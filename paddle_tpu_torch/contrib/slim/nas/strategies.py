"""The NAS controller server, the search agent and LightNASStrategy
(counterpart of paddle_tpu/contrib/slim/nas/strategies.py): a TCP server
on a thread wraps the SAController so that search agents (one a trial
worker) ask it for `next_tokens` and report `key\\ttokens\\treward`
lines; LightNASStrategy drives the search from the compression loop:
each epoch asks for tokens, scores the candidate through the user's
search space and reports the reward.

Every socket wait has a timeout: the server's accept wakes every
`poll` seconds to see whether it was closed, a connection's read gives
up after `timeout` seconds, and close() joins the thread.
"""
from __future__ import annotations

import socket
from threading import Thread

from ..core.strategy import Strategy

__all__ = ["ControllerServer", "SearchAgent", "LightNASStrategy"]


class ControllerServer:
    """TCP wrapper over a controller, on 127.0.0.1 and a port the system
    picks by default (port 0).

    Protocol (ASCII, one message a connection):
      "next_tokens"                -> "t0,t1,..."
      "<key>\\t<tokens>\\t<reward>" -> "ok" (controller.update called)
    """

    poll = 0.2       # seconds between the accept loop's checks of close()
    timeout = 10.0   # seconds a connection may take to send its message

    def __init__(self, controller=None, address=("127.0.0.1", 0),
                 max_client_num=100, search_steps=None, key="nas"):
        self._controller = controller
        self._address = address
        self._max_client_num = max_client_num
        self._search_steps = search_steps
        self._closed = False
        self._key = key
        self._ip, self._port = address
        self._thread = None

    def start(self):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(self._address)
        self._sock.listen(self._max_client_num)
        self._sock.settimeout(self.poll)
        self._ip, self._port = self._sock.getsockname()[:2]
        self._thread = Thread(target=self.run, daemon=True)
        self._thread.start()
        return self._thread

    def close(self):
        self._closed = True
        if self._thread is not None:
            self._thread.join(timeout=self.poll + self.timeout + 1.0)
        self._sock.close()

    def ip(self):
        return self._ip

    def port(self):
        return self._port

    def run(self):
        while not self._closed and (
                self._search_steps is None
                or self._controller._iter < self._search_steps):
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            with conn:
                conn.settimeout(self.timeout)
                try:
                    message = conn.recv(4096).decode().strip("\n")
                except (socket.timeout, OSError):
                    continue
                if self._closed:
                    break
                if message == "next_tokens":
                    tokens = self._controller.next_tokens()
                    conn.sendall(",".join(map(str, tokens)).encode())
                else:
                    parts = message.split("\t")
                    if len(parts) < 3 or parts[0] != self._key:
                        continue  # noise
                    tokens = [int(t) for t in parts[1].split(",")]
                    self._controller.update(tokens, float(parts[2]))
                    conn.sendall(b"ok")


class SearchAgent:
    """The client side: one connection a message, each wait bounded by
    `timeout` seconds."""

    timeout = 30.0

    def __init__(self, server_ip=None, server_port=None, key="nas"):
        self.server_ip = server_ip
        self.server_port = server_port
        self._key = key

    def _send(self, message):
        with socket.create_connection(
                (self.server_ip, self.server_port),
                timeout=self.timeout) as s:
            s.sendall(message.encode())
            return s.recv(4096).decode()

    def next_tokens(self):
        return [int(t) for t in self._send("next_tokens").split(",")]

    def update(self, tokens, reward):
        tokens = ",".join(map(str, tokens))
        return self._send(f"{self._key}\t{tokens}\t{reward}")


class LightNASStrategy(Strategy):
    """Architecture search inside the compression loop: each epoch in
    [start, end) fetches tokens, scores the candidate through the
    context's search space (`context.put("search_space", space)`) and
    reports the reward; the best tokens and reward land on the context's
    blackboard at the compression's end."""

    def __init__(self, controller=None, end_epoch=10, target_flops=None,
                 retrain_epoch=0, metric_name="acc", server_ip=None,
                 server_port=0, is_server=True, search_steps=None,
                 key="light-nas"):
        super().__init__(0, end_epoch)
        self._controller = controller
        self.target_flops = target_flops
        self.retrain_epoch = retrain_epoch
        self.metric_name = metric_name
        self._is_server = is_server
        self._server_ip = server_ip or "127.0.0.1"
        self._server_port = server_port
        self._search_steps = search_steps
        self._key = key
        self._server = None
        self._agent = None

    def on_compression_begin(self, context):
        space = context.get("search_space")
        assert space is not None, (
            "LightNASStrategy needs context.put('search_space', <your "
            "SearchSpaceBase impl>) before run()")
        self._space = space
        if self._is_server:
            from . import SAController
            ctrl = self._controller or SAController(
                range_table=space.range_table())
            self._server = ControllerServer(
                controller=ctrl,
                address=(self._server_ip, self._server_port),
                search_steps=self._search_steps, key=self._key)
            self._server.start()
            self._server_port = self._server.port()
        self._agent = SearchAgent(self._server_ip, self._server_port,
                                  key=self._key)

    def on_epoch_begin(self, context):
        if not (self.start_epoch <= context.epoch_id < self.end_epoch):
            return
        tokens = self._agent.next_tokens()
        reward = self._space.eval_tokens(tokens, context)
        self._agent.update(tokens, reward)
        context.put("nas_last", (tokens, reward))

    def on_compression_end(self, context):
        if self._server is not None:
            context.put("nas_best_tokens",
                        self._server._controller.best_tokens)
            context.put("nas_best_reward",
                        self._server._controller.max_reward)
            self._server.close()
