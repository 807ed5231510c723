"""Compressor: the compression training loop (counterpart of
paddle_tpu/contrib/slim/core/compressor.py).

Strategies hook the epochs' and batches' boundaries and may swap the
training program (distillation), rewrite it (QAT) or change parameters
in the scope (pruning); the loop checkpoints the compression state
(the epoch and the strategies' blackboard) so that a stopped run
resumes mid-schedule.

As in the JAX package, each epoch trains through a new Executor and
each evaluation runs through another, so each plans its block again and
(on a card) captures it again at its second run: a strategy that swaps
or rewrites the program is followed without any invalidation.
"""
from __future__ import annotations

import os
import pickle

import numpy as np

__all__ = ["Context", "Compressor"]


class Context:
    """What the strategies see and change. train_graph and eval_graph
    are (program, feed_names, fetch_names) triples; `optimize_graph` is
    the triple the epoch loop trains on, which a strategy may replace
    (distillation swaps in the merged teacher and student program)."""

    def __init__(self, place, scope, train_graph, train_reader,
                 eval_graph, eval_reader, teacher_graphs=(),
                 train_optimizer=None, distiller_optimizer=None):
        self.place = place
        self.scope = scope
        self.train_graph = train_graph
        self.train_reader = train_reader
        self.eval_graph = eval_graph
        self.eval_reader = eval_reader
        self.teacher_graphs = list(teacher_graphs)
        self.train_optimizer = train_optimizer
        self.distiller_optimizer = distiller_optimizer
        self.optimize_graph = train_graph
        self.epoch_id = 0
        self.k_v = {}
        self.eval_results = {}

    def put(self, key, value):
        self.k_v[key] = value

    def get(self, key):
        return self.k_v.get(key)

    def run_eval_graph(self, sampled_rate=None, cached_id=0):
        """Evaluate eval_graph over eval_reader; returns (results,
        fetch_names), each result the batches' values stacked and
        flattened."""
        from ....core.scope import scope_guard
        from ....executor import Executor
        program, feed_names, fetch_names = self.eval_graph
        exe = Executor(self.place)
        rows = []
        for i, data in enumerate(self.eval_reader()):
            if sampled_rate is not None and \
                    (hash((cached_id, i)) % 1000) / 1000.0 > sampled_rate:
                continue
            feed = dict(zip(feed_names, data)) \
                if not isinstance(data, dict) else data
            with scope_guard(self.scope):
                vals = exe.run(program, feed=feed,
                               fetch_list=list(fetch_names))
            rows.append([np.asarray(v) for v in vals])
        results = [np.stack([r[i] for r in rows]).reshape(-1)
                   for i in range(len(fetch_names))]
        return results, list(fetch_names)

    def eval_converged(self, metric_name, delta=0.001):
        if len(self.eval_results.get(metric_name, [])) < 2:
            return False
        a, b = self.eval_results[metric_name][-2:]
        return abs(a - b) < delta


def apply_optimizer(context, program, loss_name, optimizer):
    """A clone of `program` (a forward and loss graph) with the
    optimizer's ops for `loss_name` appended; the startup program of
    the new optimizer state runs once in the context's scope (the
    parameters are there already). Returns the clone."""
    from ....core.scope import scope_guard
    from ....executor import Executor
    from ....framework import Program, program_guard
    prog = program.clone()
    startup = Program()
    with program_guard(prog, startup):
        optimizer.minimize(prog.global_block().var(loss_name))
    with scope_guard(context.scope):
        Executor(context.place).run(startup)
    return prog


class Compressor:
    """Drive strategies over an epoch loop.

        comp = Compressor(place, scope, train_program, train_reader,
                          train_feed_list, train_fetch_list,
                          eval_program, eval_reader, eval_feed_list,
                          eval_fetch_list, teacher_programs=[...],
                          epoch=N, checkpoint_path=...)
        comp.config("compress.yaml")   # or comp.strategies = [...]
        comp.run()
    """

    def __init__(self, place, scope, train_program, train_reader=None,
                 train_feed_list=None, train_fetch_list=None,
                 eval_program=None, eval_reader=None,
                 eval_feed_list=None, eval_fetch_list=None,
                 teacher_programs=(), checkpoint_path=None,
                 train_optimizer=None, distiller_optimizer=None,
                 epoch=1, log_period=20):
        self.place = place
        self.scope = scope
        self.epoch = epoch
        self.log_period = log_period
        self.checkpoint_path = checkpoint_path
        self.strategies = []
        self.context = Context(
            place, scope,
            (train_program, list(train_feed_list or []),
             list(train_fetch_list or [])),
            train_reader,
            (eval_program, list(eval_feed_list or []),
             list(eval_fetch_list or [])),
            eval_reader, teacher_programs,
            train_optimizer=train_optimizer,
            distiller_optimizer=distiller_optimizer)

    def _add_strategy(self, strategy):
        self.strategies.append(strategy)
        self.epoch = max(self.epoch, strategy.end_epoch)

    def config(self, config_file):
        """Load strategies (and the epoch count and checkpoint path)
        from a yaml config (ConfigFactory)."""
        from .config import ConfigFactory
        factory = ConfigFactory(config_file)
        for s in factory.strategies:
            self._add_strategy(s)
        if factory.compressor.get("epoch"):
            self.epoch = int(factory.compressor["epoch"])
        if factory.compressor.get("checkpoint_path"):
            self.checkpoint_path = factory.compressor["checkpoint_path"]
        return self

    # ---- checkpoint of the compression state -------------------------------
    def _checkpoint_file(self):
        return os.path.join(self.checkpoint_path, "compress.state")

    def _save_checkpoint(self, context):
        if not self.checkpoint_path:
            return
        from ....core.scope import scope_guard
        from ....executor import Executor
        from ....io import save_persistables
        os.makedirs(self.checkpoint_path, exist_ok=True)
        with scope_guard(self.scope):
            save_persistables(Executor(self.place), self.checkpoint_path,
                              main_program=self.context.optimize_graph[0])
        with open(self._checkpoint_file(), "wb") as f:
            pickle.dump({"epoch_id": context.epoch_id,
                         "k_v": context.k_v}, f)

    def _load_checkpoint(self, context):
        if not self.checkpoint_path or \
                not os.path.exists(self._checkpoint_file()):
            return False
        from ....core.scope import scope_guard
        from ....executor import Executor
        from ....io import load_persistables
        with open(self._checkpoint_file(), "rb") as f:
            state = pickle.load(f)
        context.epoch_id = state["epoch_id"] + 1
        context.k_v = state["k_v"]
        with scope_guard(self.scope):
            load_persistables(Executor(self.place), self.checkpoint_path,
                              main_program=self.context.optimize_graph[0])
        for s in self.strategies:
            s.restore_from_checkpoint(context)
        return True

    # ---- the loop ------------------------------------------------------------
    def _train_one_epoch(self, context):
        if context.train_reader is None:
            return
        from ....core.scope import scope_guard
        from ....executor import Executor
        program, feed_names, fetch_names = context.optimize_graph
        exe = Executor(self.place)
        for batch_id, data in enumerate(context.train_reader()):
            for s in self.strategies:
                s.on_batch_begin(context)
            feed = dict(zip(feed_names, data)) \
                if not isinstance(data, dict) else data
            with scope_guard(self.scope):
                vals = exe.run(program, feed=feed,
                               fetch_list=list(fetch_names))
            for s in self.strategies:
                s.on_batch_end(context)
            if batch_id % self.log_period == 0:
                metrics = ", ".join(
                    f"{n}={float(np.asarray(v).reshape(-1)[0]):.4f}"
                    for n, v in zip(fetch_names, vals))
                print(f"[slim] epoch {context.epoch_id} "
                      f"batch {batch_id}: {metrics}")

    def _eval(self, context):
        if context.eval_reader is None or \
                context.eval_graph[0] is None:
            return
        results, names = context.run_eval_graph()
        for n, r in zip(names, results):
            context.eval_results.setdefault(n, []).append(
                float(np.mean(r)))

    def _init_model(self, context):
        """With a train_optimizer the train program is a forward and loss
        graph: build the default optimize graph from it."""
        if context.train_optimizer is not None and \
                context.optimize_graph is context.train_graph:
            prog, feeds, fetches = context.train_graph
            opt_prog = apply_optimizer(context, prog, fetches[0],
                                       context.train_optimizer)
            context.optimize_graph = (opt_prog, feeds, fetches)

    def run(self):
        from ....core.scope import scope_guard
        context = self.context
        # strategies resolve scope state (pruners, quantization passes)
        # through global_scope(): pin it to the context's
        with scope_guard(self.scope):
            self._init_model(context)
            resumed = self._load_checkpoint(context)
            for s in self.strategies:
                s.on_compression_begin(context)
            start = context.epoch_id if resumed else 0
            for epoch_id in range(start, self.epoch):
                context.epoch_id = epoch_id
                for s in self.strategies:
                    s.on_epoch_begin(context)
                self._train_one_epoch(context)
                for s in self.strategies:
                    s.on_epoch_end(context)
                self._eval(context)
                self._save_checkpoint(context)
            for s in self.strategies:
                s.on_compression_end(context)
        return context
