"""Light NAS (counterpart of paddle_tpu/contrib/slim/nas/): the
SAController's simulated annealing over integer token lists (each slot
with its range), the ControllerServer and SearchAgent that carry it over
TCP, and the LightNASStrategy that drives the search from the
Compressor's loop.
"""
from __future__ import annotations

import math
import random
from typing import Callable, List, Optional, Sequence

__all__ = ["SAController", "SearchSpaceBase"]


class SearchSpaceBase:
    """A search space: token ranges and a net builder."""

    def init_tokens(self) -> List[int]:
        raise NotImplementedError

    def range_table(self) -> List[int]:
        raise NotImplementedError

    def create_net(self, tokens):
        raise NotImplementedError

    def eval_tokens(self, tokens, context) -> float:
        """Score one candidate (LightNASStrategy calls this): build
        the net, short-train/eval it, return the reward. Override for
        anything beyond the default create_net()-returns-reward
        contract."""
        return float(self.create_net(tokens))


class SAController:
    """Simulated annealing over token lists: propose a random mutation, accept if better or
    with probability exp((reward - best) / temperature)."""

    def __init__(self, range_table: Sequence[int],
                 reduce_rate: float = 0.85,
                 init_temperature: float = 1024.0,
                 max_iter_number: int = 300, seed: int = 0):
        self._range_table = list(range_table)
        self._reduce_rate = reduce_rate
        self._temperature = init_temperature
        self._max_iter = max_iter_number
        self._rng = random.Random(seed)
        self._tokens: Optional[List[int]] = None
        self._reward = -float("inf")
        self._best_tokens: Optional[List[int]] = None
        self._best_reward = -float("inf")
        self._iter = 0

    # -- the controller's API ------------------------------------------------
    def reset(self, range_table, init_tokens, reward=-float("inf")):
        self._range_table = list(range_table)
        self._tokens = list(init_tokens)
        self._reward = reward
        self._best_tokens = list(init_tokens)
        self._best_reward = reward
        self._iter = 0

    def next_tokens(self) -> List[int]:
        if self._tokens is None:
            self._tokens = [self._rng.randrange(r)
                            for r in self._range_table]
            return list(self._tokens)
        new = list(self._tokens)
        idx = self._rng.randrange(len(new))
        new[idx] = self._rng.randrange(self._range_table[idx])
        self._proposal = new
        return list(new)

    def update(self, tokens: List[int], reward: float) -> bool:
        """Feed back the proposal's reward; returns acceptance."""
        self._iter += 1
        self._temperature *= self._reduce_rate
        accept = False
        if reward > self._reward:
            accept = True
        else:
            t = max(self._temperature, 1e-8)
            prob = math.exp(min((reward - self._reward) / t, 0.0))
            accept = self._rng.random() < prob
        if accept:
            self._tokens = list(tokens)
            self._reward = reward
        if reward > self._best_reward:
            self._best_reward = reward
            self._best_tokens = list(tokens)
        return accept

    @property
    def best_tokens(self):
        return list(self._best_tokens or [])

    @property
    def max_reward(self):
        return self._best_reward

    def search(self, eval_fn: Callable[[List[int]], float],
               init_tokens: Optional[List[int]] = None):
        """Run the full SA loop: returns (best_tokens, best_reward)."""
        if init_tokens is not None:
            self.reset(self._range_table, init_tokens,
                       eval_fn(list(init_tokens)))
        for _ in range(self._max_iter):
            tokens = self.next_tokens()
            self.update(tokens, eval_fn(tokens))
        return self.best_tokens, self.max_reward


from .strategies import (  # noqa: E402,F401
    ControllerServer, SearchAgent, LightNASStrategy)

__all__ += ["ControllerServer", "SearchAgent", "LightNASStrategy"]
