"""Pruning strategies over the Compressor (counterpart of
paddle_tpu/contrib/slim/prune/strategies.py). The pruners zero parameter
slots in the scope; the strategies choose the ratios (uniform, by
sensitivity, or searched by simulated annealing), apply the masks again
after every batch so that an update cannot bring a pruned weight back,
and keep the masks on the context's blackboard for the checkpoint.
"""
from __future__ import annotations

import re

import numpy as np

from ..core.strategy import Strategy
from .._state import read, write
from . import apply_prune_masks

__all__ = ["PruneStrategy", "UniformPruneStrategy",
           "SensitivePruneStrategy", "AutoPruneStrategy"]

_MASKS_KEY = "__prune_masks__"


class PruneStrategy(Strategy):
    """Base: match params by regex, delegate ratios to `_get_ratios`."""

    def __init__(self, pruner=None, start_epoch=0, end_epoch=0,
                 target_ratio=0.5, metric_name=None,
                 pruned_params="conv.*_weights"):
        super().__init__(start_epoch, end_epoch)
        self.pruner = pruner
        self.target_ratio = target_ratio
        self.metric_name = metric_name
        self.pruned_params = pruned_params
        self.pruned_list = []

    def _matched_params(self, context):
        prog = context.train_graph[0]
        pat = re.compile(self.pruned_params)
        names = []
        for name, var in prog.global_block().vars.items():
            if getattr(var, "trainable", False) and pat.match(name):
                names.append(name)
        return sorted(names)

    def _eval_metric(self, context, sampled_rate=None, cached_id=0):
        results, names = context.run_eval_graph(sampled_rate, cached_id)
        return float(np.mean(results[names.index(self.metric_name)]))

    def _get_ratios(self, context, params):
        raise NotImplementedError

    def _prune(self, context):
        params = self._matched_params(context)
        assert params, (f"pruned_params pattern "
                        f"{self.pruned_params!r} matched nothing")
        ratios = self._get_ratios(context, params)
        masks = self.pruner.prune(context.train_graph[0], params,
                                  ratios)
        self.pruned_list = list(params)
        all_masks = context.get(_MASKS_KEY) or {}
        all_masks.update(masks)
        context.put(_MASKS_KEY, all_masks)

    def on_epoch_begin(self, context):
        if context.epoch_id == self.start_epoch:
            self._prune(context)

    def on_batch_end(self, context):
        masks = context.get(_MASKS_KEY)
        if masks:
            apply_prune_masks(context.scope, masks)

    def restore_from_checkpoint(self, context):
        masks = context.get(_MASKS_KEY)
        if masks:
            apply_prune_masks(context.scope, masks)
            self.pruned_list = sorted(masks)


class UniformPruneStrategy(PruneStrategy):
    """The same ratio for every matched parameter."""

    def _get_ratios(self, context, params):
        return [self.target_ratio] * len(params)


class SensitivePruneStrategy(PruneStrategy):
    """Sensitivity-ordered ratios: measure each param's eval-metric loss at increasing prune ratios,
    then pick per-param ratios — less sensitive params pruned harder —
    whose average hits target_ratio."""

    def __init__(self, pruner=None, start_epoch=0, end_epoch=0,
                 target_ratio=0.5, metric_name=None,
                 pruned_params="conv.*_weights", delta_rate=0.2,
                 eval_rate=None):
        super().__init__(pruner, start_epoch, end_epoch, target_ratio,
                         metric_name, pruned_params)
        self.delta_rate = delta_rate
        self.eval_rate = eval_rate
        self.sensitivities = {}

    def _compute_sensitivities(self, context, params):
        """Prune one parameter at a time at each ratio, evaluate,
        restore."""
        scope = context.scope
        base = self._eval_metric(context, self.eval_rate, 0)
        sens = {}
        for name in params:
            backup = read(scope, name)
            losses = {}
            ratio = self.delta_rate
            while ratio < 1.0:
                self.pruner.prune(context.train_graph[0], [name],
                                  [ratio])
                m = self._eval_metric(context, self.eval_rate, 0)
                losses[round(ratio, 4)] = (base - m) / max(
                    abs(base), 1e-8)
                write(scope, name, backup)
                ratio += self.delta_rate
            sens[name] = losses
        return sens

    def _get_ratios(self, context, params):
        self.sensitivities = self._compute_sensitivities(context,
                                                         params)
        # greedy: rank params by loss at the probe ratio; assign larger
        # ratios to the least sensitive so the mean hits target_ratio
        probe = round(self.delta_rate, 4)
        order = sorted(params,
                       key=lambda p: self.sensitivities[p][probe])
        n = len(params)
        total = self.target_ratio * n
        ratios = {}
        # linear ramp: least sensitive gets ~2x target, most ~0
        weights = np.linspace(2.0, 0.0, n)
        weights = weights / weights.sum() * total
        for p, r in zip(order, weights):
            ratios[p] = float(min(max(r, 0.0), 0.9))
        return [ratios[p] for p in params]


class AutoPruneStrategy(PruneStrategy):
    """Per-parameter ratios searched by simulated annealing: tokens = per-param ratio indices; reward = eval metric after
    pruning at those ratios (weights restored between trials)."""

    def __init__(self, pruner=None, start_epoch=0, end_epoch=0,
                 target_ratio=0.5, metric_name=None,
                 pruned_params="conv.*_weights", controller=None,
                 max_iter=10, ratio_steps=8):
        super().__init__(pruner, start_epoch, end_epoch, target_ratio,
                         metric_name, pruned_params)
        self._controller = controller
        self._max_iter = max_iter
        self._ratio_steps = ratio_steps

    def _get_ratios(self, context, params):
        from ..nas import SAController
        scope = context.scope
        steps = self._ratio_steps
        grid = np.linspace(0.0, min(2 * self.target_ratio, 0.9), steps)
        ctrl = self._controller or SAController(
            range_table=[steps] * len(params),
            max_iter_number=self._max_iter)
        backups = {}
        for name in params:
            backups[name] = read(scope, name)

        def reward(tokens):
            ratios = [float(grid[t]) for t in tokens]
            if abs(float(np.mean(ratios)) - self.target_ratio) > \
                    self.target_ratio * 0.5:
                return -1e9  # constraint: stay near the target
            self.pruner.prune(context.train_graph[0], params, ratios)
            m = self._eval_metric(context)
            for name, b in backups.items():
                write(scope, name, b)
            return m

        init = [int(np.abs(grid - self.target_ratio).argmin())] * \
            len(params)
        best, _ = ctrl.search(reward, init_tokens=init)
        return [float(grid[t]) for t in best]
