"""The distillation strategy and the distillers (counterpart of
paddle_tpu/contrib/slim/distillation/strategies.py). At start_epoch the
strategy grafts every teacher program into a clone of the student's
forward graph (merge from distillation/__init__.py), sums the distillers' losses with the student
loss, applies the distiller optimizer, and swaps the context's
optimize graph; at end_epoch the plain student optimize graph returns.
Student parameters live in the shared scope, so weights trained through
the merged graph are the same arrays the restored graph keeps using.
"""
from __future__ import annotations

from ..core.strategy import Strategy
from . import merge, l2_loss, soft_label_loss, fsp_loss

__all__ = ["DistillationStrategy", "L2Distiller", "SoftLabelDistiller",
           "FSPDistiller"]


class L2Distiller:
    def __init__(self, teacher_feature_map, student_feature_map,
                 distillation_loss_weight=1.0):
        self.teacher_feature_map = teacher_feature_map
        self.student_feature_map = student_feature_map
        self.weight = distillation_loss_weight

    def build(self, program, prefix):
        return l2_loss(prefix + self.teacher_feature_map,
                       self.student_feature_map, program), self.weight


class SoftLabelDistiller:
    def __init__(self, teacher_feature_map, student_feature_map,
                 teacher_temperature=2.0, student_temperature=2.0,
                 distillation_loss_weight=1.0):
        self.teacher_feature_map = teacher_feature_map
        self.student_feature_map = student_feature_map
        self.teacher_temperature = teacher_temperature
        self.student_temperature = student_temperature
        self.weight = distillation_loss_weight

    def build(self, program, prefix):
        return soft_label_loss(
            prefix + self.teacher_feature_map,
            self.student_feature_map, program,
            self.teacher_temperature,
            self.student_temperature), self.weight


class FSPDistiller:
    def __init__(self, teacher_pairs, student_pairs,
                 distillation_loss_weight=1.0):
        self.teacher_pairs = teacher_pairs
        self.student_pairs = student_pairs
        self.weight = distillation_loss_weight

    def build(self, program, prefix):
        from .... import layers as L
        from ....framework import program_guard
        losses = []
        for (t1, t2), (s1, s2) in zip(self.teacher_pairs,
                                      self.student_pairs):
            losses.append(fsp_loss(prefix + t1, prefix + t2, s1, s2,
                                   program))
        with program_guard(program):
            total = losses[0]
            for l in losses[1:]:
                total = L.elementwise_add(total, l)
        return total, self.weight


class DistillationStrategy(Strategy):
    def __init__(self, distillers=None, start_epoch=0, end_epoch=0,
                 name_prefix="teacher_"):
        super().__init__(start_epoch, end_epoch)
        self.distillers = list(distillers or [])
        self.name_prefix = name_prefix
        self._saved_graph = None

    def _create_distillation_graph(self, context):
        """The student's forward graph with every teacher merged in, the
        distillers' weighted losses added to the student's loss, and the
        distiller optimizer applied."""
        from .... import layers as L
        from ....framework import program_guard
        from ..core.compressor import apply_optimizer

        s_prog, feeds, fetches = context.train_graph
        merged = s_prog.clone()
        data_map = {n: n for n in feeds}
        for t_prog in context.teacher_graphs:
            merge(t_prog, merged, data_map, scope=context.scope,
                  name_prefix=self.name_prefix)
        with program_guard(merged):
            total = merged.global_block().var(fetches[0])
            for d in self.distillers:
                dl, w = d.build(merged, self.name_prefix)
                total = L.elementwise_add(
                    total, L.scale(dl, scale=float(w)))
        opt = context.distiller_optimizer or context.train_optimizer
        assert opt is not None, (
            "DistillationStrategy needs distiller_optimizer (or "
            "train_optimizer) on the Compressor")
        opt_prog = apply_optimizer(context, merged, total.name, opt)
        return (opt_prog, list(feeds), [total.name] + list(fetches))

    def on_epoch_begin(self, context):
        if context.epoch_id == self.start_epoch:
            self._saved_graph = context.optimize_graph
            context.optimize_graph = \
                self._create_distillation_graph(context)

    def on_epoch_end(self, context):
        if self.end_epoch and context.epoch_id == self.end_epoch - 1 \
                and self._saved_graph is not None:
            context.optimize_graph = self._saved_graph

    def restore_from_checkpoint(self, context):
        if context.epoch_id > self.start_epoch and (
                not self.end_epoch
                or context.epoch_id < self.end_epoch):
            self._saved_graph = context.optimize_graph
            context.optimize_graph = \
                self._create_distillation_graph(context)
