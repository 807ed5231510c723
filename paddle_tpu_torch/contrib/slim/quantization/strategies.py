"""The QAT strategy (counterpart of
paddle_tpu/contrib/slim/quantization/strategies.py): at start_epoch
rewrite the train and eval graphs with fake-quant ops
(QuantizationTransformPass), fine-tune through the schedule, and at the
compression's end freeze to the int8 grid and save the float and the
int8 inference models.
"""
from __future__ import annotations

import os

from ..core.strategy import Strategy
from .quantization_pass import (QuantizationTransformPass,
                                QuantizationFreezePass,
                                ConvertToInt8Pass)

__all__ = ["QuantizationStrategy"]


class QuantizationStrategy(Strategy):
    def __init__(self, start_epoch=0, end_epoch=0,
                 weight_bits=8, activation_bits=8,
                 weight_quantize_type="abs_max",
                 activation_quantize_type="moving_average_abs_max",
                 float_model_save_path=None, int8_model_save_path=None,
                 save_in_nodes=None, save_out_nodes=None):
        super().__init__(start_epoch, end_epoch)
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits
        self.weight_quantize_type = weight_quantize_type
        self.activation_quantize_type = activation_quantize_type
        self.float_model_save_path = float_model_save_path
        self.int8_model_save_path = int8_model_save_path
        self.save_in_nodes = save_in_nodes
        self.save_out_nodes = save_out_nodes
        self._applied = False

    def _transform(self, context):
        from ..core.compressor import apply_optimizer
        pass_ = QuantizationTransformPass(
            scope=context.scope, weight_bits=self.weight_bits,
            activation_bits=self.activation_bits,
            weight_quantize_type=self.weight_quantize_type,
            activation_quantize_type=self.activation_quantize_type)
        t_prog, t_feeds, t_fetches = context.train_graph
        train_q = t_prog.clone()
        pass_.apply(train_q, for_test=False)
        context.train_graph = (train_q, t_feeds, t_fetches)
        if context.train_optimizer is not None:
            opt_prog = apply_optimizer(context, train_q, t_fetches[0],
                                       context.train_optimizer)
            context.optimize_graph = (opt_prog, t_feeds, t_fetches)
        else:
            context.optimize_graph = context.train_graph
        e_prog, e_feeds, e_fetches = context.eval_graph
        if e_prog is not None:
            eval_q = e_prog.clone()
            pass_.apply(eval_q, for_test=True)
            context.eval_graph = (eval_q, e_feeds, e_fetches)
        self._applied = True

    def on_epoch_begin(self, context):
        if context.epoch_id == self.start_epoch and not self._applied:
            self._transform(context)

    def restore_from_checkpoint(self, context):
        if context.epoch_id > self.start_epoch:
            self._transform(context)

    def on_compression_end(self, context):
        if not self._applied:
            return
        from ....core.scope import scope_guard
        from ....executor import Executor
        from ....io import save_inference_model
        prog, feeds, fetches = context.eval_graph
        if prog is None:
            return
        frozen = prog.clone()
        QuantizationFreezePass(
            scope=context.scope, weight_bits=self.weight_bits,
            weight_quantize_type=self.weight_quantize_type).apply(
                frozen)
        in_nodes = self.save_in_nodes or list(feeds)
        out_nodes = self.save_out_nodes or list(fetches)
        exe = Executor(context.place)
        if self.float_model_save_path:
            os.makedirs(self.float_model_save_path, exist_ok=True)
            with scope_guard(context.scope):
                save_inference_model(
                    self.float_model_save_path, in_nodes,
                    [frozen.global_block().var(n) for n in out_nodes],
                    exe, main_program=frozen)
        if self.int8_model_save_path:
            int8 = frozen.clone()
            ConvertToInt8Pass(scope=context.scope).apply(int8)
            os.makedirs(self.int8_model_save_path, exist_ok=True)
            with scope_guard(context.scope):
                save_inference_model(
                    self.int8_model_save_path, in_nodes,
                    [int8.global_block().var(n) for n in out_nodes],
                    exe, main_program=int8)
