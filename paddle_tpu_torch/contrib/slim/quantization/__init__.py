"""contrib.slim.quantization (counterpart of
paddle_tpu/contrib/slim/quantization/): the QAT passes, the
QuantizationStrategy, and the QuantizeTranspiler facade."""
from .quantization_pass import (  # noqa: F401
    QuantizationTransformPass, QuantizationFreezePass, ConvertToInt8Pass,
)
from .strategies import QuantizationStrategy  # noqa: F401


class QuantizeTranspiler:
    """The reference's pre-slim QAT API as a facade over the passes:
    training_transpile inserts the fake-quant ops, freeze_program snaps
    the weights and pins the scales, convert_to_int8 stores the int8
    weights."""

    def __init__(self, weight_bits=8, activation_bits=8,
                 activation_quantize_type="abs_max",
                 weight_quantize_type="abs_max", window_size=10000,
                 moving_rate=0.9):
        self._kw = dict(weight_bits=weight_bits,
                        activation_bits=activation_bits,
                        activation_quantize_type=activation_quantize_type,
                        weight_quantize_type=weight_quantize_type,
                        window_size=window_size,
                        moving_rate=moving_rate)
        self._freeze_kw = dict(
            weight_bits=weight_bits,
            weight_quantize_type=weight_quantize_type)

    def training_transpile(self, program=None, startup_program=None):
        from ...framework import default_main_program
        program = program or default_main_program()
        QuantizationTransformPass(**self._kw).apply(program)
        return program

    def freeze_program(self, program, place=None, fuse_bn=False,
                       scope=None):
        QuantizationFreezePass(scope=scope,
                               **self._freeze_kw).apply(program)
        return program

    def convert_to_int8(self, program, place=None, scope=None):
        ConvertToInt8Pass(scope=scope).apply(program)
        return program
