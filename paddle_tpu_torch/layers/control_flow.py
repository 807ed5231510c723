"""Control-flow layers: While, Switch and the tensor-array builders
(counterpart of paddle_tpu/layers/control_flow.py). StaticRNN and
DynamicRNN live in rnn.py. `While` builds its body in a sub-block and
completes into one `while` op, which the engine runs eagerly: its
condition is read on the host before every trip (ops/control_flow.py).
`Switch` is the JAX package's: its cases are context managers around
ops that run unconditionally, a schedule's arithmetic selecting the
result. `py_func` runs a Python callable as an op, eagerly.
"""
from __future__ import annotations

from .. import framework
from ..layer_helper import LayerHelper
from ..proto import framework_desc as fpb

__all__ = ["While", "Switch", "py_func", "Print", "is_empty",
           "tensor_array_to_tensor", "array_write", "array_read",
           "array_length", "create_array"]


class While:
    """`with While(cond).block(): ...`: one `while` op over the body."""

    def __init__(self, cond, is_test=False, name=None):
        self.helper = LayerHelper("while", name=name)
        self.cond_var = cond

    def block(self):
        return _WhileBlockGuard(self)


class _WhileBlockGuard:
    def __init__(self, while_op):
        self.while_op = while_op
        self.main_program = self.while_op.helper.main_program

    def __enter__(self):
        self.block = self.main_program._create_block()
        return self

    def __exit__(self, exc_type, *a):
        if exc_type is not None:
            return False
        main = self.main_program
        sub_block = main.current_block()
        main._rollback()
        parent = main.current_block()
        # carries: vars read inside the sub block that exist outside +
        # vars written inside that exist outside
        inner_reads, inner_writes = set(), set()
        for op in sub_block.ops:
            for slot in op.input_slots():
                inner_reads.update(op.input(slot))
            for slot in op.output_slots():
                inner_writes.update(op.output(slot))
        outside = set()
        for n in (inner_reads | inner_writes):
            if n not in sub_block.vars and \
                    parent._find_var_recursive(n) is not None:
                outside.add(n)
        cond_name = self.while_op.cond_var.name
        outside.add(cond_name)
        parent.append_op(
            "while",
            inputs={"X": sorted(outside),
                    "Condition": cond_name},
            outputs={"Out": sorted(n for n in inner_writes
                                   if n in outside)},
            attrs={"sub_block": sub_block,
                   "is_test": False})
        return True


class Switch:
    """Used mainly for learning-rate warmup schedules: the cases are
    context managers only, and the ops built in them all run (a schedule
    selects its result arithmetically), as in the JAX package."""

    def __init__(self, name=None):
        self.helper = LayerHelper("switch", name=name)
        self._cases = []

    def case(self, condition):
        return _SwitchCase(self, condition)

    def default(self):
        return _SwitchCase(self, None)

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


class _SwitchCase:
    def __init__(self, switch, condition):
        self.switch = switch
        self.condition = condition

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def create_array(dtype):
    helper = LayerHelper("array")
    return helper.main_program.current_block().create_var(
        name=framework.unique_name.generate("array"),
        dtype=dtype, kind=fpb.VK_TENSOR_ARRAY)


def array_write(x, i, array=None):
    helper = LayerHelper("array_write")
    if array is None:
        array = create_array(x.dtype)
    helper.append_op("write_to_array", inputs={"X": x, "I": i},
                     outputs={"Out": array})
    return array


def array_read(array, i):
    helper = LayerHelper("array_read")
    out = helper.create_variable_for_type_inference("float32")
    helper.append_op("read_from_array", inputs={"X": array, "I": i},
                     outputs={"Out": out})
    return out


def array_length(array):
    helper = LayerHelper("array_length")
    out = helper.create_variable_for_type_inference("int64", True)
    helper.append_op("lod_array_length", inputs={"X": array},
                     outputs={"Out": out})
    return out


# py_func: the callables by id (the ops read them, ops/misc.py)
py_func_registry = []


def py_func(func, x, out, backward_func=None,
            skip_vars_in_backward_input=None):
    """Call a Python function as an op, eagerly (ops/misc.py: the block
    holding it is never captured). `backward_func(*inputs, *outputs,
    *out_grads)` gives the gradient (the py_func_grad op); without it
    each input's gradient is zeros."""
    helper = LayerHelper("py_func")
    xs = x if isinstance(x, (list, tuple)) else [x]
    outs = out if isinstance(out, (list, tuple)) else [out]
    py_func_registry.append(func)
    attrs = {"forward_callable_id": len(py_func_registry) - 1}
    if backward_func is not None:
        py_func_registry.append(backward_func)
        attrs["backward_callable_id"] = len(py_func_registry) - 1
    if skip_vars_in_backward_input:
        sk = skip_vars_in_backward_input
        sk = sk if isinstance(sk, (list, tuple)) else [sk]
        attrs["skip_vars_in_backward_input"] = [
            v.name if hasattr(v, "name") else str(v) for v in sk]
    helper.append_op("py_func", inputs={"X": list(xs)},
                     outputs={"Out": list(outs)}, attrs=attrs)
    return out


def Print(input, first_n=-1, message=None, summarize=-1,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=True,
          print_phase="both"):
    """The print op: prints the tensor's value on the host each run
    (its block stays eager) and passes it on."""
    helper = LayerHelper("print")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "print", inputs={"In": input}, outputs={"Out": out},
        attrs={"first_n": first_n, "message": message or "",
               "summarize": summarize,
               "print_tensor_name": print_tensor_name,
               "print_tensor_type": print_tensor_type,
               "print_tensor_shape": print_tensor_shape,
               "print_tensor_lod": print_tensor_lod,
               "print_phase": print_phase})
    return out


def is_empty(x, cond=None):
    """[1] bool: whether x has no element."""
    helper = LayerHelper("is_empty")
    if cond is None:
        cond = helper.create_variable_for_type_inference("bool")
    helper.append_op("is_empty", inputs={"X": x},
                     outputs={"Out": cond})
    return cond


def tensor_array_to_tensor(input, axis=1, name=None, use_stack=False):
    """The array's tensors concatenated (stacked with use_stack) along
    `axis`, and each one's size along it."""
    helper = LayerHelper("tensor_array_to_tensor", name=name)
    out = helper.create_variable_for_type_inference(
        getattr(input, "dtype", "float32"))
    index = helper.create_variable_for_type_inference("int32")
    helper.append_op(
        "tensor_array_to_tensor", inputs={"X": input},
        outputs={"Out": out, "OutIndex": index},
        attrs={"axis": axis, "use_stack": use_stack})
    return out, index
