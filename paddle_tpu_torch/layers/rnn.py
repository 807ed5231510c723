"""StaticRNN / DynamicRNN / IfElse, the dynamic-sequence layer API
(counterpart of paddle_tpu/layers/rnn.py, op for op).

Both RNN classes build a sub-block under a `with rnn.step()/block():`
guard, as the reference does, and complete into ONE `recurrent` op over
it (ops/control_flow.py: a torch loop over the padded time steps, its
gradient the generic one). DynamicRNN rides the host-side LoD: the
sequences sorted by the rank table, padded time-major, stepped with a
per-sequence length mask, and unsorted back to the packed LoD layout.
IfElse builds no sub-block: both branches run on every row, and
merge_lod_tensor selects by the mask.
"""
from __future__ import annotations

import contextlib

from .. import framework
from ..layer_helper import LayerHelper
from ..proto import framework_desc as fpb
from . import tensor as tensor_layers

__all__ = ["StaticRNN", "DynamicRNN", "IfElse", "lod_rank_table",
           "max_sequence_len", "lod_tensor_to_array",
           "array_to_lod_tensor", "reorder_lod_tensor_by_rank",
           "split_lod_tensor", "merge_lod_tensor"]


def lod_rank_table(x, level=0):
    helper = LayerHelper("lod_rank_table")
    table = helper.main_program.current_block().create_var(
        name=framework.unique_name.generate("lod_rank_table"),
        dtype="int64", kind=fpb.VK_RAW)
    helper.append_op("lod_rank_table", inputs={"X": x},
                     outputs={"Out": table}, attrs={"level": level},
                     infer_shape=False)
    return table


def max_sequence_len(rank_table):
    helper = LayerHelper("max_seqence_len")
    out = helper.create_variable_for_type_inference("int64", True)
    helper.append_op("max_sequence_len",
                     inputs={"RankTable": rank_table},
                     outputs={"Out": out}, infer_shape=False)
    return out


def lod_tensor_to_array(x, table):
    helper = LayerHelper("lod_tensor_to_array")
    arr = helper.create_variable_for_type_inference(x.dtype)
    # padded time-major [T, n_seq, *features]: keep feature dims so
    # layers built on step slices see real widths
    arr.shape = (-1, -1) + tuple(x.shape[1:])
    helper.append_op("lod_tensor_to_array",
                     inputs={"X": x, "RankTable": table},
                     outputs={"Out": arr}, infer_shape=False)
    return arr


def array_to_lod_tensor(x, table):
    helper = LayerHelper("array_to_lod_tensor")
    out = helper.create_variable_for_type_inference(x.dtype)
    out.lod_level = 1
    out.shape = (-1,) + tuple(x.shape[2:])
    helper.append_op("array_to_lod_tensor",
                     inputs={"X": x, "RankTable": table},
                     outputs={"Out": out}, infer_shape=False)
    return out


def reorder_lod_tensor_by_rank(x, rank_table):
    helper = LayerHelper("reorder_lod_tensor_by_rank")
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = tuple(x.shape)
    helper.append_op("reorder_lod_tensor_by_rank",
                     inputs={"X": x, "RankTable": rank_table},
                     outputs={"Out": out}, infer_shape=False)
    return out


def split_lod_tensor(input, mask, level=0):
    helper = LayerHelper("split_lod_tensor")
    out_true = helper.create_variable_for_type_inference(input.dtype)
    out_false = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("split_lod_tensor",
                     inputs={"X": input, "Mask": mask},
                     outputs={"OutTrue": out_true,
                              "OutFalse": out_false},
                     attrs={"level": level}, infer_shape=False)
    return out_true, out_false


def merge_lod_tensor(in_true, in_false, x, mask, level=0):
    helper = LayerHelper("merge_lod_tensor")
    out = helper.create_variable_for_type_inference(in_true.dtype)
    helper.append_op("merge_lod_tensor",
                     inputs={"InTrue": in_true, "InFalse": in_false,
                             "X": x, "Mask": mask},
                     outputs={"Out": out},
                     attrs={"level": level}, infer_shape=False)
    return out


@contextlib.contextmanager
def _in_block(program, idx):
    """Temporarily emit ops into block `idx` (the parent block, while
    the user's `with` guard has the sub-block current)."""
    old = program.current_block_idx
    program.current_block_idx = idx
    try:
        yield
    finally:
        program.current_block_idx = old


class _RnnBlockGuard:
    def __init__(self, rnn):
        self.rnn = rnn

    def __enter__(self):
        self.rnn.status = _RnnBase.IN_RNN
        self.rnn._enter_block()
        return self.rnn

    def __exit__(self, exc_type, *a):
        if exc_type is not None:
            return False
        self.rnn.status = _RnnBase.AFTER_RNN
        self.rnn._complete()
        return True


class _RnnBase:
    BEFORE_RNN, IN_RNN, AFTER_RNN = 0, 1, 2

    def __init__(self, helper_name, name=None):
        self.helper = LayerHelper(helper_name, name=name)
        self.status = self.BEFORE_RNN
        self.step_inputs = []     # (sub_var, parent_seq_name)
        self.memories = []        # (pre_mem_var, init_name, mem_name)
        self.step_outputs = []    # sub-block vars marked as outputs
        self.outputs = []         # parent-block result vars
        self._mem_by_name = {}
        self._sub_block = None
        self._parent_block = None

    def _assert_in_block(self, method):
        if self.status != self.IN_RNN:
            raise ValueError(
                f"{method} must be called inside the rnn block")

    def _enter_block(self):
        main = self.helper.main_program
        self._parent_block = main.current_block()
        self._sub_block = main._create_block()

    def _collect_param_names(self):
        """Outer vars the sub-block reads (weights, constants) — bound
        to the recurrent op's `parameters` slot so grads reach them."""
        sub = self._sub_block
        produced = set()
        bound = {v.name for v, _ in self.step_inputs}
        bound |= {m.name for m, _, _ in self.memories}
        reads = []
        for op in sub.ops:
            for slot in op.output_slots():
                produced.update(op.output(slot))
        for op in sub.ops:
            for slot in op.input_slots():
                for n in op.input(slot):
                    if n in produced or n in bound or n in reads:
                        continue
                    if n in sub.vars:
                        continue  # block-local (created before any op?)
                    if self._parent_block._find_var_recursive(n) is None:
                        continue
                    reads.append(n)
        return reads

    def update_memory(self, mem, var):
        self._assert_in_block("update_memory")
        if mem.name not in self._mem_by_name:
            raise ValueError(f"{mem.name} is not a memory of this rnn")
        i = self._mem_by_name[mem.name]
        pre, init, _ = self.memories[i]
        self.memories[i] = (pre, init, var.name)


class StaticRNN(_RnnBase):
    """Fixed-length RNN over time-major inputs: `step_input(x)` takes x
    with time as dim 0 and yields the [B, ...] step slice; `memory()`
    creates a carried state; `step_output()` marks per-step outputs;
    `rnn()` returns time-major stacked outputs."""

    def __init__(self, name=None):
        super().__init__("static_rnn", name=name)
        self.seq_len = None

    def step(self):
        return _RnnBlockGuard(self)

    def step_input(self, x):
        self._assert_in_block("step_input")
        if self.seq_len is None:
            self.seq_len = x.shape[0]
        sub_var = self._sub_block.create_var(
            name=framework.unique_name.generate(f"{x.name}@step"),
            shape=x.shape[1:], dtype=x.dtype)
        self.step_inputs.append((sub_var, x.name))
        return sub_var

    def memory(self, init=None, shape=None, batch_ref=None,
               init_value=0.0, init_batch_dim_idx=0,
               ref_batch_dim_idx=1):
        self._assert_in_block("memory")
        if init is None:
            if shape is None or batch_ref is None:
                raise ValueError(
                    "memory needs `init` or (`shape` and `batch_ref`)")
            # boot memory: [batch, *feature shape] filled with
            # init_value; batch size read from the parent sequence's
            # batch axis (time-major [T, B, ...] -> dim 1, hence the
            # reference's ref_batch_dim_idx=1 default)
            feat = [int(s) for s in
                    (shape[1:] if len(shape) > 1 else shape)]
            with _in_block(self.helper.main_program,
                           self._parent_block.idx):
                init = tensor_layers.fill_constant_batch_size_like(
                    input=self._find_parent_seq(batch_ref),
                    shape=[-1] + feat,
                    dtype=batch_ref.dtype, value=init_value,
                    input_dim_idx=ref_batch_dim_idx,
                    output_dim_idx=init_batch_dim_idx)
        pre_mem = self._sub_block.create_var(
            name=framework.unique_name.generate(f"{init.name}@pre"),
            shape=init.shape, dtype=init.dtype)
        self._mem_by_name[pre_mem.name] = len(self.memories)
        self.memories.append((pre_mem, init.name, None))
        return pre_mem

    def _find_parent_seq(self, batch_ref):
        for sub_var, parent_name in self.step_inputs:
            if sub_var.name == batch_ref.name:
                return self._parent_block.var(parent_name)
        return batch_ref

    def step_output(self, o):
        self._assert_in_block("step_output")
        self.step_outputs.append(o)

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)

    def _complete(self):
        main = self.helper.main_program
        main._rollback()
        parent = self._parent_block
        mem_names = []
        for pre, init, mem in self.memories:
            if mem is None:
                raise ValueError(
                    f"memory {pre.name} was never update_memory()'d")
            mem_names.append(mem)
        params = self._collect_param_names()
        outs = []
        for o in self.step_outputs:
            out = parent.create_var(
                name=framework.unique_name.generate(f"{o.name}@seq"),
                shape=(self.seq_len,) + tuple(o.shape), dtype=o.dtype)
            outs.append(out)
        parent.append_op(
            "recurrent",
            inputs={"inputs": [p for _, p in self.step_inputs],
                    "initial_states": [i for _, i, _ in self.memories],
                    "parameters": params},
            outputs={"outputs": [o.name for o in outs]},
            attrs={"sub_block": self._sub_block,
                   "input_names": [v.name for v, _ in self.step_inputs],
                   "state_names": [p.name for p, _, _ in self.memories],
                   "state_out_names": mem_names,
                   "output_names": [o.name for o in self.step_outputs],
                   "param_names": params,
                   "reverse": False},
            infer_shape=False)
        self.outputs = outs

    def __call__(self):
        if self.status != self.AFTER_RNN:
            raise ValueError("rnn() must be called after the step block")
        return self.outputs[0] if len(self.outputs) == 1 \
            else self.outputs


class DynamicRNN(_RnnBase):
    """Variable-length RNN over LoD sequences: sequences are sorted by
    length (rank table), padded dense, stepped with per-sequence masking,
    and the output is unsorted back to the packed LoD layout: the values
    of the reference's shrinking-batch while loop."""

    def __init__(self, name=None):
        super().__init__("dynamic_rnn", name=name)
        self.rank_table = None
        self._first_seq_name = None

    def block(self):
        return _RnnBlockGuard(self)

    def _ensure_table(self, x):
        if self.rank_table is None:
            with _in_block(self.helper.main_program,
                           self._parent_block.idx):
                self.rank_table = lod_rank_table(x)

    def step_input(self, x, level=0):
        self._assert_in_block("step_input")
        self._ensure_table(x)
        with _in_block(self.helper.main_program,
                       self._parent_block.idx):
            padded = lod_tensor_to_array(x, self.rank_table)
        sub_var = self._sub_block.create_var(
            name=framework.unique_name.generate(f"{x.name}@step"),
            shape=x.shape, dtype=x.dtype)
        self.step_inputs.append((sub_var, padded.name))
        return sub_var

    def static_input(self, x):
        """Non-sequence input reordered into rank-table order so row i
        aligns with the i-th (sorted) sequence inside the block."""
        self._assert_in_block("static_input")
        if self.rank_table is None:
            raise ValueError("call step_input before static_input")
        with _in_block(self.helper.main_program,
                       self._parent_block.idx):
            reordered = reorder_lod_tensor_by_rank(x, self.rank_table)
        sub_var = self._sub_block.create_var(
            name=framework.unique_name.generate(f"{x.name}@static"),
            shape=x.shape, dtype=x.dtype)
        # delivered every step unchanged: model as a memory that carries
        # itself forward
        self._mem_by_name[sub_var.name] = len(self.memories)
        self.memories.append((sub_var, reordered.name, sub_var.name))
        return sub_var

    def memory(self, init=None, shape=None, value=0.0, need_reorder=False,
               dtype="float32"):
        self._assert_in_block("memory")
        if self.rank_table is None:
            raise ValueError("call step_input before memory")
        with _in_block(self.helper.main_program,
                       self._parent_block.idx):
            if init is not None:
                if need_reorder:
                    init = reorder_lod_tensor_by_rank(
                        init, self.rank_table)
                init_name = init.name
                mem_shape = init.shape
                mem_dtype = init.dtype
            else:
                boot = tensor_layers.fill_constant(
                    shape=[1] + [int(s) for s in shape], dtype=dtype,
                    value=value)
                # broadcast to the sorted batch against the rank table
                b = self.helper.main_program.current_block()
                bvar = b.create_var(
                    name=framework.unique_name.generate("mem_boot"),
                    shape=[-1] + [int(s) for s in shape], dtype=dtype)
                b.append_op("expand_to_rank_table_batch",
                            inputs={"X": boot,
                                    "RankTable": self.rank_table},
                            outputs={"Out": bvar}, infer_shape=False)
                init_name = bvar.name
                mem_shape = tuple([-1] + [int(s) for s in shape])
                mem_dtype = dtype
        pre_mem = self._sub_block.create_var(
            name=framework.unique_name.generate("mem@pre"),
            shape=mem_shape, dtype=mem_dtype)
        self._mem_by_name[pre_mem.name] = len(self.memories)
        self.memories.append((pre_mem, init_name, None))
        return pre_mem

    def output(self, *outputs):
        self._assert_in_block("output")
        for o in outputs:
            self.step_outputs.append(o)

    def _complete(self):
        main = self.helper.main_program
        main._rollback()
        parent = self._parent_block
        mem_names = []
        for pre, init, mem in self.memories:
            if mem is None:
                raise ValueError(
                    f"memory {pre.name} was never update_memory()'d")
            mem_names.append(mem)
        params = self._collect_param_names()
        padded_outs = []
        for o in self.step_outputs:
            out = parent.create_var(
                name=framework.unique_name.generate(f"{o.name}@padded"),
                shape=(-1, -1) + tuple(o.shape[1:]), dtype=o.dtype)
            padded_outs.append(out)
        parent.append_op(
            "recurrent",
            inputs={"inputs": [p for _, p in self.step_inputs],
                    "initial_states": [i for _, i, _ in self.memories],
                    "parameters": params,
                    "SequenceLengths": [self.rank_table.name]},
            outputs={"outputs": [o.name for o in padded_outs]},
            attrs={"sub_block": self._sub_block,
                   "input_names": [v.name for v, _ in self.step_inputs],
                   "state_names": [p.name for p, _, _ in self.memories],
                   "state_out_names": mem_names,
                   "output_names": [o.name for o in self.step_outputs],
                   "param_names": params,
                   "reverse": False},
            infer_shape=False)
        # unsort each padded output back to the packed LoD layout
        with _in_block(main, parent.idx):
            self.outputs = [array_to_lod_tensor(o, self.rank_table)
                            for o in padded_outs]

    def __call__(self, *args, **kwargs):
        if self.status != self.AFTER_RNN:
            raise ValueError("drnn() must be called after the block")
        return self.outputs[0] if len(self.outputs) == 1 \
            else self.outputs


class IfElse:
    """Row-wise two-branch select: `ie.input(x)` inside a branch yields
    the rows of x for that branch; outputs from both branches merge back
    in original row order. Both branches run on the full batch and the
    merge selects per row by the mask: exact for row-wise branches."""

    OUT_IF_ELSE_BLOCKS = 2

    def __init__(self, cond, name=None):
        self.helper = LayerHelper("ifelse", name=name)
        self.cond = cond
        self.input_table = {}
        self.status = None
        self.outputs = {True: [], False: []}

    class _Branch:
        def __init__(self, ie, is_true):
            self.ie = ie
            self.is_true = is_true

        def __enter__(self):
            self.ie.status = self.is_true
            return self

        def __exit__(self, exc_type, *a):
            self.ie.status = None
            return exc_type is None

    def true_block(self):
        return IfElse._Branch(self, True)

    def false_block(self):
        return IfElse._Branch(self, False)

    def input(self, x):
        if self.status is None:
            raise ValueError("IfElse.input() outside branch block")
        key = (x.name, self.status)
        if key not in self.input_table:
            t, f = split_lod_tensor(x, self.cond)
            self.input_table[(x.name, True)] = t
            self.input_table[(x.name, False)] = f
        return self.input_table[key]

    def output(self, *outs):
        if self.status is None:
            raise ValueError("IfElse.output() outside branch block")
        self.outputs[self.status].extend(outs)

    def __call__(self):
        t_outs, f_outs = self.outputs[True], self.outputs[False]
        if len(t_outs) != len(f_outs):
            raise ValueError(
                "true and false branches must produce the same number "
                "of outputs")
        return [merge_lod_tensor(t, f, t, self.cond)
                for t, f in zip(t_outs, f_outs)]
