"""Control-flow ops over sub-blocks, the tensor-array ops and the
DynamicRNN machinery (counterpart of paddle_tpu/ops/control_flow.py).

A control-flow op names its body by a block attr (`sub_block`) and runs
it through ExecContext.block_runner, on an env it makes: the engine runs
the body's ops in the same run (core/engine.py SubBlocks).

* `while` reads its condition on the host before every trip, and
  `conditional_block` its condition once: both are host reads of a device
  value, so the capture rule's meta-device run fails on them and keeps
  their block eager (Engine.eager_reasons), where the JAX package traces
  lax.while_loop / reads the condition at trace time.
* `recurrent` (StaticRNN, DynamicRNN) is a torch loop over the padded
  time steps, the counterpart of the JAX lax.scan, with its masked
  semantics: with SequenceLengths (a LoDRankTable), a memory holds its
  value past its sequence's end and an output is zero there. Its trip
  count is the host LoD's, so a DynamicRNN block is shape-static for a
  LoD and is captured with it. On the meta device (the capture rule's
  run) it runs one step and gives the outputs' shapes. Its gradient is
  the generic one: the forward runs with its inputs, boot states and
  `parameters` (every outer var the body reads) as autograd leaves, the
  body's ops under autograd.
* The rank-table ops read the LoD on the host, as the sequence ops do
  (ops/sequence.py), and make their index tensors once a plan through
  ExecContext.host_table: sequences sorted by length (LoDRankTable), the
  packed rows padded into a time-major [T, sequences, ...] block with
  zeros, and back.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.registry import register_no_grad_op, register_op
from ..core.scope import LoDRankTable, TensorArray


def _block_idx(ctx):
    b = ctx.attr("sub_block")
    return getattr(b, "idx", b)


def _host_value(ctx, t, what):
    """A device value read on the host; refused on the meta device (the
    capture rule's run), which keeps the block eager."""
    if t.device.type == "meta":
        raise RuntimeError(f"{ctx.op.type}: its {what} is read on the "
                           f"host, so its block cannot be captured")
    return t.detach().cpu()


def _raw(ctx, slot):
    """The value of an input slot as the env holds it (no AMP cast): a
    TensorArray, a LoDRankTable or a tensor."""
    return ctx.env[ctx.op.input(slot)[0]]


def _set_raw(ctx, slot, value):
    ctx.env[ctx.op.output(slot)[0]] = value


@register_no_grad_op("print")
def print_op(ctx):
    """Print the message and the tensor's value on the host, and pass
    the tensor on. Build-time shape inference (no run) only passes it."""
    x = ctx.input("In")
    if ctx.run is not None:
        print(ctx.attr("message", "") or "",
              _host_value(ctx, x, "tensor").numpy())
    ctx.set_output("Out", x)


@register_no_grad_op("assert")
def assert_op(ctx):
    pass   # as in the JAX package: checked nowhere


@register_no_grad_op("while")
def while_op(ctx):
    """Run the body while Condition holds. The carries are X (every
    outer var the body reads or writes) and the condition; the body runs
    on an env of the carries alone, and its values of them carry on."""
    cond_name = ctx.op.input("Condition")[0]
    idx = _block_idx(ctx)
    names = sorted(set(ctx.op.input("X") or []) | {cond_name})
    runner = ctx.block_runner
    carry = {n: ctx.env[n] for n in names}
    while bool(_host_value(ctx, carry[cond_name], "condition")
               .reshape(())):
        env = dict(carry)
        runner(idx, env)
        carry = {n: env[n] for n in names}
    ctx.env.update(carry)


@register_no_grad_op("conditional_block")
def conditional_block(ctx):
    """Run the body on this op's env when every element of the first
    Cond holds."""
    cond = ctx.inputs("Cond")
    if bool(_host_value(ctx, cond[0], "condition").all()):
        ctx.block_runner(_block_idx(ctx), None)


# ---------------------------------------------------------------------------
# tensor arrays
# ---------------------------------------------------------------------------

@register_no_grad_op("write_to_array")
def write_to_array(ctx):
    x = ctx.input("X")
    i = int(_host_value(ctx, ctx.input("I"), "index").reshape(-1)[0])
    name = ctx.op.output("Out")[0]
    arr = ctx.env.get(name)
    if not isinstance(arr, TensorArray):
        arr = TensorArray()
    while len(arr) <= i:
        arr.append(None)
    arr[i] = x
    ctx.env[name] = arr


@register_op("read_from_array", no_grad_slots=("I",))
def read_from_array(ctx):
    arr = _raw(ctx, "X")
    i = int(_host_value(ctx, ctx.input("I"), "index").reshape(-1)[0])
    ctx.set_output("Out", arr[i])


@register_no_grad_op("lod_array_length")
def lod_array_length(ctx):
    ctx.set_output("Out", torch.full((1,), len(_raw(ctx, "X")),
                                     dtype=torch.int64, device=ctx.device))


@register_no_grad_op("tensor_array_to_tensor")
def tensor_array_to_tensor(ctx):
    """The array's tensors stacked (use_stack) or concatenated along
    `axis`, and each one's size along it."""
    vals = list(_raw(ctx, "X"))
    axis = ctx.attr("axis", 0)
    out = torch.stack(vals, axis) if ctx.attr("use_stack", False) else \
        torch.cat(vals, axis)
    sizes = tuple(int(v.shape[axis]) for v in vals)
    ctx.set_output("Out", out)
    ctx.set_output("OutIndex", ctx.host_table(
        "array_sizes", sizes, lambda: np.asarray(sizes, np.int32)))


@register_no_grad_op("max_sequence_len")
def max_sequence_len(ctx):
    ctx.set_output("Out", torch.full((), _table(ctx).max_len,
                                     dtype=torch.int64, device=ctx.device))


@register_no_grad_op("delete_var")
def delete_var(ctx):
    for slot in ctx.op.input_slots():
        for n in ctx.op.input(slot):
            ctx.env.pop(n, None)


# ---------------------------------------------------------------------------
# the rank table and the DynamicRNN layout
# ---------------------------------------------------------------------------

def _table(ctx, slot="RankTable") -> LoDRankTable:
    t = _raw(ctx, slot)
    if not isinstance(t, LoDRankTable):
        raise TypeError(f"{ctx.op.type}: {slot} must be a LoDRankTable, "
                        f"got {type(t).__name__}")
    return t


@register_no_grad_op("lod_rank_table")
def lod_rank_table(ctx):
    """The rank table of LoD level `level` of X; a tensor with no LoD
    counts each row as a sequence of length 1."""
    lod = ctx.get_lod("X")
    offsets = lod[int(ctx.attr("level", 0))] if lod else \
        list(range(int(_raw(ctx, "X").shape[0]) + 1))
    _set_raw(ctx, "Out", LoDRankTable(offsets))


def _to_array_index(table, rows):
    """[T * n] rows of packed X for the padded time-major block, in
    rank-table order; `rows` (one past the last row) marks padding."""
    T = table.max_len
    idx = np.full((T, len(table)), rows, np.int64)
    for r, (seq, length) in enumerate(table.items):
        idx[:length, r] = table.offsets[seq] + np.arange(length)
    return idx.reshape(-1)


@register_op("lod_tensor_to_array", no_grad_slots=("RankTable",))
def lod_tensor_to_array(ctx):
    """Packed [rows, ...] -> padded time-major [T, n, ...]: the
    sequences in rank-table order, zeros past each one's end."""
    x = ctx.input("X")
    table = _table(ctx)
    rows = int(x.shape[0])
    idx = ctx.host_table("to_array", table.key(),
                        lambda: _to_array_index(table, rows))
    padded = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])
    ctx.set_output("Out", padded[idx].reshape(
        (table.max_len, len(table)) + tuple(x.shape[1:])))


def _from_array_index(table, n):
    """[rows] slots of the flattened [T * n] block that each packed row
    (original sequence order) reads."""
    rank_of = {seq: r for r, (seq, _) in enumerate(table.items)}
    return np.concatenate(
        [np.arange(table.offsets[s + 1] - table.offsets[s]) * n +
         rank_of[s] for s in range(n)] or [np.zeros(0)]).astype(np.int64)


@register_op("array_to_lod_tensor", no_grad_slots=("RankTable",))
def array_to_lod_tensor(ctx):
    """Padded [T, n, ...] (rank-table order) -> packed [rows, ...] in the
    original sequence order, with the table's LoD."""
    x = ctx.input("X")
    table = _table(ctx)
    n = len(table)
    flat = x.reshape((int(x.shape[0]) * n,) + tuple(x.shape[2:]))
    idx = ctx.host_table("from_array", table.key(),
                        lambda: _from_array_index(table, n))
    ctx.set_output("Out", flat[idx])
    base = table.offsets[0]
    ctx.set_lod("Out", [[o - base for o in table.offsets]])


@register_op("reorder_lod_tensor_by_rank", no_grad_slots=("RankTable",))
def reorder_lod_tensor_by_rank(ctx):
    """X's rows in rank-table order (a DynamicRNN boot memory aligned
    with the sorted sequences)."""
    table = _table(ctx)
    idx = ctx.host_table("rank_order", table.key(),
                        lambda: np.asarray(table.indices, np.int64))
    ctx.set_output("Out", ctx.input("X")[idx])


@register_op("shrink_rnn_memory", no_grad_slots=("I", "RankTable"))
def shrink_rnn_memory(ctx):
    """The identity: the padded layout keeps every row of a memory (the
    recurrent loop masks the finished ones), as in the JAX package."""
    ctx.set_output("Out", ctx.input("X"))


@register_op("expand_to_rank_table_batch", no_grad_slots=("RankTable",))
def expand_to_rank_table_batch(ctx):
    """A [1, ...] boot value broadcast to [n, ...]."""
    x = ctx.input("X")
    ctx.set_output("Out", x.expand((len(_table(ctx)),) +
                                   tuple(x.shape[1:])))


def _row_mask(mask, x):
    return mask.reshape((-1,) + (1,) * (x.dim() - 1)).bool()


@register_op("split_lod_tensor", no_grad_slots=("Mask",))
def split_lod_tensor(ctx):
    """Both outputs keep every row: the rows of the other branch are
    zero (merge_lod_tensor selects by the same mask)."""
    x = ctx.input("X")
    m = _row_mask(ctx.input("Mask"), x)
    ctx.set_output("OutTrue", torch.where(m, x, 0.0))
    ctx.set_output("OutFalse", torch.where(m, 0.0, x))


@register_op("merge_lod_tensor", no_grad_slots=("Mask", "X"))
def merge_lod_tensor(ctx):
    t, f = ctx.input("InTrue"), ctx.input("InFalse")
    ctx.set_output("Out", torch.where(_row_mask(ctx.input("Mask"), t), t, f))


# ---------------------------------------------------------------------------
# the recurrent block
# ---------------------------------------------------------------------------

def _live_mask(table, T):
    """[T, n] bool: sequence r (rank-table order) is live at step t."""
    return np.arange(T)[:, None] < np.asarray(table.lengths)[None, :]


@register_op("recurrent", no_grad_slots=("SequenceLengths",))
def recurrent(ctx):
    """The body over T time steps (reference recurrent_op.cc): each
    step's env binds the `parameters` (param_names), the memories
    (state_names) and the step slices of the time-major inputs
    (input_names); the body's state_out_names are the next memories and
    its output_names the step outputs, stacked time-major. With
    SequenceLengths, a sequence's memories hold and its outputs are zero
    from its end on. `reverse` runs the steps from T-1 down."""
    idx = _block_idx(ctx)
    in_names = list(ctx.attr("input_names", []) or [])
    state_names = list(ctx.attr("state_names", []) or [])
    state_out_names = list(ctx.attr("state_out_names", []) or [])
    output_names = list(ctx.attr("output_names", []) or [])
    param_names = list(ctx.attr("param_names", []) or [])
    xs = ctx.inputs("inputs")
    carry = ctx.inputs("initial_states")
    params = ctx.inputs("parameters")
    table = _raw(ctx, "SequenceLengths") \
        if ctx.has_input("SequenceLengths") else None
    T = int(xs[0].shape[0]) if xs else int(ctx.attr("max_len"))
    meta = ctx.device.type == "meta"
    steps = range(T - 1, -1, -1) if ctx.attr("reverse", False) \
        else range(T)
    if meta:   # the capture rule's run: one step gives the shapes
        steps = steps[:1]
    live = all_live = None
    if isinstance(table, LoDRankTable):
        live = ctx.host_table("rnn_live", (table.key(), T),
                             lambda: _live_mask(table, T))
        all_live = min(table.lengths, default=0)
    runner = ctx.block_runner
    ys = {}
    for t in steps:
        env = dict(zip(param_names, params))
        env.update(zip(state_names, carry))
        env.update(zip(in_names, (x[t] for x in xs)))
        runner(idx, env)
        new = [env[n] for n in state_out_names]
        outs = [env[n] for n in output_names]
        if live is not None and t >= all_live:
            m = live[t]
            new = [torch.where(_row_mask(m, a), a, b)
                   for a, b in zip(new, carry)]
            outs = [torch.where(_row_mask(m, o), o, 0.0) for o in outs]
        carry = new
        ys[t] = outs
    if output_names:
        if meta:
            (step_outs,) = ys.values()
            stacked = [o.unsqueeze(0).expand((T,) + tuple(o.shape))
                       for o in step_outs]
        else:
            stacked = [torch.stack([ys[t][k] for t in range(T)])
                       for k in range(len(output_names))]
        ctx.set_outputs("outputs", stacked)
    if ctx.has_output("final_states"):
        ctx.set_outputs("final_states", list(carry))
