"""The port's backward against the JAX package's.

append_backward builds the tiny fused Transformer's gradient program
(2+2 layers, d_model 32, 4 heads, vocab 64, dropout 0) in both packages;
the two must agree op for op. The JAX package then runs forward and
backward on one ragged batch and every intermediate value is fetched.
Each op of the backward section (every `<type>_grad`, the `sum` ops that
add up repeated gradients and the loss seed) then runs through the
port's lowering on the JAX values of its inputs, and its outputs are held
against the JAX values.

Tolerance: 1e-5 relative and absolute. Both sides run float32 on the CPU
and differ only in the order of float32 sums.

The dropout gradient cannot be held against the JAX package (the two
draw different masks), so it is held against the port's own forward
mask: the grad op must reuse the forward's draw, never draw anew.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.core.scope import Scope as JaxScope
from paddle_tpu.models import transformer as jax_transformer

import paddle_tpu_torch as pt
from paddle_tpu_torch.core.registry import OPS as PT_OPS
from paddle_tpu_torch.core.registry import ExecContext
from paddle_tpu_torch.core.types import dtype_to_torch
from paddle_tpu_torch.models import transformer as pt_transformer
from torch_threads import one_torch_thread  # noqa: F401

RTOL = ATOL = 1e-5
B, S_SRC, S_TRG = 4, 16, 12


def _cfg(mod):
    cfg = mod.transformer_base(src_vocab_size=64, trg_vocab_size=64,
                               fuse_attention=True, dropout=0.0)
    cfg.n_layer, cfg.d_model, cfg.d_inner = 2, 32, 64
    cfg.n_head, cfg.d_head = 4, 8
    return cfg


def _build(fl, mod):
    cfg = _cfg(mod)
    fl.framework.unique_name.reset()
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        cost, _, _ = mod.transformer_train(cfg)
        fl.backward.append_backward(cost)
    return cfg, main, startup, cost


def _backward_ops(block):
    ops = block.ops
    first = next(i for i, op in enumerate(ops) if op.type == "fill_constant"
                 and op.output("Out")[0].endswith("@GRAD"))
    return list(enumerate(ops))[first:]


@pytest.fixture(scope="module")
def both():
    """(JAX main, port main, {var name: JAX value}) after one JAX
    forward and backward."""
    cfg, jmain, jstartup, _ = _build(fluid, jax_transformer)
    _, pmain, _, _ = _build(pt, pt_transformer)
    feed = jax_transformer.make_batch(
        cfg, B, S_SRC, S_TRG, rng=np.random.default_rng(3),
        src_lens=np.array([16, 11, 7, 13]),
        trg_lens=np.array([12, 9, 5, 12]))
    block = jmain.global_block()
    names = sorted({n for op in block.ops
                    for n in op.input_arg_names + op.output_arg_names
                    if n and n not in feed})
    scope = JaxScope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(jstartup, scope=scope)
    persist = [n for n in names if block.var(n).persistable]
    values = {n: np.asarray(scope.find_var(n).get_tensor())
              for n in persist}
    rest = [n for n in names if n not in values]
    outs = exe.run(jmain, feed=feed, fetch_list=rest, scope=scope)
    values.update({n: np.asarray(o) for n, o in zip(rest, outs)})
    values.update(feed)
    return jmain, pmain, values


def test_backward_program_matches_jax_op_for_op(both):
    jmain, pmain, _ = both
    jops, pops = jmain.global_block().ops, pmain.global_block().ops
    assert len(pops) == len(jops)
    for j, p in zip(jops, pops):
        assert p.type == j.type
        assert p._inputs == j._inputs, p.type
        assert p._outputs == j._outputs, p.type
        assert p.all_attrs() == j.all_attrs(), p.type
    jv, pv = jmain.global_block().vars, pmain.global_block().vars
    assert sorted(pv) == sorted(jv)
    for n in jv:
        assert pv[n].stop_gradient == jv[n].stop_gradient, n
    assert [o.attr("op_role") for o in pops] == \
        [o.attr("op_role") for o in jops]


_BACKWARD_TYPES = ["add_position_encoding_grad", "elementwise_add_grad",
                   "elementwise_div_grad", "elementwise_mul_grad",
                   "fill_constant", "fused_attention_grad",
                   "label_smoothed_softmax_xent_grad", "layer_norm_grad",
                   "lookup_table_grad", "mul_grad", "reduce_sum_grad",
                   "relu_grad", "reshape2_grad", "scale_grad",
                   "squeeze2_grad", "sum"]


def test_every_backward_op_type_is_covered(both):
    jmain, _, _ = both
    assert sorted({op.type for _, op in
                   _backward_ops(jmain.global_block())}) == _BACKWARD_TYPES


def _as_torch(block, name, value):
    t = torch.from_numpy(np.array(value))
    var = block.find_var(name)
    if var is not None and t.is_floating_point():
        t = t.to(dtype_to_torch(var.dtype))
    return t


@pytest.fixture(scope="module")
def replay(both):
    """Run the port's backward section op by op. Each op reads the JAX
    value of every input that the backward writes at most once; a name
    written again (the first of repeated gradients, which `sum` then
    overwrites in place) is read as the port left it. Returns
    [(op, {output name: port value})] and the names written more than
    once."""
    _, pmain, values = both
    block = pmain.global_block()
    bwd = _backward_ops(block)
    writes = {}
    for _, op in bwd:
        for n in op.output_arg_names:
            writes[n] = writes.get(n, 0) + 1
    env, results = {}, []
    for _, op in bwd:
        for n in op.input_arg_names:
            if n and (writes.get(n, 0) <= 1 or n not in env):
                env[n] = _as_torch(block, n, values[n])
        with torch.no_grad():
            PT_OPS.get(op.type).lowering(
                ExecContext(op, env, torch.device("cpu")))
        results.append((op, {n: env[n].clone() for n in op.output_arg_names
                             if n}))
    return results, {n for n, c in writes.items() if c > 1}


@pytest.mark.parametrize("op_type", _BACKWARD_TYPES)
def test_backward_op_matches_jax(both, replay, op_type):
    _, _, values = both
    results, rewritten = replay
    last_writer = {n: i for i, (_, outs) in enumerate(results)
                   for n in outs}
    checked = 0
    for i, (op, outs) in enumerate(results):
        if op.type != op_type:
            continue
        for n, got in outs.items():
            if n in rewritten and last_writer[n] != i:
                continue   # an intermediate value JAX does not keep
            want = values[n]
            assert got.shape == want.shape, (op.type, n)
            np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                                       atol=ATOL,
                                       err_msg=f"{op.type} -> {n}")
            checked += 1
    assert checked


def _dropout_program(impl):
    pt.framework.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[6, 8], dtype="float32")
        x.stop_gradient = False
        y = pt.layers.dropout(x, dropout_prob=0.3,
                              dropout_implementation=impl)
        w = pt.layers.data(name="w", shape=[6, 8], dtype="float32")
        loss = pt.layers.reduce_sum(pt.layers.elementwise_mul(y, w))
        pt.backward.append_backward(loss)
    mask = main.global_block().ops[0].output("Mask")[0]
    return main, y, mask


@pytest.mark.parametrize("impl", ["upscale_in_train", "downgrade_in_infer"])
def test_dropout_grad_reuses_the_forward_mask(impl):
    main, y, mask = _dropout_program(impl)
    rng = np.random.default_rng(0)
    feed = {"x": rng.standard_normal((3, 6, 8)).astype(np.float32),
            "w": rng.standard_normal((3, 6, 8)).astype(np.float32)}
    exe = pt.Executor(pt.CPUPlace())
    out, m, gx = exe.run(main, feed=feed,
                         fetch_list=[y, mask, "x@GRAD"], scope=pt.Scope())
    t = round(0.7 * 256)
    scale = 256.0 / t if impl == "upscale_in_train" else 1.0
    assert m.dtype == np.uint8 and 0 < m.mean() < 1
    np.testing.assert_allclose(out, feed["x"] * m * scale, rtol=1e-6)
    np.testing.assert_allclose(gx, feed["w"] * m * scale, rtol=1e-6)


def test_dropout_grad_without_a_record_draws_the_forward_mask():
    """A grad op that finds no forward record (a block that holds the
    grad op but not its forward) regenerates the mask from the same
    seed: it must equal the forward's mask."""
    main, y, mask = _dropout_program("upscale_in_train")
    block = main.global_block()
    fwd, grad = block.ops[0], next(op for op in block.ops
                                   if op.type == "dropout_grad")
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((3, 6, 8)).astype(np.float32))
    g = torch.ones_like(x)
    env = {"x": x}
    with torch.no_grad():
        PT_OPS.get("dropout").lowering(ExecContext(fwd, env,
                                                   torch.device("cpu")))
        env[y.name + "@GRAD"] = g
        PT_OPS.get("dropout_grad").lowering(
            ExecContext(grad, env, torch.device("cpu")))
    keep = env[mask].bool()
    np.testing.assert_allclose(env["x@GRAD"].numpy(),
                               torch.where(keep, g * 256 / 179, 0).numpy(),
                               rtol=1e-6)
