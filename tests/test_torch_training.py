"""The port's training step against the JAX package's.

Both packages build the tiny fused Transformer (2+2 layers, d_model 32,
4 heads, d_inner 64, vocab 64, dropout 0) with Adam, with and without
contrib.mixed_precision.decorate (bf16 compute, float32 master weights);
the Programs must agree op for op. The port then starts from the JAX
package's initial parameters and Adam state and both take 3 steps on the
same ragged batch.

Tolerances:
* float32: every loss and every final parameter, moment and beta power
  within 1e-5 (float32 sums in another order through 3 steps).
* bf16 AMP: the two frameworks round to bf16 in other places, so the
  losses agree to LOSS_AMP_TOL. A gradient element near zero can change
  sign between them, and Adam then moves that weight by up to lr the
  other way each step: each final tensor is held at its 99th percentile
  of |difference| to Q99_AMP_TOL and at its maximum to 2 * steps * lr,
  the farthest two Adam trajectories can part. Moments are measured
  against the largest moment of their kind (MOMENT_*_AMP_TOL). Measured
  on this setup: loss 3.6e-4; parameters' 99th percentile 1.6e-3,
  maximum 1.09e-2; moments' 99th percentile 2.4e-3, maximum 7.4e-3.

Also here: the adam op against the JAX lowered adam, the per-run
randomness of the port (each run draws anew; a fresh scope replays the
draws), and the attention bias under AMP (rounded through bf16 on both
sides).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as fluid
from paddle_tpu.core import amp as jax_amp
from paddle_tpu.core.registry import ExecContext as JaxContext
from paddle_tpu.core.registry import OPS as JAX_OPS
from paddle_tpu.core.scope import Scope as JaxScope
from paddle_tpu.models import transformer as jax_transformer

import paddle_tpu_torch as pt
from paddle_tpu_torch.core import amp as pt_amp
from paddle_tpu_torch.core.registry import OPS as PT_OPS
from paddle_tpu_torch.core.registry import ExecContext as PtContext
from paddle_tpu_torch.io import load_params_from_numpy
from paddle_tpu_torch.kernels import registry as kreg
from paddle_tpu_torch.models import transformer as pt_transformer

from test_torch_ops import _Op

LR, STEPS = 2e-3, 3
F32_TOL = 1e-5
LOSS_AMP_TOL = 1e-3
Q99_AMP_TOL = 4e-3
MOMENT_Q99_AMP_TOL = 5e-3
MOMENT_MAX_AMP_TOL = 2e-2
B, S_SRC, S_TRG = 4, 16, 12


def _cfg(mod, dropout=0.0):
    cfg = mod.transformer_base(src_vocab_size=64, trg_vocab_size=64,
                               fuse_attention=True, dropout=dropout)
    cfg.n_layer, cfg.d_model, cfg.d_inner = 2, 32, 64
    cfg.n_head, cfg.d_head = 4, 8
    return cfg


def _build(fl, mod, amp, dropout=0.0):
    cfg = _cfg(mod, dropout)
    fl.framework.unique_name.reset()
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        cost, _, _ = mod.transformer_train(cfg)
        opt = fl.optimizer.AdamOptimizer(learning_rate=LR)
        if amp:
            opt = fl.contrib.mixed_precision.decorate(opt)
        opt.minimize(cost)
    return cfg, main, startup, cost


def _batch(mod, cfg):
    return mod.make_batch(cfg, B, S_SRC, S_TRG,
                          rng=np.random.default_rng(3),
                          src_lens=np.array([16, 11, 7, 13]),
                          trg_lens=np.array([12, 9, 5, 12]))


def _same_ops(jprog, pprog):
    jops, pops = jprog.global_block().ops, pprog.global_block().ops
    assert len(pops) == len(jops)
    for j, p in zip(jops, pops):
        assert p.type == j.type
        assert p._inputs == j._inputs, p.type
        assert p._outputs == j._outputs, p.type
        assert p.all_attrs() == j.all_attrs(), p.type


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "amp"])
def test_training_program_matches_jax_op_for_op(amp):
    _, jmain, jstartup, _ = _build(fluid, jax_transformer, amp)
    _, pmain, pstartup, _ = _build(pt, pt_transformer, amp)
    _same_ops(jmain, pmain)
    _same_ops(jstartup, pstartup)
    types = [o.type for o in pmain.global_block().ops]
    assert types.count("adam") == len(pmain.all_parameters()) == 87
    assert types.count("fused_attention_grad") == 6
    if amp:
        assert pmain._amp["dtype"] == torch.bfloat16
        assert sorted(pmain._amp["white_ops"]) == \
            sorted(jmain._amp["white_ops"])
        assert {"fused_attention", "mul"} <= pmain._amp["white_ops"]
        assert sorted(pmain._amp["black_ops"]) == \
            sorted(jmain._amp["black_ops"])
    else:
        assert pmain._amp is None
        assert getattr(jmain, "_amp", None) is None


def _train_both(amp):
    """3 steps in each package from the JAX initialization: (JAX losses,
    port losses, JAX scope, port scope, persistable names)."""
    cfg, jmain, jstartup, jcost = _build(fluid, jax_transformer, amp)
    _, pmain, pstartup, pcost = _build(pt, pt_transformer, amp)
    feed = _batch(jax_transformer, cfg)
    jscope, pscope = JaxScope(), pt.Scope()
    jexe, pexe = fluid.Executor(fluid.CPUPlace()), pt.Executor(pt.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    pexe.run(pstartup, scope=pscope)
    names = [v.name for v in jmain.global_block().vars.values()
             if v.persistable and jscope.find_var(v.name) is not None]
    load_params_from_numpy(
        pscope, {p.name: np.asarray(jscope.find_var(p.name).get_tensor())
                 for p in jmain.all_parameters()}, pt.CPUPlace())
    jl, pl = [], []
    kreg.reset_counts()
    for _ in range(STEPS):
        jl.append(float(np.asarray(jexe.run(jmain, feed=feed,
                                            fetch_list=[jcost],
                                            scope=jscope)[0])))
        pl.append(float(pexe.run(pmain, feed=feed, fetch_list=[pcost],
                                 scope=pscope)[0]))
    assert not any(kreg.launches().values())   # CPU: the plain versions
    return jl, pl, jscope, pscope, names


def _final(scope, n):
    return np.asarray(scope.find_var(n).get_tensor())


def test_three_steps_match_jax_float32():
    jl, pl, jscope, pscope, names = _train_both(amp=False)
    np.testing.assert_allclose(pl, jl, rtol=F32_TOL, atol=F32_TOL)
    assert pl[-1] < pl[0]
    assert any("moment1" in n for n in names)
    for n in names:
        got, want = _final(pscope, n), _final(jscope, n)
        assert got.dtype == want.dtype == np.float32, n
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL,
                                   err_msg=n)


def test_three_steps_match_jax_bf16_amp():
    jl, pl, jscope, pscope, names = _train_both(amp=True)
    np.testing.assert_allclose(pl, jl, rtol=0, atol=LOSS_AMP_TOL)
    assert pl[-1] < pl[0]
    # a moment is measured against the largest moment of its kind: some
    # gradients are zero but for rounding noise (the key biases')
    scale = {k: max(float(np.abs(_final(jscope, n)).max())
                    for n in names if k in n)
             for k in ("moment1", "moment2")}
    for n in names:
        got, want = _final(pscope, n), _final(jscope, n)
        assert got.dtype == want.dtype == np.float32, n   # f32 masters
        d = np.abs(got.astype(np.float64) - want).ravel()
        kind = next((k for k in scale if k in n), None)
        if kind is None:
            assert np.quantile(d, 0.99) <= Q99_AMP_TOL, n
            assert d.max() <= 2 * STEPS * LR + 1e-6, n
        else:
            d = d / scale[kind]
            assert np.quantile(d, 0.99) <= MOMENT_Q99_AMP_TOL, n
            assert d.max() <= MOMENT_MAX_AMP_TOL, n


def _ulps(a, b):
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return np.abs(ia - ib)


# the plain Adam repeats the JAX lowered adam's operations in the same
# order: measured 0 ulp apart on lengths 1 to 262144; the bound leaves
# one ulp for a CPU on which XLA contracts a multiply-add
ADAM_ULP = 1


@pytest.mark.parametrize("n", [1, 511, 513, 4096])
def test_adam_op_matches_jax_lowered_adam(n):
    rng = np.random.default_rng(n)
    ins = {"Param": rng.standard_normal(n).astype(np.float32),
           "Grad": rng.standard_normal(n).astype(np.float32),
           "Moment1": (0.1 * rng.standard_normal(n)).astype(np.float32),
           "Moment2": (0.01 * rng.random(n)).astype(np.float32),
           "LearningRate": np.array([2e-4], np.float32),
           "Beta1Pow": np.array([0.9 ** 3], np.float32),
           "Beta2Pow": np.array([0.999 ** 3], np.float32)}
    outs = ["ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut",
            "Beta2PowOut"]
    attrs = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}
    op = _Op("adam", ins, outs, attrs)
    jenv = {s.lower(): jnp.asarray(a) for s, a in ins.items()}
    JAX_OPS.get("adam").lowering(JaxContext(op, jenv))
    penv = {s.lower(): torch.from_numpy(a.copy()) for s, a in ins.items()}
    kreg.reset_counts()
    PT_OPS.get("adam").lowering(PtContext(op, penv, torch.device("cpu")))
    assert kreg.launches()["fused_adam"] == 0
    for s in outs:
        want = np.asarray(jenv[op.output(s)[0]])
        got = penv[op.output(s)[0]].numpy()
        assert got.shape == want.shape and got.dtype == np.float32, s
        assert _ulps(got, want).max() <= ADAM_ULP, s


def _dropout_program():
    """The tiny Transformer with dropout 0.1 (dropout ops and attention
    dropout), trained: fetch every dropout mask and the cost."""
    cfg, main, startup, cost = _build(pt, pt_transformer, amp=False,
                                      dropout=0.1)
    masks = [op.output("Mask")[0] for op in main.global_block().ops
             if op.type == "dropout"]
    assert masks
    return cfg, main, startup, cost, masks


def test_each_run_draws_new_masks_and_a_fresh_scope_replays_them():
    cfg, main, startup, cost, masks = _dropout_program()
    feed = _batch(pt_transformer, cfg)
    exe = pt.Executor(pt.CPUPlace())

    def runs(n):
        scope = pt.Scope()
        exe.run(startup, scope=scope)
        return [exe.run(main, feed=feed, fetch_list=masks + [cost],
                        scope=scope) for _ in range(n)]

    first, second = runs(2), runs(2)
    for a, b in zip(first, second):        # fresh scope: same draws
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    changed = [not np.array_equal(x, y)
               for x, y in zip(first[0][:-1], first[1][:-1])]
    assert all(changed)                    # every run: new masks
    assert first[0][-1] != first[1][-1]


def test_attention_dropout_seed_words_change_per_run():
    """The fused_attention op's two hash-seed words come from the program
    seed, the op uid and the run index; its grad op (same uid) gets the
    same words."""
    from paddle_tpu_torch.core.registry import RunState
    _, main, _, _, _ = _dropout_program()
    ops = main.global_block().ops
    fwd = next(op for op in ops if op.type == "fused_attention")
    grad = next(op for op in ops if op.type == "fused_attention_grad"
                and op.attr("__op_uid__") == fwd.attr("__op_uid__"))
    cpu = torch.device("cpu")
    words = [PtContext(o, {}, cpu, RunState(main.random_seed, r))
             .seed_words() for r in (0, 1) for o in (fwd, grad)]
    assert words[0] == words[1] and words[2] == words[3]
    assert words[0] != words[2]


def test_attention_bias_under_amp_rounds_through_bf16():
    """A non-mask bias under AMP: the port's fused_attention rounds it
    through bf16 (as the JAX op casts it with q/k/v), so both add the
    same bias. Held against the JAX op under its amp_guard, and against
    the port's output with a bias that was never rounded."""
    rng = np.random.default_rng(4)
    ins = {"Q": rng.standard_normal((2, 12, 4, 8)).astype(np.float32),
           "K": rng.standard_normal((2, 16, 4, 8)).astype(np.float32),
           "V": rng.standard_normal((2, 16, 4, 8)).astype(np.float32),
           "BiasQK": (3 * rng.standard_normal((2, 4, 12, 16))).astype(
               np.float32)}
    attrs = {"scale": 8 ** -0.5, "layout": "bshd", "causal": False}
    op = _Op("fused_attention", ins, ["Out"], attrs)
    jenv = {s.lower(): jnp.asarray(a) for s, a in ins.items()}
    with jax_amp.amp_guard(True, jnp.bfloat16, (), ("fused_attention",)):
        JAX_OPS.get("fused_attention").lowering(JaxContext(op, jenv))

    def port(bias):
        env = {s.lower(): torch.from_numpy(a.copy()) for s, a in ins.items()}
        env["biasqk"] = bias
        with pt_amp.amp_guard(True, torch.bfloat16, (),
                              ("fused_attention",)):
            PT_OPS.get("fused_attention").lowering(
                PtContext(op, env, torch.device("cpu")))
        return env["out_out"]

    bias = torch.from_numpy(ins["BiasQK"])
    got = port(bias)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jenv["out_out"].astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2)
    # the bias the kernels read is the bf16-rounded one: rounding it
    # beforehand changes nothing, bit for bit
    torch.testing.assert_close(port(bias.bfloat16().float()), got, rtol=0,
                               atol=0)
