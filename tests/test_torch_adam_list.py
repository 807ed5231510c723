"""Adam as one multi-tensor update, against the JAX package.

* The list entry's plain version (fused_adam_multi on CPU tensors) over
  seeded odd lengths, each tensor with beta powers of its own: 0 ulp
  from the port's adam op in every output, the new beta powers
  included, and within test_torch_training.ADAM_ULP of the JAX lowered
  adam (paddle_tpu/ops/optimizer_ops.py; XLA on the CPU may contract a
  multiply-add: measured 1 ulp at 65537 elements, 0 below).
* Weight decay (the JAX kernel's (lr_t*wd)*p term): fused_adam and
  fused_adam_multi against the JAX fused_adam Pallas kernel in interpret
  mode, with and without weight decay. XLA on the CPU rounds that kernel
  otherwise than its own lowered op (where m nearly cancels, the two
  differ by thousands of ulp of m, and p' by up to 1024 ulp where it
  nearly cancels), so the band is stated against the magnitudes of the
  terms: m' and v' within 2^-22 of the sum of their two terms'
  magnitudes (measured 2^-23), p' within 2^-21 of |p| + |the update|
  (measured 1.8e-7 without and 1.9e-7 with weight decay, over 20 seeds
  of these lengths).
* The entry checks its lists: lengths here, and, before the kernel is
  built, dtypes, devices and the beta powers' size.
* The engine's grouping: a run of adam ops that share a LearningRate,
  beta1, beta2 and epsilon goes to one call of the kernel's list entry.
  Three steps of a small Transformer (2+2 layers, d_model 64) at
  PT_KERNEL_MIN_NUMEL=1 with the CPU routing hook armed give the same
  bits grouped as op by op, and match the JAX package's three steps
  within tests/test_torch_training.py's float32 tolerance; the registry
  still counts one decision per op.
* Which ops a group takes: same type, same key, no op reading what an
  earlier one of the run wrote.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as fluid
from paddle_tpu.core.scope import Scope as JaxScope
from paddle_tpu.kernels import fused_optimizer as jfo
from paddle_tpu.models import transformer as jax_transformer

import paddle_tpu_torch as pt
from paddle_tpu_torch.core import engine
from paddle_tpu_torch.core.registry import OPS as PT_OPS
from paddle_tpu_torch.io import load_params_from_numpy
from paddle_tpu_torch.kernels import fused_optimizer as pfo
from paddle_tpu_torch.kernels import registry as kreg
from paddle_tpu_torch.models import transformer as pt_transformer

from test_torch_ops import _run_both
from test_torch_training import ADAM_ULP, F32_TOL, _ulps
from torch_threads import one_torch_thread  # noqa: F401

B1, B2, EPS = 0.9, 0.999, 1e-8
LR, STEPS = 2e-3, 3
# lengths that cut float4 runs and 4096-element chunks
_SHAPES = [(1,), (3,), (4,), (127,), (129,), (513, 7), (4097,), (65537,)]
_OUTS = ["ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut",
         "Beta2PowOut"]
# the band against the JAX kernel in interpret mode (see the docstring)
MV_REL = 2.0 ** -22
P_REL = 2.0 ** -21


@pytest.fixture(autouse=True)
def _clean_registry():
    kreg.reset_stats()
    yield
    kreg.reset_stats()


def _state(seed, shapes=_SHAPES):
    """Per tensor: p, g, m, v, Beta1Pow, Beta2Pow (step 1 to 8)."""
    r = np.random.default_rng(seed)
    out = []
    for sh in shapes:
        t = int(r.integers(1, 9))
        out.append((r.standard_normal(sh).astype(np.float32),
                    r.standard_normal(sh).astype(np.float32),
                    (0.1 * r.standard_normal(sh)).astype(np.float32),
                    (0.01 * r.random(sh)).astype(np.float32),
                    np.array([B1 ** t], np.float32),
                    np.array([B2 ** t], np.float32)))
    return out


def _multi(state, lr, **kw):
    cols = list(zip(*state))
    return pfo.fused_adam_multi(*([torch.from_numpy(a.copy()) for a in c]
                                  for c in cols[:4]),
                                torch.tensor([lr], dtype=torch.float32),
                                *([torch.from_numpy(a.copy()) for a in c]
                                  for c in cols[4:]),
                                beta1=B1, beta2=B2, epsilon=EPS, **kw)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_adam_list_plain_matches_jax_lowered_adam(seed):
    state = _state(seed)
    lr = np.float32(2e-4 * (seed + 1))
    kreg.reset_counts()
    got = _multi(state, lr)
    assert not any(kreg.launches().values())      # CPU: the plain version
    assert all(len(lst) == len(state) for lst in got)
    for i, (p, g, m, v, b1p, b2p) in enumerate(state):
        want = _run_both("adam", {
            "Param": p, "Grad": g, "Moment1": m, "Moment2": v,
            "LearningRate": np.array([lr], np.float32),
            "Beta1Pow": b1p, "Beta2Pow": b2p}, _OUTS,
            {"beta1": B1, "beta2": B2, "epsilon": EPS})
        for s, out in zip(_OUTS, got):
            j, op = want[s]
            o = out[i].numpy()
            assert o.shape == j.shape and o.dtype == np.float32, s
            assert np.array_equal(o, op), (s, p.shape)
            assert _ulps(o, j).max() <= ADAM_ULP, (s, p.shape)


def _jax_band(got, want, p, g, m, v, lr_t):
    """got (p', m', v') of the port within the stated band of the JAX
    kernel's want."""
    b1m = np.abs(np.float32(B1) * m) + np.abs(np.float32(1 - B1) * g)
    b2v = np.abs(np.float32(B2) * v) + np.abs(np.float32(1 - B2) * g * g)
    upd = lr_t * np.abs(got[1]) / (np.sqrt(got[2]) + EPS)
    assert np.all(np.abs(got[0].astype(np.float64) - want[0]) <=
                  P_REL * (np.abs(p) + upd))
    assert np.all(np.abs(got[1].astype(np.float64) - want[1]) <=
                  MV_REL * b1m)
    assert np.all(np.abs(got[2].astype(np.float64) - want[2]) <=
                  MV_REL * b2v)


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_weight_decay_matches_jax_fused_adam_interpret(wd):
    state = _state(10 + int(wd * 100))
    lr = np.float32(2e-4)
    multi = _multi(state, lr, weight_decay=wd)
    for i, (p, g, m, v, b1p, b2p) in enumerate(state):
        lr_t = (torch.tensor(lr) * torch.sqrt(1 - torch.from_numpy(b2p)[0])
                / (1 - torch.from_numpy(b1p)[0]))
        want = [np.asarray(x) for x in jfo.fused_adam(
            jnp.asarray(p), jnp.asarray(g), jnp.asarray(m), jnp.asarray(v),
            jnp.asarray(lr_t.numpy()), beta1=B1, beta2=B2, epsilon=EPS,
            weight_decay=wd)]
        one = [t.numpy() for t in pfo.fused_adam(
            *(torch.from_numpy(a.copy()) for a in (p, g, m, v)),
            lr_t.reshape(1), B1, B2, EPS, weight_decay=wd)]
        _jax_band(one, want, p, g, m, v, float(lr_t))
        # the list entry computes lr_t itself, with the same roundings
        for a, b in zip(one, (multi[0][i], multi[1][i], multi[2][i])):
            assert np.array_equal(a, b.numpy())
        if wd:   # the term is there: p' differs from the step without it
            plain = pfo.adam_plain(*(torch.from_numpy(a) for a in
                                     (p, g, m, v)), lr_t, B1, B2, EPS)
            assert not np.array_equal(plain[0].numpy(), one[0])


def test_adam_list_entry_checks_its_lists():
    z = torch.zeros(3)
    one = torch.ones(1)
    lr = torch.tensor([LR])
    assert pfo.fused_adam_multi([], [], [], [], lr, [], []) == \
        ([], [], [], [], [])
    with pytest.raises(ValueError, match="lists of 2 parameters"):
        pfo.fused_adam_multi([z, z], [z], [z, z], [z, z], lr, [one, one],
                             [one, one])
    with pytest.raises(ValueError, match="beta"):
        pfo.fused_adam_multi([z], [z], [z], [z], lr, [one, one], [one])
    # the launch's own checks run before the kernel is built
    with pytest.raises(TypeError, match="g must be float32"):
        pfo._launch_adam([z], [z.double()], [z], [z], lr, [one], [one],
                         B1, B2, EPS, 0.0)
    with pytest.raises(ValueError, match="parameters on"):
        pfo._launch_adam([z, z.to("meta")], [z, z], [z, z], [z, z], lr,
                         [one, one], [one, one], B1, B2, EPS, 0.0)
    with pytest.raises(TypeError, match="Beta2Pow must be one float32"):
        pfo._launch_adam([z], [z], [z], [z], lr, [one], [torch.ones(2)],
                         B1, B2, EPS, 0.0)
    with pytest.raises(TypeError, match="the rate must be one float32"):
        pfo._launch_adam([z], [z], [z], [z], lr.double(), [one], [one],
                         B1, B2, EPS, 0.0)
    # the single entry is the list entry on a list of one
    got = pfo.fused_adam(torch.ones(5), torch.ones(5), torch.zeros(5),
                         torch.zeros(5), lr)
    want = pfo.adam_plain(torch.ones(5), torch.ones(5), torch.zeros(5),
                          torch.zeros(5), lr.reshape(()), B1, B2, EPS)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert kreg.get("fused_adam").run_many is pfo.fused_adam_multi


def _cfg(mod):
    cfg = mod.transformer_base(src_vocab_size=64, trg_vocab_size=64,
                               fuse_attention=True, dropout=0.0)
    cfg.n_layer, cfg.d_model, cfg.d_inner = 2, 64, 128
    cfg.n_head, cfg.d_head = 4, 16
    return cfg


def _build(fl, mod):
    cfg = _cfg(mod)
    fl.framework.unique_name.reset()
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        cost, _, _ = mod.transformer_train(cfg)
        fl.optimizer.AdamOptimizer(learning_rate=LR).minimize(cost)
    return cfg, main, startup, cost


def _batch(mod, cfg):
    return mod.make_batch(cfg, 4, 16, 12, rng=np.random.default_rng(3),
                          src_lens=np.array([16, 11, 7, 13]),
                          trg_lens=np.array([12, 9, 5, 12]))


def _steps(monkeypatch, grouped):
    """STEPS steps of the small Transformer through the port's Executor
    at floor 1 with the CPU routing hook armed, from the JAX package's
    initial state: losses, persistables, the calls into the Adam
    kernel's two entries and the registry's decisions of each step."""
    monkeypatch.setattr(kreg, "_ROUTE_ON_CPU", True)
    monkeypatch.setenv("PT_KERNEL_MIN_NUMEL", "1")
    monkeypatch.delenv("PT_KERNEL_DENY", raising=False)
    if not grouped:
        monkeypatch.setattr(PT_OPS.get("adam"), "group", None)
    kern = kreg.get("fused_adam")
    calls = {"run": 0, "run_many": []}

    def run(*a, _run=kern.run, **kw):
        calls["run"] += 1
        return _run(*a, **kw)

    def run_many(ps, *a, _run=kern.run_many, **kw):
        calls["run_many"].append(len(ps))
        return _run(ps, *a, **kw)
    monkeypatch.setattr(kern, "run", run)
    monkeypatch.setattr(kern, "run_many", run_many)

    cfg, jmain, jstartup, _ = _build(fluid, jax_transformer)
    _, pmain, pstartup, pcost = _build(pt, pt_transformer)
    jscope, pscope = JaxScope(), pt.Scope()
    fluid.Executor(fluid.CPUPlace()).run(jstartup, scope=jscope)
    exe = pt.Executor(pt.CPUPlace())
    exe.run(pstartup, scope=pscope)
    names = [v.name for v in jmain.global_block().vars.values()
             if v.persistable and jscope.find_var(v.name) is not None]
    load_params_from_numpy(
        pscope, {n: np.asarray(jscope.find_var(n).get_tensor())
                 for n in names}, pt.CPUPlace())
    feed = _batch(pt_transformer, cfg)
    losses, decisions = [], []
    for _ in range(STEPS):
        kreg.reset_stats()
        losses.append(exe.run(pmain, feed=feed, fetch_list=[pcost],
                              scope=pscope)[0])
        decisions.append(kreg.dispatch_stats()["per_kernel"]["fused_adam"])
    params = {n: np.asarray(pscope.find_var(n).get_tensor()) for n in names}
    monkeypatch.undo()
    return losses, params, calls, decisions, len(pmain.all_parameters())


def test_grouped_transformer_steps_equal_per_op_steps_and_jax(monkeypatch):
    grouped = _steps(monkeypatch, True)
    per_op = _steps(monkeypatch, False)
    n = grouped[4]
    # one call of the list entry a step, with every parameter
    assert grouped[2] == {"run": 0, "run_many": [n] * STEPS}
    assert per_op[2] == {"run": n * STEPS, "run_many": []}
    # the registry decides and counts op by op either way
    for dec in grouped[3] + per_op[3]:
        assert dec == {"custom": n}
    for a, b in zip(grouped[0], per_op[0]):
        assert np.array_equal(a, b)
    assert any("beta1_pow" in k for k in grouped[1])
    for k, v in grouped[1].items():
        assert np.array_equal(v, per_op[1][k]), k

    # against the JAX package's three steps from the same state
    cfg, jmain, jstartup, jcost = _build(fluid, jax_transformer)
    jscope = JaxScope()
    jexe = fluid.Executor(fluid.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    feed = _batch(jax_transformer, cfg)
    for step in range(STEPS):
        jl, = jexe.run(jmain, feed=feed, fetch_list=[jcost], scope=jscope)
        np.testing.assert_allclose(grouped[0][step], np.asarray(jl),
                                   rtol=F32_TOL, atol=F32_TOL)
    assert grouped[0][-1] < grouped[0][0]
    for k, v in grouped[1].items():
        np.testing.assert_allclose(v, np.asarray(
            jscope.find_var(k).get_tensor()), rtol=F32_TOL, atol=F32_TOL,
            err_msg=k)


class _FakeAdam:
    def __init__(self, type, lr, reads, writes, uid, b1=B1, b2=B2,
                 eps=EPS):
        self.type = type
        self._lr = [lr]
        self.input_arg_names = list(reads) + [lr]
        self.output_arg_names = list(writes)
        self._attrs = {"beta1": b1, "beta2": b2, "epsilon": eps,
                       engine.OP_UID_ATTR: uid}

    def input(self, slot):
        return self._lr if slot == "LearningRate" else []

    def attr(self, name, default=None):
        return self._attrs.get(name, default)


def test_an_adam_group_stops_at_another_type_key_or_a_dependency():
    key = PT_OPS.get("adam").group[0]
    ops = [_FakeAdam("adam", "lr0", ["p0"], ["p0"], 1),
           _FakeAdam("adam", "lr0", ["p1"], ["p1"], 2),
           _FakeAdam("adam", "lr1", ["p2"], ["p2"], 3),        # other rate
           _FakeAdam("adam", "lr1", ["p3"], ["p3"], 4, b1=0.8),  # beta1
           _FakeAdam("adam", "lr1", ["p4"], ["p4"], 5, b1=0.8,
                     b2=0.99),                                   # beta2
           _FakeAdam("adam", "lr1", ["p5"], ["p5"], 6, b1=0.8, b2=0.99,
                     eps=1e-6),                                  # epsilon
           _FakeAdam("adam", "lr1", ["p6"], ["p6"], 7, b1=0.8, b2=0.99,
                     eps=1e-6),
           _FakeAdam("adam", "lr1", ["p6", "g"], ["p6"], 8, b1=0.8,
                     b2=0.99, eps=1e-6),                         # reads p6
           _FakeAdam("sgd", "lr1", ["p7"], ["p7"], 9),
           _FakeAdam("adam", "lr1", ["p8"], ["p8"], 10)]
    ends, i = [], 0
    while i < len(ops):
        i = engine._group_end(ops, i, key, {}) if ops[i].type == "adam" \
            else i + 1
        ends.append(i)
    assert ends == [2, 3, 4, 5, 7, 8, 9, 10]
    # an op whose forward record the run needs is never grouped
    assert engine._group_end(ops, 0, key, {2: frozenset()}) == 1
