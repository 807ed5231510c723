"""Repairs of the port against the JAX package: the kernel registry
governs fused attention, head dims above 128, and Executor.run's full
signature.

* fused attention asks the kernel registry as the reference's
  use_kernel_path does: under PT_KERNEL_DENY=flash_attention or
  FLAGS_use_custom_kernels=0 it runs the plain (composed) version and
  counts `denied`, else `lowered` for the plain path on the CPU; a tiny
  Transformer scored by both Executors counts the same decisions and
  gives the same logits (the port with its CPU hook armed, so that its
  decisions are counted; the JAX package counts every call).
* Head dims 160, 192 and 256: the plain versions the CUDA-core kernels
  are held to on the card, against the JAX package's Pallas kernels in
  interpret mode, forward and backward; the kernels' checks take every
  head dim from 1 up (tests/test_torch_wide_heads.py holds D = 260 and
  320 against the JAX package).
* Executor.run takes feed_var_name, fetch_var_name, return_numpy and
  use_program_cache with the reference's defaults: one fluid script with
  all four runs through both packages.
* Engine.run takes the reference's (program, scope, place, feed,
  fetch_names, block_idx, return_numpy, iterations, use_program_cache):
  a Place positionally and by keyword, place=None as CUDAPlace(0)
  (raising as Executor() does where torch sees no card), block_idx 0
  only, a torch tensor feed used as it is, and iterations=3 equal to
  three single runs and to the JAX engine's iterations=3.
* decorate and OptimizerWithMixedPrecision take the JAX package's nine
  arguments in its order: its positional call with incr_every_n_steps,
  and incr_ratio by keyword, build and train a step in both packages;
  backward(callbacks=...) is refused by name.
* A closed Executor raises on run in both packages, and close drops the
  port's plans.

Tolerance: float32 1e-5 relative and absolute (float32 sums in another
order), as the port's other attention tests.
"""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as fluid
from paddle_tpu.core import flags as jflags
from paddle_tpu.core.engine import Engine as JaxEngine
from paddle_tpu.core.scope import Scope as JaxScope
from paddle_tpu.kernels import registry as jkreg
from paddle_tpu.models import transformer as jax_transformer

import paddle_tpu_torch as pt
from paddle_tpu_torch.core.engine import Engine as PtEngine
from paddle_tpu_torch.core.flags import set_flags
from paddle_tpu_torch.io import load_params_from_numpy
from paddle_tpu_torch.kernels import flash_attention as pfa
from paddle_tpu_torch.kernels import registry as pkreg
from paddle_tpu_torch.models import transformer as pt_transformer
from torch_threads import one_torch_thread  # noqa: F401

jfa = importlib.import_module("paddle_tpu.kernels.flash_attention")

RTOL = ATOL = 1e-5


@pytest.fixture(autouse=True)
def _clean():
    """Both registries start and end with the flag on and no counts."""
    pkreg.reset_stats()
    jkreg.reset_stats()
    yield
    set_flags({"FLAGS_use_custom_kernels": True})
    jflags.set_flags({"FLAGS_use_custom_kernels": True})
    pkreg.reset_stats()
    jkreg.reset_stats()


# ---------------------------------------------------------------------------
# fused attention and the kernel registry
# ---------------------------------------------------------------------------

def _cfg(mod):
    cfg = mod.transformer_base(src_vocab_size=64, trg_vocab_size=64,
                               fuse_attention=True)
    cfg.n_layer, cfg.d_model, cfg.d_inner = 2, 32, 64
    cfg.n_head, cfg.d_head = 4, 8
    return cfg


def _batch(mod, cfg):
    return mod.make_batch(cfg, 4, 16, 12, rng=np.random.default_rng(2),
                          src_lens=np.array([16, 11, 7, 13], np.int32),
                          trg_lens=np.array([12, 9, 5, 12], np.int32))


def _score_both():
    """The tiny Transformer scored once by each package from the JAX
    package's parameters: (JAX (logits, cost), port (logits, cost), the
    number of attention ops)."""
    cfg = _cfg(jax_transformer)
    fluid.framework.unique_name.reset()
    jmain, jstartup = fluid.Program(), fluid.Program()
    with fluid.program_guard(jmain, jstartup):
        jcost, jlogits, _ = jax_transformer.transformer_train(cfg,
                                                              is_test=True)
    jscope = JaxScope()
    jexe = fluid.Executor(fluid.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    params = {p.name: np.asarray(jscope.find_var(p.name).get_tensor())
              for p in jmain.all_parameters()}
    # the decisions of the run alone (the JAX package also decides while
    # it infers shapes at build time; the port infers them on meta
    # tensors, where nothing is counted)
    jkreg.reset_stats()
    jl, jc = jexe.run(jmain, feed=_batch(jax_transformer, cfg),
                      fetch_list=[jlogits, jcost], scope=jscope)

    pcfg = _cfg(pt_transformer)
    pt.framework.unique_name.reset()
    pmain, pstartup = pt.Program(), pt.Program()
    with pt.program_guard(pmain, pstartup):
        pcost, plogits, _ = pt_transformer.transformer_train(pcfg,
                                                             is_test=True)
    pscope = pt.Scope()
    load_params_from_numpy(pscope, params, pt.CPUPlace())
    pkreg.reset_stats()
    pl, pc = pt.Executor(pt.CPUPlace()).run(
        pmain, feed=_batch(pt_transformer, pcfg),
        fetch_list=[plogits, pcost], scope=pscope)
    n_attn = sum(op.type == "fused_attention"
                 for op in pmain.global_block().ops)
    return (np.asarray(jl), float(np.asarray(jc))), (pl, float(pc)), n_attn


_GATES = [("deny_list", "denied"), ("flag_off", "denied"),
          ("allowed", "lowered")]


def _gate(gate, monkeypatch):
    """Arm the port's CPU hook (so that its decisions count) and apply
    one gate to both registries."""
    monkeypatch.setattr(pkreg, "_ROUTE_ON_CPU", True)
    monkeypatch.delenv("PT_KERNEL_DENY", raising=False)
    if gate == "deny_list":
        monkeypatch.setenv("PT_KERNEL_DENY", "other,flash_attention")
    elif gate == "flag_off":
        set_flags({"FLAGS_use_custom_kernels": False})
        jflags.set_flags({"FLAGS_use_custom_kernels": False})


class _Op:
    """The one op a lowering reads: slots named after their variables."""

    def __init__(self, type, inputs, attrs):
        self.type = type
        self._inputs = {s: [s.lower()] for s in inputs}
        self._attrs = dict(attrs)

    def input(self, slot):
        return self._inputs.get(slot, [])

    def output(self, slot):
        return ["out"] if slot == "Out" else []

    def input_slots(self):
        return list(self._inputs)

    def output_slots(self):
        return ["Out"]

    def attr(self, name, default=None):
        return self._attrs.get(name, default)

    def all_attrs(self):
        return dict(self._attrs)


@pytest.mark.parametrize("gate,outcome", _GATES)
def test_attention_op_decides_as_the_jax_op(gate, outcome, monkeypatch):
    """One fused_attention lowering in each package: the same single
    decision in the dispatch stats, and the same output."""
    from paddle_tpu.core.registry import OPS as JAX_OPS
    from paddle_tpu.core.registry import ExecContext as JaxContext
    from paddle_tpu_torch.core.registry import OPS as PT_OPS
    from paddle_tpu_torch.core.registry import ExecContext as PtContext
    _gate(gate, monkeypatch)
    q, k, v, b = _wide_inputs(5, "bshd", 2, 4, 16, 16, 8, "key_pad")
    ins = {"Q": q, "K": k, "V": v, "BiasQK": b}
    attrs = {"scale": -1.0, "block_q": 0, "block_k": 0, "layout": "bshd",
             "dropout_prob": 0.0, "is_test": True, "causal": True}
    op = _Op("fused_attention", ins, attrs)
    jenv = {s.lower(): jnp.asarray(a) for s, a in ins.items()}
    JAX_OPS.get("fused_attention").lowering(JaxContext(op, jenv))
    penv = {s.lower(): torch.from_numpy(a) for s, a in ins.items()}
    PT_OPS.get("fused_attention").lowering(
        PtContext(op, penv, torch.device("cpu")))
    prow = pkreg.dispatch_stats()["per_kernel"]["flash_attention"]
    jrow = jkreg.dispatch_stats()["per_kernel"]["flash_attention"]
    assert prow == jrow == {outcome: 1}
    np.testing.assert_allclose(penv["out"].numpy(), np.asarray(jenv["out"]),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("gate,outcome", _GATES)
def test_transformer_under_each_gate_matches_jax(gate, outcome,
                                                 monkeypatch):
    """A tiny Transformer scored by both Executors: the same logits and
    cost, every decision of both of the gate's kind, and one a run for
    each of the port's attention ops (the JAX package decides as often as
    it traces the step)."""
    _gate(gate, monkeypatch)
    pkreg.reset_counts()
    (jl, jc), (pl, pc), n_attn = _score_both()
    assert n_attn == 6
    assert pkreg.dispatch_stats()["per_kernel"]["flash_attention"] == {
        outcome: n_attn}
    jrow = jkreg.dispatch_stats()["per_kernel"]["flash_attention"]
    assert list(jrow) == [outcome] and jrow[outcome] % n_attn == 0
    assert not any(pkreg.launches().values())
    np.testing.assert_allclose(pl, jl, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pc, jc, rtol=RTOL, atol=ATOL)


def test_attention_uncounted_where_routing_is_impossible():
    """A CPU tensor without the hook, and the meta tensors of shape
    inference, run the plain version uncounted, as registry.select
    counts nothing where the device cannot route."""
    assert not pkreg._ROUTE_ON_CPU
    for dev in ("cpu", "meta"):
        q = torch.zeros(1, 8, 2, 8, device=dev)
        pfa.fused_attention_forward(q, q, q, None, 0.3, False, "bshd")
    assert pkreg.dispatch_stats()["decisions"] == 0


# ---------------------------------------------------------------------------
# head dims above 128
# ---------------------------------------------------------------------------

def _wide_inputs(seed, layout, B, H, Sq, Sk, D, bias):
    rng = np.random.default_rng(seed)

    def t(S):
        shape = (B, S, H, D) if layout == "bshd" else (B, H, S, D)
        return rng.standard_normal(shape).astype(np.float32)

    q, k, v = t(Sq), t(Sk), t(Sk)
    if bias == "key_pad":
        lens = np.maximum(Sk - 3 * np.arange(B), 1)
        b = np.where(np.arange(Sk)[None, :] < lens[:, None], 0.0,
                     -1e9).astype(np.float32)[:, None, None, :]
    else:
        b = rng.standard_normal((B, H, Sq, Sk)).astype(np.float32)
    return q, k, v, b


_WIDE = [
    # (layout, B, H, Sq, Sk, D, bias, causal)
    ("bshd", 2, 2, 16, 16, 192, "key_pad", True),
    ("bhsd", 2, 2, 12, 16, 256, "per_head", False),
    ("bshd", 1, 3, 16, 8, 160, "key_pad", False),
    ("bhsd", 2, 1, 16, 16, 256, "key_pad", True),
]


@pytest.mark.parametrize("layout,B,H,Sq,Sk,D,bias,causal", _WIDE)
def test_wide_head_dims_match_jax_kernels_interpret(layout, B, H, Sq, Sk, D,
                                                    bias, causal,
                                                    monkeypatch):
    """Forward (out, lse) and backward (dq, dk, dv, dbias) of the plain
    versions against the JAX package's _fa_forward / _fa_backward in
    interpret mode, from the JAX forward's out and lse."""
    monkeypatch.setattr(jfa, "_INTERPRET", True)
    q, k, v, b = _wide_inputs(D + Sq, layout, B, H, Sq, Sk, D, bias)
    g = np.random.default_rng(D).standard_normal(q.shape).astype(np.float32)
    scale = D ** -0.5
    jargs = [jnp.asarray(a) for a in (q, k, v, b)]
    jo, jl = jfa._fa_forward(*jargs, scale, Sq, Sk, return_lse=True,
                             layout=layout, causal=causal)
    tt = (lambda a: torch.from_numpy(np.array(a)))
    po, pl = pfa.fused_attention_forward(tt(q), tt(k), tt(v), tt(b), scale,
                                         causal, layout, return_lse=True)
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=RTOL,
                               atol=ATOL)
    want_dbias = bias == "per_head"
    want = jfa._fa_backward(*jargs, jo, jl, jnp.asarray(g), scale, Sq, Sk,
                            layout=layout, want_dbias=want_dbias,
                            causal=causal)
    got = pfa.fused_attention_backward(tt(q), tt(k), tt(v), tt(b), tt(jo),
                                       tt(jl), tt(g), scale, causal, layout,
                                       want_dbias=want_dbias)
    for name, pg, jg in zip(("dq", "dk", "dv", "dbias"), got,
                            list(want) + [None]):
        if not want_dbias and name == "dbias":
            assert pg is None
            continue
        np.testing.assert_allclose(pg.numpy(), np.asarray(jg), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


@pytest.mark.parametrize("D,ok", [(192, True), (256, True), (264, True),
                                  (512, True), (0, False)])
def test_kernel_checks_take_head_dims_up_to_256(D, ok):
    """Every head dim from 1 up (256 was the limit until the CUDA-core
    kernels took D in 256-column groups); none of these takes the
    tensor-core kernels, which stop at 128."""
    q = torch.zeros(1, 4, 2, D)
    if ok:
        assert pfa._check(q, q, q, None, "bshd") == (1, 2, 4, 4, D)
        for qx in (q, q.bfloat16()):
            assert not pfa._sm90_eligible(qx, qx, qx, qx, "bshd")
    else:
        with pytest.raises(ValueError, match="head dims from 1"):
            pfa._check(q, q, q, None, "bshd")


# ---------------------------------------------------------------------------
# Executor.run's signature
# ---------------------------------------------------------------------------

def _script(pkg, layers):
    """A fluid script: fc -> relu -> fc -> softmax, cross entropy, SGD."""
    pkg.framework.unique_name.reset()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = layers.data(name="x", shape=[8], dtype="float32")
        y = layers.data(name="y", shape=[1], dtype="int64")
        h = layers.fc(x, 16, act="relu")
        pred = layers.fc(h, 4, act="softmax")
        loss = layers.mean(layers.cross_entropy(pred, y))
        pkg.optimizer.SGD(learning_rate=0.05).minimize(loss)
    main.random_seed = startup.random_seed = 3
    return main, startup, pred, loss


def test_executor_run_takes_the_reference_arguments():
    rng = np.random.default_rng(4)
    feed = {"x": rng.standard_normal((6, 8)).astype(np.float32),
            "y": rng.integers(0, 4, (6, 1)).astype(np.int64)}
    # the JAX package: its own initialization, handed to the port
    jmain, jstartup, jpred, jloss = _script(fluid, fluid.layers)
    jscope = JaxScope()
    jexe = fluid.Executor(fluid.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    params = {p.name: np.asarray(jscope.find_var(p.name).get_tensor())
              for p in jmain.all_parameters()}
    pmain, pstartup, ppred, ploss = _script(pt, pt.layers)
    pscope = pt.Scope()
    pexe = pt.Executor(pt.CPUPlace())
    pexe.run(pstartup, scope=pscope)
    load_params_from_numpy(pscope, params, pt.CPUPlace())
    for step, return_numpy in enumerate((True, False, True)):
        kw = dict(feed_var_name="feed", fetch_var_name="fetch",
                  return_numpy=return_numpy, use_program_cache=step != 1)
        jout = jexe.run(jmain, feed=feed, fetch_list=[jpred, jloss],
                        scope=jscope, **kw)
        pout = pexe.run(pmain, feed=feed, fetch_list=[ppred, ploss],
                        scope=pscope, **kw)
        assert len(pout) == len(jout) == 2
        for p, j in zip(pout, jout):
            if return_numpy:
                assert isinstance(p, np.ndarray)
                j = np.asarray(j)
            else:
                # the fetched tensors as they lie on the device
                assert isinstance(p, torch.Tensor)
                assert p.device == torch.device("cpu")
                p = p.numpy()
                j = np.asarray(j.array if hasattr(j, "array") else j)
            np.testing.assert_allclose(p, j, rtol=RTOL, atol=ATOL)
    # positional, in the reference's order: program, feed, fetch_list,
    # feed_var_name, fetch_var_name, scope
    loss_p, = pexe.run(pmain, feed, [ploss], "feed", "fetch", pscope)
    loss_j, = jexe.run(jmain, feed, [jloss], "feed", "fetch", jscope)
    np.testing.assert_allclose(loss_p, np.asarray(loss_j), rtol=RTOL,
                               atol=ATOL)


# ---------------------------------------------------------------------------
# Engine.run's signature, decorate's arguments, Executor.close
# ---------------------------------------------------------------------------

def _feed(seed=4):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((6, 8)).astype(np.float32),
            "y": rng.integers(0, 4, (6, 1)).astype(np.int64)}


def _both_scripts():
    """The fluid script in both packages from the JAX package's
    initialization: (jax main, scope, loss), (port main, scope, loss)."""
    jmain, jstartup, _, jloss = _script(fluid, fluid.layers)
    jscope = JaxScope()
    fluid.Executor(fluid.CPUPlace()).run(jstartup, scope=jscope)
    params = {p.name: np.asarray(jscope.find_var(p.name).get_tensor())
              for p in jmain.all_parameters()}
    pmain, pstartup, _, ploss = _script(pt, pt.layers)
    pscope = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(pstartup, scope=pscope)
    load_params_from_numpy(pscope, params, pt.CPUPlace())
    return (jmain, jscope, jloss), (pmain, pscope, ploss)


def _params(prog, scope):
    return {p.name: np.asarray(scope.find_var(p.name).get_tensor())
            for p in prog.all_parameters()}


def test_engine_run_takes_the_reference_arguments():
    _, (main, scope, loss) = _both_scripts()
    eng, feed, cpu = PtEngine(), _feed(), pt.CPUPlace()
    # positionally, block_idx in sixth place
    a, = eng.run(main, scope, cpu, feed, [loss.name], 0, True, 1, True)
    b, = eng.run(program=main, scope=scope, place=cpu, feed=feed,
                 fetch_names=[loss.name], block_idx=0, return_numpy=True,
                 iterations=1, use_program_cache=True)
    c, = eng.run(main, scope, torch.device("cpu"), feed, [loss.name])
    assert all(isinstance(v, np.ndarray) and np.isfinite(v)
               for v in (a, b, c))
    assert len({float(a), float(b), float(c)}) == 3   # SGD steps
    with pytest.raises(NotImplementedError, match="sub-blocks"):
        eng.run(main, scope, cpu, feed, [loss.name], 1)
    with pytest.raises(TypeError, match="Place"):
        eng.run(main, scope, "cpu", feed, [loss.name])
    # a torch tensor on the run's device is the feed itself
    x = torch.from_numpy(feed["x"])
    got, = eng.run(main, scope, cpu, dict(feed, x=x), ["x"],
                   return_numpy=False)
    assert got is x


def test_engine_run_place_none_is_cuda_place_0(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, (main, scope, loss) = _both_scripts()
    with pytest.raises(RuntimeError, match=r"CPUPlace\(\)") as eng_err:
        PtEngine().run(main, scope, None, _feed(), [loss.name])
    with pytest.raises(RuntimeError, match=r"CPUPlace\(\)") as exe_err:
        pt.Executor()
    assert str(eng_err.value) == str(exe_err.value)


def test_iterations_run_the_plan_k_times_in_both_packages():
    """iterations=3: three SGD steps on one feed, the last step's loss
    fetched; equal to three single runs in the port (bit for bit, the
    same ops) and to the JAX engine's iterations=3 (RTOL/ATOL)."""
    (jmain, jscope, jloss), (pmain, pscope, ploss) = _both_scripts()
    _, (smain, sscope, sloss) = _both_scripts()
    feed = _feed()
    jl, = JaxEngine().run(jmain, jscope, fluid.CPUPlace(), feed,
                          [jloss.name], iterations=3)
    eng = PtEngine()
    pl, = eng.run(pmain, pscope, pt.CPUPlace(), feed, [ploss.name],
                  iterations=3)
    assert eng.counters["runs"] == 1 and eng.counters["traces"] == 1
    single = PtEngine()
    for _ in range(3):
        sl, = single.run(smain, sscope, pt.CPUPlace(), feed, [sloss.name])
    assert float(pl) == float(sl)
    np.testing.assert_allclose(pl, np.asarray(jl), rtol=RTOL, atol=ATOL)
    pp, sp, jp = (_params(pmain, pscope), _params(smain, sscope),
                  _params(jmain, jscope))
    for n in jp:
        np.testing.assert_array_equal(pp[n], sp[n], err_msg=n)
        np.testing.assert_allclose(pp[n], jp[n], rtol=RTOL, atol=ATOL,
                                   err_msg=n)
    with pytest.raises(ValueError, match="iterations"):
        eng.run(pmain, pscope, pt.CPUPlace(), feed, [ploss.name],
                iterations=0)


def _amp_script(pkg, wrap):
    """The fluid script with SGD under `wrap(optimizer)`."""
    pkg.framework.unique_name.reset()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = pkg.layers.data(name="x", shape=[8], dtype="float32")
        y = pkg.layers.data(name="y", shape=[1], dtype="int64")
        pred = pkg.layers.fc(pkg.layers.fc(x, 16, act="relu"), 4,
                             act="softmax")
        loss = pkg.layers.mean(pkg.layers.cross_entropy(pred, y))
        opt = wrap(pkg.contrib.mixed_precision,
                   pkg.optimizer.SGD(learning_rate=0.05))
        opt.minimize(loss)
    main.random_seed = startup.random_seed = 3
    return main, startup, loss, opt


_KNOBS = ("_loss_scaling", "_incr_every_n_steps",
          "_decr_every_n_nan_or_inf", "_incr_ratio", "_decr_ratio")


@pytest.mark.parametrize("call", ["positional", "keyword", "class"])
def test_decorate_takes_the_reference_arguments(call):
    import paddle_tpu.contrib.mixed_precision  # noqa: F401
    wrap = {
        # the reference's order: amp_lists, init_loss_scaling,
        # incr_every_n_steps, decr_every_n_nan_or_inf, incr_ratio,
        # decr_ratio, use_dynamic_loss_scaling, dtype
        "positional": lambda mp, o: mp.decorate(o, None, 1.0, 500, 3,
                                                 2.5, 0.5, False,
                                                 "bfloat16"),
        "keyword": lambda mp, o: mp.decorate(o, incr_ratio=2.0),
        "class": lambda mp, o: mp.OptimizerWithMixedPrecision(
            o, None, 1.0, False, 700, 4, 3.0, 0.25, "bfloat16"),
    }[call]
    losses, knobs = [], []
    for pkg, Scope in ((fluid, JaxScope), (pt, pt.Scope)):
        main, startup, loss, opt = _amp_script(pkg, wrap)
        scope = Scope()
        exe = pkg.Executor(pkg.CPUPlace())
        exe.run(startup, scope=scope)
        out, = exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope)
        losses.append(float(np.asarray(out)))
        knobs.append([getattr(opt, k) for k in _KNOBS])
        assert main._amp is not None
    assert all(np.isfinite(losses))
    assert knobs[0] == knobs[1]


def test_decorate_backward_refuses_callbacks():
    main, _, loss, opt = _amp_script(
        pt, lambda mp, o: mp.decorate(o))
    with pytest.raises(NotImplementedError, match="callbacks"):
        opt.backward(loss, callbacks=[lambda *a: None])


def test_closed_executor_raises_as_the_jax_one():
    _, (main, scope, loss) = _both_scripts()
    jexe = fluid.Executor(fluid.CPUPlace())
    pexe = pt.Executor(pt.CPUPlace())
    pexe.run(main, feed=_feed(), fetch_list=[loss], scope=scope)
    assert pexe._engine._plans and pexe._engine.counters["runs"] == 1
    for exe in (jexe, pexe):
        exe.close()
    assert not pexe._engine._plans and pexe._engine.counters["runs"] == 0
    for exe, prog in ((jexe, fluid.Program()), (pexe, main)):
        with pytest.raises(RuntimeError, match="Executor is closed"):
            exe.run(prog, feed=_feed(), fetch_list=[], scope=scope)
