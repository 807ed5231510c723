"""The engine's captured block (core/engine.py _Captured), on the CPU.

With the plan cache on, the second run of a plan captures its block when
the capture rule (capture_blocker: the block on the meta device) admits
it, and every later run replays it. On the CPU there is no CUDA graph: a
replay runs the step on the same static tensors with the same
bookkeeping (static feeds, state synced from the scope, random state
prepared for the run index, fetches copied out, launch counts added per
run), which these tests hold to the eager engine (use_program_cache=False)
bit for bit.

* The rule admits the real programs at full width (ResNet-50, the
  Transformer-base training and serving programs, LeNet), probed on meta
  tensors; a block with an op that cannot run on meta stays eager, with
  that op's type in Engine.eager_reasons.
* 3 steps of a 2+2-layer d_model 64 Transformer with dropout 0.1 (dropout
  ops and attention dropout) and of a small ResNet equal the eager
  engine's bit for bit: losses and every persistable.
* iterations=3, a scope write between runs (load_params_from_numpy),
  fetches that the next run does not overwrite, the counters, and the
  launch counts and registry decisions per run.
* The first captured step of the small Transformer (dropout off) from the
  JAX package's parameters against the JAX package's step, within the
  float32 tolerance of tests/test_torch_training.py.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.core.scope import Scope as JaxScope
from paddle_tpu.models import transformer as jax_transformer

import paddle_tpu_torch as pt
from paddle_tpu_torch.core import engine as E
from paddle_tpu_torch.core.registry import OPS, register_op
from paddle_tpu_torch.io import load_params_from_numpy
from paddle_tpu_torch.kernels import registry as kreg
from paddle_tpu_torch.models import lenet, resnet as R
from paddle_tpu_torch.models import transformer as T
from torch_threads import one_torch_thread  # noqa: F401

CPU = pt.CPUPlace()
# the float32 tolerance of tests/test_torch_training.py: float32 sums in
# another order than the JAX package's
F32_TOL = 1e-5
STEPS = 3


# ---------------------------------------------------------------------------
# programs
# ---------------------------------------------------------------------------

def _cfg(mod, dropout, d_model=64):
    cfg = mod.transformer_base(src_vocab_size=64, trg_vocab_size=64,
                               fuse_attention=True, dropout=dropout)
    cfg.n_layer, cfg.d_model, cfg.d_inner = 2, d_model, 2 * d_model
    cfg.n_head, cfg.d_head = 4, d_model // 4
    return cfg


def _transformer(fl=pt, mod=T, dropout=0.1, amp=False):
    cfg = _cfg(mod, dropout)
    fl.framework.unique_name.reset()
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        cost, _, _ = mod.transformer_train(cfg)
        opt = fl.optimizer.AdamOptimizer(learning_rate=2e-3)
        if amp:
            opt = fl.contrib.mixed_precision.decorate(opt)
        opt.minimize(cost)
    main.random_seed = startup.random_seed = 7
    feed = mod.make_batch(cfg, 4, 16, 12, rng=np.random.default_rng(3),
                          src_lens=np.array([16, 11, 7, 13]),
                          trg_lens=np.array([12, 9, 5, 12]))
    return main, startup, cost, feed


def _resnet():
    pt.framework.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        cost, _, _ = pt.models.resnet_train(class_dim=10, depth=18,
                                            image_shape=(3, 16, 16))
        pt.optimizer.MomentumOptimizer(0.01, 0.9).minimize(cost)
    main.random_seed = startup.random_seed = 7
    r = np.random.RandomState(0)
    feed = {"image": r.rand(4, 3, 16, 16).astype(np.float32),
            "label": r.randint(0, 10, (4, 1)).astype(np.int64)}
    return main, startup, cost, feed


def _lenet():
    pt.framework.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        cost, _, _ = lenet.lenet_train()
        pt.optimizer.SGD(learning_rate=0.05).minimize(cost)
    r = np.random.RandomState(0)
    feed = {"img": r.rand(8, 1, 28, 28).astype(np.float32),
            "label": r.randint(0, 10, (8, 1)).astype(np.int64)}
    return main, startup, cost, feed


def _persistables(main, scope):
    return [v.name for v in main.global_block().vars.values()
            if v.persistable and scope.find_var(v.name) is not None]


def _copy(scope, names):
    new = pt.Scope()
    for n in names:
        new.var(n).get_tensor().set_tensor(
            scope.find_var(n).get_tensor().tensor.clone())
    return new


def _two_scopes(main, startup):
    scope = pt.Scope()
    pt.Executor(CPU).run(startup, scope=scope)
    names = _persistables(main, scope)
    return _copy(scope, names), _copy(scope, names), names


def _value(scope, n):
    return scope.find_var(n).get_tensor().tensor


# ---------------------------------------------------------------------------
# the capture rule
# ---------------------------------------------------------------------------

def _probe(main, fetch, feed_shapes):
    """capture_blocker on a scope of meta tensors: the rule needs shapes
    and dtypes only, so the full-width programs cost no initialization."""
    block = main.global_block()
    scope = pt.Scope()
    for v in block.vars.values():
        if v.persistable:
            scope.var(v.name).get_tensor().set_tensor(torch.empty(
                [max(int(d), 1) for d in v.shape],
                dtype=pt.core.types.dtype_to_torch(v.dtype), device="meta"))
    feeds = {n: torch.empty(s, dtype=d, device="meta")
             for n, (s, d) in feed_shapes.items()}
    sig = E._feed_signature(feeds)
    plan = E._Plan(block, scope, torch.device("cpu"), sig, [fetch.name])
    return E.capture_blocker(main, block, plan, feeds, [fetch.name]), plan


def test_the_rule_admits_resnet50_training():
    pt.framework.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        cost, _, _ = pt.models.resnet_train(depth=50)
        pt.contrib.mixed_precision.decorate(
            pt.optimizer.MomentumOptimizer(0.1, 0.9)).minimize(cost)
    assert len(main.global_block().ops) == 535
    reason, plan = _probe(main, cost, {
        "image": ((128, 3, 224, 224), torch.float32),
        "label": ((128, 1), torch.int64)})
    assert reason is None
    # the written persistables: 161 parameters and their velocities, the
    # 53 batch norms' running means and variances
    assert len(plan.written) == 2 * 161 + 2 * 53


@pytest.mark.parametrize("is_test", [False, True],
                         ids=["training", "serving"])
def test_the_rule_admits_transformer_base(is_test):
    cfg = T.transformer_base(fuse_attention=True,
                             dropout=0.0 if is_test else 0.1)
    pt.framework.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        cost, _, _ = T.transformer_train(cfg, is_test=is_test)
        if not is_test:
            pt.contrib.mixed_precision.decorate(
                pt.optimizer.AdamOptimizer(2e-4)).minimize(cost)
    B, S = (32, 256) if is_test else (96, 128)
    feed = T.make_batch(cfg, B, S, S, rng=np.random.default_rng(0))
    reason, _ = _probe(main, cost, {
        n: (a.shape, pt.core.types.dtype_to_torch(
            main.global_block().find_var(n).dtype))
        for n, a in feed.items()})
    assert reason is None


def test_the_rule_admits_lenet():
    main, _, cost, feed = _lenet()
    reason, _ = _probe(main, cost, {
        "img": ((512, 1, 28, 28), torch.float32),
        "label": ((512, 1), torch.int64)})
    assert reason is None


_HOST_READ = "host_read_for_capture_test"


@pytest.fixture
def host_read_op():
    """An op that scales X by its own largest value, read on the host: a
    value the meta device does not have. Registered for the test alone
    (the op registry is the process's)."""
    @register_op(_HOST_READ)
    def _host_read(ctx):
        x = ctx.input("X")
        ctx.set_output("Out", x * float(x.max().item()))
    yield _HOST_READ
    for t in (_HOST_READ, _HOST_READ + "_grad"):
        OPS._map.pop(t, None)


def _host_read_program():
    pt.framework.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", [4], dtype="float32")
        h = pt.layers.fc(x, 4)
        block = main.global_block()
        out = block.create_var(name="scaled", dtype="float32",
                               shape=h.shape)
        block.append_op(type=_HOST_READ, inputs={"X": [h.name]},
                        outputs={"Out": [out.name]}, infer_shape=False)
        cost = pt.layers.mean(out)
    return main, startup, cost


def test_a_block_that_reads_a_value_on_the_host_stays_eager(host_read_op):
    main, startup, cost = _host_read_program()
    exe, scope = pt.Executor(CPU), pt.Scope()
    exe.run(startup, scope=scope)
    feed = {"x": np.arange(8, dtype=np.float32).reshape(2, 4)}
    before = dict(exe._engine.counters)
    outs = [exe.run(main, feed=feed, fetch_list=[cost], scope=scope)[0]
            for _ in range(3)]
    c = {k: v - before[k] for k, v in exe._engine.counters.items()}
    assert (c["captures"], c["replays"], c["eager_runs"]) == (0, 0, 3)
    assert list(exe._engine.eager_reasons.values()) == [_HOST_READ]
    assert all(np.array_equal(o, outs[0]) for o in outs)


# ---------------------------------------------------------------------------
# captured steps against the eager engine, bit for bit
# ---------------------------------------------------------------------------

def _steps(main, cost, feed, scope, cached, steps=STEPS, exe=None):
    exe = exe or pt.Executor(CPU)
    return [exe.run(main, feed=feed, fetch_list=[cost], scope=scope,
                    use_program_cache=cached)[0] for _ in range(steps)], exe


def _assert_scopes_equal(a, b, names):
    for n in names:
        assert torch.equal(_value(a, n), _value(b, n)), n


@pytest.mark.parametrize("build", [_transformer, _resnet],
                         ids=["transformer_dropout", "resnet"])
def test_captured_steps_equal_eager_steps(build):
    main, startup, cost, feed = build()
    cap, eager, names = _two_scopes(main, startup)
    got, exe = _steps(main, cost, feed, cap, True)
    want, _ = _steps(main, cost, feed, eager, False)
    assert [float(x) for x in got] == [float(x) for x in want]
    assert len(set(float(x) for x in got)) == STEPS   # the steps train
    _assert_scopes_equal(cap, eager, names)
    c = exe._engine.counters
    assert (c["captures"], c["replays"], c["eager_runs"]) == \
        (1, STEPS - 1, 1)


def test_captured_dropout_masks_equal_eager_masks_each_run():
    main, startup, cost, feed = _transformer()
    masks = [op.output("Mask")[0] for op in main.global_block().ops
             if op.type == "dropout"]
    cap, eager, _ = _two_scopes(main, startup)
    exes = {True: pt.Executor(CPU), False: pt.Executor(CPU)}
    runs = {c: [exes[c].run(main, feed=feed, fetch_list=masks + [cost],
                            scope=s, use_program_cache=c)
                for _ in range(STEPS)]
            for c, s in ((True, cap), (False, eager))}
    for a, b in zip(runs[True], runs[False]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    # each replay draws new masks
    assert not np.array_equal(runs[True][1][0], runs[True][2][0])


def test_iterations_replay_with_their_own_run_indices():
    main, startup, cost, feed = _transformer()
    a, b, names = _two_scopes(main, startup)
    exe_a, exe_b = pt.Executor(CPU), pt.Executor(CPU)
    for exe, s in ((exe_a, a), (exe_b, b)):   # first run: eager
        exe.run(main, feed=feed, fetch_list=[cost], scope=s)
    last = exe_a.run(main, feed=feed, fetch_list=[cost], scope=a)
    last = exe_a._engine.run(main, a, CPU, feed, [cost.name],
                             iterations=3)[0]
    singles = [exe_b.run(main, feed=feed, fetch_list=[cost], scope=b)[0]
               for _ in range(4)]
    assert float(last) == float(singles[-1])
    _assert_scopes_equal(a, b, names)
    assert exe_a._engine.counters["replays"] == 4


def test_a_scope_write_between_replays_takes_effect():
    main, startup, cost, feed = _lenet()
    cap, eager, names = _two_scopes(main, startup)
    exes = {True: pt.Executor(CPU), False: pt.Executor(CPU)}
    w = main.all_parameters()[0].name
    new_w = np.full(_value(cap, w).shape, 0.01, np.float32)
    losses = {}
    for cached, scope in ((True, cap), (False, eager)):
        exe = exes[cached]
        out = [exe.run(main, feed=feed, fetch_list=[cost], scope=scope,
                       use_program_cache=cached)[0] for _ in range(3)]
        load_params_from_numpy(scope, {w: new_w}, CPU)
        out += [exe.run(main, feed=feed, fetch_list=[cost], scope=scope,
                        use_program_cache=cached)[0] for _ in range(2)]
        losses[cached] = [float(x) for x in out]
    assert losses[True] == losses[False]
    _assert_scopes_equal(cap, eager, names)
    assert exes[True]._engine.counters["captures"] == 1


def test_fetches_are_copies_the_next_run_leaves():
    main, startup, cost, feed = _lenet()
    scope, _, _ = _two_scopes(main, startup)
    exe = pt.Executor(CPU)
    w = main.all_parameters()[0].name
    outs = []
    for _ in range(4):
        outs.append(exe.run(main, feed=feed, fetch_list=[cost, w],
                            scope=scope, return_numpy=False))
    kept = [(o[0].clone(), o[1].clone()) for o in outs]
    exe.run(main, feed=feed, fetch_list=[cost, w], scope=scope,
            return_numpy=False)
    for o, k in zip(outs, kept):
        assert torch.equal(o[0], k[0]) and torch.equal(o[1], k[1])
    assert not torch.equal(outs[2][1], outs[3][1])   # w moved
    assert outs[3][1] is not _value(scope, w)


def test_launch_counts_and_decisions_per_run(monkeypatch):
    """LeNet's six sgd ops through the fused_sgd list entry on the CPU
    (the registry routes CPU tensors under _ROUTE_ON_CPU, and the list
    entry here counts a launch as the kernel's wrapper does): every run,
    eager or replayed, counts one launch, six decisions for fused_sgd and
    the same other decisions."""
    monkeypatch.setenv("PT_KERNEL_MIN_NUMEL", "1")
    monkeypatch.setattr(kreg, "_ROUTE_ON_CPU", True)
    kern = kreg.get("fused_sgd")
    plain = kern.run_many

    def counted(*a, **kw):
        kreg.count_launch("fused_sgd")
        return plain(*a, **kw)
    monkeypatch.setattr(kern, "run_many", counted)
    main, startup, cost, feed = _lenet()
    scope, _, _ = _two_scopes(main, startup)
    exe = pt.Executor(CPU)
    per_run = []
    for _ in range(4):
        kreg.reset_counts()
        kreg.reset_stats()
        exe.run(main, feed=feed, fetch_list=[cost], scope=scope)
        per_run.append((kreg.launches()["fused_sgd"],
                        kreg.dispatch_stats()["per_kernel"]))
    assert per_run[0][0] == 1
    assert per_run[0][1]["fused_sgd"] == {"custom": 6}
    assert per_run == [per_run[0]] * 4
    c = exe._engine.counters
    assert (c["captures"], c["replays"], c["eager_runs"]) == (1, 3, 1)


def test_a_routing_change_captures_again(monkeypatch):
    """A captured block replays the kernel choices of its capture: a
    change of a registry knob between runs captures the block again,
    and the runs stay equal to eager ones."""
    main, startup, cost, feed = _lenet()
    cap, eager, names = _two_scopes(main, startup)
    exes = {True: pt.Executor(CPU), False: pt.Executor(CPU)}
    losses = {True: [], False: []}
    for floor in (None, "1", None):
        if floor is None:
            monkeypatch.delenv("PT_KERNEL_MIN_NUMEL", raising=False)
        else:
            monkeypatch.setenv("PT_KERNEL_MIN_NUMEL", floor)
        for cached, scope in ((True, cap), (False, eager)):
            losses[cached] += [float(exes[cached].run(
                main, feed=feed, fetch_list=[cost], scope=scope,
                use_program_cache=cached)[0]) for _ in range(2)]
    assert losses[True] == losses[False]
    _assert_scopes_equal(cap, eager, names)
    c = exes[True]._engine.counters
    assert (c["captures"], c["replays"], c["eager_runs"]) == (3, 5, 1)


def test_use_program_cache_false_never_captures():
    main, startup, cost, feed = _lenet()
    scope, _, _ = _two_scopes(main, startup)
    _, exe = _steps(main, cost, feed, scope, False)
    c = exe._engine.counters
    assert (c["captures"], c["replays"], c["eager_runs"]) == (0, 0, STEPS)


def test_close_releases_the_captured_blocks():
    main, startup, cost, feed = _lenet()
    scope, _, _ = _two_scopes(main, startup)
    _, exe = _steps(main, cost, feed, scope, True)
    engine = exe._engine
    plans = [p for ps in engine._plans.values() for p in ps]
    assert any(p.captured is not None for p in plans)
    exe.close()
    assert not engine._plans and all(p.captured is None for p in plans)
    with pytest.raises(RuntimeError, match="closed"):
        exe.run(main, feed=feed, fetch_list=[cost], scope=scope)


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

def test_first_captured_step_matches_jax_from_its_parameters():
    """Both packages from the JAX initialization: the port's second step
    (the first captured one) and the JAX step agree within F32_TOL, and
    so do the parameters after it."""
    jmain, jstartup, jcost, feed = _transformer(fluid, jax_transformer,
                                                dropout=0.0)
    pmain, pstartup, pcost, _ = _transformer(dropout=0.0)
    jscope, pscope = JaxScope(), pt.Scope()
    jexe, pexe = fluid.Executor(fluid.CPUPlace()), pt.Executor(CPU)
    jexe.run(jstartup, scope=jscope)
    pexe.run(pstartup, scope=pscope)
    load_params_from_numpy(
        pscope, {p.name: np.asarray(jscope.find_var(p.name).get_tensor())
                 for p in jmain.all_parameters()}, CPU)
    jl, pl = [], []
    for _ in range(2):
        jl.append(float(np.asarray(jexe.run(jmain, feed=feed,
                                            fetch_list=[jcost],
                                            scope=jscope)[0])))
        pl.append(float(pexe.run(pmain, feed=feed, fetch_list=[pcost],
                                 scope=pscope)[0]))
    assert pexe._engine.counters["captures"] == 1
    np.testing.assert_allclose(pl, jl, rtol=F32_TOL, atol=F32_TOL)
    for p in jmain.all_parameters():
        np.testing.assert_allclose(
            np.asarray(pscope.find_var(p.name).get_tensor()),
            np.asarray(jscope.find_var(p.name).get_tensor()),
            rtol=F32_TOL, atol=F32_TOL, err_msg=p.name)
