"""The engine's per-step plan (core/engine.py _Plan), on the CPU.

* A second run with the same program version, fetch list, scope and
  feed signature reuses the plan (`fast_path_hits`); appending an op (a
  version bump), another fetch list, another feed shape or dtype,
  another scope, setting Program._amp and setting an op type's group
  lowering each build a new one (`traces`).
* use_program_cache=False neither reuses nor keeps a plan; a key keeps
  at most 4 plans, one per feed signature.
* A persistable that is uninitialized, or erased from the scope after
  the plan was built, still raises the "run the startup program first?"
  error.
* 3 training steps of LeNet (SGD) and of a 1+1-layer Transformer (Adam,
  dropout 0.1) give bit-equal losses and persistables with and without
  the cache.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch.core import engine as E
from paddle_tpu_torch.core.registry import OPS
from paddle_tpu_torch.models import lenet, transformer as T
from torch_threads import one_torch_thread  # noqa: F401

CPU = pt.CPUPlace()


def _fc_program():
    pt.framework.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", [6], dtype="float32")
        y = pt.layers.data("y", [1], dtype="float32")
        h = pt.layers.fc(x, 4, act="relu")
        pred = pt.layers.fc(h, 1)
        cost = pt.layers.mean(pt.layers.elementwise_add(pred, y))
        pt.optimizer.SGD(0.01).minimize(cost)
    return main, startup, h, cost


def _feed(n=5, seed=0, dtype=np.float32):
    r = np.random.default_rng(seed)
    return {"x": r.standard_normal((n, 6)).astype(dtype),
            "y": r.standard_normal((n, 1)).astype(dtype)}


@pytest.fixture
def fc():
    main, startup, h, cost = _fc_program()
    exe, scope = pt.Executor(CPU), pt.Scope()
    exe.run(startup, scope=scope)
    return exe, scope, main, startup, h, cost


def _counts(exe):
    c = exe._engine.counters
    return c["runs"], c["fast_path_hits"], c["traces"]


def test_second_run_hits_the_plan(fc):
    exe, scope, main, _, _, cost = fc
    base = _counts(exe)                        # the startup run's plan
    exe.run(main, feed=_feed(), fetch_list=[cost], scope=scope)
    exe.run(main, feed=_feed(seed=1), fetch_list=[cost], scope=scope)
    exe.run(main, feed=_feed(seed=2), fetch_list=[cost], scope=scope)
    runs, hits, traces = _counts(exe)
    assert (runs - base[0], hits - base[1], traces - base[2]) == (3, 2, 1)


def _run_counts(exe, *runs):
    """(hits, traces) that each call of `runs` adds."""
    out = []
    for fn in runs:
        _, h0, t0 = _counts(exe)
        fn()
        _, h1, t1 = _counts(exe)
        out.append((h1 - h0, t1 - t0))
    return out


def test_each_invalidation_builds_a_new_plan(fc):
    exe, scope, main, startup, h, cost = fc

    def run(feed=None, fetch=(cost,), sc=scope):
        return lambda: exe.run(main, feed=feed or _feed(),
                               fetch_list=list(fetch), scope=sc)

    other = pt.Scope()
    exe.run(startup, scope=other)

    def append_op():
        with pt.program_guard(main, startup):
            pt.layers.scale(cost, scale=2.0)

    def set_amp():
        main._amp = {"dtype": torch.bfloat16, "black_ops": frozenset(),
                     "white_ops": frozenset()}

    def regroup():
        info = OPS.get("sgd")
        info.group = info.group       # setting it, even to itself

    steps = [run(), run(),                          # build, hit
             run(fetch=(cost, h)), run(fetch=(cost, h)),
             run(feed=_feed(n=7)), run(feed=_feed(n=7)),
             run(sc=other), run(sc=other),
             append_op, run(), run(),
             set_amp, run(), run(),
             regroup, run(), run()]
    got = _run_counts(exe, *steps)
    build, hit, none = (0, 1), (1, 0), (0, 0)
    assert got == [build, hit, build, hit, build, hit, build, hit,
                   none, build, hit, none, build, hit, none, build, hit]


def test_another_feed_dtype_builds_a_new_plan(fc):
    """The Executor casts feeds to the declared dtypes; the engine keys
    its plans on the feed it is given."""
    exe, scope, main, _, _, cost = fc
    eng = exe._engine
    feeds = [{k: v for k, v in _feed().items()},
             {k: v.astype(np.float64) for k, v in _feed().items()}]
    t0 = eng.counters["traces"]
    out = [eng.run(main, scope, torch.device("cpu"), f, [cost.name])[0]
           for f in feeds + feeds]
    assert eng.counters["traces"] - t0 == 2
    assert all(o.dtype == np.float32 for o in out)   # cast to the var's


def test_use_program_cache_false_neither_hits_nor_fills(fc):
    exe, scope, main, _, _, cost = fc
    for _ in range(3):
        exe.run(main, feed=_feed(), fetch_list=[cost], scope=scope,
                use_program_cache=False)
    runs, hits, traces = _counts(exe)
    assert (runs, hits, traces) == (4, 0, 4)        # the startup's too
    assert sum(len(v) for v in exe._engine._plans.values()) == 1
    exe.run(main, feed=_feed(), fetch_list=[cost], scope=scope)
    assert _counts(exe) == (5, 0, 5)


def test_a_key_keeps_at_most_four_plans(fc):
    exe, scope, main, _, _, cost = fc
    for n in range(1, 7):
        exe.run(main, feed=_feed(n=n), fetch_list=[cost], scope=scope)
    key = E.Engine._key(main, [cost.name])
    plans = exe._engine._plans[key]
    assert len(plans) == E._MAX_PLANS == 4
    assert [p.feed_sig[0][1] for p in plans] == [(n, 6) for n in
                                                 range(3, 7)]
    _, h0, t0 = _counts(exe)
    exe.run(main, feed=_feed(n=6), fetch_list=[cost], scope=scope)
    exe.run(main, feed=_feed(n=1), fetch_list=[cost], scope=scope)
    assert _counts(exe)[1:] == (h0 + 1, t0 + 1)      # 6 kept, 1 dropped


def test_uninitialized_or_erased_persistable_still_raises(fc):
    exe, scope, main, startup, _, cost = fc
    fresh = pt.Scope()
    with pytest.raises(RuntimeError, match="run the startup program "
                                           "first"):
        exe.run(main, feed=_feed(), fetch_list=[cost], scope=fresh)
    exe.run(main, feed=_feed(), fetch_list=[cost], scope=scope)
    w = main.all_parameters()[0].name
    scope.find_var(w).get_tensor().set_tensor(None)   # uninitialized
    with pytest.raises(RuntimeError, match=f"first\\?\\): \\[{w!r}\\]"):
        exe.run(main, feed=_feed(), fetch_list=[cost], scope=scope)
    exe.run(startup, scope=scope)
    exe.run(main, feed=_feed(), fetch_list=[cost], scope=scope)
    scope.erase([w])                                  # erased
    with pytest.raises(RuntimeError, match=f"first\\?\\): \\[{w!r}\\]"):
        exe.run(main, feed=_feed(), fetch_list=[cost], scope=scope)
    assert scope.find_var(w) is None


# ---------------------------------------------------------------------------
# training is bit-equal with and without the cache
# ---------------------------------------------------------------------------

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


def _transformer():
    cfg = T.transformer_base(src_vocab_size=64, trg_vocab_size=64,
                             fuse_attention=True, dropout=0.1)
    cfg.n_layer, cfg.d_model, cfg.d_inner = 1, 32, 64
    cfg.n_head, cfg.d_head = 4, 8
    pt.framework.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        cost, _, _ = T.transformer_train(cfg)
        pt.optimizer.AdamOptimizer(learning_rate=2e-3).minimize(cost)
    main.random_seed = startup.random_seed = 7
    feed = T.make_batch(cfg, 4, 16, 12, rng=np.random.default_rng(3),
                        src_lens=np.array([16, 11, 7, 13]),
                        trg_lens=np.array([12, 9, 5, 12]))
    return main, startup, cost, feed


@pytest.mark.parametrize("model", [_lenet, _transformer],
                         ids=["lenet", "transformer"])
def test_three_steps_bit_equal_with_and_without_the_cache(model):
    main, startup, cost, feed = model()
    results = {}
    for cached in (True, False):
        exe, scope = pt.Executor(CPU), pt.Scope()
        exe.run(startup, scope=scope)
        losses = [exe.run(main, feed=feed, fetch_list=[cost], scope=scope,
                          use_program_cache=cached)[0] for _ in range(3)]
        state = {v.name: scope.find_var(v.name).get_tensor().tensor.clone()
                 for v in main.global_block().vars.values()
                 if v.persistable and scope.find_var(v.name) is not None}
        results[cached] = (losses, state, _counts(exe))
    (la, sa, ca), (lb, sb, cb) = results[True], results[False]
    assert all(np.array_equal(a, b) for a, b in zip(la, lb))
    assert not np.array_equal(la[0], la[-1])      # the steps train
    assert sa.keys() == sb.keys() and len(sa) > 4
    for n in sa:
        assert torch.equal(sa[n], sb[n]), n
    assert ca == (4, 2, 2)      # startup and the first step built plans
    assert cb == (4, 0, 4)
