"""The random ops in the port, against the JAX package.

torch cannot draw jax.random's bits, so each op is held to the JAX op in
what a draw must share: the shape and dtype of every output, the bounds,
and the law, at level ALPHA (a Kolmogorov-Smirnov test for the
continuous draws, chi-square for the discrete ones, on both packages'
draws). Within the port the same seed draws the same numbers, and a
block holding sampling_id and random_crop replays (on the CPU: the
engine's replay bookkeeping) what its eager runs draw.

C.1: a `ShapeTensor` input sets the shape of uniform_random,
gaussian_random, truncated_gaussian_random and randint as in the JAX
package; it is read on the host, so a block holding one stays eager with
the op type as its reason.
"""
import numpy as np
import pytest
import torch
from scipy import stats

import jax.numpy as jnp

import paddle_tpu  # noqa: F401
from paddle_tpu.core.registry import ExecContext as JaxContext
from paddle_tpu.core.registry import OPS as JAX_OPS

import paddle_tpu_torch as pt
from paddle_tpu_torch.core.registry import ExecContext as PtContext
from paddle_tpu_torch.core.registry import OPS as PT_OPS
from paddle_tpu_torch.core.registry import RunState

from test_torch_ops import _Op

ALPHA = 1e-3
SIX = ("uniform_random_batch_size_like", "gaussian_random_batch_size_like",
       "truncated_gaussian_random", "randint", "sampling_id", "random_crop")


def _draw(op_type, inputs, outs, attrs, run=0, seed=0):
    """{slot: (JAX numpy, port numpy)}; the port's op draws for run index
    `run` of a program with seed `seed`."""
    op = _Op(op_type, inputs, outs, dict(attrs, __op_uid__=5))
    jenv = {s.lower(): jnp.asarray(a) for s, a in inputs.items()}
    JAX_OPS.get(op_type).lowering(JaxContext(op, jenv))
    penv = {s.lower(): torch.from_numpy(np.array(a))
            for s, a in inputs.items()}
    PT_OPS.get(op_type).lowering(PtContext(op, penv, torch.device("cpu"),
                                           RunState(seed, run)))
    return {s: (np.asarray(jenv[op.output(s)[0]]),
                penv[op.output(s)[0]].numpy()) for s in outs}


def _same_kind(j, p):
    """Equal shapes and dtypes; where the port gives a 64-bit dtype, the
    JAX package (64-bit types off) gives its 32-bit one."""
    assert p.shape == j.shape, (p.shape, j.shape)
    narrow = {np.dtype(np.int64): np.int32, np.dtype(np.float64): np.float32}
    assert p.dtype == j.dtype or narrow.get(p.dtype) == j.dtype, \
        (p.dtype, j.dtype)


def test_the_six_ops_are_registered_as_in_jax():
    for t in SIX:
        assert PT_OPS.has(t) and not PT_OPS.has(t + "_grad")
        assert not JAX_OPS.has(t + "_grad")


@pytest.mark.parametrize("dtype", [9, 10])
def test_uniform_random_batch_size_like(dtype):
    x = np.zeros((37, 3), np.float32)
    attrs = {"shape": [-1, 1000], "input_dim_idx": 0, "output_dim_idx": 0,
             "min": -2.0, "max": 3.0, "dtype": dtype}
    j, p = _draw("uniform_random_batch_size_like", {"Input": x}, ["Out"],
                 attrs)["Out"]
    _same_kind(j, p)
    assert p.shape == (37, 1000)
    for d in (j, p):
        assert d.min() >= -2.0 and d.max() < 3.0
        assert stats.kstest(d.ravel(), stats.uniform(-2, 5).cdf).pvalue \
            > ALPHA


def test_gaussian_random_batch_size_like_on_another_dim():
    x = np.zeros((2, 9), np.float32)
    attrs = {"shape": [500, 7, 3], "input_dim_idx": 1, "output_dim_idx": 2,
             "mean": 1.5, "std": 0.5, "dtype": 9}
    j, p = _draw("gaussian_random_batch_size_like", {"Input": x}, ["Out"],
                 attrs)["Out"]
    _same_kind(j, p)
    assert p.shape == (500, 7, 9)
    for d in (j, p):
        assert stats.kstest(d.ravel(), stats.norm(1.5, 0.5).cdf).pvalue \
            > ALPHA


def test_truncated_gaussian_random_is_the_truncated_normal():
    attrs = {"shape": [200, 300], "mean": -1.0, "std": 2.0, "dtype": 9}
    j, p = _draw("truncated_gaussian_random", {}, ["Out"], attrs)["Out"]
    _same_kind(j, p)
    law = stats.truncnorm(-2.0, 2.0, loc=-1.0, scale=2.0)
    for d in (j, p):
        assert d.min() >= -5.0 and d.max() <= 3.0
        assert stats.kstest(d.ravel(), law.cdf).pvalue > ALPHA


@pytest.mark.parametrize("dtype", [5, 6])
def test_randint(dtype):
    attrs = {"shape": [40000], "low": -3, "high": 9, "dtype": dtype}
    j, p = _draw("randint", {}, ["Out"], attrs)["Out"]
    assert p.dtype == (np.int32 if dtype == 5 else np.int64)
    assert p.shape == j.shape
    for d in (j, p):
        assert d.min() == -3 and d.max() == 8
        counts = np.bincount(d - -3, minlength=12)
        assert stats.chisquare(counts).pvalue > ALPHA


def test_sampling_id_follows_the_rows_probabilities():
    rng = np.random.default_rng(4)
    p = rng.random(7) ** 2
    p /= p.sum()
    rows = 60000
    x = np.tile(p.astype(np.float32), (rows, 1))
    j, q = _draw("sampling_id", {"X": x}, ["Out"], {})["Out"]
    assert q.dtype == np.int64 and q.shape == (rows,) == j.shape
    for d in (j, q):
        counts = np.bincount(d, minlength=7)
        assert stats.chisquare(counts, rows * p).pvalue > ALPHA
    # a one-hot row always draws its class
    one = np.eye(7, dtype=np.float32)[[3, 0, 6]]
    j, q = _draw("sampling_id", {"X": one}, ["Out"], {})["Out"]
    assert q.tolist() == j.tolist() == [3, 0, 6]


def test_random_crop_starts_and_shapes():
    img = np.arange(2 * 3 * 20 * 15, dtype=np.float32).reshape(2, 3, 20, 15)
    attrs = {"shape": [3, 12, 10]}
    outs = _draw("random_crop", {"X": img}, ["Out", "SeedOut"], attrs)
    for s in ("Out", "SeedOut"):
        _same_kind(*outs[s])
    assert outs["SeedOut"][1].tolist() == [0]
    starts = []
    for run in range(800):
        o = _draw("random_crop", {"X": img}, ["Out"], attrs, run=run)
        for d in o["Out"]:
            r, c = divmod(int(d[0, 0, 0, 0]), 15)
            # the crop is the window at (r, c), in every image and channel
            np.testing.assert_array_equal(d, img[:, :, r:r + 12, c:c + 10])
        starts.append(divmod(int(o["Out"][1][0, 0, 0, 0]), 15))
    starts = np.array(starts)
    assert starts.min() == 0 and starts[:, 0].max() == 8 and \
        starts[:, 1].max() == 5
    for i, lim in enumerate((8, 5)):
        counts = np.bincount(starts[:, i], minlength=lim + 1)
        assert stats.chisquare(counts).pvalue > ALPHA


def test_a_seed_draws_the_same_and_runs_draw_anew():
    attrs = {"shape": [64], "mean": 0.0, "std": 1.0, "dtype": 9}
    a = _draw("truncated_gaussian_random", {}, ["Out"], attrs)["Out"][1]
    b = _draw("truncated_gaussian_random", {}, ["Out"], attrs)["Out"][1]
    c = _draw("truncated_gaussian_random", {}, ["Out"], attrs, run=1)[
        "Out"][1]
    d = _draw("truncated_gaussian_random", {}, ["Out"],
              dict(attrs, seed=3), run=1)["Out"][1]
    e = _draw("truncated_gaussian_random", {}, ["Out"],
              dict(attrs, seed=3), run=2)["Out"][1]
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    np.testing.assert_array_equal(d, e)      # a fixed seed draws alike


def _program(fl, with_shape_tensor):
    fl.framework.unique_name.reset()
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        b = main.global_block()
        if with_shape_tensor:
            b.create_var(name="shape", shape=[2], dtype="int64")
        for t in ("uniform_random", "gaussian_random",
                  "truncated_gaussian_random", "randint"):
            b.create_var(name=t, shape=[-1, -1], dtype="float32")
            b.append_op(
                type=t,
                inputs={"ShapeTensor": ["shape"]} if with_shape_tensor
                else {},
                outputs={"Out": [t]},
                attrs={"shape": [2, 2], "dtype": 5 if t == "randint"
                       else 9}, infer_shape=False)
    return main


def test_c1_shape_tensor_sets_the_shape_as_in_jax():
    """C.1: the ShapeTensor input, not the shape attr, sets the shape (and
    the dtype is the attr's), in both packages; the port's block stays
    eager, its reason the op type."""
    shape = np.array([3, 5], np.int64)
    for t in ("uniform_random", "gaussian_random",
              "truncated_gaussian_random", "randint"):
        attrs = {"shape": [2, 2], "dtype": 5 if t == "randint" else 9}
        j, p = _draw(t, {"ShapeTensor": shape}, ["Out"], attrs)["Out"]
        assert j.shape == p.shape == (3, 5), t
        assert j.dtype == p.dtype, t
    main = _program(pt, True)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    fetch = ["uniform_random", "gaussian_random",
             "truncated_gaussian_random", "randint"]
    for shp in ([4, 6], [4, 6], [2, 3]):
        outs = exe.run(main, feed={"shape": np.array(shp, np.int64)},
                       fetch_list=fetch, scope=scope)
        assert all(o.shape == tuple(shp) for o in outs)
    c = exe._engine.counters
    assert c["captures"] == 0 and c["eager_runs"] == 3
    assert list(exe._engine.eager_reasons.values()) == ["uniform_random"]
    # without a ShapeTensor the attr sets it and the block is captured
    main = _program(pt, False)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    for _ in range(3):
        outs = exe.run(main, fetch_list=fetch, scope=scope)
    assert all(o.shape == (2, 2) for o in outs)
    assert exe._engine.counters["captures"] == 1
    assert not exe._engine.eager_reasons


def test_sampling_id_and_random_crop_replay_what_eager_runs_draw():
    """A block with both ops: 4 runs with the plan cache (eager, then the
    engine's replays) and 4 with use_program_cache=False from fresh
    scopes draw the same ids and crops run for run, and the runs differ
    from each other."""
    pt.framework.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        probs = pt.layers.data("probs", [6], dtype="float32")
        ims = pt.layers.data("ims", [2, 9, 8], dtype="float32")
        sid = pt.layers.sampling_id(probs)
        crop = pt.layers.random_crop(ims, [2, 5, 4])
    feed = {"probs": np.full((32, 6), 1 / 6, np.float32),
            "ims": np.random.RandomState(0).rand(3, 2, 9, 8)
            .astype(np.float32)}
    runs = {}
    for cached in (True, False):
        exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
        runs[cached] = [exe.run(main, feed=feed, fetch_list=[sid, crop],
                                scope=scope, use_program_cache=cached)
                        for _ in range(4)]
        if cached:
            assert exe._engine.counters["replays"] == 3
    for a, b in zip(runs[True], runs[False]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert runs[True][0][1].shape == (3, 2, 5, 4)
    assert len({r[0].tobytes() for r in runs[True]}) == 4
