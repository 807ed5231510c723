"""layers.distributions and the three initializers of slice 25
(TruncatedNormal, NumpyArrayInitializer, Bilinear) in the port, against
the JAX package.

* Uniform, Normal, Categorical and MultivariateNormalDiag: the programs
  their methods build equal the JAX package's op for op; entropy,
  log_prob and kl_divergence on the same feeds agree within 1e-5
  (float32 transcendental functions in XLA and torch), and against the
  closed forms; samples have the JAX samples' shapes and dtypes and lie
  in their support; Categorical.sample draws through sampling_id and
  raises where the JAX one raises.
* The initializers build the JAX package's startup ops; NumpyArray and
  Bilinear fill exactly the JAX values, TruncatedNormal draws the
  truncated normal's law (KS test at ALPHA) in [-2 std, 2 std].
"""
import math

import numpy as np
import pytest
from scipy import stats

import paddle_tpu as fluid
from paddle_tpu.core.scope import Scope as JaxScope

import paddle_tpu_torch as pt

from test_torch_quantization import _same_program

RTOL = ATOL = 1e-5
ALPHA = 1e-3


def _run(fl, main, startup, feed, fetch):
    if fl is fluid:
        scope, exe = JaxScope(), fluid.Executor(fluid.CPUPlace())
    else:
        scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    return [np.asarray(v) for v in exe.run(main, feed=feed,
                                           fetch_list=fetch, scope=scope)]


def _both(build, feed):
    """The program `build(fl)` makes in each package (they must be the
    same) and its fetches: {package: values}."""
    out, progs = {}, {}
    for fl in (fluid, pt):
        fl.framework.unique_name.reset()
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup):
            fetch = build(fl)
        progs[fl] = main
        out[fl] = _run(fl, main, startup, feed, [v.name for v in fetch])
    _same_program(progs[pt], progs[fluid])
    return out[fluid], out[pt]


def _close(j, p, n=None):
    for a, b in zip(j[:n], p[:n]):
        assert b.shape == a.shape and b.dtype == a.dtype
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)


def test_normal_matches_jax_and_the_closed_forms():
    def build(fl):
        L = fl.layers
        loc = L.data("loc", [3], dtype="float32")
        scale = L.data("scale", [3], dtype="float32")
        d = L.distributions.Normal(loc, scale)
        other = L.distributions.Normal(L.scale(loc, bias=1.0),
                                       L.scale(scale, scale=2.0))
        return [d.entropy(), d.log_prob(L.scale(loc, bias=0.5)),
                d.kl_divergence(other), d.sample([4, 3], seed=7)]
    loc = np.array([[0.0, 1.0, -2.0]], np.float32)
    scale = np.array([[1.0, 0.5, 2.0]], np.float32)
    j, p = _both(build, {"loc": loc, "scale": scale})
    _close(j, p, 3)
    np.testing.assert_allclose(
        p[0], 0.5 + 0.5 * math.log(2 * math.pi) + np.log(scale), rtol=1e-5)
    np.testing.assert_allclose(
        p[1], stats.norm(loc, scale).logpdf(loc + 0.5), rtol=1e-5)
    s2 = 2 * scale
    kl = np.log(s2 / scale) + (scale ** 2 + 1.0) / (2 * s2 ** 2) - 0.5
    np.testing.assert_allclose(p[2], kl, rtol=1e-5)
    assert p[3].shape == j[3].shape == (4, 3) and p[3].dtype == j[3].dtype


def test_uniform_matches_jax():
    def build(fl):
        L = fl.layers
        d = L.distributions.Uniform(0.5, 2.5)
        v = L.data("v", [4], dtype="float32")
        return [d.entropy(), d.log_prob(v), d.sample([2000], seed=3)]
    v = np.array([[0.0, 0.5, 1.0, 2.6]], np.float32)
    j, p = _both(build, {"v": v})
    _close(j, p, 2)
    np.testing.assert_allclose(p[0], math.log(2.0), rtol=1e-6)
    for s in (j[2], p[2]):
        assert s.shape == (2000,) and (s >= 0.5).all() and (s < 2.5).all()
        assert stats.kstest(s, stats.uniform(0.5, 2.0).cdf).pvalue > ALPHA


def test_categorical_matches_jax_and_samples_through_sampling_id():
    probs = np.array([[0.1, 0.2, 0.3, 0.4], [0.7, 0.1, 0.1, 0.1]],
                     np.float32)

    def build(fl):
        L = fl.layers
        lg = L.data("lg", [4], dtype="float32")
        other = L.data("lg2", [4], dtype="float32")
        d = L.distributions.Categorical(lg)
        return [d.entropy(), d.log_prob(L.data("ix", [1], dtype="int64")),
                d.kl_divergence(L.distributions.Categorical(other)),
                d.sample(seed=5)]
    feed = {"lg": np.log(probs), "lg2": np.log(probs[::-1].copy()),
            "ix": np.array([[2], [0]], np.int64)}
    j, p = _both(build, feed)
    _close(j, p, 3)
    np.testing.assert_allclose(p[0], -(probs * np.log(probs)).sum(1),
                               rtol=1e-4)
    np.testing.assert_allclose(p[1], np.log([0.3, 0.7]), rtol=1e-4)
    assert p[3].dtype == np.int64 and p[3].shape == j[3].shape == (2,)
    pt.framework.unique_name.reset()
    with pt.program_guard(pt.Program(), pt.Program()):
        d = pt.layers.distributions.Categorical(
            pt.layers.data("lg", [4], dtype="float32"))
        d.sample()
        types = [o.type for o in pt.default_main_program()
                 .global_block().ops]
        assert "sampling_id" in types
        with pytest.raises(NotImplementedError):
            d.sample([3])


def test_multivariate_normal_diag_matches_jax():
    def build(fl):
        L = fl.layers
        loc = L.data("loc", [3], dtype="float32")
        scale = L.data("scale", [3], dtype="float32")
        d = L.distributions.MultivariateNormalDiag(loc, scale)
        other = L.distributions.MultivariateNormalDiag(
            L.scale(loc, bias=0.5), L.scale(scale, scale=1.5))
        return [d.entropy(), d.log_prob(L.scale(loc, bias=0.25)),
                d.kl_divergence(other), d.sample([2, 3], seed=2)]
    loc = np.array([[0.0, 1.0, -2.0]], np.float32)
    scale = np.array([[1.0, 0.5, 2.0]], np.float32)
    j, p = _both(build, {"loc": loc, "scale": scale})
    _close(j, p, 3)
    want = stats.multivariate_normal(loc[0], np.diag(scale[0] ** 2))
    np.testing.assert_allclose(p[0], want.entropy(), rtol=1e-5)
    np.testing.assert_allclose(p[1], want.logpdf(loc[0] + 0.25), rtol=1e-5)
    assert p[3].shape == j[3].shape


# ---------------------------------------------------------------------------
# the initializers
# ---------------------------------------------------------------------------

def _init_program(fl, init, shape, dtype="float32"):
    fl.framework.unique_name.reset()
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        w = fl.layers.create_parameter(shape, dtype,
                                       default_initializer=init)
    return main, startup, w


@pytest.mark.parametrize("kind", ["numpy_float", "numpy_int64", "bilinear",
                                  "truncated_normal"])
def test_initializers_match_jax(kind):
    vals = {}
    for fl in (fluid, pt):
        I = fl.initializer
        if kind == "numpy_float":
            arr = np.arange(12, dtype=np.float32).reshape(3, 4) / 7
            init, shape, dt = I.NumpyArrayInitializer(arr), [3, 4], \
                "float32"
        elif kind == "numpy_int64":
            arr = np.arange(6, dtype=np.int64).reshape(2, 3) - 2
            init, shape, dt = I.NumpyArrayInitializer(arr), [2, 3], "int64"
        elif kind == "bilinear":
            init, shape, dt = I.Bilinear(), [3, 1, 4, 4], "float32"
        else:
            init, shape, dt = I.TruncatedNormal(loc=1.0, scale=0.5, seed=0), \
                [100, 200], "float32"
        main, startup, w = _init_program(fl, init, shape, dt)
        ops = [(o.type, o.all_attrs()) for o in startup.global_block().ops]
        scope = JaxScope() if fl is fluid else pt.Scope()
        fl.Executor(fl.CPUPlace()).run(startup, scope=scope)
        vals[fl] = (ops, np.asarray(scope.find_var(w.name).get_tensor()))
    (jops, jw), (pops, pw) = vals[fluid], vals[pt]
    assert [t for t, _ in pops] == [t for t, _ in jops]
    assert [a for _, a in pops] == [a for _, a in jops]
    # the JAX package (64-bit types off) fills int64 as int32
    assert pw.shape == jw.shape and (pw.dtype == jw.dtype or (
        pw.dtype == np.int64 and jw.dtype == np.int32))
    if kind == "truncated_normal":
        for d in (jw, pw):
            assert d.min() >= 0.0 and d.max() <= 2.0
            law = stats.truncnorm(-2, 2, loc=1.0, scale=0.5)
            assert stats.kstest(d.ravel(), law.cdf).pvalue > ALPHA
    else:
        np.testing.assert_array_equal(pw, jw)
    if kind == "bilinear":
        assert pw[0, 0, 1, 1] == pw.max() and pw.min() > 0


def test_initializer_aliases():
    I = pt.initializer
    assert I.TruncatedNormal is I.TruncatedNormalInitializer
    assert I.Bilinear is I.BilinearInitializer
    assert set(fluid.initializer.__all__) - set(I.__all__) <= \
        {"force_init_on_cpu", "init_on_cpu"}


def test_a_0d_assign_value_stays_0d_as_in_jax():
    """A 0-d numpy value through layers.assign (assign_value) is 0-d, as
    in the JAX package (the port's host table once made it [1]: the
    distributions' scalar parameters)."""
    shapes = {}
    for fl in (fluid, pt):
        fl.framework.unique_name.reset()
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup):
            a = fl.layers.assign(np.asarray(0.5, np.float32))
            b = fl.layers.assign(np.asarray([[1, 2]], np.int32))
        shapes[fl] = [o.shape for o in _run(fl, main, startup, {},
                                            [a.name, b.name])]
    assert shapes[pt] == shapes[fluid] == [(), (1, 2)]
