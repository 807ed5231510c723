"""The conv op family in the port against the JAX package's lowerings,
its builders and the dygraph layers that use them.

* Every case of ops/family_cases.py's conv_cases() (the transposed
  convolutions with groups 2 and depthwise, conv3d, pool3d with
  ceil_mode and exclusive, adaptive pool2d / pool3d, max_pool2d_with_index,
  unfold, spp, both interpolations with align_corners both ways, a scale
  and an OutSize input, the layout ops) through the port's lowering
  (family_cases.run) and the JAX lowering on the same seeded inputs, and
  both `<op>_grad` lowerings (the generic vjp in each) under one random
  cotangent of every float output (test_torch_op_families._grads).
  Tolerance: TOL = 1e-5 relative and absolute, float32 (the
  convolutions' sums run in another order).
* max_pool2d_with_index's Out is held to the JAX op; its Mask is the
  reference's (each maximum's flat h * W + w index in the unpadded
  input) held to a numpy argmax, exactly: the JAX op writes zeros.
* Adaptive pooling raises on sizes that do not divide, as the JAX op.
* Under AMP the transposed convolutions compute in bf16 as the JAX op
  does and return the JAX op's dtype, within 1e-2 of its largest value.
* The builders (mul, sum, gaussian_random, lstm_unit, gru_unit,
  merge_selected_rows, get_tensor_from_selected_rows, rank,
  conv2d_transpose, conv3d, pool3d, the adaptive pools, the resizes,
  the layout ops, spp) build the JAX package's ProgramDesc byte
  for byte, and their forward from the JAX package's initial
  parameters equals the JAX forward within TOL. conv3d_transpose is
  the JAX builder's alias of the 2-D one, which cannot run on a 5-D
  input: the port's builds a conv3d_transpose op, held to the JAX op's
  lowering. The JAX unfold builder binds the op's output to Out, which
  the op never writes: the port's binds Y, held to the JAX op.
  image_resize_short fails in the JAX package (its module's
  `round` is the layer builder); the port's equals image_resize to the
  rounded sizes.
* The dygraph layers Conv2DTranspose, Conv3D, GroupNorm and PRelu
  against the JAX dygraph's (outputs and gradients within TOL from the
  same parameters), Conv3DTranspose against the JAX op's lowering.
"""
import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as fluid
from paddle_tpu.core import amp as jamp
from paddle_tpu.core.registry import ExecContext as JaxContext
from paddle_tpu.core.registry import OPS as JAX_OPS
from paddle_tpu.core.scope import Scope as JaxScope

import paddle_tpu_torch as pt
from paddle_tpu_torch.core import amp as pamp
from paddle_tpu_torch.core.registry import ExecContext as PtContext
from paddle_tpu_torch.core.registry import OPS as PT_OPS
from paddle_tpu_torch.io import load_params_from_numpy
from paddle_tpu_torch.ops import family_cases

from test_torch_op_families import TOL, _check, _grads
from test_torch_sequence import CPU, _op
from torch_threads import one_torch_thread  # noqa: F401

CASES = family_cases.conv_cases()


def _jax_forward(op_type, inputs, attrs, outs):
    op, env = _op(op_type, inputs, outs, attrs)
    jenv = {n: jnp.asarray(a) for n, a in env.items()}
    JAX_OPS.get(op_type).lowering(JaxContext(op, jenv, None, None, {}))
    return jenv


@pytest.mark.parametrize("case", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_conv_op_matches_jax(case):
    op_type, inputs, attrs, out_slots, diff = case
    names = {s: [f"{s.lower()}_out{i}" for i in range(n)]
             for s, n in out_slots.items()}
    port, _ = family_cases.run(op_type, inputs, attrs, out_slots, "cpu")
    jenv = _jax_forward(op_type, inputs, attrs, names)
    for slot, ns in names.items():
        if slot == "Mask":          # the JAX op's zeros: see below
            continue
        for n in ns:
            _check(jenv[n], port[n], f"{op_type} {n}")
    if diff:
        _grads(op_type, inputs, attrs, names, jenv, diff)


def _family(ops):
    return {t for t in ops.types() if not ops.get(t).is_grad_op and
            inspect.getmodule(ops.get(t).lowering).__name__
            .endswith("ops.conv")}


def test_conv_family_is_registered_whole():
    """The 15 op types of the JAX package's ops/conv.py beside conv2d,
    depthwise_conv2d and pool2d are registered in the port's ops/conv.py,
    each has a case above, and each has a gradient op in the port
    exactly where it has one in the JAX package."""
    jax_types = _family(JAX_OPS)
    assert jax_types == _family(PT_OPS)
    new = jax_types - {"conv2d", "depthwise_conv2d", "pool2d"}
    assert len(new) == 15
    covered = {c[0] for c in CASES}
    assert new <= covered, sorted(new - covered)
    assert {"pool2d", "pool3d"} <= {c[0] for c in CASES
                                    if c[2].get("adaptive")}
    for t in jax_types:
        assert PT_OPS.has(t + "_grad") == JAX_OPS.has(t + "_grad"), t


def _argmax_mask(x, ksize, strides, paddings):
    """Each window's maximum as its flat h * W + w index in x."""
    n, c, h, w = x.shape
    (kh, kw), (sh, sw), (ph, pw) = ksize, strides, paddings
    oh = (h + 2 * ph - kh) // sh + 1
    ow = (w + 2 * pw - kw) // sw + 1
    mask = np.zeros((n, c, oh, ow), np.int32)
    for i in range(oh):
        for j in range(ow):
            r0, c0 = i * sh - ph, j * sw - pw
            rs = range(max(r0, 0), min(r0 + kh, h))
            cs = range(max(c0, 0), min(c0 + kw, w))
            win = x[:, :, rs.start:rs.stop, cs.start:cs.stop]
            flat = win.reshape(n, c, -1).argmax(-1)
            mask[:, :, i, j] = (rs.start + flat // len(cs)) * w + \
                cs.start + flat % len(cs)
    return mask


@pytest.mark.parametrize("case", [c for c in CASES
                                  if c[0] == "max_pool2d_with_index"])
def test_max_pool_mask_is_the_reference_argmax(case):
    _, inputs, attrs, out_slots, _ = case
    port, _ = family_cases.run("max_pool2d_with_index", inputs, attrs,
                               out_slots, "cpu")
    want = _argmax_mask(inputs["X"], attrs["ksize"], attrs["strides"],
                        attrs["paddings"])
    got = port["mask_out0"].numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # the JAX op's Mask: zeros (ROADMAP's list of the reference's faults)
    jenv = _jax_forward("max_pool2d_with_index", inputs, attrs,
                        {"Out": ["o"], "Mask": ["m"]})
    assert not np.asarray(jenv["m"]).any() and want.any()


@pytest.mark.parametrize("op_type,x,ksize", [
    ("pool2d", (1, 2, 5, 6), [2, 3]), ("pool3d", (1, 2, 4, 4, 6),
                                       [2, 3, 4])])
def test_adaptive_pool_needs_divisible_sizes(op_type, x, ksize):
    inputs = {"X": np.ones(x, np.float32)}
    attrs = {"pooling_type": "avg", "ksize": ksize, "adaptive": True}
    with pytest.raises(AssertionError, match="divisible"):
        _jax_forward(op_type, inputs, attrs, {"Out": ["o"]})
    with pytest.raises(ValueError, match="divisible"):
        family_cases.run(op_type, inputs, attrs, {"Out": 1}, "cpu")


@pytest.mark.parametrize("case", [c for c in CASES if "transpose" in c[0]],
                         ids=lambda c: c[0])
def test_transposed_convolutions_under_amp(case):
    op_type, inputs, attrs, _, _ = case
    op, env = _op(op_type, inputs, {"Output": ["y"]}, attrs)
    jenv = {n: jnp.asarray(a) for n, a in env.items()}
    penv = {n: torch.from_numpy(np.array(a)) for n, a in env.items()}
    with jamp.amp_guard(True):
        JAX_OPS.get(op_type).lowering(JaxContext(op, jenv, None, None, {}))
    with pamp.amp_guard(True):
        PT_OPS.get(op_type).lowering(PtContext(op, penv, CPU, None, {}))
    j = np.asarray(jenv["y"].astype(jnp.float32))
    p = penv["y"].float().numpy()
    assert str(penv["y"].dtype).split(".")[-1] == str(jenv["y"].dtype)
    assert penv["y"].dtype == (torch.bfloat16 if op_type ==
                               "conv2d_transpose" else torch.float32)
    assert np.abs(p - j).max() <= 1e-2 * np.abs(j).max()


# ---------------------------------------------------------------------------
# the builders
# ---------------------------------------------------------------------------

def _builders(fl):
    """A program of the new builders on small data vars; returns (main,
    startup, fetch vars, feed)."""
    L = fl.layers
    fl.framework.unique_name.reset()
    main, startup = fl.Program(), fl.Program()
    main.random_seed = startup.random_seed = 5
    with fl.program_guard(main, startup):
        img = L.data("img", [4, 6, 8], dtype="float32")
        vol = L.data("vol", [2, 4, 6, 6], dtype="float32")
        x = L.data("x", [6], dtype="float32")
        y = L.data("y", [6, 3], dtype="float32", append_batch_size=False)
        hid = L.data("hid", [3], dtype="float32")
        cell = L.data("cell", [3], dtype="float32")
        g3 = L.data("g3", [9], dtype="float32")
        sc = L.create_parameter([4], "float32", name="aff_s")
        bi = L.create_parameter([4], "float32", name="aff_b")
        h, c = L.lstm_unit(x, hid, cell)
        gh, gr, gg = L.gru_unit(g3, hid, 9)
        outs = [
            L.mul(x, y), L.sum([x, x, x]), L.rank(vol), h, c, gh, gr, gg,
            L.conv2d_transpose(img, 5, filter_size=3, stride=2, padding=1,
                               act="relu"),
            L.conv2d_transpose(img, 4, output_size=[13, 17], stride=2,
                               groups=2, bias_attr=False),
            L.conv3d(vol, 3, 3, padding=1, act="relu"),
            L.pool3d(vol, 2, "avg", 2, ceil_mode=True),
            L.adaptive_pool2d(img, [3, 4], "max"),
            L.adaptive_pool3d(vol, [2, 3, 1], "avg"),
            L.image_resize(img, [9, 11]),
            L.resize_bilinear(img, scale=1.5, align_corners=False),
            L.resize_nearest(img, [12, 16]),
            L.pixel_shuffle(img, 2),
            L.space_to_depth(img, 2),
            L.shuffle_channel(img, 2),
            L.affine_channel(img, sc, bi),
            L.temporal_shift(img, 2, 0.25),
            L.spp(img, 2, "avg"),
        ]
    rng = np.random.default_rng(13)
    feed = {"img": rng.standard_normal((2, 4, 6, 8)).astype(np.float32),
            "vol": rng.standard_normal((2, 2, 4, 6, 6)).astype(np.float32),
            "x": rng.standard_normal((2, 6)).astype(np.float32),
            "y": rng.standard_normal((6, 3)).astype(np.float32),
            "hid": rng.standard_normal((2, 3)).astype(np.float32),
            "cell": rng.standard_normal((2, 3)).astype(np.float32),
            "g3": rng.standard_normal((2, 9)).astype(np.float32)}
    return main, startup, outs, feed


def _startup_state(jmain, jstart, pstart):
    jscope, jexe = JaxScope(), fluid.Executor(fluid.CPUPlace())
    jexe.run(jstart, scope=jscope)
    state = {v.name: np.asarray(jscope.find_var(v.name).get_tensor())
             for v in jmain.global_block().vars.values()
             if v.persistable and jscope.find_var(v.name) is not None}
    pscope, pexe = pt.Scope(), pt.Executor(pt.CPUPlace())
    pexe.run(pstart, scope=pscope)
    load_params_from_numpy(pscope, state, pt.CPUPlace())
    return jscope, jexe, pscope, pexe


def test_builders_match_jax():
    jmain, jstart, jouts, feed = _builders(fluid)
    pmain, pstart, pouts, _ = _builders(pt)
    assert pmain.serialize_to_string() == jmain.serialize_to_string()
    assert pstart.serialize_to_string() == jstart.serialize_to_string()
    jscope, jexe, pscope, pexe = _startup_state(jmain, jstart, pstart)
    jres = jexe.run(jmain, feed=feed, fetch_list=jouts, scope=jscope)
    pres = pexe.run(pmain, feed=feed, fetch_list=pouts, scope=pscope)
    for v, j, p in zip(pouts, jres, pres):
        j, p = np.asarray(j), np.asarray(p)
        assert p.shape == j.shape, v.name
        np.testing.assert_allclose(p, j, rtol=TOL, atol=TOL,
                                   err_msg=v.name)


def _program_only(fl):
    """Builders whose ops need inputs these tests do not make (a
    SelectedRows) or draw at random: ProgramDesc bytes only."""
    L = fl.layers
    fl.framework.unique_name.reset()
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        x = L.data("x", [6], dtype="float32")
        L.merge_selected_rows(x)
        L.get_tensor_from_selected_rows(x)
        L.gaussian_random([3, 4], mean=0.5, std=2.0, seed=7)
    return main


def test_program_only_builders_match_jax():
    assert _program_only(pt).serialize_to_string() == \
        _program_only(fluid).serialize_to_string()
    # require_index builds a max_pool3d_with_index op (slice 26; its
    # program and run against JAX: tests/test_torch_misc_ops.py)
    progs = []
    for fl in (pt, fluid):
        fl.framework.unique_name.reset()
        main = fl.Program()
        with fl.program_guard(main, fl.Program()):
            fl.layers.adaptive_pool3d(
                fl.layers.data("v", [2, 4, 4, 4], dtype="float32"), 2,
                require_index=True)
        progs.append(main)
    assert [o.type for o in progs[0].global_block().ops] == \
        ["max_pool3d_with_index"]
    assert progs[0].serialize_to_string() == progs[1].serialize_to_string()


def test_conv3d_transpose_builder_runs_the_3d_op():
    pt.framework.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        vol = pt.layers.data("vol", [3, 2, 3, 3], dtype="float32")
        out = pt.layers.conv3d_transpose(vol, 4, filter_size=[2, 3, 3],
                                         stride=2, padding=[0, 1, 1],
                                         groups=1, bias_attr=False)
        sized = pt.layers.conv3d_transpose(vol, 2, output_size=[4, 7, 7],
                                           stride=2, bias_attr=False)
    op = main.global_block().ops[0]
    assert op.type == "conv3d_transpose"
    assert (op.attr("strides"), op.attr("paddings"),
            op.attr("dilations")) == ([2, 2, 2], [0, 1, 1], [1, 1, 1])
    filters = [p for p in main.all_parameters()]
    assert [list(p.shape) for p in filters] == [[3, 4, 2, 3, 3],
                                                [3, 2, 2, 3, 3]]
    assert list(out.shape)[1:] == [4, 4, 5, 5] and \
        list(sized.shape)[1:] == [2, 4, 7, 7]
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    x = np.random.default_rng(3).standard_normal(
        (2, 3, 2, 3, 3)).astype(np.float32)
    got = exe.run(main, feed={"vol": x}, fetch_list=[out, sized],
                  scope=scope)
    for var, o, v in zip(main.global_block().ops, got, (out, sized)):
        w = np.asarray(scope.find_var(var.input("Filter")[0]).get_tensor())
        attrs = {k: var.attr(k) for k in ("strides", "paddings",
                                          "dilations", "groups")}
        j = _jax_forward("conv3d_transpose", {"Input": x, "Filter": w},
                         attrs, {"Output": ["y"]})["y"]
        assert np.asarray(o).shape == tuple(j.shape)
        np.testing.assert_allclose(np.asarray(o), np.asarray(j), rtol=TOL,
                                   atol=TOL, err_msg=v.name)
    # the JAX builder is the 2-D one: a conv2d_transpose op with 2-D
    # attrs, which fails on a 5-D input
    fluid.framework.unique_name.reset()
    jmain, jstart = fluid.Program(), fluid.Program()
    with fluid.program_guard(jmain, jstart):
        jy = fluid.layers.conv3d_transpose(
            fluid.layers.data("vol", [3, 2, 3, 3], dtype="float32"), 4,
            filter_size=[2, 3, 3], stride=2)
    assert jmain.global_block().ops[0].type == "conv2d_transpose"
    jscope, jexe = JaxScope(), fluid.Executor(fluid.CPUPlace())
    jexe.run(jstart, scope=jscope)
    with pytest.raises(Exception, match="conv2d_transpose"):
        jexe.run(jmain, feed={"vol": x}, fetch_list=[jy], scope=jscope)


def test_unfold_builder_binds_the_op_output():
    """The port's unfold binds Y, the slot the op writes (the JAX
    builder binds Out and its program cannot fetch it); its result is
    the JAX op's."""
    for fl in (fluid, pt):
        fl.framework.unique_name.reset()
        main = fl.Program()
        with fl.program_guard(main, fl.Program()):
            y = fl.layers.unfold(fl.layers.data("img", [4, 6, 8],
                                                dtype="float32"),
                                 [2, 3], paddings=[1, 0, 1, 2])
        assert list(main.global_block().ops[0]._outputs) == \
            (["Out"] if fl is fluid else ["Y"])
    x = np.random.default_rng(9).standard_normal(
        (2, 4, 6, 8)).astype(np.float32)
    got = pt.Executor(pt.CPUPlace()).run(main, feed={"img": x},
                                         fetch_list=[y],
                                         scope=pt.Scope())[0]
    attrs = {k: main.global_block().ops[0].attr(k) for k in
             ("kernel_sizes", "strides", "paddings", "dilations")}
    j = _jax_forward("unfold", {"X": x}, attrs, {"Y": ["y"]})["y"]
    np.testing.assert_allclose(np.asarray(got), np.asarray(j), rtol=TOL,
                               atol=TOL)


def test_image_resize_short():
    pt.framework.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        img = pt.layers.data("img", [3, 6, 9], dtype="float32")
        short = pt.layers.image_resize_short(img, 8)
        direct = pt.layers.image_resize(img, [8, 12])
    assert list(short.shape)[1:] == [3, 8, 12]
    x = np.random.default_rng(4).standard_normal(
        (2, 3, 6, 9)).astype(np.float32)
    a, b = pt.Executor(pt.CPUPlace()).run(
        main, feed={"img": x}, fetch_list=[short, direct], scope=pt.Scope())
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # the JAX builder calls its module's `round`, the layer builder
    with fluid.program_guard(fluid.Program(), fluid.Program()):
        with pytest.raises(Exception):
            fluid.layers.image_resize_short(
                fluid.layers.data("img", [3, 6, 9], dtype="float32"), 8)


# ---------------------------------------------------------------------------
# the dygraph layers
# ---------------------------------------------------------------------------

def _layer_net(kind):
    def build(fl):
        nn = fl.dygraph.nn

        class Net(fl.dygraph.Layer):
            def __init__(self):
                super().__init__("net")
                self.layer = {
                    "Conv2DTranspose": lambda: nn.Conv2DTranspose(
                        "d", 5, filter_size=4, stride=2, padding=1,
                        act="relu"),
                    "Conv3D": lambda: nn.Conv3D("c", 3, 3, padding=1,
                                                act="relu"),
                    "GroupNorm": lambda: nn.GroupNorm("g", groups=2,
                                                      act="relu"),
                    "PRelu": lambda: nn.PRelu("p", mode="channel"),
                }[kind]()

            def forward(self, x):
                return self.layer(x)
        return Net()
    return build


DY_SHAPES = {"Conv2DTranspose": (2, 4, 3, 5), "Conv3D": (2, 2, 3, 4, 4),
             "GroupNorm": (2, 4, 3, 5), "PRelu": (2, 4, 3, 5)}


@pytest.mark.parametrize("kind", sorted(DY_SHAPES))
def test_dygraph_layer_matches_jax(kind):
    from test_torch_dygraph import _close, _gradients
    x = np.random.default_rng(6).standard_normal(
        DY_SHAPES[kind]).astype(np.float32)
    jl, jg, js = _gradients(fluid, _layer_net(kind), x)
    pl, pg, _ = _gradients(pt, _layer_net(kind), x, js)
    np.testing.assert_allclose(pl, jl, rtol=TOL, atol=TOL)
    assert set(pg) == set(jg) and len(jg) > 1
    _close(pg, jg, what=kind)


def test_dygraph_conv3d_transpose_matches_the_jax_op():
    x = np.random.default_rng(7).standard_normal(
        (2, 3, 2, 3, 3)).astype(np.float32)
    np.random.seed(0)
    with pt.dygraph.guard(pt.CPUPlace()):
        layer = pt.dygraph.nn.Conv3DTranspose("d3", 4, filter_size=3,
                                              stride=2, padding=1)
        xv = pt.dygraph.to_variable(x)
        y = layer(xv)
        pt.layers.mean(y).backward()
        params = dict(layer._stable_named_parameters())
        w = next(p for k, p in params.items() if len(p.shape) == 5)
        b = next(p for k, p in params.items() if len(p.shape) == 1)
        out, gx = y.numpy(), xv.gradient()
        wv, bv = w.numpy(), b.numpy()
    j = np.asarray(_jax_forward(
        "conv3d_transpose", {"Input": x, "Filter": wv},
        {"strides": [2] * 3, "paddings": [1] * 3, "dilations": [1] * 3,
         "groups": 1}, {"Output": ["y"]})["y"]) + bv.reshape(1, -1, 1, 1, 1)
    assert out.shape == (2, 4, 3, 5, 5)
    np.testing.assert_allclose(out, j, rtol=TOL, atol=TOL)
    assert gx.shape == x.shape and np.abs(gx).max() > 0
