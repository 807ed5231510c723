"""Slice 26's misc ops, builders and dygraph layers in the port against
the JAX package.

* Every case of ops/family_cases.py's misc_cases() through the port's
  lowering (family_cases.run) and the JAX lowering on the same seeded
  inputs: outputs and output LoDs, and both `<op>_grad` lowerings (the
  generic vjp in each) under one random cotangent of every float output
  where the op has a gradient. Tolerance TOL = 1e-5 relative and
  absolute (float32: the order of sums differs), integers exactly. The
  ops that read values on the host (family_cases.MISC_HOST_OPS, a
  lod_reset reading Y's values, an affine_grid reading OutputShape) run
  the JAX lowering eagerly, the rest under jax.jit.
* spectral_norm's U and V advance in a program's scope run after run as
  in the JAX package; the dygraph SpectralNorm and TreeConv equal the
  JAX dygraph's.
* save and save_combine files written by one package are read by the
  other's load and load_combine, and are the same bytes.
* adaptive_pool3d(require_index=True) through a program equals the JAX
  package's.
* Every new builder builds the JAX package's ProgramDesc byte for byte,
  and its program's fetches on the same feeds and parameters equal the
  JAX package's (within TOL).
* The registry: the port registers 323 of the JAX package's 382 forward
  op types, each with a `_grad` op exactly where the JAX package has
  one.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as fluid
from paddle_tpu.core.registry import ExecContext as JaxContext
from paddle_tpu.core.registry import OPS as JAX_OPS

import paddle_tpu_torch as pt
from paddle_tpu_torch.core.registry import ExecContext as PtContext
from paddle_tpu_torch.core.registry import OPS as PT_OPS
from paddle_tpu_torch.io import load_params_from_numpy
from paddle_tpu_torch.ops import family_cases

from test_torch_book import _same_ops, _widen_desc
from test_torch_one_stage_detection import (_grads, _jax_lowering,
                                            _out_names)
from test_torch_op_families import _check
from test_torch_sequence import _op
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5
CPU = torch.device("cpu")
CASES = family_cases.misc_cases()
IDS = [f"{c[0]}-{i}" for i, c in enumerate(CASES)]
NEW_TYPES = {
    "lod_reset", "row_conv", "lstmp", "dense_lstm", "cudnn_lstm", "unique",
    "unique_with_counts", "save", "load", "save_combine", "load_combine",
    "spectral_norm", "center_loss", "cvm", "conv_shift",
    "modified_huber_loss", "pad_constant_like",
    "teacher_student_sigmoid_loss", "similarity_focus", "affine_grid",
    "grid_sampler", "unpool", "max_pool3d_with_index", "deformable_conv",
    "deformable_psroi_pooling", "tree_conv"}
FILE_OPS = {"save", "load", "save_combine", "load_combine"}


def _eager(case):
    """Whether the JAX lowering of a case must run eagerly (a host
    read)."""
    op_type, inputs = case[0], case[1]
    return op_type in family_cases.MISC_HOST_OPS or \
        (op_type == "lod_reset" and "Y" in inputs and not case[2]) or \
        (op_type == "affine_grid" and "OutputShape" in inputs)


def _jax_run(case, names):
    op_type, inputs, lods, attrs = case[:4]
    op, env = _op(op_type, inputs, names, attrs)
    if not _eager(case):
        return _jax_lowering(op_type, op, env, lods)
    jl = dict(lods)
    jenv = {n: jnp.asarray(a) for n, a in env.items()}
    JAX_OPS.get(op_type).lowering(JaxContext(op, jenv, None, None, jl))
    return jenv, jl


def _eager_grads(case, names, fwd):
    """_grads with the JAX grad lowering run eagerly."""
    op_type, inputs, lods, attrs, _, diff = case
    rng = np.random.default_rng(7)
    g_in = dict(inputs)
    for s, ns in names.items():
        v = np.asarray(fwd[ns[0]])
        if np.issubdtype(v.dtype, np.floating):
            g_in[s] = v
            g_in[s + "@GRAD"] = rng.standard_normal(v.shape).astype(v.dtype)
    g_outs = {s + "@GRAD": [s.lower() + "@g"] for s in diff}
    op, env = _op(op_type + "_grad", g_in, g_outs, attrs)
    pg = {n: torch.from_numpy(np.array(a)) for n, a in env.items()}
    PT_OPS.get(op_type + "_grad").lowering(
        PtContext(op, pg, CPU, None, dict(lods)))
    jg = {n: jnp.asarray(a) for n, a in env.items()}
    JAX_OPS.get(op_type + "_grad").lowering(
        JaxContext(op, jg, None, None, dict(lods)))
    keys = [n for ns in g_outs.values() for n in ns]
    return {n: jg[n] for n in keys}, {n: pg[n] for n in keys}


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_misc_op_matches_jax(case):
    op_type, inputs, lods, attrs, out_slots, diff = case
    names = _out_names(out_slots)
    port, plod = family_cases.run(op_type, inputs, attrs, out_slots, "cpu",
                                  lods)
    jenv, jl = _jax_run(case, names)
    for ns in names.values():
        for n in ns:
            _check(jenv[n], port[n], f"{op_type} {n}")
            assert (jl.get(n) or None) == (plod[n] or None), n
    if not diff:
        return
    if _eager(case):
        jg, pg = _eager_grads(case, names, jenv)
    else:
        jg, pg, _ = _grads(op_type, inputs, lods, attrs, names, jenv, diff)
    for n in jg:
        assert np.isfinite(pg[n].numpy()).all(), n
        _check(jg[n], pg[n], f"{op_type} {n}")


def test_the_cases_cover_what_they_name():
    """Every forward op type of the slice but the file ops has a case;
    the cases hold an empty sequence (row_conv, lstmp), taps outside the
    map (grid_sampler), a modified-Huber point of each branch, and every
    label kind of the teacher-student loss."""
    assert {c[0] for c in CASES} == NEW_TYPES - FILE_OPS
    grid = [c for c in CASES if c[0] == "grid_sampler"][0][1]["Grid"]
    assert (np.abs(grid) > 1).any()
    mh = [c for c in CASES if c[0] == "modified_huber_loss"][0][1]
    prod = mh["X"] * (mh["Y"] * 2 - 1)
    assert (prod < -1).any() and (prod > 1).any() and \
        ((prod > -1) & (prod < 1)).any()


def test_misc_ops_are_registered():
    """The port registers 323 of the JAX package's 382 forward op types
    (297 before slice 26, whose 26 types are NEW_TYPES), each with a
    `_grad` op exactly where the JAX package has one: 19 of the 26."""
    def forward(ops):
        return {t for t in ops.types() if not ops.get(t).is_grad_op}
    assert len(forward(PT_OPS)) == 323 and len(forward(JAX_OPS)) == 382
    assert forward(PT_OPS) <= forward(JAX_OPS)
    assert NEW_TYPES <= forward(PT_OPS) and len(NEW_TYPES) == 26
    for t in NEW_TYPES:
        assert PT_OPS.has(t + "_grad") == JAX_OPS.has(t + "_grad"), t
    assert sum(PT_OPS.has(t + "_grad") for t in NEW_TYPES) == 19


# ---------------------------------------------------------------------------
# state, files and the dygraph layers
# ---------------------------------------------------------------------------

def _scope(fl):
    return fl.Scope() if fl is pt else fluid.core.Scope()


def _spectral_program(fl):
    fl.framework.unique_name.reset()
    main, start = fl.Program(), fl.Program()
    with fl.program_guard(main, start):
        w = fl.layers.data("w", [6, 3, 2], dtype="float32",
                           append_batch_size=False)
        out = fl.layers.spectral_norm(w, dim=1, power_iters=1)
    return main, start, out


def test_spectral_norm_advances_u_and_v_as_jax():
    """Two runs of a spectral_norm program: each advances U and V in the
    scope by one power iteration from the last, and both runs' outputs
    and vectors equal the JAX package's."""
    w = np.random.default_rng(1).standard_normal((6, 3, 2)).astype(
        np.float32)
    got = {}
    for fl in (fluid, pt):
        main, start, out = _spectral_program(fl)
        scope, exe = _scope(fl), fl.Executor(fl.CPUPlace())
        exe.run(start, scope=scope)
        names = [p.name for p in main.all_parameters()]
        if fl is fluid:
            state = {n: np.array(scope.find_var(n).get_tensor())
                     for n in names}
        else:
            load_params_from_numpy(scope, state, pt.CPUPlace())
        seen = []
        for _ in range(2):
            o, = exe.run(main, feed={"w": w}, fetch_list=[out], scope=scope)
            seen.append([np.asarray(o)] + [
                np.array(scope.find_var(n).get_tensor()) for n in names])
        got[fl is pt] = seen
    for j, p in zip(got[False], got[True]):
        for a, b in zip(j, p):
            np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL)
    # the vectors moved between the runs
    assert np.abs(got[True][0][1] - got[True][1][1]).max() > 1e-6


def _dygraph_layers(fl, w, nodes, edges):
    """SpectralNorm and TreeConv of `fl` called once: (outputs, the
    layers)."""
    sn = fl.dygraph.nn.SpectralNorm("sn", dim=0, power_iters=2)
    tc = fl.dygraph.nn.TreeConv("tc", output_size=2, num_filters=2,
                                max_depth=2)
    v = fl.dygraph.to_variable
    return (sn(v(w)).numpy(), tc(v(nodes), v(edges)).numpy()), (sn, tc)


def test_dygraph_spectral_norm_and_tree_conv_match_jax():
    """The port's layers, given the JAX layers' parameters after a first
    call (U and V included), compute what the JAX layers' second call
    does."""
    r = np.random.default_rng(3)
    w = r.standard_normal((4, 5)).astype(np.float32)
    nodes = r.standard_normal((1, 4, 3)).astype(np.float32)
    edges = np.array([[[0, 1], [0, 2], [1, 3]]], np.int32)
    with fluid.dygraph.guard(fluid.CPUPlace()):
        np.random.seed(0)
        _, (sn, tc) = _dygraph_layers(fluid, w, nodes, edges)
        init = [p.numpy() for layer in (sn, tc)
                for p in layer.state_dict().values()]
        v = fluid.dygraph.to_variable
        want = (sn(v(w)).numpy(), tc(v(nodes), v(edges)).numpy())
    with pt.dygraph.guard(pt.CPUPlace()):
        _, layers = _dygraph_layers(pt, w, nodes, edges)
        params = [p for layer in layers
                  for p in layer.state_dict().values()]
        assert [tuple(p.shape) for p in params] == [a.shape for a in init]
        for p, a in zip(params, init):
            p.set_value(a)
        v = pt.dygraph.to_variable
        got = (layers[0](v(w)).numpy(),
               layers[1](v(nodes), v(edges)).numpy())
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)


def _file_op(fl_ops, ctx_cls, op_type, inputs, outputs, attrs, lods,
             tensor):
    op, env = _op(op_type, inputs, outputs, attrs)
    env = {n: tensor(a) for n, a in env.items()}
    lod_env = dict(lods)
    args = (CPU, None, lod_env) if ctx_cls is PtContext else \
        (None, None, lod_env)
    fl_ops.get(op_type).lowering(ctx_cls(op, env, *args))
    return env, lod_env


def _jax_op(*a):
    return _file_op(JAX_OPS, JaxContext, *a, jnp.asarray)


def _pt_op(*a):
    return _file_op(PT_OPS, PtContext, *a,
                    lambda v: torch.from_numpy(np.array(v)))


def test_save_files_cross_packages(tmp_path):
    """save and save_combine write the same bytes in both packages (a
    LoD kept), and each package's load and load_combine read the
    other's files."""
    r = np.random.default_rng(5)
    x = r.standard_normal((3, 4)).astype(np.float32)
    # int32: without 64-bit types the JAX package holds an int64 as int32
    y = np.arange(5, dtype=np.int32)
    lods = {"x": [[0, 1, 3]]}
    paths = {k: str(tmp_path / k / "t") for k in ("jax", "pt")}
    _jax_op("save", {"X": x}, {}, {"file_path": paths["jax"]}, lods)
    _pt_op("save", {"X": x}, {}, {"file_path": paths["pt"]}, lods)
    data = [open(p, "rb").read() for p in paths.values()]
    assert data[0] == data[1] and len(data[0]) > x.nbytes
    for run, path in ((_pt_op, paths["jax"]), (_jax_op, paths["pt"])):
        env, lod = run("load", {}, {"Out": ["out"]}, {"file_path": path},
                       {})
        np.testing.assert_array_equal(np.asarray(env["out"]), x)
        assert lod["out"] == lods["x"]
    combined = {k: str(tmp_path / k / "c") for k in paths}
    ins = {"X": [x, y]}
    _jax_op("save_combine", ins, {}, {"file_path": combined["jax"]},
            {"x0": [[0, 2, 3]]})
    _pt_op("save_combine", ins, {}, {"file_path": combined["pt"]},
           {"x0": [[0, 2, 3]]})
    data = [open(p, "rb").read() for p in combined.values()]
    assert data[0] == data[1]
    for run, path in ((_pt_op, combined["jax"]), (_jax_op, combined["pt"])):
        env, lod = run("load_combine", {}, {"Out": ["x0", "x1"]},
                       {"file_path": path}, {})
        np.testing.assert_array_equal(np.asarray(env["x0"]), x)
        np.testing.assert_array_equal(np.asarray(env["x1"]), y)
        assert lod["x0"] == [[0, 2, 3]]
    env, _ = _pt_op("load", {}, {"Out": ["out"]},
                    {"file_path": paths["jax"], "load_as_fp16": True}, {})
    assert env["out"].dtype == torch.float16


def test_file_and_host_ops_keep_their_block_eager(tmp_path):
    """A block holding a file op, unique or a tree_conv is not captured:
    the capture rule names the op (the meta device refuses it)."""
    meta = torch.device("meta")
    for op_type, ins, outs, attrs in (
            ("save", {"X": np.ones((2, 2), np.float32)}, {},
             {"file_path": str(tmp_path / "s")}),
            ("load", {}, {"Out": ["out"]}, {"file_path": "x"}),
            ("unique", {"X": np.ones(3, np.int64)},
             {"Out": ["o"], "Index": ["i"]}, {}),
            ("tree_conv", {"NodesVector": np.ones((1, 2, 3), np.float32),
                           "EdgeSet": np.zeros((1, 1, 2), np.int32),
                           "Filter": np.ones((3, 3, 1, 1), np.float32)},
             {"Out": ["o"]}, {})):
        op, env = _op(op_type, ins, outs, attrs)
        env = {n: torch.empty(np.asarray(a).shape, device=meta)
               for n, a in env.items()}
        with pytest.raises(NotImplementedError):
            PT_OPS.get(op_type).lowering(PtContext(op, env, meta))
    assert not os.path.exists(tmp_path / "s")


# ---------------------------------------------------------------------------
# the builders
# ---------------------------------------------------------------------------

def _case(op_type, i=0):
    return [c for c in CASES if c[0] == op_type][i]


def _build(fl, name, tmp):
    """(main, startup, fetches, feed) of one builder in package `fl`;
    feed values are arrays or (array, lengths) for a LoD."""
    fl.framework.unique_name.reset()
    main, start = fl.Program(), fl.Program()
    L = fl.layers
    r = np.random.default_rng(11)

    def f32(*shape):
        return r.standard_normal(shape).astype(np.float32)

    with fl.program_guard(main, start):
        if name in ("lod_reset", "lod_append"):
            x = L.data("x", [3], dtype="float32", lod_level=1)
            if name == "lod_reset":
                outs = [L.lod_reset(x, target_lod=[0, 1, 4])]
            else:
                outs = [L.lod_append(x, [0, 1, 2, 4])]
            feed = {"x": (f32(4, 3), [2, 2])}
        elif name == "row_conv":
            x = L.data("x", [3], dtype="float32", lod_level=1)
            outs = [L.row_conv(x, 2, act="relu")]
            feed = {"x": (f32(6, 3), [4, 2])}
        elif name in ("unique", "unique_with_counts"):
            x = L.data("x", [6], dtype="int32", append_batch_size=False)
            outs = list(getattr(L, name)(x))
            feed = {"x": np.array([3, 1, 3, 0, 1, 3], np.int32)}
        elif name == "spectral_norm":
            w = L.data("w", [4, 6], dtype="float32", append_batch_size=False)
            outs = [L.spectral_norm(w, dim=1, power_iters=3)]
            feed = {"w": f32(4, 6)}
        elif name == "tree_conv":
            c = _case("tree_conv")[1]
            n = L.data("n", [5, 3], dtype="float32")
            e = L.data("e", [4, 2], dtype="int32")
            outs = [L.tree_conv(n, e, 2, num_filters=2)]
            feed = {"n": c["NodesVector"], "e": c["EdgeSet"]}
        elif name == "dynamic_lstmp":
            x = L.data("x", [16], dtype="float32", lod_level=1)
            outs = list(L.dynamic_lstmp(x, 16, 3))
            feed = {"x": (f32(7, 16) * 0.5, [3, 4])}
        elif name == "lstm":
            x = L.data("x", [4, 3], dtype="float32")
            h = L.data("h", [2, 2, 5], dtype="float32",
                       append_batch_size=False)
            c = L.data("c", [2, 2, 5], dtype="float32",
                       append_batch_size=False)
            outs = list(L.lstm(x, h, c, 4, 5, 2))
            feed = {"x": f32(2, 4, 3), "h": f32(2, 2, 5), "c": f32(2, 2, 5)}
        elif name == "affine_grid":
            t = L.data("t", [2, 3], dtype="float32")
            outs = [L.affine_grid(t, [2, 1, 3, 4])]
            feed = {"t": f32(2, 2, 3)}
        elif name == "grid_sampler":
            c = _case("grid_sampler")[1]
            x = L.data("x", [3, 5, 6], dtype="float32")
            g = L.data("g", [4, 3, 2], dtype="float32")
            outs = [L.grid_sampler(x, g)]
            feed = {"x": c["X"], "g": c["Grid"]}
        elif name == "center_loss":
            x = L.data("x", [3], dtype="float32")
            lab = L.data("lab", [1], dtype="int64")
            outs = [L.center_loss(x, lab, 4, 0.1)]
            feed = {"x": f32(5, 3),
                    "lab": np.array([[1], [3], [1], [0], [3]], np.int64)}
        elif name == "continuous_value_model":
            x = L.data("x", [6], dtype="float32")
            cvm = L.data("cvm", [2], dtype="float32")
            outs = [L.continuous_value_model(x, cvm)]
            feed = {"x": np.abs(f32(4, 6)), "cvm": f32(4, 2)}
        elif name == "pad_constant_like":
            x = L.data("x", [4, 5], dtype="float32")
            y = L.data("y", [3, 5], dtype="float32")
            outs = [L.pad_constant_like(x, y, 0.5)]
            feed = {"x": f32(3, 4, 5), "y": f32(3, 3, 5)}
        elif name == "similarity_focus":
            x = L.data("x", [3, 4, 5], dtype="float32")
            outs = [L.similarity_focus(x, 1, [0, 2])]
            feed = {"x": f32(2, 3, 4, 5)}
        elif name == "teacher_student_sigmoid_loss":
            c = _case("teacher_student_sigmoid_loss")[1]
            x = L.data("x", [1], dtype="float32")
            lab = L.data("lab", [1], dtype="float32")
            outs = [L.teacher_student_sigmoid_loss(x, lab)]
            feed = {"x": c["X"], "lab": c["Label"]}
        elif name == "unpool2d":
            c = _case("unpool")[1]
            x = L.data("x", [2, 2, 3], dtype="float32")
            i = L.data("i", [2, 2, 3], dtype="int32")
            outs = [L.unpool2d(x, i, [2, 2], [2, 2])]
            feed = {"x": c["X"], "i": c["Indices"]}
        elif name == "deformable_conv":
            c = _case("deformable_conv")[1]
            x = L.data("x", [4, 5, 5], dtype="float32")
            o = L.data("o", [36, 5, 5], dtype="float32")
            m = L.data("m", [18, 5, 5], dtype="float32")
            outs = [L.deformable_conv(x, o, m, 4, 3, padding=1, groups=2,
                                      deformable_groups=2)]
            feed = {"x": c["Input"], "o": c["Offset"], "m": c["Mask"]}
        elif name == "deformable_roi_pooling":
            c = _case("deformable_psroi_pooling")
            x = L.data("x", [8, 6, 7], dtype="float32")
            rois = L.data("rois", [4], dtype="float32", lod_level=1)
            t = L.data("t", [2, 2, 3], dtype="float32")
            outs = [L.deformable_roi_pooling(
                x, rois, t, spatial_scale=0.5, group_size=[2, 2],
                pooled_height=2, pooled_width=3, part_size=[2, 3],
                sample_per_part=2, position_sensitive=True)]
            feed = {"x": c[1]["Input"], "t": c[1]["Trans"],
                    "rois": (c[1]["ROIs"], [2, 1])}
        elif name == "adaptive_pool3d_index":
            x = L.data("x", [2, 5, 6, 7], dtype="float32")
            outs = list(L.adaptive_pool3d(x, [2, 3, 2], require_index=True))
            feed = {"x": f32(1, 2, 5, 6, 7)}
        else:   # load
            out = main.global_block().create_var(
                name="loaded", shape=[3, 4], dtype="float32")
            outs = [L.load(out, tmp)]
            feed = {}
    return main, start, outs, feed


BUILDERS = ["lod_reset", "lod_append", "row_conv", "unique",
            "unique_with_counts", "spectral_norm", "tree_conv",
            "dynamic_lstmp", "lstm", "affine_grid", "grid_sampler",
            "center_loss", "continuous_value_model", "pad_constant_like",
            "similarity_focus", "teacher_student_sigmoid_loss", "unpool2d",
            "deformable_conv", "deformable_roi_pooling",
            "adaptive_pool3d_index", "load"]


def _feed(fl, feed):
    return {k: fl.create_lod_tensor(v[0], [v[1]], fl.CPUPlace())
            if isinstance(v, tuple) else v for k, v in feed.items()}


def _run(fl, main, start, outs, feed, params=None):
    scope, exe = _scope(fl), fl.Executor(fl.CPUPlace())
    exe.run(start, scope=scope)
    if params is not None:
        load_params_from_numpy(scope, params, pt.CPUPlace())
    state = {p.name: np.array(scope.find_var(p.name).get_tensor())
             for p in main.all_parameters()}
    got = exe.run(main, feed=_feed(fl, feed), fetch_list=outs, scope=scope,
                  return_numpy=False)
    return got, state


@pytest.mark.parametrize("name", BUILDERS)
def test_builder_program_equals_jax(name, tmp_path):
    path = str(tmp_path / "t")
    if name == "load":
        from paddle_tpu_torch.io import _serialize_tensor
        with open(path, "wb") as f:
            _serialize_tensor(f, "t", np.arange(12, dtype=np.float32)
                              .reshape(3, 4))
    pm, ps, pouts, feed = _build(pt, name, path)
    jm, js, jouts, _ = _build(fluid, name, path)
    mine = pm.serialize_to_string()
    if name == "lstm":
        # the JAX package infers no shape for dense_lstm's outputs (its
        # vars keep shape ()); the port's are [B, T, H] and [L, B, H]
        _same_ops(pm, jm)
    else:
        assert _widen_desc(jm.serialize_to_string(), mine, ("",)) == mine
    assert ps.serialize_to_string() == js.serialize_to_string()
    jgot, state = _run(fluid, jm, js, jouts, feed)
    pgot, _ = _run(pt, pm, ps, pouts, feed, params=state)
    for j, p in zip(jgot, pgot):
        j, p = np.asarray(j), np.asarray(p)
        assert j.shape == p.shape, name
        np.testing.assert_allclose(p, j, rtol=TOL, atol=TOL, err_msg=name)
