"""The LoD path and the sequence ops of the port against the JAX package.

* Each op of paddle_tpu_torch/ops/sequence.py through both packages'
  lowerings on the same numpy inputs and LoDs (a zero-length sequence in
  most, a two-level LoD for sequence_expand), and the gradient of each
  float input through both `<op>_grad` lowerings under one cotangent:
  float32 within TOL = 1e-5 (the ops gather and reduce the same
  float32 values; only the order of a sum may differ), output LoDs
  equal. sequence_pool's MAX is held on tie-free data; with ties each
  package splits a maximum's gradient evenly between the tied rows.
* sequence_erase, sequence_slice and edit_distance, which read values
  on the host, likewise (values and output LoD), and a program holding
  each runs eagerly with the op named in Engine.eager_reasons.
* The engine's LoD plumbing: its _LOD_SHARING_OPS equal the JAX
  engine's as a set, embedding -> fc -> fc carries the feed's LoD to a
  fetch as the JAX engine does, create_lod_tensor and
  create_random_int_lodtensor, and tensor files with LoD written by one
  package and read by the other.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as fluid
from paddle_tpu.core import engine as jax_engine
from paddle_tpu.core.registry import ExecContext as JaxContext
from paddle_tpu.core.registry import OPS as JAX_OPS
from paddle_tpu.core.scope import Scope as JaxScope

import paddle_tpu_torch as pt
from paddle_tpu_torch.core import engine as pt_engine
from paddle_tpu_torch.core.registry import ExecContext as PtContext
from paddle_tpu_torch.core.registry import OPS as PT_OPS

from test_torch_ops import _Op
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5
CPU = torch.device("cpu")
LOD = [[0, 2, 2, 5, 6]]          # four sequences, the second empty


def _rng(seed=0):
    return np.random.default_rng(seed)


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _names(slot, value):
    if isinstance(value, list):
        return [f"{slot.lower()}{i}" for i in range(len(value))]
    return [slot.lower()]


def _op(op_type, inputs, outputs, attrs):
    op = _Op(op_type, {}, [], attrs)
    op._inputs = {s: _names(s, v) for s, v in inputs.items()}
    op._outputs = {s: list(ns) for s, ns in outputs.items()}
    env = {}
    for s, v in inputs.items():
        env.update(zip(_names(s, v), v if isinstance(v, list) else [v]))
    return op, env


def _both(op_type, inputs, outputs, attrs, lods):
    """Run op_type in both packages with `lods` (input name -> LoD);
    returns (jax env, port env, jax lods, port lods)."""
    op, env = _op(op_type, inputs, outputs, attrs)
    jenv = {n: jnp.asarray(a) for n, a in env.items()}
    penv = {n: torch.from_numpy(np.array(a)) for n, a in env.items()}
    jl, pl = dict(lods), dict(lods)
    JAX_OPS.get(op_type).lowering(JaxContext(op, jenv, None, None, jl))
    PT_OPS.get(op_type).lowering(PtContext(op, penv, CPU, None, pl))
    return jenv, penv, jl, pl


def _close(j, p, msg=""):
    j, p = np.asarray(j), p.detach().numpy()
    assert j.shape == p.shape, (msg, j.shape, p.shape)
    if np.issubdtype(j.dtype, np.floating):
        np.testing.assert_allclose(p, j, rtol=TOL, atol=TOL, err_msg=msg)
    else:
        np.testing.assert_array_equal(p.astype(np.int64),
                                      j.astype(np.int64), err_msg=msg)


# (op, inputs, LoDs by input name, attrs, output slots, float slots to
# differentiate)
def _cases():
    r = _rng(3)
    x = _f32(r, 6, 3)
    cases = []
    for ptype in ("AVERAGE", "SUM", "SQRT", "MAX", "LAST", "FIRST"):
        cases.append(("sequence_pool", {"X": x}, {"x": LOD},
                      {"pooltype": ptype, "pad_value": 0.0},
                      ["Out", "MaxIndex"], ["X"]))
    cases += [
        ("sequence_pool", {"X": x}, {"x": LOD},
         {"pooltype": "MAX", "pad_value": 3.0}, ["Out", "MaxIndex"], ["X"]),
        ("sequence_pool", {"X": _f32(r, 6, 2, 2)}, {"x": LOD},
         {"pooltype": "SQRT", "pad_value": -1.0}, ["Out", "MaxIndex"],
         ["X"]),
        ("sequence_softmax", {"X": _f32(r, 6, 1)}, {"x": LOD}, {},
         ["Out"], ["X"]),
        ("sequence_softmax", {"X": _f32(r, 6)}, {"x": [[0, 4, 6]]}, {},
         ["Out"], ["X"]),
        ("sequence_reverse", {"X": x}, {"x": LOD}, {}, ["Y"], ["X"]),
        ("sequence_reshape", {"X": _f32(r, 6, 4)}, {"x": LOD},
         {"new_dim": 2}, ["Out"], ["X"]),
        ("sequence_reshape", {"X": _f32(r, 6, 4)}, {"x": [[0, 2, 6]]},
         {"new_dim": 8}, ["Out"], ["X"]),
        # X with a LoD, Y's two levels: level 0 repeats X's sequences
        ("sequence_expand", {"X": _f32(r, 3, 2), "Y": _f32(r, 4, 1)},
         {"x": [[0, 1, 3]], "y": [[0, 2, 3], [0, 1, 3, 4]]},
         {"ref_level": 0}, ["Out"], ["X"]),
        # X without one: each row repeated by Y's last level (one 0)
        ("sequence_expand", {"X": _f32(r, 3, 2), "Y": _f32(r, 4, 1)},
         {"y": [[0, 2, 3], [0, 1, 1, 4]]}, {"ref_level": -1}, ["Out"],
         ["X"]),
        ("sequence_expand_as", {"X": _f32(r, 3, 2), "Y": _f32(r, 5, 1)},
         {"y": [[0, 2, 2, 5]]}, {}, ["Out"], ["X"]),
        ("sequence_concat", {"X": [_f32(r, 5, 2), _f32(r, 4, 2)]},
         {"x0": [[0, 2, 2, 5]], "x1": [[0, 1, 3, 4]]}, {}, ["Out"], ["X"]),
        ("sequence_pad", {"X": x, "PadValue": np.array([0.5], np.float32)},
         {"x": LOD}, {"padded_length": -1}, ["Out", "Length"], ["X"]),
        ("sequence_pad", {"X": x, "PadValue": np.array([-2.0], np.float32)},
         {"x": LOD}, {"padded_length": 4}, ["Out", "Length"], ["X"]),
        ("sequence_unpad", {"X": _f32(r, 4, 3, 2),
                            "Length": np.array([2, 0, 3, 1], np.int64)},
         {"length": LOD}, {}, ["Out"], ["X"]),
        ("sequence_mask", {"X": np.array([2, 0, 3], np.int64)}, {},
         {"maxlen": 4, "out_dtype": "int64"}, ["Y"], []),
        ("sequence_mask", {"X": np.array([[2, 0], [3, 1]], np.int64)}, {},
         {"maxlen": -1, "out_dtype": "float32"}, ["Y"], []),
        ("sequence_conv", {"X": x, "Filter": _f32(r, 9, 4)}, {"x": LOD},
         {"contextLength": 3, "contextStart": -1, "contextStride": 1},
         ["Out"], ["X", "Filter"]),
        ("sequence_conv", {"X": x, "Filter": _f32(r, 12, 5)}, {"x": LOD},
         {"contextLength": 4, "contextStart": -2, "contextStride": 1},
         ["Out"], ["X", "Filter"]),
        ("sequence_enumerate", {"X": r.integers(0, 9, (6, 1))},
         {"x": LOD}, {"win_size": 3, "pad_value": 0}, ["Out"], []),
        ("im2sequence", {"X": _f32(r, 2, 2, 5, 5)}, {},
         {"kernels": [2, 3], "strides": [1, 2], "paddings": [1, 0, 0, 1]},
         ["Out"], ["X"]),
        ("sequence_scatter", {"X": _f32(r, 3, 5),
                              "Ids": np.array([[0], [4], [1], [1], [3],
                                               [2]], np.int64),
                              "Updates": _f32(r, 6, 1)},
         {"ids": [[0, 2, 5, 6]]}, {}, ["Out"], ["X", "Updates"]),
        # the value-dependent ops (read on the host)
        ("sequence_erase", {"X": np.array([[2], [5], [3], [5], [5], [7]],
                                          np.int64)},
         {"x": LOD}, {"tokens": [5, 9]}, ["Out"], []),
        ("sequence_erase", {"X": np.array([[1], [1], [4], [2], [1], [0]],
                                          np.int32)},
         {"x": [[0, 3, 6]]}, {"tokens": [1]}, ["Out"], []),
        ("sequence_slice", {"X": x, "Offset": np.array([[1], [0], [2], [0]],
                                                       np.int64),
                            "Length": np.array([[1], [0], [1], [1]],
                                               np.int64)},
         {"x": LOD}, {}, ["Out"], ["X"]),
        ("edit_distance", {"Hyps": np.array([[1], [2], [3], [4], [4], [6]],
                                            np.int64),
                           "Refs": np.array([[1], [3], [3], [4], [5], [6],
                                             [7]], np.int64)},
         {"hyps": [[0, 3, 3, 6]], "refs": [[0, 2, 4, 7]]},
         {"normalized": False}, ["Out", "SequenceNum"], []),
        ("edit_distance", {"Hyps": np.array([[1], [2], [3], [4], [4], [6]],
                                            np.int64),
                           "Refs": np.array([[2], [3], [4], [4]], np.int64)},
         {"hyps": [[0, 2, 6]], "refs": [[0, 1, 4]]},
         {"normalized": True}, ["Out", "SequenceNum"], []),
    ]
    return cases


_CASES = _cases()


@pytest.mark.parametrize("case", range(len(_CASES)), ids=[
    f"{c[0]}-{c[3].get('pooltype', i)}" for i, c in enumerate(_CASES)])
def test_sequence_op_and_its_grad_match_jax(case):
    op_type, inputs, lods, attrs, out_slots, diff = _CASES[case]
    outs = {s: [s.lower() + "_out"] for s in out_slots}
    jenv, penv, jl, pl = _both(op_type, inputs, outs, attrs, lods)
    for s in out_slots:
        if s == "MaxIndex":
            continue        # zeros in both (the JAX package's marker)
        n = outs[s][0]
        _close(jenv[n], penv[n], msg=f"{op_type}.{s}")
        assert pl.get(n) == jl.get(n), (op_type, s, pl.get(n), jl.get(n))
    if not diff:
        return
    # the gradient of every float input under one cotangent of Out
    main = "Y" if "Y" in out_slots and op_type != "sequence_mask" else "Out"
    y = np.asarray(jenv[outs[main][0]])
    ct = _f32(_rng(case), *y.shape)
    g_in = dict(inputs)
    for s in out_slots:
        if outs[s][0] in jenv:     # MaxIndex is set in MAX mode only
            g_in[s] = np.asarray(jenv[outs[s][0]])
    g_in[main + "@GRAD"] = ct
    g_outs = {s + "@GRAD": [n + "@g" for n in _names(s, inputs[s])]
              for s in diff}
    op, env = _op(op_type + "_grad", g_in, g_outs, attrs)
    for s in out_slots:
        if s != main:
            op._inputs[s + "@GRAD"] = [""]
    jenv = {n: jnp.asarray(a) for n, a in env.items()}
    penv = {n: torch.from_numpy(np.array(a)) for n, a in env.items()}
    JAX_OPS.get(op_type + "_grad").lowering(
        JaxContext(op, jenv, None, None, dict(lods)))
    PT_OPS.get(op_type + "_grad").lowering(
        PtContext(op, penv, CPU, None, dict(lods)))
    for names in g_outs.values():
        for n in names:
            _close(jenv[n], penv[n], msg=f"{op_type} {n}")


def test_sequence_pool_max_ties_split_the_gradient_evenly():
    """Ties: JAX's segment_max and torch's amax both give each of k tied
    maxima 1/k of the cotangent."""
    x = np.array([[1.0, 2.0], [1.0, 5.0], [0.5, 5.0], [4.0, 4.0]],
                 np.float32)
    lod = {"x": [[0, 3, 4]]}
    attrs = {"pooltype": "MAX", "pad_value": 0.0}
    outs = {"Out": ["out"], "MaxIndex": ["mi"]}
    jenv, penv, _, _ = _both("sequence_pool", {"X": x}, outs, attrs, lod)
    _close(jenv["out"], penv["out"])
    ct = np.ones((2, 2), np.float32)
    g_in = {"X": x, "Out": np.asarray(jenv["out"]),
            "MaxIndex": np.zeros((2, 2), np.int32), "Out@GRAD": ct}
    op, env = _op("sequence_pool_grad", g_in, {"X@GRAD": ["gx"]}, attrs)
    op._inputs["MaxIndex@GRAD"] = [""]
    jenv = {n: jnp.asarray(a) for n, a in env.items()}
    penv = {n: torch.from_numpy(np.array(a)) for n, a in env.items()}
    JAX_OPS.get("sequence_pool_grad").lowering(
        JaxContext(op, jenv, None, None, dict(lod)))
    PT_OPS.get("sequence_pool_grad").lowering(
        PtContext(op, penv, CPU, None, dict(lod)))
    want = np.array([[0.5, 0.0], [0.5, 0.5], [0.0, 0.5], [1.0, 1.0]],
                    np.float32)
    np.testing.assert_array_equal(penv["gx"].numpy(), want)
    np.testing.assert_array_equal(np.asarray(jenv["gx"]), want)


def test_sequence_op_without_a_lod_raises():
    op, env = _op("sequence_pool", {"X": np.zeros((3, 2), np.float32)},
                  {"Out": ["out"]}, {"pooltype": "SUM"})
    penv = {n: torch.from_numpy(a) for n, a in env.items()}
    with pytest.raises(ValueError, match="requires a LoD"):
        PT_OPS.get("sequence_pool").lowering(PtContext(op, penv, CPU))


# ---------------------------------------------------------------------------
# the engine's LoD plumbing, LoDTensor, tensor files
# ---------------------------------------------------------------------------

def test_lod_sharing_ops_equal_the_jax_engines():
    assert pt_engine._LOD_SHARING_OPS == jax_engine._LOD_SHARING_OPS


def _token_program(fl):
    fl.framework.unique_name.reset()
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        word = fl.layers.data("word", [1], dtype="int64", lod_level=1)
        emb = fl.layers.embedding(word, size=[20, 6])
        h = fl.layers.fc(emb, 5, act="relu")
        out = fl.layers.fc(h, 3)
    return main, startup, out


def test_share_lod_through_embedding_fc_fc():
    ids = _rng(1).integers(0, 20, (7, 1)).astype(np.int64)
    lens = [[3, 0, 4]]
    jmain, jstartup, jout = _token_program(fluid)
    jscope = JaxScope()
    jexe = fluid.Executor(fluid.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    params = {p.name: np.asarray(jscope.find_var(p.name).get_tensor())
              for p in jmain.all_parameters()}
    jres = jexe.run(jmain, feed={"word": fluid.create_lod_tensor(
        ids, lens, fluid.CPUPlace())}, fetch_list=[jout], scope=jscope)[0]
    pmain, pstartup, pout = _token_program(pt)
    assert pmain.global_block().find_var("word").lod_level == 1
    pscope = pt.Scope()
    pexe = pt.Executor(pt.CPUPlace())
    pexe.run(pstartup, scope=pscope)
    pt.io.load_params_from_numpy(pscope, params, pt.CPUPlace())
    feed = {"word": pt.create_lod_tensor(ids, lens, pt.CPUPlace())}
    for numpy in (True, False):
        pres = pexe.run(pmain, feed=feed, fetch_list=[pout], scope=pscope,
                        return_numpy=numpy)[0]
        assert isinstance(pres, pt.LoDTensor)
        assert pres.lod() == jres.lod() == [[0, 3, 3, 7]]
        np.testing.assert_allclose(np.asarray(pres), np.asarray(jres),
                                   rtol=TOL, atol=TOL)


def test_create_lod_tensor_matches_jax():
    data = np.arange(12, dtype=np.float32).reshape(6, 2)
    lens = [[2, 1], [1, 3, 2]]
    j = fluid.create_lod_tensor(data, lens, fluid.CPUPlace())
    p = pt.create_lod_tensor(data, lens, pt.CPUPlace())
    assert p.lod() == j.lod() == [[0, 2, 3], [0, 1, 4, 6]]
    assert p.recursive_sequence_lengths() == j.recursive_sequence_lengths()
    assert p.has_valid_recursive_sequence_lengths()
    np.testing.assert_array_equal(np.asarray(p), np.asarray(j))
    p.set_lod([[0, 2, 7]])
    assert not p.has_valid_recursive_sequence_lengths()
    p.set_recursive_sequence_lengths([[4, 2]])
    assert p.lod() == [[0, 4, 6]] and p.has_valid_recursive_sequence_lengths()
    with pytest.raises(ValueError, match="partition"):
        pt.create_lod_tensor(data, [[2, 2]], pt.CPUPlace())
    np.random.seed(5)
    r = pt.create_random_int_lodtensor([[2, 3]], [1], pt.CPUPlace(), 0, 9)
    a = np.asarray(r)
    assert a.shape == (5, 1) and a.dtype == np.int64
    assert a.min() >= 0 and a.max() <= 9 and r.lod() == [[0, 2, 5]]


def test_tuple_feed_refused_as_by_the_jax_executor():
    main, startup, out = _token_program(pt)
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    with pytest.raises(TypeError, match="LoDTensor"):
        exe.run(main, feed={"word": (np.zeros((3, 1), np.int64),
                                     [[0, 3]])}, fetch_list=[out],
                scope=scope)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_lod_tensor_files_cross_packages(tmp_path, writer):
    """A persistable holding a LoDTensor with a two-level LoD, written by
    one package's save_vars and read by the other's load_vars."""
    data = _f32(_rng(2), 5, 3)
    lod = [[0, 1, 3], [0, 2, 2, 5]]
    out = {}
    for name, fl in (("jax", fluid), ("port", pt)):
        fl.framework.unique_name.reset()
        prog = fl.Program()
        with fl.program_guard(prog, fl.Program()):
            v = prog.global_block().create_var(
                name="seq_state", shape=[-1, 3], dtype="float32",
                persistable=True, lod_level=2)
        out[name] = (fl, prog, v)
    wfl, wprog, wv = out[writer]
    rfl, rprog, rv = out["port" if writer == "jax" else "jax"]
    wscope = JaxScope() if writer == "jax" else pt.Scope()
    t = wfl.create_lod_tensor(data, [[1, 2], [2, 0, 3]], wfl.CPUPlace())
    assert t.lod() == lod
    wscope.var("seq_state").get_tensor().set(np.asarray(t), wfl.CPUPlace())
    wscope.var("seq_state").get_tensor().set_lod(lod)
    with wfl.scope_guard(wscope):
        wfl.io.save_vars(wfl.Executor(wfl.CPUPlace()), str(tmp_path),
                         wprog, vars=[wv])
    rscope = JaxScope() if writer == "port" else pt.Scope()
    with rfl.scope_guard(rscope):
        rfl.io.load_vars(rfl.Executor(rfl.CPUPlace()), str(tmp_path),
                         rprog, vars=[rv])
    got = rscope.find_var("seq_state").get_tensor()
    assert got.lod() == lod
    np.testing.assert_array_equal(np.asarray(got), data)


def _value_dependent_program(op_type):
    pt.framework.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    L = pt.layers
    with pt.program_guard(main, startup):
        ids = L.data("ids", [1], dtype="int64", lod_level=1)
        if op_type == "sequence_erase":
            out = L.sequence_erase(ids, tokens=[5])
        elif op_type == "sequence_slice":
            off = L.data("off", [1], dtype="int64")
            ln = L.data("len", [1], dtype="int64")
            out = L.sequence_slice(ids, off, ln)
        else:
            out, _ = L.edit_distance(ids, ids, normalized=False)
    return main, out


@pytest.mark.parametrize("op_type", ["sequence_erase", "sequence_slice",
                                     "edit_distance"])
def test_value_dependent_ops_keep_their_block_eager(op_type):
    main, out = _value_dependent_program(op_type)
    feed = {"ids": pt.create_lod_tensor(
        np.array([[2], [5], [3], [5], [7]], np.int64), [[2, 3]],
        pt.CPUPlace()),
        "off": np.array([[1], [0]], np.int64),
        "len": np.array([[1], [2]], np.int64)}
    exe = pt.Executor(pt.CPUPlace())
    got = [exe.run(main, feed=feed, fetch_list=[out], return_numpy=False)[0]
           for _ in range(3)]
    c = exe._engine.counters
    assert (c["captures"], c["replays"], c["eager_runs"]) == (0, 0, 3)
    assert list(exe._engine.eager_reasons.values()) == [op_type]
    want = {"sequence_erase": ([[2], [3], [7]], [[0, 1, 3]]),
            "sequence_slice": ([[5], [3], [5]], [[0, 1, 3]]),
            "edit_distance": ([[0.0], [0.0]], None)}[op_type]
    for g in got:
        np.testing.assert_array_equal(np.asarray(g), np.array(want[0]))
        if want[1] is not None:
            assert g.lod() == want[1]
