"""Persistence across the two packages: the port's ProgramDesc codec and
io.py against the JAX package's protobuf messages and io.py.

* The codec writes the bytes protobuf writes, for random attribute
  values of every type and for a whole LeNet program pruned for
  inference (JAX: stamp_program(pruned.to_proto()).SerializeToString()),
  and reads them back to the same bytes.
* Checkpoints both ways (save_persistables in one package,
  load_persistables in the other): equal tensors, byte-equal files, and
  the same next training step (loss within 1e-5: float32 sums in another
  order).
* Inference models both ways: equal outputs within 1e-5.
* A tensor file or __model__ whose metadata is not JSON (a pickle) is
  refused.
"""
import json
import os
import pickle
import struct

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.core.op_version import stamp_program as jax_stamp
from paddle_tpu.core.scope import Scope as JaxScope
from paddle_tpu.models import lenet as jax_lenet
from paddle_tpu.proto import framework_pb2 as fpb

import paddle_tpu_torch as pt
from paddle_tpu_torch.core.op_version import (VERSION_OP, OpVersionError,
                                              check_program, stamp_program)
from paddle_tpu_torch.io import load_params_from_numpy
from paddle_tpu_torch.models import lenet as pt_lenet
from paddle_tpu_torch.proto import framework_desc as fd
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5
B, LR = 8, 0.05


def _feed(seed=0):
    r = np.random.RandomState(seed)
    return {"img": r.rand(B, 1, 28, 28).astype(np.float32),
            "label": r.randint(0, 10, (B, 1)).astype(np.int64)}


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------

def _random_attr(r, i):
    ints = [int(x) for x in r.integers(-2 ** 62, 2 ** 62, r.integers(0, 4))]
    floats = [float(x) for x in r.standard_normal(r.integers(0, 4)) * 1e3]
    kw = dict(name=f"a{i}", type=int(r.integers(0, 13)),
              i=int(r.integers(-2 ** 63, 2 ** 63 - 1)),
              f=float(r.choice([0.0, -0.0, 1e39, r.standard_normal()])),
              s=str(r.choice(["", "x", "héllo"])), ints=ints,
              floats=floats, strings=["", "ab"][:int(r.integers(0, 3))],
              b=bool(r.integers(0, 2)),
              bools=[bool(x) for x in r.integers(0, 2, r.integers(0, 3))],
              block_idx=int(r.integers(-2 ** 31, 2 ** 31)),
              block_idxs=[int(x) for x in r.integers(-5, 5,
                                                     r.integers(0, 3))],
              d=float(r.choice([0.0, -0.0, r.standard_normal()])))
    return fpb.Attr(**kw), fd.Attr(**kw)


def test_codec_writes_and_reads_protobuf_bytes():
    r = np.random.default_rng(0)
    for i in range(200):
        want, mine = _random_attr(r, i)
        data = want.SerializeToString()
        assert mine.SerializeToString() == data, i
        assert fd.Attr.FromString(data).SerializeToString() == data, i
    var = fpb.VarDesc(name="w", kind=1, persistable=True)
    var.tensor.data_type = 0           # set, all defaults: still written
    blk = fpb.BlockDesc(idx=0, parent_idx=-1, forward_block_idx=-1,
                        vars=[var])
    prog = fpb.ProgramDesc(blocks=[blk], version=1)
    mine = fd.ProgramDesc(version=1, blocks=[fd.BlockDesc(
        parent_idx=-1, forward_block_idx=-1,
        vars=[fd.VarDesc(name="w", kind=1, persistable=True,
                         tensor=fd.TensorDesc())])])
    assert mine.SerializeToString() == prog.SerializeToString()
    assert fd.ProgramDesc.FromString(prog.SerializeToString()) == mine


def test_codec_reads_unpacked_scalars_and_skips_unknown_fields():
    # ints (field 6) written unpacked, then an unknown field 20 (varint)
    data = bytes([0x30, 0x02, 0x30, 0x03, 0xA0, 0x01, 0x07]) + \
        fpb.Attr(name="n").SerializeToString()
    assert fd.Attr.FromString(data) == fd.Attr(name="n", ints=[1, -2])
    with pytest.raises(ValueError):
        fd.Attr.FromString(b"\x0a\x05ab")          # truncated string


def _build(fl, mod, with_accuracy=True):
    """The LeNet SGD program; without accuracy, its prediction, mean
    cross-entropy and SGD only."""
    fl.framework.unique_name.reset()
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        if with_accuracy:
            cost, acc, _ = mod.lenet_train()
        else:
            img = fl.layers.data("img", [1, 28, 28], dtype="float32")
            label = fl.layers.data("label", [1], dtype="int64")
            pred = mod.lenet(img)
            cost = fl.layers.mean(fl.layers.cross_entropy(pred, label))
            acc = None
        fl.optimizer.SGD(learning_rate=LR).minimize(cost)
    pred = [op for op in main.global_block().ops
            if op.type == "softmax"][0].output("Out")[0]
    return main, startup, cost, acc, pred


def test_pruned_lenet_serializes_to_the_jax_bytes():
    """The accuracy layer is left out: the JAX package's shape inference
    runs without 64-bit types and declares top_k's int64 indices int32,
    where the port declares int64 (so that var's desc differs)."""
    jmain, _, _, _, jpred = _build(fluid, jax_lenet, with_accuracy=False)
    pmain, _, _, _, ppred = _build(pt, pt_lenet, with_accuracy=False)
    jpruned = fluid.io._prune_program(jmain, ["img"], [jpred])
    ppruned = pt.io._prune_program(pmain, [ppred])
    want = jax_stamp(jpruned.to_proto()).SerializeToString()
    got = stamp_program(ppruned.to_proto()).SerializeToString()
    assert got == want
    # the whole training program too
    assert pmain.serialize_to_string() == jmain.serialize_to_string()
    # the carrier op is the JAX package's; check_program strips it, and
    # what is left parses to a program that writes the same bytes
    proto = fd.ProgramDesc.FromString(want)
    assert proto.blocks[0].ops[-1].type == VERSION_OP
    again = pt.Program.from_proto(check_program(proto))
    assert again.serialize_to_string() == ppruned.serialize_to_string()


def test_full_lenet_desc_round_trips_through_the_codec():
    jmain, _, _, _, _ = _build(fluid, jax_lenet)
    data = jmain.serialize_to_string()
    prog = pt.Program.parse_from_string(data)
    assert prog.serialize_to_string() == data
    assert [op.type for op in prog.global_block().ops] == \
        [op.type for op in jmain.global_block().ops]


def test_newer_op_version_is_refused():
    proto = stamp_program(fd.ProgramDesc(blocks=[fd.BlockDesc(
        ops=[fd.OpDesc(type="mean")])]))
    proto.blocks[0].ops[-1].attrs[0].i = 2
    with pytest.raises(OpVersionError, match="mean"):
        check_program(proto)


# ---------------------------------------------------------------------------
# checkpoints both ways
# ---------------------------------------------------------------------------

def _persistables(prog, scope):
    return {v.name: np.asarray(scope.find_var(v.name).get_tensor())
            for v in prog.global_block().vars.values()
            if v.persistable and scope.find_var(v.name) is not None}


def _setup():
    """Both programs, a JAX scope after its startup and one step, and a
    port scope holding the same initial values."""
    jmain, jstartup, jcost, _, jpred = _build(fluid, jax_lenet)
    pmain, pstartup, pcost, _, ppred = _build(pt, pt_lenet)
    jscope, pscope = JaxScope(), pt.Scope()
    jexe, pexe = fluid.Executor(fluid.CPUPlace()), pt.Executor(pt.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    jexe.run(jmain, feed=_feed(1), fetch_list=[jcost], scope=jscope)
    return (jmain, jexe, jscope, jcost, jpred), \
        (pmain, pexe, pscope, pcost, ppred)


@pytest.mark.parametrize("filename", [None, "params"],
                         ids=["file_per_var", "one_file"])
def test_checkpoints_cross_both_ways(tmp_path, filename):
    (jmain, jexe, jscope, jcost, _), (pmain, pexe, pscope, pcost, _) = \
        _setup()
    want = _persistables(jmain, jscope)
    assert len(want) == 7
    # JAX -> port
    with fluid.scope_guard(jscope):
        fluid.io.save_persistables(jexe, str(tmp_path / "jax"), jmain,
                                   filename=filename)
    with pt.scope_guard(pscope):
        pt.io.load_persistables(pexe, str(tmp_path / "jax"), pmain,
                                filename=filename)
    got = _persistables(pmain, pscope)
    assert sorted(got) == sorted(want)
    for n in want:
        assert got[n].dtype == want[n].dtype and \
            np.array_equal(got[n], want[n]), n
    # port -> JAX, into a fresh scope; the files are the same bytes
    with pt.scope_guard(pscope):
        pt.io.save_persistables(pexe, str(tmp_path / "pt"), pmain,
                                filename=filename)
    for name in os.listdir(tmp_path / "jax"):
        assert (tmp_path / "pt" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    jscope2 = JaxScope()
    with fluid.scope_guard(jscope2):
        fluid.io.load_persistables(jexe, str(tmp_path / "pt"), jmain,
                                   filename=filename)
    for n in want:
        assert np.array_equal(np.asarray(jscope2.find_var(n).get_tensor()),
                              want[n]), n
    # the next step from each restored scope
    feed = _feed(2)
    jl = [float(np.asarray(jexe.run(jmain, feed=feed, fetch_list=[jcost],
                                    scope=s)[0])) for s in (jscope, jscope2)]
    pl = float(pexe.run(pmain, feed=feed, fetch_list=[pcost],
                        scope=pscope)[0])
    assert jl[0] == jl[1]
    assert abs(pl - jl[0]) <= TOL * max(1.0, abs(jl[0]))


def test_inference_models_cross_both_ways(tmp_path):
    (jmain, jexe, jscope, _, jpred), (pmain, pexe, pscope, _, ppred) = \
        _setup()
    load_params_from_numpy(pscope, _persistables(jmain, jscope),
                           pt.CPUPlace())
    img = _feed(3)["img"]
    with fluid.scope_guard(jscope):
        fluid.io.save_inference_model(str(tmp_path / "jax"), ["img"],
                                      [jpred], jexe, jmain)
    with pt.scope_guard(pscope):
        pt.io.save_inference_model(str(tmp_path / "pt"), ["img"], [ppred],
                                   pexe, pmain)
    outs = {}
    for side in ("jax", "pt"):
        ps, js = pt.Scope(), JaxScope()
        with pt.scope_guard(ps):
            prog, feeds, fetches = pt.io.load_inference_model(
                str(tmp_path / side), pexe)
            outs[("pt", side)], = pexe.run(prog, feed={feeds[0]: img},
                                           fetch_list=fetches, scope=ps)
        with fluid.scope_guard(js):
            prog, feeds, fetches = fluid.io.load_inference_model(
                str(tmp_path / side), jexe)
            outs[("jax", side)] = np.asarray(jexe.run(
                prog, feed={feeds[0]: img}, fetch_list=fetches,
                scope=js)[0])
        assert feeds == ["img"]
    live, = pexe.run(pmain.clone(for_test=True), feed=_feed(3),
                     fetch_list=[ppred], scope=pscope)
    assert live.shape == (B, 10)
    for key, out in outs.items():
        np.testing.assert_allclose(out, live, rtol=TOL, atol=TOL,
                                   err_msg=str(key))


# ---------------------------------------------------------------------------
# untrusted files
# ---------------------------------------------------------------------------

def test_pickled_files_are_refused(tmp_path):
    meta = pickle.dumps({"name": "w", "lod": []})
    with open(tmp_path / "w", "wb") as f:
        f.write(b"PTCK" + struct.pack("<II", len(meta), 0) + meta)
    prog = pt.Program()
    prog.global_block().create_var(name="w", shape=[1], persistable=True)
    with pytest.raises(ValueError, match="non-JSON"):
        pt.io.load_persistables(pt.Executor(pt.CPUPlace()), str(tmp_path),
                                prog)
    model = tmp_path / "m"
    model.mkdir()
    with open(model / "__model__", "wb") as f:
        f.write(struct.pack("<II", 2, len(meta)) + meta)
    with pytest.raises(ValueError, match="non-JSON"):
        pt.io.load_inference_model(str(model), pt.Executor(pt.CPUPlace()))
    # and a JSON file that is not a tensor file is refused too
    with open(tmp_path / "w", "wb") as f:
        f.write(b"XXXX" + json.dumps({}).encode())
    with pytest.raises(ValueError, match="magic"):
        pt.io.load_persistables(pt.Executor(pt.CPUPlace()), str(tmp_path),
                                prog)
