"""The book's sentiment classifiers (understand_sentiment: convolution_net
and stacked_lstm_net) in the port, on LoD batches of word ids, against
the JAX package, and the LoD path of the engine, Executor and predictor.

* The training programs (Adagrad(0.002), sparse embedding) at the book's
  widths (vocab 5148, emb 128, hid 512, 3 stacked LSTMs) equal the JAX
  package's op for op: types, inputs, outputs, attrs, parameter names
  and shapes, startup ops. The JAX package's sequence layers leave
  their outputs without a width (shape ()), so an fc built on
  sequence_pool(dynamic_lstm(...)) gets a weight of width 1 there and
  sequence_conv a scalar bias (a program it cannot run); the reference
  infers those widths when it builds the op. The JAX program is built
  here with the widths set after each such op, as the reference's
  InferShape sets them (_jax_widths), and the port's layers set them
  themselves; test_jax_layers_leave_the_widths_out pins the JAX
  package's shapes without it.
* 3 Adagrad steps of each net at a tiny width (vocab 100, emb 16, hid
  32), dense and sparse embedding, from the JAX package's initial
  parameters: losses and every persistable within RTOL/ATOL 1e-5.
* The engine keys its plans on the feeds' LoD: the same shapes with
  other offsets build a new plan (and compute on their own offsets),
  the same LoD reuses one; a plan's CPU "replay" equals eager runs bit
  for bit, and its second and later runs make no new index tensor.
* Faults C.1 (layers.data takes lod_level and type, and the VarDesc
  records lod_level) and C.2 (Executor.run keeps a fed LoDTensor's
  offsets).
* The predictor on LoD feeds equals the port's Executor and the JAX
  package's predictor on the same saved model.
"""
import contextlib

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu.layer_helper as jax_layer_helper
from paddle_tpu.core.scope import Scope as JaxScope
from paddle_tpu.inference import (AnalysisConfig as JaxConfig,
                                  PaddleTensor as JaxTensor,
                                  create_paddle_predictor as jax_predictor)

import paddle_tpu_torch as pt
from paddle_tpu_torch.core import engine as E
from paddle_tpu_torch.inference import (AnalysisConfig, PaddleTensor,
                                        create_paddle_predictor)
from paddle_tpu_torch.io import load_params_from_numpy
from paddle_tpu_torch.models import sentiment
from torch_threads import one_torch_thread  # noqa: F401

RTOL = ATOL = 1e-5
STEPS = 3
TINY = {"input_dim": 100, "emb_dim": 16, "hid_dim": 32}
BOOK = {"input_dim": 5148, "emb_dim": 128, "hid_dim": 512}


@contextlib.contextmanager
def _jax_widths():
    """Set the width of each JAX sequence op's outputs after the op is
    appended, as the reference's InferShape does at build time."""
    orig = jax_layer_helper.LayerHelper.append_op

    def append_op(self, type, inputs=None, outputs=None, attrs=None,
                  infer_shape=True):
        op = orig(self, type, inputs, outputs, attrs, infer_shape)
        if type == "sequence_conv":
            outputs["Out"].shape = (-1, inputs["Filter"].shape[1])
        elif type == "lstm":
            for slot in ("Hidden", "Cell"):
                outputs[slot].shape = (-1, inputs["Weight"].shape[0])
        return op

    jax_layer_helper.LayerHelper.append_op = append_op
    try:
        yield
    finally:
        jax_layer_helper.LayerHelper.append_op = orig


def _book(fl, net, input_dim, emb_dim, hid_dim, is_sparse=True,
          lr=0.002):
    """The book's program, as a user of the package writes it."""
    L = fl.layers
    fl.framework.unique_name.reset()
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        data = L.data(name="words", shape=[1], dtype="int64", lod_level=1)
        label = L.data(name="label", shape=[1], dtype="int64")
        emb = L.embedding(input=data, size=[input_dim, emb_dim],
                          is_sparse=is_sparse)
        if net == "conv":
            convs = [fl.nets.sequence_conv_pool(
                input=emb, num_filters=hid_dim, filter_size=k, act="tanh",
                pool_type="sqrt") for k in (3, 4)]
            prediction = L.fc(input=convs, size=2, act="softmax")
        else:
            fc1 = L.fc(input=emb, size=hid_dim)
            lstm1, _ = L.dynamic_lstm(input=fc1, size=hid_dim)
            inputs = [fc1, lstm1]
            for i in range(2, 4):
                fc = L.fc(input=inputs, size=hid_dim)
                lstm, _ = L.dynamic_lstm(input=fc, size=hid_dim,
                                         is_reverse=(i % 2) == 0)
                inputs = [fc, lstm]
            prediction = L.fc(input=[L.sequence_pool(inputs[0], "max"),
                                     L.sequence_pool(inputs[1], "max")],
                              size=2, act="softmax")
        cost = L.mean(L.cross_entropy(input=prediction, label=label))
        acc = L.accuracy(input=prediction, label=label)
        fl.optimizer.Adagrad(learning_rate=lr).minimize(cost)
    return main, startup, cost, acc, prediction


def _port(net, input_dim, emb_dim, hid_dim, is_sparse=True):
    pt.framework.unique_name.reset()
    return sentiment.sentiment_train(net, input_dim=input_dim,
                                     emb_dim=emb_dim, hid_dim=hid_dim,
                                     is_sparse=is_sparse)


def _types(prog):
    return [op.type for op in prog.global_block().ops]


def _param_shapes(prog):
    return [(p.name, tuple(p.shape)) for p in prog.all_parameters()]


@pytest.mark.parametrize("net,n_ops", [("conv", 44), ("stacked_lstm", 70)])
def test_sentiment_program_matches_jax(net, n_ops):
    with _jax_widths():
        jmain, jstartup = _book(fluid, net, **BOOK)[:2]
    pmain, pstartup = _port(net, **BOOK)[:2]
    types = _types(pmain)
    assert types == _types(jmain) and len(types) == n_ops, types
    for j, p in zip(jmain.global_block().ops, pmain.global_block().ops):
        assert p._inputs == j._inputs and p._outputs == j._outputs, p.type
        assert p.all_attrs() == j.all_attrs(), p.type
    assert _param_shapes(pmain) == _param_shapes(jmain)
    assert _types(pstartup) == _types(jstartup)
    assert types.count("adagrad") == len(pmain.all_parameters())
    assert [op.attr("is_sparse") for op in pmain.global_block().ops
            if op.type == "lookup_table"] == [True]
    if net == "stacked_lstm":
        assert [op.attr("is_reverse") for op in pmain.global_block().ops
                if op.type == "lstm"] == [False, True, False]
        assert ("lstm_0.b_0", (1, 7 * 128)) in _param_shapes(pmain)


@pytest.mark.parametrize("net,wrong", [
    ("conv", {"sequence_conv_0.b_0": (), "sequence_conv_1.b_0": (),
              "fc_0.w_0": (1, 2), "fc_0.w_1": (1, 2)}),
    ("stacked_lstm", {"fc_1.w_1": (1, 512), "fc_2.w_1": (1, 512),
                      "fc_3.w_1": (1, 2)})])
def test_jax_layers_leave_the_widths_out(net, wrong):
    jshapes = dict(_param_shapes(_book(fluid, net, **BOOK)[0]))
    pshapes = dict(_param_shapes(_port(net, **BOOK)[0]))
    assert set(jshapes) == set(pshapes)
    assert {n: s for n, s in jshapes.items() if pshapes[n] != s} == wrong


def _batch(seed=0, B=6, lens=None, vocab=TINY["input_dim"]):
    rng = np.random.RandomState(seed)
    lens = list(lens) if lens is not None else \
        list(rng.randint(1, 9, B))
    ids = rng.randint(0, vocab, (sum(lens), 1)).astype(np.int64)
    labels = rng.randint(0, 2, (len(lens), 1)).astype(np.int64)
    return ids, [lens], labels


def _persistables(prog, scope):
    return {v.name: np.asarray(scope.find_var(v.name).get_tensor())
            for v in prog.global_block().vars.values()
            if v.persistable and scope.find_var(v.name) is not None}


def _jax_start(net, is_sparse, widths=TINY):
    with _jax_widths():
        jmain, jstartup, jcost = _book(fluid, net, is_sparse=is_sparse,
                                       **widths)[:3]
    jscope = JaxScope()
    jexe = fluid.Executor(fluid.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    params = {p.name: np.asarray(jscope.find_var(p.name).get_tensor())
              for p in jmain.all_parameters()}
    return jmain, jcost, jscope, jexe, params


def _port_start(net, is_sparse, params, widths=TINY):
    pmain, pstartup, pcost, pacc, pred = _port(net, is_sparse=is_sparse,
                                               **widths)
    pscope = pt.Scope()
    pexe = pt.Executor(pt.CPUPlace())
    pexe.run(pstartup, scope=pscope)
    load_params_from_numpy(pscope, params, pt.CPUPlace())
    return pmain, pcost, pacc, pred, pscope, pexe


@pytest.mark.parametrize("is_sparse", [True, False],
                         ids=["sparse", "dense"])
@pytest.mark.parametrize("net", ["conv", "stacked_lstm"])
def test_three_adagrad_steps_match_jax(net, is_sparse):
    ids, lens, labels = _batch(lens=[5, 1, 8, 0, 3, 7])
    jmain, jcost, jscope, jexe, params = _jax_start(net, is_sparse)
    pmain, pcost, _, _, pscope, pexe = _port_start(net, is_sparse, params)
    jl, pl = [], []
    for _ in range(STEPS):
        jl.append(float(np.asarray(jexe.run(
            jmain, feed={"words": fluid.create_lod_tensor(
                ids, lens, fluid.CPUPlace()), "label": labels},
            fetch_list=[jcost], scope=jscope)[0])))
        pl.append(float(pexe.run(
            pmain, feed={"words": pt.create_lod_tensor(
                ids, lens, pt.CPUPlace()), "label": labels},
            fetch_list=[pcost], scope=pscope)[0]))
    np.testing.assert_allclose(pl, jl, rtol=RTOL, atol=ATOL)
    assert all(np.isfinite(pl)) and len(set(pl)) == STEPS
    js, ps = _persistables(jmain, jscope), _persistables(pmain, pscope)
    assert set(js) == set(ps) and len(ps) >= 8
    for n in js:
        np.testing.assert_allclose(ps[n], js[n], rtol=RTOL, atol=ATOL,
                                   err_msg=n)


def _feed(ids, lens, labels):
    return {"words": pt.create_lod_tensor(ids, lens, pt.CPUPlace()),
            "label": labels}


def test_the_plan_is_keyed_by_the_lod():
    """Two batches of the same shapes and other offsets get two plans,
    each computing on its own offsets; the same LoD reuses its plan."""
    params = _jax_start("stacked_lstm", True)[4]
    pmain, pcost, _, pred, pscope, pexe = _port_start("stacked_lstm", True,
                                                      params)
    test = pt.io._prune_program(pmain, [pred.name])
    ids, lens_a, labels = _batch(lens=[4, 2, 6])
    lens_b = [[6, 4, 2]]
    key = E.Engine._key(test, [pred.name])
    outs = {}
    for lens in (lens_a, lens_b, lens_a):
        outs.setdefault(str(lens), []).append(np.asarray(pexe.run(
            test, feed=_feed(ids, lens, labels), fetch_list=[pred],
            scope=pscope)[0]))
    plans = pexe._engine._plans[key]
    assert len(plans) == 2
    assert [p.feed_lods["words"] for p in plans] == [[[0, 4, 6, 12]],
                                                     [[0, 6, 10, 12]]]
    a, b = outs[str(lens_a)], outs[str(lens_b)][0]
    np.testing.assert_array_equal(a[0], a[1])
    assert not np.allclose(a[0], b)
    # b equals a run of its own, with no plan kept
    ref = np.asarray(pexe.run(test, feed=_feed(ids, lens_b, labels),
                              fetch_list=[pred], scope=pscope,
                              use_program_cache=False)[0])
    np.testing.assert_array_equal(b, ref)


@pytest.mark.parametrize("net", ["conv", "stacked_lstm"])
def test_replay_is_bit_equal_to_eager_and_makes_no_index(net):
    """Runs with the plan cache (the first eager, the second captures:
    on the CPU a replay of the step on static tensors, the rest replay)
    against runs without it, from the same parameters: fetches and
    persistables equal bit for bit; the plan's index tensors are made at
    its first run and no later run makes one."""
    params = _jax_start(net, True)[4]
    ids, lens, labels = _batch(seed=3, lens=[3, 0, 5, 2])
    res, state = {}, {}
    for cached in (True, False):
        pmain, pcost, pacc, _, pscope, pexe = _port_start(net, True, params)
        res[cached], built = [], []
        for _ in range(4):
            res[cached].append([np.asarray(v) for v in pexe.run(
                pmain, feed=_feed(ids, lens, labels),
                fetch_list=[pcost, pacc], scope=pscope,
                use_program_cache=cached)])
            if cached:
                plan = pexe._engine._plans[E.Engine._key(
                    pmain, [pcost.name, pacc.name])][0]
                built.append(plan.host_tables.built)
        state[cached] = _persistables(pmain, pscope)
        if cached:
            c = pexe._engine.counters
            assert not pexe._engine.eager_reasons
            assert (c["captures"], c["replays"]) == (1, 3)
            assert built[0] > 0 and built == [built[0]] * 4
    for a, b in zip(res[True], res[False]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for n in state[True]:
        np.testing.assert_array_equal(state[True][n], state[False][n])


def test_data_takes_lod_level_and_type():
    """C.1: layers.data takes the reference's lod_level (recorded on the
    VarDesc) and type; the program serializes to the JAX package's
    bytes."""
    progs = {}
    for name, fl in (("jax", fluid), ("port", pt)):
        fl.framework.unique_name.reset()
        prog = fl.Program()
        with fl.program_guard(prog, fl.Program()):
            fl.layers.data("word", [1], dtype="int64", lod_level=1)
            fl.layers.data("lab", [1], dtype="int64", lod_level=0,
                           type=None)
        progs[name] = prog
    var = progs["port"].global_block().find_var("word")
    assert var.lod_level == 1 and var.to_proto().tensor.lod_level == 1
    assert progs["port"].serialize_to_string() == \
        progs["jax"].serialize_to_string()


def test_executor_keeps_a_fed_lodtensors_offsets():
    """C.2: a LoDTensor feed reaches the ops with its offsets (per
    sequence sums), and a fetch with a LoD comes back as a LoDTensor
    whose offsets are the feed's."""
    pt.framework.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", [2], dtype="float32", lod_level=1)
        pooled = pt.layers.sequence_pool(x, "sum")
        y = pt.layers.scale(x, 2.0)
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup)
    data = np.arange(10, dtype=np.float32).reshape(5, 2)
    t = pt.create_lod_tensor(data, [[2, 3]], pt.CPUPlace())
    got, scaled = exe.run(main, feed={"x": t}, fetch_list=[pooled, y],
                          return_numpy=False)
    np.testing.assert_array_equal(got.numpy(), [[2, 4], [18, 21]])
    assert isinstance(scaled, pt.LoDTensor)
    assert scaled.lod() == [[0, 2, 5]]
    np.testing.assert_array_equal(np.asarray(scaled), 2 * data)


def test_predictor_on_lod_feeds_matches_executor_and_jax(tmp_path):
    """The trained tiny stacked net saved by the port; the port's
    predictor (ZeroCopy and Run) on LoD feeds against the port's
    Executor on the test program and against the JAX package's
    predictor on the same directory; a warmed LoD signature captures
    nothing more."""
    params = _jax_start("stacked_lstm", True)[4]
    pmain, pcost, _, pred, pscope, pexe = _port_start("stacked_lstm", True,
                                                      params)
    ids, lens, labels = _batch(seed=5, lens=[7, 2, 4, 1])
    for _ in range(2):
        pexe.run(pmain, feed=_feed(ids, lens, labels), fetch_list=[pcost],
                 scope=pscope)
    test = pt.io._prune_program(pmain, [pred.name])
    ref = np.asarray(pexe.run(test, feed=_feed(ids, lens, labels),
                              fetch_list=[pred], scope=pscope)[0])
    model_dir = str(tmp_path / "sentiment")
    with pt.scope_guard(pscope):
        pt.io.save_inference_model(model_dir, ["words"], [pred], pexe,
                                   main_program=pmain)
    config = AnalysisConfig(model_dir)
    config.disable_gpu()
    predictor = create_paddle_predictor(config)
    it = predictor.get_input_tensor("words")
    it.copy_from_cpu(ids)
    it.set_lod(pt.create_lod_tensor(ids, lens, pt.CPUPlace()).lod())
    for _ in range(3):
        predictor.zero_copy_run()
        ot = predictor.get_output_tensor(predictor.get_output_names()[0])
        np.testing.assert_allclose(ot.copy_to_cpu(), ref, rtol=RTOL,
                                   atol=ATOL)
    c = predictor._engine.counters
    assert (c["captures"], c["replays"], c["eager_runs"]) == (1, 2, 1)
    pt_in = PaddleTensor(ids, "words")
    pt_in.lod = [[0, 7, 9, 13, 14]]
    out = predictor.run([pt_in])[0]
    np.testing.assert_allclose(out.data, ref, rtol=RTOL, atol=ATOL)
    assert predictor._engine.counters["captures"] == 1
    jconfig = JaxConfig(model_dir)
    jconfig.disable_gpu()
    jp = jax_predictor(jconfig)
    j_in = JaxTensor(ids, "words")
    j_in.lod = [[0, 7, 9, 13, 14]]
    np.testing.assert_allclose(np.asarray(jp.run([j_in])[0].data), ref,
                               rtol=RTOL, atol=ATOL)
