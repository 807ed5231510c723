"""CRNN-CTC (chip_smoke.crnn_ctc: PaddleCV's ocr_recognition model) in the
port against the JAX package, at widths (4, 4, 8, 8), 16x64 grayscale
images (T = 8 columns), GRU width 8, 7 classes (blank 7) and B=3, on
labels of 1, 2 and 5 characters, the first a repeat ("aa"); the card
runs the published sizes (48x512, 95 classes, B=32). The empty label
is the op sweep's case (family_cases.nlp_cases).

* The training program (Momentum, L2Decay on every parameter, the GRU
  biases at learning rate 2), the one with ctc_greedy_decoder and the
  EditDistance evaluator, and the decode program built with each
  package's layers: op for op the same, the parameters' names and
  shapes too. (The JAX builders of im2sequence and dynamic_gru leave
  their outputs' widths out, so the fcs after them would take a width
  of 1: the test sets them, _jax_widths, as the reference's InferShape
  does.)
* Three Momentum steps from the JAX package's initial parameters
  (carried by load_params_from_numpy): the losses within LOSS_RTOL =
  1e-5 relative, fc_out within ATOL = 1e-5.
* The decoded rows and edit distances equal the JAX package's, exactly:
  the JAX ctc_align and edit_distance lowerings run on the JAX fc_out
  with the images' LoD (the JAX top_k drops the LoD, so its decoder
  would read the batch as one sequence: ROADMAP, C.1).
* The decode program through save_inference_model and AnalysisPredictor
  on the CPU: its rows and LoD equal Executor.run's.
* The decoder-free training block captures: no eager reason, the second
  run of its plan captures, the later ones replay on the CPU, bit-equal
  to eager runs; the block with the evaluator stays eager (ctc_align).
"""
import contextlib
import tempfile

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as fluid
import paddle_tpu.layer_helper as jax_layer_helper
from paddle_tpu.core.registry import ExecContext as JaxContext
from paddle_tpu.core.registry import OPS as JAX_OPS

import paddle_tpu_torch as pt
from paddle_tpu_torch.inference import AnalysisConfig, create_paddle_predictor
from paddle_tpu_torch.io import load_params_from_numpy

import chip_smoke as cs
from test_torch_book import _same_ops
from test_torch_one_stage_detection import jax_start_state
from test_torch_sequence import _op
from torch_threads import one_torch_thread  # noqa: F401

SIZE = {"image": (16, 64), "num_classes": 7, "rnn_hidden": 8,
        "widths": (4, 4, 8, 8)}
B, T = 3, 8
LOSS_RTOL = 1e-5
ATOL = 1e-5
LABELS = ([2, 2], [5], [0, 3, 1, 6, 4])


def _feed(seed, fl):
    f = cs.ocr_batch(torch, pt, seed, pt.CPUPlace(), B=B,
                     image=SIZE["image"], num_classes=SIZE["num_classes"])
    ids = np.concatenate(LABELS).reshape(-1, 1).astype(np.int32)
    lens = [[len(x) for x in LABELS]]
    if fl is fluid:
        return {"pixel": f["pixel"].numpy(),
                "label": fluid.create_lod_tensor(ids, lens,
                                                 fluid.CPUPlace())}
    return {"pixel": f["pixel"],
            "label": pt.create_lod_tensor(ids, lens, pt.CPUPlace())}


@contextlib.contextmanager
def _jax_widths():
    """Set the width of the JAX im2sequence's and gru's outputs after the
    op is appended, as the reference's InferShape does at build time
    (the JAX builders leave it out; the fcs after them take it)."""
    orig = jax_layer_helper.LayerHelper.append_op

    def append_op(self, type, inputs=None, outputs=None, attrs=None,
                  infer_shape=True):
        op = orig(self, type, inputs, outputs, attrs, infer_shape)
        if type == "im2sequence":
            x, k = inputs["X"], attrs["kernels"]
            outputs["Out"].shape = (-1, x.shape[1] * k[0] * k[1])
        elif type == "gru":
            outputs["Hidden"].shape = (-1, inputs["Weight"].shape[0])
        return op

    jax_layer_helper.LayerHelper.append_op = append_op
    try:
        yield
    finally:
        jax_layer_helper.LayerHelper.append_op = orig


def _train(fl, evaluate=False):
    fl.framework.unique_name.reset()
    with _jax_widths():
        main, start, outs = cs.crnn_ctc_train(fl, evaluate=evaluate, **SIZE)
    main.random_seed = start.random_seed = 5
    return main, start, outs


def _decode(fl):
    fl.framework.unique_name.reset()
    with _jax_widths():
        return cs.crnn_ctc_decode(fl, **SIZE)


def _jax_decode(fc_out, labels):
    """The JAX lowerings of top_k's argmax, ctc_align and edit_distance
    on the images' LoD: (rows, LoD, distances)."""
    lod = [list(range(0, B * T + 1, T))]
    ids = np.argmax(fc_out, 1).reshape(-1, 1).astype(np.int64)
    op, env = _op("ctc_align", {"Input": ids}, {"Output": ["o"]},
                  {"blank": SIZE["num_classes"]})
    jl = {"input": lod}
    jenv = {n: jnp.asarray(a) for n, a in env.items()}
    JAX_OPS.get("ctc_align").lowering(JaxContext(op, jenv, None, None, jl))
    rows, rlod = np.asarray(jenv["o"]), jl["o"]
    ref = np.concatenate(labels).reshape(-1, 1).astype(np.int64)
    op, env = _op("edit_distance", {"Hyps": rows.astype(np.int64),
                                    "Refs": ref},
                  {"Out": ["d"], "SequenceNum": ["n"]},
                  {"normalized": True})
    jl = {"hyps": rlod, "refs": [np.cumsum([0] + [len(x) for x in labels])
                                 .tolist()]}
    jenv = {n: jnp.asarray(a) for n, a in env.items()}
    JAX_OPS.get("edit_distance").lowering(JaxContext(op, jenv, None, None,
                                                     jl))
    return rows, rlod, np.asarray(jenv["d"])


@pytest.fixture(scope="module")
def runs():
    jmain, jstart, jouts = _train(fluid, evaluate=True)
    pmain, pstart, pouts = _train(pt, evaluate=True)
    jscope, jexe, state = jax_start_state(jstart, jmain)
    pscope, pexe = pt.Scope(), pt.Executor(pt.CPUPlace())
    pexe.run(pstart, scope=pscope)
    load_params_from_numpy(pscope, state, pt.CPUPlace())
    steps = []
    for s in range(3):
        j = jexe.run(jmain, feed=_feed(s, fluid), scope=jscope,
                     fetch_list=[jouts["loss"], jouts["fc_out"]])
        p = pexe.run(pmain, feed=_feed(s, pt), scope=pscope,
                     fetch_list=[pouts["loss"], pouts["fc_out"],
                                 pouts["decoded"]], return_numpy=False)
        steps.append(([np.asarray(v) for v in j], p))
    return {"steps": steps,
            "port": (pexe, pscope, pmain, pouts),
            "state": state}


def test_crnn_ctc_programs_equal_the_jax_programs():
    for evaluate in (False, True):
        jmain, jstart, _ = _train(fluid, evaluate)
        pmain, pstart, _ = _train(pt, evaluate)
        _same_ops(pmain, jmain)
        _same_ops(pstart, jstart)
        types = [op.type for op in pmain.global_block().ops]
        assert types.count("conv2d") == 8 and types.count("gru") == 2
        assert types.count("momentum") == len(pmain.all_parameters()) - \
            sum(1 for p in pmain.all_parameters() if not p.trainable)
        assert ("ctc_align" in types) == evaluate
    jd, _, _ = _decode(fluid)
    pd, _, outs = _decode(pt)
    _same_ops(pd, jd)
    assert [op.type for op in pd.global_block().ops][-2:] == \
        ["top_k", "ctc_align"]


def test_three_momentum_steps_match_jax(runs):
    for i, (j, p) in enumerate(runs["steps"]):
        jl = float(j[0].reshape(-1)[0])
        pl = float(np.asarray(p[0]).reshape(-1)[0])
        assert abs(pl - jl) <= LOSS_RTOL * abs(jl), (i, pl, jl)
        np.testing.assert_allclose(np.asarray(p[1]), j[1], rtol=0,
                                   atol=ATOL, err_msg=f"step {i}")
    losses = [float(np.asarray(p[0]).reshape(-1)[0])
              for _, p in runs["steps"]]
    assert all(np.isfinite(losses))


def test_decoded_rows_and_edit_distances_equal_jax(runs):
    pexe, pscope, pmain, pouts = runs["port"]
    for i, (j, p) in enumerate(runs["steps"]):
        rows, lod, dist = _jax_decode(j[1], LABELS)
        got = p[2]
        np.testing.assert_array_equal(np.asarray(got), rows,
                                      err_msg=f"step {i}")
        assert got.lod() == lod
    # the evaluator's distances: fetched from a forward of the trained
    # state, against the JAX edit_distance on the port's own decode
    ed = pouts["evaluator"]
    feed = _feed(0, pt)
    d = [op for op in pmain.global_block().ops
         if op.type == "edit_distance"][0].output("Out")[0]
    fc, rows_t, dist = pexe.run(pmain, feed=feed, scope=pscope,
                                fetch_list=[pouts["fc_out"],
                                            pouts["decoded"], d],
                                return_numpy=False)
    rows, lod, want = _jax_decode(np.asarray(fc), LABELS)
    np.testing.assert_array_equal(np.asarray(rows_t), rows)
    np.testing.assert_array_equal(np.asarray(dist), want)
    with pt.scope_guard(pscope):
        avg, err = ed.eval(pexe)
    assert np.isfinite(avg) and 0 <= err <= 1


def test_the_predictor_round_trips(runs):
    pexe, pscope, _, _ = runs["port"]
    prog, _, outs = _decode(pt)
    feed = _feed(1, pt)
    got = pexe.run(prog, feed={"pixel": feed["pixel"]}, scope=pscope,
                   fetch_list=[outs["decoded"]], return_numpy=False)[0]
    with tempfile.TemporaryDirectory() as d:
        with pt.scope_guard(pscope):
            pt.io.save_inference_model(d, ["pixel"], [outs["decoded"]],
                                       pexe, main_program=prog)
        cfg = AnalysisConfig(d)
        cfg.disable_gpu()
        predictor = create_paddle_predictor(cfg)
    predictor.get_input_tensor("pixel").copy_from_cpu(
        feed["pixel"].numpy())
    predictor.zero_copy_run()
    ot = predictor.get_output_tensor(predictor.get_output_names()[0])
    np.testing.assert_array_equal(ot.copy_to_cpu(), np.asarray(got))
    assert ot.lod() == got.lod()


def test_the_training_block_captures(runs):
    """Without the decoder the block captures (no eager reason): the
    second run of its plan captures and replays, the third and fourth
    replay, equal
    bit for bit to eager runs from the same state; the program with the
    evaluator stays eager, ctc_align named."""
    state = runs["state"]
    main, start, outs = _train(pt)
    out = {}
    for cached in (True, False):
        scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
        exe.run(start, scope=scope)
        load_params_from_numpy(scope, state, pt.CPUPlace())
        out[cached] = [np.asarray(exe.run(
            main, feed=_feed(0, pt), scope=scope, fetch_list=[outs["loss"]],
            use_program_cache=cached)[0]) for _ in range(4)]
        if cached:
            c = exe._engine.counters
            assert not exe._engine.eager_reasons
            assert (c["captures"], c["replays"]) == (1, 3), dict(c)
    for a, b in zip(out[True], out[False]):
        np.testing.assert_array_equal(a, b)
    emain, estart, eouts = _train(pt, evaluate=True)
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    exe.run(estart, scope=scope)
    load_params_from_numpy(scope, state, pt.CPUPlace())
    for _ in range(2):
        exe.run(emain, feed=_feed(0, pt), scope=scope,
                fetch_list=[eouts["loss"]])
    assert "ctc_align" in exe._engine.eager_reasons.values()
