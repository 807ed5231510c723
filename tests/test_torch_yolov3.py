"""YOLOv3 (chip_smoke.yolov3: DarkNet-53's residual stages, three heads
with their routes, yolov3_loss, yolo_box and multiclass_nms) in the port
against the JAX package, at stages (1, 1, 1, 1, 1), width 8, a 64x64
input, B=2, 6 gt slots and 4 classes (the widths the class count sets
are the only ones it changes; the card runs 80).

* The training program (Momentum under linear_lr_warmup(piecewise_decay)
  and L2Decay, batch norm's parameters and the heads' biases at
  L2Decay(0)) and the detection program built with each package's
  layers: the same ProgramDesc bytes, main and startup.
* Three Momentum steps from the JAX package's initial parameters
  (carried by load_params_from_numpy) on COCO-shaped batches
  (chip_smoke._coco_batch: a geometric count of boxes an image, padded
  to 6): losses within LOSS_RTOL = 1e-5 relative of the JAX losses.
* The detection rows of the trained parameters equal the JAX package's
  (labels and LoD exactly, scores and boxes within ROWS_ATOL = 1e-4 of
  pixel coordinates up to 640: float32 convolutions sum in other
  orders).
* The training block captures (no eager reason; the second run captures,
  the third replays on the CPU); save_inference_model, then
  AnalysisPredictor on the CPU: its rows equal Executor.run's within
  INFER_ATOL = 1e-6.
"""
import tempfile

import numpy as np
import pytest
import torch

import paddle_tpu as fluid

import paddle_tpu_torch as pt
from paddle_tpu_torch.inference import AnalysisConfig, create_paddle_predictor
from paddle_tpu_torch.io import load_params_from_numpy

import chip_smoke as cs
from test_torch_one_stage_detection import jax_start_state
from torch_threads import one_torch_thread  # noqa: F401

SIZE = {"image": 64, "class_num": 4, "stages": (1, 1, 1, 1, 1), "width": 8}
B, BOXES = 2, 6
LOSS_RTOL = 1e-5
ROWS_ATOL = 1e-4
INFER_ATOL = 1e-6


def _train(fl):
    fl.framework.unique_name.reset()
    main, startup, loss, outs = cs.yolov3_train(fl, boxes=BOXES, **SIZE)
    main.random_seed = startup.random_seed = 7
    return main, startup, loss, outs


def _detect(fl):
    fl.framework.unique_name.reset()
    return cs.yolov3_detect(fl, **SIZE)


def _batches(n):
    return [{k: v.numpy() for k, v in cs._coco_batch(
        torch, s, "cpu", B=B, image=SIZE["image"], boxes=BOXES,
        class_num=SIZE["class_num"]).items()} for s in range(n)]


@pytest.fixture(scope="module")
def runs():
    """The JAX package's and the port's three steps from the JAX initial
    parameters, then each one's detection rows of batch 0."""
    jmain, jstart, jloss, jouts = _train(fluid)
    pmain, pstart, ploss, pouts = _train(pt)
    batches = _batches(3)
    jscope, jexe, state = jax_start_state(jstart, jmain)
    pscope, pexe = pt.Scope(), pt.Executor(pt.CPUPlace())
    pexe.run(pstart, scope=pscope)
    load_params_from_numpy(pscope, state, pt.CPUPlace())
    jl, pl = [], []
    for b in batches:
        f = cs._yolo_train_feed(b)
        jl.append(float(np.asarray(jexe.run(jmain, feed=f, fetch_list=[jloss],
                                            scope=jscope)[0]).reshape(-1)[0]))
        pl.append(float(np.asarray(pexe.run(pmain, feed=f, fetch_list=[ploss],
                                            scope=pscope)[0]).reshape(-1)[0]))
    det_feed = {"image": batches[0]["image"],
                "im_shape": batches[0]["im_shape"]}
    jdet, jdstart, jn = _detect(fluid)
    pdet, pdstart, pn = _detect(pt)
    jrows = jexe.run(jdet, feed=det_feed, fetch_list=[jn], scope=jscope,
                     return_numpy=False)[0]
    prows = pexe.run(pdet, feed=det_feed, fetch_list=[pn], scope=pscope,
                     return_numpy=False)[0]
    return {"losses": (jl, pl), "rows": (jrows, prows),
            "programs": ((jmain, jstart, jouts, jdet, jdstart),
                         (pmain, pstart, pouts, pdet, pdstart)),
            "port": (pexe, pscope, pdet, pn, det_feed)}


def test_yolov3_programs_equal_the_jax_programs(runs):
    (jmain, jstart, jouts, jdet, jdstart), \
        (pmain, pstart, pouts, pdet, pdstart) = runs["programs"]
    types = [op.type for op in pmain.global_block().ops]
    assert types.count("yolov3_loss") == 3 and \
        types.count("yolov3_loss_grad") == 3
    assert types.count("conv2d") == 39 and types.count("nearest_interp") == 2
    assert [tuple(o.shape) for o in pouts] == [tuple(o.shape) for o in jouts] \
        == [(-1, 27, 2, 2), (-1, 27, 4, 4), (-1, 27, 8, 8)]
    assert pmain.serialize_to_string() == jmain.serialize_to_string()
    assert pstart.serialize_to_string() == jstart.serialize_to_string()
    assert [op.type for op in pdet.global_block().ops].count("yolo_box") == 3
    assert pdet.serialize_to_string() == jdet.serialize_to_string()
    assert pdstart.serialize_to_string() == jdstart.serialize_to_string()


def test_three_momentum_steps_match_jax(runs):
    jl, pl = runs["losses"]
    assert all(np.isfinite(pl)) and pl[-1] < pl[0]
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)


def test_detection_rows_match_jax(runs):
    jrows, prows = runs["rows"]
    j, p = np.asarray(jrows), np.asarray(prows)
    assert j.shape == p.shape == (B * cs.YOLO_DET["keep_top_k"], 6)
    assert jrows.lod() == prows.lod()
    np.testing.assert_array_equal(p[:, 0], j[:, 0])
    assert (p[:, 0] >= 0).sum() > 0
    np.testing.assert_allclose(p[:, 1:], j[:, 1:], rtol=0, atol=ROWS_ATOL)


def test_training_block_captures_and_the_predictor(runs):
    pexe, pscope, pdet, pn, det_feed = runs["port"]
    assert not pexe._engine.eager_reasons
    c = dict(pexe._engine.counters)
    # startup and the first step eager, the second captures (and counts a
    # replay: on the CPU it runs the step on the static tensors), the
    # third replays; the detection eager
    assert (c["captures"], c["replays"], c["eager_runs"]) == (1, 2, 3)
    again = pexe.run(pdet, feed=det_feed, fetch_list=[pn], scope=pscope,
                     return_numpy=False)[0]
    assert pexe._engine.counters["captures"] == 2 and \
        not pexe._engine.eager_reasons
    np.testing.assert_array_equal(np.asarray(again),
                                  np.asarray(runs["rows"][1]))
    with tempfile.TemporaryDirectory() as d:
        with pt.scope_guard(pscope):
            pt.io.save_inference_model(d, ["image", "im_shape"], [pn], pexe,
                                       main_program=pdet)
        config = AnalysisConfig(d)
        config.disable_gpu()
        predictor = create_paddle_predictor(config)
    for name in ("image", "im_shape"):
        predictor.get_input_tensor(name).copy_from_cpu(det_feed[name])
    predictor.zero_copy_run()
    out = predictor.get_output_tensor(predictor.get_output_names()[0])
    np.testing.assert_allclose(out.copy_to_cpu(), np.asarray(again),
                               rtol=0, atol=INFER_ATOL)
    assert out.lod() == again.lod()
