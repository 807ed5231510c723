"""Faster R-CNN (chip_smoke.faster_rcnn: ResNet-C4, the RPN, the
proposal and RoI sampling ops, roi_align, res5 and the two heads) in the
port against the JAX package, at stages (1, 1, 1, 1), width 8, 64x96
images, B=2, 5 classes, use_random=False, 200 / 40 proposals before /
after NMS and 32 RoIs an image (the card runs the published sizes).

* The training program (Momentum under linear_lr_warmup(piecewise_decay)
  and L2Decay, conv1 and res2 frozen, the frozen affine_channel
  parameters, the biases at twice the rate) and the detection program
  built with each package's layers: op for op the same ProgramDesc
  (the JAX package infers int32 for the labels' cast to int64).
* Three Momentum steps from the JAX package's initial parameters
  (carried by load_params_from_numpy) on COCO-shaped batches
  (chip_smoke._rcnn_batch: a geometric count of boxes an image, a crowd
  box): each step's proposals (RpnRois) and sampled RoIs equal the JAX
  package's within ROIS_ATOL = 1e-4 of pixel coordinates up to 96 (the
  convolutions' float32 noise through the decode: the same rows), the
  RoIs' labels exactly; then the losses within LOSS_RTOL = 1e-5
  relative.
* The detection rows of the trained parameters equal the JAX package's
  (labels and LoD exactly, scores and boxes within ROWS_ATOL = 1e-4).
* The training and detection blocks capture (no eager reason; the
  second run of a plan captures, the third replays on the CPU, equal to
  eager); save_inference_model, then AnalysisPredictor on the CPU: its
  rows equal Executor.run's within INFER_ATOL = 1e-6.
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
from test_torch_book import _widen_desc
from test_torch_one_stage_detection import jax_start_state
from torch_threads import one_torch_thread  # noqa: F401

SIZE = {"image": (64, 96), "class_num": 5, "stages": (1, 1, 1, 1),
        "width": 8}
KW = {"proposals": (200, 40), "roi_batch": 32, "use_random": False}
B = 2
LOSS_RTOL = 1e-5
ROIS_ATOL = 1e-4
ROWS_ATOL = 1e-4
INFER_ATOL = 1e-6
STEP_FETCH = ("loss", "rpn_rois", "rois", "labels")


def _train(fl):
    fl.framework.unique_name.reset()
    main, startup, outs = cs.faster_rcnn_train(fl, **SIZE, **KW)
    main.random_seed = startup.random_seed = 7
    return main, startup, outs


def _detect(fl):
    fl.framework.unique_name.reset()
    return cs.faster_rcnn_detect(fl, **SIZE, proposals=KW["proposals"])


def _batches(n, fl):
    out = []
    for s in range(n):
        f = cs._rcnn_batch(torch, pt, s, pt.CPUPlace(), B=B,
                           image=SIZE["image"], short=64, long_max=95,
                           class_num=SIZE["class_num"])
        if fl is fluid:
            f = {k: (fluid.create_lod_tensor(
                np.asarray(v), [np.diff(v.lod()[0]).tolist()],
                fluid.CPUPlace()) if hasattr(v, "lod") else v.numpy())
                for k, v in f.items()}
        out.append(f)
    return out


def _det_feed(f):
    return {k: f[k] for k in ("image", "im_info")}


@pytest.fixture(scope="module")
def runs():
    """The JAX package's and the port's three steps from the JAX initial
    parameters (each step's STEP_FETCH), then each one's detection rows
    of batch 0."""
    jmain, jstart, jouts = _train(fluid)
    pmain, pstart, pouts = _train(pt)
    jscope, jexe, state = jax_start_state(jstart, jmain)
    pscope, pexe = pt.Scope(), pt.Executor(pt.CPUPlace())
    pexe.run(pstart, scope=pscope)
    load_params_from_numpy(pscope, state, pt.CPUPlace())
    steps = []
    pfeeds = _batches(3, pt)
    for jf, pf in zip(_batches(3, fluid), pfeeds):
        j = jexe.run(jmain, feed=jf, fetch_list=[jouts[k] for k in
                                                 STEP_FETCH], scope=jscope)
        p = pexe.run(pmain, feed=pf, fetch_list=[pouts[k] for k in
                                                 STEP_FETCH], scope=pscope)
        steps.append(([np.asarray(v) for v in j], [np.asarray(v) for v in p]))
    jdet, jdstart, jd = _detect(fluid)
    pdet, pdstart, pd = _detect(pt)
    feed = _det_feed(pfeeds[0])
    jrows = jexe.run(jdet, feed={k: v.numpy() for k, v in feed.items()},
                     fetch_list=[jd["nmsed"]], scope=jscope,
                     return_numpy=False)[0]
    prows = pexe.run(pdet, feed=feed, fetch_list=[pd["nmsed"]], scope=pscope,
                     return_numpy=False)[0]
    return {"steps": steps, "rows": (jrows, prows),
            "programs": ((jmain, jstart, jdet, jdstart),
                         (pmain, pstart, pdet, pdstart)),
            "port": (pexe, pscope, pmain, pouts, pfeeds[0], pdet, pd, feed)}


def test_faster_rcnn_programs_equal_the_jax_programs(runs):
    (jmain, jstart, jdet, jdstart), (pmain, pstart, pdet, pdstart) = \
        runs["programs"]
    types = [op.type for op in pmain.global_block().ops]
    for t in ("rpn_target_assign", "generate_proposals",
              "generate_proposal_labels", "roi_align", "roi_align_grad",
              "affine_channel", "sigmoid_cross_entropy_with_logits",
              "softmax_with_cross_entropy", "smooth_l1_loss", "gather"):
        assert t in types, t
    # conv1, res2-res5 of one bottleneck (3 convs and a projection each)
    # and the RPN's three; momentum on all but conv1's and res2's four
    # convs and the frozen affine parameters
    assert types.count("conv2d") == 1 + 4 * 4 + 3
    assert types.count("momentum") == 3 * 4 + 6 + 4
    mine = pmain.serialize_to_string()
    assert _widen_desc(jmain.serialize_to_string(), mine, ("cast",)) == mine
    assert pstart.serialize_to_string() == jstart.serialize_to_string()
    assert [op.type for op in pdet.global_block().ops].count(
        "multiclass_nms") == 1
    assert pdet.serialize_to_string() == jdet.serialize_to_string()
    assert pdstart.serialize_to_string() == jdstart.serialize_to_string()


def test_three_momentum_steps_match_jax(runs):
    losses = []
    for i, (j, p) in enumerate(runs["steps"]):
        for name, a, b in zip(STEP_FETCH[1:3], j[1:3], p[1:3]):
            assert a.shape == b.shape, (i, name)
            np.testing.assert_allclose(b, a, rtol=0, atol=ROIS_ATOL,
                                       err_msg=f"step {i} {name}")
        np.testing.assert_array_equal(p[3], j[3], err_msg=f"step {i}")
        assert (p[3] > 0).any() and (p[3] == 0).any()
        losses.append((float(j[0].reshape(-1)[0]), float(p[0].reshape(-1)[0])))
    jl, pl = zip(*losses)
    assert all(np.isfinite(pl))
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)


def test_detection_rows_match_jax(runs):
    jrows, prows = runs["rows"]
    j, p = np.asarray(jrows), np.asarray(prows)
    assert j.shape == p.shape == (B * cs.RCNN_DET["keep_top_k"], 6)
    assert jrows.lod() == prows.lod()
    np.testing.assert_array_equal(p[:, 0], j[:, 0])
    np.testing.assert_allclose(p[:, 1:], j[:, 1:], rtol=0, atol=ROWS_ATOL)


def test_blocks_capture_and_the_predictor(runs):
    pexe, pscope, pmain, pouts, pfeed, pdet, pd, feed = runs["port"]
    c0 = dict(pexe._engine.counters)
    # batch 0's plan ran once: its second run captures, the third replays
    for _ in range(2):
        pexe.run(pmain, feed=pfeed, fetch_list=[pouts["loss"]], scope=pscope)
    assert pexe._engine.counters["captures"] == c0["captures"] + 1
    rows = [pexe.run(pdet, feed=feed, fetch_list=[pd["nmsed"]],
                     scope=pscope, return_numpy=False)[0]
            for _ in range(2)]
    eager = pexe.run(pdet, feed=feed, fetch_list=[pd["nmsed"]], scope=pscope,
                     use_program_cache=False, return_numpy=False)[0]
    assert pexe._engine.counters["captures"] == c0["captures"] + 2
    assert not pexe._engine.eager_reasons
    for r in rows:
        np.testing.assert_array_equal(np.asarray(r), np.asarray(eager))
        assert r.lod() == eager.lod()
    with tempfile.TemporaryDirectory() as d:
        with pt.scope_guard(pscope):
            pt.io.save_inference_model(d, ["image", "im_info"],
                                       [pd["nmsed"]], pexe,
                                       main_program=pdet)
        config = AnalysisConfig(d)
        config.disable_gpu()
        predictor = create_paddle_predictor(config)
    for name in ("image", "im_info"):
        predictor.get_input_tensor(name).copy_from_cpu(feed[name].numpy())
    predictor.zero_copy_run()
    out = predictor.get_output_tensor(predictor.get_output_names()[0])
    np.testing.assert_allclose(out.copy_to_cpu(), np.asarray(eager),
                               rtol=0, atol=INFER_ATOL)
    assert out.lod() == eager.lod()
