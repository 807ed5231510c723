"""SimpleBaseline pose estimation (chip_smoke.pose_resnet: ResNet
bottleneck stages, three 4x4 stride-2 deconvolutions, 17 heatmaps) in
the port against the JAX package, at 2 bottleneck stages of one block,
a 64x48 input and B=2.

* The training program (pose_loss, AdamOptimizer(1e-3)) built with each
  package's layers and models/resnet.py blocks: the same ProgramDesc
  bytes, main and startup.
* Three Adam steps from the JAX package's initial parameters (carried by
  load_params_from_numpy) on COCO-shaped batches (chip_smoke._pose_batch:
  Gaussian heatmaps at seeded joints, target_weight 0/1): losses within
  LOSS_RTOL = 1e-5 relative of the JAX losses, and the first step's
  heatmaps within HEAT_TOL = 1e-5 of the largest. (Later heatmaps drift
  further: Adam's step is near lr for a parameter whose gradient is near
  zero, whatever that gradient's rounding.)
* save_inference_model, then AnalysisPredictor on the CPU: its heatmaps
  equal Executor.run's on the pruned program within 1e-6.
* The capture rule: a resize whose size is an OutSize input (read on the
  host) keeps its block eager, with bilinear_interp named as the reason;
  the same resize to a list out_shape is captured (a CPU replay).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.core.scope import Scope as JaxScope

import paddle_tpu_torch as pt
from paddle_tpu_torch.io import load_params_from_numpy

import chip_smoke as cs

STAGES, IMAGE, B = (1, 1), (64, 48), 2
LOSS_RTOL = 1e-5
HEAT_TOL = 1e-5
INFER_ATOL = 1e-6


def _program(fl):
    fl.framework.unique_name.reset()
    main, startup, loss, heat = cs.pose_train(fl, image=IMAGE,
                                              stages=STAGES)
    main.random_seed = startup.random_seed = 7
    return main, startup, loss, heat


def _feeds(hw, n):
    return [{k: v.numpy() for k, v in cs._pose_batch(
        torch, s, "cpu", B=B, image=IMAGE, heat=hw).items()}
        for s in range(n)]


def test_pose_programs_equal_the_jax_programs():
    jmain, jstart, _, jheat = _program(fluid)
    pmain, pstart, _, pheat = _program(pt)
    types = [op.type for op in pmain.global_block().ops]
    assert types.count("conv2d_transpose") == 3 and \
        types.count("conv2d_transpose_grad") == 3
    assert tuple(pheat.shape) == tuple(jheat.shape) == (-1, 17) + IMAGE
    assert pmain.serialize_to_string() == jmain.serialize_to_string()
    assert pstart.serialize_to_string() == jstart.serialize_to_string()


def test_three_adam_steps_match_jax():
    jmain, jstart, jloss, jheat = _program(fluid)
    pmain, pstart, ploss, pheat = _program(pt)
    feeds = _feeds(tuple(pheat.shape[2:]), 3)
    jscope, jexe = JaxScope(), fluid.Executor(fluid.CPUPlace())
    jexe.run(jstart, scope=jscope)
    state = {v.name: np.asarray(jscope.find_var(v.name).get_tensor())
             for v in jmain.global_block().vars.values()
             if v.persistable and jscope.find_var(v.name) is not None}
    pscope, pexe = pt.Scope(), pt.Executor(pt.CPUPlace())
    pexe.run(pstart, scope=pscope)
    load_params_from_numpy(pscope, state, pt.CPUPlace())
    jl, pl, heats = [], [], []
    for f in feeds:
        jo = jexe.run(jmain, feed=f, fetch_list=[jloss, jheat],
                      scope=jscope)
        po = pexe.run(pmain, feed=f, fetch_list=[ploss, pheat],
                      scope=pscope)
        jl.append(float(jo[0]))
        pl.append(float(po[0]))
        heats.append((np.asarray(jo[1]), np.asarray(po[1])))
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)
    assert len(set(pl)) == 3
    j, p = heats[0]
    assert np.abs(p - j).max() <= HEAT_TOL * np.abs(j).max()


def test_pose_predictor_round_trip(tmp_path):
    main, startup, loss, heat = _program(pt)
    feed = _feeds(tuple(heat.shape[2:]), 1)[0]
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    d = str(tmp_path / "pose")
    with pt.scope_guard(scope):
        pt.io.save_inference_model(d, ["image"], [heat], exe,
                                   main_program=main)
    test = pt.io._prune_program(main, [heat.name])
    ref = np.asarray(exe.run(test, feed={"image": feed["image"]},
                             fetch_list=[heat], scope=scope)[0])
    from paddle_tpu_torch.inference import (AnalysisConfig,
                                            create_paddle_predictor)
    config = AnalysisConfig(d)
    config.disable_gpu()
    pred = create_paddle_predictor(config)
    assert pred.get_input_names() == ["image"]
    it = pred.get_input_tensor("image")
    ot = pred.get_output_tensor(pred.get_output_names()[0])
    for _ in range(3):      # a plan, its capture, a replay
        it.copy_from_cpu(feed["image"])
        pred.zero_copy_run()
        got = ot.copy_to_cpu()
        assert got.shape == (B, 17) + IMAGE
        np.testing.assert_allclose(got, ref, rtol=0, atol=INFER_ATOL)
    assert pred._engine.counters["captures"] == 1


@pytest.mark.parametrize("size", ["OutSize", "list"])
def test_capture_rule_and_the_resize_size(size):
    pt.framework.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        img = pt.layers.data("img", [3, 4, 6], dtype="float32")
        if size == "OutSize":
            shape = pt.layers.data("shape", [2], dtype="int32",
                                   append_batch_size=False)
            out = pt.layers.resize_bilinear(img, actual_shape=shape)
        else:
            out = pt.layers.resize_bilinear(img, out_shape=[8, 9])
        loss = pt.layers.mean(out)
    op = main.global_block().ops[0]
    assert op.type == "bilinear_interp" and \
        ("OutSize" in op._inputs) == (size == "OutSize")
    x = np.random.default_rng(0).standard_normal(
        (2, 3, 4, 6)).astype(np.float32)
    feed = {"img": x}
    if size == "OutSize":
        feed["shape"] = np.array([8, 9], np.int32)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    got = [exe.run(main, feed=feed, fetch_list=[out, loss],
                   scope=scope) for _ in range(3)]
    c = exe._engine.counters
    reasons = set(exe._engine.eager_reasons.values())
    if size == "OutSize":
        assert reasons == {"bilinear_interp"}
        assert (c["captures"], c["eager_runs"]) == (0, 3)
    else:
        assert not reasons and (c["captures"], c["eager_runs"]) == (1, 1)
    for o in got:
        assert np.asarray(o[0]).shape == (2, 3, 8, 9)
        np.testing.assert_array_equal(np.asarray(o[0]),
                                      np.asarray(got[0][0]))
