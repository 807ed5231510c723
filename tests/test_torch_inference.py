"""The port's inference predictor (paddle_tpu_torch/inference/) against
the port's Executor and the JAX package's predictor, on the CPU.

* A small regression model (fc 16 relu, fc 1, square error, 5 SGD
  steps) saved with save_inference_model: the predictor's ZeroCopy and
  Run() outputs equal to the live program's within TOL (1e-5), in the
  port and across packages (the JAX package saves, both predictors
  serve the directory).
* clone() shares the loaded scope (the model directory may be gone), a
  batch-size change is a new signature, a signature's second run
  captures and every later one replays (the engine's counters), a
  torch tensor feeds as a numpy array does, the predictor's tensors
  appear in the memory census.
* The parts that are refused or kept as knobs: a LoD that does not
  partition its feed's rows raises (a valid one is served), enable_aot
  writes no artifact, and AnalysisConfig() means the card (it raises
  where torch sees none).
"""
import os
import shutil

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.core.scope import Scope as JaxScope
from paddle_tpu.inference import (AnalysisConfig as JaxConfig,
                                  PaddleTensor as JaxTensor,
                                  create_paddle_predictor as jax_predictor)

import paddle_tpu_torch as pt
from paddle_tpu_torch.inference import (AnalysisConfig, PaddleTensor,
                                        create_paddle_predictor)
from paddle_tpu_torch.observability import memory as obs_memory
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5


def _data():
    rng = np.random.RandomState(0)
    xs = rng.rand(16, 6).astype(np.float32)
    ys = xs.sum(1, keepdims=True).astype(np.float32)
    return xs, ys


def _build(pkg, layers):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = layers.data("x", [6], dtype="float32")
        y = layers.data("y", [1], dtype="float32")
        h = layers.fc(x, 16, act="relu")
        pred = layers.fc(h, 1)
        d = layers.elementwise_sub(pred, y)
        loss = layers.mean(layers.elementwise_mul(d, d))
        pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, pred, loss


def _train_and_save(tmp_path):
    """The port trains and saves; (model dir, x, the live prediction)."""
    pt.framework.unique_name.reset()
    main, startup, pred, loss = _build(pt, pt.layers)
    xs, ys = _data()
    scope = pt.Scope()
    with pt.scope_guard(scope):
        exe = pt.Executor(pt.CPUPlace())
        exe.run(startup)
        for _ in range(5):
            exe.run(main, feed={"x": xs, "y": ys}, fetch_list=[loss])
        model_dir = str(tmp_path / "model")
        pt.io.save_inference_model(model_dir, ["x"], [pred], exe,
                                   main_program=main)
        ref, = exe.run(main, feed={"x": xs, "y": ys},
                       fetch_list=[pred.name])
    return model_dir, xs, ref


def _predictor(model_dir):
    config = AnalysisConfig(model_dir)
    config.disable_gpu()
    return create_paddle_predictor(config)


def test_predictor_matches_executor(tmp_path):
    model_dir, xs, ref = _train_and_save(tmp_path)
    pred = _predictor(model_dir)
    assert pred.get_input_names() == ["x"]
    assert len(pred.get_output_names()) == 1
    it = pred.get_input_tensor("x")
    it.copy_from_cpu(xs)
    assert it.shape() == [16, 6]
    pred.zero_copy_run()
    ot = pred.get_output_tensor(pred.get_output_names()[0])
    np.testing.assert_allclose(ot.copy_to_cpu(), ref, rtol=TOL, atol=TOL)
    assert ot.shape() == [16, 1]
    outs = pred.run([PaddleTensor(xs, "x")])
    np.testing.assert_allclose(outs[0].data, ref, rtol=TOL, atol=TOL)
    assert outs[0].shape == [16, 1]
    for _ in range(3):
        pred.zero_copy_run()
    np.testing.assert_allclose(ot.copy_to_cpu(), ref, rtol=TOL, atol=TOL)


def test_predictor_matches_jax_predictor(tmp_path):
    """The JAX package trains and saves; its predictor and the port's
    serve the same directory."""
    fluid.framework.unique_name.reset()
    main, startup, pred, loss = _build(fluid, fluid.layers)
    xs, ys = _data()
    scope = JaxScope()
    with fluid.scope_guard(scope):
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        for _ in range(5):
            exe.run(main, feed={"x": xs, "y": ys}, fetch_list=[loss.name])
        model_dir = str(tmp_path / "jax_model")
        fluid.io.save_inference_model(model_dir, ["x"], [pred], exe,
                                      main_program=main)
    jcfg = JaxConfig(model_dir)
    jcfg.disable_gpu()
    jcfg.enable_aot(False)
    want = np.asarray(jax_predictor(jcfg).run([JaxTensor(xs, "x")])[0].data)
    port = _predictor(model_dir)
    for _ in range(3):          # eager, capture, replay
        got = port.run([PaddleTensor(xs, "x")])[0].data
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_predictor_clone_shares_loaded_weights(tmp_path):
    model_dir, xs, ref = _train_and_save(tmp_path)
    p1 = _predictor(model_dir)
    out1 = p1.run([PaddleTensor(xs, "x")])[0].data
    shutil.rmtree(model_dir)
    twin = p1.clone()
    assert twin._scope is p1._scope
    assert twin._engine is not p1._engine
    out2 = twin.run([PaddleTensor(xs, "x")])[0].data
    np.testing.assert_allclose(out2, out1, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(out2, ref, rtol=TOL, atol=TOL)


def test_predictor_batch_size_change_builds_a_signature(tmp_path):
    model_dir, xs, _ = _train_and_save(tmp_path)
    pred = _predictor(model_dir)
    o16 = pred.run([PaddleTensor(xs, "x")])[0]
    o4 = pred.run([PaddleTensor(xs[:4], "x")])[0]
    assert o16.shape[0] == 16 and o4.shape[0] == 4
    assert len(pred._compiled) == 2
    assert pred._engine.counters["traces"] == 2
    np.testing.assert_allclose(o4.data, o16.data[:4], rtol=TOL, atol=TOL)


def test_signature_captures_at_its_second_run(tmp_path):
    model_dir, xs, ref = _train_and_save(tmp_path)
    pred = _predictor(model_dir)
    c = pred._engine.counters
    seen = []
    for _ in range(4):
        out = pred.run([PaddleTensor(xs, "x")])[0].data
        np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)
        seen.append((c["traces"], c["captures"], c["replays"],
                     c["eager_runs"]))
    assert seen == [(1, 0, 0, 1), (1, 1, 1, 1), (1, 1, 2, 1),
                    (1, 1, 3, 1)]


def test_tensor_feed_and_device_fetch(tmp_path):
    """A torch tensor feeds as its numpy array does, and _run_feeds
    gives the fetches as tensors on the predictor's device."""
    model_dir, xs, ref = _train_and_save(tmp_path)
    pred = _predictor(model_dir)
    it = pred.get_input_tensor("x")
    it.copy_from_cpu(torch.from_numpy(xs))
    pred.zero_copy_run()
    out = pred.get_output_tensor(pred.get_output_names()[0]).copy_to_cpu()
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)
    t, = pred._run_feeds({"x": torch.from_numpy(xs)})
    assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
    np.testing.assert_allclose(t.numpy(), ref, rtol=TOL, atol=TOL)


def test_predictor_in_memory_census(tmp_path):
    model_dir, xs, _ = _train_and_save(tmp_path)
    pred = _predictor(model_dir)
    for _ in range(2):
        pred.run([PaddleTensor(xs, "x")])
    c = obs_memory.census(top_n=512)
    labels = {b["label"] for b in c["top_buffers"]
              if b["owner"] == "predictor"}
    assert any(lb.startswith("scope:") for lb in labels)
    # the captured plan's static input (its state is the scope's: the
    # scope's Variables point at the static tensors)
    assert any(lb.endswith(".in:x") for lb in labels)
    assert c["owners"]["predictor"]["bytes"] > 0


def test_predictor_lod_input_refused(tmp_path):
    """A LoD that partitions the feed's rows is served (the dense model
    carries it to its output) and is a signature of its own; one that
    does not is refused."""
    model_dir, xs, ref = _train_and_save(tmp_path)
    pred = _predictor(model_dir)
    it = pred.get_input_tensor("x")
    it.copy_from_cpu(xs)
    it.set_lod([[0, 6, 16]])
    assert it.lod() == [[0, 6, 16]]
    pred.zero_copy_run()
    ot = pred.get_output_tensor(pred.get_output_names()[0])
    np.testing.assert_allclose(ot.copy_to_cpu(), ref, rtol=TOL, atol=TOL)
    assert ot.lod() == [[0, 6, 16]]
    it.set_lod([[0, 6, 17]])
    with pytest.raises(ValueError, match="does not partition"):
        pred.zero_copy_run()
    assert len(pred._compiled) == 1


def test_enable_aot_accepted_writes_nothing(tmp_path):
    model_dir, xs, ref = _train_and_save(tmp_path)
    before = sorted(os.listdir(model_dir))
    config = AnalysisConfig(model_dir)
    config.disable_gpu()
    config.enable_aot(True)
    config.switch_ir_optim(True)
    config.enable_memory_optim()
    pred = create_paddle_predictor(config)
    for _ in range(3):
        out = pred.run([PaddleTensor(xs, "x")])[0].data
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)
    assert sorted(os.listdir(model_dir)) == before
    assert not os.path.exists(os.path.join(model_dir, "__aot__"))


def test_analysis_config_means_the_card(tmp_path, monkeypatch):
    model_dir, _, _ = _train_and_save(tmp_path)
    config = AnalysisConfig(model_dir)
    assert config.use_gpu()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CPUPlace"):
        create_paddle_predictor(config)
    config.disable_gpu()
    assert not config.use_gpu()
    assert create_paddle_predictor(config)._place == pt.CPUPlace()


def test_concurrent_runs_share_one_lock(tmp_path):
    """Eight threads run two signatures at once with a short switch
    interval: every run is counted and every output right (each run,
    plan and capture holds the predictor's run lock)."""
    import sys
    import threading
    model_dir, xs, ref = _train_and_save(tmp_path)
    pred = _predictor(model_dir)
    bad, runs = [], 10
    old = sys.getswitchinterval()

    def work(i):
        n = 16 if i % 2 else 4
        for _ in range(runs):
            out = pred.run([PaddleTensor(xs[:n], "x")])[0].data
            if not np.allclose(out, ref[:n], rtol=TOL, atol=TOL):
                bad.append(i)

    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not bad
    assert sum(pred._compiled.values()) == 8 * runs
    c = pred._engine.counters
    assert (c["runs"], c["traces"], c["captures"]) == (8 * runs, 2, 2)
