"""The PTB word language model (chip_smoke.ptb_lm: PaddleNLP's
lm_model.py, its cudnn path: an embedding, layers.lstm, the softmax fc,
gradients clipped by GradientClipByGlobalNorm, SGD) in the port against
the JAX package, at vocab 50, 2 layers of 8, 5 steps, B=3.

* The training program built with each package's layers is the same op
  for op (types, slots, attrs and the parameters' shapes), and the
  startup programs the same bytes.
* 3 clipped SGD steps of truncated BPTT (last_hidden / last_cell fed
  back as init_hidden / init_cell) from the JAX package's initial
  parameters (carried by load_params_from_numpy) match its steps within
  RTOL = 1e-5 relative (ATOL = 1e-7 absolute for values near zero) on
  the losses, the carried states and the parameters: once with a clip
  that binds (the global norm above it) and once with one that does
  not. Dropout is off here, as in every parity run.
* The port's captured steps (CPU replays, dropout 0.5 on) are bit-equal
  to its eager steps from the same state.
* The is_test program through save_inference_model and AnalysisPredictor
  gives Executor.run's per-token losses and states.
"""
import tempfile

import numpy as np
import pytest

import paddle_tpu as fluid

import paddle_tpu_torch as pt
from paddle_tpu_torch.inference import AnalysisConfig, create_paddle_predictor
from paddle_tpu_torch.io import load_params_from_numpy

import chip_smoke
from test_torch_book import _same_ops, _widen_desc
from torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-7
SIZE = dict(vocab=50, hidden=8, layers=2, steps=5, init_scale=0.05)
B, STEPS = 3, 3
BINDING, LOOSE = 0.05, 1000.0


def _build(fl, clip=LOOSE, dropout=0.0, is_test=False):
    fl.framework.unique_name.reset()
    return chip_smoke.ptb_train(fl, batch=B, clip=clip, is_test=is_test,
                                dropout=dropout, **SIZE)


def _scope(fl):
    return pt.Scope() if fl is pt else fluid.core.Scope()


def _feed(x, y, h, c):
    return {"x": x, "y": y, "init_hidden": h, "init_cell": c}


def _train(fl, main, start, outs, params=None, cached=True, exe=None):
    """STEPS steps of truncated BPTT from zero states: (losses, the
    carried states, the parameters after, the initial parameters)."""
    scope, exe = _scope(fl), exe or fl.Executor(fl.CPUPlace())
    exe.run(start, scope=scope)
    if params is not None:
        load_params_from_numpy(scope, params, pt.CPUPlace())
    names = [p.name for p in main.all_parameters()]
    init = {n: np.array(scope.find_var(n).get_tensor()) for n in names}
    shape = (SIZE["layers"], B, SIZE["hidden"])
    h = np.zeros(shape, np.float32)
    c = np.zeros(shape, np.float32)
    losses, states = [], []
    for x, y in chip_smoke.ptb_batches(STEPS, B, SIZE["steps"],
                                       SIZE["vocab"]):
        loss, h, c = exe.run(
            main, feed=_feed(x, y, h, c), scope=scope,
            fetch_list=[outs["loss"], outs["last_hidden"],
                        outs["last_cell"]], use_program_cache=cached)
        h, c = np.asarray(h), np.asarray(c)
        losses.append(np.asarray(loss))
        states.append((h, c))
    return losses, states, {n: np.array(scope.find_var(n).get_tensor())
                            for n in names}, init


def test_the_programs_are_the_same_op_for_op():
    pm, ps, _ = _build(pt, BINDING)
    jm, js, _ = _build(fluid, BINDING)
    _same_ops(pm, jm)
    mine = ps.serialize_to_string()
    assert _widen_desc(js.serialize_to_string(), mine, ("",)) == mine
    types = [o.type for o in pm.global_block().ops]
    assert types.count("dense_lstm") == 1 and \
        types.count("dense_lstm_grad") == 1
    assert types.count("squared_l2_norm") == 4 and types.count("sgd") == 4
    # the global-norm clip's ops, in the JAX package's order
    i = types.index("squared_l2_norm")
    assert types[i + 4:i + 10] == ["sum", "sqrt", "fill_constant",
                                   "elementwise_max", "elementwise_div",
                                   "elementwise_mul"]


@pytest.mark.parametrize("clip", [BINDING, LOOSE], ids=["binding", "loose"])
def test_three_clipped_steps_match_jax(clip):
    jm, js, jo = _build(fluid, clip)
    pm, ps, po = _build(pt, clip)
    jl, jstates, jparams, init = _train(fluid, jm, js, jo)
    pl, pstates, pparams, _ = _train(pt, pm, ps, po, params=init)
    for a, b in zip(pl, jl):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    for (ph, pc), (jh, jc) in zip(pstates, jstates):
        np.testing.assert_allclose(ph, jh, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(pc, jc, rtol=RTOL, atol=ATOL)
    for n in jparams:
        np.testing.assert_allclose(pparams[n], jparams[n], rtol=RTOL,
                                   atol=ATOL, err_msg=n)
    # whether the clip binds: against the other bound's steps
    other = _train(pt, *_build(pt, LOOSE if clip == BINDING else BINDING),
                   params=init)[2]
    moved = max(np.abs(other[n] - pparams[n]).max() for n in pparams)
    assert moved > 1e-4


def test_captured_steps_equal_eager_steps_on_the_cpu():
    """Dropout 0.5 on: the plan's first run is eager, its second
    captures (on the CPU a replay runs the step on the static tensors),
    the third replays; the same steps without the plan cache give the
    same bits."""
    pm, ps, po = _build(pt, BINDING, dropout=0.5)
    exe = pt.Executor(pt.CPUPlace())
    cap = _train(pt, pm, ps, po, exe=exe)
    c = exe._engine.counters
    assert (c["captures"], c["replays"]) == (1, STEPS - 1), dict(c)
    eager = _train(pt, pm, ps, po, params=cap[3], cached=False)
    for a, b in zip(cap[0], eager[0]):
        np.testing.assert_array_equal(a, b)
    for (h, c_), (h2, c2) in zip(cap[1], eager[1]):
        np.testing.assert_array_equal(h, h2)
        np.testing.assert_array_equal(c_, c2)
    for n in cap[2]:
        np.testing.assert_array_equal(cap[2][n], eager[2][n])


def test_the_predictor_round_trips():
    pm, ps, po = _build(pt, BINDING)
    _, _, params, _ = _train(pt, pm, ps, po)
    prog, _, outs = _build(pt, is_test=True)
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    load_params_from_numpy(scope, params, pt.CPUPlace())
    x, y = chip_smoke.ptb_batches(1, B, SIZE["steps"], SIZE["vocab"],
                                  seed=5)[0]
    r = np.random.default_rng(0)
    shape = (SIZE["layers"], B, SIZE["hidden"])
    feed = _feed(x, y, r.standard_normal(shape).astype(np.float32),
                 r.standard_normal(shape).astype(np.float32))
    fetch = [outs["token_loss"], outs["last_hidden"], outs["last_cell"]]
    got = exe.run(prog, feed=feed, fetch_list=fetch, scope=scope)
    assert got[0].shape == (B, SIZE["steps"])
    with tempfile.TemporaryDirectory() as d:
        with pt.scope_guard(scope):
            pt.io.save_inference_model(d, list(feed), fetch, exe,
                                       main_program=prog)
        cfg = AnalysisConfig(d)
        cfg.disable_gpu()
        predictor = create_paddle_predictor(cfg)
    for n, v in feed.items():
        predictor.get_input_tensor(n).copy_from_cpu(v)
    predictor.zero_copy_run()
    for name, want in zip(predictor.get_output_names(), got):
        np.testing.assert_array_equal(
            predictor.get_output_tensor(name).copy_to_cpu(), want)
