"""dygraph.jit.capture in the port on the CPU, against its own eager step
and against the JAX package's capture (tests/test_dygraph_capture.py):
the same numpy inputs, made from a seed, and the same initial parameters
(crossing as numpy through state_dict / set_dict).

On a CPU place the port's capture runs discovery (the step in the
tracer's abstract mode: no update) and then the eager step on each call;
the CUDA graph it builds on a card is held in tests/test_torch_cuda.py
(a graph a signature, a host sync raising, dropout drawing anew).

Tolerances: the port's captured trajectory equals its eager one within
2e-5 (as the JAX package holds its own; here it is the same arithmetic:
measured 0). Against the JAX package's capture, which XLA compiles into
one fused executable, float32 losses within 1e-5 relative and
parameters within 1e-5 relative in the norm of each tensor (Adam
magnifies the rounding of an element whose gradient is noise). Under
bf16 AMP each package rounds its own intermediate values to bf16, so
two AMP runs drift apart as either drifts from float32: the port's AMP
losses must be no further (in the norm over the 10 steps) from the JAX
package's than AMP_RATIO times the JAX package's AMP losses are from
its float32 ones (measured ratio 0.41), and each package's AMP losses
stay within the JAX test's bound (rtol 0.15, atol 0.05) of its float32
ones.
"""
import contextlib

import numpy as np
import pytest
import torch

import jax

import paddle_tpu as fluid
import paddle_tpu.framework as jfw

import paddle_tpu_torch as pt
from torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6
AMP_RATIO = 1.5


def _conv_net(fl):
    """tests/test_dygraph_capture.py's ConvNet, in package `fl`."""
    class ConvNet(fl.dygraph.Layer):
        def __init__(self):
            super().__init__("net")
            self.c1 = fl.dygraph.nn.Conv2D("c1", 8, 3, padding=1)
            self.c2 = fl.dygraph.nn.Conv2D("c2", 16, 3, padding=1, stride=2)
            self.fc = fl.dygraph.nn.FC("fc", 10)

        def forward(self, x):
            h = fl.layers.relu(self.c1(x))
            h = fl.layers.relu(self.c2(h))
            return self.fc(h)
    return ConvNet()


def _data(n=16):
    rng = np.random.RandomState(0)
    return (rng.rand(n, 1, 28, 28).astype(np.float32),
            rng.randint(0, 10, (n, 1)).astype(np.int64))


@contextlib.contextmanager
def _guard(fl):
    if fl is fluid:
        with fl.dygraph.guard(fl.CPUPlace()):
            jfw._dygraph_tracer()._rng_key = jax.random.PRNGKey(0)
            yield
    else:
        np.random.seed(0)
        with fl.dygraph.guard(fl.CPUPlace()):
            yield


def _state(model):
    return {k: np.asarray(p.numpy())
            for k, p in model._stable_named_parameters()}


def _run(fl, mode, params=None, n_steps=8, make_opt=None, amp=False,
         outs=False):
    """(losses of n_steps steps, eager or captured, from `params`, the
    package's own initial values when None; the final state; the model;
    the captured function)."""
    xs, ys = _data()
    with _guard(fl):
        model = _conv_net(fl)
        if params is not None:
            with fl.dygraph.base.no_grad():
                model(fl.dygraph.to_variable(xs))
            model.set_dict(params)
        opt = (make_opt or (lambda f: f.optimizer.AdamOptimizer(0.01)))(fl)

        def step(x, y):
            logits = model(x)
            loss = fl.layers.mean(
                fl.layers.softmax_with_cross_entropy(logits, y))
            loss.backward()
            opt.minimize(loss)
            model.clear_gradients()
            return (loss, logits) if outs else loss

        captured = fl.dygraph.jit.capture(step, optimizer=opt, amp=amp) \
            if mode == "captured" else step
        losses = []
        for _ in range(n_steps):
            out = captured(fl.dygraph.to_variable(xs),
                           fl.dygraph.to_variable(ys))
            loss = out[0] if outs else out
            losses.append(float(np.asarray(loss.numpy())))
        return np.array(losses), _state(model), model, captured


@pytest.fixture(scope="module")
def initial():
    """The JAX package's initial ConvNet parameters."""
    xs, _ = _data()
    with _guard(fluid):
        model = _conv_net(fluid)
        with fluid.dygraph.base.no_grad():
            model(fluid.dygraph.to_variable(xs))
        return _state(model)


def test_capture_matches_eager_trajectory_exactly(initial):
    le, se, _, _ = _run(pt, "eager", initial)
    lc, sc, _, cap = _run(pt, "captured", initial)
    np.testing.assert_allclose(lc, le, rtol=0, atol=2e-5)
    for k in se:
        np.testing.assert_allclose(sc[k], se[k], rtol=0, atol=2e-5,
                                   err_msg=k)
    # one discovery pass, every call captured, one cache entry
    assert cap.eager_calls == 1
    assert cap.captured_calls == 8
    assert len(cap._cache) == 1


def test_capture_matches_jax_capture(initial):
    jl, js, _, jcap = _run(fluid, "captured", initial)
    pl, ps, _, pcap = _run(pt, "captured", initial)
    np.testing.assert_allclose(pl, jl, rtol=RTOL, atol=ATOL)
    assert pl[-1] < pl[0]
    for k, want in js.items():
        err = np.linalg.norm(ps[k] - want) / np.linalg.norm(want)
        assert err <= RTOL, (k, err)
    assert (pcap.eager_calls, pcap.captured_calls, len(pcap._cache)) == \
        (jcap.eager_calls, jcap.captured_calls, len(jcap._cache))


def test_discovery_applies_no_update():
    """Discovery creates the parameters and accumulators with the values
    an eager build draws, and changes none of them."""
    xs, ys = _data()
    with _guard(pt):
        model = _conv_net(pt)
        with pt.dygraph.no_grad():
            model(pt.dygraph.to_variable(xs))
        want = _state(model)
    with _guard(pt):
        tracer = pt.framework._dygraph_tracer()
        model = _conv_net(pt)
        opt = pt.optimizer.MomentumOptimizer(0.1, 0.9)

        def step(x, y):
            loss = pt.layers.mean(pt.layers.softmax_with_cross_entropy(
                model(x), y))
            loss.backward()
            opt.minimize(loss)
            model.clear_gradients()
            return loss

        cap = pt.dygraph.jit.capture(step, optimizer=opt)
        cap._discover_state(tracer, [torch.from_numpy(xs),
                                     torch.from_numpy(ys)])
        got = _state(model)
        assert tracer._tape == [] and not tracer._run.records
        vel = [v for v in opt._accumulators["velocity"].values()]
        assert cap.eager_calls == 1 and cap.captured_calls == 0
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert len(vel) == 6 and all((v.numpy() == 0).all() for v in vel)
    assert all(v.value.device.type == "cpu" for v in cap._state.values())


def test_capture_handles_multiple_signatures_and_outputs():
    with _guard(pt):
        model = _conv_net(pt)
        opt = pt.optimizer.SGDOptimizer(0.1)

        @pt.dygraph.jit.capture(optimizer=opt)
        def step(x, y):
            logits = model(x)
            loss = pt.layers.mean(
                pt.layers.softmax_with_cross_entropy(logits, y))
            loss.backward()
            opt.minimize(loss)
            model.clear_gradients()
            return loss, {"logits": logits}

        for bs in (8, 8, 4, 8, 4):
            xs, ys = _data(bs)
            loss, out = step(pt.dygraph.to_variable(xs),
                             pt.dygraph.to_variable(ys))
            assert out["logits"].shape == (bs, 10)
            assert np.isfinite(float(loss.numpy()))
        assert len(step._cache) == 2   # two batch-size signatures
        assert step.captured_calls == 5 and step.eager_calls == 1
        assert all(p.gradient() is None for p in model.parameters())


def test_a_schedule_advances_once_a_signature():
    """The rate is fixed when a signature is first run, as the JAX
    capture bakes it at its trace: the schedule steps at discovery and at
    each signature's first call only."""
    with _guard(pt):
        model = _conv_net(pt)
        decay = pt.dygraph.PiecewiseDecay([1, 2, 3], [1.0, 0.5, 0.25, 0.125])
        opt = pt.optimizer.SGDOptimizer(decay)

        def step(x, y):
            loss = pt.layers.mean(
                pt.layers.softmax_with_cross_entropy(model(x), y))
            loss.backward()
            opt.minimize(loss)
            model.clear_gradients()
            return loss

        cap = pt.dygraph.jit.capture(step, optimizer=opt)
        for n in (4, 4, 4, 2, 4, 2):
            cap(*_data(n))
        assert decay.step_num == 3
        assert opt._global_learning_rate().numpy().tolist() == [0.25]


def _momentum(fl):
    return fl.optimizer.MomentumOptimizer(0.05, 0.9)


def test_capture_amp_bf16_parity(initial):
    """amp=True: the bf16 activation stream and float32 master
    parameters of the JAX package's capture; the losses fall as the JAX
    test requires, track the float32 trajectory within its bound, and
    agree with the JAX package's AMP capture within AMP_RATIO."""
    runs = {}
    for fl in (fluid, pt):
        for amp in (True, False):
            runs[fl, amp] = _run(fl, "captured", initial, n_steps=10,
                                 make_opt=_momentum, amp=amp, outs=True)
    pl, ps, model, _ = runs[pt, True]
    jl = runs[fluid, True][0]
    assert pl[-1] < pl[0] - 0.5, pl
    for p in model.parameters():            # master parameters
        assert p.value.dtype == torch.float32
    for fl in (fluid, pt):
        np.testing.assert_allclose(runs[fl, True][0], runs[fl, False][0],
                                   rtol=0.15, atol=0.05)
    jl32 = runs[fluid, False][0]
    assert np.linalg.norm(pl - jl) <= AMP_RATIO * np.linalg.norm(jl - jl32)
    # the bf16 path ran: AMP moved each package off its float32 losses
    assert not np.allclose(pl, runs[pt, False][0], rtol=1e-4)
