"""The fake-quantize ops, the int8 inference ops, fsp and contrib.slim's
QAT passes in the port, against the JAX package.

* The nine fake-quantize ops and quantize / dequantize / requantize /
  fsp: forward and (where the JAX package registers one) the generic
  gradient through both `<op>_grad` lowerings, on the same numpy inputs,
  at 0 ulp: the port computes the JAX expressions with the same float32
  operations in the same order (the straight-through value
  `smooth + (rounded - smooth)`, jnp.clip's tie-splitting gradient,
  round half to even). A sum is in another order in XLA and torch (fsp's
  product; the gradient a scale gathers from the whole tensor), so the
  cases with a sum take inputs on a dyadic grid, where every sum is
  exact in any order; fsp on normal inputs holds 1e-6.
* The moving-average and range_abs_max state over 5 runs of a program
  in both packages, within STATE_RTOL (8 ulps): the jitted JAX step is
  not its lowering's arithmetic op for op (XLA fuses a multiply-add and
  multiplies by the bin count's reciprocal); the counters equal (the
  JAX package stores the iteration counter as float32, the port as
  int64).
* QuantizationTransformPass: the port's program is the JAX package's op
  for op, slot for slot, attr for attr and var for var (ResNet-18 and a
  classifier, every weight and activation type, train and test).
* The QAT flow of test_quantization.py::test_qat_end_to_end on
  resnet_train(depth=18) at 32x32, 10 classes, B=8, for both activation
  types (moving_average_abs_max, abs_max): transform, 2 Momentum steps,
  freeze, int8, each package from the JAX package's parameters. Each
  QAT step of the port is held to the JAX step from the same state by
  chip_smoke.qat_forward_check: every quantized tensor of the port
  (computed from the JAX package's quantized inputs of its segment)
  equals the JAX one element for element, except where the two
  pre-round values lie on either side of a half-step (the segment's
  float32 sums in another order moved a value across it): such an
  element moves by one quantum, scale / 127, and nowhere else. The
  pre-quantization tensors agree within X_RTOL of their largest, the
  loss within the bound qat_forward_check derives from the fc's width. The check rejects a bin count of 126 and a
  per-tensor weight scale. The test program after the steps is held
  the same way. Freeze and ConvertToInt8Pass on the same
  weights give the JAX package's weights, scales and int8 arrays bit
  for bit, and the int8 tensor files are the same bytes.
"""
import io as _io

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as fluid
import paddle_tpu.models  # noqa: F401
from paddle_tpu.contrib.slim import quantization as jq
from paddle_tpu.core.registry import ExecContext as JaxContext
from paddle_tpu.core.registry import OPS as JAX_OPS
from paddle_tpu.core.scope import Scope as JaxScope

import paddle_tpu_torch as pt
from paddle_tpu_torch.contrib.slim import quantization as pq
from paddle_tpu_torch.core.registry import ExecContext as PtContext
from paddle_tpu_torch.core.registry import OPS as PT_OPS
from paddle_tpu_torch.io import load_params_from_numpy
from paddle_tpu_torch.ops import family_cases

import chip_smoke

CPU = torch.device("cpu")
QUANT_OPS = (
    "fake_quantize_abs_max", "fake_quantize_dequantize_abs_max",
    "fake_channel_wise_quantize_abs_max", "fake_dequantize_max_abs",
    "fake_channel_wise_dequantize_max_abs", "fake_quantize_range_abs_max",
    "fake_quantize_moving_average_abs_max",
    "fake_quantize_dequantize_moving_average_abs_max",
    "moving_average_abs_max_scale")
MISC_OPS = ("quantize", "dequantize", "requantize", "fsp")


class _View:
    """An op desc both registries' ExecContexts read."""

    def __init__(self, type, inputs, outputs, attrs):
        self.type = type
        self._inputs = inputs
        self._outputs = outputs
        self._attrs = dict(attrs)

    def input(self, slot):
        return self._inputs.get(slot, [])

    def output(self, slot):
        return self._outputs.get(slot, [])

    def input_slots(self):
        return list(self._inputs)

    def output_slots(self):
        return list(self._outputs)

    def attr(self, name, default=None):
        return self._attrs.get(name, default)

    def has_attr(self, name):
        return name in self._attrs

    def all_attrs(self):
        return dict(self._attrs)

    def _all_attrs(self):
        return self._attrs.items()


def _f32(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _one(a):
    return np.asarray([a], np.float32)


CASES = [(t, ins, list(outs), attrs, diff)
         for t, ins, attrs, outs, diff in family_cases.quant_cases()]


GRAD_CASES = [(t, ins, list(outs), attrs, diff)
              for t, ins, attrs, outs, diff in
              family_cases.quant_grad_cases()]


def _ids():
    return [f"{c[0]}-{i}" for i, c in enumerate(CASES)]


def _names(slot, v):
    return [f"{slot.lower()}{i}" for i in range(len(v))] \
        if isinstance(v, list) else [slot.lower()]


def _env(inputs, to):
    env, ins = {}, {}
    for s, v in inputs.items():
        ins[s] = _names(s, v)
        for n, a in zip(ins[s], v if isinstance(v, list) else [v]):
            env[n] = to(np.array(a))
    return env, ins


def _forward(op_type, inputs, outs, attrs):
    """{slot: (JAX numpy, port numpy)} and both envs."""
    out_names = {s: [s.lower() + "_out"] for s in outs}
    jenv, ins = _env(inputs, jnp.asarray)
    view = _View(op_type, ins, out_names, attrs)
    JAX_OPS.get(op_type).lowering(JaxContext(view, jenv))
    penv, _ = _env(inputs, torch.from_numpy)
    PT_OPS.get(op_type).lowering(PtContext(view, penv, CPU))
    return {s: (np.asarray(jenv[n[0]]), penv[n[0]].numpy())
            for s, n in out_names.items()}, jenv, penv, ins, out_names


@pytest.mark.parametrize("case", CASES, ids=_ids())
def test_op_matches_jax_at_0_ulp(case):
    op_type, inputs, outs, attrs, _ = case
    res = _forward(op_type, inputs, outs, attrs)[0]
    for s, (j, p) in res.items():
        assert p.shape == j.shape, (s, p.shape, j.shape)
        if s == "IterOut":       # int64 in the port, JAX's x64 is off
            assert p.dtype == np.int64
            np.testing.assert_array_equal(p, j)
            continue
        assert p.dtype == j.dtype, (s, p.dtype, j.dtype)
        np.testing.assert_array_equal(p, j, err_msg=f"{op_type}.{s}")


@pytest.mark.parametrize("case", GRAD_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in
                              enumerate(GRAD_CASES)])
def test_op_gradient_matches_jax_at_0_ulp(case):
    """The generic gradient of each op through both `<op>_grad`
    lowerings, under the same cotangent of every float output (on a grid
    of 1/4 in [-1, 1], as the inputs are dyadic: _grad_cases)."""
    op_type, inputs, outs, attrs, diff = case
    assert JAX_OPS.has(op_type + "_grad") and PT_OPS.has(op_type + "_grad")
    _, jenv, penv, ins, out_names = _forward(op_type, inputs, outs, attrs)
    rng = np.random.default_rng(7)
    g_in = dict(ins)
    g_in.update({s: n for s, n in out_names.items()})
    cts = {}
    for s, n in out_names.items():
        v = np.asarray(jenv[n[0]])
        if v.dtype.kind != "f":
            continue
        g_in[s + "@GRAD"] = [n[0] + "@g"]
        cts[n[0] + "@g"] = (rng.integers(-4, 5, v.shape) / 4).astype(
            v.dtype)
    g_out = {s + "@GRAD": [f"{s.lower()}@dx"] for s in diff}
    view = _View(op_type + "_grad", g_in, g_out, attrs)
    jenv.update({k: jnp.asarray(v) for k, v in cts.items()})
    penv.update({k: torch.from_numpy(v) for k, v in cts.items()})
    JAX_OPS.get(op_type + "_grad").lowering(JaxContext(view, jenv))
    PT_OPS.get(op_type + "_grad").lowering(PtContext(view, penv, CPU))
    for s in diff:
        n = f"{s.lower()}@dx"
        j, p = np.asarray(jenv[n]), penv[n].numpy()
        assert p.dtype == j.dtype and p.shape == j.shape
        np.testing.assert_array_equal(p, j, err_msg=f"{op_type} d{s}")
        assert np.abs(p).max() > 0


def test_fsp_on_normal_inputs():
    rng = np.random.default_rng(3)
    x, y = _f32(rng, 2, 3, 6, 7), _f32(rng, 2, 4, 6, 7)
    (j, p), = _forward("fsp", {"X": x, "Y": y}, ["Out"], {})[0].values()
    np.testing.assert_allclose(p, j, rtol=1e-6, atol=1e-6)
    want = np.einsum("nihw,njhw->nij", x.astype(np.float64), y) / 42
    np.testing.assert_allclose(p, want, rtol=1e-5, atol=1e-6)


def test_the_ops_are_registered_as_in_jax():
    for t in QUANT_OPS + MISC_OPS:
        assert PT_OPS.has(t), t
        assert PT_OPS.has(t + "_grad") == JAX_OPS.has(t + "_grad"), t
        assert PT_OPS.get(t).no_grad_slots == JAX_OPS.get(t).no_grad_slots
    covered = {c[0] for c in CASES}
    assert covered == set(QUANT_OPS + MISC_OPS)


# ---------------------------------------------------------------------------
# the state over five runs
# ---------------------------------------------------------------------------

def _state_program(fl, kind):
    fl.framework.unique_name.reset()
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        b = main.global_block()
        b.create_var(name="x", shape=[6, 4], dtype="float32")
        b.create_var(name="out", shape=[6, 4], dtype="float32")
        for n in ("scale", "accum", "state"):
            b.create_var(name=n, shape=[1], dtype="float32",
                         persistable=True)
        b.create_var(name="scales", shape=[3], dtype="float32",
                     persistable=True)
        b.create_var(name="iter", shape=[1], dtype="int64",
                     persistable=True)
        if kind == "moving_average":
            b.append_op(
                type="fake_quantize_dequantize_moving_average_abs_max",
                inputs={"X": ["x"], "InScale": ["scale"],
                        "InAccum": ["accum"], "InState": ["state"]},
                outputs={"Out": ["out"], "OutScale": ["scale"],
                         "OutAccum": ["accum"], "OutState": ["state"]},
                attrs={"bit_length": 8, "moving_rate": 0.9,
                       "is_test": False}, infer_shape=False)
        else:
            b.append_op(
                type="fake_quantize_range_abs_max",
                inputs={"X": ["x"], "InScale": ["scale"],
                        "Iter": ["iter"], "OutScales": ["scales"]},
                outputs={"Out": ["out"], "OutScale": ["scale"],
                         "OutScales": ["scales"], "IterOut": ["iter"]},
                attrs={"bit_length": 8, "window_size": 3,
                       "is_test": False}, infer_shape=False)
    return main


# 8 float32 ulps
STATE_RTOL = 8 * 2.0 ** -23


@pytest.mark.parametrize("kind", ["moving_average", "range"])
def test_scale_state_over_five_runs_matches_jax(kind):
    init = {"scale": _one(0.001), "accum": _one(0.001),
            "state": _one(1.0), "scales": np.zeros(3, np.float32),
            "iter": np.zeros(1, np.int64)}
    rng = np.random.default_rng(5)
    xs = [_f32(rng, 6, 4, scale=s) for s in (1.0, 3.0, 0.5, 0.7, 0.2)]
    jmain = _state_program(fluid, kind)
    pmain = _state_program(pt, kind)
    jscope, jexe = JaxScope(), fluid.Executor(fluid.CPUPlace())
    pscope, pexe = pt.Scope(), pt.Executor(pt.CPUPlace())
    for n, a in init.items():
        jscope.var(n).get_tensor().set(a)
    load_params_from_numpy(pscope, init, pt.CPUPlace())
    names = ["scale", "accum", "state"] if kind == "moving_average" \
        else ["scale", "scales", "iter"]
    for x in xs:
        jo, = jexe.run(jmain, feed={"x": x}, fetch_list=["out"],
                       scope=jscope)
        po, = pexe.run(pmain, feed={"x": x}, fetch_list=["out"],
                       scope=pscope)
        # the jitted JAX step is not the lowering's arithmetic op for op:
        # XLA contracts rate * accum + max into a fused multiply-add and
        # turns the division by the bin count into a multiply by its
        # reciprocal (measured: up to 2 ulps in the scale after 5 runs)
        jo = np.asarray(jo)
        np.testing.assert_allclose(po, jo, rtol=STATE_RTOL,
                                   atol=STATE_RTOL * np.abs(jo).max())
        for n in names:
            j = np.asarray(jscope.find_var(n).get_tensor())
            p = np.asarray(pscope.find_var(n).get_tensor())
            np.testing.assert_allclose(p, j.astype(p.dtype), rtol=STATE_RTOL,
                                       err_msg=n)
    if kind == "range":         # the window forgot the run at scale 3.0
        assert np.asarray(pscope.find_var("scale").get_tensor())[0] < \
            np.abs(xs[1]).max()
        assert int(np.asarray(pscope.find_var("iter").get_tensor())[0]) == 5


# ---------------------------------------------------------------------------
# the transform pass
# ---------------------------------------------------------------------------

def _classifier(fl):
    fl.framework.unique_name.reset()
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        x = fl.layers.data("x", [1, 8, 8], dtype="float32")
        y = fl.layers.data("y", [1], dtype="int64")
        h = fl.layers.conv2d(x, 4, 3, act="relu")
        h = fl.layers.conv2d(h, 4, 3, groups=4, act="relu")
        logits = fl.layers.fc(h, 4)
        loss = fl.layers.mean(fl.layers.softmax_with_cross_entropy(
            logits, y))
    return main, startup, loss


def _resnet18(fl, hw=32, classes=10):
    fl.framework.unique_name.reset()
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        cost, acc, _ = fl.models.resnet_train(
            class_dim=classes, depth=18, image_shape=(3, hw, hw))
    return main, startup, cost, acc


def _same_program(pprog, jprog):
    pb, jb = pprog.global_block(), jprog.global_block()
    assert [o.type for o in pb.ops] == [o.type for o in jb.ops]
    for p, j in zip(pb.ops, jb.ops):
        assert p._inputs == j._inputs and p._outputs == j._outputs, p.type
        assert p.all_attrs() == j.all_attrs(), p.type
    assert sorted(pb.vars) == sorted(jb.vars)
    for n, v in pb.vars.items():
        w = jb.vars[n]
        assert (tuple(v.shape), v.persistable) == \
            (tuple(w.shape), w.persistable), n


@pytest.mark.parametrize("w_type", ["abs_max", "channel_wise_abs_max"])
@pytest.mark.parametrize("a_type", ["moving_average_abs_max",
                                    "range_abs_max", "abs_max"])
def test_transform_pass_gives_the_jax_program(a_type, w_type):
    for build in (_classifier, _resnet18):
        progs = {}
        for fl, mod, scope in ((fluid, jq, JaxScope()),
                               (pt, pq, pt.Scope())):
            main = build(fl)[0]
            test = main.clone(for_test=True)
            tp = mod.QuantizationTransformPass(
                scope=scope, activation_quantize_type=a_type,
                weight_quantize_type=w_type,
                quantizable_op_type=("conv2d", "depthwise_conv2d", "mul"))
            tp.apply(main, for_test=False)
            tp.apply(test, for_test=True)
            progs[fl] = (main, test)
        for p, j in zip(progs[pt], progs[fluid]):
            _same_program(p, j)
        types = [o.type for o in progs[pt][0].global_block().ops]
        assert any(t.startswith("fake_") for t in types)
    n_conv = types.count("conv2d")
    assert n_conv == 20 and types.count("mul") == 1
    # a weight quantizer a conv and the fc (two ops channel-wise); an
    # activation quantizer an input, which the 3 projection shortcuts
    # share with their block's first conv
    per_w = 2 if w_type == "channel_wise_abs_max" else 1
    assert sum(t.startswith("fake_") for t in types) == 21 * per_w + 18


# ---------------------------------------------------------------------------
# the QAT flow at depth 18
# ---------------------------------------------------------------------------

LR, MU, B, HW, CLASSES, QAT_STEPS = 1e-3, 0.9, 8, 32, 10, 2


def _feed(step):
    r = np.random.RandomState(step)
    return {"image": r.rand(B, 3, HW, HW).astype(np.float32),
            "label": r.randint(0, CLASSES, (B, 1)).astype(np.int64)}


@pytest.fixture(scope="module")
def initial():
    main, startup, _, _ = _resnet18(fluid)
    scope = JaxScope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    return {v.name: np.asarray(scope.find_var(v.name).get_tensor())
            for v in main.global_block().vars.values()
            if v.persistable and scope.find_var(v.name) is not None}


def _qat_programs(fl, mod, scope, a_type):
    """The QAT forward program (for the check), the train program
    (Momentum) and the test program, transformed, as test_qat_end_to_end
    builds them: clone the test program, minimize, transform both."""
    main, startup, cost, acc = _resnet18(fl)
    test = main.clone(for_test=True)
    fwd = main.clone()
    with fl.program_guard(main, startup):
        fl.optimizer.MomentumOptimizer(LR, MU).minimize(cost)
    tp = mod.QuantizationTransformPass(
        scope=scope, activation_quantize_type=a_type,
        weight_quantize_type="abs_max")
    tp.apply(main, for_test=False)
    tp.apply(fwd, for_test=False)
    tp.apply(test, for_test=a_type != "abs_max")
    return fwd, main, startup, test, cost


def _jax_state(scope, names):
    return {n: np.asarray(scope.find_var(n).get_tensor()) for n in names
            if scope.find_var(n) is not None and
            scope.find_var(n).is_initialized()}


@pytest.mark.parametrize("a_type", ["moving_average_abs_max", "abs_max"])
def test_qat_flow_at_depth_18_matches_jax(initial, a_type):
    jscope, jexe = JaxScope(), fluid.Executor(fluid.CPUPlace())
    for n, a in initial.items():
        jscope.var(n).get_tensor().set(a)
    jfwd, jmain, jstart, jtest, jcost = _qat_programs(fluid, jq, jscope,
                                                       a_type)
    pscope = pt.Scope()
    pfwd, pmain, pstart, ptest, pcost = _qat_programs(pt, pq, pscope,
                                                      a_type)
    _same_program(pmain, jmain)
    _same_program(ptest, jtest)
    # the velocities are the only startup state the parameters lack
    names = [v.name for v in pmain.global_block().vars.values()
             if v.persistable]
    jexe.run(jstart, scope=jscope)
    for n, a in initial.items():          # the startup refilled them
        jscope.var(n).get_tensor().set(a)
    checks = []
    for step in range(QAT_STEPS):
        feed = _feed(step)
        state = _jax_state(jscope, names)
        # the JAX step's quantized tensors, from its forward program
        fetch = chip_smoke.qat_fetch_names(jfwd, jcost.name)
        ref_scope = JaxScope()
        for n, a in state.items():
            ref_scope.var(n).get_tensor().set(a)
        vals = jexe.run(jfwd, feed=feed, fetch_list=fetch, scope=ref_scope)
        ref = {n: np.asarray(v) for n, v in zip(fetch, vals)}
        checks.append(chip_smoke.qat_forward_check(
            torch, pt, pfwd, state, feed, ref, pcost.name, CPU))
        jexe.run(jmain, feed=feed, fetch_list=[jcost.name], scope=jscope)
    for c in checks:
        assert c["violations"] == 0, c
        assert c["x_rel"] <= chip_smoke.QAT_X_RTOL, c
        assert c["loss_rel"] <= c["loss_bound"], c
        assert c["mutants"]["bin_cnt 126"] > 0, c
        assert c["quant_ops"] == 21 + 18 and c["elements"] > 10 ** 6
    # the test program after the steps, held the same way; then freeze
    # and int8 on the JAX weights
    state = _jax_state(jscope, names)
    fetch = chip_smoke.qat_fetch_names(jtest, jcost.name)
    vals = jexe.run(jtest, feed=_feed(9), fetch_list=fetch, scope=jscope)
    c = chip_smoke.qat_forward_check(
        torch, pt, ptest, state, _feed(9),
        {n: np.asarray(v) for n, v in zip(fetch, vals)}, pcost.name, CPU)
    assert c["violations"] == 0 and c["x_rel"] <= chip_smoke.QAT_X_RTOL \
        and c["loss_rel"] <= c["loss_bound"], c
    load_params_from_numpy(pscope, state, pt.CPUPlace())
    with fluid.scope_guard(jscope):
        jq.QuantizationFreezePass(scope=jscope).apply(jtest)
        jq.ConvertToInt8Pass(scope=jscope).apply(jtest)
    pq.QuantizationFreezePass(scope=pscope).apply(ptest)
    pq.ConvertToInt8Pass(scope=pscope).apply(ptest)
    _same_program(ptest, jtest)
    params = [p.name for p in ptest.all_parameters()]
    assert len(params) > 40
    for n in params:
        for name in (n, n + ".quant_scale", n + "@int8"):
            if jscope.find_var(name) is None:
                assert pscope.find_var(name) is None, name
                continue
            j = np.asarray(jscope.find_var(name).get_tensor())
            p = np.asarray(pscope.find_var(name).get_tensor())
            assert p.dtype == j.dtype, name
            np.testing.assert_array_equal(p, j, err_msg=name)
    w8 = np.asarray(pscope.find_var("res_fc.w_0@int8").get_tensor())
    s = np.asarray(pscope.find_var("res_fc.w_0.quant_scale").get_tensor())
    w = np.asarray(pscope.find_var("res_fc.w_0").get_tensor())
    assert w8.dtype == np.int8
    np.testing.assert_allclose(w8 * (s[0] / 127.0), w, rtol=1e-6,
                               atol=1e-7)
    # the int8 tensor files: the same bytes from either package
    from paddle_tpu import io as jio
    from paddle_tpu_torch import io as pio
    files = {}
    for mod in (jio, pio):
        buf = _io.BytesIO()
        mod._serialize_tensor(buf, "res_fc.w_0@int8", w8)
        files[mod] = buf.getvalue()
    assert files[jio] == files[pio]
    back = pio._deserialize_tensors(_io.BytesIO(files[jio]))
    got = back["res_fc.w_0@int8"][0]
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, w8)
