"""The one-stage detectors' ops and layers in the port against the JAX
package, and the repaired gather and top_k.

* Every case of ops/family_cases.py's one_stage_cases() (yolov3_loss with
  a box on a cell edge, two boxes on one cell and anchor and an image
  with no box; yolo_box; anchor_generator with Python's half-to-even
  rounding; density_prior_box with int(step / density); sigmoid_focal_loss
  with an ignored label and FgNum 0; box_clip on a LoD;
  box_decoder_and_assign with a tie and a clipped delta;
  polygon_box_transform; retinanet_target_assign with a crowd box;
  retinanet_detection_output over two levels) through the port's lowering
  (family_cases.run) and the JAX lowering on the same seeded inputs,
  outputs and output LoDs, and both `<op>_grad` lowerings (the generic
  vjp in each) under one random cotangent of every float output.
  Tolerance TOL = 1e-5 relative and absolute (float32; libm and the order
  of sums differ), integers exactly. Two cases the JAX lowering cannot
  be held to: yolov3_loss with GTScore below 1 (the JAX lowering reads no
  GTScore; held to a numpy reckoning of the reference's rule, loss and
  gradient, within TOL) and retinanet_target_assign over a LoD with an
  image without boxes (the JAX lowering's argmax over no box fails; the
  other images' rows are held to the JAX lowering on the LoD without it,
  and every anchor of the empty image is negative).
* The numpy reckoning equals the JAX lowering where every score is 1.
* Each of the ten builders builds the JAX package's ProgramDesc byte for
  byte.
* A RetinaNet head (chip_smoke.retinanet: two levels, width 16, 5
  classes, B=2 on a LoD of boxes with a crowd box): the same training
  program as the JAX package's, and three SGD steps from the JAX
  package's parameters within LOSS_RTOL = 1e-5 of its losses; its
  detection program (retinanet_detection_output) runs captured.
* C.1: gather at indices [-1, -n, n, 0] equals jnp.take, forward (NaN /
  the int type's minimum for the filled row) and gradient (the wrapped
  rows receive theirs, the filled row sends none); scatter drops an
  update to an id out of range and gather_nd clamps a coordinate out of
  range, as the JAX ops do (both raised in the port before).
* C.2: top_k's gradient equals the JAX op's (the grad op, and a program
  through append_backward); a K input is read, and its block stays eager
  with top_k named as the reason, where the attr form captures.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as fluid
from paddle_tpu.core.registry import ExecContext as JaxContext
from paddle_tpu.core.registry import OPS as JAX_OPS
from paddle_tpu.core.scope import Scope as JaxScope

import paddle_tpu_torch as pt
from paddle_tpu_torch.core.registry import ExecContext as PtContext
from paddle_tpu_torch.core.registry import OPS as PT_OPS
from paddle_tpu_torch.io import load_params_from_numpy
from paddle_tpu_torch.ops import family_cases

import chip_smoke as cs
from test_torch_book import _widen_desc
from test_torch_op_families import _check
from test_torch_sequence import CPU, _names, _op
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5
LOSS_RTOL = 1e-5
CASES = family_cases.one_stage_cases()
IDS = [f"{c[0]}-{i}" for i, c in enumerate(CASES)]


def _scored(case):
    """A yolov3_loss case whose GTScore is not all 1."""
    return case[0] == "yolov3_loss" and "GTScore" in case[1] and \
        not np.all(case[1]["GTScore"] == 1)


def _empty_image(case):
    lod = case[2].get("gtboxes")
    return lod is not None and 0 in np.diff(lod[0])


def _jax_lowering(op_type, op, env, lods):
    """The JAX lowering of `op` on `env` (numpy), traced and compiled as
    one function (jax.jit): the same values as op by op, in a fraction
    of the time. Returns (env with the outputs, the LoDs it set)."""
    jl = dict(lods)

    def fn(arrays):
        e = dict(arrays)
        JAX_OPS.get(op_type).lowering(JaxContext(op, e, None, None, jl))
        return {n: e[n] for ns in op._outputs.values() for n in ns
                if n in e}

    outs = jax.jit(fn)({n: jnp.asarray(a) for n, a in env.items()})
    return dict(env, **outs), jl


_FORWARDS = {}


def _jax_forward(op_type, inputs, lods, attrs, names, cache=False):
    """The JAX forward of a case; with `cache`, reused for the same
    case (its inputs' identity)."""
    key = (op_type, id(inputs)) if cache else None
    if key in _FORWARDS:
        return _FORWARDS[key]
    op, env = _op(op_type, inputs, names, attrs)
    out = _jax_lowering(op_type, op, env, lods)
    if cache:
        _FORWARDS[key] = out
    return out


def _grads(op_type, inputs, lods, attrs, outs, fwd, diff, with_jax=True):
    """Both `<op>_grad` lowerings (the JAX one only where `fwd` is the
    JAX forward's env; none without `with_jax`) under one cotangent of
    every float output; returns ({grad name: JAX value} or None, {grad
    name: port value}, cotangents)."""
    rng = np.random.default_rng(7)
    g_in, cot = dict(inputs), {}
    for s, ns in outs.items():
        v = np.asarray(fwd[ns[0]])
        if not np.issubdtype(v.dtype, np.floating):
            continue
        g_in[s] = v
        g_in[s + "@GRAD"] = cot[s] = rng.standard_normal(v.shape).astype(
            v.dtype)
    g_outs = {s + "@GRAD": [n + "@g" for n in _names(s, inputs[s])]
              for s in diff}
    op, env = _op(op_type + "_grad", g_in, g_outs, attrs)
    pg = {n: torch.from_numpy(np.array(a)) for n, a in env.items()}
    PT_OPS.get(op_type + "_grad").lowering(PtContext(op, pg, CPU, None,
                                                     dict(lods)))
    names = [n for ns in g_outs.values() for n in ns]
    if not with_jax:
        return None, {n: pg[n] for n in names}, cot
    jg, _ = _jax_lowering(op_type + "_grad", op, env, lods)
    return {n: jg[n] for n in names}, {n: pg[n] for n in names}, cot


# ---------------------------------------------------------------------------
# the reference's GTScore rule, in numpy
# ---------------------------------------------------------------------------

def _sig(v):
    return 1.0 / (1.0 + np.exp(-v))


def _bce(v, t):
    return max(v, 0.0) - v * t + np.log1p(np.exp(-abs(v)))


def _iou_cs(a, b):
    """IoU of two (cx, cy, w, h) boxes."""
    ax1, ay1, ax2, ay2 = a[0] - a[2] / 2, a[1] - a[3] / 2, \
        a[0] + a[2] / 2, a[1] + a[3] / 2
    bx1, by1, bx2, by2 = b[0] - b[2] / 2, b[1] - b[3] / 2, \
        b[0] + b[2] / 2, b[1] + b[3] / 2
    iw = max(min(ax2, bx2) - max(ax1, bx1), 0.0)
    ih = max(min(ay2, by2) - max(ay1, by1), 0.0)
    inter = iw * ih
    union = a[2] * a[3] + b[2] * b[3] - inter
    return inter / union if union > 0 else 0.0


def yolov3_loss_numpy(x, gt_box, gt_label, gt_score, attrs, cot):
    """Loss [N] and dLoss.cot/dX of yolov3_loss by the reference's loops
    (yolov3_loss_op.h) in float64: a box whose best anchor (of all) is
    this head's adds (2 - w h) score times the sigmoid cross entropy of
    x and y and |w - tw| + |h - th|, and score times each class's sigmoid
    cross entropy; its cell's objectness is the score of the last box
    there; a cell with objectness above 1e-5 adds score times its cross
    entropy against 1, any other not ignored (best IoU of its predicted
    box below ignore_thresh, or a box's cell) its cross entropy against
    0."""
    x = x.astype(np.float64)
    n, _, h, w = x.shape
    mask = attrs["anchor_mask"]
    an = np.asarray(attrs["anchors"], np.float64).reshape(-1, 2)
    cls, a_n = attrs["class_num"], len(mask)
    size = attrs["downsample_ratio"] * h
    pos_t, neg_t = 1.0, 0.0
    if attrs["use_label_smooth"] and cls > 1:
        pos_t, neg_t = 1.0 - 1.0 / cls, 1.0 / cls
    p = x.reshape(n, a_n, 5 + cls, h, w)
    grad = np.zeros_like(p)
    loss = np.zeros(n)
    for i in range(n):
        boxes = [(t, gt_box[i, t]) for t in range(gt_box.shape[1])
                 if gt_box[i, t, 2] > 0]
        obj = np.zeros((a_n, h, w))
        for a in range(a_n):
            for j in range(h):
                for k in range(w):
                    pb = ((_sig(p[i, a, 0, j, k]) + k) / w,
                          (_sig(p[i, a, 1, j, k]) + j) / h,
                          np.exp(p[i, a, 2, j, k]) * an[mask[a], 0] / size,
                          np.exp(p[i, a, 3, j, k]) * an[mask[a], 1] / size)
                    best = max([_iou_cs(pb, b) for _, b in boxes] + [0.0])
                    if best >= attrs["ignore_thresh"]:
                        obj[a, j, k] = -1.0
        for t, b in boxes:
            gw, gh = b[2] * size, b[3] * size
            ious = [min(gw, aw) * min(gh, ah) /
                    (gw * gh + aw * ah - min(gw, aw) * min(gh, ah))
                    for aw, ah in an]
            best_n = int(np.argmax(ious))
            if best_n not in mask:
                continue
            a = mask.index(best_n)
            gi = min(max(int(b[0] * w), 0), w - 1)
            gj = min(max(int(b[1] * h), 0), h - 1)
            s = float(gt_score[i, t])
            scale = (2.0 - b[2] * b[3]) * s
            q = p[i, a, :, gj, gi]
            tx, ty = b[0] * w - gi, b[1] * h - gj
            tw, th = np.log(gw / an[best_n, 0]), np.log(gh / an[best_n, 1])
            loss[i] += scale * (_bce(q[0], tx) + _bce(q[1], ty) +
                                abs(q[2] - tw) + abs(q[3] - th))
            g = grad[i, a, :, gj, gi]
            g[0] += cot[i] * scale * (_sig(q[0]) - tx)
            g[1] += cot[i] * scale * (_sig(q[1]) - ty)
            g[2] += cot[i] * scale * np.sign(q[2] - tw)
            g[3] += cot[i] * scale * np.sign(q[3] - th)
            for c in range(cls):
                tc = pos_t if c == int(gt_label[i, t]) else neg_t
                loss[i] += s * _bce(q[5 + c], tc)
                g[5 + c] += cot[i] * s * (_sig(q[5 + c]) - tc)
            obj[a, gj, gi] = s
        for a in range(a_n):
            for j in range(h):
                for k in range(w):
                    v, o = p[i, a, 4, j, k], obj[a, j, k]
                    if o > 1e-5:
                        loss[i] += _bce(v, 1.0) * o
                        grad[i, a, 4, j, k] += cot[i] * o * (_sig(v) - 1.0)
                    elif o > -0.5:
                        loss[i] += _bce(v, 0.0)
                        grad[i, a, 4, j, k] += cot[i] * _sig(v)
    return loss, grad.reshape(x.shape)


# ---------------------------------------------------------------------------
# the ops
# ---------------------------------------------------------------------------

def _port(case):
    op_type, inputs, lods, attrs, out_slots, _ = case
    return family_cases.run(op_type, inputs, attrs, out_slots, "cpu", lods)


def _out_names(out_slots):
    return {s: [f"{s.lower()}_out{i}" for i in range(n)]
            for s, n in out_slots.items()}


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_one_stage_op_matches_jax(case):
    op_type, inputs, lods, attrs, out_slots, diff = case
    names = _out_names(out_slots)
    port, plod = _port(case)
    if _scored(case):
        cot = np.random.default_rng(7).standard_normal(2).astype(np.float32)
        loss, grad = yolov3_loss_numpy(inputs["X"], inputs["GTBox"],
                                       inputs["GTLabel"], inputs["GTScore"],
                                       attrs, cot)
        np.testing.assert_allclose(port["loss_out0"].numpy(), loss,
                                   rtol=TOL, atol=TOL)
        _, pg, got_cot = _grads(op_type, inputs, lods, attrs, names,
                                port, diff, with_jax=False)
        np.testing.assert_array_equal(got_cot["Loss"], cot)
        np.testing.assert_allclose(pg["x@g"].numpy(), grad, rtol=TOL,
                                   atol=TOL)
        return
    if _empty_image(case):
        _check_empty_image(case, port)
        return
    jenv, jl = _jax_forward(op_type, inputs, lods, attrs, names, cache=True)
    for ns in names.values():
        for n in ns:
            _check(jenv[n], port[n], f"{op_type} {n}")
            assert jl.get(n) == plod[n], n
    if diff:
        jg, pg, _ = _grads(op_type, inputs, lods, attrs, names, jenv, diff)
        for n in jg:
            _check(jg[n], pg[n], f"{op_type} {n}")


def _check_empty_image(case, port):
    """retinanet_target_assign over images of 2, 0 and 3 boxes: images 0
    and 2 equal the JAX lowering's on the LoD [0, 2, 5] without the empty
    image; image 1's anchors are all negative."""
    op_type, inputs, lods, attrs, out_slots, _ = case
    m = inputs["Anchor"].shape[0]
    kept = dict(inputs, ImInfo=inputs["ImInfo"][[0, 2]])
    names = _out_names(out_slots)
    jenv, _ = _jax_forward(op_type, kept, {"gtboxes": [[0, 2, 5]]}, attrs,
                           names)
    for s, (n,) in names.items():
        p, j = port[n].numpy(), np.asarray(jenv[n])
        if s == "ForegroundNumber":
            np.testing.assert_array_equal(p[[0, 2]], j)
            assert p[1, 0] == 0
            continue
        p = p.reshape(3, m, -1)
        j = j.reshape(2, m, -1)
        if s in ("LocationIndex", "ScoreIndex"):
            # rows are numbered b * M + m: image 2's are M past the JAX one's
            j = np.where(j >= 0, j + np.array([0, m])[:, None, None], -1)
        np.testing.assert_allclose(p[[0, 2]], j, rtol=TOL, atol=TOL,
                                   err_msg=s)
    loc, score, label = (port[f"{s}_out0"].numpy().reshape(3, m) for s in
                         ("locationindex", "scoreindex", "targetlabel"))
    assert (loc[1] == -1).all() and (label[1] == 0).all()
    np.testing.assert_array_equal(score[1], m + np.arange(m))
    assert not port["bboxinsideweight_out0"].numpy().reshape(
        3, m, 4)[1].any()


def test_numpy_reckoning_equals_jax_at_unit_scores():
    for case in CASES:
        if case[0] != "yolov3_loss" or _scored(case):
            continue
        _, inputs, lods, attrs, out_slots, _ = case
        jenv, _ = _jax_forward("yolov3_loss", inputs, lods, attrs,
                               _out_names(out_slots), cache=True)
        loss, _ = yolov3_loss_numpy(
            inputs["X"], inputs["GTBox"], inputs["GTLabel"],
            np.ones(inputs["GTLabel"].shape, np.float32), attrs,
            np.ones(2))
        np.testing.assert_allclose(loss, np.asarray(jenv["loss_out0"]),
                                   rtol=TOL, atol=TOL)


def test_one_stage_cases_are_not_trivial():
    """The cases reach what they name: a box on a cell edge, two boxes on
    one cell and anchor, a box of another head, ignored and positive
    cells, dropped yolo_box rows, a forced crowd anchor, suppressed and
    padded detections."""
    x, box, _, _ = family_cases._yolo_inputs(np.random.default_rng(22))
    assert box[0, 0, 0] * 4 == 2.0
    port, _ = _port(CASES[0])
    match = port["gtmatchmask_out0"].numpy()
    assert match[0].tolist() == [1, 1, 1, 0, 0, 0] and not match[1].any()
    noobj = port["objectnessmask_out0"].numpy()
    assert (noobj == 0).any() and (noobj == 1).any()
    kinds = [c[0] for c in CASES]
    boxes = _port(CASES[kinds.index("yolo_box")])[0]["boxes_out0"].numpy()
    assert (boxes == 0).all(-1).any() and (boxes != 0).any()
    ta = _port(CASES[kinds.index("retinanet_target_assign")])[0]
    loc = ta["locationindex_out0"].numpy().reshape(-1)
    assert (loc >= 0).sum() >= 3 and (loc == -1).any()
    out = _port(CASES[kinds.index("retinanet_detection_output")])[0][
        "out_out0"].numpy()
    assert (out[:, 0] >= 0).any() and (out[:, 0] == -1).any()
    # of the two overlapping class-1 candidates (0.95 and 0.93) in each
    # image, NMS keeps the first
    assert np.isclose(out[:, 1], 0.95).sum() == 2 and \
        not np.isclose(out[:, 1], 0.93).any()


def test_one_stage_ops_are_registered():
    """The ten op types are registered in the port, each with a case, a
    gradient op where the JAX package has one; the port registers 323 of
    the JAX package's forward op types (257 with these ten, then the
    two-stage detectors' ten, slice 24's eleven, slice 25's nineteen and
    slice 26's twenty-six)."""
    ten = {"yolov3_loss", "yolo_box", "anchor_generator",
           "density_prior_box", "sigmoid_focal_loss",
           "retinanet_target_assign", "retinanet_detection_output",
           "box_clip", "box_decoder_and_assign", "polygon_box_transform"}
    assert ten == {c[0] for c in CASES}
    for t in ten:
        assert PT_OPS.has(t) and \
            PT_OPS.has(t + "_grad") == JAX_OPS.has(t + "_grad"), t

    def forward(ops):
        return {t for t in ops.types() if not ops.get(t).is_grad_op}
    assert len(forward(PT_OPS)) == 323
    assert forward(PT_OPS) <= forward(JAX_OPS)


# ---------------------------------------------------------------------------
# the builders
# ---------------------------------------------------------------------------

def _builder_program(fl, name):
    L = fl.layers
    fl.framework.unique_name.reset()
    main = fl.Program()
    with fl.program_guard(main, fl.Program()):
        feat = L.data("feat", [4, 6, 5], dtype="float32")
        img = L.data("img", [3, 48, 40], dtype="float32")
        boxes = L.data("boxes", [4], dtype="float32", lod_level=1)
        info = L.data("info", [3], dtype="float32")
        if name == "density_prior_box":
            L.density_prior_box(feat, img, densities=[2, 1],
                                fixed_sizes=[8.0, 16.0],
                                fixed_ratios=[1.0], clip=True,
                                flatten_to_2d=True)
        elif name == "anchor_generator":
            L.anchor_generator(feat, anchor_sizes=[16.0, 32.0],
                               aspect_ratios=[0.5, 1.0], stride=[8.0, 8.0])
        elif name == "box_clip":
            L.box_clip(boxes, info)
        elif name == "polygon_box_transform":
            L.polygon_box_transform(L.data("geo", [8, 6, 5],
                                           dtype="float32"))
        elif name in ("yolov3_loss", "yolo_box"):
            x = L.data("x", [24, 4, 4], dtype="float32")
            if name == "yolo_box":
                L.yolo_box(x, L.data("size", [2], dtype="int32"),
                           [4, 5, 10, 12, 20, 24], 3, 0.01, 8)
            else:
                L.yolov3_loss(x, L.data("gtb", [6, 4], dtype="float32"),
                              L.data("gtl", [6], dtype="int32"),
                              family_cases.YOLO_ANCHORS,
                              family_cases.YOLO_MASK, 3, 0.7, 8,
                              gt_score=L.data("gts", [6], dtype="float32"))
        elif name == "sigmoid_focal_loss":
            L.sigmoid_focal_loss(L.data("logit", [5], dtype="float32"),
                                 L.data("label", [1], dtype="int32"),
                                 L.data("fg", [1], dtype="int32",
                                        append_batch_size=False))
        elif name == "retinanet_detection_output":
            # a batch of 2 at build time: the JAX lowering unrolls over
            # the images, which the build-time shape inference runs
            def fixed(n, shape):
                return L.data(n, shape, dtype="float32",
                              append_batch_size=False)
            L.retinanet_detection_output(
                [fixed(f"d{i}", [2, 6, 4]) for i in (0, 1)],
                [fixed(f"s{i}", [2, 6, 3]) for i in (0, 1)],
                [fixed(f"a{i}", [6, 4]) for i in (0, 1)],
                fixed("info2", [2, 3]), keep_top_k=10)
        elif name == "retinanet_target_assign":
            L.retinanet_target_assign(
                L.data("bp", [12, 4], dtype="float32"),
                L.data("cl", [12, 3], dtype="float32"),
                L.data("an", [12, 4], dtype="float32",
                       append_batch_size=False),
                L.data("av", [12, 4], dtype="float32",
                       append_batch_size=False),
                boxes, L.data("gl", [1], dtype="int32", lod_level=1),
                L.data("crowd", [1], dtype="int32", lod_level=1), info, 3)
        else:
            L.box_decoder_and_assign(
                L.data("pb", [4], dtype="float32"),
                L.data("pv", [4], dtype="float32"),
                L.data("tb", [12], dtype="float32"),
                L.data("bs", [3], dtype="float32"), 4.135)
    return main


BUILDERS = ["density_prior_box", "anchor_generator", "box_clip",
            "polygon_box_transform", "yolov3_loss", "yolo_box",
            "sigmoid_focal_loss", "retinanet_detection_output",
            "retinanet_target_assign", "box_decoder_and_assign"]


@pytest.mark.parametrize("name", BUILDERS)
def test_builder_program_equals_jax(name):
    p, j = _builder_program(pt, name), _builder_program(fluid, name)
    assert name in [op.type for op in p.global_block().ops]
    assert p.serialize_to_string() == j.serialize_to_string()


# ---------------------------------------------------------------------------
# a RetinaNet head
# ---------------------------------------------------------------------------

def _retina(fl):
    fl.framework.unique_name.reset()
    main, startup, loss, levels = cs.retinanet_train(fl)
    main.random_seed = startup.random_seed = 3
    return main, startup, loss, levels


def _retina_feeds(n, fl=pt):
    out = []
    for s in range(n):
        f = cs._retina_batch(pt, s, pt.CPUPlace(), B=2)
        if fl is fluid:
            f = {k: (fluid.create_lod_tensor(
                np.asarray(v), [np.diff(v.lod()[0]).tolist()],
                fluid.CPUPlace())
                     if hasattr(v, "lod") else v.numpy())
                 for k, v in f.items()}
        out.append(f)
    return out


def jax_start_state(jstart, jmain):
    """Run the JAX package's startup, then commit every persistable to
    the CPU device, as a step's outputs are: the startup leaves its
    outputs uncommitted, and a step on uncommitted parameters compiles
    again on the next step's committed ones. Returns (scope, executor,
    {persistable: numpy value})."""
    jscope, jexe = JaxScope(), fluid.Executor(fluid.CPUPlace())
    jexe.run(jstart, scope=jscope)
    state = {}
    for v in jmain.global_block().vars.values():
        var = jscope.find_var(v.name) if v.persistable else None
        if var is not None:
            t = var.get_tensor()
            state[v.name] = np.asarray(t)
            t.set(state[v.name], fluid.CPUPlace())
    return jscope, jexe, state


def test_retinanet_head_matches_jax():
    jmain, jstart, jloss, _ = _retina(fluid)
    pmain, pstart, ploss, levels = _retina(pt)
    types = [op.type for op in pmain.global_block().ops]
    for t in ("anchor_generator", "retinanet_target_assign",
              "sigmoid_focal_loss", "gather", "smooth_l1_loss"):
        assert t in types, t
    assert pmain.serialize_to_string() == jmain.serialize_to_string()
    assert pstart.serialize_to_string() == jstart.serialize_to_string()
    jscope, jexe, state = jax_start_state(jstart, jmain)
    pscope, pexe = pt.Scope(), pt.Executor(pt.CPUPlace())
    pexe.run(pstart, scope=pscope)
    load_params_from_numpy(pscope, state, pt.CPUPlace())
    jl = [float(np.asarray(jexe.run(jmain, feed=f, fetch_list=[jloss],
                                    scope=jscope)[0]).reshape(-1)[0])
          for f in _retina_feeds(3, fluid)]
    feeds = _retina_feeds(3)
    pl = [float(np.asarray(pexe.run(pmain, feed=f, fetch_list=[ploss],
                                    scope=pscope)[0]).reshape(-1)[0])
          for f in feeds]
    assert all(np.isfinite(pl)) and pl[-1] != pl[0]
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)
    assert not pexe._engine.eager_reasons
    det, out = cs.retinanet_detect(pt, pmain, levels)
    f = {k: feeds[0][k] for k in ("image", "im_info")}
    c0 = pexe._engine.counters["captures"]    # 0: three LoDs, one run each
    rows = [pexe.run(det, feed=f, fetch_list=[out], scope=pscope,
                     return_numpy=False)[0] for _ in range(3)]
    assert pexe._engine.counters["captures"] == c0 + 1
    assert not pexe._engine.eager_reasons
    r = np.asarray(rows[0])
    assert r.shape == (2 * cs.RETINA_DET["keep_top_k"], 6)
    assert rows[0].lod() == [[0, 100, 200]] and (r[:, 0] >= 0).any()
    for o in rows[1:]:
        np.testing.assert_array_equal(np.asarray(o), r)


# ---------------------------------------------------------------------------
# C.1: gather, scatter and gather_nd out of range
# ---------------------------------------------------------------------------

def _both_ops(op_type, inputs, outs, attrs, diff=()):
    """The op's forward in both packages, then (with `diff`) both grad
    ops under a cotangent of Out."""
    jenv, _ = _jax_forward(op_type, inputs, {}, attrs, outs)
    port, _ = family_cases.run(op_type, inputs, attrs,
                               {s: len(n) for s, n in outs.items()}, "cpu")
    grads = _grads(op_type, inputs, {}, attrs, outs, jenv, diff) \
        if diff else None
    return jenv, port, grads


@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_gather_out_of_range_matches_jnp_take(dtype):
    n = 4
    x = (np.arange(12).reshape(n, 3) * 1.5).astype(dtype)
    idx = np.array([-1, -n, n, 0], np.int32)
    jenv, port, grads = _both_ops(
        "gather", {"X": x, "Index": idx}, {"Out": ["out_out0"]}, {},
        ["X"] if dtype == "float32" else ())
    p, j = port["out_out0"].numpy(), np.asarray(jenv["out_out0"])
    np.testing.assert_array_equal(p, j)         # NaN == NaN here
    np.testing.assert_array_equal(
        np.asarray(jnp.take(jnp.asarray(x), jnp.asarray(idx), axis=0)), p)
    fill = np.nan if dtype == "float32" else np.iinfo(np.int32).min
    np.testing.assert_array_equal(p[2], np.full(3, fill, dtype))
    np.testing.assert_array_equal(p[[0, 1, 3]], x[[3, 0, 0]])
    if grads:
        jg, pg, cot = grads
        _check(jg["x@g"], pg["x@g"], "gather X@GRAD")
        g = cot["Out"]
        np.testing.assert_allclose(pg["x@g"].numpy(), np.stack(
            [g[1] + g[3], 0 * g[0], 0 * g[0], g[0]]), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dtype, port_type", [
    ("int32", torch.int32), ("int8", torch.int32), ("int16", torch.int32),
    ("bool", torch.int32), ("uint8", torch.int64)])
def test_reduce_sum_keeps_an_int_type(dtype, port_type):
    """reduce_sum of an int32 tensor (RetinaNet's foreground count) is
    int32 in both packages; the port's was int64. Narrower types widen as
    jnp.sum widens them, so a sum past the type's range does not wrap:
    to int32, and uint8 to int64 where JAX's is uint32 (torch has no
    uint32 sum)."""
    x = (np.array([[100], [0], [120]]) if dtype != "bool"
         else np.array([[1], [0], [1]])).astype(dtype)
    if dtype == "uint8":
        x = x * 2
    for attrs in ({"reduce_all": True}, {"dim": [0], "keep_dim": True}):
        jenv, port, _ = _both_ops("reduce_sum", {"X": x},
                                  {"Out": ["out_out0"]}, attrs)
        p, j = port["out_out0"], np.asarray(jenv["out_out0"])
        assert p.dtype == port_type
        assert int(j.reshape(-1)[0]) == int(x.astype(np.int64).sum())
        np.testing.assert_array_equal(p.numpy(), j)


def test_scatter_and_gather_nd_out_of_range_match_jax():
    r = np.random.default_rng(1)
    x = r.standard_normal((4, 3)).astype(np.float32)
    for overwrite in (True, False):
        inputs = {"X": x, "Ids": np.array([-1, 5, 0, -6], np.int32),
                  "Updates": r.standard_normal((4, 3)).astype(np.float32)}
        jenv, port, (jg, pg, _) = _both_ops(
            "scatter", inputs, {"Out": ["out_out0"]},
            {"overwrite": overwrite}, ["X", "Updates"])
        _check(jenv["out_out0"], port["out_out0"], "scatter Out")
        for name in jg:
            _check(jg[name], pg[name], f"scatter {name}")
    x3 = r.standard_normal((2, 3, 4)).astype(np.float32)
    idx = np.array([[1, -1], [0, 3], [-3, 0], [2, 0], [-2, -3]], np.int64)
    jenv, port, (jg, pg, _) = _both_ops(
        "gather_nd", {"X": x3, "Index": idx}, {"Out": ["out_out0"]}, {},
        ["X"])
    _check(jenv["out_out0"], port["out_out0"], "gather_nd Out")
    _check(jg["x@g"], pg["x@g"], "gather_nd X@GRAD")


# ---------------------------------------------------------------------------
# C.2: top_k's gradient and its K input
# ---------------------------------------------------------------------------

def test_top_k_gradient_matches_jax():
    x = np.random.default_rng(2).standard_normal((3, 7)).astype(np.float32)
    jenv, port, (jg, pg, cot) = _both_ops(
        "top_k", {"X": x}, {"Out": ["out_out0"],
                            "Indices": ["indices_out0"]}, {"k": 3}, ["X"])
    _check(jenv["out_out0"], port["out_out0"], "top_k Out")
    _check(jenv["indices_out0"], port["indices_out0"], "top_k Indices")
    _check(jg["x@g"], pg["x@g"], "top_k X@GRAD")
    want = np.zeros_like(x)
    np.put_along_axis(want, port["indices_out0"].numpy(), cot["Out"], -1)
    np.testing.assert_array_equal(pg["x@g"].numpy(), want)


def _top_k_program(fl, k_input):
    L = fl.layers
    fl.framework.unique_name.reset()
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        x = L.data("x", [7], dtype="float32")
        x.stop_gradient = False
        h = L.fc(x, 7)
        if k_input:
            k = L.data("k", [1], dtype="int32", append_batch_size=False)
            helper = fl.layer_helper.LayerHelper("top_k")
            vals = helper.create_variable_for_type_inference("float32")
            ids = helper.create_variable_for_type_inference("int64", True)
            main.global_block().append_op(
                "top_k", inputs={"X": h, "K": k},
                outputs={"Out": vals, "Indices": ids}, attrs={"k": 1},
                infer_shape=False)
        else:
            vals, _ = L.topk(h, 3)
        loss = L.mean(vals)
        fl.optimizer.SGD(0.1).minimize(loss)
    return main, startup, vals, loss


def test_top_k_program_gradient_matches_jax():
    """append_backward through top_k in both packages: the same program
    (but for the Indices var, int32 in the JAX package without 64-bit
    types), the same fc gradient step (the updated weights within
    TOL)."""
    jm, js, _, jloss = _top_k_program(fluid, False)
    pm, ps, _, ploss = _top_k_program(pt, False)
    assert "top_k_grad" in [op.type for op in pm.global_block().ops]
    assert _widen_desc(jm.serialize_to_string(), pm.serialize_to_string(),
                       ("top_k",)) == pm.serialize_to_string()
    x = np.random.default_rng(3).standard_normal((4, 7)).astype(np.float32)
    jscope, jexe = JaxScope(), fluid.Executor(fluid.CPUPlace())
    jexe.run(js, scope=jscope)
    w = {p.name: np.asarray(jscope.find_var(p.name).get_tensor())
         for p in jm.all_parameters()}
    pscope, pexe = pt.Scope(), pt.Executor(pt.CPUPlace())
    pexe.run(ps, scope=pscope)
    load_params_from_numpy(pscope, w, pt.CPUPlace())
    jexe.run(jm, feed={"x": x}, fetch_list=[jloss], scope=jscope)
    pexe.run(pm, feed={"x": x}, fetch_list=[ploss], scope=pscope)
    for name in w:
        np.testing.assert_allclose(
            np.asarray(pscope.find_var(name).get_tensor().tensor),
            np.asarray(jscope.find_var(name).get_tensor()), rtol=TOL,
            atol=TOL, err_msg=name)


@pytest.mark.parametrize("k_input", [True, False])
def test_top_k_input_keeps_its_block_eager(k_input):
    main, startup, vals, loss = _top_k_program(pt, k_input)
    x = np.random.default_rng(4).standard_normal((4, 7)).astype(np.float32)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    feed = {"x": x, "k": np.array([2], np.int32)} if k_input else {"x": x}
    got = [exe.run(main, feed=feed, fetch_list=[vals], scope=scope)[0]
           for _ in range(3)]
    c = exe._engine.counters
    reasons = set(exe._engine.eager_reasons.values())
    assert [np.asarray(g).shape for g in got] == \
        [(4, 2 if k_input else 3)] * 3
    if k_input:
        assert reasons == {"top_k"} and c["captures"] == 0
    else:
        assert not reasons and c["captures"] == 1
