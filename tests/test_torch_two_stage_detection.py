"""The two-stage detectors' ops and layers in the port against the JAX
package.

* Every case of ops/family_cases.py's two_stage_cases() (roi_align with a
  RoI past the map's edge and one under a pixel; roi_pool with an empty
  bin and tied values; psroi_pool; roi_perspective_transform;
  generate_proposals with min_size filtering, eta 1 and eta < 1;
  rpn_target_assign with a single-box image, a crowd box and two boxes
  on one anchor; generate_proposal_labels at ImInfo scales 1 and 2;
  generate_mask_labels; distribute_fpn_proposals; collect_fpn_proposals)
  through the port's lowering (family_cases.run) and the JAX lowering on
  the same seeded inputs, outputs and output LoDs, and both `<op>_grad`
  lowerings (the generic vjp in each) under one random cotangent of
  every float output where the op has a gradient. Tolerance TOL = 1e-5
  relative and absolute (float32; libm and the order of sums differ),
  integers exactly. Three departures are held to numpy reckonings of the
  reference's rule instead: roi_pool's Argmax (the flat index of each
  bin's first maximum, -1 for an empty bin; the JAX lowering writes
  zeros), rpn_target_assign where a crowd box and a non-crowd box pick
  one anchor (positive: the non-crowd box forces it; the JAX lowering's
  duplicate scatter writes leave it to their order) and
  generate_mask_labels at two images (each RoI matched within its own
  image; the JAX lowering matches across them).
* use_random draws samples from the masks, the same ones for the same
  generator seed.
* Each of the ten builders builds the JAX package's ProgramDesc byte for
  byte.
* A program of each op, fed a LoD where the op reads one, captures on
  the CPU (no eager reason; replays equal eager runs).
"""
import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.core.registry import OPS as JAX_OPS

import paddle_tpu_torch as pt
from paddle_tpu_torch.core.registry import OPS as PT_OPS
from paddle_tpu_torch.ops import family_cases

from test_torch_book import _widen_desc
from test_torch_one_stage_detection import (_grads, _jax_forward,
                                            _out_names)
from test_torch_op_families import _check
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5
CASES = family_cases.two_stage_cases()
IDS = [f"{c[0]}-{i}" for i, c in enumerate(CASES)]
F32 = np.float32


def _port(case):
    op_type, inputs, lods, attrs, out_slots, _ = case
    return family_cases.run(op_type, inputs, attrs, out_slots, "cpu", lods)


def _conflict(case):
    """The rpn_target_assign case whose crowd and non-crowd boxes pick
    one anchor."""
    if case[0] != "rpn_target_assign" or "gtboxes" not in case[2]:
        return False
    ins, attrs = case[1], case[3]
    offs = case[2]["gtboxes"][0]
    for b, (s, e) in enumerate(zip(offs[:-1], offs[1:])):
        picks = _rpn_picks(ins["Anchor"].reshape(-1, 4), ins["GtBoxes"][s:e],
                           ins["IsCrowd"].reshape(-1)[s:e], ins["ImInfo"][b],
                           attrs["rpn_straddle_thresh"])
        crowd = ins["IsCrowd"].reshape(-1)[s:e] != 0
        if set(picks[crowd]) & set(picks[~crowd]):
            return True
    return False


def _two_images(case):
    return case[0] == "generate_mask_labels" and \
        len(case[2]["rois"][0]) > 2


# ---------------------------------------------------------------------------
# numpy reckonings of the reference's rules
# ---------------------------------------------------------------------------

def _np_iou(a, b):
    """IoU [N, M] of pixel boxes (+1 sizes), float32 in the lowerings'
    order of operations."""
    one = F32(1.0)
    area_a = (a[:, 2] - a[:, 0] + one) * (a[:, 3] - a[:, 1] + one)
    area_b = (b[:, 2] - b[:, 0] + one) * (b[:, 3] - b[:, 1] + one)
    iw = np.maximum(np.minimum(a[:, None, 2], b[None, :, 2]) -
                    np.maximum(a[:, None, 0], b[None, :, 0]) + one, F32(0))
    ih = np.maximum(np.minimum(a[:, None, 3], b[None, :, 3]) -
                    np.maximum(a[:, None, 1], b[None, :, 1]) + one, F32(0))
    inter = iw * ih
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / union, F32(0)).astype(F32)


def _inside(anchors, info, straddle):
    return (anchors[:, 0] >= -straddle) & (anchors[:, 1] >= -straddle) & \
        (anchors[:, 2] < info[1] + straddle) & \
        (anchors[:, 3] < info[0] + straddle)


def _rpn_picks(anchors, gt, crowd, info, straddle):
    """Each box's best inside anchor (IoU 0 for a crowd box: the first
    inside anchor)."""
    iou = np.where((crowd == 0)[None, :], _np_iou(anchors, gt), F32(0))
    inside = _inside(anchors, info, straddle)
    return np.argmax(np.where(inside[:, None], iou, F32(-1)), axis=0)


def rpn_targets_numpy(case):
    """rpn_target_assign's five outputs by the reference's rule, with
    use_random=False: an anchor is positive where a non-crowd box picks
    it, whatever a crowd box does there."""
    _, ins, lods, attrs, _, _ = case
    anchors = ins["Anchor"].reshape(-1, 4)
    m = anchors.shape[0]
    batch = attrs["rpn_batch_size_per_im"]
    n_fg = int(batch * attrs["rpn_fg_fraction"])
    offs = lods["gtboxes"][0]
    loc, score, label, tbox = [], [], [], []
    for b, (s, e) in enumerate(zip(offs[:-1], offs[1:])):
        gt, crowd = ins["GtBoxes"][s:e], ins["IsCrowd"].reshape(-1)[s:e]
        info, st = ins["ImInfo"][b], attrs["rpn_straddle_thresh"]
        iou = np.where((crowd == 0)[None, :], _np_iou(anchors, gt), F32(0))
        best, best_gt = iou.max(1), iou.argmax(1)
        inside = _inside(anchors, info, st)
        pos = (best >= F32(attrs["rpn_positive_overlap"])) & inside
        picks = _rpn_picks(anchors, gt, crowd, info, st)
        pos[picks[crowd == 0]] = True
        neg = (best < F32(attrs["rpn_negative_overlap"])) & inside & ~pos
        fg = np.full(n_fg, -1)
        bg = np.full(batch - n_fg, -1)
        got = np.flatnonzero(pos)[:n_fg]
        fg[:len(got)] = got
        got = np.flatnonzero(neg)[:batch - n_fg]
        bg[:len(got)] = got
        both = np.concatenate([fg, bg])
        loc.append(np.where(fg >= 0, fg + b * m, -1))
        score.append(np.where(both >= 0, both + b * m, -1))
        label.append(np.concatenate([np.where(fg >= 0, 1, -1),
                                     np.where(bg >= 0, 0, -1)]))
        a = anchors[np.maximum(fg, 0)].astype(np.float64)
        g = gt[best_gt[np.maximum(fg, 0)]].astype(np.float64)
        aw, ah = a[:, 2] - a[:, 0] + 1, a[:, 3] - a[:, 1] + 1
        gw, gh = g[:, 2] - g[:, 0] + 1, g[:, 3] - g[:, 1] + 1
        t = np.stack([((g[:, 2] + g[:, 0]) / 2 - (a[:, 0] + aw / 2)) / aw,
                      ((g[:, 3] + g[:, 1]) / 2 - (a[:, 1] + ah / 2)) / ah,
                      np.log(gw / aw), np.log(gh / ah)], axis=1)
        tbox.append(t * (fg >= 0)[:, None])
    w = (np.concatenate(loc) >= 0).astype(F32)
    return {"locationindex_out0": np.concatenate(loc)[:, None],
            "scoreindex_out0": np.concatenate(score)[:, None],
            "targetlabel_out0": np.concatenate(label)[:, None],
            "targetbbox_out0": np.concatenate(tbox),
            "bboxinsideweight_out0": np.repeat(w[:, None], 4, axis=1)}


def mask_labels_numpy(case):
    """generate_mask_labels' MaskInt32 with each RoI matched within its
    own image (the LoDs of Rois and GtSegms), float32 in the lowering's
    order of operations."""
    _, ins, lods, attrs, _, _ = case
    rois, segs = ins["Rois"], ins["GtSegms"]
    lab = ins["LabelsInt32"].reshape(-1)
    classes, res = attrs["num_classes"], attrs["resolution"]
    ro, so = lods["rois"][0], lods["gtsegms"][0]
    out = np.zeros((rois.shape[0], classes * res * res), np.int32)
    grid = (np.arange(res, dtype=F32) + F32(0.5)) / F32(res)
    for b in range(len(ro) - 1):
        own = segs[so[b]:so[b + 1]]
        for i in range(ro[b], ro[b + 1]):
            g = own[np.argmax(_np_iou(rois[i:i + 1], own)[0])]
            rw = max(rois[i, 2] - rois[i, 0], F32(1))
            rh = max(rois[i, 3] - rois[i, 1], F32(1))
            gx = rois[i, 0] + grid * rw
            gy = rois[i, 1] + grid * rh
            inside = (gx[None, :] >= g[0]) & (gx[None, :] <= g[2]) & \
                (gy[:, None] >= g[1]) & (gy[:, None] <= g[3])
            if lab[i] > 0:
                out[i, lab[i] * res * res:(lab[i] + 1) * res * res] = \
                    inside.reshape(-1)
    return out


def roi_pool_argmax_numpy(case):
    """roi_pool's Argmax: the flat h * W + w index of each bin's first
    maximum in row-major order, -1 for an empty bin; the bins of the
    lowering (float32 corners, rounded half to even)."""
    _, ins, lods, attrs, _, _ = case
    x, rois = ins["X"], ins["ROIs"]
    ph, pw = attrs["pooled_height"], attrs["pooled_width"]
    _, c, h, w = x.shape
    offs = lods.get("rois", [[0, rois.shape[0]]])[0]
    out = np.full((rois.shape[0], c, ph, pw), -1, np.int64)
    for b in range(len(offs) - 1):
        for r in range(offs[b], offs[b + 1]):
            x1, y1, x2, y2 = np.round(rois[r] * F32(attrs["spatial_scale"]))
            bw = max(x2 - x1 + F32(1), F32(1)) / F32(pw)
            bh = max(y2 - y1 + F32(1), F32(1)) / F32(ph)

            def cells(start, size, p, n):
                lo = np.floor(start + F32(p) * size)
                hi = np.ceil(start + F32(p + 1) * size)
                return [j for j in range(n) if lo <= j < hi]
            for p in range(ph):
                ys = cells(y1, bh, p, h)
                for q in range(pw):
                    xs = cells(x1, bw, q, w)
                    if not ys or not xs:
                        continue
                    for ch in range(c):
                        k = int(np.argmax(x[b, ch][np.ix_(ys, xs)]))
                        out[r, ch, p, q] = ys[k // len(xs)] * w + \
                            xs[k % len(xs)]
    return out


# ---------------------------------------------------------------------------
# the ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_two_stage_op_matches_jax(case):
    op_type, inputs, lods, attrs, out_slots, diff = case
    names = _out_names(out_slots)
    port, plod = _port(case)
    if _conflict(case):
        want = rpn_targets_numpy(case)
        for n, v in want.items():
            _check(v.astype(port[n].numpy().dtype), port[n], f"{op_type} {n}")
        return
    if _two_images(case):
        np.testing.assert_array_equal(port["maskint32_out0"].numpy(),
                                      mask_labels_numpy(case))
        np.testing.assert_array_equal(port["maskrois_out0"].numpy(),
                                      inputs["Rois"])
        np.testing.assert_array_equal(
            port["roihasmaskint32_out0"].numpy()[:, 0],
            (inputs["LabelsInt32"][:, 0] > 0).astype(np.int32))
        return
    jenv, jl = _jax_forward(op_type, inputs, lods, attrs, names, cache=True)
    for ns in names.values():
        for n in ns:
            if op_type == "roi_pool" and n == "argmax_out0":
                np.testing.assert_array_equal(port[n].numpy(),
                                              roi_pool_argmax_numpy(case))
                continue
            _check(jenv[n], port[n], f"{op_type} {n}")
            assert jl.get(n) == plod[n], n
    if diff:
        jg, pg, _ = _grads(op_type, inputs, lods, attrs, names, jenv, diff)
        for n in jg:
            _check(jg[n], pg[n], f"{op_type} {n}")


def test_numpy_reckonings_equal_jax_without_the_departures():
    """The rpn and mask reckonings equal the JAX lowering where the rules
    agree: the first rpn case (no crowd box shares an anchor) and the
    mask case at one image."""
    kinds = [c[0] for c in CASES]
    rpn = CASES[kinds.index("rpn_target_assign")]
    assert not _conflict(rpn)
    jenv, _ = _jax_forward(rpn[0], rpn[1], rpn[2], rpn[3],
                           _out_names(rpn[4]), cache=True)
    for n, v in rpn_targets_numpy(rpn).items():
        np.testing.assert_allclose(np.asarray(jenv[n]), v, rtol=TOL,
                                   atol=TOL, err_msg=n)
    one = CASES[kinds.index("generate_mask_labels")]
    assert not _two_images(one)
    jenv, _ = _jax_forward(one[0], one[1], one[2], one[3],
                           _out_names(one[4]), cache=True)
    np.testing.assert_array_equal(np.asarray(jenv["maskint32_out0"]),
                                  mask_labels_numpy(one))


def test_two_stage_cases_are_not_trivial():
    """The cases reach what they name: empty and tied roi_pool bins,
    padded and filtered proposals and an NMS that suppresses, forced and
    sampled anchors, a conflicting crowd box, foreground RoIs, masks
    that differ across images, FPN rows on several levels."""
    kinds = [c[0] for c in CASES]
    pool = _port(CASES[kinds.index("roi_pool")])[0]
    arg = pool["argmax_out0"].numpy()
    assert (arg == -1).any() and (arg >= 0).any()
    relu = CASES[kinds.index("roi_pool") + 1]
    # a bin of relu zeros only: its gradient splits over the ties
    assert (_port(relu)[0]["out_out0"].numpy() == 0).any()
    for i in (0, 1):
        case = CASES[kinds.index("generate_proposals") + i]
        rois = _port(case)[0]["rpnrois_out0"].numpy()
        probs = _port(case)[0]["rpnroiprobs_out0"].numpy()
        assert (probs > 0).any() and (probs == 0).any(), i
        assert (rois == 0).all(-1).any()
    rpn = [c for c in CASES if c[0] == "rpn_target_assign"]
    assert [_conflict(c) for c in rpn] == [False, False, True]
    jenv, _ = _jax_forward(rpn[2][0], rpn[2][1], rpn[2][2], rpn[2][3],
                           _out_names(rpn[2][4]))
    assert not np.array_equal(np.asarray(jenv["locationindex_out0"]),
                              _port(rpn[2])[0]["locationindex_out0"].numpy())
    label = _port(rpn[0])[0]["targetlabel_out0"].numpy()
    assert (label == 1).any() and (label == 0).any()
    pl = _port(CASES[kinds.index("generate_proposal_labels")])[0]
    lab = pl["labelsint32_out0"].numpy()
    assert (lab > 0).any() and (lab == 0).any()
    assert (pl["bboxinsideweights_out0"].numpy() > 0).any()
    two = CASES[kinds.index("generate_mask_labels") + 1]
    jenv, _ = _jax_forward(two[0], two[1], two[2], two[3],
                           _out_names(two[4]))
    assert not np.array_equal(np.asarray(jenv["maskint32_out0"]),
                              mask_labels_numpy(two))
    fpn = _port(CASES[kinds.index("distribute_fpn_proposals")])[0]
    restore = fpn["restoreindex_out0"].numpy().reshape(4, -1)
    assert ((restore >= 0).sum(1) > 0).sum() >= 3
    assert sorted(restore[restore >= 0].tolist()) == list(range(8))


def test_two_stage_ops_are_registered():
    """The ten op types are registered in the port, each with a case, a
    gradient op where the JAX package has one; the port registers 323 of
    the JAX package's 382 forward op types (267 with these ten, then
    slice 24's eleven, slice 25's nineteen and slice 26's
    twenty-six)."""
    ten = {"roi_align", "roi_pool", "psroi_pool",
           "roi_perspective_transform", "generate_proposals",
           "rpn_target_assign", "generate_proposal_labels",
           "generate_mask_labels", "distribute_fpn_proposals",
           "collect_fpn_proposals"}
    assert ten == {c[0] for c in CASES}
    for t in ten:
        assert PT_OPS.has(t) and \
            PT_OPS.has(t + "_grad") == JAX_OPS.has(t + "_grad"), t

    def forward(ops):
        return {t for t in ops.types() if not ops.get(t).is_grad_op}
    assert len(forward(PT_OPS)) == 323 and len(forward(JAX_OPS)) == 382
    assert forward(PT_OPS) <= forward(JAX_OPS)


def test_use_random_samples_from_the_masks():
    """With use_random, rpn_target_assign and generate_proposal_labels
    sample from the same masks (as many samples, each one positive /
    foreground where the first-in-order sampling has one there), and the
    same generator seed draws the same samples."""
    kinds = [c[0] for c in CASES]
    for kind, slot in (("rpn_target_assign", "targetlabel_out0"),
                       ("generate_proposal_labels", "labelsint32_out0")):
        case = list(CASES[kinds.index(kind)])
        case[3] = dict(case[3], use_random=True)
        base = _port(CASES[kinds.index(kind)])[0]
        a, b = _port(case)[0], _port(case)[0]
        for n in a:
            np.testing.assert_array_equal(a[n].numpy(), b[n].numpy())
        lab, want = a[slot].numpy(), base[slot].numpy()
        np.testing.assert_array_equal(lab >= 0, want >= 0)
        np.testing.assert_array_equal(lab > 0, want > 0)
        if kind == "rpn_target_assign":
            pos = a["locationindex_out0"].numpy()
            assert set(pos[pos >= 0].tolist()) <= set(
                a["scoreindex_out0"].numpy().reshape(-1).tolist())


def test_roi_align_in_blocks_of_rois_equals_one_block(monkeypatch):
    """roi_align gathers its samples for a block of RoIs at a time: with
    a block of one RoI (four blocks) the output equals one block's bit
    for bit, the gradient within TOL (the blocks' accumulates add in
    another order)."""
    from paddle_tpu_torch.ops import detection
    case = CASES[0]
    names = _out_names(case[4])
    whole, _ = _port(case)
    _, g_whole, _ = _grads(case[0], case[1], case[2], case[3], names, whole,
                           case[5], with_jax=False)
    monkeypatch.setattr(detection, "_SAMPLES_AT_ONCE", 1)
    blocks, _ = _port(case)
    _, g_blocks, _ = _grads(case[0], case[1], case[2], case[3], names,
                            blocks, case[5], with_jax=False)
    assert case[1]["ROIs"].shape[0] == 4
    np.testing.assert_array_equal(blocks["out_out0"].numpy(),
                                  whole["out_out0"].numpy())
    np.testing.assert_allclose(g_blocks["x@g"].numpy(),
                               g_whole["x@g"].numpy(), rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# the builders
# ---------------------------------------------------------------------------

def _builder_program(fl, name):
    L = fl.layers
    fl.framework.unique_name.reset()
    main = fl.Program()
    with fl.program_guard(main, fl.Program()):
        def data(n, shape, dtype="float32", lod=0, batch=True):
            return L.data(n, shape, dtype=dtype, lod_level=lod,
                          append_batch_size=batch)
        feat = data("feat", [4, 6, 7])
        rois = data("rois", [4], lod=1)
        info = data("info", [3])
        if name == "roi_align":
            L.roi_align(feat, rois, 2, 2, 0.5, -1)
        elif name == "roi_pool":
            L.roi_pool(feat, rois, 2, 3, 0.5)
        elif name == "psroi_pool":
            L.psroi_pool(data("ps", [8, 5, 6]), rois, 2, 0.5, 2, 2)
        elif name == "roi_perspective_transform":
            L.roi_perspective_transform(feat, data("quads", [8], lod=1), 3,
                                        4, 0.5)
        elif name == "generate_proposals":
            L.generate_proposals(
                data("scores", [3, 3, 4]), data("deltas", [12, 3, 4]), info,
                data("anchors", [3, 4, 3, 4], batch=False),
                data("var", [3, 4, 3, 4], batch=False), pre_nms_top_n=20,
                post_nms_top_n=8, nms_thresh=0.5, min_size=2.0, eta=0.9)
        elif name == "rpn_target_assign":
            L.rpn_target_assign(
                data("bp", [40, 4]), data("cl", [40, 1]),
                data("an", [40, 4], batch=False),
                data("av", [40, 4], batch=False), data("gt", [4], lod=1),
                data("crowd", [1], "int32", lod=1), info,
                rpn_batch_size_per_im=8, use_random=False)
        elif name == "generate_proposal_labels":
            L.generate_proposal_labels(
                rois, data("cls", [1], "int32", lod=1),
                data("crowd", [1], "int32", lod=1), data("gt", [4], lod=1),
                info, batch_size_per_im=8, fg_thresh=0.5, class_nums=5,
                use_random=False)
        elif name == "generate_mask_labels":
            L.generate_mask_labels(
                info, data("cls", [1], "int32", lod=1),
                data("crowd", [1], "int32", lod=1),
                data("segms", [4], lod=1), rois,
                data("labels", [1], "int32", lod=1), 4, 4)
        elif name == "distribute_fpn_proposals":
            L.distribute_fpn_proposals(data("fpn", [4]), 2, 5, 4, 224)
        else:
            L.collect_fpn_proposals(
                [data(f"r{i}", [4]) for i in range(3)],
                [data(f"s{i}", [1]) for i in range(3)], 2, 4, 6)
    return main


BUILDERS = ["roi_align", "roi_pool", "psroi_pool",
            "roi_perspective_transform", "generate_proposals",
            "rpn_target_assign", "generate_proposal_labels",
            "generate_mask_labels", "distribute_fpn_proposals",
            "collect_fpn_proposals"]


@pytest.mark.parametrize("name", BUILDERS)
def test_builder_program_equals_jax(name):
    """(roi_pool's Argmax var: int64 as the builder declares it, where
    the JAX package's build-time inference writes its lowering's int32.)"""
    p, j = _builder_program(pt, name), _builder_program(fluid, name)
    assert name in [op.type for op in p.global_block().ops]
    mine = p.serialize_to_string()
    theirs = j.serialize_to_string()
    if name == "roi_pool":
        theirs = _widen_desc(theirs, mine, ("roi_pool",))
    assert mine == theirs


# ---------------------------------------------------------------------------
# capture
# ---------------------------------------------------------------------------

CAPTURED = {}
for _c in CASES:
    CAPTURED.setdefault(_c[0], _c)


def _case_program(case):
    """A program of the case's op alone: a data var an input (its shape
    fixed, a LoD level where the case gives one), the case's attrs; and
    its feed (LoD tensors where a LoD applies)."""
    op_type, inputs, lods, attrs, out_slots, _ = case
    main, feed = pt.Program(), {}
    block = main.global_block()
    ins = {}
    with pt.program_guard(main, pt.Program()):
        for slot, v in inputs.items():
            vals = v if isinstance(v, list) else [v]
            names = family_cases._names(slot, v)
            ins[slot] = []
            for n, a in zip(names, vals):
                a = np.ascontiguousarray(a)
                lod = lods.get(n)
                ins[slot].append(pt.layers.data(
                    n, list(a.shape), dtype=str(a.dtype),
                    lod_level=1 if lod else 0, append_batch_size=False))
                feed[n] = pt.create_lod_tensor(
                    a, [np.diff(lod[0]).tolist()], pt.CPUPlace()) \
                    if lod else a
        outs = {s: [block.create_var(name=f"{s.lower()}_{i}")
                    for i in range(k)] for s, k in out_slots.items()}
        block.append_op(op_type, inputs=ins, outputs=outs, attrs=attrs)
    return main, feed, [v for vs in outs.values() for v in vs]


def _lod(fetched):
    return fetched.lod() if hasattr(fetched, "lod") else []


@pytest.mark.parametrize("op_type", sorted(CAPTURED))
def test_op_program_captures(op_type):
    main, feed, fetch = _case_program(CAPTURED[op_type])
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    runs = [exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                    return_numpy=False) for _ in range(3)]
    eager = exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                    use_program_cache=False, return_numpy=False)
    c = exe._engine.counters
    assert not exe._engine.eager_reasons
    assert (c["captures"], c["replays"]) == (1, 2)
    for got in runs[1:]:
        for a, b in zip(got, eager):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            assert _lod(a) == _lod(b)
