"""SSD's detection ops, layers and evaluator in the port against the JAX
package.

* The eight ops (ops/family_cases.py detection_cases: three images of
  1, 4 and 2 boxes; a single-box image, ties across rows and along a
  row, a prior no box reaches 0.5, bipartite and per_prediction
  matching, target_assign with -1 NegIndices padding, mining with tied
  losses, NMS with a duplicate box, equal scores, eta < 1 and another
  background label, 11point and integral mAP) through both lowerings:
  values within TOL (float32; box_coder's log and exp differ between
  the two libms by up to 4.8e-7, every other op is exact) and integers
  and output LoDs equal. One LoD differs by design: an encoded
  box_coder output keeps TargetBox's LoD (the reference's ShareLoD),
  which the JAX lowering drops.
* An accumulated DetectionMAP evaluator over two batches equals the JAX
  package's, and its block stays eager with the reason in
  Engine.eager_reasons; the plain detection_map's block too.
* The builders: a tiny SSD (64x64, two feature maps, 288 priors, 5
  classes, a depthwise-separable block) and chip_smoke.mobilenet_ssd at
  Pascal VOC's widths (1917 priors, 21 classes) with ssd_loss and
  RMSProp(piecewise_decay) + L2Decay build the JAX package's ops but
  for one attr, ssd_loss's mining reshape2 `shape`: [-1, M] in the port,
  [1, -1] (the build-time batch) in the JAX package. With the JAX
  builder given the port's shape, the ProgramDescs are equal byte for
  byte (the cast outputs the JAX package writes int32 for want of
  64-bit types read as int64).
* The tiny SSD trains 3 steps at B=1 from the JAX package's parameters
  on the same VOC-shaped feeds: losses within LOSS_RTOL, persistables
  within RTOL / ATOL (batch norm and the convolutions sum in other
  orders; RMSProp's first steps divide by the gradients' own scale).
* At B=3 (where the JAX builder fails) the port's ssd_loss with
  normalize=False gives, prior for prior, the concatenation of the JAX
  package's B=1 losses of each image (TOL).
* detection_output at B=2 equals the JAX rows (the JAX builder fed the
  softmaxed scores: it leaves the reference's softmax out), and their
  mAP equals; AnalysisPredictor's rows equal the Executor's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as fluid
import paddle_tpu.layers as JL
from paddle_tpu.core.registry import ExecContext as JaxContext
from paddle_tpu.core.registry import OPS as JAX_OPS
from paddle_tpu.core.scope import Scope as JaxScope

import paddle_tpu_torch as pt
from paddle_tpu_torch.core.registry import ExecContext as PtContext
from paddle_tpu_torch.core.registry import OPS as PT_OPS
from paddle_tpu_torch.inference import AnalysisConfig, create_paddle_predictor
from paddle_tpu_torch.io import load_params_from_numpy
from paddle_tpu_torch.ops import family_cases

import chip_smoke
from test_torch_book import _widen_desc
from test_torch_sequence import CPU, _op
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5
LOSS_RTOL = 1e-5
RTOL, ATOL = 1e-4, 1e-6
CASES = family_cases.detection_cases()
M_TINY, C_TINY = 288, 5


# ---------------------------------------------------------------------------
# the ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_detection_op_matches_jax(case):
    op_type, inputs, lods, attrs, out_slots = case
    outs = {s: [s.lower() + "_out"] for s in out_slots}
    op, env = _op(op_type, inputs, outs, attrs)
    jenv = {n: jnp.asarray(a) for n, a in env.items()}
    penv = {n: torch.from_numpy(np.array(a)) for n, a in env.items()}
    jl, pl = dict(lods), dict(lods)
    JAX_OPS.get(op_type).lowering(JaxContext(op, jenv, None, None, jl))
    PT_OPS.get(op_type).lowering(PtContext(op, penv, CPU, None, pl))
    for (n,) in outs.values():
        j, p = np.asarray(jenv[n]), penv[n].numpy()
        assert j.shape == p.shape, (n, j.shape, p.shape)
        if np.issubdtype(j.dtype, np.floating):
            np.testing.assert_allclose(p, j, rtol=TOL, atol=TOL, err_msg=n)
        else:
            assert p.dtype == j.dtype, (n, p.dtype, j.dtype)
            np.testing.assert_array_equal(p, j, err_msg=n)
        if op_type == "box_coder" and "targetbox" in lods:
            assert jl.get(n) is None and pl[n] == lods["targetbox"]
        else:
            assert jl.get(n) == pl.get(n), n


def test_detection_cases_are_not_trivial():
    """The cases reach the paths they name: a per_prediction fill, a
    dropped -1 NegIndex, kept and padded NMS rows, a mAP between 0 and
    1."""
    def port(i):
        op_type, inputs, lods, attrs, out_slots = CASES[i]
        outs = {s: [s.lower() + "_out"] for s in out_slots}
        op, env = _op(op_type, inputs, outs, attrs)
        penv = {n: torch.from_numpy(np.array(a)) for n, a in env.items()}
        PT_OPS.get(op_type).lowering(PtContext(op, penv, CPU, None,
                                               dict(lods)))
        return [penv[outs[s][0]].numpy() for s in out_slots]

    kinds = [c[0] for c in CASES]
    bi = kinds.index("bipartite_match")
    assert ((port(bi + 1)[0] >= 0).sum() > (port(bi)[0] >= 0).sum())
    assert (port(bi)[0][:, 5] == -1).all()       # no box reaches prior 5
    ta = [i for i, k in enumerate(kinds) if k == "target_assign"][-1]
    assert port(ta)[1].sum() > port(ta - 2)[1].sum()
    labels = np.concatenate([port(i)[0][:, 0] for i, k in enumerate(kinds)
                             if k == "multiclass_nms"])
    assert (labels >= 0).any() and (labels == -1).any()
    for i in (i for i, k in enumerate(kinds) if k == "detection_map"):
        assert 0.0 < float(port(i)[0]) < 1.0


# ---------------------------------------------------------------------------
# the evaluator
# ---------------------------------------------------------------------------

def _map_program(fl, ap_version):
    L = fl.layers
    fl.framework.unique_name.reset()
    main = fl.Program()
    with fl.program_guard(main, fl.Program()):
        det = L.data("det", [6], dtype="float32", lod_level=1)
        lab = L.data("gt_label", [1], dtype="int32", lod_level=1)
        box = L.data("gt_box", [4], dtype="float32", lod_level=1)
        diff = L.data("difficult", [1], dtype="int32", lod_level=1)
        ev = fl.evaluator.DetectionMAP(det, lab, box, diff, class_num=4,
                                       overlap_threshold=0.5,
                                       evaluate_difficult=False,
                                       ap_version=ap_version)
    return main, ev


def _map_batches(fl, place):
    case = [c for c in CASES if c[0] == "detection_map"][0]
    det, lab = case[1]["DetectRes"], case[1]["Label"]
    dlod, llod = case[2]["detectres"], case[2]["label"]
    out = []
    for shift in (0.0, 0.1):
        d = det.copy()
        d[:, 2:] += shift
        if shift:
            d[:, 1] = d[::-1, 1]          # other scores, other matches
        out.append({
            "det": fl.create_lod_tensor(d, [np.diff(dlod[0]).tolist()],
                                        place),
            "gt_label": fl.create_lod_tensor(
                lab[:, :1].astype(np.int32), [np.diff(llod[0]).tolist()],
                place),
            "difficult": fl.create_lod_tensor(
                lab[:, 1:2].astype(np.int32), [np.diff(llod[0]).tolist()],
                place),
            "gt_box": fl.create_lod_tensor(lab[:, 2:], [np.diff(
                llod[0]).tolist()], place)})
    return out


@pytest.mark.parametrize("ap_version", ["11point", "integral"])
@pytest.mark.filterwarnings("ignore::UserWarning")
def test_detection_map_evaluator_matches_jax(ap_version):
    got = {}
    for name, fl, place in (("jax", fluid, fluid.CPUPlace()),
                            ("port", pt, pt.CPUPlace())):
        scope = (JaxScope if name == "jax" else pt.Scope)()
        with fl.scope_guard(scope):
            main, ev = _map_program(fl, ap_version)
            exe = fl.Executor(place)
            got[name] = [[float(np.asarray(v)) for v in exe.run(
                main, feed=f, fetch_list=list(ev.get_map_var()))]
                for f in _map_batches(fl, place)]
            if name == "port":
                ev.reset(exe)
                again = exe.run(main, feed=_map_batches(fl, place)[0],
                                fetch_list=list(ev.get_map_var()))
                reasons = list(exe._engine.eager_reasons.values())
    np.testing.assert_allclose(got["port"], got["jax"], rtol=1e-6)
    assert got["port"][0][0] == got["port"][0][1] == float(again[1])
    assert got["port"][1][1] != got["port"][1][0]     # accumulated
    assert reasons and reasons[0].startswith("state ")


def test_detection_map_block_stays_eager():
    """A program holding the plain detection_map op: its second run of a
    LoD keeps the block eager, the op named as the reason."""
    L = pt.layers
    pt.framework.unique_name.reset()
    main = pt.Program()
    with pt.program_guard(main, pt.Program()):
        det = L.data("det", [6], dtype="float32", lod_level=1)
        lab = L.data("lab", [6], dtype="float32", lod_level=1)
        m = L.detection_map(det, lab, class_num=4)
    case = [c for c in CASES if c[0] == "detection_map"][0]
    feed = {"det": pt.create_lod_tensor(case[1]["DetectRes"], [[2, 4, 3]],
                                        pt.CPUPlace()),
            "lab": pt.create_lod_tensor(case[1]["Label"], [[1, 4, 2]],
                                        pt.CPUPlace())}
    exe = pt.Executor(pt.CPUPlace())
    a, b = (float(exe.run(main, feed=feed, fetch_list=[m])[0])
            for _ in range(2))
    assert a == b and list(exe._engine.eager_reasons.values()) == \
        ["detection_map"]
    assert exe._engine.counters["captures"] == 0


# ---------------------------------------------------------------------------
# the builders and the tiny SSD
# ---------------------------------------------------------------------------

def _tiny_head(fl, img):
    """A 64x64 SSD: a conv, a depthwise-separable block, two stride-2
    convs to the 8x8 and 4x4 maps, multi_box_head (3 and 6 priors a
    cell: 288)."""
    L = fl.layers

    def conv_bn(x, n, k, s, p, groups=1):
        c = L.conv2d(x, n, k, stride=s, padding=p, groups=groups, act=None,
                     use_cudnn=False, bias_attr=False,
                     param_attr=fl.ParamAttr(
                         learning_rate=0.1,
                         initializer=fl.initializer.MSRA()))
        return L.batch_norm(c, act="relu")

    x = conv_bn(img, 8, 3, 2, 1)
    x = conv_bn(x, 8, 3, 1, 1, groups=8)
    x = conv_bn(conv_bn(x, 16, 1, 1, 0), 16, 3, 2, 1)
    m1 = conv_bn(x, 16, 3, 2, 1)
    m2 = conv_bn(m1, 16, 3, 2, 1)
    return L.multi_box_head([m1, m2], img, base_size=64,
                            num_classes=C_TINY,
                            aspect_ratios=[[2.], [2., 3.]],
                            min_sizes=[12.0, 28.0], max_sizes=[[], 48.0],
                            offset=0.5, flip=True)


def _ssd_program(fl, head_fn, image, num_classes, jax_shape=None):
    """(main, startup, loss, head): head_fn's net, ssd_loss summed,
    RMSProp(piecewise_decay) + L2Decay. With jax_shape, the JAX
    builder's mining reshape is given that shape."""
    L = fl.layers
    fl.framework.unique_name.reset()
    main, startup = fl.Program(), fl.Program()
    main.random_seed = startup.random_seed = 7
    orig = JL.reshape

    def reshape(x, shape, *a, **k):
        return orig(x, jax_shape if list(shape) == [1, -1] else shape,
                    *a, **k)

    if jax_shape is not None:
        JL.reshape = reshape
    try:
        with fl.program_guard(main, startup):
            img = L.data("img", [3, image, image], dtype="float32")
            gt_box = L.data("gt_box", [4], dtype="float32", lod_level=1)
            gt_label = L.data("gt_label", [1], dtype="int32", lod_level=1)
            head = head_fn(fl, img)
            loss = L.reduce_sum(L.ssd_loss(head[0], head[1], gt_box,
                                           gt_label, head[2], head[3]))
            lr = L.piecewise_decay([2], [1e-3, 5e-4])
            fl.optimizer.RMSProp(
                learning_rate=lr,
                regularization=fl.regularizer.L2Decay(5e-5)).minimize(loss)
    finally:
        JL.reshape = orig
    return main, startup, loss, head


def _same_but_reshape(pmain, jmain, num_priors):
    """Op for op equal but for the mining reshape2's shape attr."""
    pops, jops = pmain.global_block().ops, jmain.global_block().ops
    assert [o.type for o in pops] == [o.type for o in jops]
    differ = []
    for p, j in zip(pops, jops):
        assert (p._inputs, p._outputs) == (j._inputs, j._outputs), p.type
        if p.all_attrs() != j.all_attrs():
            differ.append((p.type, p.attr("shape"), j.attr("shape")))
    assert differ == [("reshape2", [-1, num_priors], [1, -1])]


def _mobilenet_head(fl, img):
    return chip_smoke.mobilenet_ssd(fl.layers, img, 21, 1.0)


@pytest.mark.parametrize("net", ["tiny", "mobilenet_ssd"])
def test_ssd_programs_match_jax(net):
    head_fn, image, classes, priors = {
        "tiny": (_tiny_head, 64, C_TINY, M_TINY),
        "mobilenet_ssd": (_mobilenet_head, 300, 21, 1917)}[net]
    pmain, pstart, _, head = _ssd_program(pt, head_fn, image, classes)
    assert int(head[2].shape[0]) == priors
    jmain, jstart, _, _ = _ssd_program(fluid, head_fn, image, classes)
    _same_but_reshape(pmain, jmain, priors)
    jmain, jstart, _, _ = _ssd_program(fluid, head_fn, image, classes,
                                       jax_shape=[-1, priors])
    mine = pmain.serialize_to_string()
    assert mine == _widen_desc(jmain.serialize_to_string(), mine,
                               ("cast",))
    assert pstart.serialize_to_string() == jstart.serialize_to_string()


def _voc_feed(fl, rng, B, place, image=64):
    """VOC-shaped: 1 to 4 boxes an image, labels 1..C-1."""
    lens = rng.integers(1, 5, B).tolist()
    g = sum(lens)
    wh = rng.uniform(0.1, 0.5, (g, 2))
    c = rng.uniform(wh / 2, 1 - wh / 2)
    box = np.concatenate([c - wh / 2, c + wh / 2], 1).astype(np.float32)
    lab = rng.integers(1, C_TINY, (g, 1)).astype(np.int32)
    img = rng.standard_normal((B, 3, image, image)).astype(np.float32)
    return {"img": img, "gt_box": fl.create_lod_tensor(box, [lens], place),
            "gt_label": fl.create_lod_tensor(lab, [lens], place)}


def _persistables(prog, scope):
    return {v.name: np.asarray(scope.find_var(v.name).get_tensor())
            for v in prog.global_block().vars.values()
            if v.persistable and scope.find_var(v.name) is not None}


@pytest.fixture(scope="module")
def trained():
    """The tiny SSD, 3 steps at B=1 in each package from the JAX
    package's initial parameters: (port program, head, scope, jax
    losses, port losses, jax state, port state)."""
    jmain, jstart, jloss, _ = _ssd_program(
        fluid, _tiny_head, 64, C_TINY, jax_shape=[-1, M_TINY])
    pmain, pstart, ploss, head = _ssd_program(pt, _tiny_head, 64, C_TINY)
    jscope, jexe = JaxScope(), fluid.Executor(fluid.CPUPlace())
    jexe.run(jstart, scope=jscope)
    pscope, pexe = pt.Scope(), pt.Executor(pt.CPUPlace())
    pexe.run(pstart, scope=pscope)
    load_params_from_numpy(pscope, _persistables(jmain, jscope),
                           pt.CPUPlace())
    losses = ([], [])
    for step in range(3):
        for i, (fl, main, loss, scope, exe) in enumerate((
                (fluid, jmain, jloss, jscope, jexe),
                (pt, pmain, ploss, pscope, pexe))):
            f = _voc_feed(fl, np.random.default_rng(step), 1,
                          fl.CPUPlace())
            losses[i].append(float(np.asarray(exe.run(
                main, feed=f, fetch_list=[loss], scope=scope)[0])))
    return (pmain, head, pscope, losses[0], losses[1],
            _persistables(jmain, jscope), _persistables(pmain, pscope))


def test_tiny_ssd_trains_as_jax(trained):
    _, _, _, jl, pl, js, ps = trained
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)
    assert set(js) == set(ps)
    for n, j in js.items():
        np.testing.assert_allclose(ps[n], j, rtol=RTOL, atol=ATOL, err_msg=n)


def _loss_program(fl, m, c, normalize):
    L = fl.layers
    fl.framework.unique_name.reset()
    main = fl.Program()
    with fl.program_guard(main, fl.Program()):
        loc = L.data("loc", [m, 4], dtype="float32")
        conf = L.data("conf", [m, c], dtype="float32")
        prior = L.data("prior", [m, 4], dtype="float32",
                       append_batch_size=False)
        gt_box = L.data("gt_box", [4], dtype="float32", lod_level=1)
        gt_label = L.data("gt_label", [1], dtype="int32", lod_level=1)
        loss = L.ssd_loss(loc, conf, gt_box, gt_label, prior,
                          normalize=normalize)
    return main, loss


def _head_feed(rng, B, m=M_TINY, c=C_TINY):
    lens = [1, 4, 2][:B] if B > 1 else [int(rng.integers(1, 5))]
    g = sum(lens)
    wh = rng.uniform(0.1, 0.5, (g, 2))
    cen = rng.uniform(wh / 2, 1 - wh / 2)
    box = np.concatenate([cen - wh / 2, cen + wh / 2], 1).astype(np.float32)
    pw = rng.uniform(0.05, 0.5, (m, 2))
    pc = rng.uniform(pw / 2, 1 - pw / 2)
    prior = np.concatenate([pc - pw / 2, pc + pw / 2], 1).astype(np.float32)
    prior[:g] = box                     # priors each box matches well
    return {"loc": 0.1 * rng.standard_normal((B, m, 4)).astype(np.float32),
            "conf": rng.standard_normal((B, m, c)).astype(np.float32),
            "prior": prior, "box": box,
            "label": rng.integers(1, c, (g, 1)).astype(np.int32),
            "lens": lens}


def _split_feed(fl, f, lo, hi, place):
    offs = np.cumsum([0] + f["lens"])
    rows = slice(offs[lo], offs[hi])
    lens = [f["lens"][i] for i in range(lo, hi)]
    return {"loc": f["loc"][lo:hi], "conf": f["conf"][lo:hi],
            "prior": f["prior"],
            "gt_box": fl.create_lod_tensor(f["box"][rows], [lens], place),
            "gt_label": fl.create_lod_tensor(f["label"][rows], [lens],
                                             place)}


def test_ssd_loss_at_b3_is_the_jax_b1_losses():
    """normalize=False: the port's per-prior loss of three images (1, 4
    and 2 boxes) is the JAX package's B=1 loss of each, in order."""
    f = _head_feed(np.random.default_rng(3), 3)
    pmain, ploss = _loss_program(pt, M_TINY, C_TINY, False)
    got = np.asarray(pt.Executor(pt.CPUPlace()).run(
        pmain, feed=_split_feed(pt, f, 0, 3, pt.CPUPlace()),
        fetch_list=[ploss])[0])
    jmain, jloss = _loss_program(fluid, M_TINY, C_TINY, False)
    jexe = fluid.Executor(fluid.CPUPlace())
    want = np.concatenate([np.asarray(jexe.run(
        jmain, feed=_split_feed(fluid, f, i, i + 1, fluid.CPUPlace()),
        fetch_list=[jloss])[0]) for i in range(3)])
    assert got.shape == (3 * M_TINY, 1)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert (got > 0).sum() > 3 * 4         # matched and mined priors


def _detect_program(fl, m, c, softmax_first):
    L = fl.layers
    fl.framework.unique_name.reset()
    main = fl.Program()
    with fl.program_guard(main, fl.Program()):
        loc = L.data("loc", [m, 4], dtype="float32")
        conf = L.data("conf", [m, c], dtype="float32")
        prior = L.data("prior", [m, 4], dtype="float32",
                       append_batch_size=False)
        pvar = L.data("pvar", [m, 4], dtype="float32",
                      append_batch_size=False)
        scores = L.softmax(conf) if softmax_first else conf
        out = L.detection_output(loc, scores, prior, pvar,
                                 nms_threshold=0.45, nms_top_k=60,
                                 keep_top_k=30, score_threshold=0.01)
        lab = L.data("lab", [6], dtype="float32", lod_level=1)
        m_ap = L.detection_map(out, lab, class_num=c,
                               overlap_threshold=0.5,
                               ap_version="11point")
    return main, out, m_ap


def test_detection_output_and_map_match_jax():
    f = _head_feed(np.random.default_rng(5), 2)
    f["conf"][:, :, 1:] += 2.0 * np.random.default_rng(6).random(
        (2, M_TINY, 1)).astype(np.float32)
    offs = np.cumsum([0] + f["lens"])
    lab = np.concatenate([f["label"].astype(np.float32),
                          np.zeros_like(f["label"], np.float32), f["box"]],
                         axis=1)
    res = {}
    for name, fl in (("jax", fluid), ("port", pt)):
        main, out, m_ap = _detect_program(fl, M_TINY, C_TINY,
                                          softmax_first=name == "jax")
        place = fl.CPUPlace()
        feed = {"loc": f["loc"], "conf": f["conf"], "prior": f["prior"],
                "pvar": np.full((M_TINY, 4), 0.1, np.float32),
                "lab": fl.create_lod_tensor(lab[:offs[2]], [f["lens"][:2]],
                                            place)}
        rows, mp = fl.Executor(place).run(main, feed=feed,
                                          fetch_list=[out, m_ap])
        res[name] = (np.asarray(rows), float(np.asarray(mp)))
    (jr, jm), (pr, pm) = res["jax"], res["port"]
    assert pr.shape == (2 * 30, 6)
    np.testing.assert_allclose(pr, jr, rtol=TOL, atol=TOL)
    assert (pr[:, 0] >= 0).sum() > 10
    assert pm == pytest.approx(jm, rel=1e-6)


def test_ssd_detect_predictor_matches_executor(trained, tmp_path):
    """chip_smoke.ssd_detect on the trained tiny SSD: the Executor's
    rows eager and replayed, and AnalysisPredictor's, equal."""
    pmain, head, scope, *_ = trained
    prog, nmsed, _ = chip_smoke.ssd_detect(pt, pmain, head)
    img = np.random.default_rng(9).standard_normal(
        (2, 3, 64, 64)).astype(np.float32)
    exe = pt.Executor(pt.CPUPlace())
    rows = [np.asarray(exe.run(prog, feed={"img": img}, fetch_list=[nmsed],
                               scope=scope)[0]) for _ in range(3)]
    assert exe._engine.counters["captures"] == 1
    for r in rows[1:]:
        np.testing.assert_array_equal(r, rows[0])
    with pt.scope_guard(scope):
        pt.io.save_inference_model(str(tmp_path), ["img"], [nmsed], exe,
                                   main_program=prog)
    config = AnalysisConfig(str(tmp_path))
    config.disable_gpu()
    predictor = create_paddle_predictor(config)
    it = predictor.get_input_tensor("img")
    it.copy_from_cpu(img)
    predictor.zero_copy_run()
    ot = predictor.get_output_tensor(predictor.get_output_names()[0])
    np.testing.assert_array_equal(ot.copy_to_cpu(), rows[0])
    assert rows[0].shape == (2 * chip_smoke.SSD_DET["keep_top_k"], 6)
