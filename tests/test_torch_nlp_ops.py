"""Slice 24's ops, builders, evaluators, metrics and dygraph layers in the
port against the JAX package: warpctc, ctc_align, nce,
hierarchical_sigmoid, sample_logits, bilinear_tensor_product, chunk_eval,
auc, mean_iou, precision_recall and positive_negative_pair.

* Every case of ops/family_cases.py's nlp_cases() through the port's
  lowering (family_cases.run) and the JAX lowering on the same seeded
  inputs: outputs and output LoDs, and both `<op>_grad` lowerings (the
  generic vjp in each) under one random cotangent of every float output
  where the op has a gradient. Tolerance TOL = 1e-5 relative and
  absolute (float32: libm and the order of sums differ; warpctc's
  recursion is the JAX op's nested logaddexp, step for step), integers
  exactly. The cases whose op draws (nce, sample_logits without
  CustomizedSamples) are held to family_cases' numpy reckonings of the
  JAX op's formula on the samples the port drew, cost and gradient,
  within TOL; the reckoning is held to the JAX op on the samples the
  JAX op drew, within TOL.
* Each sampler's draw frequencies (uniform, log-uniform, custom; and
  sample_logits' log-uniform) against its distribution: a chi-square
  statistic below the 1 - 1e-4 quantile of its degrees of freedom.
* C.1: top_k passes its input's LoD to Out and Indices (the reference's
  ShareLoD; the JAX op drops it, so the JAX ctc_greedy_decoder decodes a
  batch as one sequence): the port's decoder equals the JAX ctc_align
  lowering run on the LoD.
* Every new builder builds the JAX package's ProgramDesc byte for byte,
  and its program's fetches on the same feeds and parameters equal the
  JAX package's (the deterministic ones; within TOL).
* metrics.py's classes against the JAX package's on the same updates;
  the dygraph layers BilinearTensorProduct and GRUUnit against the JAX
  dygraph (outputs and gradients within TOL), NCE against the port's
  graph op on its seed; ChunkEvaluator and layers.auc over three runs
  against the JAX package's.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as fluid
from paddle_tpu.core.registry import ExecContext as JaxContext
from paddle_tpu.core.registry import OPS as JAX_OPS

import paddle_tpu_torch as pt
from paddle_tpu_torch.core.registry import OPS as PT_OPS
from paddle_tpu_torch.ops import family_cases

from test_torch_book import _widen_desc
from test_torch_one_stage_detection import (_grads, _jax_lowering,
                                            _out_names)
from test_torch_op_families import _check
from test_torch_sequence import _op

TOL = 1e-5
CASES = family_cases.nlp_cases()
IDS = [f"{c[0]}-{i}" for i, c in enumerate(CASES)]
HOST_OPS = ("ctc_align", "chunk_eval")
ELEVEN = {"warpctc", "ctc_align", "nce", "hierarchical_sigmoid",
          "sample_logits", "bilinear_tensor_product", "chunk_eval", "auc",
          "mean_iou", "precision_recall", "positive_negative_pair"}


def _jax_run(op_type, inputs, lods, attrs, names):
    """The JAX lowering's outputs and LoDs: traced as one function where
    it can be, called eagerly for the host ops."""
    op, env = _op(op_type, inputs, names, attrs)
    if op_type not in HOST_OPS:
        return _jax_lowering(op_type, op, env, lods)
    jl = dict(lods)
    jenv = {n: jnp.asarray(a) for n, a in env.items()}
    JAX_OPS.get(op_type).lowering(JaxContext(op, jenv, None, None, jl))
    return jenv, jl


def _port(case):
    op_type, inputs, lods, attrs, out_slots, _ = case
    return family_cases.run(op_type, inputs, attrs, out_slots, "cpu", lods)


def _close(got, want, msg):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL,
                               atol=TOL, err_msg=msg)


def _drawn_check(case):
    """A drawing op's case: the port's outputs on its own samples, the
    gradient, and the reckoning against the JAX op on its samples."""
    op_type, inputs, lods, attrs, out_slots, diff = case
    port, _ = _port(case)
    rng = np.random.default_rng(7)
    if op_type == "nce":
        samples = port["samplelabels_out0"].numpy()
        B, nt = inputs["Label"].shape
        C = attrs["num_total_classes"]
        np.testing.assert_array_equal(samples[:, :nt], inputs["Label"])
        assert samples.shape[1] == nt + attrs["num_neg_samples"]
        assert ((samples >= 0) & (samples < C)).all()
        cot = rng.standard_normal((B, 1)).astype(np.float32)
        cost, grads = family_cases.nce_numpy(inputs, attrs, samples, cot)
        _close(port["cost_out0"], cost, "nce cost")
        out = "Cost"
    else:
        samples = port["samples_out0"].numpy()
        np.testing.assert_array_equal(samples[:, :inputs["Labels"].shape[1]],
                                      inputs["Labels"])
        cot = rng.standard_normal(samples.shape).astype(np.float32)
        logits, probs, grads = family_cases.sample_logits_numpy(
            inputs, attrs, samples, cot)
        _close(port["sampledlogits_out0"], logits, "sampled logits")
        _close(port["probabilities_out0"], probs, "probabilities")
        out = "SampledLogits"
    got = family_cases.run_grad(op_type, inputs, attrs, out_slots, diff,
                                "cpu", lods, port, {out: cot})
    for s in diff:
        _close(got[s].numpy(), grads[s], f"{op_type} {s} gradient")
    # the reckoning against the JAX op, on the samples it drew
    jenv, _ = _jax_run(op_type, inputs, lods, attrs, _out_names(out_slots))
    if op_type == "nce":
        _close(jenv["cost_out0"], family_cases.nce_numpy(
            inputs, attrs, np.asarray(jenv["samplelabels_out0"])),
            "the reckoning against the JAX nce")
    else:
        want, probs = family_cases.sample_logits_numpy(
            inputs, attrs, np.asarray(jenv["samples_out0"]))
        _close(jenv["sampledlogits_out0"], want,
               "the reckoning against the JAX sample_logits")
        _close(jenv["probabilities_out0"], probs, "the JAX probabilities")


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_nlp_op_matches_jax(case):
    op_type, inputs, lods, attrs, out_slots, diff = case
    if family_cases.drawn(case):
        _drawn_check(case)
        return
    names = _out_names(out_slots)
    port, plod = _port(case)
    jenv, jl = _jax_run(op_type, inputs, lods, attrs, names)
    for ns in names.values():
        for n in ns:
            _check(jenv[n], port[n], f"{op_type} {n}")
            assert jl.get(n) == plod[n], n
    if diff:
        jg, pg, _ = _grads(op_type, inputs, lods, attrs, names, jenv, diff)
        for n in jg:
            assert np.isfinite(pg[n].numpy()).all(), n
            _check(jg[n], pg[n], f"{op_type} {n}")


def test_the_cases_cover_what_they_name():
    """An infeasible CTC alignment gives a huge finite loss; an empty
    label -sum log p(blank); hsigmoid's case holds a power-of-two code;
    sample_logits' custom case an accidental hit."""
    loss = _port(CASES[0])[0]["loss_out0"].numpy().reshape(-1)
    assert np.isfinite(loss).all() and loss[2] > 1e29 and loss[:2].max() < 50
    lp = torch.log_softmax(torch.from_numpy(CASES[0][1]["Logits"]), -1)
    np.testing.assert_allclose(loss[1], -lp[4:9, 0].sum().item(), rtol=TOL)
    hs = [c for c in CASES if c[0] == "hierarchical_sigmoid"]
    codes = [c[1]["Label"].reshape(-1) + c[3]["num_classes"] for c in hs]
    assert any(((v & (v - 1)) == 0).any() for v in codes)
    sl = [c for c in CASES if c[0] == "sample_logits"
          and "CustomizedSamples" in c[1]][0]
    out = _port(sl)[0]["sampledlogits_out0"].numpy()
    assert (out < -1e29).sum() == 2     # rows 1 and 3
    assert {c[3]["chunk_scheme"] for c in CASES if c[0] == "chunk_eval"} == \
        {"IOB", "IOE", "IOBES", "plain"}


# ---------------------------------------------------------------------------
# the samplers' frequencies
# ---------------------------------------------------------------------------

CHI2_Q = 1 - 1e-4


def _chi2_ok(draws, p):
    from scipy.stats import chi2
    counts = np.bincount(draws.reshape(-1), minlength=len(p))
    expect = p * draws.size
    stat = float(((counts - expect) ** 2 / expect).sum())
    bound = float(chi2.ppf(CHI2_Q, len(p) - 1))
    assert stat < bound, (stat, bound, counts, expect)


@pytest.mark.parametrize("sampler", [0, 1, 2])
def test_nce_sampler_frequencies(sampler):
    C, B, k = 9, 500, 40
    r = np.random.default_rng(sampler)
    probs = r.uniform(0.02, 1.0, C).astype(np.float32)
    probs /= probs.sum()
    ins = {"Input": np.zeros((B, 2), np.float32),
           "Label": np.zeros((B, 1), np.int64),
           "Weight": np.zeros((C, 2), np.float32)}
    if sampler == 2:
        ins["CustomDistProbs"] = probs
    out, _ = family_cases.run("nce", ins, {"num_total_classes": C,
                                           "num_neg_samples": k,
                                           "sampler": sampler, "seed": 11},
                              {"SampleLabels": 1}, "cpu")
    draws = out["samplelabels_out0"].numpy()[:, 1:].astype(np.int64)
    c = np.arange(C)
    p = {0: np.full(C, 1.0 / C),
         1: np.log((c + 2.0) / (c + 1.0)) / np.log(C + 1.0),
         2: probs.astype(np.float64)}[sampler]
    _chi2_ok(draws, p)


def test_sample_logits_log_uniform_frequencies():
    C, B, k = 12, 400, 50
    ins = {"Logits": np.zeros((B, C), np.float32),
           "Labels": np.zeros((B, 1), np.int64)}
    out, _ = family_cases.run("sample_logits", ins,
                              {"num_samples": k, "seed": 3},
                              {"Samples": 1}, "cpu")
    draws = out["samples_out0"].numpy()[:, 1:].astype(np.int64)
    c = np.arange(C)
    _chi2_ok(draws, np.log((c + 2.0) / (c + 1.0)) / np.log(C + 1.0))


def test_a_seed_draws_the_same_samples_and_the_grad_redraws_them():
    case = [c for c in CASES if c[0] == "nce" and c[3]["sampler"] == 1][0]
    op_type, inputs, lods, attrs, outs, _ = case
    a, _ = family_cases.run(op_type, inputs, dict(attrs, seed=5), outs,
                            "cpu")
    b, _ = family_cases.run(op_type, inputs, dict(attrs, seed=5), outs,
                            "cpu")
    c, _ = family_cases.run(op_type, inputs, dict(attrs, seed=6), outs,
                            "cpu")
    assert torch.equal(a["samplelabels_out0"], b["samplelabels_out0"])
    assert not torch.equal(a["samplelabels_out0"], c["samplelabels_out0"])


# ---------------------------------------------------------------------------
# C.1: top_k shares its input's LoD
# ---------------------------------------------------------------------------

def test_top_k_shares_the_lod_and_the_decoder_decodes_each_sequence():
    r = np.random.default_rng(2)
    x = r.standard_normal((9, 4)).astype(np.float32)
    x[3, 2] = x[4, 2] = 9.0     # sequence 0 ends and 1 starts with class 2
    lod = [[0, 4, 9]]
    out, olod = family_cases.run("top_k", {"X": x}, {"k": 1},
                                 {"Out": 1, "Indices": 1}, "cpu", {"x": lod})
    assert olod["out_out0"] == lod and olod["indices_out0"] == lod
    main, start = pt.Program(), pt.Program()
    with pt.program_guard(main, start):
        v = pt.layers.data("x", [4], dtype="float32", lod_level=1)
        dec = pt.layers.ctc_greedy_decoder(v, blank=3)
    exe = pt.Executor(pt.CPUPlace())
    got = exe.run(main, feed={"x": pt.create_lod_tensor(
        x, [[4, 5]], pt.CPUPlace())}, fetch_list=[dec],
        return_numpy=False)[0]
    ids = np.argmax(x, 1).reshape(-1, 1).astype(np.int64)
    jenv, jl = _jax_run("ctc_align", {"Input": ids}, {"input": lod},
                        {"blank": 3}, {"Output": ["o"]})
    np.testing.assert_array_equal(np.asarray(got), np.asarray(jenv["o"]))
    assert got.lod() == jl["o"] and len(got.lod()[0]) == 3
    # sequence 0 ends and sequence 1 starts with a 2: decoded as one
    # sequence (the JAX decoder's LoD-less top_k) the two merge
    one, _ = _jax_run("ctc_align", {"Input": ids}, {}, {"blank": 3},
                      {"Output": ["o"]})
    assert np.asarray(one["o"]).shape[0] == np.asarray(got).shape[0] - 1


# ---------------------------------------------------------------------------
# the builders
# ---------------------------------------------------------------------------

def _build(fl, name):
    """(main, startup, fetch vars, feed) of one builder."""
    L = fl.layers
    main, start = fl.Program(), fl.Program()
    fl.framework.unique_name.reset() if hasattr(
        fl.framework, "unique_name") else None
    r = np.random.default_rng(5)
    with fl.program_guard(main, start):
        if name in ("warpctc", "ctc_greedy_decoder"):
            x = L.data("x", [5], dtype="float32", lod_level=1)
            lab = L.data("lab", [1], dtype="int32", lod_level=1)
            feed = {"x": (CASES[0][1]["Logits"], [4, 5, 2, 6]),
                    "lab": (CASES[0][1]["Label"], [2, 0, 2, 3])}
            outs = [L.warpctc(x, lab, blank=0, norm_by_times=True)] \
                if name == "warpctc" else [L.ctc_greedy_decoder(x, blank=0)]
        elif name.startswith("nce"):
            sampler = name.split("_", 1)[1]
            x = L.data("x", [4], dtype="float32")
            lab = L.data("lab", [1], dtype="int64")
            outs = [L.nce(x, lab, 7, num_neg_samples=3, sampler=sampler,
                          custom_dist=[0.1] * 6 + [0.4]
                          if sampler == "custom_dist" else None, seed=3)]
            feed = None
        elif name == "hsigmoid":
            x = L.data("x", [4], dtype="float32")
            lab = L.data("lab", [1], dtype="int64")
            outs = [L.hsigmoid(x, lab, 6)]
            feed = {"x": r.standard_normal((5, 4)).astype(np.float32),
                    "lab": np.array([[0], [2], [5], [3], [1]], np.int64)}
        elif name.startswith("sampled_softmax"):
            x = L.data("x", [9], dtype="float32")
            lab = L.data("lab", [1], dtype="int64")
            if name.endswith("custom"):
                s = L.data("s", [4], dtype="int64")
                p = L.data("p", [4], dtype="float32")
                outs = [L.sampled_softmax_with_cross_entropy(
                    x, lab, 3, use_customized_samples=True,
                    customized_samples=s, customized_probabilities=p)]
                c = [c for c in CASES if c[0] == "sample_logits"][0][1]
                feed = {"x": c["Logits"], "lab": c["Labels"],
                        "s": c["CustomizedSamples"],
                        "p": c["CustomizedProbabilities"]}
            else:
                outs = [L.sampled_softmax_with_cross_entropy(x, lab, 5)]
                feed = None
        elif name == "bilinear_tensor_product":
            x = L.data("x", [4], dtype="float32")
            y = L.data("y", [3], dtype="float32")
            outs = [L.bilinear_tensor_product(x, y, 2, act="tanh")]
            feed = {"x": r.standard_normal((3, 4)).astype(np.float32),
                    "y": r.standard_normal((3, 3)).astype(np.float32)}
        elif name == "chunk_eval":
            c = [c for c in CASES if c[0] == "chunk_eval"][0][1]
            inf = L.data("inf", [1], dtype="int64", lod_level=1)
            lab = L.data("lab", [1], dtype="int64", lod_level=1)
            outs = list(L.chunk_eval(inf, lab, "IOB", 3,
                                     excluded_chunk_types=[2]))
            lens = np.diff(family_cases.CHUNK_LOD[0]).tolist()
            feed = {"inf": (c["Inference"], lens), "lab": (c["Label"], lens)}
        elif name == "mean_iou":
            p = L.data("p", [1], dtype="int32")
            lab = L.data("lab", [1], dtype="int32")
            outs = list(L.mean_iou(p, lab, 4))
            feed = {"p": r.integers(0, 4, (8, 1)).astype(np.int32),
                    "lab": r.integers(0, 4, (8, 1)).astype(np.int32)}
        else:   # auc
            p = L.data("p", [2], dtype="float32")
            lab = L.data("lab", [1], dtype="int64")
            a, _, stats = L.auc(p, lab, num_thresholds=31)
            outs = [a] + stats
            q = r.uniform(0, 1, 10).astype(np.float32)
            feed = {"p": np.stack([1 - q, q], 1),
                    "lab": (r.random((10, 1)) < 0.5).astype(np.int64)}
    return main, start, outs, feed


BUILDERS = ["warpctc", "ctc_greedy_decoder", "nce_uniform",
            "nce_log_uniform", "nce_custom_dist", "hsigmoid",
            "sampled_softmax", "sampled_softmax_custom",
            "bilinear_tensor_product", "chunk_eval", "mean_iou", "auc"]


def _feed(fl, feed):
    out = {}
    for k, v in feed.items():
        if isinstance(v, tuple):
            out[k] = fl.create_lod_tensor(v[0], [v[1]], fl.CPUPlace())
        else:
            out[k] = v
    return out


def _run(fl, main, start, outs, feed, params=None):
    scope = fl.Scope() if fl is pt else fluid.core.Scope()
    exe = fl.Executor(fl.CPUPlace())
    exe.run(start, scope=scope)
    if params is not None:
        from paddle_tpu_torch.io import load_params_from_numpy
        load_params_from_numpy(scope, params, pt.CPUPlace())
    state = {p.name: np.array(scope.find_var(p.name).get_tensor())
             for p in main.all_parameters()}
    got = exe.run(main, feed=_feed(fl, feed), fetch_list=outs, scope=scope,
                  return_numpy=False)
    return got, state


@pytest.mark.parametrize("name", BUILDERS)
def test_builder_program_equals_jax(name):
    pm, ps, pouts, feed = _build(pt, name)
    jm, js, jouts, _ = _build(fluid, name)
    mine = pm.serialize_to_string()
    assert _widen_desc(jm.serialize_to_string(), mine, ("",)) == mine
    assert ps.serialize_to_string() == js.serialize_to_string()
    if feed is None or name == "ctc_greedy_decoder":
        return      # draws, or the JAX decoder's lost LoD (C.1)
    jgot, state = _run(fluid, jm, js, jouts, feed)
    pgot, _ = _run(pt, pm, ps, pouts, feed, params=state)
    for j, p in zip(jgot, pgot):
        j, p = np.asarray(j), np.asarray(p)
        assert j.shape == p.shape, name
        np.testing.assert_allclose(p, j, rtol=TOL, atol=TOL, err_msg=name)


# ---------------------------------------------------------------------------
# metrics.py, the evaluators and the dygraph layers
# ---------------------------------------------------------------------------

def test_metrics_classes_match_jax():
    for mod in (fluid.metrics, pt.metrics):
        assert set(mod.__all__) == set(pt.metrics.__all__)
    results = {}
    for mod in (fluid.metrics, pt.metrics):
        comp = mod.CompositeMetric()
        comp.add_metric(mod.Precision())
        comp.add_metric(mod.Recall())
        acc, ed, auc = mod.Accuracy(), mod.EditDistance(), mod.Auc(
            num_thresholds=63)
        rr = np.random.default_rng(9)
        for _ in range(3):
            pred = rr.uniform(0, 1, (20, 1)).astype(np.float32)
            lab = (rr.random((20, 1)) < 0.4).astype(np.int64)
            comp.update(pred, lab)
            acc.update(rr.uniform(0, 1, 1), int(rr.integers(1, 9)))
            ed.update(rr.integers(0, 3, (6, 1)).astype(np.float32), 6)
            auc.update(np.concatenate([1 - pred, pred], 1), lab)
        results[mod] = (comp.eval(), acc.eval(), ed.eval(), auc.eval())
        auc.reset()
        assert auc.eval() == 0.0
    assert results[fluid.metrics] == results[pt.metrics]


def _dy_run(fl, kind, params=None):
    from test_torch_dygraph import _guard
    r = np.random.default_rng(4)
    x = r.standard_normal((3, 4)).astype(np.float32)
    y = r.standard_normal((3, 5)).astype(np.float32)
    g = r.standard_normal((3, 6)).astype(np.float32)
    h = r.standard_normal((3, 2)).astype(np.float32)
    with _guard(fl):
        if kind == "bilinear":
            layer = fl.dygraph.nn.BilinearTensorProduct("btp", size=2,
                                                        act="sigmoid")
            args = (x, y)
        else:
            layer = fl.dygraph.nn.GRUUnit("gru", size=6)
            args = (g, h)
        with fl.dygraph.base.no_grad():
            layer(*[fl.dygraph.to_variable(a) for a in args])
        if params is not None:
            layer.set_dict(params)
        outs = layer(*[fl.dygraph.to_variable(a) for a in args])
        outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
        loss = fl.layers.reduce_sum(fl.layers.square(outs[0]))
        loss.backward()
        state = {k: np.asarray(p.numpy())
                 for k, p in layer._stable_named_parameters()}
        grads = {k: np.asarray(p.gradient())
                 for k, p in layer._stable_named_parameters()}
        return [np.asarray(o.numpy()) for o in outs], grads, state


@pytest.mark.parametrize("kind", ["bilinear", "gru_unit"])
def test_dygraph_layer_matches_jax(kind):
    jouts, jgrads, state = _dy_run(fluid, kind)
    pouts, pgrads, pstate = _dy_run(pt, kind, params=state)
    assert set(pstate) == set(state)
    for j, p in zip(jouts, pouts):
        np.testing.assert_allclose(p, j, rtol=TOL, atol=TOL)
    for k in jgrads:
        np.testing.assert_allclose(pgrads[k], jgrads[k], rtol=TOL, atol=TOL,
                                   err_msg=k)


def test_dygraph_nce_equals_the_graph_op_on_its_seed():
    from test_torch_dygraph import _guard
    r = np.random.default_rng(8)
    x = r.standard_normal((5, 4)).astype(np.float32)
    lab = np.array([[1], [4], [0], [6], [2]], np.int64)
    shapes = {}
    for fl in (fluid, pt):
        with _guard(fl):
            layer = fl.dygraph.nn.NCE("nce", num_total_classes=7,
                                      num_neg_samples=3,
                                      sampler="log_uniform", seed=9)
            cost = layer(fl.dygraph.to_variable(x),
                         fl.dygraph.to_variable(lab))
            shapes[fl] = {k: tuple(p.shape) for k, p in
                          layer._stable_named_parameters()}
            if fl is pt:
                params = {k: np.asarray(p.numpy())
                          for k, p in layer._stable_named_parameters()}
                got = np.asarray(cost.numpy())
    assert shapes[fluid] == shapes[pt]
    w = [v for k, v in params.items() if v.ndim == 2 and v.shape[1] == 4][0]
    b = [v for k, v in params.items() if v.shape == (7, 1)][0]
    ins = {"Input": x, "Label": lab, "Weight": w, "Bias": b}
    attrs = {"num_total_classes": 7, "num_neg_samples": 3, "sampler": 1,
             "seed": 9}
    out, _ = family_cases.run("nce", ins, attrs,
                              {"Cost": 1, "SampleLabels": 1}, "cpu")
    np.testing.assert_array_equal(got, out["cost_out0"].numpy())
    _close(got, family_cases.nce_numpy(
        ins, attrs, out["samplelabels_out0"].numpy()), "the reckoning")


def _chunk_program(fl):
    L = fl.layers
    main, start = fl.Program(), fl.Program()
    with fl.program_guard(main, start):
        inf = L.data("inf", [1], dtype="int64", lod_level=1)
        lab = L.data("lab", [1], dtype="int64", lod_level=1)
        ev = fl.evaluator.ChunkEvaluator(inf, lab, "IOB", 3)
        p = L.data("p", [2], dtype="float32")
        y = L.data("y", [1], dtype="int64")
        a, _, stats = L.auc(p, y, num_thresholds=63)
    return main, start, ev, [a] + stats + ev.metrics


def test_chunk_evaluator_and_auc_over_three_runs_match_jax():
    res = {}
    for fl in (fluid, pt):
        with pytest.warns(UserWarning):
            main, start, ev, fetch = _chunk_program(fl)
        exe = fl.Executor(fl.CPUPlace())
        scope = fl.Scope() if fl is pt else fluid.core.Scope()
        exe.run(start, scope=scope)
        r = np.random.default_rng(12)
        got = []
        guard = pt.scope_guard(scope) if fl is pt else \
            fluid.scope_guard(scope)
        with guard:
            for _ in range(3):
                lens = r.integers(1, 7, 4).tolist()
                n = sum(lens)
                lab = r.integers(0, 7, (n, 1)).astype(np.int64)
                inf = np.where(r.random((n, 1)) < 0.3,
                               r.integers(0, 7, (n, 1)), lab)
                q = r.uniform(0, 1, 16).astype(np.float32)
                feed = {"inf": fl.create_lod_tensor(inf, [lens],
                                                    fl.CPUPlace()),
                        "lab": fl.create_lod_tensor(lab, [lens],
                                                    fl.CPUPlace()),
                        "p": np.stack([1 - q, q], 1),
                        "y": (r.random((16, 1)) < 0.5).astype(np.int64)}
                got.append([np.asarray(v) for v in exe.run(
                    main, feed=feed, fetch_list=fetch, scope=scope)])
            got.append([np.asarray(v) for v in ev.eval(exe)])
        res[fl] = got
    for j, p in zip(res[fluid], res[pt]):
        for a, b in zip(j, p):
            np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL)
    assert res[pt][2][1].sum() > 0 and 0 < res[pt][3][2] < 1


def test_nlp_ops_are_registered():
    """The eleven op types are registered in the port, each with a case,
    a gradient op where the JAX package has one; the port registers 297
    of the JAX package's 382 forward op types (278 with these eleven,
    then slice 25's nineteen)."""
    assert ELEVEN == {c[0] for c in CASES}
    for t in ELEVEN:
        assert PT_OPS.has(t) and \
            PT_OPS.has(t + "_grad") == JAX_OPS.has(t + "_grad"), t

    def forward(ops):
        return {t for t in ops.types() if not ops.get(t).is_grad_op}
    assert len(forward(PT_OPS)) == 297 and len(forward(JAX_OPS)) == 382
    assert forward(PT_OPS) <= forward(JAX_OPS)


def test_hsigmoid_custom_trees_raise():
    main, start = pt.Program(), pt.Program()
    with pt.program_guard(main, start):
        x = pt.layers.data("x", [4], dtype="float32")
        lab = pt.layers.data("lab", [1], dtype="int64")
        with pytest.raises(NotImplementedError):
            pt.layers.hsigmoid(x, lab, 6, is_custom=True)
