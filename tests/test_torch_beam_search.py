"""The beam-search decoder's ops in the port against the JAX package.

* log, gather and stack through both packages' lowerings on the same
  numpy inputs, and the gradient of each float input through both
  `<op>_grad` lowerings under one cotangent.
* beam_search at step 0 (no LoD: every row its own source), on LoD
  groups of K rows, with frozen beams (a row whose last id is end_id
  re-emits (end_id, its score) and nothing else), with
  is_accumulated=False (the log of the clamped probabilities plus the
  previous score), and without a parent_idx output: selected ids and
  parent rows equal, scores within TOL, the outputs' LoD [i*K].
* beam_search_decode on stacked steps with hypotheses that end early
  and a parent permutation: SentenceIds equal (int32), every position
  after the first end_id holding end_id; SentenceScores the last step's.

Tolerance: float32 within TOL = 1e-5 (log and the sums); ids, parents
and gathers exact. The scores are drawn so that no two candidates of a
source lie within TOL: the ids are compared exactly.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.core.registry import ExecContext as JaxContext
from paddle_tpu.core.registry import OPS as JAX_OPS

from paddle_tpu_torch.core.registry import ExecContext as PtContext
from paddle_tpu_torch.core.registry import OPS as PT_OPS

from test_torch_sequence import CPU, _both, _close, _names, _op
from torch_threads import one_torch_thread  # noqa: F401

END = 0


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _unary_cases():
    r = np.random.default_rng(0)
    return [
        ("log", {"X": r.uniform(0.1, 3.0, (5, 4)).astype(np.float32)},
         {}, ["Out"], ["X"]),
        ("gather", {"X": _f32(r, 6, 3),
                    "Index": np.array([5, 0, 0, 2], np.int32)},
         {}, ["Out"], ["X"]),
        ("gather", {"X": _f32(r, 6, 2, 2),
                    "Index": np.array([[1], [1], [4]], np.int64)},
         {}, ["Out"], ["X"]),
        ("stack", {"X": [_f32(r, 3, 2), _f32(r, 3, 2), _f32(r, 3, 2)]},
         {"axis": 0}, ["Y"], ["X"]),
        ("stack", {"X": [_f32(r, 4, 1), _f32(r, 4, 1)]},
         {"axis": 1}, ["Y"], ["X"]),
    ]


_UNARY = _unary_cases()


def _grad_both(op_type, inputs, outs, main, jenv, attrs, diff, seed):
    """The gradient of each float input of `diff` through both
    `<op>_grad` lowerings under one cotangent of output slot `main`."""
    y = np.asarray(jenv[outs[main][0]])
    ct = np.random.default_rng(seed).standard_normal(y.shape) \
        .astype(np.float32)
    g_in = dict(inputs)
    g_in[main] = y
    g_in[main + "@GRAD"] = ct
    g_outs = {s + "@GRAD": [n + "@g" for n in _names(s, inputs[s])]
              for s in diff}
    op, env = _op(op_type + "_grad", g_in, g_outs, attrs)
    jenv = {n: jnp.asarray(a) for n, a in env.items()}
    penv = {n: torch.from_numpy(np.array(a)) for n, a in env.items()}
    JAX_OPS.get(op_type + "_grad").lowering(JaxContext(op, jenv, None,
                                                       None, {}))
    PT_OPS.get(op_type + "_grad").lowering(PtContext(op, penv, CPU, None,
                                                     {}))
    for names in g_outs.values():
        for n in names:
            _close(jenv[n], penv[n], msg=f"{op_type} {n}")
            assert np.abs(np.asarray(jenv[n])).max() > 0


@pytest.mark.parametrize("case", range(len(_UNARY)),
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(_UNARY)])
def test_decoder_op_and_its_grad_match_jax(case):
    op_type, inputs, attrs, out_slots, diff = _UNARY[case]
    outs = {s: [s.lower() + "_out"] for s in out_slots}
    jenv, penv, _, _ = _both(op_type, inputs, outs, attrs, {})
    n = outs[out_slots[0]][0]
    _close(jenv[n], penv[n], msg=op_type)
    _grad_both(op_type, inputs, outs, out_slots[0], jenv, attrs, diff, case)


def _step(rng, rows, n_cand, K, lod, finished=(), probs=False):
    """One beam_search step's inputs: pre ids (end_id on `finished`
    rows, whose scores lead their source's), pre scores, candidate ids
    and scores (probabilities in (0, 1] when `probs`), all candidates of
    a source apart by more than TOL."""
    pre_ids = rng.integers(2, 50, (rows, 1)).astype(np.int64)
    pre_ids[list(finished), 0] = END
    pre_scores = -rng.uniform(0, 3, (rows, 1)).astype(np.float32)
    pre_scores[list(finished), 0] = rng.uniform(1, 2, len(finished))
    ids = rng.integers(0, 50, (rows, n_cand)).astype(np.int64)
    spread = rng.permutation(rows * n_cand).reshape(rows, n_cand)
    if probs:
        scores = ((spread + 1) / (rows * n_cand + 1)).astype(np.float32)
    else:
        scores = (-0.1 * spread - rng.uniform(0, 0.01, (rows, n_cand))) \
            .astype(np.float32)
    return {"pre_ids": pre_ids, "pre_scores": pre_scores, "ids": ids,
            "scores": scores}


# (name, rows, candidates, K, pre_ids LoD, finished rows, probabilities)
BEAM_CASES = [
    ("step0", 3, 3, 3, None, (), False),
    ("groups", 6, 3, 3, [[0, 3, 6], [0, 1, 2, 3, 4, 5, 6]], (), False),
    ("frozen", 8, 4, 4, [[0, 4, 8]], (1, 4, 5, 6), False),
    ("all-frozen", 4, 2, 2, [[0, 2, 4]], (2, 3), False),
    ("not-accumulated", 6, 3, 3, [[0, 3, 6]], (4,), True),
]


@pytest.mark.parametrize("parent", [True, False])
@pytest.mark.parametrize("case", BEAM_CASES, ids=[c[0] for c in BEAM_CASES])
def test_beam_search_matches_jax(case, parent):
    name, rows, n_cand, K, lod, finished, probs = case
    ins = _step(np.random.default_rng(rows * 10 + n_cand), rows, n_cand, K,
                lod, finished, probs)
    outs = {"selected_ids": ["sel_ids"], "selected_scores": ["sel_sc"]}
    if parent:
        outs["parent_idx"] = ["parent"]
    attrs = {"beam_size": K, "end_id": END, "level": 0,
             "is_accumulated": not probs}
    lods = {"pre_ids": lod} if lod else {}
    jenv, penv, jl, pl = _both("beam_search", ins, outs, attrs, lods)
    B = len(lod[0]) - 1 if lod else rows
    for n in ("sel_ids", "sel_sc") + (("parent",) if parent else ()):
        _close(jenv[n], penv[n], msg=f"{name} {n}")
    assert penv["sel_ids"].shape == (B * K, 1)
    assert penv["sel_ids"].dtype == torch.int64
    if parent:
        assert penv["parent"].dtype == torch.int32
    want_lod = [[i * K for i in range(B + 1)]]
    assert pl["sel_ids"] == jl["sel_ids"] == want_lod
    assert pl["sel_sc"] == jl["sel_sc"] == want_lod
    if finished and parent:
        # each frozen row (its score leads) selects itself once again:
        # (end_id, its score)
        sel = penv["sel_ids"].numpy()[:, 0]
        par = penv["parent"].numpy()
        for r in finished:
            (k,) = np.flatnonzero(par == r)
            assert sel[k] == END
            assert penv["sel_sc"].numpy()[k, 0] == ins["pre_scores"][r, 0]


def test_beam_search_decode_matches_jax():
    rng = np.random.default_rng(5)
    T, B, K = 5, 2, 3
    n = B * K
    ids = rng.integers(1, 9, (T, n, 1)).astype(np.int64)
    ids[1, 0, 0] = END          # hypothesis 0 ends at step 1 ...
    ids[3, 4, 0] = END          # ... and 4 at step 3
    # each step's parents: a permutation of its source's K rows
    parents = np.stack([np.concatenate([rng.permutation(K) + b * K
                                        for b in range(B)])
                        for _ in range(T)]).astype(np.int32)
    scores = _f32(rng, T, n, 1)
    outs = {"SentenceIds": ["sent"], "SentenceScores": ["sent_sc"]}
    jenv, penv, _, _ = _both(
        "beam_search_decode",
        {"Ids": ids, "Scores": scores, "ParentIdx": parents}, outs,
        {"beam_size": K, "end_id": END}, {})
    _close(jenv["sent"], penv["sent"], msg="SentenceIds")
    _close(jenv["sent_sc"], penv["sent_sc"], msg="SentenceScores")
    sent = penv["sent"].numpy()
    assert penv["sent"].dtype == torch.int32 and sent.shape == (n, T)
    np.testing.assert_array_equal(penv["sent_sc"].numpy(), scores[-1])
    for row in sent:
        ends = np.flatnonzero(row == END)
        if ends.size:
            assert (row[ends[0]:] == END).all()
    assert (sent == END).any()
