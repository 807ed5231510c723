"""The linear-chain CRF ops of the port against the JAX package.

* linear_chain_crf through both packages' lowerings on the same numpy
  emissions, transitions, labels and LoDs: its four outputs
  (LogLikelihood, and EmissionExps, TransitionExps and Alpha as the JAX
  op writes them), and Emission@GRAD and Transition@GRAD through both
  `linear_chain_crf_grad` lowerings under one cotangent. The LoDs hold a
  length-1 sequence, a batch whose longest sequence is the last one and
  one whose longest is the first, and no LoD (one sequence).
* The same gradients through append_backward of a small program
  (emission data -> linear_chain_crf -> mean) in each package, from the
  same transition parameter.
* crf_decoding without and with Label: the Viterbi paths (int32) equal
  and the output's LoD the emission's.

Tolerance: float32 within TOL = 1e-5 (the forward algorithm's logsumexp
sums in another order); paths and flags exact (random emissions: no
tie between two paths' scores).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as fluid
from paddle_tpu.core.registry import ExecContext as JaxContext
from paddle_tpu.core.registry import OPS as JAX_OPS
from paddle_tpu.core.scope import LoDTensor as JaxLoD
from paddle_tpu.core.scope import Scope as JaxScope

import paddle_tpu_torch as pt
from paddle_tpu_torch.core.registry import ExecContext as PtContext
from paddle_tpu_torch.core.registry import OPS as PT_OPS
from paddle_tpu_torch.io import load_params_from_numpy

from test_torch_sequence import CPU, TOL, _both, _close, _op
from torch_threads import one_torch_thread  # noqa: F401

N_TAG = 4
# (name, LoD or None)
LODS = [("len1-longest-last", [[0, 3, 4, 9]]),
        ("longest-first", [[0, 5, 7, 8]]),
        ("one-sequence", None)]


def _inputs(seed, lod):
    rng = np.random.default_rng(seed)
    rows = lod[0][-1] if lod else 6
    return {"Emission": rng.standard_normal((rows, N_TAG))
            .astype(np.float32),
            "Transition": rng.standard_normal((N_TAG + 2, N_TAG))
            .astype(np.float32),
            "Label": rng.integers(0, N_TAG, (rows, 1)).astype(np.int64)}


CRF_OUTS = {s: [s.lower() + "_out"] for s in
            ("LogLikelihood", "EmissionExps", "TransitionExps", "Alpha")}


@pytest.mark.parametrize("name,lod", LODS, ids=[n for n, _ in LODS])
def test_linear_chain_crf_and_its_grad_match_jax(name, lod):
    ins = _inputs(1, lod)
    lods = {"emission": lod} if lod else {}
    jenv, penv, _, _ = _both("linear_chain_crf", ins, CRF_OUTS, {}, lods)
    for slot, (n,) in CRF_OUTS.items():
        _close(jenv[n], penv[n], msg=f"{name} {slot}")
    ll = np.asarray(jenv["loglikelihood_out"])
    assert ll.shape == (len(lod[0]) - 1 if lod else 1, 1)

    ct = np.random.default_rng(2).standard_normal(ll.shape) \
        .astype(np.float32)
    g_in = dict(ins)
    for slot, (n,) in CRF_OUTS.items():
        g_in[slot] = np.asarray(jenv[n])
    g_in["LogLikelihood@GRAD"] = ct
    g_outs = {"Emission@GRAD": ["em@g"], "Transition@GRAD": ["tr@g"]}
    op, env = _op("linear_chain_crf_grad", g_in, g_outs, {})
    for slot in ("Alpha", "EmissionExps", "TransitionExps"):
        op._inputs[slot + "@GRAD"] = [""]
    jenv = {n: jnp.asarray(a) for n, a in env.items()}
    penv = {n: torch.from_numpy(np.array(a)) for n, a in env.items()}
    JAX_OPS.get("linear_chain_crf_grad").lowering(
        JaxContext(op, jenv, None, None, dict(lods)))
    PT_OPS.get("linear_chain_crf_grad").lowering(
        PtContext(op, penv, CPU, None, dict(lods)))
    for n in ("em@g", "tr@g"):
        _close(jenv[n], penv[n], msg=f"{name} {n}")
        assert np.abs(np.asarray(jenv[n])).max() > 0


def _crf_program(fl):
    fl.framework.unique_name.reset()
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        em = fl.layers.data("em", [N_TAG], dtype="float32", lod_level=1)
        em.stop_gradient = False
        lab = fl.layers.data("lab", [1], dtype="int64", lod_level=1)
        cost = fl.layers.linear_chain_crf(
            em, lab, param_attr=fl.ParamAttr(name="crfw"))
        loss = fl.layers.mean(cost)
        grads = fl.gradients(loss, [em, main.global_block().var("crfw")])
    return main, startup, loss, grads


@pytest.mark.parametrize("name,lod", LODS[:2], ids=[n for n, _ in LODS[:2]])
def test_crf_gradients_through_append_backward_match_jax(name, lod):
    jmain, jstart, jloss, jgrads = _crf_program(fluid)
    pmain, pstart, ploss, pgrads = _crf_program(pt)
    assert pmain.serialize_to_string() == jmain.serialize_to_string()
    ins = _inputs(3, lod)
    lens = [np.diff(lod[0]).tolist()]
    jscope, jexe = JaxScope(), fluid.Executor(fluid.CPUPlace())
    jexe.run(jstart, scope=jscope)
    crfw = np.asarray(jscope.find_var("crfw").get_tensor())
    jfeed = {"em": JaxLoD(ins["Emission"], lod),
             "lab": JaxLoD(ins["Label"], lod)}
    want = jexe.run(jmain, feed=jfeed, scope=jscope,
                    fetch_list=[jloss] + [g.name for g in jgrads])
    pscope, pexe = pt.Scope(), pt.Executor(pt.CPUPlace())
    pexe.run(pstart, scope=pscope)
    load_params_from_numpy(pscope, {"crfw": crfw}, pt.CPUPlace())
    pfeed = {"em": pt.create_lod_tensor(ins["Emission"], lens,
                                        pt.CPUPlace()),
             "lab": pt.create_lod_tensor(ins["Label"], lens, pt.CPUPlace())}
    got = pexe.run(pmain, feed=pfeed, scope=pscope,
                   fetch_list=[ploss] + [g.name for g in pgrads])
    for w, g, what in zip(want, got, ("loss", "Emission@GRAD",
                                      "Transition@GRAD")):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=TOL,
                                   atol=TOL, err_msg=f"{name} {what}")


@pytest.mark.parametrize("with_label", [False, True])
@pytest.mark.parametrize("name,lod", LODS, ids=[n for n, _ in LODS])
def test_crf_decoding_matches_jax(name, lod, with_label):
    ins = _inputs(4, lod)
    if not with_label:
        del ins["Label"]
    lods = {"emission": lod} if lod else {}
    outs = {"ViterbiPath": ["path"]}
    jenv, penv, jl, pl = _both("crf_decoding", ins, outs, {}, lods)
    assert penv["path"].dtype == torch.int32
    assert penv["path"].shape == (ins["Emission"].shape[0], 1)
    _close(jenv["path"], penv["path"], msg=name)
    assert pl["path"] == jl["path"] == (lod or [[0, 6]])
    if with_label:
        flags = penv["path"].numpy()
        assert set(np.unique(flags)) <= {0, 1}
