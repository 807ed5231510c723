"""The CTR models (BASELINE config 4: Wide&Deep and DeepFM) with Adagrad in
the port, on dense and on SelectedRows embedding gradients, against the
JAX package.

* The new ops (flatten, flatten2, concat, sigmoid,
  sigmoid_cross_entropy_with_logits with ignore_index and normalize,
  elementwise_sub) through both packages' lowerings on the same numpy
  inputs, and their gradients through both `<op>_grad` lowerings under
  the same cotangent: 1e-6 relative and absolute (the same float32
  operations; exp and log1p may differ in their last bit). The dense
  adagrad op within SQRT_ULP of the JAX lowering (the same operations
  in the same order; see SQRT_ULP).
* The SelectedRows pieces, with duplicate rows and padding_idx slots,
  compared through to_dense: merge_rows, lookup_table_grad with
  is_sparse=True, the sum and scale branches, merge_selected_rows and
  get_tensor_from_selected_rows; the sparse branches of sgd, momentum
  (with and without Nesterov), adagrad and adam: sgd and momentum 0
  ulp (each package sums duplicates in slot order on the CPU and rounds
  each operation once), adagrad and adam within SQRT_ULP; a gradient
  whose slots are all parked changes nothing, and a parked slot leaves
  row 0 as it was. Fetching a SelectedRows gives
  what the JAX engine gives: a 0-d object array holding it.
* The Wide&Deep (55 ops, 23 startup ops), sparse Wide&Deep and DeepFM
  (58, 17) training programs equal the JAX package's op for op.
* 3 Adagrad(0.01) steps of each at vocab 1001, B=64 from the JAX
  package's initial parameters: losses and every parameter and moment
  within 1e-5 (float32 sums of the GEMMs in another order), but for the
  elements whose gradients all stayed below TINY_G (see there).
* Within the port: a sparse step equals the dense step (the same sums,
  to 1e-6), and a table looked up twice with is_sparse=True, whose two
  SelectedRows meet in a sum op, trains as the JAX package does.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as fluid
import paddle_tpu.models  # noqa: F401
from paddle_tpu.core.registry import ExecContext as JaxContext
from paddle_tpu.core.registry import OPS as JAX_OPS
from paddle_tpu.core.scope import Scope as JaxScope
from paddle_tpu.core.selected_rows import SelectedRows as JaxRows
from paddle_tpu.core.selected_rows import merge_rows as jax_merge_rows
from paddle_tpu.models import wide_deep as jax_wd

import paddle_tpu_torch as pt
from paddle_tpu_torch.core.registry import ExecContext as PtContext
from paddle_tpu_torch.core.registry import OPS as PT_OPS
from paddle_tpu_torch.core.selected_rows import SelectedRows as PtRows
from paddle_tpu_torch.core.selected_rows import merge_rows as pt_merge_rows
from paddle_tpu_torch.io import load_params_from_numpy
from paddle_tpu_torch.models import wide_deep as pt_wd

from test_torch_ops import _Op
from test_torch_training import _ulps
from torch_threads import one_torch_thread  # noqa: F401

# op parity: the same float32 operations (exp, log1p and sigmoid may
# round their last bit differently in XLA and torch)
OP_TOL = 1e-6
# 3 training steps: the GEMMs of the deep tower sum 429-wide rows in
# another order in each package
RTOL = ATOL = 1e-5
# Adagrad moves an element by lr*g/(sqrt(m) + eps), about lr in g's sign
# at the first step wherever |g| >> eps, whatever g's last bits. Where a
# gradient is a batch sum that cancels to |g| ~ eps (1e-6), its absolute
# float32 error (the terms' size times 2^-24) is a large part of it, and
# the update multiplies that error by lr*eps/(|g| + eps)^2 (2500 at
# |g| = eps). So a parameter element is held to RTOL/ATOL unless every
# gradient it saw was below TINY_G (its moment below TINY_G^2; half the
# deep tower's weights: dead relus), and those to TINY_G_ATOL, a hundredth
# of one step's move of lr (measured at most 4.2e-5, in 5 of the 331,600
# deep-tower weights of Wide&Deep; 0 elsewhere)
TINY_G, TINY_G_ATOL = 1e-4, 1e-4
VOCAB, B, SLOTS, DENSE, LR, STEPS = 1001, 64, 26, 13, 0.01, 3
CPU = torch.device("cpu")
# torch's vectorized float32 sqrt on the CPU is 1 ulp from the correctly
# rounded one in places (numpy's and XLA's; measured), and XLA contracts
# m + g*g into a fused multiply-add: adagrad and adam, 1 ulp (the card's
# sqrtf is correctly rounded)
SQRT_ULP = 1


def _rng(seed=0):
    return np.random.default_rng(seed)


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _names(slot, value):
    if isinstance(value, list):
        return [f"{slot.lower()}{i}" for i in range(len(value))]
    return [slot.lower()]


def _op(op_type, inputs, outputs, attrs):
    """An op view over `inputs` (slot -> array, or list of arrays) and
    `outputs` (slot -> names), and the env of its inputs by name."""
    op = _Op(op_type, {}, [], attrs)
    op._inputs = {s: _names(s, v) for s, v in inputs.items()}
    op._outputs = {s: list(ns) for s, ns in outputs.items()}
    env = {}
    for s, v in inputs.items():
        env.update(zip(_names(s, v), v if isinstance(v, list) else [v]))
    return op, env


def _run(op_type, op, jenv, penv):
    JAX_OPS.get(op_type).lowering(JaxContext(op, jenv))
    PT_OPS.get(op_type).lowering(PtContext(op, penv, CPU))


def _both(op_type, inputs, outputs, attrs):
    """Run op_type in both packages; returns (jax env, port env) as
    numpy-convertible values."""
    op, env = _op(op_type, inputs, outputs, attrs)
    jenv = {n: jnp.asarray(a) for n, a in env.items()}
    penv = {n: torch.from_numpy(np.array(a)) for n, a in env.items()}
    _run(op_type, op, jenv, penv)
    return jenv, penv


def _close(j, p, tol=OP_TOL, msg=""):
    j, p = np.asarray(j), p.detach().numpy()
    assert j.shape == p.shape and j.dtype == p.dtype, (msg, j.shape,
                                                       p.shape)
    np.testing.assert_allclose(p, j, rtol=tol, atol=tol, err_msg=msg)


# ---------------------------------------------------------------------------
# the new ops and their gradients
# ---------------------------------------------------------------------------

def _labels(rng, shape, ignore=None):
    lab = rng.integers(0, 2, shape).astype(np.float32)
    if ignore is not None:
        lab[0, 0] = lab[-1, -1] = ignore
    return lab


def _op_cases():
    r = _rng(3)
    x = _f32(r, 4, 3, 5)
    logits = 3 * _f32(r, 6, 2)
    return [
        ("flatten", {"X": x}, {"axis": 1}),
        ("flatten", {"X": x}, {"axis": 2}),
        ("flatten", {"X": x}, {"axis": 0}),
        ("flatten2", {"X": x}, {"axis": 1}),
        ("concat", {"X": [_f32(r, 4, 3), _f32(r, 4, 5), _f32(r, 4, 1)]},
         {"axis": 1}),
        ("concat", {"X": [_f32(r, 2, 3), _f32(r, 5, 3)]}, {"axis": 0}),
        ("sigmoid", {"X": 4 * _f32(r, 5, 7)}, {}),
        ("sigmoid_cross_entropy_with_logits",
         {"X": logits, "Label": _labels(r, (6, 2))},
         {"ignore_index": -100, "normalize": False}),
        ("sigmoid_cross_entropy_with_logits",
         {"X": logits, "Label": _labels(r, (6, 2), ignore=-1)},
         {"ignore_index": -1, "normalize": False}),
        ("sigmoid_cross_entropy_with_logits",
         {"X": logits, "Label": _labels(r, (6, 2), ignore=-1)},
         {"ignore_index": -1, "normalize": True}),
        ("elementwise_sub", {"X": _f32(r, 4, 3), "Y": _f32(r, 4, 3)},
         {"axis": -1}),
        ("elementwise_sub", {"X": _f32(r, 4, 3, 2), "Y": _f32(r, 3)},
         {"axis": 1}),
    ]


_OP_CASES = _op_cases()


@pytest.mark.parametrize("case", range(len(_OP_CASES)),
                         ids=[f"{c[0]}-{i}" for i, c in
                              enumerate(_OP_CASES)])
def test_op_and_its_grad_match_jax(case):
    op_type, inputs, attrs = _OP_CASES[case]
    outs = {"Out": ["out"]}
    if op_type == "flatten2":
        outs["XShape"] = ["xshape"]
    jenv, penv = _both(op_type, inputs, outs, attrs)
    _close(jenv["out"], penv["out"], msg=op_type)
    if op_type == "flatten2":
        assert tuple(penv["xshape"].shape) == (0,) + inputs["X"].shape
    # the gradient of every float input under one cotangent
    out = np.asarray(jenv["out"])
    ct = _f32(_rng(case), *out.shape)
    diff = [s for s in inputs if s != "Label"]
    g_in = dict(inputs, Out=out, **{"Out@GRAD": ct})
    g_outs = {s + "@GRAD": [n + "@g" for n in _names(s, inputs[s])]
              for s in diff}
    op, env = _op(op_type + "_grad", g_in, g_outs, attrs)
    jenv = {n: jnp.asarray(a) for n, a in env.items()}
    penv = {n: torch.from_numpy(np.array(a)) for n, a in env.items()}
    _run(op_type + "_grad", op, jenv, penv)
    for names in g_outs.values():
        for n in names:
            _close(jenv[n], penv[n], msg=f"{op_type} {n}")


def test_adagrad_dense_is_0_ulp_from_jax():
    r = _rng(5)
    n = 4097
    ins = {"Param": _f32(r, n), "Grad": _f32(r, n),
           "Moment": np.abs(_f32(r, n)),
           "LearningRate": np.array([0.01], np.float32)}
    outs = {"ParamOut": ["p_out"], "MomentOut": ["m_out"]}
    jenv, penv = _both("adagrad", ins, outs, {"epsilon": 1e-6})
    for n_ in ("p_out", "m_out"):
        j, p = np.asarray(jenv[n_]), penv[n_].numpy()
        assert p.dtype == j.dtype == np.float32
        assert _ulps(p, j).max() <= SQRT_ULP, n_


# ---------------------------------------------------------------------------
# SelectedRows
# ---------------------------------------------------------------------------

HEIGHT, DIM = 12, 3


def _sparse(seed, n=20, padding_idx=None, all_parked=False):
    """(jax SelectedRows, port SelectedRows) of n slots over HEIGHT rows
    with duplicates; ids at padding_idx (and, with all_parked, every
    slot) parked at HEIGHT."""
    r = _rng(seed)
    ids = r.integers(0, HEIGHT - 2, n)     # duplicates; rows 10, 11 free
    ids[:3] = ids[3]                       # at least one triple
    if padding_idx is not None:
        ids[[1, 7, 12]] = padding_idx
    rows = np.where(ids == padding_idx, HEIGHT, ids) \
        if padding_idx is not None else ids
    if all_parked:
        rows = np.full(n, HEIGHT)
    vals = _f32(r, n, DIM)
    return (JaxRows(jnp.asarray(rows, jnp.int32), jnp.asarray(vals),
                    HEIGHT),
            PtRows(torch.tensor(rows, dtype=torch.int64),
                   torch.from_numpy(vals), HEIGHT))


@pytest.mark.parametrize("padding_idx", [None, 4])
def test_merge_rows_matches_jax(padding_idx):
    js, ps = _sparse(1, padding_idx=padding_idx)
    jr, jv = jax_merge_rows(js.rows, js.values, HEIGHT)
    pr, pv = pt_merge_rows(ps.rows, ps.values, HEIGHT)
    np.testing.assert_array_equal(pr.numpy(), np.asarray(jr))
    assert _ulps(pv.numpy(), np.asarray(jv)).max() == 0
    _close(js.merged().to_dense(), ps.merged().to_dense(), tol=0)
    _close(js.to_dense(), ps.to_dense(), tol=0)
    # the merge keeps the static length; unused slots are parked
    assert pr.shape == ps.rows.shape and (pr == HEIGHT).any()


@pytest.mark.parametrize("padding_idx", [-1, 0, 5])
def test_lookup_table_grad_sparse_matches_jax(padding_idx):
    r = _rng(2)
    w = _f32(r, HEIGHT, DIM)
    ids = r.integers(0, HEIGHT, (6, 4, 1)).astype(np.int64)
    ids[0, :3] = 5                          # duplicates, padding_idx 5
    ids[1, 1] = 0
    attrs = {"is_sparse": True, "padding_idx": padding_idx}
    jenv, penv = _both("lookup_table", {"W": w, "Ids": ids},
                       {"Out": ["out"]}, attrs)
    _close(jenv["out"], penv["out"], tol=0)
    ct = _f32(r, 6, 4, DIM)
    op, env = _op("lookup_table_grad",
                  {"W": w, "Ids": ids, "Out": np.asarray(jenv["out"]),
                   "Out@GRAD": ct}, {"W@GRAD": ["dw"]}, attrs)
    jenv = {n: jnp.asarray(a) for n, a in env.items()}
    penv = {n: torch.from_numpy(np.array(a)) for n, a in env.items()}
    _run("lookup_table_grad", op, jenv, penv)
    jg, pg = jenv["dw"], penv["dw"]
    assert isinstance(pg, PtRows) and pg.height == HEIGHT
    np.testing.assert_array_equal(pg.rows.numpy(), np.asarray(jg.rows))
    _close(jg.values, pg.values, tol=0)
    _close(jg.to_dense(), pg.to_dense(), tol=0)
    # the dense gradient of the same lookup, through both packages
    dense = dict(attrs, is_sparse=False)
    op, env = _op("lookup_table_grad",
                  {"W": w, "Ids": ids, "Out": np.asarray(jenv["out"]),
                   "Out@GRAD": ct}, {"W@GRAD": ["dw"]}, dense)
    penv = {n: torch.from_numpy(np.array(a)) for n, a in env.items()}
    PT_OPS.get("lookup_table_grad").lowering(PtContext(op, penv, CPU))
    _close(jg.to_dense(), penv["dw"], tol=1e-6)


def test_sum_and_scale_of_selected_rows_match_jax():
    (ja, pa), (jb, pb) = _sparse(3), _sparse(4, padding_idx=2)
    dense = _f32(_rng(5), HEIGHT, DIM)
    op = _Op("sum", {}, ["Out"], {})
    op._inputs = {"X": ["a", "b"]}
    jenv, penv = {"a": ja, "b": jb}, {"a": pa, "b": pb}
    _run("sum", op, jenv, penv)
    js, ps = jenv["out_out"], penv["out_out"]
    assert isinstance(ps, PtRows) and ps.rows.shape == (40,)
    np.testing.assert_array_equal(ps.rows.numpy(), np.asarray(js.rows))
    _close(js.to_dense(), ps.to_dense(), tol=0)
    # a SelectedRows and a dense tensor: summed densely
    op._inputs = {"X": ["a", "d"]}
    jenv = {"a": ja, "d": jnp.asarray(dense)}
    penv = {"a": pa, "d": torch.from_numpy(dense.copy())}
    _run("sum", op, jenv, penv)
    _close(jenv["out_out"], penv["out_out"], tol=0)
    # scale, without a bias; with one it is refused
    op = _Op("scale", {}, ["Out"], {"scale": 0.37, "bias": 0.0})
    op._inputs = {"X": ["b"]}
    jenv, penv = {"b": jb}, {"b": pb}
    _run("scale", op, jenv, penv)
    assert isinstance(penv["out_out"], PtRows)
    _close(jenv["out_out"].to_dense(), penv["out_out"].to_dense(), tol=0)
    op._attrs["bias"] = 1.0
    with pytest.raises(ValueError, match="bias"):
        PT_OPS.get("scale").lowering(PtContext(op, {"b": pb}, CPU))


def test_merge_and_get_tensor_from_selected_rows_match_jax():
    js, ps = _sparse(6, padding_idx=3)
    for op_type in ("merge_selected_rows", "get_tensor_from_selected_rows"):
        op = _Op(op_type, {}, ["Out"], {})
        op._inputs = {"X": ["x"]}
        jenv, penv = {"x": js}, {"x": ps}
        _run(op_type, op, jenv, penv)
        j, p = jenv["out_out"], penv["out_out"]
        if op_type == "merge_selected_rows":
            np.testing.assert_array_equal(p.rows.numpy(),
                                          np.asarray(j.rows))
            j, p = j.values, p.values
        _close(j, p, tol=0)
        with pytest.raises(TypeError, match="SelectedRows"):
            PT_OPS.get(op_type).lowering(
                PtContext(op, {"x": torch.zeros(3)}, CPU))


_SPARSE_OPTS = {
    "sgd": ({}, [], ["ParamOut"]),
    "momentum": ({"mu": 0.9, "use_nesterov": False}, ["Velocity"],
                 ["ParamOut", "VelocityOut"]),
    "momentum_nesterov": ({"mu": 0.9, "use_nesterov": True}, ["Velocity"],
                          ["ParamOut", "VelocityOut"]),
    "adagrad": ({"epsilon": 1e-6}, ["Moment"], ["ParamOut", "MomentOut"]),
    "adam": ({"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8},
             ["Moment1", "Moment2", "Beta1Pow", "Beta2Pow"],
             ["ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut",
              "Beta2PowOut"]),
}


def _sparse_opt_both(name, grad_pair, seed=7):
    """One sparse update of `name` through both packages: returns
    {slot: (jax numpy, port numpy)} and the port's inputs before it."""
    attrs, state, outs = _SPARSE_OPTS[name]
    op_type = name.split("_")[0]
    r = _rng(seed)
    ins = {"Param": _f32(r, HEIGHT, DIM),
           "LearningRate": np.array([0.05], np.float32)}
    for s in state:
        ins[s] = np.array([0.9 ** 3 if s == "Beta1Pow" else 0.999 ** 3],
                          np.float32) if s.endswith("Pow") \
            else np.abs(_f32(r, HEIGHT, DIM))
    op = _Op(op_type, ins, outs, attrs)
    op._inputs["Grad"] = ["grad"]
    jg, pg = grad_pair
    jenv = {s.lower(): jnp.asarray(a) for s, a in ins.items()}
    penv = {s.lower(): torch.from_numpy(np.array(a))
            for s, a in ins.items()}
    jenv["grad"], penv["grad"] = jg, pg
    _run(op_type, op, jenv, penv)
    return ({s: (np.asarray(jenv[op.output(s)[0]]),
                 penv[op.output(s)[0]].numpy()) for s in outs}, ins)


@pytest.mark.parametrize("name", sorted(_SPARSE_OPTS))
@pytest.mark.parametrize("padding_idx", [None, 4])
def test_sparse_optimizer_matches_jax(name, padding_idx):
    out, ins = _sparse_opt_both(name, _sparse(8, padding_idx=padding_idx))
    bound = SQRT_ULP if name in ("adagrad", "adam") else 0
    for slot, (j, p) in out.items():
        assert p.shape == j.shape and p.dtype == j.dtype == np.float32
        assert _ulps(p, j).max() <= bound, slot
    # rows 10 and 11 are never looked up: untouched, state too
    for slot, (j, p) in out.items():
        src = ins[slot[:-3] if slot.endswith("Out") else slot]
        if src.shape == (HEIGHT, DIM):
            np.testing.assert_array_equal(p[10:], src[10:], err_msg=slot)


@pytest.mark.parametrize("name", sorted(_SPARSE_OPTS))
def test_parked_slots_change_nothing(name):
    """A gradient whose every slot is parked updates no row; a parked
    slot beside live ones leaves row 0 (where the port sends parked
    slots) as it was when row 0 is not looked up."""
    out, ins = _sparse_opt_both(name, _sparse(9, all_parked=True))
    for slot, (j, p) in out.items():
        if p.shape == (HEIGHT, DIM):
            src = ins[slot[:-3]]
            np.testing.assert_array_equal(p, src, err_msg=slot)
            np.testing.assert_array_equal(j, src, err_msg=slot)
    js, ps = _sparse(10, padding_idx=0)   # id 0 is padding: row 0 parked
    assert (ps.rows != 0).all()
    out, ins = _sparse_opt_both(name, (js, ps))
    for slot, (j, p) in out.items():
        if p.shape == (HEIGHT, DIM):
            np.testing.assert_array_equal(p[0], ins[slot[:-3]][0],
                                          err_msg=slot)
            assert _ulps(p, j).max() <= SQRT_ULP, slot


def test_optimizers_refuse_a_torch_sparse_layout():
    op = _Op("adagrad", {"Param": 0, "Grad": 0, "Moment": 0,
                         "LearningRate": 0}, ["ParamOut", "MomentOut"],
             {"epsilon": 1e-6})
    g = torch.sparse_coo_tensor([[0, 2]], [1.0, 2.0], (4,),
                                check_invariants=True)
    env = {"param": torch.zeros(4), "grad": g, "moment": torch.zeros(4),
           "learningrate": torch.tensor([0.1])}
    with pytest.raises(NotImplementedError, match="SelectedRows"):
        PT_OPS.get("adagrad").lowering(PtContext(op, env, CPU))


# ---------------------------------------------------------------------------
# the programs and 3 training steps
# ---------------------------------------------------------------------------

def _build(fl, wd, kind, amp=False):
    """kind: "wide_deep" and "deepfm" are ctr_train's; "sparse" is
    Wide&Deep with is_sparse=True and ctr_train's loss, as a user of the
    JAX package builds it; "twice" looks one sparse table up twice.
    amp: Adagrad under decorate, bf16 with a static loss scale of 8 (the
    scale ops then scale the SelectedRows gradients)."""
    fl.framework.unique_name.reset()
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        if kind in ("wide_deep", "deepfm"):
            cost, _, feeds = wd.ctr_train(kind, vocab_size=VOCAB)
        else:
            L = fl.layers
            slots = L.data("slot_ids", [-1, SLOTS], append_batch_size=False,
                           dtype="int32")
            dense = L.data("dense_feat", [-1, DENSE],
                           append_batch_size=False, dtype="float32")
            label = L.data("ctr_label", [-1, 1], append_batch_size=False,
                           dtype="float32")
            feeds = ["slot_ids", "dense_feat", "ctr_label"]
            if kind == "sparse":
                logit = wd.wide_deep(slots, dense, VOCAB, 16, is_sparse=True)
            else:
                attr = fl.ParamAttr(name="shared.w_0")
                a = L.embedding(slots, [VOCAB, 4], is_sparse=True,
                                padding_idx=0, param_attr=attr)
                b = L.embedding(slots, [VOCAB, 4], is_sparse=True,
                                param_attr=attr)
                h = L.concat([L.flatten(a), L.flatten(L.sigmoid(b)), dense],
                             axis=1)
                logit = L.fc(h, 1, param_attr=fl.ParamAttr(name="out.w_0"),
                             bias_attr=fl.ParamAttr(name="out.b_0"))
            cost = L.mean(L.sigmoid_cross_entropy_with_logits(logit, label))
            L.sigmoid(logit)                  # ctr_train's probability
        opt = fl.optimizer.AdagradOptimizer(LR)
        if amp:
            opt = fl.contrib.mixed_precision.decorate(
                opt, init_loss_scaling=8.0)
        opt.minimize(cost)
    main.random_seed = startup.random_seed = 7
    return main, startup, cost, feeds


def _types(prog):
    return [op.type for op in prog.global_block().ops]


@pytest.mark.parametrize("kind,n_ops,n_startup", [
    ("wide_deep", 55, 23), ("sparse", 55, 23), ("deepfm", 58, 17)])
def test_ctr_program_matches_jax(kind, n_ops, n_startup):
    jmain, jstartup, _, _ = _build(fluid, jax_wd, kind)
    pmain, pstartup, _, _ = _build(pt, pt_wd, kind)
    types = _types(pmain)
    assert types == _types(jmain) and len(types) == n_ops
    assert types.count("adagrad") == len(pmain.all_parameters())
    for j, p in zip(jmain.global_block().ops, pmain.global_block().ops):
        assert p._inputs == j._inputs and p._outputs == j._outputs, p.type
        assert p.all_attrs() == j.all_attrs(), p.type
    assert _types(pstartup) == _types(jstartup)
    assert len(_types(pstartup)) == n_startup
    assert [p.name for p in pmain.all_parameters()] == \
        [p.name for p in jmain.all_parameters()]
    sparse = [op.attr("is_sparse") for op in pmain.global_block().ops
              if op.type == "lookup_table"]
    assert sparse == [kind == "sparse"] * 2


def _batch(seed=0, padding=False):
    """bench.py's batch at vocab 1001 and B=64 (RandomState(0)); with
    padding, some ids are 0 (the padding_idx of the "twice" model)."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, VOCAB, (B, SLOTS)).astype(np.int32)
    if padding:
        ids[::5, 3] = 0
    return {"slot_ids": ids,
            "dense_feat": rng.rand(B, DENSE).astype(np.float32),
            "ctr_label": rng.randint(0, 2, (B, 1)).astype(np.float32)}


def _persistables(prog, scope, to_np):
    return {v.name: to_np(scope.find_var(v.name).get_tensor())
            for v in prog.global_block().vars.values()
            if v.persistable and scope.find_var(v.name) is not None}


def _train_both(kind, batch):
    """STEPS steps through both packages from the JAX package's initial
    parameters; returns (jax losses, port losses, jax state, port
    state) with every persistable after the steps."""
    jmain, jstartup, jcost, feeds = _build(fluid, jax_wd, kind)
    jscope = JaxScope()
    jexe = fluid.Executor(fluid.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    params = {p.name: np.asarray(jscope.find_var(p.name).get_tensor())
              for p in jmain.all_parameters()}
    pmain, pstartup, pcost, _ = _build(pt, pt_wd, kind)
    pscope = pt.Scope()
    pexe = pt.Executor(pt.CPUPlace())
    pexe.run(pstartup, scope=pscope)
    load_params_from_numpy(pscope, params, pt.CPUPlace())
    feed = {k: batch[k] for k in feeds}
    jl, pl = [], []
    for _ in range(STEPS):
        jl.append(float(np.asarray(jexe.run(jmain, feed=feed,
                                            fetch_list=[jcost],
                                            scope=jscope)[0])))
        pl.append(float(pexe.run(pmain, feed=feed, fetch_list=[pcost],
                                 scope=pscope)[0]))
    return (jl, pl, _persistables(jmain, jscope, np.asarray),
            _persistables(pmain, pscope, np.asarray))


@pytest.mark.parametrize("kind", ["wide_deep", "sparse", "deepfm",
                                  "twice"])
def test_three_adagrad_steps_match_jax(kind):
    jl, pl, js, ps = _train_both(kind, _batch(padding=kind == "twice"))
    np.testing.assert_allclose(pl, jl, rtol=RTOL, atol=ATOL)
    assert all(np.isfinite(pl)) and len(set(pl)) == STEPS
    assert set(ps) == set(js) and len(ps) >= 4
    for n in js:
        j = np.asarray(js[n])
        m = js.get(n + "_moment_0")
        atol = ATOL if m is None else \
            np.where(np.asarray(m) < TINY_G ** 2, TINY_G_ATOL, ATOL)
        assert (np.abs(ps[n] - j) <= atol + RTOL * np.abs(j)).all(), n


@pytest.mark.parametrize("amp", [False, True], ids=["float32", "amp"])
def test_sparse_step_equals_dense_step(amp):
    """Wide&Deep with is_sparse=True against is_sparse=False in the port,
    from the same parameters, in float32 and under bf16 AMP with a loss
    scale: the same losses and parameters (the sparse path merges
    duplicate rows before the update, the dense one adds them into the
    table: the same sums)."""
    batch = _batch(1)
    out = {}
    for kind in ("wide_deep", "sparse"):
        main, startup, cost, feeds = _build(pt, pt_wd, kind, amp)
        assert (main._amp is not None) == amp
        scope = pt.Scope()
        exe = pt.Executor(pt.CPUPlace())
        exe.run(startup, scope=scope)
        losses = [float(exe.run(main, feed=batch, fetch_list=[cost],
                                scope=scope)[0]) for _ in range(STEPS)]
        out[kind] = losses, _persistables(main, scope, np.asarray)
    (ld, sd), (ls, ss) = out["wide_deep"], out["sparse"]
    np.testing.assert_allclose(ls, ld, rtol=OP_TOL, atol=OP_TOL)
    for n in sd:
        np.testing.assert_allclose(ss[n], sd[n], rtol=OP_TOL, atol=OP_TOL,
                                   err_msg=n)


def test_twice_looked_up_table_sums_selected_rows():
    """The two sparse gradients of one table meet in a sum op, which
    gives a SelectedRows of both lookups' rows (padding slots parked)."""
    main, startup, cost, _ = _build(pt, pt_wd, "twice")
    sums = [op for op in main.global_block().ops if op.type == "sum"]
    assert len(sums) == 1 and sums[0].output("Out") == ["shared.w_0@GRAD"]
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    batch = _batch(padding=True)
    _, g = exe.run(main, feed=batch, fetch_list=[cost, "shared.w_0@GRAD"],
                   scope=scope, return_numpy=False)
    assert isinstance(g, PtRows) and g.rows.shape == (2 * B * SLOTS,)
    n_pad = int((batch["slot_ids"] == 0).sum())
    assert int((g.rows == VOCAB).sum()) == n_pad


def test_fetched_selected_rows_is_what_jax_gives():
    jmain, jstartup, jcost, feeds = _build(fluid, jax_wd, "sparse")
    pmain, pstartup, pcost, _ = _build(pt, pt_wd, "sparse")
    jscope, pscope = JaxScope(), pt.Scope()
    jexe, pexe = fluid.Executor(fluid.CPUPlace()), pt.Executor(pt.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    pexe.run(pstartup, scope=pscope)
    params = {p.name: np.asarray(jscope.find_var(p.name).get_tensor())
              for p in jmain.all_parameters()}
    load_params_from_numpy(pscope, params, pt.CPUPlace())
    name = "ctr_emb.w_0@GRAD"
    j = jexe.run(jmain, feed=_batch(), fetch_list=[jcost, name],
                 scope=jscope)[1]
    p = pexe.run(pmain, feed=_batch(), fetch_list=[pcost, name],
                 scope=pscope)[1]
    for a in (j, p):
        assert isinstance(a, np.ndarray) and a.shape == () and \
            a.dtype == object
    j, p = j[()], p[()]
    assert isinstance(p, PtRows) and p.height == j.height == VOCAB
    np.testing.assert_allclose(p.to_dense().numpy(),
                               np.asarray(j.to_dense()), rtol=RTOL,
                               atol=ATOL)
