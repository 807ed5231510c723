"""The bucket surface of the optimizer kernels (kernels/fused_optimizer.py
bucket_sweep) and the comm scheduler's bucket planner
(parallel/comm_scheduler.py) in the port against the JAX package.

* The plain version (what bucket_sweep runs on the CPU) equals the JAX
  lowered update (the adam and sgd op lowerings of
  paddle_tpu/ops/optimizer_ops.py) plus the reference's _gate and its
  row window, bit for bit, for every guard and every shard of 4.
* Against the JAX bucket_sweep itself (its Pallas kernel in interpret
  mode, which XLA contracts into fused multiply-adds: it misses its own
  4-ulp gate in tests/test_kernels.py) within SWEEP_RTOL / SWEEP_ATOL,
  with weight decay too.
* ZeRO-1: each of 4 shards writes only its window (the rest bit-equal to
  the input), and the four windows together equal the unsharded sweep;
  a padded row count that the shard count does not divide raises, as in
  the reference; the shard index may be a tensor.
* The guard: nonfinite=1 returns the inputs bit for bit; spike=1 with
  damp 0.5 is the reference's gate.
* The planner: the bucket plan of a 2+2-layer Transformer's training
  program (names, shapes, bytes, dtype, ready op) equals the JAX
  planner's at three caps; plan_stats equal; the flag's cap is read.

Tolerance: SWEEP_RTOL = 1e-5, SWEEP_ATOL = 1e-7 against the Pallas kernel
(measured worst: 2.4e-6 relative on m' near zero, 2.4e-7 absolute: one
or two fused roundings); everything else exact.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as fluid
from paddle_tpu.core.registry import ExecContext as JaxContext
from paddle_tpu.core.registry import OPS as JAX_OPS
from paddle_tpu.kernels import fused_optimizer as jfo
from paddle_tpu.kernels import registry as jreg
from paddle_tpu.models import transformer as jax_transformer
from paddle_tpu.parallel import comm_scheduler as jcs

import paddle_tpu_torch as pt
from paddle_tpu_torch.core.flags import get_flags, set_flags
from paddle_tpu_torch.kernels import fused_optimizer as pfo
from paddle_tpu_torch.models import transformer as pt_transformer
from paddle_tpu_torch.parallel import comm_scheduler as pcs

from test_torch_ops import _Op

SWEEP_RTOL, SWEEP_ATOL = 1e-5, 1e-7
# two 256-row blocks and a ragged tail: 512 padded rows
N = 2 * 256 * 128 - 300
LR, B1P, B2P = 0.01, 0.9 ** 3, 0.999 ** 3
GUARDS = {"none": None, "pass": (0.0, 0.0, 0.0), "spike": (0.0, 1.0, 0.5),
          "nonfinite": (1.0, 0.0, 0.0)}
SHARDS = [None] + [(i, 4) for i in range(4)]


def _inputs(seed=0, n=N):
    rng = np.random.default_rng(seed)
    p, g, m = (rng.standard_normal(n).astype(np.float32) for _ in range(3))
    v = np.abs(rng.standard_normal(n)).astype(np.float32)
    return p, g, m, v


def _bits(a):
    return np.asarray(a).view(np.int32)


def _lowered(kind, p, g, m, v):
    """The JAX adam / sgd op lowering on the whole view."""
    f32 = lambda x: jnp.asarray(np.float32(x)).reshape(1)  # noqa: E731
    if kind == "adam":
        ins = {"Param": p, "Grad": g, "Moment1": m, "Moment2": v,
               "LearningRate": f32(LR), "Beta1Pow": f32(B1P),
               "Beta2Pow": f32(B2P)}
        outs = ["ParamOut", "Moment1Out", "Moment2Out"]
    else:
        ins = {"Param": p, "Grad": g, "LearningRate": f32(LR)}
        outs = ["ParamOut"]
    op = _Op(kind, ins, outs, {"beta1": 0.9, "beta2": 0.999,
                               "epsilon": 1e-8})
    env = {s.lower(): jnp.asarray(a) for s, a in ins.items()}
    JAX_OPS.get(kind).lowering(JaxContext(op, env))
    return [env[s.lower() + "_out"] for s in outs]


def _reference(kind, ins, shard, guard):
    """The lowered update, then the reference's _gate, then its row
    window, in JAX."""
    olds = [jnp.asarray(ins[i]) for i in ((0, 2, 3) if kind == "adam"
                                          else (0,))]
    news = _lowered(kind, *ins)
    if guard is not None:
        nf, sp, damp = (jnp.asarray(np.float32(x)) for x in guard)
        news = [jfo._gate(n, o, nf > 0, sp > 0, damp)
                for n, o in zip(news, olds)]
    rows = np.arange(N) // 128
    lo, hi = (0, pfo.rows_padded(N)) if shard is None else \
        (shard[0] * pfo.rows_padded(N) // 4,
         (shard[0] + 1) * pfo.rows_padded(N) // 4)
    inside = jnp.asarray((rows >= lo) & (rows < hi))
    return [np.asarray(jnp.where(inside, n, o)) for n, o in zip(news, olds)]


def _port(kind, ins, **kw):
    t = [torch.from_numpy(a.copy()) for a in ins]
    if kind == "adam":
        return [o.numpy() for o in pfo.bucket_sweep(
            "adam", *t, lr=LR, beta1_pow=B1P, beta2_pow=B2P, **kw)]
    return [pfo.bucket_sweep("sgd", t[0], t[1], lr=LR, **kw).numpy()]


@pytest.mark.parametrize("shard", SHARDS, ids=str)
@pytest.mark.parametrize("guard", list(GUARDS))
@pytest.mark.parametrize("kind", ["adam", "sgd"])
def test_plain_equals_lowered_update_and_gate(kind, guard, shard):
    ins = _inputs()
    got = _port(kind, ins, shard=shard, guard=GUARDS[guard])
    for a, b in zip(got, _reference(kind, ins, shard, GUARDS[guard])):
        np.testing.assert_array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("wd", [0.0, 0.01])
@pytest.mark.parametrize("kind", ["adam", "sgd"])
def test_matches_jax_bucket_sweep(kind, wd, monkeypatch):
    monkeypatch.setattr(jreg, "_INTERPRET", True, raising=False)
    ins = _inputs(1)
    kw = dict(weight_decay=wd, shard=(1, 4), guard=(0.0, 1.0, 0.25))
    got = _port(kind, ins, **kw)
    if kind == "adam":
        want = jfo.bucket_sweep("adam", *map(jnp.asarray, ins), lr=LR,
                                beta1_pow=B1P, beta2_pow=B2P, **kw)
    else:
        want = [jfo.bucket_sweep("sgd", jnp.asarray(ins[0]),
                                 jnp.asarray(ins[1]), lr=LR, **kw)]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=SWEEP_RTOL,
                                   atol=SWEEP_ATOL)


@pytest.mark.parametrize("kind", ["adam", "sgd"])
def test_four_windows_make_the_unsharded_sweep(kind):
    ins = _inputs(2)
    whole = _port(kind, ins)
    olds = [ins[i] for i in (0, 2, 3)[:len(whole)]]
    merged = [a.copy() for a in olds]
    per = pfo.rows_padded(N) // 4 * 128
    for i in range(4):
        part = _port(kind, ins, shard=(torch.tensor(i), 4))
        lo, hi = i * per, (i + 1) * per
        for out, old, acc in zip(part, olds, merged):
            keep = np.ones(N, bool)
            keep[lo:hi] = False
            np.testing.assert_array_equal(_bits(out[keep]), _bits(old[keep]))
            acc[lo:hi] = out[lo:hi]
    for a, b in zip(merged, whole):
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_rows_that_do_not_divide_raise():
    p = torch.zeros(128 * 256)
    with pytest.raises(ValueError, match="not divisible"):
        pfo.bucket_sweep("sgd", p, p, lr=0.1, shard=(0, 3))
    with pytest.raises(ValueError, match="adam\\|sgd"):
        pfo.bucket_sweep("lamb", p, p, lr=0.1)


@pytest.mark.parametrize("kind", ["adam", "sgd"])
def test_nonfinite_returns_the_inputs(kind):
    ins = list(_inputs(3))
    ins[1][::7] = np.inf          # the gradient that tripped the guard
    got = _port(kind, ins, guard=(1.0, 0.0, 0.0))
    for a, i in zip(got, (0, 2, 3)):
        np.testing.assert_array_equal(_bits(a), _bits(ins[i]))


def test_hyper_table_and_window_are_tensors():
    """Tensors in, tensors on the device in: what a captured graph
    rereads at each replay."""
    h = pfo.sweep_hyper(torch.tensor(0.5), (torch.tensor(1.0), 0.0, 0.25),
                        torch.device("cpu"))
    assert h.dtype == torch.float32 and h.tolist() == [0.5, 1.0, 0.0, 0.25]
    b = pfo.sweep_bounds(512, (torch.tensor(3), 4), torch.device("cpu"))
    assert b.dtype == torch.int64 and b.tolist() == [384, 512]
    assert pfo.sweep_bounds(256, None, torch.device("cpu")).tolist() == \
        [0, 256]
    assert pfo.rows_padded(1) == 256 and pfo.rows_padded(256 * 128 + 1) \
        == 512


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------

def _train_program(fl, mod):
    cfg = mod.transformer_base(src_vocab_size=64, trg_vocab_size=64,
                               fuse_attention=True, dropout=0.0)
    cfg.n_layer, cfg.d_model, cfg.d_inner = 2, 32, 64
    cfg.n_head, cfg.d_head = 4, 8
    fl.framework.unique_name.reset()
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        cost, _, _ = mod.transformer_train(cfg)
        fl.optimizer.AdamOptimizer(1e-3).minimize(cost)
    return main


@pytest.fixture(scope="module")
def programs():
    return (_train_program(fluid, jax_transformer),
            _train_program(pt, pt_transformer))


@pytest.mark.parametrize("cap", [0, 4096, 64 * 1024])
def test_plan_matches_jax(programs, cap):
    jmain, pmain = programs
    jb = jcs.plan_program_buckets(jmain, bucket_bytes=cap)
    pb = pcs.plan_program_buckets(pmain, bucket_bytes=cap)
    assert [b.key() for b in pb] == [b.key() for b in jb]
    assert [(b.bytes, b.last_op_idx, b.size) for b in pb] == \
        [(b.bytes, b.last_op_idx, b.size) for b in jb]
    assert jcs.grad_production_order(jmain) == \
        pcs.grad_production_order(pmain)
    last = max(b.last_op_idx for b in jb) + 1
    for mode in ("", "int8"):
        assert pcs.plan_stats(pb, last, mode) == \
            jcs.plan_stats(jb, last, mode)
    assert len(pb) == 1 if cap == 0 else len(pb) > 1


def test_plan_reads_the_flag(programs):
    _, pmain = programs
    old = get_flags("allreduce_bucket_mb")
    try:
        set_flags({"FLAGS_allreduce_bucket_mb": 0.004})
        assert pcs.bucket_bytes_from_flags() == int(0.004 * 1024 * 1024)
        assert [b.key() for b in pcs.plan_program_buckets(pmain)] == \
            [b.key() for b in pcs.plan_program_buckets(
                pmain, bucket_bytes=int(0.004 * 1024 * 1024))]
        set_flags({"FLAGS_allreduce_bucket_mb": -1})
        assert pcs.bucket_bytes_from_flags() == 0
    finally:
        set_flags(old)


def test_named_buckets_seal_on_dtype_and_cap():
    items = [("a", (4,), "float32"), ("b", (300,), "float32"),
             ("c", (2,), "float16"), ("d", (8,), "float32")]
    for cap in (0, 1024, 16):
        assert [b.key() for b in pcs.plan_named_buckets(items, cap)] == \
            [b.key() for b in jcs.plan_named_buckets(items, cap)]
