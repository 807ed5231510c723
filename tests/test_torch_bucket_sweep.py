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
* The kernels' arguments (sweep_args): every scalar takes a pointer slot
  as a tensor (converted to float32 / int64 first where it is not) and a
  value slot as a number; a plain mirror of what the kernel computes from
  the slots (load_sweep in csrc/fused_optimizer.cu: the bias-corrected
  rate in float32, one rounding an operation, and the window) is
  bit-equal to the plain route's hyper table and window (sweep_lr_t,
  sweep_hyper, sweep_bounds) over seeded rates and beta powers, and to
  the JAX bucket_sweep itself (interpret mode) over mixes of numbers and
  tensors: with beta1 = 1, epsilon = 1, p = g = v = 0 and m = 1 the
  Adam step writes p' = -lr_t inside the window (-(lr_t*damp) on a
  spike, 0 on a nonfinite step) and 0 outside, exactly.
* The planner: the bucket plan of a 2+2-layer Transformer's training
  program (names, shapes, bytes, dtype, ready op) equals the JAX
  planner's at three caps; plan_stats equal; the flag's cap is read.

Tolerance: SWEEP_RTOL = 1e-5, SWEEP_ATOL = 1e-7 against the Pallas kernel
(measured worst: 2.4e-6 relative on m' near zero, 2.4e-7 absolute: one
or two fused roundings); everything else exact.
"""
import ctypes

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
from torch_threads import one_torch_thread  # noqa: F401

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
# the kernels' arguments
# ---------------------------------------------------------------------------

CPU = torch.device("cpu")
SCALARS = ("lr", "beta1_pow", "beta2_pow", "nonfinite", "spike", "damp",
           "shard")
NUMBERS = {"lr": 0.01, "beta1_pow": 0.9 ** 3, "beta2_pow": 0.999 ** 3,
           "nonfinite": 0.0, "spike": 1.0, "damp": 0.25, "shard": 2}


def _pack(n, values, num=4):
    """sweep_args with each scalar of `values` as given."""
    v = dict(values)
    return pfo.sweep_args(n, v["lr"], v["beta1_pow"], v["beta2_pow"],
                          (v["shard"], num),
                          (v["nonfinite"], v["spike"], v["damp"]),
                          device=CPU)


@pytest.mark.parametrize("name", SCALARS)
def test_sweep_args_slots(name):
    """A tensor takes a pointer slot (the tensor itself where it is
    float32 / int64 already, else a converted copy the packing keeps), a
    number a value slot; the others stay as they were given."""
    dtype = torch.int64 if name == "shard" else torch.float32
    t = torch.tensor(NUMBERS[name], dtype=dtype)
    args, keep = _pack(N, {**NUMBERS, name: t})
    assert getattr(args, name).ptr == t.data_ptr() and keep == [t]
    assert getattr(args, name).value == 0
    for other in SCALARS:
        if other != name:
            slot = getattr(args, other)
            assert slot.ptr is None
            assert slot.value == (NUMBERS[other] if other == "shard" else
                                  np.float32(NUMBERS[other]))
    other = torch.tensor(NUMBERS[name], dtype=torch.float64)
    args, keep = _pack(N, {**NUMBERS, name: other.reshape(1)})
    (conv,) = keep
    assert conv.dtype == dtype and getattr(args, name).ptr == conv.data_ptr()
    args, keep = _pack(N, NUMBERS)
    assert getattr(args, name).ptr is None and not keep
    assert (args.per, args.fold) == (pfo.rows_padded(N) // 4, 1)


def test_sweep_args_fold_and_rows():
    """No beta powers: no fold (the rate as given, sgd's case); no shard:
    one window of every padded row; a count the shards do not divide
    raises as the plain route does."""
    args, _ = pfo.sweep_args(N, 0.5, device=CPU)
    assert (args.fold, args.per, args.shard.value) == \
        (0, pfo.rows_padded(N), 0)
    args, _ = pfo.sweep_args(N, 0.5, 0.9, None, device=CPU)
    assert args.fold == 0
    with pytest.raises(ValueError, match="not divisible"):
        pfo.sweep_args(N, 0.5, shard=(0, 3), device=CPU)


def _read(slot, ctype):
    return ctype.from_address(slot.ptr).value if slot.ptr else slot.value


def _kernel_scalars(args):
    """What load_sweep (csrc/fused_optimizer.cu) computes from the slots,
    in numpy float32: (lr_t, spike, damp, lo, hi), the window in elements
    (empty on a nonfinite step)."""
    f32 = np.float32
    lr = f32(_read(args.lr, ctypes.c_float))
    if args.fold:
        b1p = f32(_read(args.beta1_pow, ctypes.c_float))
        b2p = f32(_read(args.beta2_pow, ctypes.c_float))
        lr = (lr * np.sqrt(f32(1) - b2p)) / (f32(1) - b1p)
    spike = f32(_read(args.spike, ctypes.c_float)) > 0
    damp = f32(_read(args.damp, ctypes.c_float))
    idx = _read(args.shard, ctypes.c_int64)
    if f32(_read(args.nonfinite, ctypes.c_float)) > 0:
        return lr, spike, damp, 0, 0
    lo = idx * args.per * 128
    return lr, spike, damp, lo, lo + args.per * 128


def _as(kind, x):
    """x as a number or as a one-element tensor of another dtype than the
    slot's (float64 / int32: the packing converts it)."""
    if kind == "number" or isinstance(x, torch.Tensor):
        return x
    return torch.tensor([x], dtype=torch.int32 if isinstance(x, int)
                        else torch.float64)


def test_mirror_equals_the_plain_route():
    """The kernel's scalars against the plain route's hyper table and
    window, bit for bit, over 1000 seeded rates and beta powers (the
    fold's square root is correctly rounded on both sides)."""
    rng = np.random.default_rng(19)
    rows = pfo.rows_padded(N)
    for i in range(1000):
        lr = float(10.0 ** rng.uniform(-6, 0))
        b1p, b2p = (float(b ** rng.integers(1, 5000))
                    for b in (0.9, 0.999))
        guard = (float(i % 7 == 0), float(i % 3 == 0), float(rng.random()))
        shard = (int(rng.integers(0, 4)), 4)
        kind = ("number", "tensor")[i % 2]
        args, keep = pfo.sweep_args(
            N, _as(kind, lr), _as(kind, b1p), b2p,
            (_as(kind, shard[0]), 4), tuple(_as(kind, x) for x in guard),
            device=CPU)
        lr_t, spike, damp, lo, hi = _kernel_scalars(args)
        hyper = pfo.sweep_hyper(pfo.sweep_lr_t(lr, b1p, b2p, CPU), guard,
                                CPU)
        bounds = pfo.sweep_bounds(rows, shard, CPU)
        assert np.float32(lr_t).view(np.int32) == \
            hyper[0].numpy().view(np.int32), (lr, b1p, b2p)
        assert spike == bool(hyper[2] > 0) and damp == hyper[3].item()
        if hyper[1] > 0:
            assert lo == hi == 0
        else:
            assert (lo, hi) == tuple(128 * bounds.numpy())


MIXES = {
    "numbers": {},
    "tensors": {n: "tensor" for n in SCALARS},
    "rate and index": {"lr": "tensor", "shard": "tensor"},
    "beta powers": {"beta1_pow": "tensor", "beta2_pow": "tensor"},
    "guard spike": {"spike": "tensor", "damp": "tensor"},
    "guard nonfinite": {"nonfinite": "tensor"},
}
MIX_VALUES = {"numbers": (0.003, 0.9 ** 7, 0.999 ** 7, 0.0, 0.0, 0.0, 1),
              "tensors": (0.0123, 0.9 ** 2, 0.999 ** 2, 0.0, 1.0, 0.3, 3),
              "rate and index": (1e-4, 0.9 ** 40, 0.999 ** 40, 0.0, 0.0,
                                 0.0, 0),
              "beta powers": (0.5, 0.9 ** 1, 0.999 ** 1, 0.0, 0.0, 0.0, 2),
              "guard spike": (2e-3, 0.9 ** 5, 0.999 ** 5, 0.0, 1.0, 0.7, 1),
              "guard nonfinite": (2e-3, 0.9 ** 5, 0.999 ** 5, 1.0, 0.0,
                                  0.0, 3)}


@pytest.mark.parametrize("mix", list(MIXES))
def test_mirror_equals_jax_bucket_sweep(mix, monkeypatch):
    """The JAX bucket_sweep writes p' = -lr_t (spike: -(lr_t*damp);
    nonfinite: 0) inside its window and 0 outside when beta1 = 1,
    epsilon = 1, p = g = v = 0 and m = 1 (every other operation is
    exact); so does the port's plain route; both equal what the kernel
    computes from the packed slots, bit for bit."""
    monkeypatch.setattr(jreg, "_INTERPRET", True, raising=False)
    n = 256 * 128
    values = dict(zip(SCALARS, MIX_VALUES[mix]))
    kinds = {name: MIXES[mix].get(name, "number") for name in SCALARS}
    args, keep = pfo.sweep_args(
        n, *(_as(kinds[k], values[k]) for k in SCALARS[:3]),
        (_as(kinds["shard"], values["shard"]), 4),
        tuple(_as(kinds[k], values[k]) for k in SCALARS[3:6]),
        device=CPU)
    lr_t, spike, damp, lo, hi = _kernel_scalars(args)
    inside = np.float32(-lr_t) * damp if spike else np.float32(-lr_t)
    want = np.zeros(n, np.float32)
    want[lo:hi] = inside

    def jx(name):
        x = values[name]
        if kinds[name] == "number":
            return x
        return jnp.asarray(x, jnp.int32 if name == "shard" else jnp.float32)

    zeros, ones = np.zeros(n, np.float32), np.ones(n, np.float32)
    kw = dict(beta1=1.0, epsilon=1.0, shard=(jx("shard"), 4),
              guard=tuple(jx(k) for k in SCALARS[3:6]))
    got_jax = jfo.bucket_sweep("adam", *map(jnp.asarray, (zeros, zeros,
                                                         ones, zeros)),
                               lr=jx("lr"), beta1_pow=jx("beta1_pow"),
                               beta2_pow=jx("beta2_pow"), **kw)[0]
    t = [torch.from_numpy(a.copy()) for a in (zeros, zeros, ones, zeros)]
    got_port = pfo.bucket_sweep(
        "adam", *t, lr=_as(kinds["lr"], values["lr"]),
        beta1_pow=_as(kinds["beta1_pow"], values["beta1_pow"]),
        beta2_pow=_as(kinds["beta2_pow"], values["beta2_pow"]),
        beta1=1.0, epsilon=1.0,
        shard=(_as(kinds["shard"], values["shard"]), 4),
        guard=tuple(_as(kinds[k], values[k]) for k in SCALARS[3:6]))[0]
    np.testing.assert_array_equal(_bits(got_jax), _bits(want))
    np.testing.assert_array_equal(_bits(got_port.numpy()), _bits(want))


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
