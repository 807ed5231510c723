#!/usr/bin/env python3
"""Drive paddle_tpu_torch on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

1. Requires a CUDA device (exits non-zero without one) and prints the
   card's name and power limit as nvidia-smi reports them.
2. Builds every kernel of the port from paddle_tpu_torch/csrc with nvcc
   (one process per source, all at once) and prints the build seconds.
3. Kernel phase: holds each kernel against its plain PyTorch version on
   the card, in float32 and bf16: the flash-attention forward (without
   and with attention dropout), its dq and dk/dv backward kernels, and
   Adam. Then times kernel, plain version and the library yardstick:
   the forward at the serving shape, and all four kernels at the
   training shape (B=96, S=128, H=8, D=64, bf16; Adam over the 255
   parameters of Transformer-base).
4. Serving phase: builds full-width Transformer-base (6+6 layers,
   d_model 512, 8 heads, vocab 32000, fuse_attention) with the port's
   layers, initializes it on the card from a seed, and scores 3 ragged
   batches of 32 x 256 tokens through Executor.run. Checks finite logits
   and cost, 18 attention launches per forward, and the logits against
   the same forward under plain_reference().
5. Training phase: the same model as bench.py trains it (dropout 0.1,
   contrib.mixed_precision.decorate(AdamOptimizer(2e-4)): bf16 compute,
   float32 master weights) takes 5 steps on one ragged batch of
   96 x 128. Checks a finite, falling loss, exactly 18 forward, 18 dq,
   18 dk/dv and 255 Adam launches per step, and one step from a copy of
   the initial scope under plain_reference() against the kernels' first
   step. Prints steps/s, tokens/s, peak memory and a profile of one step.
6. Prints one JSON line of per-kernel numbers, then, last, the device
   line {"ok": true, "device": {...}}. Any failed check raises: the
   script exits non-zero and prints no result.

float32 matmuls run in full float32 (TF32 off), as the port assumes.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 1234

# tolerances of the kernel phase: float32 differs from the plain version
# only in the order of float32 sums; bf16 rounds p and out to bf16
F32_TOL = 1e-5
BF16_TOL = 2e-2
# backward, float32: each gradient sums up to S products of the
# recomputed p, in another order than the plain version's matmuls
BWD_F32_TOL = 1e-4
# Adam: both round each operation once, in the same order
ADAM_ULP = 1
# whole-forward logits, kernel vs plain_reference(): the attention
# outputs' float32 rounding differences (~5e-7), carried through 12
# layers and 30 layer norms; logits have std ~0.45 at this
# initialization, and the measured difference is ~2e-6
LOGITS_ATOL = 1e-4
COST_RTOL = 1e-4

# one training step from copies of the initial scope: the kernels' bf16
# step against the same step under plain_reference() and against the
# same Program run in float32 (no AMP, same dropout masks).
# * the loss to a relative LOSS_STEP_RTOL (bf16 outputs of the attention
#   round differently where the float32 sums differ in their last bits);
# * the gradients, read from the first moments (m = 0.1 g after one step)
#   in the norm over all parameters: the kernels' bf16 gradients must be
#   as close to the float32 ones as the plain version's bf16 gradients
#   are, within GRAD_NOISE_RATIO of that distance. bf16 keeps 8 bits, and
#   its rounding, not the kernels, sets how far a bf16 step is from the
#   float32 one;
# * a parameter to at most 2 * lr: Adam's first step moves an element by
#   lr * g / (|g| + 3.2e-7), about lr in the gradient's sign, so where a
#   gradient near zero takes the other sign two steps part by up to
#   2 * lr (the key biases' gradients are zero but for rounding noise).
LOSS_STEP_RTOL = 1e-3
GRAD_NOISE_RATIO = 1.5

# Published peaks (NVIDIA data sheets, dense): float32 outside the tensor
# cores and bf16 in them, in FLOP/s, and HBM bytes/s. Keyed by the name
# torch reports.
_PEAKS = {"PCIe": (51e12, 756e12, 2.0e12), "NVL": (60e12, 835e12, 3.9e12),
          "SXM": (67e12, 989e12, 3.35e12)}

# the training shape: bench.py's Transformer-base batch
TRAIN_B, TRAIN_S, LR = 96, 128, 2e-4


def _require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def _peaks(name):
    for key in ("PCIe", "NVL"):
        if key in name:
            return _PEAKS[key]
    return _PEAKS["SXM"]   # "H100 80GB HBM3" is the SXM part


def _time_ms(fn, iters=30, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _attn_inputs(torch, dev, dtype, layout, B, H, Sq, Sk, D, bias_kind,
                 pad_all=False, seed=0):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def t(S):
        shape = (B, S, H, D) if layout == "bshd" else (B, H, S, D)
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    q, k, v = t(Sq), t(Sk), t(Sk)
    if bias_kind == "key_pad":
        lens = torch.randint(1, Sk + 1, (B,), generator=g, device=dev)
        lens[0] = Sk
        if pad_all:
            lens[-1] = 0          # every key of the last row padded
        keep = torch.arange(Sk, device=dev)[None, :] < lens[:, None]
        bias = torch.where(keep, 0.0, -1e9)[:, None, None, :].float()
    elif bias_kind == "per_head":
        bias = torch.randn((B, H, Sq, Sk), generator=g, device=dev)
    else:
        bias = None
    return q, k, v, bias


# (name, layout, B, H, Sq, Sk, D, bias, causal, pad_all)
_CASES = [
    ("bshd key-padding bias", "bshd", 4, 8, 256, 256, 64, "key_pad",
     False, False),
    ("bshd causal + bias", "bshd", 4, 8, 256, 256, 64, "key_pad", True,
     False),
    ("cross Sq != Sk", "bshd", 4, 8, 192, 256, 64, "key_pad", False,
     False),
    ("bhsd per-head bias", "bhsd", 2, 8, 128, 160, 64, "per_head", True,
     False),
    ("ragged S=77, D=96", "bshd", 3, 4, 77, 77, 96, "key_pad", True,
     False),
    ("ragged Sq=50 Sk=130, D=128", "bhsd", 2, 3, 50, 130, 128, "key_pad",
     False, False),
    ("rows with all keys padded", "bshd", 4, 8, 128, 128, 64, "key_pad",
     False, True),
    ("serving shape", "bshd", 32, 8, 256, 256, 64, "key_pad", False,
     False),
    ("serving shape, causal", "bshd", 32, 8, 256, 256, 64, "key_pad",
     True, False),
    ("training shape", "bshd", TRAIN_B, 8, TRAIN_S, TRAIN_S, 64, "key_pad",
     False, False),
    ("training shape, causal", "bshd", TRAIN_B, 8, TRAIN_S, TRAIN_S, 64,
     "key_pad", True, False),
]
# attention dropout: (seed word 0, seed word 1, keep threshold t);
# t = 230 is dropout 0.1, the training path's
_DROPOUTS = [(0x12345678, 0x9ABCDEF0, 230), (7, 11, 128)]


def _close(torch, got, ref, tol):
    """(max |err|, ok) of got against ref at tolerance tol, relative and
    absolute."""
    err = (got.float() - ref.float()).abs()
    ok = bool((err <= tol + tol * ref.float().abs()).all()
              and torch.isfinite(got.float()).all())
    return err.max().item(), ok


def _dname(torch, dtype):
    return str(dtype).replace("torch.", "")


def kernel_phase(torch, dev):
    """Every attention kernel against its plain version over the case
    list, without and with dropout; returns {(kernel, dtype, case):
    max |err|}."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    worst = {}
    for dtype, tol, btol in ((torch.float32, F32_TOL, BWD_F32_TOL),
                             (torch.bfloat16, BF16_TOL, BF16_TOL)):
        dname = _dname(torch, dtype)
        for (name, layout, B, H, Sq, Sk, D, bias_kind, causal,
             pad_all) in _CASES:
            q, k, v, bias = _attn_inputs(torch, dev, dtype, layout, B, H,
                                         Sq, Sk, D, bias_kind, pad_all)
            scale = D ** -0.5
            for drop in [None] + _DROPOUTS:
                tag = "" if drop is None else f" drop t={drop[2]}"
                out, lse = fa.fused_attention_forward(
                    q, k, v, bias, scale, causal, layout, return_lse=True,
                    dropout=drop)
                ref, ref_lse = fa.fused_attention_plain(
                    q, k, v, bias, scale, causal, layout, return_lse=True,
                    dropout=drop)
                torch.cuda.synchronize()
                err, ok = _close(torch, out, ref, tol)
                lerr, lok = _close(torch, lse, ref_lse, tol)
                print(f"  fwd vs plain [{dname:8s}] {name + tag:36s} "
                      f"out max|err|={err:.3e} lse max|err|={lerr:.3e} "
                      f"tol={tol:g} {'ok' if ok and lok else 'FAIL'}")
                _require(ok and lok, f"flash_attention_fwd {dname} "
                                     f"{name}{tag} disagrees with its "
                                     f"plain version")
                worst[("flash_attention_fwd", dname, name + tag)] = err

                g = torch.randn(q.shape, device=dev,
                                generator=torch.Generator(device=dev)
                                .manual_seed(3)).to(dtype)
                want_dbias = bias_kind == "per_head"
                got = fa.fused_attention_backward(
                    q, k, v, bias, ref, ref_lse, g, scale, causal, layout,
                    dropout=drop, want_dbias=want_dbias)
                exp = fa.fused_attention_backward_plain(
                    q, k, v, bias, ref, ref_lse, g, scale, causal, layout,
                    dropout=drop, want_dbias=want_dbias)
                torch.cuda.synchronize()
                errs = {}
                for gname, a, r in zip(("dq", "dk", "dv", "dbias"), got,
                                       exp):
                    if r is None:
                        continue
                    errs[gname], ok = _close(torch, a, r, btol)
                    ok = ok and r.abs().max().item() > 0   # not vacuous
                    _require(ok, f"flash attention backward {gname} "
                                 f"{dname} {name}{tag} disagrees with its "
                                 f"plain version")
                print(f"  bwd vs plain [{dname:8s}] {name + tag:36s} "
                      + " ".join(f"{k}={e:.3e}" for k, e in errs.items())
                      + f" tol={btol:g} ok")
                worst[("flash_attention_bwd_dq", dname, name + tag)] = \
                    errs["dq"]
                worst[("flash_attention_bwd_dkv", dname, name + tag)] = \
                    max(errs["dk"], errs["dv"])
    return worst


def _ulps(torch, a, b):
    """Distance in units in the last place between float32 tensors."""
    ia = a.view(torch.int32).long()
    ib = b.view(torch.int32).long()
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return (ia - ib).abs()


def _adam_state(torch, dev, n, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    p = torch.randn(n, device=dev, generator=g)
    grad = torch.randn(n, device=dev, generator=g) * 1e-2
    m = torch.randn(n, device=dev, generator=g) * 1e-3
    v = torch.rand(n, device=dev, generator=g) * 1e-5
    return p, grad, m, v


def _lr_t(torch, dev, step=3):
    return torch.tensor([LR * (1 - 0.999 ** step) ** 0.5
                         / (1 - 0.9 ** step)], device=dev)


def adam_phase(torch, dev):
    """The Adam kernel against its plain version on lengths that cut
    blocks and a Transformer-base embedding; returns the worst |err| and
    ulp distance."""
    from paddle_tpu_torch.kernels import fused_optimizer as fo
    worst_err, worst_ulp = 0.0, 0
    lr_t = _lr_t(torch, dev)
    for n in (1, 511, 513, 262144, 16384000):
        p, g, m, v = _adam_state(torch, dev, n, n)
        ref = fo.adam_plain(p, g, m, v, lr_t[0], 0.9, 0.999, 1e-8)
        got = fo.fused_adam(p.clone(), g, m.clone(), v.clone(), lr_t)
        torch.cuda.synchronize()
        ulp = max(int(_ulps(torch, a, r).max()) for a, r in zip(got, ref))
        err = max((a - r).abs().max().item() for a, r in zip(got, ref))
        print(f"  adam vs plain n={n:9d}: max ulp {ulp}, max|err| "
              f"{err:.3e} (bound {ADAM_ULP} ulp) "
              f"{'ok' if ulp <= ADAM_ULP else 'FAIL'}")
        _require(ulp <= ADAM_ULP, f"fused_adam n={n} is {ulp} ulp from "
                                  f"its plain version")
        worst_err, worst_ulp = max(worst_err, err), max(worst_ulp, ulp)
    return worst_err, worst_ulp


def time_attention(torch, dev, card):
    """Kernel, plain and library times at the serving shape, and the
    bound for the same work."""
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import flash_attention as fa
    peak_flops, _, peak_bw = _peaks(card)
    B, H, S, D = 32, 8, 256, 64
    q, k, v, bias = _attn_inputs(torch, dev, torch.float32, "bshd", B, H,
                                 S, S, D, "key_pad", seed=7)
    scale = D ** -0.5
    res = {}
    for causal in (False, True):
        kern = _time_ms(lambda: fa.fused_attention_forward(
            q, k, v, bias, scale, causal, "bshd"))
        plain = _time_ms(lambda: fa.fused_attention_plain(
            q, k, v, bias, scale, causal, "bshd"))
        pairs = S * (S + 1) // 2 if causal else S * S
        flops = 4 * B * H * pairs * D
        nbytes = 4 * q.numel() * 4 + bias.numel() * 4
        bound_f, bound_b = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
        lib = None
        if not causal:   # sdpa takes no mask together with is_causal
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            lib = _time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=bias, scale=scale))
        res[causal] = {"ms": kern, "plain_ms": plain, "library_ms": lib,
                       "bound_ms": max(bound_f, bound_b),
                       "bound_by": "operations" if bound_f >= bound_b
                       else "bytes", "gflop": flops / 1e9,
                       "mb": nbytes / 1e6}
        print(f"  flash_attention_fwd B={B} S={S} H={H} D={D} "
              f"causal={causal}: kernel {kern:.4f} ms, plain "
              f"{plain:.4f} ms, library "
              f"{'n/a' if lib is None else f'{lib:.4f} ms'}, bound "
              f"{res[causal]['bound_ms']:.4f} ms "
              f"({res[causal]['bound_by']}: {flops / 1e9:.3f} GFLOP at "
              f"{peak_flops / 1e12:g} TFLOP/s fp32, {nbytes / 1e6:.1f} MB "
              f"at {peak_bw / 1e12:g} TB/s)")
    return res


def _device_ms(torch, fn, iters, keys):
    """Device time per call of fn, summed over the CUDA kernels whose
    name holds each key, from torch.profiler over `iters` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {k: 0.0 for k in keys}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        for k in keys:
            if k in e.key:
                out[k] += e.self_device_time_total / 1e3 / iters
    return out


def _bound(flops, nbytes, peak_flops, peak_bw):
    t_f, t_b = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
    return max(t_f, t_b), "operations" if t_f >= t_b else "bytes"


def time_training_attention(torch, dev, card):
    """Forward (with dropout, returning lse) and backward kernels at the
    training shape in bf16, key-padding bias, without and with the
    causal mask: kernel, plain and library times and the bounds."""
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import flash_attention as fa
    _, peak_bf16, peak_bw = _peaks(card)
    B, H, S, D = TRAIN_B, 8, TRAIN_S, 64
    q, k, v, bias = _attn_inputs(torch, dev, torch.bfloat16, "bshd", B, H,
                                 S, S, D, "key_pad", seed=7)
    g = torch.randn(q.shape, device=dev).to(torch.bfloat16)
    drop = (0x2545F491, 0x9E3779B9, 230)
    scale = D ** -0.5
    el = q.numel()           # elements of each of q, k, v, out, dO
    rows = B * H * S         # lse and di
    res = {}
    for causal in (False, True):
        pairs = S * (S + 1) // 2 if causal else S * S
        mm = 2 * B * H * pairs * D       # one [S, S] x [S, D] product
        out, lse = fa.fused_attention_forward(q, k, v, bias, scale, causal,
                                              "bshd", return_lse=True,
                                              dropout=drop)
        fwd = _time_ms(lambda: fa.fused_attention_forward(
            q, k, v, bias, scale, causal, "bshd", return_lse=True,
            dropout=drop))
        fwd_plain = _time_ms(lambda: fa.fused_attention_plain(
            q, k, v, bias, scale, causal, "bshd", return_lse=True,
            dropout=drop))
        dev_ms = _device_ms(torch, lambda: fa.fused_attention_backward(
            q, k, v, bias, out, lse, g, scale, causal, "bshd",
            dropout=drop), 20, ("di_kernel", "dq_kernel", "dkv_kernel"))
        bwd = _time_ms(lambda: fa.fused_attention_backward(
            q, k, v, bias, out, lse, g, scale, causal, "bshd",
            dropout=drop))
        bwd_plain = _time_ms(lambda: fa.fused_attention_backward_plain(
            q, k, v, bias, out, lse, g, scale, causal, "bshd",
            dropout=drop))
        # library: sdpa with the same bias (and causal mask) as one float
        # mask, dropout 0.1 from its own generator
        mask = bias.to(torch.bfloat16).expand(B, 1, S, S)
        if causal:
            tri = torch.ones(S, S, device=dev, dtype=torch.bool).triu(1)
            mask = mask.masked_fill(tri, float("-inf"))
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k, v))
        gt = g.transpose(1, 2)

        def lib_fwd():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, dropout_p=0.1, scale=scale)

        def lib_fwd_bwd():
            torch.autograd.backward(lib_fwd(), gt)

        lib_f = _time_ms(lib_fwd)
        lib_fb = _time_ms(lib_fwd_bwd)
        fb, fby = _bound(2 * mm, 4 * el * 2 + bias.numel() * 4 + rows * 4,
                         peak_bf16, peak_bw)
        qb, qby = _bound(3 * mm, 6 * el * 2 + bias.numel() * 4 + rows * 8,
                         peak_bf16, peak_bw)
        kb, kby = _bound(4 * mm, 6 * el * 2 + bias.numel() * 4 + rows * 8,
                         peak_bf16, peak_bw)
        res[causal] = {
            "fwd": {"ms": fwd, "plain_ms": fwd_plain, "library_ms": lib_f,
                    "bound_ms": fb, "bound_by": fby},
            "dq": {"ms": dev_ms["di_kernel"] + dev_ms["dq_kernel"],
                   "plain_ms": bwd_plain, "library_ms": lib_fb - lib_f,
                   "bound_ms": qb, "bound_by": qby},
            "dkv": {"ms": dev_ms["dkv_kernel"], "plain_ms": bwd_plain,
                    "library_ms": lib_fb - lib_f, "bound_ms": kb,
                    "bound_by": kby},
            "bwd_ms": bwd}
        print(f"  training shape B={B} S={S} H={H} D={D} bf16 dropout 0.1 "
              f"causal={causal}:")
        print(f"    forward+lse: kernel {fwd:.4f} ms, plain "
              f"{fwd_plain:.4f} ms, sdpa {lib_f:.4f} ms, bound {fb:.4f} ms "
              f"({fby}; {2 * mm / 1e9:.3f} GFLOP)")
        print(f"    backward: both kernels {bwd:.4f} ms (events); device "
              f"di {dev_ms['di_kernel']:.4f} + dq {dev_ms['dq_kernel']:.4f}"
              f" ms (bound {qb:.4f}, {qby}), dk/dv "
              f"{dev_ms['dkv_kernel']:.4f} ms (bound {kb:.4f}, {kby}); "
              f"plain backward {bwd_plain:.4f} ms; sdpa backward "
              f"{lib_fb - lib_f:.4f} ms (fwd+bwd {lib_fb:.4f} - fwd)")
    return res


def time_adam(torch, dev, card, shapes):
    """One Adam step over every parameter shape of the training
    program: kernel (one launch per parameter), plain and
    torch.optim.Adam(fused=True), and the bound of 28 bytes an element."""
    from paddle_tpu_torch.kernels import fused_optimizer as fo
    _, _, peak_bw = _peaks(card)
    state = [_adam_state(torch, dev, int(np.prod(sh)), i)
             for i, sh in enumerate(shapes)]
    n = sum(p.numel() for p, _, _, _ in state)
    lr_t = _lr_t(torch, dev)

    def kernel():
        for p, g, m, v in state:
            fo.fused_adam(p, g, m, v, lr_t)

    def plain():
        for p, g, m, v in state:
            fo.adam_plain(p, g, m, v, lr_t[0], 0.9, 0.999, 1e-8)

    ev = _time_ms(kernel, iters=10, warmup=2)
    dev_ms = _device_ms(torch, kernel, 5, ("adam_kernel",))["adam_kernel"]
    pl = _time_ms(plain, iters=5, warmup=1)
    params = [p.clone().requires_grad_(True) for p, _, _, _ in state]
    for prm, (_, g, _, _) in zip(params, state):
        prm.grad = g.clone()
    opt = torch.optim.Adam(params, lr=LR, fused=True)
    lib = _time_ms(opt.step, iters=10, warmup=2)
    bound = 28 * n / peak_bw * 1e3
    print(f"  adam over {len(shapes)} parameters, {n} elements: kernel "
          f"device {dev_ms:.4f} ms ({len(shapes)} launches; events over "
          f"the launch loop {ev:.4f} ms), plain {pl:.4f} ms, "
          f"torch.optim.Adam(fused=True) {lib:.4f} ms, bound {bound:.4f} "
          f"ms (bytes: 28 B x {n})")
    return {"ms": dev_ms, "events_ms": ev, "plain_ms": pl,
            "library_ms": lib, "bound_ms": bound, "bound_by": "bytes",
            "elements": n}


def where_time_goes(torch, exe, main, feed, cost, scope):
    """The forward again fetching only the cost (the difference to a
    full run is the logits' trip to the host), then once under
    torch.profiler: device busy share and the kernels that take most
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    exe.run(main, feed=feed, fetch_list=[cost], scope=scope)
    cost_only = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        exe.run(main, feed=feed, fetch_list=[cost], scope=scope)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    print(f"  forward fetching only the cost: {cost_only:.4f} s; "
          f"profiled: wall {wall:.4f} s, device busy {busy:.4f} s "
          f"({100 * busy / wall:.1f} %)")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total,
                    reverse=True)[:8]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms "
              f"x{e.count:<4d} {e.key[:90]}")


def slice_phase(torch, dev):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import registry as kreg
    from paddle_tpu_torch.models import transformer as T

    cfg = T.transformer_base(fuse_attention=True)   # full width
    pt.framework.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        cost, logits, _ = T.transformer_train(cfg, is_test=True)
    startup.random_seed = SEED
    n_attn = sum(op.type == "fused_attention"
                 for op in main.global_block().ops)
    _require(n_attn == 18, f"expected 18 fused_attention ops, got {n_attn}")

    exe = pt.Executor(pt.CUDAPlace(0))
    scope = pt.Scope()
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    print(f"  startup on the card: {time.perf_counter() - t0:.3f} s, "
          f"{sum(int(np.prod(p.shape)) for p in main.all_parameters())} "
          f"parameters")

    B, S = 32, 256
    rng = np.random.default_rng(SEED)
    batches = [T.make_batch(cfg, B, S, S, rng=rng,
                            src_lens=rng.integers(S // 2, S + 1, B),
                            trg_lens=rng.integers(S // 2, S + 1, B))
               for _ in range(3)]

    torch.cuda.reset_peak_memory_stats()
    kreg.reset_counts()
    outs, secs = [], []
    for feed in batches:
        t0 = time.perf_counter()
        outs.append(exe.run(main, feed=feed, fetch_list=[logits, cost],
                            scope=scope))
        secs.append(time.perf_counter() - t0)
    counts = kreg.launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    _require(counts["flash_attention_fwd"] == 18 * len(batches),
             f"flash_attention_fwd launched "
             f"{counts['flash_attention_fwd']} times in "
             f"{len(batches)} forwards (want 18 each)")
    for (lg, c), feed in zip(outs, batches):
        _require(lg.shape == (B, S, cfg.trg_vocab_size),
                 f"logits shape {lg.shape}")
        _require(bool(np.isfinite(lg).all()) and np.isfinite(c),
                 "non-finite logits or cost")
        # random weights score near-uniformly: cost ~ log(vocab)
        _require(abs(float(c) - np.log(cfg.trg_vocab_size)) < 1.0,
                 f"cost {float(c)} far from log(vocab)")

    with kreg.plain_reference():
        ref_lg, ref_c = exe.run(main, feed=batches[-1],
                                fetch_list=[logits, cost], scope=scope)
    _require(kreg.launches() == counts,
             "plain_reference() launched a kernel")
    lg, c = outs[-1]
    lerr = float(np.abs(lg - ref_lg).max())
    cerr = abs(float(c) - float(ref_c)) / abs(float(ref_c))
    print(f"  logits kernel vs plain_reference(): max|err|={lerr:.3e} "
          f"(atol {LOGITS_ATOL:g}), cost rel err={cerr:.3e} "
          f"(rtol {COST_RTOL:g})")
    _require(lerr <= LOGITS_ATOL and cerr <= COST_RTOL,
             "forward disagrees with plain_reference()")

    where_time_goes(torch, exe, main, batches[-1], cost, scope)

    tokens = [int(f["lbl_w"].sum() + (f["src_bias"] == 0).sum())
              for f in batches]
    steady = secs[1:]
    tps = sum(tokens[1:]) / sum(steady)
    print(f"  forward seconds per batch: "
          f"{', '.join(f'{s:.4f}' for s in secs)} (first includes "
          f"warm-up)")
    print(f"  tokens/s (non-pad src+trg, batches 2-3, fetch included): "
          f"{tps:.1f}; padded tokens/s: "
          f"{B * 2 * S * len(steady) / sum(steady):.1f}")
    print(f"  peak memory allocated: {peak_gb:.3f} GB; launches per "
          f"forward: {counts['flash_attention_fwd'] // len(batches)}")
    return counts, lerr


def _build_training(pt, T):
    """bench.py's Transformer-base training program, built with the
    port: dropout 0.1, decorate(AdamOptimizer(2e-4))."""
    cfg = T.transformer_base(fuse_attention=True, dropout=0.1)
    pt.framework.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        cost, _, _ = T.transformer_train(cfg)
        opt = pt.contrib.mixed_precision.decorate(
            pt.optimizer.AdamOptimizer(learning_rate=LR))
        opt.minimize(cost)
    main.random_seed = startup.random_seed = SEED
    return cfg, main, startup, cost


def _copy_scope(pt, scope, names):
    new = pt.Scope()
    for n in names:
        new.var(n).get_tensor().set_tensor(
            scope.find_var(n).get_tensor().tensor.clone())
    return new


def profile_step(torch, exe, main, feed, cost, scope):
    """One training step under torch.profiler: wall time, device busy
    share and the kernels that take most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        exe.run(main, feed=feed, fetch_list=[cost], scope=scope)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    print(f"  profiled step: wall {wall:.4f} s, device busy {busy:.4f} s "
          f"({100 * busy / wall:.1f} %)")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total,
                    reverse=True)[:12]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms "
              f"x{e.count:<5d} {e.key[:90]}")


def training_phase(torch, dev, built):
    """5 steps of Transformer-base at B=96, S=128 under bf16 AMP with
    dropout 0.1; returns the launch counts of the 5 steps."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import registry as kreg
    from paddle_tpu_torch.models import transformer as T

    cfg, main, startup, cost = built
    block = main.global_block()
    types = [op.type for op in block.ops]
    n_params = len(main.all_parameters())
    print(f"  training program: {len(types)} ops, {n_params} parameters, "
          f"{types.count('fused_attention')} attention, "
          f"{types.count('adam')} adam")
    _require(types.count("fused_attention") == 18 and
             types.count("fused_attention_grad") == 18 and
             types.count("adam") == n_params == 255,
             "the training program is not bench.py's Transformer-base")

    exe = pt.Executor(pt.CUDAPlace(0))
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    persist = [v.name for v in block.vars.values()
               if v.persistable and scope.find_var(v.name) is not None]
    ref_scope = _copy_scope(pt, scope, persist)
    f32_scope = _copy_scope(pt, scope, persist)

    B, S = TRAIN_B, TRAIN_S
    rng = np.random.default_rng(SEED)
    feed = T.make_batch(cfg, B, S, S, rng=rng,
                        src_lens=rng.integers(S // 2, S + 1, B),
                        trg_lens=rng.integers(S // 2, S + 1, B))
    masks = [op.output("Mask")[0] for op in block.ops
             if op.type == "dropout"][:3]
    params = [p.name for p in main.all_parameters()]
    moments = [op.input("Moment1")[0] for op in block.ops
               if op.type == "adam"]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, secs, per_step = [], [], []
    first_masks = after_first = None
    for step in range(5):
        kreg.reset_counts()
        t0 = time.perf_counter()
        res = exe.run(main, feed=feed,
                      fetch_list=[cost] + (masks if step == 0 else []),
                      scope=scope)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        per_step.append(kreg.launches())
        losses.append(float(res[0]))
        if step == 0:
            first_masks = res[1:]
            after_first = {n: scope.find_var(n).get_tensor().tensor.clone()
                           for n in params + moments}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"  losses: {', '.join(f'{x:.6f}' for x in losses)}")
    _require(all(np.isfinite(losses)), "non-finite loss")
    _require(losses[-1] < losses[0], "the loss did not fall in 5 steps")
    want = {"flash_attention_fwd": 18, "flash_attention_bwd_dq": 18,
            "flash_attention_bwd_dkv": 18, "fused_adam": 255}
    for i, c in enumerate(per_step):
        _require(c == want, f"step {i + 1} launched {c}, want {want}")
    print(f"  launches per step: {per_step[0]}")

    # the first step again, from copies of the initial scope: with every
    # wrapper on its plain version, and in float32 (AMP off)
    with kreg.plain_reference():
        ref = exe.run(main, feed=feed, fetch_list=[cost] + masks,
                      scope=ref_scope)
    _require(kreg.launches() == per_step[-1],
             "plain_reference() launched a kernel")
    for a, b in zip(first_masks, ref[1:]):
        _require(np.array_equal(a, b), "a dropout mask differs between "
                                       "the kernels' and the plain step")
    amp, main._amp = main._amp, None
    try:
        f32 = exe.run(main, feed=feed, fetch_list=[cost], scope=f32_scope)
    finally:
        main._amp = amp
    lerr = abs(float(ref[0]) - losses[0]) / abs(losses[0])

    def value(sc, n):
        return after_first[n] if sc is None else \
            sc.find_var(n).get_tensor().tensor

    def grad_err(sa, sb):
        d2 = r2 = 0.0
        for n in moments:
            a, b = value(sa, n).double(), value(sb, n).double()
            d2 += float(((a - b) ** 2).sum())
            r2 += float((b ** 2).sum())
        return (d2 / r2) ** 0.5

    e_kp = grad_err(None, ref_scope)
    e_k32 = grad_err(None, f32_scope)
    e_p32 = grad_err(ref_scope, f32_scope)
    worst = max((value(None, n) - value(ref_scope, n)).abs().max().item()
                for n in params)
    print(f"  first step, kernels vs plain_reference(): loss rel err "
          f"{lerr:.3e} (rtol {LOSS_STEP_RTOL:g}); float32 step loss "
          f"{float(f32[0]):.6f}; gradients (first moments) rel err in the "
          f"norm over all parameters: kernels bf16 vs plain bf16 "
          f"{e_kp:.3e}, kernels bf16 vs float32 {e_k32:.3e}, plain bf16 "
          f"vs float32 {e_p32:.3e} (bound {GRAD_NOISE_RATIO:g}x that); "
          f"parameters max|err| vs plain {worst:.3e} (bound {2 * LR:g}); "
          f"dropout masks equal")
    _require(lerr <= LOSS_STEP_RTOL and
             e_k32 <= GRAD_NOISE_RATIO * e_p32 + 1e-6 and
             worst <= 2 * LR * 1.01,
             "the training step disagrees with plain_reference()")

    profile_step(torch, exe, main, feed, cost, scope)
    steady = secs[1:]
    tokens = int(feed["lbl_w"].sum())
    print(f"  step seconds: {', '.join(f'{x:.4f}' for x in secs)} (first "
          f"includes warm-up)")
    print(f"  steps/s (steps 2-5): {len(steady) / sum(steady):.3f}; "
          f"non-pad target tokens/s: {tokens * len(steady) / sum(steady):.1f}"
          f" ({tokens} per step); padded tokens/s: "
          f"{B * S * len(steady) / sum(steady):.1f}")
    print(f"  peak memory allocated: {peak_gb:.3f} GB")
    total = {k: sum(c[k] for c in per_step) for k in want}
    return total


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from paddle_tpu_torch.kernels import registry as kreg

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{card}; TF32 off")

    print("[build]")
    t0 = time.perf_counter()
    per_kernel = kreg.build()
    print(f"  built {sorted(per_kernel) or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.2f} s")
    for name in sorted({src[:-3] for src in kreg.SOURCES.values()}):
        log = kreg.BUILD_DIR / f"{name}.log"
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}")

    print("[kernel phase]")
    worst = kernel_phase(torch, dev)
    adam_err, adam_ulp = adam_phase(torch, dev)
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import transformer as T
    built = _build_training(pt, T)
    shapes = [p.shape for p in built[1].all_parameters()]
    times = time_attention(torch, dev, card)
    ttimes = time_training_attention(torch, dev, card)
    atimes = time_adam(torch, dev, card, shapes)
    for t in (ttimes[False]["dq"], ttimes[False]["dkv"], atimes):
        _require(t["ms"] > 0, "the profiler saw no device time")

    print("[serving phase]")
    counts, _ = slice_phase(torch, dev)
    print(f"  launches in the serving phase: {counts}")

    print("[training phase]")
    tcounts = training_phase(torch, dev, built)

    src = "paddle_tpu_torch/csrc/"
    bf = "bfloat16"
    rows = []
    for name, source, replaces, t, err in (
            ("flash_attention_fwd", "flash_attention_fwd.cu",
             "paddle_tpu/kernels/flash_attention.py:353",
             ttimes[False]["fwd"],
             worst[("flash_attention_fwd", bf, "training shape drop t=230")]),
            ("flash_attention_bwd_dq", "flash_attention_bwd.cu",
             "paddle_tpu/kernels/flash_attention.py:426",
             ttimes[False]["dq"],
             worst[("flash_attention_bwd_dq", bf,
                    "training shape drop t=230")]),
            ("flash_attention_bwd_dkv", "flash_attention_bwd.cu",
             "paddle_tpu/kernels/flash_attention.py:502",
             ttimes[False]["dkv"],
             worst[("flash_attention_bwd_dkv", bf,
                    "training shape drop t=230")]),
            ("fused_adam", "fused_optimizer.cu",
             "paddle_tpu/kernels/fused_optimizer.py:108", atimes,
             adam_err)):
        rows.append({"name": name, "route": "cuda", "source": src + source,
                     "replaces": replaces, "launches": tcounts[name],
                     "max_abs_err": err, "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"],
                     "library_ms": t["library_ms"]})
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
