#!/usr/bin/env python3
"""Drive paddle_tpu_torch on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

1. Requires a CUDA device (exits non-zero without one) and prints the
   card's name and power limit as nvidia-smi reports them.
2. Builds every kernel of the port from paddle_tpu_torch/csrc with nvcc
   (one process per source, all at once) and prints the build seconds.
3. Kernel phase: holds each kernel against its plain PyTorch version on
   the card, in float32 and bf16, over the cases below, and times kernel,
   plain version and the library yardstick at the serving shape.
4. Slice phase: builds full-width Transformer-base (6+6 layers, d_model
   512, 8 heads, vocab 32000, fuse_attention) with the port's layers,
   initializes it on the card from a seed, and scores 3 ragged batches
   of 32 x 256 tokens through Executor.run. Checks finite logits and
   cost, 18 attention launches per forward, and the logits against the
   same forward under plain_reference().
5. Prints one JSON line of per-kernel numbers, then, last, the device
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
# whole-forward logits, kernel vs plain_reference(): the attention
# outputs' float32 rounding differences (~5e-7), carried through 12
# layers and 30 layer norms; logits have std ~0.45 at this
# initialization, and the measured difference is ~2e-6
LOGITS_ATOL = 1e-4
COST_RTOL = 1e-4

# Published peaks (NVIDIA data sheets, dense): float32 outside the tensor
# cores in FLOP/s, and HBM bytes/s. Keyed by the name torch reports.
_PEAKS = {"PCIe": (51e12, 2.0e12), "NVL": (60e12, 3.9e12),
          "SXM": (67e12, 3.35e12)}


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
]


def kernel_phase(torch, dev):
    from paddle_tpu_torch.kernels import flash_attention as fa
    worst = {}
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16,
                                                   BF16_TOL)):
        for (name, layout, B, H, Sq, Sk, D, bias_kind, causal,
             pad_all) in _CASES:
            q, k, v, bias = _attn_inputs(torch, dev, dtype, layout, B, H,
                                         Sq, Sk, D, bias_kind, pad_all)
            scale = D ** -0.5
            out, lse = fa.fused_attention_forward(
                q, k, v, bias, scale, causal, layout, return_lse=True)
            ref, ref_lse = fa.fused_attention_plain(
                q, k, v, bias, scale, causal, layout, return_lse=True)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs()
            lerr = (lse - ref_lse).abs()
            ok = bool((err <= tol + tol * ref.float().abs()).all()
                      and (lerr <= tol + tol * ref_lse.abs()).all()
                      and torch.isfinite(out.float()).all())
            dname = str(dtype).replace("torch.", "")
            print(f"  kernel vs plain [{dname:8s}] {name:28s} "
                  f"out max|err|={err.max().item():.3e} "
                  f"lse max|err|={lerr.max().item():.3e} "
                  f"tol={tol:g} {'ok' if ok else 'FAIL'}")
            _require(ok, f"flash_attention_fwd {dname} {name} disagrees "
                         f"with its plain version")
            worst[(dname, name)] = err.max().item()
    return worst


def time_attention(torch, dev, card):
    """Kernel, plain and library times at the serving shape, and the
    bound for the same work."""
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import flash_attention as fa
    peak_flops, peak_bw = _peaks(card)
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
    for name in kreg.SOURCES:
        log = kreg.BUILD_DIR / f"{name}.log"
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}")

    print("[kernel phase]")
    worst = kernel_phase(torch, dev)
    times = time_attention(torch, dev, card)

    print("[slice phase]")
    counts, _ = slice_phase(torch, dev)

    t = times[False]
    row = {"name": "flash_attention_fwd", "route": "cuda",
           "source": "paddle_tpu_torch/csrc/flash_attention_fwd.cu",
           "replaces": "paddle_tpu/kernels/flash_attention.py:353",
           "launches": counts["flash_attention_fwd"],
           "max_abs_err": worst[("float32", "serving shape")],
           "ms": t["ms"], "plain_ms": t["plain_ms"],
           "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
           "library_ms": t["library_ms"]}
    print(smi)
    print(json.dumps({"kernels": [row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
