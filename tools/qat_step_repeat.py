#!/usr/bin/env python3
"""Repeat chip_smoke.py's QAT card-against-CPU step check on the card.

    python3 tools/qat_step_repeat.py ROOT [--states N] [--feeds SEEDS]

ROOT holds a checkout of this repo (chip_smoke.py and paddle_tpu_torch/).
For each of N states (a Compressor run of chip_smoke's [qat phase]:
full-width ResNet-50, channel-wise / moving-average QAT, each run's
training a state of its own) the script runs chip_smoke's
_qat_card_vs_cpu once a feed seed (the step at QAT_CHECK_B on the card,
held op by op to the CPU) and counts the checks that failed. A single
step check passes or fails on the rare element whose rounding sits at
its bound, so this is how often that happens. Exit code 1 if any
check failed.
"""
import argparse
import os
import sys
import tempfile
import time


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root")
    ap.add_argument("--states", type=int, default=2)
    ap.add_argument("--feeds", default="100,101,102,103,104",
                    help="comma-separated feed seeds (chip_smoke uses 100)")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch
    if not torch.cuda.is_available():
        print("qat_step_repeat: torch sees no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    import paddle_tpu_torch as pt

    failed = []

    def soft(cond, msg):
        if not cond:
            print(f"  FAILED: {msg}")
            failed.append(msg)

    batch = cs._qat_batch
    seeds = [int(v) for v in args.feeds.split(",")]
    cs._require = soft
    runs = 0
    for state in range(args.states):
        with tempfile.TemporaryDirectory() as tmp:
            ctx, scope, cost, _, _ = cs._qat_compress(torch, pt, tmp)
            for seed in seeds:
                cs._qat_batch = (lambda sd: lambda _s, B=None, **kw:
                                 batch(sd, B=B, **kw))(seed)
                t0 = time.perf_counter()
                cs._qat_card_vs_cpu(torch, pt, ctx, scope, cost)
                cs._qat_batch = batch
                runs += 1
                print(f"[state {state} feed {seed}] "
                      f"{time.perf_counter() - t0:.1f} s", flush=True)
        del ctx, scope
        cs.gc_cuda(torch)
    print(f"qat_step_repeat: {len(failed)} of {runs} step checks failed "
          f"({args.states} states x {len(seeds)} feeds)")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
