#!/usr/bin/env python3
"""Run chip_smoke.py's bucket sweep phase alone on the card.

    python3 tools/ab_sweep.py ROOT [--baseline DIR]

ROOT holds a checkout of this repo (chip_smoke.py and paddle_tpu_torch/).
The script builds that checkout's kernels and runs its
chip_smoke.bucket_sweep_phase: Transformer-base's training program
planned into buckets, one step's gradients, then the Adam and SGD sweeps
over every bucket with all of the phase's checks and timings. With
--baseline DIR (an earlier checkout, e.g. unpacked with git archive, or
a copy whose paddle_tpu_torch/csrc/fused_optimizer.cu holds another
design of the sweep kernels behind either C interface) that checkout's
sweep is timed in turns with ROOT's (baseline, this, this, baseline).
"""
import argparse
import os
import subprocess
import sys


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root")
    ap.add_argument("--baseline", metavar="DIR")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch
    import chip_smoke
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import registry as kreg
    from paddle_tpu_torch.models import transformer as T
    if not torch.cuda.is_available():
        print("ab_sweep: torch sees no CUDA device", file=sys.stderr)
        return 1
    if not (chip_smoke.__file__.startswith(root)
            and pt.__file__.startswith(root)):
        print(f"ab_sweep: {root} is not the checkout imported",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    kreg.build()
    print(f"=== {root}" + (f" against {args.baseline}" if args.baseline
                          else ""), flush=True)
    dev = torch.device("cuda", 0)
    chip_smoke.bucket_sweep_phase(
        torch, dev, torch.cuda.get_device_name(0),
        chip_smoke._build_training(pt, T),
        os.path.abspath(args.baseline) if args.baseline else None)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
