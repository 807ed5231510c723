#!/usr/bin/env python3
"""Run chip_smoke.py's [op sweep] and [ptb phase] alone on the card.

    python3 tools/ptb_phase.py [ROOT] [--no-sweep]

ROOT (default: this script's checkout) holds chip_smoke.py and
paddle_tpu_torch/. Builds the optimizer kernels (fused_optimizer.cu:
the PTB step's SGD goes to fused_sgd), sets TF32 off as chip_smoke.py
does, prints the card's name and power limit, then runs the op sweep
(every op family's cases on the card against the CPU, slice 26's misc
ops among them) unless --no-sweep, and the PTB word language model's
phase. Exit code 1 if a check failed.
"""
import argparse
import os
import subprocess
import sys
import time


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root", nargs="?",
                    default=os.path.dirname(os.path.dirname(
                        os.path.abspath(__file__))))
    ap.add_argument("--no-sweep", action="store_true")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch
    if not torch.cuda.is_available():
        print("ptb_phase: torch sees no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    from paddle_tpu_torch.kernels import registry as kreg
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    t0 = time.perf_counter()
    kreg.build(["fused_sgd"])
    print(f"[build] fused_optimizer.cu in {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda", 0)
    try:
        if not args.no_sweep:
            print("[op sweep]")
            cs.op_sweep_phase(torch, dev)
        print("[ptb phase]")
        cs.ptb_phase(torch, dev)
    except RuntimeError as exc:
        print(f"ptb_phase: {exc}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
