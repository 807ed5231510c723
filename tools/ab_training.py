#!/usr/bin/env python3
"""Run one checkout's training phase of chip_smoke.py on the card.

    python3 tools/ab_training.py ROOT

ROOT holds a checkout of this repo (chip_smoke.py and paddle_tpu_torch/,
e.g. unpacked with git archive). The script builds that checkout's
kernels and runs its chip_smoke.training_phase: 5 steps of full-width
Transformer-base at B=96, S=128 under bf16 AMP, with its own checks,
steps/s and profiled step. To compare two checkouts on one card, run
them in turns in one call, e.g. parent, change, change, parent:

    for r in PARENT . . PARENT; do python3 tools/ab_training.py $r; done
"""
import os
import sys


def main(argv):
    root = os.path.abspath(argv[1])
    sys.path.insert(0, root)
    os.chdir(root)
    import torch
    import chip_smoke
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import registry as kreg
    from paddle_tpu_torch.models import transformer as T
    if not torch.cuda.is_available():
        print("ab_training: torch sees no CUDA device", file=sys.stderr)
        return 1
    if not (chip_smoke.__file__.startswith(root)
            and pt.__file__.startswith(root)):
        print(f"ab_training: {root} is not the checkout imported",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kreg.build()
    print(f"=== {root}", flush=True)
    chip_smoke.training_phase(torch, torch.device("cuda", 0),
                              chip_smoke._build_training(pt, T))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
