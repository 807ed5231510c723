"""Tuning (counterpart of paddle_tpu/tuning/).

* :mod:`.knobs`    — the knobs the kernel registry reads
* :mod:`.variants` — the GEMM variant search over the tile shapes that
  csrc/tuned_matmul.cu instantiates (parity-gated, timed on the card)

The search driver, the tuning cache and the knob search of the JAX
package are not ported yet.
"""
from . import knobs, variants  # noqa: F401

__all__ = ["knobs", "variants"]
