"""Where postmortem dumps go (counterpart of
paddle_tpu/observability/recorder.py, the part that tracing.py uses).

The JAX package's step flight recorder (a ring of per-step records
dumped when a run dies) is not ported (ROADMAP.md A.11); its dump
directory is, because span dumps (tracing.dump_spans) land beside it.
"""
from __future__ import annotations

import os
import tempfile

__all__ = ["default_dir"]


def default_dir() -> str:
    """``$PT_FLIGHT_DIR``, else ``<tmp>/paddle_tpu_flight``."""
    return os.environ.get(
        "PT_FLIGHT_DIR",
        os.path.join(tempfile.gettempdir(), "paddle_tpu_flight"))
