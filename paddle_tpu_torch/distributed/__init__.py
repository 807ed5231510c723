"""paddle_tpu_torch.distributed (counterpart of paddle_tpu/distributed/,
the part that serving calls): fault injection (faults.py), retries and
circuit breakers (resilience.py) and the RPC framing (async_ps.py). The
launcher, elastic resume and the parameter server are ROADMAP.md A.7
and A.9.
"""
from . import async_ps, faults, resilience  # noqa: F401
