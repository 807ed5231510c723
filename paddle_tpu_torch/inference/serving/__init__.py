"""The serving engine: continuous-batching generation on exported
programs (counterpart of paddle_tpu/inference/serving/).

* **export** — a Program pair (prefill, decode) frozen with bucketed
  batch and sequence signatures, each captured as one CUDA graph
  (``export_serving_model`` / ``FrozenServingModel``);
* **kv_cache** — the paged key/value store on the device, in the
  memory census as owner ``kv_cache`` (``PagedKVCache``);
* **scheduler** — admission, prefill and decode at step granularity,
  with deadlines, priorities, quotas and preemption
  (``ServingEngine``);
* **server** — the multi-tenant RPC front end with graceful SIGTERM
  drain (``ServeServer``).
"""
from .export import (BucketSpec, FrozenServingModel, bucket_for,
                     build_book_lm, export_serving_model,
                     load_serving_model, reference_generate,
                     resolve_serving_mesh)
from .kv_cache import PagedKVCache
from .scheduler import (Request, RunnerKilled, ServingEngine,
                        TenantQuota, STATUS_DEADLINE, STATUS_FAILED,
                        STATUS_OK, STATUS_QUEUE_FULL, STATUS_QUOTA)
from .server import ServeServer, generate, serve_rpc

__all__ = [
    "BucketSpec", "bucket_for", "build_book_lm",
    "export_serving_model", "load_serving_model",
    "FrozenServingModel", "resolve_serving_mesh",
    "reference_generate", "PagedKVCache", "ServingEngine", "Request",
    "TenantQuota", "RunnerKilled", "ServeServer", "generate",
    "serve_rpc", "STATUS_OK", "STATUS_DEADLINE", "STATUS_QUOTA",
    "STATUS_FAILED", "STATUS_QUEUE_FULL",
]
