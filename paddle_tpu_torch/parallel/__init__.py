"""Data-parallel planning (counterpart of paddle_tpu/parallel/): the
comm scheduler's bucket planner. No collective and no mesh yet."""
from . import comm_scheduler  # noqa: F401
from .comm_scheduler import (GradBucket, bucket_bytes_from_flags,  # noqa: F401
                             grad_production_order, plan_named_buckets,
                             plan_program_buckets, plan_stats)
