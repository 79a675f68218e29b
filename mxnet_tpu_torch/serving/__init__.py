"""Serving tier: the bucketed KV-cache engine (one recorded CUDA graph a
bucket on the card) and the continuous batcher.  The replicas, the front
door and the fleet watcher wait for the production planes (ROADMAP queue
1 item 5)."""

from .batcher import (ContinuousBatcher, DeadlineExceeded,
                      ServerOverloaded, max_delay_ms_from_env,
                      max_queue_from_env)
from .engine import (ServingEngine, batch_buckets_from_env, compile_count,
                     dispatch_count, prefill_buckets_for, reset_counters,
                     state_for_serving, trace_count)

__all__ = [
    "ServingEngine", "ContinuousBatcher", "ServerOverloaded",
    "DeadlineExceeded", "state_for_serving", "batch_buckets_from_env",
    "prefill_buckets_for", "max_delay_ms_from_env", "max_queue_from_env",
    "trace_count", "compile_count", "dispatch_count", "reset_counters",
]
