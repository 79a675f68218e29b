"""Serving tier: the bucketed KV-cache engine."""

from .engine import (ServingEngine, batch_buckets_from_env,
                     prefill_buckets_for, state_for_serving)

__all__ = ["ServingEngine", "batch_buckets_from_env", "prefill_buckets_for",
           "state_for_serving"]
