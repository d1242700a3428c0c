"""Serving substrate: KV slot pool, continuous batcher, engine."""
from .batcher import ContinuousBatcher, Request
from .engine import ServeEngine
from .kvcache import CacheFullError, SlotAllocator

__all__ = ["ContinuousBatcher", "Request", "ServeEngine", "CacheFullError",
           "SlotAllocator"]
