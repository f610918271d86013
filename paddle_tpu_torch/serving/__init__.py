"""Continuous-batching GPT serving over a paged KV cache (the port's
``paddle_tpu.serving``, generation engine only)."""
from .base import (BadRequest, DeadlineExceeded, EngineBase, EngineClosed,
                   QueueFull)
from .generation import GenerationConfig, GenerationEngine, build_window_step
from .metrics import LatencyWindow, MetricsRegistry
from .paged_kv import (PageAllocator, PagedKVPool, PoolExhausted,
                       PrefixCache, token_blocks)

__all__ = ["GenerationConfig", "GenerationEngine", "build_window_step",
           "EngineBase", "BadRequest", "DeadlineExceeded", "EngineClosed",
           "QueueFull", "LatencyWindow", "MetricsRegistry", "PageAllocator",
           "PagedKVPool", "PoolExhausted", "PrefixCache", "token_blocks"]
