"""The serving tier in one process (the port's ``paddle_tpu.serving``):

- ``ServingEngine`` (+ ``BucketSpec``, ``ServingConfig``): batched
  inference over an ``nn.Module`` or a callable on tensors — requests
  coalesced into pre-declared shape buckets, admission control, deadlines,
  per-request error isolation;
- ``GenerationEngine`` (+ ``GenerationConfig``): continuous-batching GPT
  decode over a paged KV cache with prefix reuse, an optional int8 warm
  host tier, draft-model speculative decoding, weight swaps and KV page
  export/install;
- ``ReplicaRouter`` (+ ``RouterConfig``): N engines behind one
  admission-controlled front door — tenant quotas, load-aware and
  prefix-affinity dispatch, fencing on replica faults;
- ``kv_transfer``: the page wire format (``pack_kv_pages`` …), shared
  with the JAX package byte for byte;
- ``ServingFleet`` (+ ``ServingFleetPolicy``, ``ReplicaClient``,
  ``BrownoutShed``): supervised replica processes behind one front door —
  frame RPC and heartbeats through a ``TCPStore``, fencing and bounded
  restarts, failover replay, hedging, brownout, rolling restarts and
  prefill/decode pools that ship KV pages (``fleet.py``; a replica runs as
  ``python -m paddle_tpu_torch.serving.fleet``).
"""
from .base import (BadRequest, DeadlineExceeded, EngineBase, EngineClosed,
                   QueueFull, ReplicaFault, RequestCancelled)
from .buckets import BucketSpec
from .engine import ServingConfig, ServingEngine
from .fleet import (BrownoutShed, ReplicaClient, ServingFleet,
                    ServingFleetPolicy)
from .generation import (GenerationConfig, GenerationEngine,
                         build_decode_step, build_window_step,
                         flatten_gpt_params, nest_gpt_params)
from .kv_transfer import (FleetKVCache, KVMigrationStats, pack_kv_pages,
                          prompt_cache_key, unpack_kv_pages)
from .metrics import LatencyWindow, MetricsRegistry
from .paged_kv import (HostPagePool, PageAllocator, PagedKVPool,
                       PoolExhausted, PrefixCache, token_blocks)
from .router import ReplicaRouter, RouterConfig, TenantQuotaExceeded
from .speculative import greedy_accept, rejection_sample

__all__ = [
    "BucketSpec", "ServingConfig", "ServingEngine",
    "GenerationConfig", "GenerationEngine",
    "ReplicaRouter", "RouterConfig", "TenantQuotaExceeded",
    "ServingFleet", "ServingFleetPolicy", "ReplicaClient", "BrownoutShed",
    "ReplicaFault", "RequestCancelled",
    "PageAllocator", "PrefixCache", "PagedKVPool", "PoolExhausted",
    "HostPagePool", "token_blocks", "greedy_accept", "rejection_sample",
    "FleetKVCache", "KVMigrationStats", "pack_kv_pages",
    "unpack_kv_pages", "prompt_cache_key",
    "MetricsRegistry", "LatencyWindow",
    "QueueFull", "DeadlineExceeded", "EngineClosed", "BadRequest",
    "EngineBase", "build_window_step", "build_decode_step",
    "flatten_gpt_params", "nest_gpt_params",
]
