"""paddle_tpu_torch.distributed.resilience — the chaos half of the JAX
package's fault-tolerant runtime (port of
``paddle_tpu/distributed/resilience``): deterministic fault injection
(``FaultInjector`` / ``PT_FAULTS``) and its counters. The checkpointer,
the preemption hooks and the retry lanes are not ported yet (ROADMAP
Queue 1 item 6).
"""
from __future__ import annotations

from . import metrics  # noqa: F401
from .faults import FaultInjector, InjectedFault, inject, injector

__all__ = ["FaultInjector", "InjectedFault", "inject", "injector",
           "metrics"]
