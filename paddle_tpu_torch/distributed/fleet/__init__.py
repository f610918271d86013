"""fleet: the distributed-training facade (port of
``paddle_tpu/distributed/fleet``; the elastic runtime, the data generators
and the parameter server are not ported)."""
from ..meta_parallel import (ColumnParallelLinear, ParallelCrossEntropy,
                             RowParallelLinear, VocabParallelEmbedding)
from .base import (DistributedStrategy, ParallelMode, barrier_worker,
                   distributed_model, distributed_optimizer,
                   get_hybrid_communicate_group, init, is_initialized,
                   worker_index, worker_num)
from .topology import CommunicateTopology, HybridCommunicateGroup

__all__ = ["init", "is_initialized", "distributed_model",
           "distributed_optimizer", "get_hybrid_communicate_group",
           "worker_index", "worker_num", "barrier_worker",
           "DistributedStrategy", "ParallelMode", "CommunicateTopology",
           "HybridCommunicateGroup", "VocabParallelEmbedding",
           "ColumnParallelLinear", "RowParallelLinear",
           "ParallelCrossEntropy"]
