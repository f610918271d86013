from .mp_layers import (ColumnParallelLinear, ParallelCrossEntropy,
                        RowParallelLinear, VocabParallelEmbedding)
from .random_ctl import (RNGStatesTracker, get_rng_state_tracker,
                         model_parallel_random_seed)

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy", "RNGStatesTracker",
           "get_rng_state_tracker", "model_parallel_random_seed"]
