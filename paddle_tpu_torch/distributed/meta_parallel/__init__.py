from .mp_layers import (ColumnParallelLinear, ParallelCrossEntropy,
                        RowParallelLinear, VocabParallelEmbedding)
from .pipeline import (bubble_fraction, choose_microbatches, microbatch,
                       one_f_one_b, pipeline_local, unmicrobatch)
from .pp_layers import (LayerDesc, PipelineLayer, SharedLayerDesc,
                        find_homogeneous_run, layer_signature)
from .random_ctl import (RNGStatesTracker, get_rng_state_tracker,
                         model_parallel_random_seed)
from .wrappers import (HybridParallelGradScaler, HybridParallelOptimizer,
                       PipelineParallel, ShardingParallel, TensorParallel)

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy", "RNGStatesTracker",
           "get_rng_state_tracker", "model_parallel_random_seed",
           "LayerDesc", "SharedLayerDesc", "PipelineLayer",
           "layer_signature", "find_homogeneous_run", "PipelineParallel",
           "TensorParallel", "ShardingParallel", "HybridParallelOptimizer",
           "HybridParallelGradScaler", "bubble_fraction",
           "choose_microbatches", "microbatch", "unmicrobatch",
           "one_f_one_b", "pipeline_local"]
