from .bert import (BertConfig, BertEmbeddings, BertForPretraining,
                   BertForSequenceClassification, BertLayer, BertModel,
                   bert_param_count)
from .convert import (bert_state_from_numpy, dit_state_from_numpy,
                      gather_gpt_state, gpt_engine_params,
                      gpt_state_from_numpy, llama_state_from_numpy,
                      resnet_state_from_numpy, shard_gpt_state)
from .dit import (DiT, DiTBlock, DiTConfig, GaussianDiffusion, LabelEmbedder,
                  TimestepEmbedder, dit_flops_per_image, dit_param_count)
from .gpt import (GPTAttention, GPTBlock, GPTConfig, GPTForCausalLM,
                  GPTForCausalLMPipe, GPTModel, gpt_mp_dim, gpt_param_count,
                  gpt_shard)
from .llama import (LlamaConfig, LlamaForCausalLM, LlamaModel,
                    LlamaMoEConfig, llama_flops_per_token,
                    llama_moe_flops_per_token, llama_moe_param_counts,
                    llama_param_count)

__all__ = ["BertConfig", "BertEmbeddings", "BertLayer", "BertModel",
           "BertForPretraining", "BertForSequenceClassification",
           "bert_param_count", "bert_state_from_numpy", "DiTConfig", "DiT",
           "DiTBlock", "TimestepEmbedder", "LabelEmbedder",
           "GaussianDiffusion", "dit_param_count", "dit_flops_per_image",
           "dit_state_from_numpy", "resnet_state_from_numpy", "GPTConfig", "GPTAttention", "GPTBlock", "GPTModel",
           "GPTForCausalLM", "GPTForCausalLMPipe", "gpt_param_count",
           "gpt_state_from_numpy", "gpt_engine_params", "gpt_mp_dim",
           "gpt_shard", "shard_gpt_state", "gather_gpt_state",
           "LlamaConfig", "LlamaMoEConfig", "LlamaModel",
           "LlamaForCausalLM", "llama_state_from_numpy",
           "llama_flops_per_token", "llama_param_count",
           "llama_moe_param_counts", "llama_moe_flops_per_token"]
