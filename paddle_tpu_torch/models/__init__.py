from .bert import (BertConfig, BertEmbeddings, BertForPretraining,
                   BertForSequenceClassification, BertLayer, BertModel,
                   bert_param_count)
from .convert import (bert_state_from_numpy, gather_gpt_state, gpt_engine_params,
                      gpt_state_from_numpy, llama_state_from_numpy,
                      shard_gpt_state)
from .gpt import (GPTAttention, GPTBlock, GPTConfig, GPTForCausalLM,
                  GPTForCausalLMPipe, GPTModel, gpt_mp_dim, gpt_param_count,
                  gpt_shard)
from .llama import (LlamaConfig, LlamaForCausalLM, LlamaModel,
                    LlamaMoEConfig, llama_flops_per_token,
                    llama_moe_flops_per_token, llama_moe_param_counts,
                    llama_param_count)

__all__ = ["BertConfig", "BertEmbeddings", "BertLayer", "BertModel",
           "BertForPretraining", "BertForSequenceClassification",
           "bert_param_count", "bert_state_from_numpy", "GPTConfig", "GPTAttention", "GPTBlock", "GPTModel",
           "GPTForCausalLM", "GPTForCausalLMPipe", "gpt_param_count",
           "gpt_state_from_numpy", "gpt_engine_params", "gpt_mp_dim",
           "gpt_shard", "shard_gpt_state", "gather_gpt_state",
           "LlamaConfig", "LlamaMoEConfig", "LlamaModel",
           "LlamaForCausalLM", "llama_state_from_numpy",
           "llama_flops_per_token", "llama_param_count",
           "llama_moe_param_counts", "llama_moe_flops_per_token"]
