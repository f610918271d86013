from .convert import (gpt_engine_params, gpt_state_from_numpy,
                      llama_state_from_numpy)
from .gpt import (GPTAttention, GPTBlock, GPTConfig, GPTForCausalLM,
                  GPTForCausalLMPipe, GPTModel, gpt_param_count)
from .llama import (LlamaConfig, LlamaForCausalLM, LlamaModel,
                    LlamaMoEConfig, llama_flops_per_token,
                    llama_moe_flops_per_token, llama_moe_param_counts,
                    llama_param_count)

__all__ = ["GPTConfig", "GPTAttention", "GPTBlock", "GPTModel",
           "GPTForCausalLM", "GPTForCausalLMPipe", "gpt_param_count", "gpt_state_from_numpy", "gpt_engine_params",
           "LlamaConfig", "LlamaMoEConfig", "LlamaModel",
           "LlamaForCausalLM", "llama_state_from_numpy",
           "llama_flops_per_token", "llama_param_count",
           "llama_moe_param_counts", "llama_moe_flops_per_token"]
