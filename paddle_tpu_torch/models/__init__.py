from .convert import gpt_engine_params, gpt_state_from_numpy
from .gpt import (GPTAttention, GPTBlock, GPTConfig, GPTForCausalLM,
                  GPTModel)

__all__ = ["GPTConfig", "GPTAttention", "GPTBlock", "GPTModel",
           "GPTForCausalLM", "gpt_state_from_numpy", "gpt_engine_params"]
