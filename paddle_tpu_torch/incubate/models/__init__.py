from .gpt import (GPTConfig, GPTAttention, GPTMLP, GPTBlock,  # noqa: F401
                  GPTModel, GPTForCausalLM, gpt2_124m, gpt2_355m, gpt3_1p3b,
                  gpt3_6p7b)

__all__ = ["GPTConfig", "GPTAttention", "GPTMLP", "GPTBlock", "GPTModel",
           "GPTForCausalLM", "gpt2_124m", "gpt2_355m", "gpt3_1p3b",
           "gpt3_6p7b"]
