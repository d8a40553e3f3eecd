"""Models of the port (counterpart of paddle_tpu/models)."""
from .generation import GenerationConfig, generate
from .gpt import (CONFIGS, CacheQuantError, GPTConfig, GPTForCausalLM,
                  GPTModel, flops_per_token, gpt)

__all__ = ["CONFIGS", "CacheQuantError", "GPTConfig", "GPTForCausalLM",
           "GPTModel", "flops_per_token", "gpt", "GenerationConfig",
           "generate"]
