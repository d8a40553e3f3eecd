"""Models of the port (counterpart of paddle_tpu/models)."""
from .generation import GenerationConfig, generate
from .gpt import (CONFIGS, CacheQuantError, GPTConfig, GPTForCausalLM,
                  GPTModel, gpt)

__all__ = ["CONFIGS", "CacheQuantError", "GPTConfig", "GPTForCausalLM",
           "GPTModel", "gpt", "GenerationConfig", "generate"]
