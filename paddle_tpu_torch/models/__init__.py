"""Models of the port (counterpart of paddle_tpu/models)."""
from .bert import (BertConfig, BertForMaskedLM,
                   BertForSequenceClassification, BertModel,
                   ErnieForMaskedLM, ErnieForSequenceClassification,
                   ErnieModel, bert, bert_for_masked_lm,
                   bert_for_sequence_classification)
from .generation import GenerationConfig, generate
from .gpt import (CONFIGS, CacheQuantError, GPTConfig, GPTForCausalLM,
                  GPTModel, flops_per_token, gpt)

__all__ = ["CONFIGS", "CacheQuantError", "GPTConfig", "GPTForCausalLM",
           "GPTModel", "flops_per_token", "gpt", "GenerationConfig",
           "generate", "BertConfig", "BertModel",
           "BertForSequenceClassification", "BertForMaskedLM", "ErnieModel",
           "ErnieForSequenceClassification", "ErnieForMaskedLM", "bert",
           "bert_for_sequence_classification", "bert_for_masked_lm"]
