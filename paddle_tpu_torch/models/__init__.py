"""Models of the port (counterpart of paddle_tpu/models)."""
from .bert import (BertConfig, BertForMaskedLM,
                   BertForSequenceClassification, BertModel,
                   ErnieForMaskedLM, ErnieForSequenceClassification,
                   ErnieModel, bert, bert_for_masked_lm,
                   bert_for_sequence_classification)
from .generation import GenerationConfig, generate
from .gpt import (CONFIGS, CacheQuantError, GPTConfig, GPTForCausalLM,
                  GPTModel, flops_per_token, gpt)
from .resnet import (BasicBlock, BottleneckBlock, ResNet, resnet18,
                     resnet34, resnet50, resnet101, resnet152,
                     train_flops_per_image, wide_resnet50_2,
                     wide_resnet101_2)

__all__ = ["CONFIGS", "CacheQuantError", "GPTConfig", "GPTForCausalLM",
           "GPTModel", "flops_per_token", "gpt", "GenerationConfig",
           "generate", "BertConfig", "BertModel",
           "BertForSequenceClassification", "BertForMaskedLM", "ErnieModel",
           "ErnieForSequenceClassification", "ErnieForMaskedLM", "bert",
           "bert_for_sequence_classification", "bert_for_masked_lm",
           "BasicBlock", "BottleneckBlock", "ResNet", "resnet18", "resnet34",
           "resnet50", "resnet101", "resnet152", "train_flops_per_image",
           "wide_resnet50_2", "wide_resnet101_2"]
