"""Optimizers of the port (counterpart of paddle_tpu/optimizer): the twelve
optimizers and the LR schedulers (`optimizer.lr`)."""
from . import lr
from .optimizer import (ASGD, LBFGS, SGD, Adadelta, Adagrad, Adam, Adamax,
                        AdamW, Lamb, Momentum, Optimizer, RMSProp, Rprop)

__all__ = ["lr", "Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adagrad",
           "RMSProp", "Adadelta", "Adamax", "Lamb", "Rprop", "ASGD", "LBFGS"]
