"""Optimizers and learning-rate schedulers of the PyTorch port."""
from . import lr
from .lr import CosineAnnealingDecay, LinearWarmup, LRScheduler
from .optimizer import (SGD, Adadelta, Adagrad, Adam, Adamax, AdamW, Lamb,
                        Momentum, NAdam, Optimizer, RAdam, RMSProp)

__all__ = ["lr", "LRScheduler", "LinearWarmup", "CosineAnnealingDecay",
           "Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adagrad",
           "RMSProp", "Adadelta", "Adamax", "Lamb", "NAdam", "RAdam"]
