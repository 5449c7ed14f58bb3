"""Optimizers and learning-rate schedulers of the PyTorch port."""
from . import lr
from .lr import CosineAnnealingDecay, LinearWarmup, LRScheduler
from .optimizer import SGD, Adam, AdamW, Optimizer

__all__ = ["lr", "LRScheduler", "LinearWarmup", "CosineAnnealingDecay",
           "Optimizer", "SGD", "Adam", "AdamW"]
