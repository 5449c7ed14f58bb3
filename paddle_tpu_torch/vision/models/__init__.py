"""Vision models of the port (counterpart of
``paddle_tpu/vision/models``): the ResNet family. The JAX package's
other models (VGG, MobileNet, DenseNet, Inception, the small nets) are
still to port (ROADMAP)."""
from .resnet import (BasicBlock, BottleneckBlock, ResNet, resnet18,
                     resnet34, resnet50, resnet101, resnet152)

__all__ = ["ResNet", "BasicBlock", "BottleneckBlock", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152"]
