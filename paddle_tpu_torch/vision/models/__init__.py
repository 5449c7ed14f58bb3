"""Vision models of the port (counterpart of
``paddle_tpu/vision/models``): the ResNet family and LeNet. The JAX
package's other models (VGG, MobileNet, DenseNet, Inception, the rest of
the small nets) are still to port (ROADMAP)."""
from .resnet import (BasicBlock, BottleneckBlock, ResNet, resnet18,
                     resnet34, resnet50, resnet101, resnet152)
from .small_nets import LeNet

__all__ = ["ResNet", "BasicBlock", "BottleneckBlock", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152", "LeNet"]
