"""Vision models of the port (counterpart of
``paddle_tpu/vision/models``): the JAX package's whole zoo, ResNet, VGG,
MobileNet v1/v2/v3, LeNet, AlexNet, SqueezeNet, ShuffleNetV2, DenseNet,
GoogLeNet and InceptionV3, with its parameter names (a JAX model's
state goes across with ``models.load_jax_layer_state``). No weights are
bundled: ``pretrained=True`` raises."""
from .resnet import (BasicBlock, BottleneckBlock, ResNet, resnet18,
                     resnet34, resnet50, resnet101, resnet152)
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19
from .mobilenet import (MobileNetV1, MobileNetV2, MobileNetV3Small,
                        MobileNetV3Large, mobilenet_v1, mobilenet_v2,
                        mobilenet_v3_small, mobilenet_v3_large)
from .small_nets import (LeNet, AlexNet, alexnet, SqueezeNet, squeezenet1_0,
                         squeezenet1_1, ShuffleNetV2, shufflenet_v2_x0_25,
                         shufflenet_v2_x0_33, shufflenet_v2_x0_5,
                         shufflenet_v2_x1_0, shufflenet_v2_x1_5,
                         shufflenet_v2_x2_0, shufflenet_v2_swish)
from .densenet import (DenseNet, densenet121, densenet161, densenet169,
                       densenet201, densenet264)
from .inception import GoogLeNet, googlenet, InceptionV3, inception_v3

__all__ = [
    "ResNet", "BasicBlock", "BottleneckBlock", "resnet18", "resnet34",
    "resnet50", "resnet101", "resnet152",
    "VGG", "vgg11", "vgg13", "vgg16", "vgg19",
    "MobileNetV1", "MobileNetV2", "MobileNetV3Small", "MobileNetV3Large",
    "mobilenet_v1", "mobilenet_v2", "mobilenet_v3_small",
    "mobilenet_v3_large",
    "LeNet", "AlexNet", "alexnet", "SqueezeNet", "squeezenet1_0",
    "squeezenet1_1", "ShuffleNetV2", "shufflenet_v2_x0_25",
    "shufflenet_v2_x0_33", "shufflenet_v2_x0_5", "shufflenet_v2_x1_0",
    "shufflenet_v2_x1_5", "shufflenet_v2_x2_0", "shufflenet_v2_swish",
    "DenseNet", "densenet121", "densenet161", "densenet169", "densenet201",
    "densenet264", "GoogLeNet", "googlenet", "InceptionV3", "inception_v3",
]
