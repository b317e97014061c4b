"""The vision model zoo (counterpart of ``paddle_tpu/vision/models/``):
23 constructors and ``LeNet``. Every model takes ``device`` (None: the
current device, the card unless ``set_device("cpu")`` chose the host)
and ``seed`` (its weights' generator); parameter and buffer names match
the JAX models', so a JAX ``state_dict`` loads through
``convert.load_numpy_state_dict``."""

from .classic import (
    VGG,
    AlexNet,
    DenseNet,
    LeNet,
    ShuffleNetV2,
    SqueezeNet,
    alexnet,
    densenet121,
    shufflenet_v2_x1_0,
    squeezenet1_0,
    squeezenet1_1,
    vgg11,
    vgg13,
    vgg16,
    vgg19,
)
from .inception import GoogLeNet, InceptionV3, googlenet, inception_v3
from .mobilenetv2 import MobileNetV2, mobilenet_v2
from .mobilenetv3 import MobileNetV3, mobilenet_v3_large, mobilenet_v3_small
from .resnet import (
    BasicBlock,
    BottleneckBlock,
    ResNet,
    resnet18,
    resnet34,
    resnet50,
    resnet101,
    resnet152,
    resnext50_32x4d,
    resnext101_32x4d,
    wide_resnet50_2,
    wide_resnet101_2,
)

CONSTRUCTORS = ("alexnet", "densenet121", "googlenet", "inception_v3",
                "mobilenet_v2", "mobilenet_v3_large", "mobilenet_v3_small",
                "resnet18", "resnet34", "resnet50", "resnet101",
                "resnet152", "resnext50_32x4d", "resnext101_32x4d",
                "shufflenet_v2_x1_0", "squeezenet1_0", "squeezenet1_1",
                "vgg11", "vgg13", "vgg16", "vgg19", "wide_resnet50_2",
                "wide_resnet101_2")

__all__ = ["AlexNet", "BasicBlock", "BottleneckBlock", "DenseNet",
           "GoogLeNet", "InceptionV3", "LeNet", "MobileNetV2",
           "MobileNetV3", "ResNet", "ShuffleNetV2", "SqueezeNet", "VGG",
           *CONSTRUCTORS]
