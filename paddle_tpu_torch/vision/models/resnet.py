"""ResNet family (counterpart of ``paddle_tpu/vision/models/resnet.py``):
``BasicBlock``/``BottleneckBlock``, ``resnet18``-``152``, the wide and
ResNeXt variants.

Layout: ``channels_last`` (None: ``PT_FLAGS_conv_layout``, auto = NHWC
on the card, NCHW on the CPU) transposes once at the entry, runs the
whole conv / norm / pool body channels-last inside a
``layout.channels_last_scope`` and transposes back once at the exit, as
the JAX model does; the blocks are layout-neutral. The norms are the
port's ``BatchNorm2D`` (plain torch ops; running statistics moved in
every training forward) unless ``norm_layer`` names another factory: a
``GroupNorm`` one (``lambda c: GroupNorm(32, c)``) puts the NHWC
GroupNorm kernels (rows 12-13) under every norm on the card.
"""

from __future__ import annotations

from ...core.module import Layer
from ...nn import functional as F
from ...nn import layout
from ...nn.layer.common import Linear, Sequential
from ...nn.layer.conv import AdaptiveAvgPool2D, Conv2D, MaxPool2D
from ...nn.layer.norm import BatchNorm2D
from ._common import building


class BasicBlock(Layer):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 norm_layer=BatchNorm2D):
        super().__init__()
        self.conv1 = Conv2D(inplanes, planes, 3, stride=stride, padding=1,
                            bias_attr=False)
        self.bn1 = norm_layer(planes)
        self.conv2 = Conv2D(planes, planes, 3, padding=1, bias_attr=False)
        self.bn2 = norm_layer(planes)
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return F.relu(out + identity)


class BottleneckBlock(Layer):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 norm_layer=BatchNorm2D, groups=1, base_width=64):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = Conv2D(inplanes, width, 1, bias_attr=False)
        self.bn1 = norm_layer(width)
        self.conv2 = Conv2D(width, width, 3, stride=stride, padding=1,
                            groups=groups, bias_attr=False)
        self.bn2 = norm_layer(width)
        self.conv3 = Conv2D(width, planes * self.expansion, 1,
                            bias_attr=False)
        self.bn3 = norm_layer(planes * self.expansion)
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return F.relu(out + identity)


class ResNet(Layer):
    """``forward(x, labels=None)``: NCHW images -> logits (or pooled
    features with ``num_classes=0``), or with labels the mean
    ``cross_entropy``. ``device`` and ``seed`` as ``building`` takes
    them."""

    def __init__(self, block, depth_cfg, num_classes=1000, with_pool=True,
                 norm_layer=BatchNorm2D, in_channels=3, groups=1, width=64,
                 channels_last=None, device=None, seed: int = 0):
        super().__init__()
        with building(device, seed):
            self.channels_last = channels_last
            self.inplanes = 64
            self.norm_layer = norm_layer
            self.groups = groups
            self.base_width = width
            self.conv1 = Conv2D(in_channels, 64, 7, stride=2, padding=3,
                                bias_attr=False)
            self.bn1 = norm_layer(64)
            self.maxpool = MaxPool2D(3, stride=2, padding=1)
            self.layer1 = self._make_layer(block, 64, depth_cfg[0])
            self.layer2 = self._make_layer(block, 128, depth_cfg[1],
                                           stride=2)
            self.layer3 = self._make_layer(block, 256, depth_cfg[2],
                                           stride=2)
            self.layer4 = self._make_layer(block, 512, depth_cfg[3],
                                           stride=2)
            self.with_pool = with_pool
            if with_pool:
                self.avgpool = AdaptiveAvgPool2D(1)
            self.num_classes = num_classes
            if num_classes > 0:
                self.fc = Linear(512 * block.expansion, num_classes)

    def _make_layer(self, block, planes, blocks, stride=1):
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = Sequential(
                Conv2D(self.inplanes, planes * block.expansion, 1,
                       stride=stride, bias_attr=False),
                self.norm_layer(planes * block.expansion))
        extra = ({"groups": self.groups, "base_width": self.base_width}
                 if block is BottleneckBlock else {})
        layers = [block(self.inplanes, planes, stride, downsample,
                        self.norm_layer, **extra)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes,
                                norm_layer=self.norm_layer, **extra))
        return Sequential(*layers)

    def forward(self, x, labels=None):
        cl = layout.decide(self.channels_last, x.device)
        if cl:
            x = layout.nchw_to_nhwc(x)
        with layout.channels_last_scope(cl):
            x = F.relu(self.bn1(self.conv1(x)))
            x = self.maxpool(x)
            x = self.layer1(x)
            x = self.layer2(x)
            x = self.layer3(x)
            x = self.layer4(x)
            if self.with_pool:
                x = self.avgpool(x)
        if cl:
            x = layout.nhwc_to_nchw(x)
        if self.num_classes > 0:
            x = self.fc(x.reshape(x.shape[0], -1))
        if labels is not None:
            return F.cross_entropy(x, labels)
        return x


def _resnet(block, depth_cfg, **kwargs):
    return ResNet(block, depth_cfg, **kwargs)


def resnet18(**kwargs):
    return _resnet(BasicBlock, (2, 2, 2, 2), **kwargs)


def resnet34(**kwargs):
    return _resnet(BasicBlock, (3, 4, 6, 3), **kwargs)


def resnet50(**kwargs):
    return _resnet(BottleneckBlock, (3, 4, 6, 3), **kwargs)


def resnet101(**kwargs):
    return _resnet(BottleneckBlock, (3, 4, 23, 3), **kwargs)


def resnet152(**kwargs):
    return _resnet(BottleneckBlock, (3, 8, 36, 3), **kwargs)


def wide_resnet50_2(**kwargs):
    """The bottleneck width doubled."""
    return _resnet(BottleneckBlock, (3, 4, 6, 3), width=128, **kwargs)


def wide_resnet101_2(**kwargs):
    return _resnet(BottleneckBlock, (3, 4, 23, 3), width=128, **kwargs)


def resnext50_32x4d(**kwargs):
    """32 groups, 4 wide."""
    return _resnet(BottleneckBlock, (3, 4, 6, 3), groups=32, width=4,
                   **kwargs)


def resnext101_32x4d(**kwargs):
    return _resnet(BottleneckBlock, (3, 4, 23, 3), groups=32, width=4,
                   **kwargs)
