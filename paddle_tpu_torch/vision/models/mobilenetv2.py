"""MobileNetV2 (counterpart of
``paddle_tpu/vision/models/mobilenetv2.py``): inverted residuals with
depthwise convolutions (``groups`` = channels), in the declared NCHW
layout as in JAX."""

from __future__ import annotations

from ...core.module import Layer
from ...nn import functional as F
from ...nn.layer.common import Linear, Sequential
from ...nn.layer.conv import AdaptiveAvgPool2D, Conv2D
from ...nn.layer.norm import BatchNorm2D
from ._common import building


def _make_divisible(v, divisor=8, min_value=None):
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class ConvBNReLU(Layer):
    def __init__(self, in_ch, out_ch, kernel=3, stride=1, groups=1):
        super().__init__()
        self.conv = Conv2D(in_ch, out_ch, kernel, stride=stride,
                           padding=(kernel - 1) // 2, groups=groups,
                           bias_attr=False)
        self.bn = BatchNorm2D(out_ch)

    def forward(self, x):
        return F.relu6(self.bn(self.conv(x)))


class InvertedResidual(Layer):
    def __init__(self, inp, oup, stride, expand_ratio):
        super().__init__()
        self.stride = stride
        hidden = int(round(inp * expand_ratio))
        self.use_res = stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNReLU(inp, hidden, kernel=1))
        layers.append(ConvBNReLU(hidden, hidden, stride=stride,
                                 groups=hidden))
        self.body = Sequential(*layers)
        self.project = Conv2D(hidden, oup, 1, bias_attr=False)
        self.project_bn = BatchNorm2D(oup)

    def forward(self, x):
        out = self.project_bn(self.project(self.body(x)))
        return x + out if self.use_res else out


class MobileNetV2(Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 device=None, seed: int = 0):
        super().__init__()
        cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
               (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]  # t, c, n, s
        with building(device, seed):
            input_channel = _make_divisible(32 * scale)
            self.last_channel = _make_divisible(1280 * max(1.0, scale))
            features = [ConvBNReLU(3, input_channel, stride=2)]
            for t, c, n, s in cfg:
                out_ch = _make_divisible(c * scale)
                for i in range(n):
                    features.append(InvertedResidual(
                        input_channel, out_ch, s if i == 0 else 1, t))
                    input_channel = out_ch
            features.append(ConvBNReLU(input_channel, self.last_channel,
                                       kernel=1))
            self.features = Sequential(*features)
            self.with_pool = with_pool
            self.num_classes = num_classes
            if with_pool:
                self.pool = AdaptiveAvgPool2D(1)
            if num_classes > 0:
                self.classifier = Linear(self.last_channel, num_classes)

    def forward(self, x, labels=None):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(x.reshape(x.shape[0], -1))
        if labels is not None:
            return F.cross_entropy(x, labels)
        return x


def mobilenet_v2(scale=1.0, **kwargs):
    return MobileNetV2(scale=scale, **kwargs)
