"""MobileNetV3 (counterpart of
``paddle_tpu/vision/models/mobilenetv3.py``): bneck blocks with
squeeze-excitation (``hardsigmoid``) and ``hardswish``, large and small,
in the declared NCHW layout."""

from __future__ import annotations

from ...core.module import Layer
from ...nn import functional as F
from ...nn.layer.common import Dropout, Linear, Sequential
from ...nn.layer.conv import AdaptiveAvgPool2D, Conv2D
from ...nn.layer.norm import BatchNorm2D
from ._common import building
from .mobilenetv2 import _make_divisible


class _SqueezeExcite(Layer):
    def __init__(self, ch, squeeze_ch):
        super().__init__()
        self.fc1 = Conv2D(ch, squeeze_ch, 1)
        self.fc2 = Conv2D(squeeze_ch, ch, 1)

    def forward(self, x):
        s = F.adaptive_avg_pool2d(x, 1)
        s = F.relu(self.fc1(s))
        return x * F.hardsigmoid(self.fc2(s))


class _ConvBNAct(Layer):
    def __init__(self, cin, cout, k=3, stride=1, groups=1, act="hardswish"):
        super().__init__()
        self.conv = Conv2D(cin, cout, k, stride=stride, padding=(k - 1) // 2,
                           groups=groups, bias_attr=False)
        self.bn = BatchNorm2D(cout)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        if self.act == "hardswish":
            return F.hardswish(x)
        if self.act == "relu":
            return F.relu(x)
        return x


class _Bneck(Layer):
    def __init__(self, cin, exp, cout, k, stride, use_se, act):
        super().__init__()
        self.use_res = stride == 1 and cin == cout
        layers = []
        if exp != cin:
            layers.append(_ConvBNAct(cin, exp, 1, act=act))
        layers.append(_ConvBNAct(exp, exp, k, stride=stride, groups=exp,
                                 act=act))
        if use_se:
            layers.append(_SqueezeExcite(exp, _make_divisible(exp // 4)))
        layers.append(_ConvBNAct(exp, cout, 1, act="none"))
        self.body = Sequential(*layers)

    def forward(self, x):
        out = self.body(x)
        return x + out if self.use_res else out


# (kernel, exp, out, SE, act, stride): the paper's Tables 1 and 2
_LARGE = [
    (3, 16, 16, False, "relu", 1),
    (3, 64, 24, False, "relu", 2),
    (3, 72, 24, False, "relu", 1),
    (5, 72, 40, True, "relu", 2),
    (5, 120, 40, True, "relu", 1),
    (5, 120, 40, True, "relu", 1),
    (3, 240, 80, False, "hardswish", 2),
    (3, 200, 80, False, "hardswish", 1),
    (3, 184, 80, False, "hardswish", 1),
    (3, 184, 80, False, "hardswish", 1),
    (3, 480, 112, True, "hardswish", 1),
    (3, 672, 112, True, "hardswish", 1),
    (5, 672, 160, True, "hardswish", 2),
    (5, 960, 160, True, "hardswish", 1),
    (5, 960, 160, True, "hardswish", 1),
]
_SMALL = [
    (3, 16, 16, True, "relu", 2),
    (3, 72, 24, False, "relu", 2),
    (3, 88, 24, False, "relu", 1),
    (5, 96, 40, True, "hardswish", 2),
    (5, 240, 40, True, "hardswish", 1),
    (5, 240, 40, True, "hardswish", 1),
    (5, 120, 48, True, "hardswish", 1),
    (5, 144, 48, True, "hardswish", 1),
    (5, 288, 96, True, "hardswish", 2),
    (5, 576, 96, True, "hardswish", 1),
    (5, 576, 96, True, "hardswish", 1),
]


class MobileNetV3(Layer):
    def __init__(self, config, last_channel, scale=1.0, num_classes=1000,
                 with_pool=True, device=None, seed: int = 0):
        super().__init__()
        with building(device, seed):
            inp = _make_divisible(16 * scale)
            self.stem = _ConvBNAct(3, inp, 3, stride=2, act="hardswish")
            blocks = []
            for k, exp, cout, se, act, s in config:
                out_c = _make_divisible(cout * scale)
                blocks.append(_Bneck(inp, _make_divisible(exp * scale),
                                     out_c, k, s, se, act))
                inp = out_c
            self.blocks = Sequential(*blocks)
            last_exp = _make_divisible(config[-1][1] * scale)
            self.conv_last = _ConvBNAct(inp, last_exp, 1, act="hardswish")
            self.with_pool = with_pool
            if with_pool:
                self.pool = AdaptiveAvgPool2D(1)
            self.num_classes = num_classes
            if num_classes > 0:
                # hardswish after the first Linear, in forward
                self.classifier = Sequential(
                    Linear(last_exp, last_channel), Dropout(0.2),
                    Linear(last_channel, num_classes))

    def forward(self, x):
        x = self.conv_last(self.blocks(self.stem(x)))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = x.reshape(x.shape[0], -1)
            x = F.hardswish(self.classifier[0](x))
            x = self.classifier[2](self.classifier[1](x))
        return x


def mobilenet_v3_large(scale=1.0, **kwargs):
    return MobileNetV3(_LARGE, _make_divisible(1280 * scale), scale,
                       **kwargs)


def mobilenet_v3_small(scale=1.0, **kwargs):
    return MobileNetV3(_SMALL, _make_divisible(1024 * scale), scale,
                       **kwargs)
