"""The classic CNNs (counterpart of ``paddle_tpu/vision/models/
classic.py``): VGG (with and without BatchNorm), AlexNet, SqueezeNet 1.0
and 1.1, DenseNet, ShuffleNetV2 and LeNet, in the declared NCHW
layout."""

from __future__ import annotations

import torch

from ...core.module import Layer
from ...nn import functional as F
from ...nn.layer.common import Dropout, LayerList, Linear, Sequential
from ...nn.layer.conv import Conv2D
from ...nn.layer.norm import BatchNorm2D
from ._common import building


class _ConvBNReLU(Layer):
    def __init__(self, cin, cout, k=3, stride=1, padding=1, groups=1):
        super().__init__()
        self.conv = Conv2D(cin, cout, k, stride=stride, padding=padding,
                           groups=groups, bias_attr=False)
        self.bn = BatchNorm2D(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class _MaxPool2x2(Layer):
    def forward(self, x):
        return F.max_pool2d(x, 2, 2)


class _ConvReLU(Layer):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = Conv2D(cin, cout, 3, padding=1)

    def forward(self, x):
        return F.relu(self.conv(x))


# ---------------------------------------------------------------------------
# VGG
# ---------------------------------------------------------------------------
_VGG_CFGS = {
    11: [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    13: [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
         512, 512, "M"],
    16: [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
         "M", 512, 512, 512, "M"],
    19: [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512,
         512, 512, "M", 512, 512, 512, 512, "M"],
}


class VGG(Layer):
    def __init__(self, depth=16, num_classes=1000, batch_norm=False,
                 with_pool=True, device=None, seed: int = 0):
        super().__init__()
        with building(device, seed):
            layers = []
            cin = 3
            for v in _VGG_CFGS[depth]:
                if v == "M":
                    layers.append(_MaxPool2x2())
                    continue
                layers.append(_ConvBNReLU(cin, v) if batch_norm
                              else _ConvReLU(cin, v))
                cin = v
            self.features = LayerList(layers)
            self.batch_norm = batch_norm
            self.with_pool = with_pool
            self.classifier = LayerList([
                Linear(512 * 7 * 7, 4096), Linear(4096, 4096),
                Linear(4096, num_classes)])
            self.dropout = Dropout(0.5)

    def forward(self, x):
        for m in self.features:
            x = m(x)
        if self.with_pool:
            x = F.adaptive_avg_pool2d(x, (7, 7))
        x = x.reshape(x.shape[0], -1)
        x = self.dropout(F.relu(self.classifier[0](x)))
        x = self.dropout(F.relu(self.classifier[1](x)))
        return self.classifier[2](x)


def vgg11(**kw):
    return VGG(11, **kw)


def vgg13(**kw):
    return VGG(13, **kw)


def vgg16(**kw):
    return VGG(16, **kw)


def vgg19(**kw):
    return VGG(19, **kw)


# ---------------------------------------------------------------------------
# AlexNet
# ---------------------------------------------------------------------------
class AlexNet(Layer):
    def __init__(self, num_classes=1000, device=None, seed: int = 0):
        super().__init__()
        with building(device, seed):
            self.c1 = Conv2D(3, 64, 11, stride=4, padding=2)
            self.c2 = Conv2D(64, 192, 5, padding=2)
            self.c3 = Conv2D(192, 384, 3, padding=1)
            self.c4 = Conv2D(384, 256, 3, padding=1)
            self.c5 = Conv2D(256, 256, 3, padding=1)
            self.fc1 = Linear(256 * 6 * 6, 4096)
            self.fc2 = Linear(4096, 4096)
            self.fc3 = Linear(4096, num_classes)
            self.dropout = Dropout(0.5)

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.c1(x)), 3, 2)
        x = F.max_pool2d(F.relu(self.c2(x)), 3, 2)
        x = F.relu(self.c4(F.relu(self.c3(x))))
        x = F.max_pool2d(F.relu(self.c5(x)), 3, 2)
        x = F.adaptive_avg_pool2d(x, (6, 6)).reshape(x.shape[0], -1)
        x = self.dropout(F.relu(self.fc1(x)))
        x = self.dropout(F.relu(self.fc2(x)))
        return self.fc3(x)


def alexnet(**kw):
    return AlexNet(**kw)


# ---------------------------------------------------------------------------
# SqueezeNet
# ---------------------------------------------------------------------------
class _Fire(Layer):
    def __init__(self, cin, squeeze, e1, e3):
        super().__init__()
        self.squeeze = Conv2D(cin, squeeze, 1)
        self.expand1 = Conv2D(squeeze, e1, 1)
        self.expand3 = Conv2D(squeeze, e3, 3, padding=1)

    def forward(self, x):
        s = F.relu(self.squeeze(x))
        return torch.cat([F.relu(self.expand1(s)), F.relu(self.expand3(s))],
                         dim=1)


class SqueezeNet(Layer):
    def __init__(self, version="1.1", num_classes=1000, device=None,
                 seed: int = 0):
        super().__init__()
        if version not in ("1.0", "1.1"):
            raise ValueError(f"SqueezeNet: unknown version {version!r}")
        self.version = version
        with building(device, seed):
            if version == "1.1":
                self.conv1 = Conv2D(3, 64, 3, stride=2)
                cin, self._pool_after = 64, (1, 3)
            else:
                self.conv1 = Conv2D(3, 96, 7, stride=2)
                cin, self._pool_after = 96, (2, 6)
            self.fires = LayerList([
                _Fire(cin, 16, 64, 64), _Fire(128, 16, 64, 64),
                _Fire(128, 32, 128, 128), _Fire(256, 32, 128, 128),
                _Fire(256, 48, 192, 192), _Fire(384, 48, 192, 192),
                _Fire(384, 64, 256, 256), _Fire(512, 64, 256, 256)])
            self.conv_final = Conv2D(512, num_classes, 1)
            self.dropout = Dropout(0.5)

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.conv1(x)), 3, 2)
        for i, fire in enumerate(self.fires):
            x = fire(x)
            if i in self._pool_after:
                x = F.max_pool2d(x, 3, 2)
        x = F.relu(self.conv_final(self.dropout(x)))
        return F.adaptive_avg_pool2d(x, (1, 1)).reshape(x.shape[0], -1)


def squeezenet1_0(**kw):
    return SqueezeNet("1.0", **kw)


def squeezenet1_1(**kw):
    return SqueezeNet("1.1", **kw)


# ---------------------------------------------------------------------------
# DenseNet
# ---------------------------------------------------------------------------
class _DenseLayer(Layer):
    def __init__(self, cin, growth, bn_size=4):
        super().__init__()
        self.bn1 = BatchNorm2D(cin)
        self.conv1 = Conv2D(cin, bn_size * growth, 1, bias_attr=False)
        self.bn2 = BatchNorm2D(bn_size * growth)
        self.conv2 = Conv2D(bn_size * growth, growth, 3, padding=1,
                            bias_attr=False)

    def forward(self, x):
        h = self.conv1(F.relu(self.bn1(x)))
        h = self.conv2(F.relu(self.bn2(h)))
        return torch.cat([x, h], dim=1)


class _Transition(Layer):
    def __init__(self, cin, cout):
        super().__init__()
        self.bn = BatchNorm2D(cin)
        self.conv = Conv2D(cin, cout, 1, bias_attr=False)

    def forward(self, x):
        return F.avg_pool2d(self.conv(F.relu(self.bn(x))), 2, 2)


class DenseNet(Layer):
    def __init__(self, layers=121, growth_rate=32, num_classes=1000,
                 device=None, seed: int = 0):
        super().__init__()
        block_cfg = {121: (6, 12, 24, 16), 169: (6, 12, 32, 32),
                     201: (6, 12, 48, 32)}[layers]
        with building(device, seed):
            c = 64
            self.stem = Conv2D(3, c, 7, stride=2, padding=3, bias_attr=False)
            self.stem_bn = BatchNorm2D(c)
            blocks = []
            for bi, n in enumerate(block_cfg):
                for _ in range(n):
                    blocks.append(_DenseLayer(c, growth_rate))
                    c += growth_rate
                if bi != len(block_cfg) - 1:
                    blocks.append(_Transition(c, c // 2))
                    c //= 2
            self.blocks = LayerList(blocks)
            self.final_bn = BatchNorm2D(c)
            self.classifier = Linear(c, num_classes)

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.stem_bn(self.stem(x))), 3, 2, padding=1)
        for blk in self.blocks:
            x = blk(x)
        x = F.relu(self.final_bn(x))
        x = F.adaptive_avg_pool2d(x, (1, 1)).reshape(x.shape[0], -1)
        return self.classifier(x)


def densenet121(**kw):
    return DenseNet(121, **kw)


# ---------------------------------------------------------------------------
# ShuffleNetV2
# ---------------------------------------------------------------------------
def _channel_shuffle(x, groups=2):
    n, c, h, w = x.shape
    return x.reshape(n, groups, c // groups, h, w).transpose(1, 2).reshape(
        n, c, h, w)


class _ShuffleUnit(Layer):
    def __init__(self, cin, cout, stride):
        super().__init__()
        self.stride = stride
        branch = cout // 2
        if stride > 1:
            self.b1_dw = Conv2D(cin, cin, 3, stride=stride, padding=1,
                                groups=cin, bias_attr=False)
            self.b1_bn1 = BatchNorm2D(cin)
            self.b1_pw = Conv2D(cin, branch, 1, bias_attr=False)
            self.b1_bn2 = BatchNorm2D(branch)
            b2_in = cin
        else:
            b2_in = cin // 2
        self.b2_pw1 = Conv2D(b2_in, branch, 1, bias_attr=False)
        self.b2_bn1 = BatchNorm2D(branch)
        self.b2_dw = Conv2D(branch, branch, 3, stride=stride, padding=1,
                            groups=branch, bias_attr=False)
        self.b2_bn2 = BatchNorm2D(branch)
        self.b2_pw2 = Conv2D(branch, branch, 1, bias_attr=False)
        self.b2_bn3 = BatchNorm2D(branch)

    def forward(self, x):
        if self.stride > 1:
            left = F.relu(self.b1_bn2(self.b1_pw(self.b1_bn1(
                self.b1_dw(x)))))
            right_in = x
        else:
            left, right_in = x.chunk(2, dim=1)
        h = F.relu(self.b2_bn1(self.b2_pw1(right_in)))
        h = self.b2_bn2(self.b2_dw(h))
        h = F.relu(self.b2_bn3(self.b2_pw2(h)))
        return _channel_shuffle(torch.cat([left, h], dim=1))


class ShuffleNetV2(Layer):
    def __init__(self, scale=1.0, num_classes=1000, device=None,
                 seed: int = 0):
        super().__init__()
        stage_out = {0.5: (48, 96, 192, 1024),
                     1.0: (116, 232, 464, 1024),
                     1.5: (176, 352, 704, 1024)}[scale]
        with building(device, seed):
            self.stem = _ConvBNReLU(3, 24, 3, stride=2)
            units = []
            cin = 24
            for cout, repeat in zip(stage_out[:3], (4, 8, 4)):
                units.append(_ShuffleUnit(cin, cout, 2))
                for _ in range(repeat - 1):
                    units.append(_ShuffleUnit(cout, cout, 1))
                cin = cout
            self.units = LayerList(units)
            self.head = _ConvBNReLU(cin, stage_out[3], 1, padding=0)
            self.classifier = Linear(stage_out[3], num_classes)

    def forward(self, x):
        x = F.max_pool2d(self.stem(x), 3, 2, padding=1)
        for u in self.units:
            x = u(x)
        x = self.head(x)
        x = F.adaptive_avg_pool2d(x, (1, 1)).reshape(x.shape[0], -1)
        return self.classifier(x)


def shufflenet_v2_x1_0(**kw):
    return ShuffleNetV2(1.0, **kw)


# ---------------------------------------------------------------------------
# LeNet: the MNIST 1 x 28 x 28 configuration
# ---------------------------------------------------------------------------
class LeNet(Layer):
    def __init__(self, num_classes=10, device=None, seed: int = 0):
        super().__init__()
        with building(device, seed):
            self.features = Sequential(Conv2D(1, 6, 3, stride=1, padding=1))
            self.conv2 = Conv2D(6, 16, 5, stride=1)
            self.num_classes = num_classes
            if num_classes > 0:
                self.fc = Linear(400, 120)
                self.fc1 = Linear(120, 84)
                self.fc2 = Linear(84, num_classes)

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.features(x)), 2, 2)
        x = F.max_pool2d(F.relu(self.conv2(x)), 2, 2)
        if self.num_classes > 0:
            x = x.reshape(x.shape[0], -1)
            x = F.relu(self.fc(x))
            x = F.relu(self.fc1(x))
            x = self.fc2(x)
        return x
