"""GoogLeNet (Inception v1) and Inception-v3 (counterpart of
``paddle_tpu/vision/models/inception.py``), in the declared NCHW layout.
The auxiliary heads run in training mode: GoogLeNet's training forward
returns ``(x, aux1, aux2)`` and Inception-v3's ``(x, aux)``; eval
forwards return the logits alone."""

from __future__ import annotations

import torch

from ...core.module import Layer
from ...nn import functional as F
from ...nn.layer.common import Dropout, Linear, Sequential
from ...nn.layer.conv import AdaptiveAvgPool2D, Conv2D
from ...nn.layer.norm import BatchNorm2D
from ._common import building


class _ConvBN(Layer):
    def __init__(self, cin, cout, k, stride=1, padding=0):
        super().__init__()
        self.conv = Conv2D(cin, cout, k, stride=stride, padding=padding,
                           bias_attr=False)
        self.bn = BatchNorm2D(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


# --------------------------------------------------------------- GoogLeNet
class _InceptionV1(Layer):
    def __init__(self, cin, c1, c3r, c3, c5r, c5, pool_proj):
        super().__init__()
        self.b1 = _ConvBN(cin, c1, 1)
        self.b2 = Sequential(_ConvBN(cin, c3r, 1),
                             _ConvBN(c3r, c3, 3, padding=1))
        self.b3 = Sequential(_ConvBN(cin, c5r, 1),
                             _ConvBN(c5r, c5, 3, padding=1))
        self.b4 = _ConvBN(cin, pool_proj, 1)

    def forward(self, x):
        p = F.max_pool2d(x, 3, 1, padding=1)
        return torch.cat([self.b1(x), self.b2(x), self.b3(x), self.b4(p)],
                         dim=1)


class _AuxV1(Layer):
    def __init__(self, cin, num_classes):
        super().__init__()
        self.conv = _ConvBN(cin, 128, 1)
        self.fc1 = Linear(2048, 1024)
        self.fc2 = Linear(1024, num_classes)
        self.dropout = Dropout(0.7)

    def forward(self, x):
        x = F.adaptive_avg_pool2d(x, 4)
        x = self.conv(x).reshape(x.shape[0], -1)
        x = F.relu(self.fc1(x))
        return self.fc2(self.dropout(x))


class GoogLeNet(Layer):
    def __init__(self, num_classes=1000, with_pool=True, device=None,
                 seed: int = 0):
        super().__init__()
        with building(device, seed):
            self.stem = Sequential(_ConvBN(3, 64, 7, stride=2, padding=3))
            self.conv2 = _ConvBN(64, 64, 1)
            self.conv3 = _ConvBN(64, 192, 3, padding=1)
            self.i3a = _InceptionV1(192, 64, 96, 128, 16, 32, 32)
            self.i3b = _InceptionV1(256, 128, 128, 192, 32, 96, 64)
            self.i4a = _InceptionV1(480, 192, 96, 208, 16, 48, 64)
            self.i4b = _InceptionV1(512, 160, 112, 224, 24, 64, 64)
            self.i4c = _InceptionV1(512, 128, 128, 256, 24, 64, 64)
            self.i4d = _InceptionV1(512, 112, 144, 288, 32, 64, 64)
            self.i4e = _InceptionV1(528, 256, 160, 320, 32, 128, 128)
            self.i5a = _InceptionV1(832, 256, 160, 320, 32, 128, 128)
            self.i5b = _InceptionV1(832, 384, 192, 384, 48, 128, 128)
            self.aux1 = _AuxV1(512, num_classes)
            self.aux2 = _AuxV1(528, num_classes)
            self.with_pool = with_pool
            if with_pool:
                self.pool = AdaptiveAvgPool2D(1)
            self.num_classes = num_classes
            if num_classes > 0:
                self.dropout = Dropout(0.2)
                self.fc = Linear(1024, num_classes)

    def forward(self, x):
        x = F.max_pool2d(self.stem(x), 3, 2, padding=1)
        x = F.max_pool2d(self.conv3(self.conv2(x)), 3, 2, padding=1)
        x = self.i3b(self.i3a(x))
        x = F.max_pool2d(x, 3, 2, padding=1)
        x = self.i4a(x)
        aux1 = self.aux1(x) if self.training else None
        x = self.i4d(self.i4c(self.i4b(x)))
        aux2 = self.aux2(x) if self.training else None
        x = F.max_pool2d(self.i4e(x), 3, 2, padding=1)
        x = self.i5b(self.i5a(x))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(self.dropout(x.reshape(x.shape[0], -1)))
        if self.training:
            return x, aux1, aux2
        return x


def googlenet(**kwargs):
    return GoogLeNet(**kwargs)


# ------------------------------------------------------------- Inception v3
class _IncA(Layer):
    def __init__(self, cin, pool_ch):
        super().__init__()
        self.b1 = _ConvBN(cin, 64, 1)
        self.b5 = Sequential(_ConvBN(cin, 48, 1),
                             _ConvBN(48, 64, 5, padding=2))
        self.b3 = Sequential(_ConvBN(cin, 64, 1),
                             _ConvBN(64, 96, 3, padding=1),
                             _ConvBN(96, 96, 3, padding=1))
        self.bp = _ConvBN(cin, pool_ch, 1)

    def forward(self, x):
        p = F.avg_pool2d(x, 3, 1, padding=1)
        return torch.cat([self.b1(x), self.b5(x), self.b3(x), self.bp(p)],
                         dim=1)


class _IncB(Layer):  # grid reduction 35 -> 17
    def __init__(self, cin):
        super().__init__()
        self.b3 = _ConvBN(cin, 384, 3, stride=2)
        self.b3d = Sequential(_ConvBN(cin, 64, 1),
                              _ConvBN(64, 96, 3, padding=1),
                              _ConvBN(96, 96, 3, stride=2))

    def forward(self, x):
        return torch.cat([self.b3(x), self.b3d(x), F.max_pool2d(x, 3, 2)],
                         dim=1)


class _IncC(Layer):  # 17x17, factorized 7x7
    def __init__(self, cin, ch7):
        super().__init__()
        self.b1 = _ConvBN(cin, 192, 1)
        self.b7 = Sequential(
            _ConvBN(cin, ch7, 1),
            _ConvBN(ch7, ch7, (1, 7), padding=(0, 3)),
            _ConvBN(ch7, 192, (7, 1), padding=(3, 0)))
        self.b7d = Sequential(
            _ConvBN(cin, ch7, 1),
            _ConvBN(ch7, ch7, (7, 1), padding=(3, 0)),
            _ConvBN(ch7, ch7, (1, 7), padding=(0, 3)),
            _ConvBN(ch7, ch7, (7, 1), padding=(3, 0)),
            _ConvBN(ch7, 192, (1, 7), padding=(0, 3)))
        self.bp = _ConvBN(cin, 192, 1)

    def forward(self, x):
        p = F.avg_pool2d(x, 3, 1, padding=1)
        return torch.cat([self.b1(x), self.b7(x), self.b7d(x), self.bp(p)],
                         dim=1)


class _IncD(Layer):  # grid reduction 17 -> 8
    def __init__(self, cin):
        super().__init__()
        self.b3 = Sequential(_ConvBN(cin, 192, 1),
                             _ConvBN(192, 320, 3, stride=2))
        self.b7 = Sequential(
            _ConvBN(cin, 192, 1),
            _ConvBN(192, 192, (1, 7), padding=(0, 3)),
            _ConvBN(192, 192, (7, 1), padding=(3, 0)),
            _ConvBN(192, 192, 3, stride=2))

    def forward(self, x):
        return torch.cat([self.b3(x), self.b7(x), F.max_pool2d(x, 3, 2)],
                         dim=1)


class _IncE(Layer):  # 8x8, expanded filter bank
    def __init__(self, cin):
        super().__init__()
        self.b1 = _ConvBN(cin, 320, 1)
        self.b3_stem = _ConvBN(cin, 384, 1)
        self.b3_a = _ConvBN(384, 384, (1, 3), padding=(0, 1))
        self.b3_b = _ConvBN(384, 384, (3, 1), padding=(1, 0))
        self.b3d_stem = Sequential(_ConvBN(cin, 448, 1),
                                   _ConvBN(448, 384, 3, padding=1))
        self.b3d_a = _ConvBN(384, 384, (1, 3), padding=(0, 1))
        self.b3d_b = _ConvBN(384, 384, (3, 1), padding=(1, 0))
        self.bp = _ConvBN(cin, 192, 1)

    def forward(self, x):
        s = self.b3_stem(x)
        d = self.b3d_stem(x)
        p = F.avg_pool2d(x, 3, 1, padding=1)
        return torch.cat([self.b1(x), self.b3_a(s), self.b3_b(s),
                          self.b3d_a(d), self.b3d_b(d), self.bp(p)], dim=1)


class _AuxV3(Layer):
    def __init__(self, cin, num_classes):
        super().__init__()
        self.conv0 = _ConvBN(cin, 128, 1)
        self.conv1 = _ConvBN(128, 768, 5)
        self.fc = Linear(768, num_classes)

    def forward(self, x):
        x = F.avg_pool2d(x, 5, 3)
        x = self.conv1(self.conv0(x))
        x = F.adaptive_avg_pool2d(x, 1)
        return self.fc(x.reshape(x.shape[0], -1))


class InceptionV3(Layer):
    def __init__(self, num_classes=1000, with_pool=True, device=None,
                 seed: int = 0):
        super().__init__()
        with building(device, seed):
            self.stem = Sequential(_ConvBN(3, 32, 3, stride=2),
                                   _ConvBN(32, 32, 3),
                                   _ConvBN(32, 64, 3, padding=1))
            self.conv3 = _ConvBN(64, 80, 1)
            self.conv4 = _ConvBN(80, 192, 3)
            self.a1 = _IncA(192, 32)
            self.a2 = _IncA(256, 64)
            self.a3 = _IncA(288, 64)
            self.b = _IncB(288)
            self.c1 = _IncC(768, 128)
            self.c2 = _IncC(768, 160)
            self.c3 = _IncC(768, 160)
            self.c4 = _IncC(768, 192)
            self.aux = _AuxV3(768, num_classes)
            self.d = _IncD(768)
            self.e1 = _IncE(1280)
            self.e2 = _IncE(2048)
            self.with_pool = with_pool
            if with_pool:
                self.pool = AdaptiveAvgPool2D(1)
            self.num_classes = num_classes
            if num_classes > 0:
                self.dropout = Dropout(0.5)
                self.fc = Linear(2048, num_classes)

    def forward(self, x):
        x = F.max_pool2d(self.stem(x), 3, 2)
        x = F.max_pool2d(self.conv4(self.conv3(x)), 3, 2)
        x = self.a3(self.a2(self.a1(x)))
        x = self.b(x)
        x = self.c4(self.c3(self.c2(self.c1(x))))
        aux = self.aux(x) if self.training else None
        x = self.e2(self.e1(self.d(x)))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(self.dropout(x.reshape(x.shape[0], -1)))
        if self.training:
            return x, aux
        return x


def inception_v3(**kwargs):
    return InceptionV3(**kwargs)
