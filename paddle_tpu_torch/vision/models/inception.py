"""GoogLeNet (Inception v1) and InceptionV3 (counterpart of
``paddle_tpu/vision/models/inception.py``), the JAX package's layers and
parameter names on the port's Paddle-API layers; the branches of a block
are separate convolutions, concatenated on the channel axis."""
from __future__ import annotations

from ... import nn
from ...ops import concat
from ._pretrained import no_pretrained


def _conv_bn(in_c, out_c, kernel, stride=1, padding=0):
    return nn.Sequential(
        nn.Conv2D(in_c, out_c, kernel, stride=stride, padding=padding,
                  bias_attr=False),
        nn.BatchNorm2D(out_c), nn.ReLU())


def _cat(xs):
    return concat(xs, axis=1)


class _InceptionV1Block(nn.Layer):
    def __init__(self, in_c, c1, c3r, c3, c5r, c5, proj):
        super().__init__()
        self.b1 = _conv_bn(in_c, c1, 1)
        self.b3 = nn.Sequential(_conv_bn(in_c, c3r, 1),
                                _conv_bn(c3r, c3, 3, padding=1))
        self.b5 = nn.Sequential(_conv_bn(in_c, c5r, 1),
                                _conv_bn(c5r, c5, 5, padding=2))
        self.proj = nn.Sequential(nn.MaxPool2D(3, 1, padding=1),
                                  _conv_bn(in_c, proj, 1))

    def forward(self, x):
        return _cat([self.b1(x), self.b3(x), self.b5(x), self.proj(x)])


class GoogLeNet(nn.Layer):
    """Inception v1. With a classifier it returns the (main, aux1, aux2)
    logits, the two auxiliary heads after inception 4a and 4d, as the
    JAX package's does in either mode."""

    def __init__(self, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = nn.Sequential(
            _conv_bn(3, 64, 7, stride=2, padding=3),
            nn.MaxPool2D(3, 2, padding=1),
            _conv_bn(64, 64, 1), _conv_bn(64, 192, 3, padding=1),
            nn.MaxPool2D(3, 2, padding=1))
        self.i3a = _InceptionV1Block(192, 64, 96, 128, 16, 32, 32)
        self.i3b = _InceptionV1Block(256, 128, 128, 192, 32, 96, 64)
        self.pool3 = nn.MaxPool2D(3, 2, padding=1)
        self.i4a = _InceptionV1Block(480, 192, 96, 208, 16, 48, 64)
        self.i4b = _InceptionV1Block(512, 160, 112, 224, 24, 64, 64)
        self.i4c = _InceptionV1Block(512, 128, 128, 256, 24, 64, 64)
        self.i4d = _InceptionV1Block(512, 112, 144, 288, 32, 64, 64)
        self.i4e = _InceptionV1Block(528, 256, 160, 320, 32, 128, 128)
        self.pool4 = nn.MaxPool2D(3, 2, padding=1)
        self.i5a = _InceptionV1Block(832, 256, 160, 320, 32, 128, 128)
        self.i5b = _InceptionV1Block(832, 384, 192, 384, 48, 128, 128)
        if with_pool:
            self.pool5 = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.dropout = nn.Dropout(0.4)
            self.fc = nn.Linear(1024, num_classes)
            # aux heads (train-time deep supervision)
            self.aux1 = nn.Sequential(nn.AdaptiveAvgPool2D(4),
                                      _conv_bn(512, 128, 1))
            self.aux1_fc = nn.Sequential(nn.Linear(128 * 16, 1024),
                                         nn.ReLU(), nn.Dropout(0.7),
                                         nn.Linear(1024, num_classes))
            self.aux2 = nn.Sequential(nn.AdaptiveAvgPool2D(4),
                                      _conv_bn(528, 128, 1))
            self.aux2_fc = nn.Sequential(nn.Linear(128 * 16, 1024),
                                         nn.ReLU(), nn.Dropout(0.7),
                                         nn.Linear(1024, num_classes))

    def forward(self, x):
        x = self.pool3(self.i3b(self.i3a(self.stem(x))))
        x = self.i4a(x)
        a1 = x
        x = self.i4d(self.i4c(self.i4b(x)))
        a2 = x
        x = self.pool4(self.i4e(x))
        x = self.i5b(self.i5a(x))
        if self.with_pool:
            x = self.pool5(x)
        if self.num_classes > 0:
            out = self.fc(self.dropout(x.reshape([x.shape[0], -1])))
            o1 = self.aux1(a1)
            o1 = self.aux1_fc(o1.reshape([o1.shape[0], -1]))
            o2 = self.aux2(a2)
            o2 = self.aux2_fc(o2.reshape([o2.shape[0], -1]))
            return out, o1, o2
        return x


def googlenet(pretrained=False, **kw):
    no_pretrained(pretrained)
    return GoogLeNet(**kw)


class _InceptionA(nn.Layer):
    def __init__(self, in_c, pool_c):
        super().__init__()
        self.b1 = _conv_bn(in_c, 64, 1)
        self.b5 = nn.Sequential(_conv_bn(in_c, 48, 1),
                                _conv_bn(48, 64, 5, padding=2))
        self.b3 = nn.Sequential(_conv_bn(in_c, 64, 1),
                                _conv_bn(64, 96, 3, padding=1),
                                _conv_bn(96, 96, 3, padding=1))
        self.bp = nn.Sequential(nn.AvgPool2D(3, 1, padding=1),
                                _conv_bn(in_c, pool_c, 1))

    def forward(self, x):
        return _cat([self.b1(x), self.b5(x), self.b3(x), self.bp(x)])


class _InceptionB(nn.Layer):
    def __init__(self, in_c):
        super().__init__()
        self.b3 = _conv_bn(in_c, 384, 3, stride=2)
        self.b3d = nn.Sequential(_conv_bn(in_c, 64, 1),
                                 _conv_bn(64, 96, 3, padding=1),
                                 _conv_bn(96, 96, 3, stride=2))
        self.pool = nn.MaxPool2D(3, 2)

    def forward(self, x):
        return _cat([self.b3(x), self.b3d(x), self.pool(x)])


class _InceptionC(nn.Layer):
    def __init__(self, in_c, c7):
        super().__init__()
        self.b1 = _conv_bn(in_c, 192, 1)
        self.b7 = nn.Sequential(
            _conv_bn(in_c, c7, 1),
            _conv_bn(c7, c7, (1, 7), padding=(0, 3)),
            _conv_bn(c7, 192, (7, 1), padding=(3, 0)))
        self.b7d = nn.Sequential(
            _conv_bn(in_c, c7, 1),
            _conv_bn(c7, c7, (7, 1), padding=(3, 0)),
            _conv_bn(c7, c7, (1, 7), padding=(0, 3)),
            _conv_bn(c7, c7, (7, 1), padding=(3, 0)),
            _conv_bn(c7, 192, (1, 7), padding=(0, 3)))
        self.bp = nn.Sequential(nn.AvgPool2D(3, 1, padding=1),
                                _conv_bn(in_c, 192, 1))

    def forward(self, x):
        return _cat([self.b1(x), self.b7(x), self.b7d(x), self.bp(x)])


class _InceptionD(nn.Layer):
    def __init__(self, in_c):
        super().__init__()
        self.b3 = nn.Sequential(_conv_bn(in_c, 192, 1),
                                _conv_bn(192, 320, 3, stride=2))
        self.b7 = nn.Sequential(
            _conv_bn(in_c, 192, 1),
            _conv_bn(192, 192, (1, 7), padding=(0, 3)),
            _conv_bn(192, 192, (7, 1), padding=(3, 0)),
            _conv_bn(192, 192, 3, stride=2))
        self.pool = nn.MaxPool2D(3, 2)

    def forward(self, x):
        return _cat([self.b3(x), self.b7(x), self.pool(x)])


class _InceptionE(nn.Layer):
    def __init__(self, in_c):
        super().__init__()
        self.b1 = _conv_bn(in_c, 320, 1)
        self.b3_stem = _conv_bn(in_c, 384, 1)
        self.b3_a = _conv_bn(384, 384, (1, 3), padding=(0, 1))
        self.b3_b = _conv_bn(384, 384, (3, 1), padding=(1, 0))
        self.b3d_stem = nn.Sequential(_conv_bn(in_c, 448, 1),
                                      _conv_bn(448, 384, 3, padding=1))
        self.b3d_a = _conv_bn(384, 384, (1, 3), padding=(0, 1))
        self.b3d_b = _conv_bn(384, 384, (3, 1), padding=(1, 0))
        self.bp = nn.Sequential(nn.AvgPool2D(3, 1, padding=1),
                                _conv_bn(in_c, 192, 1))

    def forward(self, x):
        s = self.b3_stem(x)
        d = self.b3d_stem(x)
        return _cat([self.b1(x), self.b3_a(s), self.b3_b(s),
                     self.b3d_a(d), self.b3d_b(d), self.bp(x)])


class InceptionV3(nn.Layer):
    """Inception v3 (299x299 inputs)."""

    def __init__(self, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = nn.Sequential(
            _conv_bn(3, 32, 3, stride=2), _conv_bn(32, 32, 3),
            _conv_bn(32, 64, 3, padding=1), nn.MaxPool2D(3, 2),
            _conv_bn(64, 80, 1), _conv_bn(80, 192, 3), nn.MaxPool2D(3, 2))
        self.blocks = nn.Sequential(
            _InceptionA(192, 32), _InceptionA(256, 64), _InceptionA(288, 64),
            _InceptionB(288),
            _InceptionC(768, 128), _InceptionC(768, 160),
            _InceptionC(768, 160), _InceptionC(768, 192),
            _InceptionD(768),
            _InceptionE(1280), _InceptionE(2048))
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.dropout = nn.Dropout(0.5)
            self.fc = nn.Linear(2048, num_classes)

    def forward(self, x):
        x = self.blocks(self.stem(x))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(self.dropout(x.reshape([x.shape[0], -1])))
        return x


def inception_v3(pretrained=False, **kw):
    no_pretrained(pretrained)
    return InceptionV3(**kw)
