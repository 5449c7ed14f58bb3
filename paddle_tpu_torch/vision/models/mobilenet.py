"""MobileNet v1, v2 and v3 (counterpart of
``paddle_tpu/vision/models/mobilenet.py``), the JAX package's layers and
parameter names on the port's Paddle-API layers. The depthwise
convolutions are grouped convolutions (cuDNN on the card), as they are
XLA convolutions there; relu6, hardswish and hardsigmoid are plain
elementwise ops."""
from __future__ import annotations

from ... import nn
from ._pretrained import no_pretrained


def _make_divisible(v, divisor=8, min_value=None):
    min_value = min_value or divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class ConvBNReLU(nn.Sequential):
    def __init__(self, in_c, out_c, kernel=3, stride=1, groups=1,
                 act=nn.ReLU):
        pad = (kernel - 1) // 2
        layers = [nn.Conv2D(in_c, out_c, kernel, stride=stride, padding=pad,
                            groups=groups, bias_attr=False),
                  nn.BatchNorm2D(out_c)]
        if act is not None:
            layers.append(act())
        super().__init__(*layers)


# ---------------- v1 ----------------
class DepthwiseSeparable(nn.Layer):
    def __init__(self, in_c, out_c, stride):
        super().__init__()
        self.dw = ConvBNReLU(in_c, in_c, 3, stride, groups=in_c)
        self.pw = ConvBNReLU(in_c, out_c, 1)

    def forward(self, x):
        return self.pw(self.dw(x))


class MobileNetV1(nn.Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool

        def s(c):
            return int(c * scale)
        cfg = [(32, 64, 1), (64, 128, 2), (128, 128, 1), (128, 256, 2),
               (256, 256, 1), (256, 512, 2)] + [(512, 512, 1)] * 5 + [
                  (512, 1024, 2), (1024, 1024, 1)]
        layers = [ConvBNReLU(3, s(32), 3, 2)]
        for in_c, out_c, stride in cfg:
            layers.append(DepthwiseSeparable(s(in_c), s(out_c), stride))
        self.features = nn.Sequential(*layers)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = nn.Linear(s(1024), num_classes)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(x.reshape([x.shape[0], -1]))
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    no_pretrained(pretrained)
    return MobileNetV1(scale=scale, **kwargs)


# ---------------- v2 ----------------
class InvertedResidual(nn.Layer):
    def __init__(self, in_c, out_c, stride, expand_ratio):
        super().__init__()
        hidden = int(round(in_c * expand_ratio))
        self.use_res = stride == 1 and in_c == out_c
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNReLU(in_c, hidden, 1, act=nn.ReLU6))
        layers += [
            ConvBNReLU(hidden, hidden, 3, stride, groups=hidden,
                       act=nn.ReLU6),
            nn.Conv2D(hidden, out_c, 1, bias_attr=False),
            nn.BatchNorm2D(out_c),
        ]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


class MobileNetV2(nn.Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
               (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
        in_c = _make_divisible(32 * scale)
        last_c = _make_divisible(1280 * max(1.0, scale))
        layers = [ConvBNReLU(3, in_c, 3, 2, act=nn.ReLU6)]
        for t, c, n, s in cfg:
            out_c = _make_divisible(c * scale)
            for i in range(n):
                layers.append(InvertedResidual(in_c, out_c,
                                               s if i == 0 else 1, t))
                in_c = out_c
        layers.append(ConvBNReLU(in_c, last_c, 1, act=nn.ReLU6))
        self.features = nn.Sequential(*layers)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Sequential(nn.Dropout(0.2),
                                            nn.Linear(last_c, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(x.reshape([x.shape[0], -1]))
        return x


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    no_pretrained(pretrained)
    return MobileNetV2(scale=scale, **kwargs)


# ---------------- v3 ----------------
class SqueezeExcite(nn.Layer):
    def __init__(self, ch, squeeze=4):
        super().__init__()
        mid = _make_divisible(ch // squeeze)
        self.pool = nn.AdaptiveAvgPool2D(1)
        self.fc1 = nn.Conv2D(ch, mid, 1)
        self.fc2 = nn.Conv2D(mid, ch, 1)
        self.relu = nn.ReLU()
        self.hsig = nn.Hardsigmoid()

    def forward(self, x):
        s = self.relu(self.fc1(self.pool(x)))
        return x * self.hsig(self.fc2(s))


class V3Block(nn.Layer):
    def __init__(self, in_c, mid_c, out_c, kernel, stride, use_se, act):
        super().__init__()
        self.use_res = stride == 1 and in_c == out_c
        layers = []
        if mid_c != in_c:
            layers.append(ConvBNReLU(in_c, mid_c, 1, act=act))
        layers.append(ConvBNReLU(mid_c, mid_c, kernel, stride,
                                 groups=mid_c, act=act))
        if use_se:
            layers.append(SqueezeExcite(mid_c))
        layers += [nn.Conv2D(mid_c, out_c, 1, bias_attr=False),
                   nn.BatchNorm2D(out_c)]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


_V3_LARGE = [
    # k, exp, out, se, act, stride
    (3, 16, 16, False, nn.ReLU, 1), (3, 64, 24, False, nn.ReLU, 2),
    (3, 72, 24, False, nn.ReLU, 1), (5, 72, 40, True, nn.ReLU, 2),
    (5, 120, 40, True, nn.ReLU, 1), (5, 120, 40, True, nn.ReLU, 1),
    (3, 240, 80, False, nn.Hardswish, 2), (3, 200, 80, False, nn.Hardswish, 1),
    (3, 184, 80, False, nn.Hardswish, 1), (3, 184, 80, False, nn.Hardswish, 1),
    (3, 480, 112, True, nn.Hardswish, 1), (3, 672, 112, True, nn.Hardswish, 1),
    (5, 672, 160, True, nn.Hardswish, 2), (5, 960, 160, True, nn.Hardswish, 1),
    (5, 960, 160, True, nn.Hardswish, 1),
]
_V3_SMALL = [
    (3, 16, 16, True, nn.ReLU, 2), (3, 72, 24, False, nn.ReLU, 2),
    (3, 88, 24, False, nn.ReLU, 1), (5, 96, 40, True, nn.Hardswish, 2),
    (5, 240, 40, True, nn.Hardswish, 1), (5, 240, 40, True, nn.Hardswish, 1),
    (5, 120, 48, True, nn.Hardswish, 1), (5, 144, 48, True, nn.Hardswish, 1),
    (5, 288, 96, True, nn.Hardswish, 2), (5, 576, 96, True, nn.Hardswish, 1),
    (5, 576, 96, True, nn.Hardswish, 1),
]


class MobileNetV3(nn.Layer):
    def __init__(self, cfg, last_c, scale=1.0, num_classes=1000,
                 with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        in_c = _make_divisible(16 * scale)
        layers = [ConvBNReLU(3, in_c, 3, 2, act=nn.Hardswish)]
        for k, exp, out, se, act, s in cfg:
            mid = _make_divisible(exp * scale)
            out_c = _make_divisible(out * scale)
            layers.append(V3Block(in_c, mid, out_c, k, s, se, act))
            in_c = out_c
        last_exp = _make_divisible(cfg[-1][1] * scale)
        layers.append(ConvBNReLU(in_c, last_exp, 1, act=nn.Hardswish))
        self.features = nn.Sequential(*layers)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Linear(last_exp, last_c), nn.Hardswish(),
                nn.Dropout(0.2), nn.Linear(last_c, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(x.reshape([x.shape[0], -1]))
        return x


class MobileNetV3Small(MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__(_V3_SMALL, 1024, scale, num_classes, with_pool)


class MobileNetV3Large(MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__(_V3_LARGE, 1280, scale, num_classes, with_pool)


def mobilenet_v3_small(pretrained=False, scale=1.0, **kwargs):
    no_pretrained(pretrained)
    return MobileNetV3Small(scale=scale, **kwargs)


def mobilenet_v3_large(pretrained=False, scale=1.0, **kwargs):
    no_pretrained(pretrained)
    return MobileNetV3Large(scale=scale, **kwargs)
