"""LeNet, AlexNet, SqueezeNet and ShuffleNetV2 (counterpart of
``paddle_tpu/vision/models/small_nets.py``), the JAX package's layers and
parameter names on the port's Paddle-API layers."""
from __future__ import annotations

from ... import nn
from ...nn import functional as F
from ...ops import concat
from ._pretrained import no_pretrained


class LeNet(nn.Layer):
    """Reference lenet.py LeNet (the vision-zoo variant)."""

    def __init__(self, num_classes=10):
        super().__init__()
        self.num_classes = num_classes
        self.features = nn.Sequential(
            nn.Conv2D(1, 6, 3, stride=1, padding=1), nn.ReLU(),
            nn.MaxPool2D(2, 2),
            nn.Conv2D(6, 16, 5, stride=1, padding=0), nn.ReLU(),
            nn.MaxPool2D(2, 2))
        if num_classes > 0:
            self.fc = nn.Sequential(
                nn.Linear(400, 120), nn.Linear(120, 84),
                nn.Linear(84, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.num_classes > 0:
            x = self.fc(x.reshape([x.shape[0], -1]))
        return x


class AlexNet(nn.Layer):
    def __init__(self, num_classes=1000):
        super().__init__()
        self.num_classes = num_classes
        self.features = nn.Sequential(
            nn.Conv2D(3, 64, 11, stride=4, padding=2), nn.ReLU(),
            nn.MaxPool2D(3, 2),
            nn.Conv2D(64, 192, 5, padding=2), nn.ReLU(),
            nn.MaxPool2D(3, 2),
            nn.Conv2D(192, 384, 3, padding=1), nn.ReLU(),
            nn.Conv2D(384, 256, 3, padding=1), nn.ReLU(),
            nn.Conv2D(256, 256, 3, padding=1), nn.ReLU(),
            nn.MaxPool2D(3, 2))
        self.avgpool = nn.AdaptiveAvgPool2D((6, 6))
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Dropout(), nn.Linear(256 * 6 * 6, 4096), nn.ReLU(),
                nn.Dropout(), nn.Linear(4096, 4096), nn.ReLU(),
                nn.Linear(4096, num_classes))

    def forward(self, x):
        x = self.avgpool(self.features(x))
        if self.num_classes > 0:
            x = self.classifier(x.reshape([x.shape[0], -1]))
        return x


def alexnet(pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return AlexNet(**kwargs)


class _Fire(nn.Layer):
    def __init__(self, in_c, squeeze_c, e1_c, e3_c):
        super().__init__()
        self.squeeze = nn.Conv2D(in_c, squeeze_c, 1)
        self.expand1 = nn.Conv2D(squeeze_c, e1_c, 1)
        self.expand3 = nn.Conv2D(squeeze_c, e3_c, 3, padding=1)
        self.relu = nn.ReLU()

    def forward(self, x):
        x = self.relu(self.squeeze(x))
        return concat([self.relu(self.expand1(x)),
                       self.relu(self.expand3(x))], axis=1)


class SqueezeNet(nn.Layer):
    """Versions "1.0" and "1.1"."""

    def __init__(self, version="1.0", num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        if version == "1.0":
            self.features = nn.Sequential(
                nn.Conv2D(3, 96, 7, stride=2), nn.ReLU(),
                nn.MaxPool2D(3, 2, ceil_mode=True),
                _Fire(96, 16, 64, 64), _Fire(128, 16, 64, 64),
                _Fire(128, 32, 128, 128),
                nn.MaxPool2D(3, 2, ceil_mode=True),
                _Fire(256, 32, 128, 128), _Fire(256, 48, 192, 192),
                _Fire(384, 48, 192, 192), _Fire(384, 64, 256, 256),
                nn.MaxPool2D(3, 2, ceil_mode=True),
                _Fire(512, 64, 256, 256))
        else:
            self.features = nn.Sequential(
                nn.Conv2D(3, 64, 3, stride=2), nn.ReLU(),
                nn.MaxPool2D(3, 2, ceil_mode=True),
                _Fire(64, 16, 64, 64), _Fire(128, 16, 64, 64),
                nn.MaxPool2D(3, 2, ceil_mode=True),
                _Fire(128, 32, 128, 128), _Fire(256, 32, 128, 128),
                nn.MaxPool2D(3, 2, ceil_mode=True),
                _Fire(256, 48, 192, 192), _Fire(384, 48, 192, 192),
                _Fire(384, 64, 256, 256), _Fire(512, 64, 256, 256))
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Dropout(0.5), nn.Conv2D(512, num_classes, 1), nn.ReLU())
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)

    def forward(self, x):
        x = self.features(x)
        if self.num_classes > 0:
            x = self.classifier(x)
        if self.with_pool:
            x = self.pool(x)
        return x.reshape([x.shape[0], -1])


def squeezenet1_0(pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return SqueezeNet("1.0", **kwargs)


def squeezenet1_1(pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return SqueezeNet("1.1", **kwargs)


class _ShuffleUnit(nn.Layer):
    def __init__(self, in_c, out_c, stride, act=nn.ReLU):
        super().__init__()
        self.stride = stride
        branch_c = out_c // 2
        if stride == 1:
            self.branch2 = nn.Sequential(
                nn.Conv2D(branch_c, branch_c, 1, bias_attr=False),
                nn.BatchNorm2D(branch_c), act(),
                nn.Conv2D(branch_c, branch_c, 3, stride=1, padding=1,
                          groups=branch_c, bias_attr=False),
                nn.BatchNorm2D(branch_c),
                nn.Conv2D(branch_c, branch_c, 1, bias_attr=False),
                nn.BatchNorm2D(branch_c), act())
        else:
            self.branch1 = nn.Sequential(
                nn.Conv2D(in_c, in_c, 3, stride=stride, padding=1,
                          groups=in_c, bias_attr=False),
                nn.BatchNorm2D(in_c),
                nn.Conv2D(in_c, branch_c, 1, bias_attr=False),
                nn.BatchNorm2D(branch_c), act())
            self.branch2 = nn.Sequential(
                nn.Conv2D(in_c, branch_c, 1, bias_attr=False),
                nn.BatchNorm2D(branch_c), act(),
                nn.Conv2D(branch_c, branch_c, 3, stride=stride, padding=1,
                          groups=branch_c, bias_attr=False),
                nn.BatchNorm2D(branch_c),
                nn.Conv2D(branch_c, branch_c, 1, bias_attr=False),
                nn.BatchNorm2D(branch_c), act())

    def forward(self, x):
        if self.stride == 1:
            half = x.shape[1] // 2
            x1, x2 = x[:, :half], x[:, half:]
            out = concat([x1, self.branch2(x2)], axis=1)
        else:
            out = concat([self.branch1(x), self.branch2(x)], axis=1)
        return F.channel_shuffle(out, 2)


_SHUFFLE_CFG = {
    "x0_25": [24, 48, 96, 192, 512], "x0_33": [24, 32, 64, 128, 512],
    "x0_5": [24, 48, 96, 192, 1024], "x1_0": [24, 116, 232, 464, 1024],
    "x1_5": [24, 176, 352, 704, 1024], "x2_0": [24, 244, 488, 976, 2048],
}


class ShuffleNetV2(nn.Layer):
    """Widths ``x0_25`` .. ``x2_0``; ``act="swish"`` for the swish
    variant."""

    def __init__(self, scale="x1_0", act="relu", num_classes=1000,
                 with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        act_layer = nn.Swish if act == "swish" else nn.ReLU
        chans = _SHUFFLE_CFG[scale]
        self.conv1 = nn.Sequential(
            nn.Conv2D(3, chans[0], 3, stride=2, padding=1, bias_attr=False),
            nn.BatchNorm2D(chans[0]), act_layer())
        self.maxpool = nn.MaxPool2D(3, 2, padding=1)
        stages = []
        in_c = chans[0]
        for stage_i, repeat in enumerate((4, 8, 4)):
            out_c = chans[stage_i + 1]
            units = [_ShuffleUnit(in_c, out_c, 2, act_layer)]
            for _ in range(repeat - 1):
                units.append(_ShuffleUnit(out_c, out_c, 1, act_layer))
            stages.append(nn.Sequential(*units))
            in_c = out_c
        self.stages = nn.Sequential(*stages)
        self.conv_last = nn.Sequential(
            nn.Conv2D(in_c, chans[-1], 1, bias_attr=False),
            nn.BatchNorm2D(chans[-1]), act_layer())
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = nn.Linear(chans[-1], num_classes)

    def forward(self, x):
        x = self.conv_last(self.stages(self.maxpool(self.conv1(x))))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(x.reshape([x.shape[0], -1]))
        return x


def _shuffle(scale, pretrained, act="relu", **kwargs):
    no_pretrained(pretrained)
    return ShuffleNetV2(scale=scale, act=act, **kwargs)


def shufflenet_v2_x0_25(pretrained=False, **kw):
    return _shuffle("x0_25", pretrained, **kw)


def shufflenet_v2_x0_33(pretrained=False, **kw):
    return _shuffle("x0_33", pretrained, **kw)


def shufflenet_v2_x0_5(pretrained=False, **kw):
    return _shuffle("x0_5", pretrained, **kw)


def shufflenet_v2_x1_0(pretrained=False, **kw):
    return _shuffle("x1_0", pretrained, **kw)


def shufflenet_v2_x1_5(pretrained=False, **kw):
    return _shuffle("x1_5", pretrained, **kw)


def shufflenet_v2_x2_0(pretrained=False, **kw):
    return _shuffle("x2_0", pretrained, **kw)


def shufflenet_v2_swish(pretrained=False, **kw):
    return _shuffle("x1_0", pretrained, act="swish", **kw)
