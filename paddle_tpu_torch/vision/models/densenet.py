"""The DenseNet family (counterpart of
``paddle_tpu/vision/models/densenet.py``): ``DenseNet`` and
``densenet121``/``161``/``169``/``201``/``264``, the JAX package's layers
and parameter names on the port's Paddle-API layers."""
from __future__ import annotations

from ... import nn
from ...ops import concat
from ._pretrained import no_pretrained


class _DenseLayer(nn.Layer):
    def __init__(self, in_c, growth_rate, bn_size, dropout):
        super().__init__()
        self.bn1 = nn.BatchNorm2D(in_c)
        self.conv1 = nn.Conv2D(in_c, bn_size * growth_rate, 1,
                               bias_attr=False)
        self.bn2 = nn.BatchNorm2D(bn_size * growth_rate)
        self.conv2 = nn.Conv2D(bn_size * growth_rate, growth_rate, 3,
                               padding=1, bias_attr=False)
        self.relu = nn.ReLU()
        self.dropout = nn.Dropout(dropout) if dropout else None

    def forward(self, x):
        out = self.conv1(self.relu(self.bn1(x)))
        out = self.conv2(self.relu(self.bn2(out)))
        if self.dropout is not None:
            out = self.dropout(out)
        return concat([x, out], axis=1)


class _Transition(nn.Layer):
    def __init__(self, in_c, out_c):
        super().__init__()
        self.bn = nn.BatchNorm2D(in_c)
        self.conv = nn.Conv2D(in_c, out_c, 1, bias_attr=False)
        self.relu = nn.ReLU()
        self.pool = nn.AvgPool2D(2, 2)

    def forward(self, x):
        return self.pool(self.conv(self.relu(self.bn(x))))


_CFGS = {
    121: (64, 32, (6, 12, 24, 16)),
    161: (96, 48, (6, 12, 36, 24)),
    169: (64, 32, (6, 12, 32, 32)),
    201: (64, 32, (6, 12, 48, 32)),
    264: (64, 32, (6, 12, 64, 48)),
}


class DenseNet(nn.Layer):
    def __init__(self, layers=121, bn_size=4, dropout=0.0, num_classes=1000,
                 with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        num_init, growth, block_cfg = _CFGS[layers]
        feats = [nn.Conv2D(3, num_init, 7, stride=2, padding=3,
                           bias_attr=False),
                 nn.BatchNorm2D(num_init), nn.ReLU(),
                 nn.MaxPool2D(3, 2, padding=1)]
        ch = num_init
        for bi, n_layers in enumerate(block_cfg):
            for _ in range(n_layers):
                feats.append(_DenseLayer(ch, growth, bn_size, dropout))
                ch += growth
            if bi != len(block_cfg) - 1:
                feats.append(_Transition(ch, ch // 2))
                ch //= 2
        feats += [nn.BatchNorm2D(ch), nn.ReLU()]
        self.features = nn.Sequential(*feats)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Linear(ch, num_classes)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(x.reshape([x.shape[0], -1]))
        return x


def densenet121(pretrained=False, **kw):
    no_pretrained(pretrained)
    return DenseNet(121, **kw)


def densenet161(pretrained=False, **kw):
    no_pretrained(pretrained)
    return DenseNet(161, **kw)


def densenet169(pretrained=False, **kw):
    no_pretrained(pretrained)
    return DenseNet(169, **kw)


def densenet201(pretrained=False, **kw):
    no_pretrained(pretrained)
    return DenseNet(201, **kw)


def densenet264(pretrained=False, **kw):
    no_pretrained(pretrained)
    return DenseNet(264, **kw)
