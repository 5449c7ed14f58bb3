"""The port's ``summary`` and ``flops`` (``hapi/summary.py``,
``hapi/dynamic_flops.py``) against the JAX package's, exactly: the
parameter counts and every layer's output shape in the table, and the
FLOP count, on ResNet-18, a tiny BERT and ResNet-50 at 1x3x224x224 (the
numbers ``chip_smoke.py``'s checkpoint phase holds on the card).
"""
import re

import numpy as np
import pytest

import chip_smoke
import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.models import bert as jbert
from paddle_tpu.vision.models import resnet18 as j_resnet18
from paddle_tpu.vision.models import resnet50 as j_resnet50
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.vision.models import resnet18 as t_resnet18
from paddle_tpu_torch.vision.models import resnet50 as t_resnet50

BERT_TINY = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
                 num_attention_heads=2, intermediate_size=64,
                 max_position_embeddings=32)


@pytest.fixture(autouse=True)
def _cpu():
    with tp.device_guard("cpu"):
        yield


def _run(fn, capsys):
    """fn's result and the table rows it printed (layer, shape, params)."""
    capsys.readouterr()
    out = fn()
    rows = [line for line in capsys.readouterr().out.splitlines()
            if re.match(r"^\S+ \(\w+\)", line)]
    return out, rows


def _both(j_fn, t_fn, capsys):
    ref, j_rows = _run(j_fn, capsys)
    got, t_rows = _run(t_fn, capsys)
    assert got == ref
    assert t_rows == j_rows
    return got


def test_resnet18_summary_and_flops(capsys):
    jp.seed(0)
    jnet = j_resnet18(num_classes=10)
    tnet = t_resnet18(num_classes=10)
    got = _both(lambda: jp.summary(jnet, (1, 3, 32, 32)),
                lambda: tp.summary(tnet, (1, 3, 32, 32)), capsys)
    assert got["total_params"] == got["trainable_params"] > 1e7
    flops = _both(lambda: jp.flops(jnet, [1, 3, 32, 32]),
                  lambda: tp.flops(tnet, [1, 3, 32, 32]), capsys)
    assert flops > 0
    model = tp.Model(tnet)
    assert model.summary((1, 3, 32, 32)) == got


def test_tiny_bert_summary_and_flops(capsys):
    ids = np.random.RandomState(0).randint(0, 64, (2, 8)).astype(np.int64)
    jp.seed(0)
    jnet = jbert.BertModel(jbert.BertConfig(**BERT_TINY))
    tnet = tbert.BertModel(tbert.BertConfig(**BERT_TINY))
    jnet.eval()
    tnet.eval()
    _both(lambda: jp.summary(jnet, input=jp.to_tensor(ids)),
          lambda: tp.summary(tnet, input=tp.to_tensor(ids)), capsys)
    _both(lambda: jp.summary(jnet, (2, 8), dtypes=["int32"]),
          lambda: tp.summary(tnet, (2, 8), dtypes=["int32"]), capsys)
    flops = _both(lambda: jp.flops(jnet, inputs=jp.to_tensor(ids)),
                  lambda: tp.flops(tnet, inputs=tp.to_tensor(ids)), capsys)
    assert flops > 0


def test_custom_ops_and_detail(capsys):
    def count(m, x, y):
        m._flops_ops += 7

    nets = [pkg.nn.Sequential(pkg.nn.Linear(4, 3), pkg.nn.Tanh(),
                              pkg.nn.Linear(3, 2)) for pkg in (jp, tp)]
    got = _both(lambda: jp.flops(nets[0], [2, 4], print_detail=True,
                                 custom_ops={jp.nn.Tanh: count}),
                lambda: tp.flops(nets[1], [2, 4], print_detail=True,
                                 custom_ops={tp.nn.Tanh: count}), capsys)
    assert got == 2 * 3 * 4 + 7 + 2 * 2 * 3
    with pytest.raises(ValueError, match="input_size or inputs"):
        tp.flops(nets[1])
    with pytest.raises(ValueError, match="input_size or input"):
        tp.summary(nets[1])


def test_resnet50_counts_equal_the_card_phase(capsys):
    """ResNet-50's parameter count and FLOPs at 1x3x224x224 in both
    packages, and the constants chip_smoke.py holds the card's to."""
    jp.seed(0)
    jnet = j_resnet50(num_classes=1000)
    tnet = t_resnet50(num_classes=1000)
    got = _both(lambda: jp.summary(jnet, (1, 3, 224, 224)),
                lambda: tp.summary(tnet, (1, 3, 224, 224)), capsys)
    flops = _both(lambda: jp.flops(jnet, [1, 3, 224, 224]),
                  lambda: tp.flops(tnet, [1, 3, 224, 224]), capsys)
    assert got["total_params"] == chip_smoke.RESNET50_PARAMS
    assert flops == chip_smoke.RESNET50_FLOPS_224
