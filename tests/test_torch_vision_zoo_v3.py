"""The port's MobileNetV3-Small and -Large against the JAX package's, on
the same weights and a numpy-seeded batch (B2, 3x64x64, 7 classes,
``scale=0.25``): the state dict's keys and shapes, one train-mode step
(logits, loss, running statistics, every gradient; the squeeze-excite
blocks' hardsigmoid gates and the hardswish activations among them) and
the eval forward (tolerances: ``tests/torch_vision_zoo.py``); their
block tables.
"""
import pytest

import paddle_tpu_torch as tp
from torch_vision_zoo import assert_run, assert_structure, run

MODELS = ["mobilenet_v3_small", "mobilenet_v3_large"]
_RUNS = {}


@pytest.fixture(autouse=True)
def _cpu():
    with tp.device_guard("cpu"):
        yield


def _run(name):
    if name not in _RUNS:
        _RUNS[name] = run(name, 64, num_classes=7, scale=0.25)
    return _RUNS[name]


@pytest.mark.parametrize("name", MODELS)
def test_train_step_and_eval(name):
    assert_run(*_run(name))


@pytest.mark.parametrize("name", MODELS)
def test_state_dict_structure(name):
    j, t, _, _ = _run(name)
    assert_structure(j, t)


@pytest.mark.parametrize("table", ["_V3_LARGE", "_V3_SMALL"])
def test_block_tables(table):
    from paddle_tpu.vision.models import mobilenet as jm
    from paddle_tpu_torch.vision.models import mobilenet as tm
    ours = [row[:4] + (row[4].__name__,) + row[5:]
            for row in getattr(tm, table)]
    theirs = [row[:4] + (row[4].__name__,) + row[5:]
              for row in getattr(jm, table)]
    assert ours == theirs


def test_pretrained_raises():
    with pytest.raises(NotImplementedError):
        tp.vision.models.mobilenet_v3_large(pretrained=True)
