"""The port's InceptionV3 against the JAX package's, on the same weights
and a numpy-seeded batch (B8, 3x107x107, 7 classes: at 75x75, the
smallest input its stride-2 reductions take, its last blocks normalize
two values a channel and neither package is near float64). Held: the
state dict's keys and shapes, one train-mode step (logits, loss, running
statistics, every gradient) and the eval forward (tolerances:
``tests/torch_vision_zoo.py``, DEEP_TOLS).
"""
import pytest

import paddle_tpu_torch as tp
from torch_vision_zoo import DEEP_TOLS, assert_run, assert_structure, run

_RUN = {}


@pytest.fixture(autouse=True)
def _cpu():
    with tp.device_guard("cpu"):
        yield


def _run():
    if not _RUN:
        _RUN["inception_v3"] = run("inception_v3", 107, n=8, num_classes=7)
    return _RUN["inception_v3"]


def test_train_step_and_eval():
    assert_run(*_run(), DEEP_TOLS)


def test_state_dict_structure():
    j, t, _, _ = _run()
    assert_structure(j, t)


def test_pretrained_raises():
    with pytest.raises(NotImplementedError):
        tp.vision.models.inception_v3(pretrained=True)
