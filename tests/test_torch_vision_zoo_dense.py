"""The port's DenseNet-121 against the JAX package's, on the same
weights and a numpy-seeded batch (B8, 3x64x64, 7 classes). Held: the
state dict's keys and shapes, one train-mode step (logits, loss, running
statistics, every gradient) and the eval forward (tolerances:
``tests/torch_vision_zoo.py``, DEEP_TOLS); the depth table, which is
all that differs between densenet121 and densenet264.
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
        _RUN["densenet121"] = run("densenet121", 64, n=8, num_classes=7)
    return _RUN["densenet121"]


def test_train_step_and_eval():
    assert_run(*_run(), DEEP_TOLS)


def test_state_dict_structure():
    j, t, _, _ = _run()
    assert_structure(j, t)


def test_densenet_table():
    from paddle_tpu.vision.models import densenet as jdn
    from paddle_tpu_torch.vision.models import densenet
    assert densenet._CFGS == jdn._CFGS


@pytest.mark.parametrize("ctor", ["densenet121", "densenet264"])
def test_pretrained_raises(ctor):
    with pytest.raises(NotImplementedError):
        getattr(tp.vision.models, ctor)(pretrained=True)
