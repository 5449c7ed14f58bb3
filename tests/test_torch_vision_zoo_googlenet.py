"""The port's GoogLeNet against the JAX package's, on the same weights
and a numpy-seeded batch (B8, 3x64x64, 7 classes), with its two
auxiliary heads (returned in train and eval mode, as the JAX model
returns them; the loss adds 0.3 x each). Held: the state dict's keys and
shapes, one train-mode step (every head's logits, the loss, running
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
        _RUN["googlenet"] = run("googlenet", 64, n=8, num_classes=7)
    return _RUN["googlenet"]


def test_train_step_and_eval():
    assert_run(*_run(), DEEP_TOLS)


def test_state_dict_structure():
    j, t, _, _ = _run()
    assert_structure(j, t)


def test_three_heads():
    _, _, _, (train, _, ev, _, _) = _run()
    assert len(train) == 3 and len(ev) == 3


def test_pretrained_raises():
    with pytest.raises(NotImplementedError):
        tp.vision.models.googlenet(pretrained=True)
