"""The port's MobileNet v1 and v2 against the JAX package's, on the same
weights and a numpy-seeded batch (B2, 3x64x64, 7 classes,
``scale=0.25``): the state dict's keys and shapes, one train-mode step
(logits, loss, running statistics, every gradient) and the eval forward
(tolerances: ``tests/torch_vision_zoo.py``). Also MobileNetV2 at the
published width (scale 1.0, 1000 classes, the chip's main path): the
same parameters as the JAX package's; and ``_make_divisible``, which
sets every width of every scale. v3 is in
``test_torch_vision_zoo_v3.py``.
"""
import pytest

import paddle_tpu_torch as tp
from torch_vision_zoo import assert_run, assert_structure, pair, run

MODELS = ["mobilenet_v1", "mobilenet_v2"]
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


def test_published_width_structure():
    j, t = pair("mobilenet_v2")
    assert_structure(j, t)


def test_make_divisible():
    from paddle_tpu.vision.models.mobilenet import _make_divisible as jmd
    from paddle_tpu_torch.vision.models.mobilenet import _make_divisible
    for v in (3, 8, 12, 16 * 0.25, 32 * 0.75, 1280 * 1.4, 960 * 0.35, 91):
        for d in (4, 8, 16):
            assert _make_divisible(v, d) == jmd(v, d)


def test_pretrained_raises():
    with pytest.raises(NotImplementedError):
        tp.vision.models.mobilenet_v2(pretrained=True)
