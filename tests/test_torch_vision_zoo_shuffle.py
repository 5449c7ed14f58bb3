"""The port's ShuffleNetV2 against the JAX package's, on the same
weights and a numpy-seeded batch (B2, 3x64x64, 7 classes): x0_25's
state dict keys and shapes, one train-mode step (logits, loss, running
statistics, every gradient) and the eval forward (tolerances:
``tests/torch_vision_zoo.py``); every other width's and the swish
variant's structure, and the width table. ``channel_shuffle`` and
``Swish`` themselves are held in ``test_torch_vision_layers.py``.
GoogLeNet is in ``test_torch_vision_zoo_googlenet.py``.
"""
import pytest

import paddle_tpu_torch as tp
from torch_vision_zoo import assert_run, assert_structure, pair, run

MODELS = ["shufflenet_v2_x0_25"]
_RUNS = {}


@pytest.fixture(autouse=True)
def _cpu():
    with tp.device_guard("cpu"):
        yield


def _run(name):
    if name not in _RUNS:
        _RUNS[name] = run(name, 64, num_classes=7)
    return _RUNS[name]


@pytest.mark.parametrize("name", MODELS)
def test_train_step_and_eval(name):
    assert_run(*_run(name))


@pytest.mark.parametrize("name", MODELS)
def test_state_dict_structure(name):
    j, t, _, _ = _run(name)
    assert_structure(j, t)


@pytest.mark.parametrize("width", ["x0_33", "x0_5", "x1_0", "x1_5",
                                   "x2_0", "swish"])
def test_shufflenet_widths_structure(width):
    j, t = pair(f"shufflenet_v2_{width}", num_classes=7)
    assert_structure(j, t)


def test_shufflenet_table():
    from paddle_tpu.vision.models import small_nets as jsn
    from paddle_tpu_torch.vision.models import small_nets
    assert small_nets._SHUFFLE_CFG == jsn._SHUFFLE_CFG


@pytest.mark.parametrize("ctor", ["shufflenet_v2_x1_0",
                                  "shufflenet_v2_swish"])
def test_pretrained_raises(ctor):
    with pytest.raises(NotImplementedError):
        getattr(tp.vision.models, ctor)(pretrained=True)
