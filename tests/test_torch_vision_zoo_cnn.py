"""The port's VGG, AlexNet and SqueezeNet against the JAX package's, on
the same weights and a numpy-seeded batch (B2, 7 classes): VGG-11 with
batch norm as a feature extractor at 32x32 (its classifier's first
layer alone has 102M weights), AlexNet and SqueezeNet 1.1 at 64x64.
Held: the state dict's keys and shapes, one train-mode step (outputs,
loss, running statistics, every gradient) and the eval forward
(tolerances: ``tests/torch_vision_zoo.py``); the VGG layer tables, every
VGG depth's structure with and without batch norm, and SqueezeNet 1.0's
(the same fire modules in another order).
"""
import pytest

import paddle_tpu_torch as tp
from torch_vision_zoo import assert_run, assert_structure, pair, run

CASES = {
    "vgg11_bn": ("vgg11", 32, dict(num_classes=0, batch_norm=True)),
    "alexnet": ("alexnet", 64, dict(num_classes=7)),
    "squeezenet1_1": ("squeezenet1_1", 64, dict(num_classes=7)),
}
_RUNS = {}


@pytest.fixture(autouse=True)
def _cpu():
    with tp.device_guard("cpu"):
        yield


def _run(case):
    if case not in _RUNS:
        name, size, kw = CASES[case]
        _RUNS[case] = run(name, size, **kw)
    return _RUNS[case]


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_step_and_eval(case):
    assert_run(*_run(case))


@pytest.mark.parametrize("case", sorted(CASES))
def test_state_dict_structure(case):
    j, t, _, _ = _run(case)
    assert_structure(j, t)


def test_vgg_tables():
    from paddle_tpu.vision.models import vgg as jvgg
    from paddle_tpu_torch.vision.models import vgg
    assert vgg._CFGS == jvgg._CFGS


@pytest.mark.parametrize("depth", [11, 13, 16, 19])
@pytest.mark.parametrize("bn", [False, True])
def test_vgg_depths_structure(depth, bn):
    j, t = pair(f"vgg{depth}", num_classes=0, batch_norm=bn)
    assert_structure(j, t)


def test_squeezenet1_0_structure():
    j, t = pair("squeezenet1_0", num_classes=7)
    assert_structure(j, t)


def test_vgg_classifier_structure():
    j, t = pair("vgg11", num_classes=7)
    assert_structure(j, t)


@pytest.mark.parametrize("ctor", ["vgg16", "alexnet", "squeezenet1_1"])
def test_pretrained_raises(ctor):
    with pytest.raises(NotImplementedError):
        getattr(tp.vision.models, ctor)(pretrained=True)
