"""The port's norm and vision functionals against the JAX package's
(``paddle_tpu/nn/functional/norm.py`` and ``vision.py``), and the
dropouts' laws; ``test_torch_nn_functional.py`` holds the activation and
common ones, with the same helpers.

One parametrised case a functional (and more for the modes of
``grid_sample``): the same numpy-seeded
inputs through both packages' Paddle API, the outputs within RTOL/ATOL
and, where the functional is differentiable, the input gradients of
sum(out * w) (w numpy-seeded) norm-wise within GRAD_RTOL
(``torch_nn_parity.check``). The functionals
that draw random numbers (their generators differ) are held to their
deterministic modes against the JAX package and to their laws alone.
"""
import numpy as np
import pytest

import paddle_tpu_torch as tp
from torch_nn_parity import _x, check


@pytest.fixture(autouse=True)
def _cpu():
    with tp.device_guard("cpu"):
        yield


NORM = {
    "group_norm": (lambda p, x, w, b: p.nn.functional.group_norm(
        x, 2, 1e-5, w, b), [_x(30, 2, 4, 3, 3), _x(31, 4), _x(32, 4)]),
    "group_norm_nhwc": (lambda p, x: p.nn.functional.group_norm(
        x, 3, data_format="NHWC"), [_x(33, 2, 3, 2, 6)]),
    "instance_norm": (lambda p, x, w, b: p.nn.functional.instance_norm(
        x, weight=w, bias=b), [_x(34, 2, 3, 4, 5), _x(35, 3), _x(36, 3)]),
    "normalize": (lambda p, x: p.nn.functional.normalize(x, axis=1),
                  [_x(37, 3, 5)]),
    "normalize_p1": (lambda p, x: p.nn.functional.normalize(x, p=1, axis=-1),
                     [_x(38, 3, 5)]),
    "normalize_inf": (lambda p, x: p.nn.functional.normalize(
        x, p=np.inf, axis=0), [_x(39, 3, 5)]),
    "local_response_norm": (lambda p, x: p.nn.functional.local_response_norm(
        x, 3, 1e-2, 0.75, 2.0), [_x(40, 2, 5, 3, 3)]),
    "local_response_norm_even": (
        lambda p, x: p.nn.functional.local_response_norm(x, 4),
        [_x(41, 2, 6, 4)]),
}


@pytest.mark.parametrize("name", sorted(NORM))
def test_norm(name):
    fn, arrays = NORM[name]
    check(fn, *arrays)


def _theta(seed, n, rows):
    t = np.zeros((n, rows, rows + 1), np.float32)
    t[:, :, :rows] = np.eye(rows)
    return t + 0.2 * _x(seed, n, rows, rows + 1)


@pytest.mark.parametrize("align", [True, False])
def test_affine_grid(align):
    check(lambda p, t: p.nn.functional.affine_grid(t, [2, 3, 4, 5], align),
          _theta(50, 2, 2))


def test_affine_grid_3d():
    check(lambda p, t: p.nn.functional.affine_grid(t, [1, 2, 3, 4, 2],
                                                   False), _theta(51, 1, 3))


GRID = [(m, pm, a) for m in ("bilinear", "nearest")
        for pm in ("zeros", "border", "reflection") for a in (True, False)]


@pytest.mark.parametrize("mode,padding,align", GRID)
def test_grid_sample(mode, padding, align):
    grid = np.random.RandomState(52).uniform(-1.3, 1.3, (2, 4, 3, 2)).astype(
        np.float32)
    check(lambda p, x, g: p.nn.functional.grid_sample(x, g, mode, padding,
                                                      align),
          _x(53, 2, 3, 5, 6), grid, diff=[True, mode == "bilinear"])


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_temporal_shift(fmt):
    shape = (6, 8, 2, 3) if fmt == "NCHW" else (6, 2, 3, 8)
    check(lambda p, x: p.nn.functional.temporal_shift(x, 3, 0.25, fmt),
          _x(54, *shape))


def test_dropouts_drop_whole_channels():
    x = tp.to_tensor(np.ones((4, 16, 3, 3), np.float32))
    y = tp.nn.functional.dropout2d(x, 0.5).numpy()
    per_map = y.reshape(4, 16, -1)
    assert ((per_map == 0).all(-1) | (per_map == 2).all(-1)).all()
    assert 0 < (per_map == 0).all(-1).mean() < 1
    a = tp.nn.functional.alpha_dropout(tp.to_tensor(_x(55, 20000)), 0.2)
    assert abs(a.numpy().mean()) < 0.05 and abs(a.numpy().std() - 1) < 0.05
