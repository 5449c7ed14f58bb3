"""The port's convolution and pooling functionals against the JAX
package's, on the same numpy-seeded fp32 inputs: outputs to 1e-5, and
the gradients of every input (held as a Layer's parameters) through
``assert_grads`` to 1e-5 norm-wise.

Each family is one parametrised test. The cases cover Paddle's padding
forms (int, per-dim, per-dim pairs, a flat asymmetric list, 'SAME',
'VALID'), strides, dilation, groups, channel-last layouts, and the
windows where torch's pooling rules differ from XLA's: ``ceil_mode``
windows that start in the padding, ``exclusive`` over the ceil
overflow, ``divisor_override``, ``return_mask`` on tied values and
adaptive pools with uneven bins.
"""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from torch_paddle_api import assert_grads, assert_same

TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    with tp.device_guard("cpu"):
        yield


def rand(*shape, seed=0):
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(
        np.float32)


def _fn_layer(pkg, arrays):
    """A Layer whose parameters are the inputs ``arrays``."""
    layer = pkg.nn.Layer()
    for i, a in enumerate(arrays):
        p = pkg.create_parameter(list(a.shape), "float32")
        p.set_value(a)
        layer.add_parameter(f"in{i}", p)
    return layer


def check(fn, *arrays, grad=True, tol=TOL):
    """``fn(package, *inputs)`` on both packages: outputs to ``tol``;
    with ``grad``, d sum(out * c)/d input for a seeded c, every input."""
    outs, layers = [], []
    for pkg in (jp, tp):
        layer = _fn_layer(pkg, arrays)
        out = fn(pkg, *layer.parameters())
        outs.append(out)
        layers.append(layer)
        if grad:
            o = out[0] if isinstance(out, (list, tuple)) else out
            cot = pkg.to_tensor(rand(*o.shape, seed=7))
            (o * cot).sum().backward()
    assert_same(outs[0], outs[1], rtol=tol, atol=tol)
    if grad:
        assert_grads(layers[0], layers[1], rtol=tol)


# --------------------------------------------------------------- convolutions
CONV_CASES = {
    # name: (functional, x shape, w shape, bias, kwargs)
    "2d_int": ("conv2d", (2, 4, 9, 9), (6, 4, 3, 3), True,
               dict(padding=1)),
    "2d_per_dim": ("conv2d", (2, 4, 9, 8), (6, 4, 3, 3), False,
                   dict(padding=[1, 2], stride=2)),
    "2d_pairs": ("conv2d", (2, 4, 9, 8), (6, 4, 3, 2), True,
                 dict(padding=[[1, 0], [2, 1]])),
    "2d_flat_asym": ("conv2d", (2, 4, 9, 8), (6, 4, 3, 3), True,
                     dict(padding=[1, 0, 2, 1], stride=2)),
    "2d_same_s1": ("conv2d", (2, 4, 9, 8), (6, 4, 3, 3), True,
                   dict(padding="SAME")),
    "2d_same_s2": ("conv2d", (2, 4, 9, 8), (6, 4, 4, 3), True,
                   dict(padding="SAME", stride=2)),
    "2d_same_dilated": ("conv2d", (2, 4, 10, 9), (6, 4, 3, 3), False,
                        dict(padding="same", stride=2, dilation=2)),
    "2d_valid": ("conv2d", (2, 4, 9, 8), (6, 4, 3, 3), True,
                 dict(padding="VALID", stride=2)),
    "2d_dilation": ("conv2d", (2, 4, 11, 9), (6, 4, 3, 3), True,
                    dict(padding=2, dilation=2)),
    "2d_groups": ("conv2d", (2, 4, 9, 8), (6, 2, 3, 3), True,
                  dict(padding=1, groups=2, stride=2)),
    "2d_nhwc": ("conv2d", (2, 9, 8, 4), (6, 4, 3, 3), True,
                dict(padding=[1, 0, 0, 1], data_format="NHWC")),
    "1d": ("conv1d", (2, 3, 12), (5, 3, 4), True,
           dict(padding=[2, 1], stride=2)),
    "1d_nlc_same": ("conv1d", (2, 12, 3), (5, 3, 3), True,
                    dict(padding="SAME", stride=3, data_format="NLC")),
    "3d": ("conv3d", (1, 2, 5, 6, 5), (4, 2, 3, 3, 2), True,
           dict(padding=1, stride=2)),
    "3d_same_groups": ("conv3d", (1, 4, 5, 6, 5), (4, 2, 3, 3, 3), False,
                       dict(padding="SAME", groups=2)),
    "2d_t": ("conv2d_transpose", (2, 4, 5, 6), (4, 3, 3, 3), True,
             dict(stride=2, padding=1, output_padding=1)),
    "2d_t_asym": ("conv2d_transpose", (2, 4, 5, 6), (4, 3, 3, 3), True,
                  dict(stride=2, padding=[1, 0, 2, 1])),
    "2d_t_same": ("conv2d_transpose", (2, 4, 5, 6), (4, 3, 4, 3), True,
                  dict(stride=2, padding="SAME")),
    "2d_t_output_size": ("conv2d_transpose", (2, 4, 5, 6), (4, 3, 3, 3),
                         True, dict(stride=2, padding=1,
                                    output_size=[10, 12])),
    "2d_t_op_past_pad": ("conv2d_transpose", (2, 4, 5, 6), (4, 3, 3, 3),
                         False, dict(stride=3, padding=0,
                                     output_padding=2)),
    "2d_t_groups_dilation": ("conv2d_transpose", (2, 4, 5, 6), (4, 2, 3, 3),
                             True, dict(stride=2, padding=1, groups=2,
                                        dilation=2)),
    "2d_t_nhwc": ("conv2d_transpose", (2, 5, 6, 4), (4, 3, 3, 3), True,
                  dict(stride=2, padding=1, data_format="NHWC")),
    "1d_t": ("conv1d_transpose", (2, 3, 7), (3, 5, 4), True,
             dict(stride=3, padding=[1, 2])),
    "3d_t": ("conv3d_transpose", (1, 2, 3, 4, 3), (2, 3, 3, 3, 2), True,
             dict(stride=2, padding=1, output_padding=1)),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv(case):
    fname, xs, ws, bias, kw = CONV_CASES[case]
    arrays = [rand(*xs), rand(*ws, seed=1)]
    if bias:
        out_ch = ws[1] * kw.get("groups", 1) if "_t" in case else ws[0]
        arrays.append(rand(out_ch, seed=2))

    def fn(pkg, x, w, *b):
        return getattr(pkg.nn.functional, fname)(
            x, w, b[0] if b else None, **kw)
    check(fn, *arrays)


def test_conv_layers_init_and_state():
    """Conv2D's parameters: shapes, the uniform(+-1/sqrt(fan_in)) bound,
    no bias with ``bias_attr=False``, and the JAX layer's output on its
    weights."""
    j = jp.nn.Conv2D(4, 6, 3, stride=2, padding=1, groups=2)
    t = tp.nn.Conv2D(4, 6, 3, stride=2, padding=1, groups=2)
    assert [list(p.shape) for p in t.parameters()] == \
        [list(p.shape) for p in j.parameters()] == [[6, 2, 3, 3], [6]]
    bound = 1 / np.sqrt(2 * 9)
    assert np.abs(t.weight.numpy()).max() <= bound
    assert np.abs(t.weight.numpy()).max() > 0.5 * bound
    nb = tp.nn.Conv2D(4, 6, 3, bias_attr=False)
    assert nb.bias is None and list(nb.state_dict()) == ["weight"]
    tp.models.load_jax_layer_state(
        t, {k: np.asarray(v.numpy()) for k, v in j.state_dict().items()})
    x = rand(2, 4, 7, 7)
    assert_same(j(jp.to_tensor(x)), t(tp.to_tensor(x)), TOL, TOL)


# -------------------------------------------------------------------- pools
def _ties(*shape, seed=3):
    """Integer-valued floats with many ties inside a window."""
    return np.random.RandomState(seed).randint(0, 3, shape).astype(
        np.float32)


POOL_CASES = {
    # name: (callable on (F, x), x, grad)
    "max2d_k3s2p1": (lambda F, x: F.max_pool2d(x, 3, 2, 1),
                     rand(2, 3, 9, 8), True),
    "max2d_ceil": (lambda F, x: F.max_pool2d(x, 2, 2, 0, ceil_mode=True),
                   rand(2, 3, 7, 5), True),
    "max2d_ceil_window_in_padding": (
        lambda F, x: F.max_pool2d(x, 3, 3, 1, ceil_mode=True),
        rand(2, 3, 5, 8), True),
    "max2d_asym_pad": (lambda F, x: F.max_pool2d(x, 3, 2, [1, 0, 0, 2]),
                       rand(2, 3, 8, 7), True),
    "max2d_same": (lambda F, x: F.max_pool2d(x, 3, 2, "SAME"),
                   rand(2, 3, 8, 7), True),
    "max2d_nhwc": (lambda F, x: F.max_pool2d(x, 2, 2, 1, ceil_mode=True,
                                             data_format="NHWC"),
                   rand(2, 7, 5, 3), True),
    "max1d": (lambda F, x: F.max_pool1d(x, 3, 2, 1, ceil_mode=True),
              rand(2, 3, 10), True),
    "max3d": (lambda F, x: F.max_pool3d(x, 2, 2, 0, ceil_mode=True),
              rand(1, 2, 5, 4, 5), True),
    "avg2d_exclusive": (lambda F, x: F.avg_pool2d(x, 3, 2, 1),
                        rand(2, 3, 9, 8), True),
    "avg2d_inclusive": (lambda F, x: F.avg_pool2d(x, 3, 2, 1,
                                                  exclusive=False),
                        rand(2, 3, 9, 8), True),
    "avg2d_ceil_exclusive": (lambda F, x: F.avg_pool2d(
        x, 2, 2, 0, ceil_mode=True), rand(2, 3, 7, 5), True),
    "avg2d_ceil_inclusive": (lambda F, x: F.avg_pool2d(
        x, 3, 2, 1, ceil_mode=True, exclusive=False), rand(2, 3, 8, 6),
        True),
    "avg2d_ceil_window_in_padding": (lambda F, x: F.avg_pool2d(
        x, 3, 3, 1, ceil_mode=True, exclusive=False), rand(2, 3, 5, 8),
        True),
    "avg2d_divisor_override": (lambda F, x: F.avg_pool2d(
        x, 3, 2, 1, divisor_override=4), rand(2, 3, 9, 8), True),
    "avg2d_same_nhwc": (lambda F, x: F.avg_pool2d(
        x, 3, 2, "SAME", data_format="NHWC"), rand(2, 8, 7, 3), True),
    "avg1d": (lambda F, x: F.avg_pool1d(x, 3, 2, 1, exclusive=False,
                                        ceil_mode=True),
              rand(2, 3, 10), True),
    "avg3d": (lambda F, x: F.avg_pool3d(x, 3, 2, 1), rand(1, 2, 5, 6, 5),
              True),
    # ties: the first maximum in row-major order, in both packages here
    "max2d_mask_ties": (lambda F, x: F.max_pool2d(x, 3, 2, 1,
                                                  return_mask=True),
                        _ties(2, 3, 9, 8), False),
    "max2d_mask_ties_unpadded": (lambda F, x: F.max_pool2d(
        x, 2, 2, 0, return_mask=True), _ties(2, 3, 8, 6), False),
    "max1d_mask_ties": (lambda F, x: F.max_pool1d(x, 2, 2, 0,
                                                  return_mask=True),
                        _ties(2, 3, 9), False),
    # padded 2-wide windows: XLA's order among ties is not row-major
    # there (test_max_mask_tie_order), so these inputs have no ties
    "max2d_mask_ceil": (lambda F, x: F.max_pool2d(x, 2, 2, 0,
                                                  return_mask=True,
                                                  ceil_mode=True),
                        rand(2, 3, 7, 5), False),
    "max2d_mask_nhwc": (lambda F, x: F.max_pool2d(x, 2, 2, 1,
                                                  return_mask=True,
                                                  data_format="NHWC"),
                        rand(2, 6, 5, 3), False),
    "max3d_mask": (lambda F, x: F.max_pool3d(x, 2, 2, 1, return_mask=True),
                   rand(1, 2, 4, 5, 4), False),
    "adaptive_avg2d_uneven": (lambda F, x: F.adaptive_avg_pool2d(x, [3, 4]),
                              rand(2, 3, 7, 9), True),
    "adaptive_avg2d_even": (lambda F, x: F.adaptive_avg_pool2d(
        x, [2, 5]), rand(2, 3, 8, 5), True),
    "adaptive_avg2d_nhwc": (lambda F, x: F.adaptive_avg_pool2d(
        x, 3, data_format="NHWC"), rand(2, 7, 5, 3), True),
    "adaptive_avg1d": (lambda F, x: F.adaptive_avg_pool1d(x, 4),
                       rand(2, 3, 10), True),
    "adaptive_avg3d": (lambda F, x: F.adaptive_avg_pool3d(x, [2, 3, 2]),
                       rand(1, 2, 5, 7, 4), True),
    "adaptive_max2d_uneven": (lambda F, x: F.adaptive_max_pool2d(x, [3, 4]),
                              rand(2, 3, 7, 9), True),
    "adaptive_max1d": (lambda F, x: F.adaptive_max_pool1d(x, 3),
                       rand(2, 3, 10), True),
    "adaptive_max3d": (lambda F, x: F.adaptive_max_pool3d(x, 2),
                       rand(1, 2, 5, 4, 5), True),
    "lp2d_p2": (lambda F, x: F.lp_pool2d(x, 2, 3, 2, 1, ceil_mode=True),
                rand(2, 3, 8, 7), True),
    "lp2d_pinf": (lambda F, x: F.lp_pool2d(x, float("inf"), 2, 2),
                  rand(2, 3, 8, 7), True),
    "lp1d_p3": (lambda F, x: F.lp_pool1d(x, 3, 3, 2), rand(2, 3, 10), True),
    "fractional2d": (lambda F, x: F.fractional_max_pool2d(
        x, [4, 3], random_u=0.37, return_mask=True), rand(2, 3, 9, 8),
        False),
    "fractional2d_kernel": (lambda F, x: F.fractional_max_pool2d(
        x, 3, kernel_size=2, random_u=0.61), rand(2, 3, 8, 7), True),
    "fractional3d": (lambda F, x: F.fractional_max_pool3d(
        x, 2, random_u=0.5, return_mask=True), rand(1, 2, 5, 6, 5), False),
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pool(case):
    fn, x, grad = POOL_CASES[case]
    check(lambda pkg, a: fn(pkg.nn.functional, a), x, grad=grad)


def test_max_mask_tie_order():
    """Among tied maxima the port's mask takes the first in row-major
    order (torch's rule). The JAX package's choice follows XLA's lowering
    of the window: row-major for this unpadded window, but a padded 2x2
    window takes the earliest column first, so the packages part there
    on ties only (ROADMAP, Queue 3)."""
    x = np.zeros((1, 1, 2, 3), np.float32)
    x[0, 0, 0, 1] = x[0, 0, 1, 0] = 1.0
    for pkg in (jp, tp):
        _, mask = pkg.nn.functional.max_pool2d(pkg.to_tensor(x), 2, 2,
                                               return_mask=True)
        assert mask.numpy().ravel().tolist() == [1]
    tied = np.array([[0, 2], [2, 0]], np.float32)[None, None]
    _, mask = tp.nn.functional.max_pool2d(tp.to_tensor(tied), 2, 2,
                                          return_mask=True)
    assert mask.numpy().ravel().tolist() == [1]


def test_adaptive_max_mask_is_none():
    for pkg in (jp, tp):
        out, mask = pkg.nn.functional.adaptive_max_pool2d(
            pkg.to_tensor(rand(1, 2, 6, 6)), 3, return_mask=True)
        assert mask is None and out.shape == [1, 2, 3, 3]


@pytest.mark.parametrize("nd", [1, 2, 3])
def test_max_unpool(nd):
    """Pool with the mask, then scatter back, in each package; the
    gradient reaches the pooled input through both."""
    shape = {1: (2, 3, 8), 2: (2, 3, 6, 8), 3: (1, 2, 4, 6, 4)}[nd]

    def fn(pkg, x):
        F = pkg.nn.functional
        out, mask = getattr(F, f"max_pool{nd}d")(x, 2, 2, return_mask=True)
        return getattr(F, f"max_unpool{nd}d")(out, mask, 2, 2)
    check(fn, rand(*shape))


@pytest.mark.parametrize("layer,args,x_shape", [
    ("MaxPool2D", (3, 2, 1), (2, 3, 9, 8)),
    ("AvgPool2D", (3, 2, 1, True, False), (2, 3, 9, 8)),
    ("AvgPool1D", (3, 2, 1, False, True), (2, 3, 10)),
    ("AvgPool3D", (2, 2, 0, True), (1, 2, 5, 4, 5)),
    ("MaxPool1D", (2,), (2, 3, 9)),
    ("MaxPool3D", (2, 2, 1), (1, 2, 4, 5, 4)),
    ("AdaptiveAvgPool2D", ((1, 1),), (2, 3, 7, 5)),
    ("AdaptiveAvgPool1D", (3,), (2, 3, 7)),
    ("AdaptiveAvgPool3D", (2,), (1, 2, 5, 4, 5)),
    ("AdaptiveMaxPool2D", (3,), (2, 3, 7, 5)),
    ("AdaptiveMaxPool1D", (3,), (2, 3, 7)),
    ("AdaptiveMaxPool3D", (2,), (1, 2, 5, 4, 5)),
])
def test_pool_layers(layer, args, x_shape):
    x = rand(*x_shape)
    assert_same(getattr(jp.nn, layer)(*args)(jp.to_tensor(x)),
                getattr(tp.nn, layer)(*args)(tp.to_tensor(x)), TOL, TOL)


def test_torch_level_entries_match_paddle_entries():
    """The same functions on torch.Tensors (the torch-level path) give
    the Paddle entries' values."""
    import torch
    x, w = rand(2, 4, 9, 8), rand(6, 4, 3, 3, seed=1)
    F = tp.nn.functional
    conv_p = F.conv2d(tp.to_tensor(x), tp.to_tensor(w), padding="SAME",
                      stride=2)
    conv_t = F.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                      padding="SAME", stride=2)
    np.testing.assert_array_equal(conv_p.numpy(), conv_t.numpy())
    pool_p = F.avg_pool2d(tp.to_tensor(x), 2, 2, ceil_mode=True,
                          exclusive=False)
    pool_t = F.avg_pool2d(torch.from_numpy(x), 2, 2, ceil_mode=True,
                          exclusive=False)
    np.testing.assert_array_equal(pool_p.numpy(), pool_t.numpy())
