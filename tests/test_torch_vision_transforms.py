"""The port's ``vision.transforms`` and image backend against the JAX
package's: every functional and every transform class on the same
numpy-seeded images (uint8 HWC, float32 HWC, gray, and PIL), the random
ones under one ``random.seed`` on each side so that they draw the same
crops, flips, angles and factors. Outputs must be equal: bitwise for
uint8 and PIL images, within 1e-6 for float arrays and Tensors (the same
numpy or PIL code runs on both sides; ``to_tensor``/``Normalize`` on a
Tensor run in jnp there and torch here).
"""
import random

import numpy as np
import pytest
from PIL import Image

import paddle_tpu as jp
import paddle_tpu.vision.transforms as JT
from paddle_tpu.core.tensor import Tensor as JTensor
import paddle_tpu_torch as tp
import paddle_tpu_torch.vision.transforms as TT
from paddle_tpu_torch.core.tensor import Tensor

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True)
def _cpu():
    with tp.device_guard("cpu"):
        yield


def _u8(h=20, w=26, c=3, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (h, w, c),
                                               dtype=np.uint8)


def _f32(h=20, w=26, c=3, seed=1):
    return np.random.RandomState(seed).rand(h, w, c).astype(np.float32)


IMAGES = {
    "u8": lambda: _u8(),
    "f32": lambda: _f32(),
    "gray": lambda: _u8(c=1),
    "pil": lambda: Image.fromarray(_u8()),
}


def _np(out):
    if isinstance(out, (Tensor, JTensor)):
        return np.asarray(out.numpy())
    return np.asarray(out)


def _assert_equal(j, t):
    assert type(j).__name__ == type(t).__name__ or (
        isinstance(j, JTensor) and isinstance(t, Tensor))
    a, b = _np(j), _np(t)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape,
                                                        a.dtype, b.dtype)
    if np.issubdtype(a.dtype, np.floating):
        np.testing.assert_allclose(b, a, **TOL)
    else:
        np.testing.assert_array_equal(b, a)


def _both(fn, img_key, seed=0, draws=1):
    """fn(module, image) on each package, ``draws`` times each under
    ``random.seed(seed)``."""
    outs = []
    for mod in (JT, TT):
        random.seed(seed)
        outs.append([fn(mod, IMAGES[img_key]()) for _ in range(draws)])
    for j, t in zip(*outs):
        _assert_equal(j, t)


FUNCTIONALS = {
    "to_tensor": (lambda M, x: M.to_tensor(x), ("u8", "f32", "pil")),
    "to_tensor_hwc": (lambda M, x: M.to_tensor(x, data_format="HWC"),
                      ("u8",)),
    "resize_int": (lambda M, x: M.resize(x, 12), ("u8", "f32", "pil")),
    "resize_pair": (lambda M, x: M.resize(x, (9, 31), "nearest"),
                    ("u8", "pil")),
    "resize_bicubic": (lambda M, x: M.resize(x, (16, 10), "bicubic"),
                       ("u8", "f32")),
    "crop": (lambda M, x: M.crop(x, 2, 3, 10, 12), ("u8", "pil")),
    "center_crop": (lambda M, x: M.center_crop(x, 11), ("u8", "f32", "pil")),
    "hflip": (lambda M, x: M.hflip(x), ("u8", "pil")),
    "vflip": (lambda M, x: M.vflip(x), ("u8", "pil")),
    "normalize_hwc": (lambda M, x: M.normalize(
        x, [0.5, 0.4, 0.3], [0.2, 0.3, 0.4], data_format="HWC"), ("f32",)),
    "normalize_chw": (lambda M, x: M.normalize(
        np.asarray(x).transpose(2, 0, 1), [0.5, 0.4, 0.3], [0.2, 0.3, 0.4]),
        ("f32",)),
    "pad_constant": (lambda M, x: M.pad(x, 3, fill=7), ("u8", "pil")),
    "pad_pair_edge": (lambda M, x: M.pad(x, (2, 1), padding_mode="edge"),
                      ("u8", "f32")),
    "pad_reflect": (lambda M, x: M.pad(x, (1, 2, 3, 4),
                                       padding_mode="reflect"), ("u8",)),
    "pad_symmetric": (lambda M, x: M.pad(x, 2, padding_mode="symmetric"),
                      ("gray",)),
    "rotate": (lambda M, x: M.rotate(x, 30), ("u8", "f32", "pil")),
    "rotate_expand": (lambda M, x: M.rotate(x, -45, "bilinear", expand=True,
                                            fill=5), ("u8",)),
    "to_grayscale": (lambda M, x: M.to_grayscale(x), ("u8", "pil")),
    "to_grayscale_3": (lambda M, x: M.to_grayscale(x, 3), ("u8",)),
    "adjust_brightness": (lambda M, x: M.adjust_brightness(x, 1.3),
                          ("u8", "f32", "pil")),
    "adjust_contrast": (lambda M, x: M.adjust_contrast(x, 0.6),
                        ("u8", "f32", "pil")),
    "adjust_hue": (lambda M, x: M.adjust_hue(x, 0.2), ("u8", "pil")),
    "erase": (lambda M, x: M.erase(x, 2, 3, 5, 6, 9), ("u8", "f32")),
}
FUNCTIONAL_CASES = [(n, k) for n, (_, keys) in sorted(FUNCTIONALS.items())
                    for k in keys]


@pytest.mark.parametrize("name,img", FUNCTIONAL_CASES)
def test_functional(name, img):
    _both(FUNCTIONALS[name][0], img)


def test_erase_and_normalize_on_tensors():
    x = _f32().transpose(2, 0, 1)
    j = JT.erase(jp.to_tensor(x), 1, 2, 4, 5, 0.5)
    t = TT.erase(tp.to_tensor(x), 1, 2, 4, 5, 0.5)
    _assert_equal(j, t)
    norm = dict(mean=[0.5, 0.4, 0.3], std=[0.2, 0.3, 0.4])
    _assert_equal(JT.Normalize(**norm)(jp.to_tensor(x)),
                  TT.Normalize(**norm)(tp.to_tensor(x)))


TRANSFORMS = {
    "Compose": (lambda M: M.Compose([M.RandomCrop(12), M.RandomHorizontalFlip(),
                                     M.ToTensor()]), ("u8", "pil")),
    "ToTensor": (lambda M: M.ToTensor(), ("u8", "f32")),
    "Resize": (lambda M: M.Resize((10, 14)), ("u8", "f32", "pil")),
    "RandomResizedCrop": (lambda M: M.RandomResizedCrop(10),
                          ("u8", "f32", "pil")),
    "RandomResizedCrop_narrow": (lambda M: M.RandomResizedCrop(
        (8, 12), scale=(0.9, 1.0), ratio=(3.0, 4.0)), ("u8",)),
    "CenterCrop": (lambda M: M.CenterCrop((8, 10)), ("u8", "pil")),
    "RandomCrop": (lambda M: M.RandomCrop(12), ("u8", "f32", "pil")),
    "RandomCrop_pad": (lambda M: M.RandomCrop(24, padding=2,
                                              pad_if_needed=True),
                       ("u8",)),
    "RandomHorizontalFlip": (lambda M: M.RandomHorizontalFlip(),
                             ("u8", "pil")),
    "RandomVerticalFlip": (lambda M: M.RandomVerticalFlip(0.7),
                           ("u8", "pil")),
    "Normalize": (lambda M: M.Normalize(mean=[123.675, 116.28, 103.53],
                                        std=[58.395, 57.12, 57.375],
                                        data_format="HWC"), ("u8",)),
    "Transpose": (lambda M: M.Transpose(), ("u8", "f32")),
    "Pad": (lambda M: M.Pad(2, fill=3), ("u8", "pil")),
    "RandomRotation": (lambda M: M.RandomRotation(40), ("u8", "f32", "pil")),
    "Grayscale": (lambda M: M.Grayscale(3), ("u8", "pil")),
    "ColorJitter": (lambda M: M.ColorJitter(0.4, 0.4, 0.4, 0.1),
                    ("u8", "pil")),
    "BrightnessTransform": (lambda M: M.BrightnessTransform(0.5),
                            ("u8", "f32")),
    "ContrastTransform": (lambda M: M.ContrastTransform(0.5),
                          ("u8", "f32")),
    "SaturationTransform": (lambda M: M.SaturationTransform(0.5),
                            ("u8", "pil")),
    "HueTransform": (lambda M: M.HueTransform(0.3), ("u8", "pil")),
    "RandomErasing": (lambda M: M.RandomErasing(prob=0.8, value=7),
                      ("u8", "f32")),
}
TRANSFORM_CASES = [(n, k) for n, (_, keys) in sorted(TRANSFORMS.items())
                   for k in keys]


@pytest.mark.parametrize("name,img", TRANSFORM_CASES)
def test_transform(name, img):
    """Eight draws in a row under one seed: the same sequence of crops,
    flips, angles and factors."""
    make = TRANSFORMS[name][0]
    outs = []
    for M in (JT, TT):
        tr = make(M)
        random.seed(3)
        outs.append([tr(IMAGES[img]()) for _ in range(8)])
    for j, t in zip(*outs):
        _assert_equal(j, t)


def test_random_erasing_on_tensors():
    x = _f32().transpose(2, 0, 1)
    outs = []
    for pkg, M in ((jp, JT), (tp, TT)):
        random.seed(5)
        tr = M.RandomErasing(prob=1.0, value=0.25)
        outs.append([tr(pkg.to_tensor(x)) for _ in range(4)])
    for j, t in zip(*outs):
        _assert_equal(j, t)


def test_every_public_name_is_ported():
    assert TT.__all__ == JT.__all__
    for name in TT.__all__:
        assert callable(getattr(TT, name)), name


def test_image_backend(tmp_path):
    import paddle_tpu.vision as JV
    import paddle_tpu_torch.vision as TV
    path = str(tmp_path / "img.png")
    Image.fromarray(_u8()).save(path)
    for V in (JV, TV):
        assert V.get_image_backend() == "pil"
        with pytest.raises(ValueError):
            V.set_image_backend("opencv")
    np.testing.assert_array_equal(np.asarray(TV.image_load(path)),
                                  np.asarray(JV.image_load(path)))
    _assert_equal(JV.image_load(path, backend="tensor"),
                  TV.image_load(path, backend="tensor"))
    try:
        TV.set_image_backend("tensor")
        assert TV.get_image_backend() == "tensor"
        assert isinstance(TV.image_load(path), Tensor)
    finally:
        TV.set_image_backend("pil")
