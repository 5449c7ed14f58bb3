"""``paddle.vision.transforms`` of the port (counterpart of
``paddle_tpu/vision/transforms.py``): the 20 transform classes and 14
functionals.

Transforms run on the host, in numpy or PIL, inside the loader's
workers. They take PIL images or numpy HWC arrays, as the JAX module's
do, and give the same pixels: the code is the JAX module's, and the
random ones draw from Python's ``random`` in its order, so one
``random.seed`` gives both packages the same crops and flips. Pillow is
imported only where the JAX module imports it (resize, rotate,
grayscale, hue and saturation); without it those raise ``ImportError``.
``to_tensor`` gives a port ``Tensor``. Neither package's ``DataLoader``
reseeds ``random`` in a forked worker, so forked workers repeat each
other's draws, as in the JAX package.
"""
from __future__ import annotations

import numbers
import random

import numpy as np
import torch

__all__ = [
    "Compose", "BaseTransform", "ToTensor", "Resize", "RandomResizedCrop",
    "CenterCrop", "RandomCrop", "RandomHorizontalFlip",
    "RandomVerticalFlip", "Normalize", "Transpose", "Pad", "RandomRotation",
    "Grayscale", "ColorJitter", "BrightnessTransform", "ContrastTransform",
    "SaturationTransform", "HueTransform", "RandomErasing",
    # functional
    "to_tensor", "resize", "crop", "center_crop", "hflip", "vflip",
    "normalize", "pad", "rotate", "to_grayscale", "adjust_brightness",
    "adjust_contrast", "adjust_hue", "erase",
]


def _is_pil(img):
    try:
        from PIL import Image
        return isinstance(img, Image.Image)
    except ImportError:  # pragma: no cover
        return False


def _to_pil(img):
    from PIL import Image
    if _is_pil(img):
        return img
    arr = np.asarray(img)
    if arr.ndim == 3 and arr.shape[2] == 1:
        arr = arr[:, :, 0]  # PIL has no (H, W, 1) mode; use mode L
    if arr.dtype != np.uint8:
        # normalized float input: scale to the uint8 range instead of
        # truncating everything in [0, 1] to {0, 1}
        if np.issubdtype(arr.dtype, np.floating) and arr.size \
                and float(arr.max()) <= 1.0 and float(arr.min()) >= 0.0:
            arr = arr * 255.0
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    return Image.fromarray(arr)


def _resample_float(arr, op):
    """Apply a PIL geometric op to a float HWC array channel-wise via
    32-bit 'F' mode images (lossless for float inputs)."""
    from PIL import Image
    chans = [np.asarray(op(Image.fromarray(arr[:, :, c].astype(np.float32),
                                           mode="F")))
             for c in range(arr.shape[2])]
    return np.stack(chans, axis=-1).astype(arr.dtype)


def _to_np(img):
    """HWC uint8/float numpy view of a PIL image or array."""
    if _is_pil(img):
        arr = np.asarray(img)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        return arr
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


# ------------------------------ functional ------------------------------
def to_tensor(pic, data_format="CHW"):
    """PIL or HWC array -> a float32 Tensor (uint8 scaled to [0, 1]), CHW
    unless ``data_format="HWC"``. On the current device; on the CPU inside
    a loader worker (a forked process must not touch the card), where the
    loader's collate stacks it."""
    from ..core.tensor import Tensor, as_tensor
    from ..io.dataloader import get_worker_info
    raw = _to_np(pic)
    arr = raw.astype(np.float32)
    if raw.dtype == np.uint8:
        arr = arr / 255.0
    if data_format == "CHW":
        arr = arr.transpose(2, 0, 1)
    arr = np.ascontiguousarray(arr)
    if get_worker_info() is not None:
        return Tensor(torch.from_numpy(arr))
    return as_tensor(arr)


def resize(img, size, interpolation="bilinear"):
    from PIL import Image
    modes = {"nearest": Image.NEAREST, "bilinear": Image.BILINEAR,
             "bicubic": Image.BICUBIC, "lanczos": Image.LANCZOS}
    if _is_pil(img):
        w0, h0 = img.size  # free attribute — no pixel decode
        arr0 = None
    else:
        arr0 = _to_np(img)
        h0, w0 = arr0.shape[:2]
    if isinstance(size, int):
        if w0 < h0:
            ow, oh = size, int(size * h0 / w0)
        else:
            ow, oh = int(size * w0 / h0), size
    else:
        oh, ow = size
    if arr0 is not None and np.issubdtype(arr0.dtype, np.floating):
        return _resample_float(
            arr0, lambda im: im.resize((ow, oh), modes[interpolation]))
    out = _to_pil(img).resize((ow, oh), modes[interpolation])
    return out if _is_pil(img) else _to_np(out)


def crop(img, top, left, height, width):
    if _is_pil(img):
        return img.crop((left, top, left + width, top + height))
    return _to_np(img)[top:top + height, left:left + width]


def center_crop(img, output_size):
    if isinstance(output_size, numbers.Number):
        output_size = (int(output_size), int(output_size))
    arr = _to_np(img)
    h, w = arr.shape[:2]
    th, tw = output_size
    top = int(round((h - th) / 2.0))
    left = int(round((w - tw) / 2.0))
    return crop(img, top, left, th, tw)


def hflip(img):
    if _is_pil(img):
        from PIL import Image
        return img.transpose(Image.FLIP_LEFT_RIGHT)
    return _to_np(img)[:, ::-1]


def vflip(img):
    if _is_pil(img):
        from PIL import Image
        return img.transpose(Image.FLIP_TOP_BOTTOM)
    return _to_np(img)[::-1]


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    arr = np.asarray(img, dtype=np.float32)
    mean = np.asarray(mean, dtype=np.float32)
    std = np.asarray(std, dtype=np.float32)
    if data_format == "CHW":
        mean = mean.reshape(-1, 1, 1)
        std = std.reshape(-1, 1, 1)
    return (arr - mean) / std


def pad(img, padding, fill=0, padding_mode="constant"):
    arr = _to_np(img)
    if isinstance(padding, numbers.Number):
        padding = (padding,) * 4  # left, top, right, bottom
    elif len(padding) == 2:
        padding = (padding[0], padding[1], padding[0], padding[1])
    l, t, r, b = padding
    mode = {"constant": "constant", "edge": "edge", "reflect": "reflect",
            "symmetric": "symmetric"}[padding_mode]
    kwargs = {"constant_values": fill} if mode == "constant" else {}
    out = np.pad(arr, ((t, b), (l, r), (0, 0)), mode=mode, **kwargs)
    return _to_pil(out) if _is_pil(img) else out


def rotate(img, angle, interpolation="nearest", expand=False, center=None,
           fill=0):
    from PIL import Image
    modes = {"nearest": Image.NEAREST, "bilinear": Image.BILINEAR,
             "bicubic": Image.BICUBIC}
    arr0 = None if _is_pil(img) else _to_np(img)
    if arr0 is not None and np.issubdtype(arr0.dtype, np.floating):
        def chan_fill(c):
            if isinstance(fill, (tuple, list)):
                return float(fill[c] if c < len(fill) else fill[-1])
            return float(fill)
        from PIL import Image
        chans = [np.asarray(Image.fromarray(
            arr0[:, :, c].astype(np.float32), mode="F").rotate(
                angle, resample=modes[interpolation], expand=expand,
                center=center, fillcolor=chan_fill(c)))
            for c in range(arr0.shape[2])]
        return np.stack(chans, axis=-1).astype(arr0.dtype)
    out = _to_pil(img).rotate(angle, resample=modes[interpolation],
                              expand=expand, center=center, fillcolor=fill)
    return out if _is_pil(img) else _to_np(out)


def to_grayscale(img, num_output_channels=1):
    pil = _to_pil(img).convert("L")
    if num_output_channels == 3:
        arr = np.asarray(pil)
        out = np.stack([arr] * 3, axis=-1)
        return _to_pil(out) if _is_pil(img) else out
    return pil if _is_pil(img) else _to_np(pil)


def adjust_brightness(img, factor):
    raw = _to_np(img)
    arr = raw.astype(np.float32) * factor
    if raw.dtype == np.uint8:
        out = np.clip(arr, 0, 255).astype(np.uint8)
    else:
        out = arr.astype(raw.dtype)  # float pipeline: dtype-preserving
    return _to_pil(out) if _is_pil(img) else out


def adjust_contrast(img, factor):
    raw = _to_np(img)
    arr = raw.astype(np.float32)
    mean = arr.mean()
    out = (arr - mean) * factor + mean
    if raw.dtype == np.uint8:
        out = np.clip(out, 0, 255).astype(np.uint8)
    else:
        out = out.astype(raw.dtype)
    return _to_pil(out) if _is_pil(img) else out


def adjust_hue(img, factor):
    if not _is_pil(img) and np.issubdtype(np.asarray(img).dtype,
                                          np.floating):
        raise TypeError(
            "adjust_hue requires a uint8/PIL image (HSV path); apply it "
            "before ToTensor/Normalize in the pipeline")
    pil = _to_pil(img).convert("HSV")
    h, s, v = pil.split()
    h_arr = np.asarray(h, dtype=np.int16)
    h_arr = ((h_arr + int(factor * 255)) % 256).astype(np.uint8)
    from PIL import Image
    out = Image.merge("HSV", (Image.fromarray(h_arr), s, v)).convert("RGB")
    return out if _is_pil(img) else _to_np(out)


def erase(img, i, j, h, w, v, inplace=False):
    from ..core.tensor import Tensor
    if isinstance(img, Tensor):
        arr = img._data.clone()
        arr[..., i:i + h, j:j + w] = torch.as_tensor(v, dtype=arr.dtype)
        return Tensor(arr)
    arr = _to_np(img).copy()
    arr[i:i + h, j:j + w] = v
    return arr


# ------------------------------- classes --------------------------------
class BaseTransform:
    """A transform: ``__call__`` applies ``_apply_image``."""

    def __call__(self, img):
        return self._apply_image(img)

    def _apply_image(self, img):  # pragma: no cover - abstract
        raise NotImplementedError


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, img):
        for t in self.transforms:
            img = t(img)
        return img


class ToTensor(BaseTransform):
    def __init__(self, data_format="CHW", keys=None):
        self.data_format = data_format

    def _apply_image(self, img):
        return to_tensor(img, self.data_format)


class Resize(BaseTransform):
    def __init__(self, size, interpolation="bilinear", keys=None):
        self.size = size
        self.interpolation = interpolation

    def _apply_image(self, img):
        return resize(img, self.size, self.interpolation)


class CenterCrop(BaseTransform):
    def __init__(self, size, keys=None):
        self.size = size

    def _apply_image(self, img):
        return center_crop(img, self.size)


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=None, pad_if_needed=False, fill=0,
                 padding_mode="constant", keys=None):
        if isinstance(size, numbers.Number):
            size = (int(size), int(size))
        self.size = size
        self.padding = padding
        self.pad_if_needed = pad_if_needed
        self.fill = fill
        self.padding_mode = padding_mode

    def _apply_image(self, img):
        if self.padding is not None:
            img = pad(img, self.padding, self.fill, self.padding_mode)
        arr = _to_np(img)
        h, w = arr.shape[:2]
        th, tw = self.size
        if self.pad_if_needed and (h < th or w < tw):
            img = pad(img, (max(tw - w, 0), max(th - h, 0)), self.fill,
                      self.padding_mode)
            arr = _to_np(img)
            h, w = arr.shape[:2]
        top = random.randint(0, h - th)
        left = random.randint(0, w - tw)
        return crop(img, top, left, th, tw)


class RandomResizedCrop(BaseTransform):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation="bilinear", keys=None):
        if isinstance(size, numbers.Number):
            size = (int(size), int(size))
        self.size = size
        self.scale = scale
        self.ratio = ratio
        self.interpolation = interpolation

    def _apply_image(self, img):
        arr = _to_np(img)
        h, w = arr.shape[:2]
        area = h * w
        for _ in range(10):
            target = random.uniform(*self.scale) * area
            ar = np.exp(random.uniform(np.log(self.ratio[0]),
                                       np.log(self.ratio[1])))
            cw = int(round(np.sqrt(target * ar)))
            ch = int(round(np.sqrt(target / ar)))
            if 0 < cw <= w and 0 < ch <= h:
                top = random.randint(0, h - ch)
                left = random.randint(0, w - cw)
                return resize(crop(img, top, left, ch, cw), self.size,
                              self.interpolation)
        return resize(center_crop(img, min(h, w)), self.size,
                      self.interpolation)


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        self.prob = prob

    def _apply_image(self, img):
        return hflip(img) if random.random() < self.prob else img


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        self.prob = prob

    def _apply_image(self, img):
        return vflip(img) if random.random() < self.prob else img


class Normalize(BaseTransform):
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False,
                 keys=None):
        if isinstance(mean, numbers.Number):
            mean = [mean] * 3
        if isinstance(std, numbers.Number):
            std = [std] * 3
        self.mean, self.std = mean, std
        self.data_format = data_format

    def _apply_image(self, img):
        from ..core.tensor import Tensor
        if isinstance(img, Tensor):
            a = img._data
            m = torch.as_tensor(self.mean, dtype=a.dtype, device=a.device)
            s = torch.as_tensor(self.std, dtype=a.dtype, device=a.device)
            if self.data_format == "CHW":
                m = m.reshape(-1, 1, 1)
                s = s.reshape(-1, 1, 1)
            return Tensor((a - m) / s)
        return normalize(img, self.mean, self.std, self.data_format)


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1), keys=None):
        self.order = order

    def _apply_image(self, img):
        return _to_np(img).transpose(self.order)


class Pad(BaseTransform):
    def __init__(self, padding, fill=0, padding_mode="constant", keys=None):
        self.padding, self.fill, self.mode = padding, fill, padding_mode

    def _apply_image(self, img):
        return pad(img, self.padding, self.fill, self.mode)


class RandomRotation(BaseTransform):
    def __init__(self, degrees, interpolation="nearest", expand=False,
                 center=None, fill=0, keys=None):
        if isinstance(degrees, numbers.Number):
            degrees = (-degrees, degrees)
        self.degrees = degrees
        self.interpolation = interpolation
        self.expand = expand
        self.center = center
        self.fill = fill

    def _apply_image(self, img):
        angle = random.uniform(*self.degrees)
        return rotate(img, angle, self.interpolation, self.expand,
                      self.center, self.fill)


class Grayscale(BaseTransform):
    def __init__(self, num_output_channels=1, keys=None):
        self.num_output_channels = num_output_channels

    def _apply_image(self, img):
        return to_grayscale(img, self.num_output_channels)


class BrightnessTransform(BaseTransform):
    def __init__(self, value, keys=None):
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return img
        factor = random.uniform(max(0, 1 - self.value), 1 + self.value)
        return adjust_brightness(img, factor)


class ContrastTransform(BaseTransform):
    def __init__(self, value, keys=None):
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return img
        factor = random.uniform(max(0, 1 - self.value), 1 + self.value)
        return adjust_contrast(img, factor)


class SaturationTransform(BaseTransform):
    def __init__(self, value, keys=None):
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return img
        if not _is_pil(img) and np.issubdtype(np.asarray(img).dtype,
                                              np.floating):
            raise TypeError(
                "SaturationTransform requires a uint8/PIL image; apply it "
                "before ToTensor/Normalize in the pipeline")
        from PIL import ImageEnhance
        factor = random.uniform(max(0, 1 - self.value), 1 + self.value)
        out = ImageEnhance.Color(_to_pil(img)).enhance(factor)
        return out if _is_pil(img) else _to_np(out)


class HueTransform(BaseTransform):
    def __init__(self, value, keys=None):
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return img
        factor = random.uniform(-self.value, self.value)
        return adjust_hue(img, factor)


class ColorJitter(BaseTransform):
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0,
                 keys=None):
        self.transforms = [BrightnessTransform(brightness),
                           ContrastTransform(contrast),
                           SaturationTransform(saturation),
                           HueTransform(hue)]

    def _apply_image(self, img):
        order = list(range(4))
        random.shuffle(order)
        for i in order:
            img = self.transforms[i](img)
        return img


class RandomErasing(BaseTransform):
    def __init__(self, prob=0.5, scale=(0.02, 0.33), ratio=(0.3, 3.3),
                 value=0, inplace=False, keys=None):
        self.prob, self.scale, self.ratio, self.value = (prob, scale, ratio,
                                                         value)

    def _apply_image(self, img):
        if random.random() >= self.prob:
            return img
        from ..core.tensor import Tensor
        if isinstance(img, Tensor):
            h, w = img.shape[-2], img.shape[-1]
        else:
            arr = _to_np(img)
            h, w = arr.shape[:2]
        area = h * w
        for _ in range(10):
            target = random.uniform(*self.scale) * area
            ar = random.uniform(*self.ratio)
            eh = int(round(np.sqrt(target / ar)))
            ew = int(round(np.sqrt(target * ar)))
            if eh < h and ew < w:
                top = random.randint(0, h - eh)
                left = random.randint(0, w - ew)
                return erase(img, top, left, eh, ew, self.value)
        return img
