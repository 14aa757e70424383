"""Image preprocessing ops and config-declared chains (a copy of
``fleetx_tpu/data/transforms/preprocess.py:26-231``).

Every op is a callable ``sample -> sample`` over HWC uint8 / float numpy
arrays; the random ones draw from Python's ``random`` module in the JAX
package's order, so a seeded ``random`` gives the same images. The ops
that decode or resize (``DecodeImage``, ``ResizeImage``, and
``RandCropImage``'s resize) need Pillow and import it when they run; on a
host without it they raise ``ImportError`` naming it. The others are
numpy. ``build_transforms`` composes ``[{OpName: {kwargs}}]``.
"""

from __future__ import annotations

import ast
import io
import operator
import random
from typing import Any, Sequence

import numpy as np

from fleetx_tpu_torch.utils.log import logger


def _image_module():
    """``PIL.Image``, or ``ImportError`` naming Pillow."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("this image op needs Pillow (the PIL package), "
                          "which is not installed") from e
    return Image


_ARITH = {ast.Add: operator.add, ast.Sub: operator.sub,
          ast.Mult: operator.mul, ast.Div: operator.truediv}


def _number(text: str) -> float:
    """A YAML number given as arithmetic (``"1.0/255.0"``): numbers and
    ``+ - * /`` only."""

    def value(node):
        if isinstance(node, ast.Constant) and \
                isinstance(node.value, (int, float)):
            return node.value
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
            return -value(node.operand)
        if isinstance(node, ast.BinOp) and type(node.op) in _ARITH:
            return _ARITH[type(node.op)](value(node.left), value(node.right))
        raise ValueError(f"not an arithmetic number: {text!r}")

    return float(value(ast.parse(text, mode="eval").body))


class DecodeImage:
    """bytes / path → HWC uint8 RGB."""

    def __init__(self, to_rgb: bool = True, channel_first: bool = False):
        self.to_rgb = to_rgb
        self.channel_first = channel_first

    def __call__(self, img):
        if isinstance(img, (bytes, bytearray)):
            img = _image_module().open(io.BytesIO(img))
        elif isinstance(img, str):
            img = _image_module().open(img)
        if not isinstance(img, np.ndarray):  # a PIL image
            if self.to_rgb:
                img = img.convert("RGB")
            img = np.asarray(img)
        if self.channel_first:
            img = img.transpose(2, 0, 1)
        return img


class ResizeImage:
    """Resize the shorter side to ``resize_short``, or to a fixed
    ``size``."""

    def __init__(self, size=None, resize_short=None,
                 interpolation="bilinear"):
        assert size is not None or resize_short is not None
        self.size = size
        self.resize_short = resize_short
        self.interpolation = interpolation

    def __call__(self, img: np.ndarray) -> np.ndarray:
        Image = _image_module()
        h, w = img.shape[:2]
        if self.resize_short:
            scale = self.resize_short / min(h, w)
            out = (round(w * scale), round(h * scale))
        else:
            s = self.size
            out = (s, s) if isinstance(s, int) else (s[1], s[0])
        resample = getattr(Image, self.interpolation.upper(), Image.BILINEAR)
        return np.asarray(Image.fromarray(img).resize(out, resample))


class CenterCropImage:
    """Center crop to ``size``."""

    def __init__(self, size: int):
        self.size = size

    def __call__(self, img: np.ndarray) -> np.ndarray:
        h, w = img.shape[:2]
        s = self.size
        top, left = max((h - s) // 2, 0), max((w - s) // 2, 0)
        return img[top:top + s, left:left + s]


class RandCropImage:
    """Random resized crop: up to 10 tries at an area in ``scale`` and an
    aspect in ``ratio``, else the whole image, resized to ``size``."""

    def __init__(self, size: int, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)):
        self.size = size
        self.scale = scale
        self.ratio = ratio

    def __call__(self, img: np.ndarray) -> np.ndarray:
        h, w = img.shape[:2]
        area = h * w
        for _ in range(10):
            target = random.uniform(*self.scale) * area
            aspect = random.uniform(*self.ratio)
            cw = int(round((target * aspect) ** 0.5))
            ch = int(round((target / aspect) ** 0.5))
            if cw <= w and ch <= h:
                top = random.randint(0, h - ch)
                left = random.randint(0, w - cw)
                img = img[top:top + ch, left:left + cw]
                break
        Image = _image_module()
        return np.asarray(Image.fromarray(img).resize(
            (self.size, self.size), Image.BILINEAR))


class RandFlipImage:
    """Horizontal flip with probability ``prob``."""

    def __init__(self, flip_code: int = 1, prob: float = 0.5):
        self.prob = prob

    def __call__(self, img: np.ndarray) -> np.ndarray:
        if random.random() < self.prob:
            return img[:, ::-1]
        return img


class NormalizeImage:
    """``(img * scale - mean) / std`` in f32, optionally to CHW and
    f16."""

    def __init__(self, scale=1.0 / 255.0, mean=(0.485, 0.456, 0.406),
                 std=(0.229, 0.224, 0.225), order="hwc",
                 output_fp16: bool = False):
        self.scale = _number(scale) if isinstance(scale, str) \
            else float(scale)
        self.mean = np.asarray(mean, np.float32).reshape(1, 1, 3)
        self.std = np.asarray(std, np.float32).reshape(1, 1, 3)
        self.order = order
        self.dtype = np.float16 if output_fp16 else np.float32

    def __call__(self, img: np.ndarray) -> np.ndarray:
        x = (img.astype(np.float32) * self.scale - self.mean) / self.std
        if self.order == "chw":
            x = x.transpose(2, 0, 1)
        return x.astype(self.dtype)


class RandomErasing:
    """With probability ``prob``, fill a random rectangle with
    ``value``."""

    def __init__(self, prob: float = 0.25, scale=(0.02, 0.33),
                 ratio=(0.3, 3.3), value: float = 0.0):
        self.prob = prob
        self.scale = scale
        self.ratio = ratio
        self.value = value

    def __call__(self, img: np.ndarray) -> np.ndarray:
        if random.random() >= self.prob:
            return img
        h, w = img.shape[:2]
        area = h * w
        for _ in range(10):
            target = random.uniform(*self.scale) * area
            aspect = random.uniform(*self.ratio)
            eh = int(round((target / aspect) ** 0.5))
            ew = int(round((target * aspect) ** 0.5))
            if eh < h and ew < w:
                top = random.randint(0, h - eh)
                left = random.randint(0, w - ew)
                img = img.copy()
                img[top:top + eh, left:left + ew] = self.value
                return img
        return img


class ToCHWImage:
    """The identity: every model here takes NHWC images, so the reference
    op's CHW transpose is declared a no-op (as in the JAX package)."""

    def __call__(self, img: np.ndarray) -> np.ndarray:
        return img


class ColorJitter:
    """Random brightness / contrast / saturation jitter, clipped to
    ``[0, 255]``; hue jitter is not supported (a warning)."""

    def __init__(self, brightness: float = 0.4, contrast: float = 0.4,
                 saturation: float = 0.4, hue: float = 0.0):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        if hue:
            logger.warning("ColorJitter hue=%s is not supported (needs HSV "
                           "round-trips); continuing without hue jitter", hue)

    def __call__(self, img: np.ndarray) -> np.ndarray:
        x = img.astype(np.float32)
        if self.brightness:
            x = x * random.uniform(1 - self.brightness, 1 + self.brightness)
        if self.contrast:
            f = random.uniform(1 - self.contrast, 1 + self.contrast)
            x = (x - x.mean()) * f + x.mean()
        if self.saturation:
            f = random.uniform(1 - self.saturation, 1 + self.saturation)
            grey = x.mean(axis=-1, keepdims=True)
            x = (x - grey) * f + grey
        return np.clip(x, 0, 255).astype(img.dtype)


OPS = {cls.__name__: cls for cls in
       (DecodeImage, ResizeImage, CenterCropImage, RandCropImage,
        RandFlipImage, NormalizeImage, RandomErasing, ToCHWImage,
        ColorJitter)}


def build_transforms(ops_cfg: Sequence[dict]):
    """``[{OpName: {kwargs}}]`` (or bare op names) → one callable applying
    them in order. ``ColorJitter`` after ``NormalizeImage`` is refused:
    its clip to ``[0, 255]`` would zero every below-mean value."""
    ops, names = [], []
    for item in ops_cfg or []:
        if isinstance(item, str):
            name, kwargs = item, {}
        else:
            (name, kwargs), = item.items()
        names.append(name)
        ops.append(OPS[name](**(kwargs or {})))
    if "ColorJitter" in names and "NormalizeImage" in names and \
            max(i for i, n in enumerate(names) if n == "ColorJitter") > \
            min(i for i, n in enumerate(names) if n == "NormalizeImage"):
        raise ValueError("ColorJitter must come before NormalizeImage in "
                         "transform_ops")

    def apply(x: Any) -> Any:
        for op in ops:
            x = op(x)
        return x

    return apply
