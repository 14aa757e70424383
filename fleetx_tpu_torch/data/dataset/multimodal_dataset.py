"""Imagen datasets: a TSV of base64 images with precomputed T5 features,
and a synthetic stand-in (a copy of
``fleetx_tpu/data/dataset/multimodal_dataset.py:17-124``).

``ImagenDataset`` indexes the TSV's lines by byte offset (cached next to
it as ``.idx.npy``), decodes each ``caption\\tbase64(image)`` row with
Pillow, imported when a row is read (``ImportError`` naming Pillow on a
host without it), resizes bicubic to ``image_size`` and maps to [-1, 1];
the text features are memory-mapped from ``{embeds_prefix}_embeds.npy``
``[N, T, D]`` and ``{embeds_prefix}_mask.npy``. No text encoder runs.
``SyntheticImagenDataset`` draws one ``np.random.RandomState(seed + i)``
per sample, so the same seed gives the JAX package's samples. Samples
are dicts of ``images`` (HWC f32), ``text_embeds``, ``text_mask`` and,
with ``lowres_size``, ``lowres_images``: the batch ``ImagenModule``
reads.
"""

from __future__ import annotations

import base64
import io
import os
from typing import Optional

import numpy as np

from fleetx_tpu_torch.utils.log import logger


def _image_module():
    """``PIL.Image``, or ``ImportError`` naming Pillow."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("decoding Imagen rows needs Pillow (the PIL "
                          "package), which is not installed") from e
    return Image


def _build_line_index(path: str) -> np.ndarray:
    """Byte offset of every line; cached as ``<path>.idx.npy``."""
    cache = path + ".idx.npy"
    if os.path.exists(cache) and \
            os.path.getmtime(cache) >= os.path.getmtime(path):
        return np.load(cache)
    offsets = [0]
    with open(path, "rb") as f:
        for line in f:
            offsets.append(offsets[-1] + len(line))
    idx = np.asarray(offsets[:-1], np.int64)
    try:
        np.save(cache, idx, allow_pickle=False)
    except OSError:
        logger.warning("could not cache line index next to %s", path)
    return idx


class ImagenDataset:
    """TSV rows ``caption\\tbase64(image)`` with T5 features; images NHWC
    in [-1, 1]."""

    def __init__(self, tsv_path: str, *, embeds_prefix: str,
                 image_size: int = 64, lowres_size: Optional[int] = None,
                 channels: int = 3, **_unused):
        self.tsv_path = tsv_path
        self.offsets = _build_line_index(tsv_path)
        self.image_size = int(image_size)
        self.lowres_size = lowres_size
        self.channels = channels
        self.text_embeds = np.load(embeds_prefix + "_embeds.npy",
                                   mmap_mode="r")
        self.text_mask = np.load(embeds_prefix + "_mask.npy", mmap_mode="r")
        if len(self.text_embeds) < len(self.offsets):
            raise ValueError("fewer T5 embedding rows than TSV lines")

    def __len__(self) -> int:
        return len(self.offsets)

    def _decode_image(self, b64: str) -> np.ndarray:
        Image = _image_module()
        img = Image.open(io.BytesIO(base64.b64decode(b64))).convert("RGB")
        img = img.resize((self.image_size, self.image_size), Image.BICUBIC)
        return np.asarray(img, np.float32) / 127.5 - 1.0

    def __getitem__(self, i: int) -> dict:
        with open(self.tsv_path, "rb") as f:
            f.seek(int(self.offsets[i]))
            line = f.readline().decode("utf-8", errors="replace") \
                .rstrip("\n")
        _caption, b64 = line.split("\t", 1)
        image = self._decode_image(b64)
        out = {"images": image,
               "text_embeds": np.asarray(self.text_embeds[i], np.float32),
               "text_mask": np.asarray(self.text_mask[i], np.int32)}
        if self.lowres_size:
            Image = _image_module()
            small = Image.fromarray(
                ((image + 1.0) * 127.5).astype(np.uint8)).resize(
                (self.lowres_size, self.lowres_size), Image.BICUBIC)
            out["lowres_images"] = (np.asarray(small, np.float32) / 127.5
                                    - 1.0)
        return out


class SyntheticImagenDataset:
    """Deterministic random images and text features."""

    def __init__(self, *, num_samples: int = 1024, image_size: int = 64,
                 lowres_size: Optional[int] = None, text_len: int = 16,
                 text_embed_dim: int = 64, channels: int = 3, seed: int = 0,
                 **_unused):
        self.num_samples = int(num_samples)
        self.image_size = int(image_size)
        self.lowres_size = lowres_size
        self.text_len = text_len
        self.text_embed_dim = text_embed_dim
        self.channels = channels
        self.seed = seed

    def __len__(self) -> int:
        return self.num_samples

    def __getitem__(self, i: int) -> dict:
        rng = np.random.RandomState(self.seed + int(i))
        s = self.image_size
        out = {
            "images": rng.uniform(-1, 1, (s, s, self.channels)).astype(
                np.float32),
            "text_embeds": rng.randn(self.text_len,
                                     self.text_embed_dim).astype(np.float32),
            "text_mask": (np.arange(self.text_len) < rng.randint(
                1, self.text_len + 1)).astype(np.int32),
        }
        if self.lowres_size:
            ls = int(self.lowres_size)
            out["lowres_images"] = rng.uniform(
                -1, 1, (ls, ls, self.channels)).astype(np.float32)
        return out
