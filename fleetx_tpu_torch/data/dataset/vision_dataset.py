"""Vision datasets: list-file image folders, CIFAR-10, synthetic images
(a copy of ``fleetx_tpu/data/dataset/vision_dataset.py:17-130``).

Each sample is ``{"images": HWC f32, "labels": int32}``, the batch
``GeneralClsModule`` reads. ``SyntheticVisionDataset`` draws one
``np.random.RandomState(seed + i)`` per sample, so the same seed gives
the JAX package's images.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from fleetx_tpu_torch.data.transforms.preprocess import build_transforms

DEFAULT_TRANSFORM_OPS = [{"DecodeImage": {}},
                         {"ResizeImage": {"size": 224}},
                         {"NormalizeImage": {}}]


class GeneralClsDataset:
    """ImageNet-style list file of ``path label`` lines under
    ``image_root``."""

    def __init__(self, image_root: str, cls_label_path: str,
                 transform_ops=None, delimiter: str = " "):
        self.root = image_root
        self.transform = build_transforms(transform_ops
                                          or DEFAULT_TRANSFORM_OPS)
        self.samples: list = []
        with open(cls_label_path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                path, label = line.rsplit(delimiter, 1)
                self.samples.append((path, int(label)))

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, i: int) -> dict:
        path, label = self.samples[i]
        img = self.transform(os.path.join(self.root, path))
        return {"images": np.asarray(img, np.float32),
                "labels": np.int32(label)}


IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif",
                  ".tiff", ".webp")


class ImageFolder:
    """``root/<class>/**/<image>`` tree: the classes are the sorted
    first-level directory names, the images are found recursively."""

    def __init__(self, root: str, transform_ops=None):
        self.root = root
        self.transform = build_transforms(transform_ops
                                          or DEFAULT_TRANSFORM_OPS)
        self.classes = sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d)))
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}
        self.samples: list = []
        for cls in self.classes:
            for dirpath, _, files in sorted(os.walk(os.path.join(root, cls))):
                for name in sorted(files):
                    if name.lower().endswith(IMG_EXTENSIONS):
                        self.samples.append(
                            (os.path.join(dirpath, name),
                             self.class_to_idx[cls]))

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, i: int) -> dict:
        path, label = self.samples[i]
        return {"images": np.asarray(self.transform(path), np.float32),
                "labels": np.int32(label)}


class CIFAR10:
    """CIFAR-10 from the standard local python-pickle batches (nothing is
    downloaded)."""

    def __init__(self, data_dir: str, mode: str = "train",
                 transform_ops=None):
        files = ([f"data_batch_{i}" for i in range(1, 6)] if mode == "train"
                 else ["test_batch"])
        xs, ys = [], []
        for name in files:
            with open(os.path.join(data_dir, name), "rb") as f:
                d = pickle.load(f, encoding="bytes")
            xs.append(d[b"data"])
            ys.extend(d[b"labels"])
        self.images = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(
            0, 2, 3, 1)
        self.labels = np.asarray(ys, np.int32)
        self.transform = build_transforms(transform_ops) if transform_ops \
            else None

    def __len__(self) -> int:
        return len(self.labels)

    def __getitem__(self, i: int) -> dict:
        img = self.images[i]
        if self.transform is not None:
            img = self.transform(img)
        else:
            img = img.astype(np.float32) / 255.0
        return {"images": np.asarray(img, np.float32),
                "labels": self.labels[i]}


class SyntheticVisionDataset:
    """Random normal images and uniform labels (no data files)."""

    def __init__(self, *, num_samples: int, image_size: int = 224,
                 num_classes: int = 1000, seed: int = 0, **_unused):
        self.num_samples = int(num_samples)
        self.image_size = int(image_size)
        self.num_classes = int(num_classes)
        self.seed = int(seed)

    def __len__(self) -> int:
        return self.num_samples

    def __getitem__(self, i: int) -> dict:
        rng = np.random.RandomState(self.seed + int(i))
        img = rng.randn(self.image_size, self.image_size, 3).astype(
            np.float32)
        return {"images": img,
                "labels": np.int32(rng.randint(0, self.num_classes))}
