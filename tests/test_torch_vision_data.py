"""Port parity: the vision data path (``fleetx_tpu_torch/data/dataset/
vision_dataset.py``, ``data/transforms/preprocess.py``,
``data/sampler/collate.py`` and the registry's vision entries) against
the JAX package's copies.

Everything here is numpy (and Pillow where an op decodes or resizes), so
the same inputs must give the same arrays bit for bit, dtypes included:
the random ops draw from Python's ``random`` module, seeded before each
side runs. Images are small PNGs written with Pillow in ``tmp_path`` and
CIFAR-10-format pickles written the same way; nothing is downloaded.
"""

import pickle
import random
import sys

import numpy as np
import pytest
from PIL import Image

from fleetx_tpu.data import build_dataset as j_build_dataset
from fleetx_tpu.data.dataset import vision_dataset as JV
from fleetx_tpu.data.sampler import collate as JC
from fleetx_tpu.data.transforms import preprocess as JP
from fleetx_tpu_torch.data import build_dataset as t_build_dataset
from fleetx_tpu_torch.data.dataset import vision_dataset as TV
from fleetx_tpu_torch.data.sampler import collate as TC
from fleetx_tpu_torch.data.transforms import preprocess as TP

pytestmark = pytest.mark.torch_port

#: the ViT-B/16 recipe's train and eval chains (shrunk to 32 pixels), and
#: the reference recipe's chain with ColorJitter and ToCHWImage
CHAINS = {
    "train": [{"DecodeImage": {}}, {"RandCropImage": {"size": 32}},
              {"RandFlipImage": {}}, {"NormalizeImage": {}}],
    "eval": [{"DecodeImage": {}}, {"ResizeImage": {"resize_short": 40}},
             {"CenterCropImage": {"size": 32}}, {"NormalizeImage": {}}],
    "jitter": [{"DecodeImage": {}}, {"ResizeImage": {"resize_short": 40}},
               {"RandCropImage": {"size": 32}}, {"ColorJitter": {}},
               {"RandomErasing": {"prob": 1.0}},
               {"NormalizeImage": {"scale": "1.0/255.0", "order": "chw"}},
               {"ToCHWImage": None}],
}


def _same(got, want, what: str = "") -> None:
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, what
    np.testing.assert_array_equal(got, want, err_msg=what)


def _png_tree(root, n_classes: int = 3, per_class: int = 2) -> list:
    """``root/<class>/[sub/]img<i>.png`` seeded RGB / grey PNGs of ragged
    sizes; returns ``(relative path, label)``."""
    rng = np.random.RandomState(0)
    out = []
    for c in range(n_classes):
        for i in range(per_class):
            sub = root / f"class{c}" / ("sub" if i % 2 else "")
            sub.mkdir(parents=True, exist_ok=True)
            h, w = rng.randint(36, 60, 2)
            mode = "L" if (c + i) % 3 == 2 else "RGB"
            shape = (h, w) if mode == "L" else (h, w, 3)
            img = Image.fromarray(rng.randint(0, 256, shape).astype(np.uint8),
                                  mode)
            path = sub / f"img{i}.png"
            img.save(path)
            out.append((str(path.relative_to(root)), c))
    return out


@pytest.fixture
def image(tmp_path):
    """A 50 x 60 seeded RGB image, as an array, a PNG path and bytes."""
    arr = (np.random.RandomState(1).rand(50, 60, 3) * 255).astype(np.uint8)
    path = tmp_path / "one.png"
    Image.fromarray(arr).save(path)
    return arr, str(path), path.read_bytes()


OP_CASES = [
    ("DecodeImage", {}, "path"), ("DecodeImage", {}, "bytes"),
    ("DecodeImage", {"channel_first": True}, "path"),
    ("ResizeImage", {"size": 24}, "array"),
    ("ResizeImage", {"size": [20, 30], "interpolation": "nearest"}, "array"),
    ("ResizeImage", {"resize_short": 40}, "array"),
    ("CenterCropImage", {"size": 32}, "array"),
    ("RandCropImage", {"size": 32}, "array"),
    ("RandCropImage", {"size": 16, "scale": (2.0, 3.0)}, "array"),
    ("RandFlipImage", {}, "array"),
    ("NormalizeImage", {}, "array"),
    ("NormalizeImage", {"scale": "1.0/255.0", "order": "chw",
                        "output_fp16": True}, "array"),
    ("RandomErasing", {"prob": 1.0}, "array"),
    ("RandomErasing", {}, "array"),
    ("ToCHWImage", {}, "array"),
    ("ColorJitter", {"hue": 0.1}, "array"),
]


@pytest.mark.parametrize("name,kwargs,source", OP_CASES,
                         ids=[f"{n}-{i}" for i, (n, _, _) in
                              enumerate(OP_CASES)])
def test_every_transform_matches_jax_under_a_fixed_seed(image, name, kwargs,
                                                        source):
    arr, path, data = image
    x = {"array": arr, "path": path, "bytes": data}[source]
    for seed in range(6):
        random.seed(seed)
        want = JP.OPS[name](**kwargs)(x)
        random.seed(seed)
        got = TP.OPS[name](**kwargs)(x)
        _same(got, want, f"{name} seed {seed}")
    assert sorted(TP.OPS) == sorted(JP.OPS)


@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_transform_chains_match_jax(image, chain):
    _, path, _ = image
    for seed in range(4):
        random.seed(seed)
        want = JP.build_transforms(CHAINS[chain])(path)
        random.seed(seed)
        got = TP.build_transforms(CHAINS[chain])(path)
        _same(got, want, f"{chain} seed {seed}")


def test_misordered_jitter_is_refused_and_pillow_is_named(image,
                                                           monkeypatch):
    bad = [{"NormalizeImage": {}}, {"ColorJitter": {}}]
    with pytest.raises(ValueError, match="ColorJitter must come before"):
        TP.build_transforms(bad)
    with pytest.raises(ValueError, match="arithmetic"):
        TP.NormalizeImage(scale="__import__('os')")
    arr, path, _ = image
    monkeypatch.setitem(sys.modules, "PIL", None)
    for op, x in ((TP.DecodeImage(), path), (TP.ResizeImage(size=8), arr),
                  (TP.RandCropImage(size=8), arr)):
        with pytest.raises(ImportError, match="Pillow"):
            op(x)
    _same(TP.CenterCropImage(8)(arr), arr[21:29, 26:34])


@pytest.mark.parametrize("chain", ["train", "eval"])
def test_general_cls_dataset_and_image_folder_match_jax(tmp_path, chain):
    files = _png_tree(tmp_path / "tree")
    listing = tmp_path / "list.txt"
    listing.write_text("".join(f"{p} {c}\n" for p, c in files) + "\n")
    pairs = [
        (TV.GeneralClsDataset(str(tmp_path / "tree"), str(listing),
                              CHAINS[chain]),
         JV.GeneralClsDataset(str(tmp_path / "tree"), str(listing),
                              CHAINS[chain])),
        (TV.ImageFolder(str(tmp_path / "tree"), CHAINS[chain]),
         JV.ImageFolder(str(tmp_path / "tree"), CHAINS[chain]))]
    for t_ds, j_ds in pairs:
        assert len(t_ds) == len(j_ds) == len(files)
        for i in range(len(files)):
            random.seed(i)
            want = j_ds[i]
            random.seed(i)
            got = t_ds[i]
            assert sorted(got) == sorted(want) == ["images", "labels"]
            for k in want:
                _same(got[k], want[k], f"{type(t_ds).__name__}[{i}] {k}")
    assert pairs[1][0].classes == pairs[1][1].classes
    assert pairs[1][0].samples == pairs[1][1].samples


def test_default_transforms_and_cifar10_match_jax(tmp_path):
    files = _png_tree(tmp_path / "tree", n_classes=2, per_class=1)
    listing = tmp_path / "list.txt"
    listing.write_text("".join(f"{p} {c}\n" for p, c in files))
    t_ds = TV.GeneralClsDataset(str(tmp_path / "tree"), str(listing))
    j_ds = JV.GeneralClsDataset(str(tmp_path / "tree"), str(listing))
    _same(t_ds[0]["images"], j_ds[0]["images"])
    assert t_ds[0]["images"].shape == (224, 224, 3)
    rng = np.random.RandomState(2)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(tmp_path / name, "wb") as f:
            pickle.dump({b"data": rng.randint(0, 256, (3, 3072)).astype(
                np.uint8), b"labels": list(rng.randint(0, 10, 3))}, f)
    ops = [{"RandFlipImage": {}}, {"NormalizeImage": {}}]
    for mode in ("train", "test"):
        for transform in (None, ops):
            t = TV.CIFAR10(str(tmp_path), mode, transform)
            j = JV.CIFAR10(str(tmp_path), mode, transform)
            assert len(t) == len(j) == (15 if mode == "train" else 3)
            for i in range(len(t)):
                random.seed(i)
                want = j[i]
                random.seed(i)
                got = t[i]
                for k in want:
                    _same(got[k], want[k], f"{mode}[{i}] {k}")


def test_synthetic_vision_dataset_and_the_registry_match_jax():
    section = {"dataset": {"name": "SyntheticVisionDataset",
                           "num_samples": 6, "image_size": 20,
                           "num_classes": 7, "seed": 3,
                           "image_root": "./absent", "transform_ops": []}}
    shape = dict(seq_length=512, vocab_size=40000)
    t_ds = t_build_dataset(section, "_child_", **shape)
    j_ds = j_build_dataset(section, "_child_", **shape)
    assert isinstance(t_ds, TV.SyntheticVisionDataset)
    assert len(t_ds) == len(j_ds) == 6
    for i in range(6):
        for k in ("images", "labels"):
            _same(t_ds[i][k], j_ds[i][k], f"{i} {k}")
    ernie = t_build_dataset({"dataset": {"name": "SyntheticErnieDataset",
                                         "num_samples": 4}}, "_child_",
                            **shape)
    assert ernie.seq_length == 512 and ernie.vocab_size == 40000
    # the Imagen sets are ported: the registry builds them, shape
    # overrides ignored, and a sample is JAX's
    imagen = {"dataset": {"name": "SyntheticImagenDataset",
                          "num_samples": 2, "image_size": 8,
                          "text_embed_dim": 12, "seed": 3}}
    t_img, j_img = t_build_dataset(imagen, "_child_", **shape), \
        j_build_dataset(imagen, "_child_", **shape)
    assert len(t_img) == len(j_img) == 2
    assert sorted(t_img[1]) == ["images", "text_embeds", "text_mask"]
    for k in ("images", "text_embeds", "text_mask"):
        _same(t_img[1][k], j_img[1][k], f"imagen {k}")
    assert t_img[1]["text_embeds"].shape == (16, 12)


COLLATE_CASES = {
    "stack": (lambda m: m.Stack(dtype=np.float32), [[1, 2], [3, 4]]),
    "stack_axis": (lambda m: m.Stack(axis=1), [np.ones((2, 3)),
                                               np.zeros((2, 3))]),
    "pad": (lambda m: m.Pad(pad_val=-1, ret_length=True), [[1, 2, 3], [4]]),
    "pad_left": (lambda m: m.Pad(pad_val=0, pad_right=False,
                                 dtype=np.int64), [[1, 2], [7, 8, 9]]),
    "pad_axis": (lambda m: m.Pad(axis=1), [np.ones((2, 3)),
                                           np.ones((2, 1))]),
    "tuple": (lambda m: m.Tuple(m.Stack(), m.Pad(pad_val=0,
                                                 ret_length=True)),
              [([1, 2], [5]), ([3, 4], [6, 7])]),
    "tuple_list": (lambda m: m.Tuple([m.Stack(), m.Stack()]),
                   [(1, 2), (3, 4)]),
    "dict": (lambda m: m.Dict({"tokens": m.Pad(pad_val=0, ret_length=True),
                               "label": m.Stack()}),
             [{"tokens": [1, 2], "label": 0}, {"tokens": [3], "label": 1}]),
}


@pytest.mark.parametrize("case", sorted(COLLATE_CASES))
def test_collate_helpers_match_jax(case):
    make, samples = COLLATE_CASES[case]
    got, want = make(TC)(samples), make(JC)(samples)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _same(got[k], want[k], k)
    elif isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    else:
        _same(got, want)
    with pytest.raises(AssertionError, match="arity"):
        TC.Tuple(TC.Stack())([(1, 2)])
