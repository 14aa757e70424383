"""Config-driven data builders (port of ``fleetx_tpu/data/__init__.py:41-106``).

Ported: the GPT datasets (``GPTDataset``, ``SyntheticGPTDataset``,
``BlendedDataset``, its children built recursively with the same shape
overrides), ERNIE's (``ErnieDataset``, ``SyntheticErnieDataset``), the
vision datasets (``GeneralClsDataset``, ``ImageFolder``, ``CIFAR10``,
``SyntheticVisionDataset``), ``GPTBatchSampler`` and
``DistributedBatchSampler``. The shape overrides reach only the datasets
that read them: ``seq_length`` the token datasets, ``vocab_size`` the
synthetic GPT set and the ERNIE sets. Imagen's (``ImagenDataset``,
``SyntheticImagenDataset``) read neither.
"""

from __future__ import annotations

from typing import Optional

from fleetx_tpu_torch.data.dataloader import DataLoader, default_collate
from fleetx_tpu_torch.data.dataset.ernie_dataset import (
    ErnieDataset, SyntheticErnieDataset)
from fleetx_tpu_torch.data.dataset.gpt_dataset import (
    BlendedDataset, GPTDataset, SyntheticGPTDataset, write_corpus)
from fleetx_tpu_torch.data.dataset.multimodal_dataset import (
    ImagenDataset, SyntheticImagenDataset)
from fleetx_tpu_torch.data.dataset.vision_dataset import (
    CIFAR10, GeneralClsDataset, ImageFolder, SyntheticVisionDataset)
from fleetx_tpu_torch.data.sampler.batch_sampler import (
    DistributedBatchSampler, GPTBatchSampler)

DATASETS = {"GPTDataset": GPTDataset,
            "SyntheticGPTDataset": SyntheticGPTDataset,
            "BlendedDataset": BlendedDataset,
            "ErnieDataset": ErnieDataset,
            "SyntheticErnieDataset": SyntheticErnieDataset,
            "GeneralClsDataset": GeneralClsDataset,
            "ImageFolder": ImageFolder,
            "CIFAR10": CIFAR10,
            "SyntheticVisionDataset": SyntheticVisionDataset,
            "ImagenDataset": ImagenDataset,
            "SyntheticImagenDataset": SyntheticImagenDataset}
SAMPLERS = {"GPTBatchSampler": GPTBatchSampler,
            "DistributedBatchSampler": DistributedBatchSampler}
#: dataset name -> ROADMAP port queue item that ports it (every dataset
#: of the JAX registry is ported)
NOT_PORTED: dict = {}
#: the datasets that take a sequence length / the model's vocabulary
SEQ_NAMED = ("GPTDataset", "SyntheticGPTDataset", "ErnieDataset",
             "SyntheticErnieDataset")
VOCAB_NAMED = ("SyntheticGPTDataset", "ErnieDataset",
               "SyntheticErnieDataset")

__all__ = ["DataLoader", "default_collate", "GPTDataset",
           "SyntheticGPTDataset", "BlendedDataset", "write_corpus",
           "ErnieDataset", "SyntheticErnieDataset", "GeneralClsDataset",
           "ImageFolder", "CIFAR10", "SyntheticVisionDataset",
           "ImagenDataset", "SyntheticImagenDataset",
           "DistributedBatchSampler",
           "GPTBatchSampler", "build_dataset", "build_dataloader"]


def build_dataset(cfg: dict, mode: str = "Train", **overrides):
    """Build a dataset from a config ``Data.{mode}.dataset`` section."""
    section = dict((cfg.get(mode) or cfg).get("dataset") or {})
    name = section.pop("name", "GPTDataset")
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"dataset {name} is not ported yet (ROADMAP.md, port queue item "
            f"{NOT_PORTED[name]})")
    cls = DATASETS.get(name)
    if cls is None:
        raise ValueError(f"unknown dataset {name!r}")
    section.pop("split", None)
    if name == "BlendedDataset":
        # each child built recursively with the same shape overrides
        children = [build_dataset({"dataset": child}, mode="_child_",
                                  **overrides)
                    for child in (section.get("datasets") or [])]
        return BlendedDataset(children, section.get("weights"),
                              int(section.get("num_samples")))
    section.update(overrides)
    input_dir = section.pop("input_dir", None)
    if input_dir is not None and "data_prefix" not in section:
        section["data_prefix"] = input_dir
    if name in SEQ_NAMED:
        section.setdefault("seq_length", section.pop("max_seq_len", 1024))
    else:  # images have no sequence axis
        section.pop("seq_length", None)
        section.pop("max_seq_len", None)
    if name not in VOCAB_NAMED:
        # a GPT corpus's token range is its own; the others have none
        section.pop("vocab_size", None)
    return cls(**section)


def build_dataloader(cfg: dict, mode: str = "Train", *,
                     num_replicas: int = 1, rank: int = 0,
                     consumed_samples: int = 0,
                     batch_size: Optional[int] = None, **dataset_overrides):
    """Dataset + sampler + loader from a config ``Data.{mode}`` section;
    ``batch_size`` overrides the config value."""
    section = dict(cfg.get(mode) or cfg)
    dataset = build_dataset(cfg, mode, **dataset_overrides)
    sampler_cfg = dict(section.get("sampler") or {})
    name = sampler_cfg.pop("name",
                           "GPTBatchSampler" if mode == "Train"
                           else "DistributedBatchSampler")
    loader_cfg = dict(section.get("loader") or {})
    if batch_size is None:
        batch_size = int(loader_cfg.get("batch_size",
                                        sampler_cfg.pop("batch_size", 1)))
    sampler_cfg.pop("batch_size", None)
    kwargs = dict(num_replicas=num_replicas, rank=rank,
                  drop_last=bool(sampler_cfg.pop("drop_last", True)))
    if name == "GPTBatchSampler":
        kwargs["consumed_samples"] = consumed_samples
    else:
        kwargs["shuffle"] = bool(sampler_cfg.pop("shuffle", False))
    kwargs.update(sampler_cfg)
    sampler = SAMPLERS[name](len(dataset), batch_size, **kwargs)
    return DataLoader(dataset, sampler,
                      prefetch=int(loader_cfg.get("prefetch", 2)))
