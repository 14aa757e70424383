"""Training entry point of the port (port of ``tools/train.py:31-81``)::

    python -m fleetx_tpu_torch.tools.train \
        -c fleetx_tpu/configs/nlp/gpt/pretrain_gpt_345M_synthetic.yaml \
        [-o Key.Sub=v ...] [--device cuda|cpu]

Loads the YAML through the port's config loader (one device), builds the
module ``Model.module`` names (``GPTModule``, ``ErnieModule``,
``GeneralClsModule``, ``ImagenModule``, ...), the LR schedule and optimizer of the
``Optimizer`` section and the ``EagerEngine``, the ``Data.Train`` loader
(and ``Data.Eval`` when ``eval_freq`` is set and an eval dataset is
named), and fits until ``Engine.max_steps`` (in ``Engine.run_mode:
epoch``, also until ``Engine.num_train_epochs`` passes). A YAML with
``Distributed.auto_layout`` runs the layout planner first
(``utils/config.py``; ``tools/auto.py`` runs it on every YAML). It runs on
``cuda`` unless ``--device cpu`` is given; without a GPU and without
``--device cpu`` it raises. Config values the slice does not cover raise
``NotImplementedError`` naming their ROADMAP item.

The encoder recipes run as they are where their data is present; the
ERNIE corpus and ImageNet are not in the repository, so their synthetic
datasets stand in::

    python -m fleetx_tpu_torch.tools.train \
        -c fleetx_tpu/configs/nlp/ernie/pretrain_ernie_345M.yaml \
        -o Data.Train.dataset.name=SyntheticErnieDataset
    python -m fleetx_tpu_torch.tools.train \
        -c fleetx_tpu/configs/vis/vit/ViT_base_patch16_224_pretrain.yaml \
        -o Global.global_batch_size=256 \
        -o Data.Train.dataset.name=SyntheticVisionDataset \
        -o Data.Train.dataset.num_samples=25600 \
        -o Data.Eval.dataset.name=SyntheticVisionDataset \
        -o Data.Eval.dataset.num_samples=512

(the ViT recipe's global batch is 16 cards' worth: one card takes
``local_batch_size`` 256). The 8-expert MoE GPT and the Imagen stages
the same way (the MoE recipe's dp 2 × mp 4 cut to one card; Imagen's
TSV and T5 features are not in the repository, and its synthetic set
must take the YAML's T5 width)::

    python -m fleetx_tpu_torch.tools.train \
        -c fleetx_tpu/configs/nlp/gpt/pretrain_gpt_moe_8expert_mp4.yaml \
        -o Distributed.dp_degree=1 -o Distributed.mp_degree=1 \
        -o Data.Train.dataset.name=SyntheticGPTDataset \
        -o Data.Train.dataset.num_samples=65536
    python -m fleetx_tpu_torch.tools.train \
        -c fleetx_tpu/configs/multimodal/imagen/imagen_397M_text2im_64x64.yaml \
        -o Data.Train.dataset.name=SyntheticImagenDataset \
        -o Data.Train.dataset.text_embed_dim=1024

(``imagen_super_resolution_256.yaml`` likewise; sample the cascade with
``python -m fleetx_tpu_torch.tasks.imagen.generate``).

Telemetry (``Observability.enable``; the CPU recipe
``pretrain_gpt_debug_obs.yaml``) writes ``metrics.jsonl`` / ``.csv`` /
``.prom``, the span trace ``trace.json`` and the flight dumps under
``Observability.output_dir`` (default ``<save_load.output_dir>/telemetry``);
``Profiler.enable`` with ``scheduler: [start, stop]`` profiles those steps
with ``torch.profiler`` into ``Profiler.profiler_log`` and decomposes the
trace into ``perf.jsonl`` beside the metrics. Read them with ``python -m
fleetx_tpu_torch.tools.metrics_report`` / ``trace_report`` /
``postmortem``.

With ``Engine.save_load.save_steps`` set, the trainer saves every
``save_steps`` steps and once more at the end (``output_dir``); with
``Engine.save_load.ckpt_dir`` set it resumes from the newest step there
that verifies (``core/engine/eager_engine.py``). Audit a checkpoint
directory with ``python -m fleetx_tpu_torch.tools.verify_ckpt``.

fp16 with the dynamic loss scaler: ``-o
Engine.mix_precision.use_pure_fp16=True -o Model.dtype=float16``
(``scale_loss`` is the initial scale). ``-o Resilience.enable=True`` runs
the resilience runtime (``resilience/``): auto-resume from
``output_dir``, the guard, the preemption exit, the step watchdog
(``Resilience.watchdog.enable``) and the fault plan
(``-o Resilience.faults.<knob>=...`` or ``FLEETX_FAULTS``). Exit codes, as
the JAX tool's: a preemption exits with ``Resilience.preemption.exit_code``
after saving the step; a ``TrainingAborted`` from the guard is an error
exit (1, with its traceback); a watchdog ``action: abort`` ends the
process with 43.

Under the supervisor (``python -m fleetx_tpu_torch.tools.supervise``):
``--num-procs 1`` restarts a crashed run, which resumes from its newest
checkpoint; a gang member (``FLEETX_NUM_PROCESSES`` above 1) raises,
since a multi-rank gang is not ported (ROADMAP.md, port queue item 12)
and N copies of a one-device job would share one card.
"""

from __future__ import annotations

import sys
from typing import Optional


def load_config(path: str, overrides: Optional[list] = None,
                auto_layout: bool = False, device=None):
    """The YAML at ``path`` with dotted overrides, post-processed; the
    layout planner runs under ``auto_layout`` or the YAML's
    ``Distributed.auto_layout``, its budget sized by ``device``."""
    from fleetx_tpu_torch.utils.config import get_config

    return get_config(path, overrides, auto_layout=auto_layout,
                      device=device)


def build_trainer(cfg: dict, device=None, wrap_optimizer=None):
    """``(engine, train_loader, eval_loader or None)`` from a config;
    ``wrap_optimizer`` (e.g. ``finetune.lora_optimizer``) wraps the
    configured optimizer."""
    from fleetx_tpu_torch.core.engine import EagerEngine
    from fleetx_tpu_torch.data import build_dataloader
    from fleetx_tpu_torch.models import build_module
    from fleetx_tpu_torch.optims import build_lr_scheduler, build_optimizer
    from fleetx_tpu_torch.utils.env import set_seed

    glb = dict(cfg.get("Global") or {})
    set_seed(int(glb.get("seed", 1234)))
    module = build_module(cfg)
    opt_cfg = dict(cfg.get("Optimizer") or {})
    lr = build_lr_scheduler(opt_cfg.get("lr"))
    optimizer = build_optimizer(opt_cfg, lr)
    if wrap_optimizer is not None:
        optimizer = wrap_optimizer(optimizer)
    engine = EagerEngine(cfg, module, optimizer=optimizer, lr_schedule=lr,
                         device=device)
    data_cfg = cfg.get("Data") or {}
    shape_kwargs = dict(
        seq_length=int(glb.get("max_seq_len", 1024)),
        vocab_size=int((cfg.get("Model") or {}).get("vocab_size") or 50304))
    batch_size = int(glb.get("global_batch_size", 8))
    train_dl = build_dataloader(data_cfg, "Train", batch_size=batch_size,
                                **shape_kwargs)
    valid_dl = None
    if engine.eval_freq and (data_cfg.get("Eval") or {}).get("dataset"):
        valid_dl = build_dataloader(data_cfg, "Eval", batch_size=batch_size,
                                    **shape_kwargs)
    return engine, train_dl, valid_dl


def run(cfg: dict, device=None):
    """Build the trainer, fit, and save the final step when ``save_steps``
    is set; returns ``(engine, logged losses)``."""
    engine, train_dl, valid_dl = build_trainer(cfg, device)
    epochs = int((cfg.get("Engine") or {}).get("num_train_epochs") or 1)
    losses = engine.fit(train_dl, valid_dl, epoch_num=epochs)
    if engine.save_steps and engine.last_saved_step != engine.step:
        engine.save()
        # an asynchronous final save completes before the process ends
        from fleetx_tpu_torch.core.checkpoint import finalize_async_saves

        finalize_async_saves()
        engine.obs.flush()  # the final save's spans into trace.json
    return engine, losses


def check_single_process() -> None:
    """Refuse to run as a member of a multi-process gang."""
    import os

    procs = int(os.environ.get("FLEETX_NUM_PROCESSES") or 1)
    if procs > 1:
        raise NotImplementedError(
            f"FLEETX_NUM_PROCESSES={procs}: a multi-process gang is not "
            f"ported yet (ROADMAP.md, port queue item 12)")


def main(argv: Optional[list] = None, auto_layout: bool = False) -> int:
    """The CLI; ``auto_layout`` runs the layout planner on every config
    (``tools/auto.py``), and logs the ``Distributed`` degrees it
    resolved."""
    from fleetx_tpu_torch.utils.config import DEGREE_KEYS, parse_args
    from fleetx_tpu_torch.utils.log import logger

    check_single_process()
    args = parse_args("fleetx_tpu_torch "
                      + ("auto" if auto_layout else "train"), argv)
    cfg = load_config(args.config, args.override, auto_layout=auto_layout,
                      device=args.device)
    if auto_layout:
        dist = cfg["Distributed"]
        logger.info("auto_layout: resolved Distributed %s",
                    {k: dist[k] for k in DEGREE_KEYS})
    run(cfg, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
