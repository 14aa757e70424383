"""Offline evaluation entry point (port of the root ``tools/eval.py``)::

    python -m fleetx_tpu_torch.tools.eval \
        -c fleetx_tpu/configs/nlp/gpt/eval_gpt_345M_single_card.yaml \
        -o Engine.save_load.ckpt_dir=D -o Offline_Eval.tokenizer_dir=T \
        -o Offline_Eval.eval_path=F [--device cuda|cpu]

Two paths, as in the reference tool:

- with an ``Offline_Eval`` section: ``GPTEvalModule.run_offline_eval``
  over ``eval_path``: a raw text file in sliding windows (``eval_type:
  ppl``, stride ``overlapping_eval``) or a ``{"text": ...}`` jsonl whose
  last word is the cloze target (``eval_type: acc``), tokenized with the
  tokenizer in ``tokenizer_dir`` (``vocab.json`` + ``merges.txt``);
- without one: ``EagerEngine(mode="eval").evaluate`` over the ``Data.Eval``
  loader (at most ``Engine.eval_iters`` batches), printing ``eval loss``;
  this path takes any family's recipe (``GPTModule``, ``ErnieModule``,
  ``GeneralClsModule``), its checkpoint checked by the module's
  ``check_params``.

The parameters come from the newest checkpoint under
``Engine.save_load.ckpt_dir``, verified (a checkpoint that fails its audit
raises); with none configured or present the tool warns "NO CHECKPOINT
FOUND" and evaluates seeded random weights. The offline path prints one
JSON line: the results (``loss``, ``ppl``, ``acc`` under ``acc``, the
sums), the window and batch counts, the host wall (first batch and the
median of the rest, device work synchronised around each batch), window
tokens per second, peak device memory and the launches of the flash
forward and fused-norm forward kernels (and of the latter's ``"rows"``
route). Runs on ``cuda`` unless
``--device cpu`` is given.
"""

from __future__ import annotations

import json
import statistics
import sys
import time
from typing import Optional


def load_config(path: str, overrides: Optional[list] = None):
    """The YAML at ``path`` with dotted overrides, post-processed."""
    from fleetx_tpu_torch.utils.config import get_config

    return get_config(path, overrides)


def eval_dataset(cfg: dict):
    """The ``Offline_Eval`` dataset: sliding windows (``ppl``) or cloze
    pairs (``acc``) over ``eval_path``."""
    from fleetx_tpu_torch.data.dataset import eval_dataset as ev
    from fleetx_tpu_torch.data.tokenizers.gpt_tokenizer import GPTTokenizer

    section = dict(cfg.get("Offline_Eval") or {})
    seq = int((cfg.get("Global") or {}).get("max_seq_len", 1024))
    tok_dir = section.get("tokenizer_dir")
    if not tok_dir:
        raise ValueError(
            "Offline_Eval.tokenizer_dir is required (a directory with "
            "vocab.json + merges.txt): eval datasets tokenize raw text")
    tokenizer = GPTTokenizer.from_pretrained(str(tok_dir))
    if section.get("eval_type", "ppl") == "acc":
        return ev.lambada_from_jsonl(str(section["eval_path"]), tokenizer,
                                     seq)
    return ev.lm_eval_from_text(str(section["eval_path"]), tokenizer, seq,
                                int(section.get("overlapping_eval", 32)))


def _timed_batches(module, times: list) -> None:
    """Record the host wall of each ``batch_metrics`` call in ``times``,
    device work synchronised before and after."""
    import torch

    fn = module.batch_metrics

    def wrapper(params, batch):
        dev = batch["tokens"].device
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn(params, batch)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
        return out

    module.batch_metrics = wrapper


def offline_eval(cfg: dict, device=None) -> dict:
    """The ``Offline_Eval`` path: results and measurements (see the module
    docstring)."""
    import torch

    from fleetx_tpu_torch.core.engine import EagerEngine
    from fleetx_tpu_torch.data.dataloader import DataLoader
    from fleetx_tpu_torch.data.sampler.batch_sampler import \
        DistributedBatchSampler
    from fleetx_tpu_torch.models import build_module
    from fleetx_tpu_torch.ops import flash_attention as FA
    from fleetx_tpu_torch.ops import fused_norm as FN

    module = build_module(cfg)
    if not hasattr(module, "run_offline_eval"):
        raise ValueError("the Offline_Eval path needs Model.module: "
                         "GPTEvalModule")
    engine = EagerEngine(cfg, module, mode="eval", device=device)
    params = engine.prepare()
    ds = eval_dataset(cfg)
    bs = int((cfg.get("Offline_Eval") or {}).get("batch_size", 8))
    loader = DataLoader(ds, DistributedBatchSampler(
        len(ds), bs, num_replicas=1, rank=0, drop_last=False))
    times: list = []
    _timed_batches(module, times)
    if engine.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(engine.device)
    FA.fwd_call.launches = FN.fwd_call.launches = 0
    FN.fwd_call.rows_launches = 0
    t0 = time.perf_counter()
    results = module.run_offline_eval(params, loader)
    wall = time.perf_counter() - t0
    seq = ds.seq_length
    out = dict(results, eval_type=module.eval_type, windows=len(ds),
               batches=len(times), seq_length=seq, wall_s=wall,
               first_batch_ms=times[0] * 1e3 if times else None,
               ms_per_batch=statistics.median(times[1:] or times) * 1e3
               if times else None,
               tokens_per_s=len(ds) * seq / wall,
               launches={"flash_attention_fwd": FA.fwd_call.launches,
                         "fused_norm_fwd": FN.fwd_call.launches,
                         "fused_norm_fwd_rows": FN.fwd_call.rows_launches},
               device=str(engine.device))
    if hasattr(ds, "tokens"):
        out["stream_tokens"] = int(len(ds.tokens))
    if engine.device.type == "cuda":
        out["peak_memory_gb"] = \
            torch.cuda.max_memory_allocated(engine.device) / 2 ** 30
    return out


def data_eval(cfg: dict, device=None) -> float:
    """The ``Data.Eval`` path: the eval engine's mean loss over at most
    ``Engine.eval_iters`` batches."""
    from fleetx_tpu_torch.core.engine import EagerEngine
    from fleetx_tpu_torch.data import build_dataloader
    from fleetx_tpu_torch.models import build_module

    glb = dict(cfg.get("Global") or {})
    module = build_module(cfg)
    engine = EagerEngine(cfg, module, mode="eval", device=device)
    loader = build_dataloader(
        cfg.get("Data") or {}, "Eval",
        seq_length=int(glb.get("max_seq_len", 1024)),
        vocab_size=int((cfg.get("Model") or {}).get("vocab_size") or 50304))
    return engine.evaluate(loader)


def main(argv: Optional[list] = None) -> int:
    from fleetx_tpu_torch.utils.config import parse_args

    args = parse_args("fleetx_tpu_torch eval", argv)
    cfg = load_config(args.config, args.override)
    if cfg.get("Offline_Eval"):
        print(json.dumps(offline_eval(cfg, device=args.device)), flush=True)
    else:
        loss = data_eval(cfg, device=args.device)
        print(f"eval loss: {loss!r}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
