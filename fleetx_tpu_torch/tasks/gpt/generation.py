"""Generation entry point (port of ``tasks/gpt/generation.py:19-58``)::

    python -m fleetx_tpu_torch.tasks.gpt.generation \
        -c fleetx_tpu/configs/nlp/gpt/generation_gpt_345M_single_card.yaml \
        [-o Key.Sub=v ...] [--device cuda|cpu]

Builds ``GPTGenerationModule`` from the config, the tokenizer from
``Generation.tokenizer_dir`` (``vocab.json`` + ``merges.txt``), and the
params from the newest checkpoint under ``Engine.save_load.ckpt_dir``,
verified against its digests. Only when no checkpoint is configured, or
none is present there, it warns and generates from seeded random
weights; a checkpoint that is there but does not verify raises. It
prints one line per returned sample for ``Generation.input_text``: the
decoded text, or with no tokenizer the ids, space-separated (the prompt
is then ``input_text`` read as ids when it is all digits, else
``1 2 3``). Sampling draws from a generator seeded with ``Global.seed``.
Runs on ``cuda`` unless ``--device cpu`` is given.

Under ``tools.supervise --num-procs N`` the config's degrees are checked
against the world of N ranks (``generation_gpt_345M_dp8.yaml`` loads
against 8, as JAX loads it against 8 devices). The JAX task takes no
mesh and generates once, so rank 0 generates and prints, and the other
ranks exit 0 after the loader.
"""

from __future__ import annotations

import sys
from typing import Optional


def load_config(path: str, overrides: Optional[list] = None,
                num_devices: Optional[int] = None):
    """The YAML at ``path`` (``_base_`` chain included) with dotted
    overrides, post-processed; ``num_devices`` is the world the degrees
    must cover (one device when not given)."""
    from fleetx_tpu_torch.utils.config import get_config

    return get_config(path, overrides, num_devices=num_devices)


def build(cfg: dict, device=None):
    """``(module, params, generator)`` for a config: the tokenizer set on
    the module when ``tokenizer_dir`` is given."""
    import torch

    from fleetx_tpu_torch.convert import check_tree
    from fleetx_tpu_torch.core.checkpoint import latest_step, load_params
    from fleetx_tpu_torch.core.module import GPTGenerationModule
    from fleetx_tpu_torch.data.tokenizers.gpt_tokenizer import GPTTokenizer
    from fleetx_tpu_torch.utils.device import resolve_device
    from fleetx_tpu_torch.utils.log import logger

    device = resolve_device(device)
    module = GPTGenerationModule(cfg)
    tok_dir = (cfg.get("Generation") or {}).get("tokenizer_dir")
    if tok_dir:
        module.tokenizer = GPTTokenizer.from_pretrained(str(tok_dir))
    seed = int((cfg.get("Global") or {}).get("seed", 0))
    ckpt_dir = ((cfg.get("Engine") or {}).get("save_load") or {}).get(
        "ckpt_dir")
    if ckpt_dir and latest_step(str(ckpt_dir)) is not None:
        params = load_params(str(ckpt_dir), device=device)
        check_tree(params, module.model_cfg)
    else:
        logger.warning("no checkpoint (ckpt_dir=%r): generating from RANDOM "
                       "weights — output will be noise", ckpt_dir)
        params = module.init_params(seed, device)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    return module, params, generator


def run(cfg: dict, device=None) -> list:
    """Generate for ``Generation.input_text``; the printed lines."""
    module, params, generator = build(cfg, device)
    text = str((cfg.get("Generation") or {}).get("input_text",
                                                 "The quick brown fox"))
    if module.tokenizer is not None:
        return module.generate(params, [text], generator)
    prompt = [int(t) for t in text.split()] \
        if text.replace(" ", "").isdigit() else [1, 2, 3]
    ids = module.generate_ids(params, [prompt], generator)
    return [" ".join(str(int(t)) for t in row) for row in ids]


def main(argv: Optional[list] = None) -> int:
    from fleetx_tpu_torch.utils.config import parse_args
    from fleetx_tpu_torch.utils.env import (close_dist_env, get_rank,
                                            get_world_size, init_dist_env)

    args = parse_args("fleetx_tpu_torch generate", argv)
    init_dist_env(device=args.device)
    rank = get_rank()
    try:
        cfg = load_config(args.config, args.override,
                          num_devices=get_world_size())
    finally:
        close_dist_env()
    if rank != 0:
        return 0
    for line in run(cfg, device=args.device):
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
