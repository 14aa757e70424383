"""GPT inference task (port of ``tasks/gpt/inference.py``): tokenize a
prompt, run the exported generation programs, detokenize::

    python -m fleetx_tpu_torch.tasks.gpt.inference \
        -c fleetx_tpu/configs/nlp/gpt/inference_gpt_345M_single_card.yaml \
        -o Inference.model_dir=D -o Generation.tokenizer_dir=T \
        [--device cuda|cpu]

``Generation.input_text`` is encoded with the tokenizer in
``Generation.tokenizer_dir`` (or ``Inference.tokenizer_dir``), left-padded
to ``Inference.prompt_len`` and run with seed ``[0, Global.seed]`` (the
key ``PRNGKey(Global.seed)``: the seed eager generation samples with).
Prints the prompt and the continuation cut at eos, or with no tokenizer
the generated ids (the prompt is then ``input_text`` read as ids when it
is all digits, else ``[0]``). Runs on ``cuda`` unless ``--device cpu``
is given. Over a data-parallel mesh (``tools.supervise --num-procs N``
with ``dp_degree`` N) the prompt is repeated over the ``batch_size * dp``
rows, each rank generates its shard, and rank 0 prints.
"""

from __future__ import annotations

import sys
from typing import Optional

import numpy as np


def run(cfg: dict, device=None) -> list:
    """The printed lines for ``Generation.input_text``."""
    from fleetx_tpu_torch.core.engine.inference_engine import (
        InferenceEngine, serving_mesh)
    from fleetx_tpu_torch.data.tokenizers.gpt_tokenizer import GPTTokenizer
    from fleetx_tpu_torch.models.gpt.generation import left_pad

    inf = dict(cfg.get("Inference") or {})
    gen = dict(cfg.get("Generation") or {})
    engine = InferenceEngine(str(inf.get("model_dir") or "./exported"),
                             mesh=serving_mesh(cfg.get("Distributed")),
                             device=device)
    tok_dir = gen.get("tokenizer_dir") or inf.get("tokenizer_dir")
    tokenizer = GPTTokenizer.from_pretrained(str(tok_dir)) if tok_dir \
        else None
    text = str(gen.get("input_text", "The quick brown fox"))
    if tokenizer is not None:
        ids = tokenizer.encode(text)
    else:
        ids = [int(t) for t in text.split()] \
            if text.replace(" ", "").isdigit() else [0]
    tokens, mask = left_pad([ids] * (int(inf.get("batch_size", 1))
                                     * engine.dp),
                            int(gen.get("pad_token_id", 50256)),
                            width=int(inf.get("prompt_len", 128)))
    seed = np.array([0, int((cfg.get("Global") or {}).get("seed", 0))],
                    np.uint32)
    out = engine.predict([tokens, mask, seed])[0]
    row = [int(t) for t in out[0]]
    if tokenizer is None:
        return [" ".join(str(t) for t in row)]
    eos = int(gen.get("eos_token_id", 50256))
    if eos in row:
        row = row[:row.index(eos)]
    return [f"prompt: {text!r}", f"continuation: {tokenizer.decode(row)!r}"]


def main(argv: Optional[list] = None) -> int:
    from fleetx_tpu_torch.utils.config import get_config, parse_args
    from fleetx_tpu_torch.utils.env import (close_dist_env, get_rank,
                                            get_world_size, init_dist_env)

    args = parse_args("fleetx_tpu_torch gpt inference", argv)
    init_dist_env(device=args.device)
    rank = get_rank()
    try:
        lines = run(get_config(args.config, args.override,
                               num_devices=get_world_size()),
                    device=args.device)
    finally:
        close_dist_env()
    if rank == 0:
        for line in lines:
            print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
