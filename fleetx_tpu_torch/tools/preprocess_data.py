"""Offline corpus preprocessing: raw text / jsonl → ``_ids.npy`` +
``_idx.npz`` (a copy of the root ``tools/preprocess_data.py`` on the
port's tokenizer)::

    python -m fleetx_tpu_torch.tools.preprocess_data \
        --input corpus.jsonl --json-key text \
        --tokenizer ./tokenizer_dir --output-prefix ./data/openwebtext \
        --workers 8 --append-eos [--device cuda|cpu]

Input formats (by extension): ``.jsonl`` / ``.json``, one JSON object per
line with the text under ``--json-key``; anything else plain text, one
document per run of non-blank lines. Output: ``{prefix}_ids.npy`` (the
flat token stream, uint16 when every id fits, else uint32) and
``{prefix}_idx.npz`` (per-document lengths), byte-identical to the root
tool's for the same input and tokenizer; ``GPTDataset`` reads them.

Tokenizing runs on the host in ``--workers`` processes. ``--device`` is
resolved as at every entry point of the port (``cuda`` unless ``--device
cpu``; without a GPU it raises), so a pipeline of the port's tools stops
at its first step on a host that cannot run the rest.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import sys
import time
from typing import Optional

import numpy as np

_worker_tokenizer = None
_worker_args = None


def _init_worker(tokenizer_path: str, args_dict: dict) -> None:
    global _worker_tokenizer, _worker_args
    from fleetx_tpu_torch.data.tokenizers.gpt_tokenizer import GPTTokenizer

    _worker_tokenizer = GPTTokenizer.from_pretrained(tokenizer_path)
    _worker_args = args_dict


def _encode_doc(text: str) -> list:
    ids = _worker_tokenizer.encode(text)
    if _worker_args["append_eos"]:
        ids.append(_worker_args["eos_id"])
    return ids


def iter_documents(path: str, json_key: str):
    """Yield document strings from jsonl or plain text."""
    is_json = path.endswith((".jsonl", ".json"))
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        if is_json:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    yield json.loads(line)[json_key]
                except (json.JSONDecodeError, KeyError):
                    continue
        else:
            buf: list = []
            for line in f:
                if line.strip():
                    buf.append(line.strip())
                elif buf:
                    yield " ".join(buf)
                    buf = []
            if buf:
                yield " ".join(buf)


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--input", required=True, help="corpus file (jsonl or txt)")
    p.add_argument("--json-key", default="text")
    p.add_argument("--tokenizer", required=True,
                   help="dir with vocab.json + merges.txt")
    p.add_argument("--output-prefix", required=True)
    p.add_argument("--workers", type=int,
                   default=max((os.cpu_count() or 2) // 2, 1))
    p.add_argument("--append-eos", action="store_true")
    p.add_argument("--eos-id", type=int, default=None,
                   help="document separator id; defaults to the tokenizer's "
                        "own eos id")
    p.add_argument("--log-interval", type=int, default=10000)
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu; tokenizing runs on the host")
    args = p.parse_args(argv)

    from fleetx_tpu_torch.data.tokenizers.gpt_tokenizer import GPTTokenizer
    from fleetx_tpu_torch.utils.device import resolve_device
    from fleetx_tpu_torch.utils.log import logger

    resolve_device(args.device)
    t0 = time.time()
    chunks: list = []
    lens: list = []
    total_tokens = 0
    eos_id = args.eos_id
    if eos_id is None:
        eos_id = GPTTokenizer.from_pretrained(args.tokenizer).eos_token_id
        logger.info("using tokenizer eos id %d as document separator", eos_id)
    worker_args = {"append_eos": args.append_eos, "eos_id": eos_id}

    with multiprocessing.get_context("spawn").Pool(
            args.workers, initializer=_init_worker,
            initargs=(args.tokenizer, worker_args)) as pool:
        docs = iter_documents(args.input, args.json_key)
        for i, ids in enumerate(pool.imap(_encode_doc, docs, chunksize=64)):
            if not ids:
                continue
            chunks.append(np.asarray(ids, np.int64))
            lens.append(len(ids))
            total_tokens += len(ids)
            if args.log_interval and (i + 1) % args.log_interval == 0:
                rate = total_tokens / max(time.time() - t0, 1e-9)
                logger.info("processed %d docs, %d tokens (%.0f tok/s)",
                            i + 1, total_tokens, rate)

    if not chunks:
        logger.error("no documents found in %s", args.input)
        return 1

    flat = np.concatenate(chunks)
    dtype = np.uint16 if flat.max() < 2 ** 16 else np.uint32
    os.makedirs(os.path.dirname(os.path.abspath(args.output_prefix)),
                exist_ok=True)
    np.save(args.output_prefix + "_ids.npy", flat.astype(dtype),
            allow_pickle=False)
    np.savez(args.output_prefix + "_idx.npz",
             lens=np.asarray(lens, np.int64))
    logger.info("wrote %s_ids.npy (%d docs, %d tokens, %s) in %.1fs",
                args.output_prefix, len(lens), total_tokens, dtype.__name__,
                time.time() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
