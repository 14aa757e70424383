"""``python -m fleetx_tpu_torch.tools.eval`` as its own process (the API
is ``tests/test_torch_eval.py``): both ``Offline_Eval`` types from a
checkpoint, the ``Data.Eval`` path with its "NO CHECKPOINT FOUND"
warning, and the refusal of a checkpoint that fails its audit.

The recipe is ``eval_gpt_345M_single_card.yaml`` (and the 345M pretrain
recipe for ``Data.Eval``) shrunk to the tiny f32 model of
``tests/test_torch_eval.py``; the text is ``docs/quick_start.md`` and
``docs/inference.md`` through a ``train_bpe`` tokenizer of
``README.md``. The processes' results must equal the same evaluation in
this process exactly (the same code on the same inputs).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.torch_port


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """This file's tensors are tiny: torch runs them on one intra-op
    thread (its default pool, on cores the other test workers share,
    costs far more than the work). The count is restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVAL_YAML = os.path.join(REPO, "fleetx_tpu", "configs", "nlp", "gpt",
                         "eval_gpt_345M_single_card.yaml")
PRETRAIN_YAML = os.path.join(REPO, "fleetx_tpu", "configs", "nlp", "gpt",
                             "pretrain_gpt_345M_single_card.yaml")
VOCAB, SEQ = 512, 128
MODEL = dict(vocab_size=VOCAB, hidden_size=128, num_layers=2,
             num_attention_heads=2, max_position_embeddings=SEQ,
             hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
             use_flash_attention=True, fused_residual_norm=True,
             dtype="float32", param_dtype="float32")
TINY = ["Model.num_layers=2", "Model.hidden_size=128",
        "Model.num_attention_heads=2", f"Model.vocab_size={VOCAB}",
        f"Model.max_position_embeddings={SEQ}", f"Global.max_seq_len={SEQ}",
        "Model.dtype=float32", "Model.hidden_dropout_prob=0.0",
        "Model.attention_probs_dropout_prob=0.0",
        "Global.global_batch_size=2", "Global.local_batch_size=2",
        "Global.micro_batch_size=2"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The tokenizer dir, the eval text and its cloze jsonl."""
    from fleetx_tpu_torch.data.tokenizers.gpt_tokenizer import train_bpe

    root = tmp_path_factory.mktemp("eval")
    with open(os.path.join(REPO, "README.md"), encoding="utf-8") as f:
        tok = train_bpe([f.read()], 400)
    tok.save_pretrained(str(root / "tok"))
    text = "".join(open(os.path.join(REPO, "docs", name),
                        encoding="utf-8").read()
                   for name in ("quick_start.md", "inference.md"))
    (root / "eval.txt").write_text(text, encoding="utf-8")
    with open(root / "cloze.jsonl", "w", encoding="utf-8") as f:
        for para in text.split("\n\n"):
            para = " ".join(para.split())
            if len(para.split()) >= 5:
                f.write(json.dumps({"text": para}) + "\n")
    return {"tok": str(root / "tok"), "txt": str(root / "eval.txt"),
            "jsonl": str(root / "cloze.jsonl"), "root": root}


def _dataset(files, kind: str):
    from fleetx_tpu_torch.data.dataset import eval_dataset as ev
    from fleetx_tpu_torch.data.tokenizers.gpt_tokenizer import GPTTokenizer

    tok = GPTTokenizer.from_pretrained(files["tok"])
    if kind == "acc":
        return ev.lambada_from_jsonl(files["jsonl"], tok, SEQ)
    return ev.lm_eval_from_text(files["txt"], tok, SEQ, 32)


def _loader(ds, bs: int = 4):
    from fleetx_tpu_torch.data.dataloader import DataLoader
    from fleetx_tpu_torch.data.sampler.batch_sampler import \
        DistributedBatchSampler

    return DataLoader(ds, DistributedBatchSampler(
        len(ds), bs, num_replicas=1, rank=0, drop_last=False))


def _cli(args: list) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("CUDA_VISIBLE_DEVICES", None)
    return subprocess.run(
        [sys.executable, "-m", "fleetx_tpu_torch.tools.eval"] + args,
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)


@pytest.fixture(scope="module")
def checkpoint(files):
    """A saved step of the tiny model (the eval recipe's module)."""
    from fleetx_tpu_torch.core.checkpoint import flatten
    from fleetx_tpu_torch.core.engine import EagerEngine
    from fleetx_tpu_torch.core.module import GPTModule

    out = str(files["root"] / "ckpt")
    cfg = {"Model": dict(MODEL), "Global": {"seed": 11},
           "Engine": {"save_load": {"output_dir": out}}}
    eng = EagerEngine(cfg, GPTModule(cfg), device="cpu")
    eng.prepare()
    eng.save()
    return out, {k: v.detach().clone()
                 for k, v in flatten(eng.params).items()}


@pytest.mark.parametrize("kind", ["ppl", "acc"])
def test_eval_cli_offline_paths(files, checkpoint, kind):
    """``tools.eval --device cpu`` on the eval recipe shrunk to the tiny
    model, from the checkpoint: the printed results equal
    ``run_offline_eval`` in this process on the checkpoint's weights."""
    from fleetx_tpu_torch.core.checkpoint import unflatten
    from fleetx_tpu_torch.core.module import GPTEvalModule

    ckpt, flat = checkpoint
    path = files["jsonl"] if kind == "acc" else files["txt"]
    out = _cli(["-c", EVAL_YAML, "--device", "cpu"] + sum(
        (["-o", o] for o in TINY + [
            f"Engine.save_load.ckpt_dir={ckpt}",
            f"Offline_Eval.tokenizer_dir={files['tok']}",
            f"Offline_Eval.eval_path={path}",
            f"Offline_Eval.eval_type={kind}",
            "Offline_Eval.batch_size=4"]), []))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "NO CHECKPOINT FOUND" not in out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    ours = _dataset(files, kind)
    module = GPTEvalModule({"Model": dict(MODEL),
                            "Offline_Eval": {"eval_type": kind}})
    want = module.run_offline_eval(unflatten(flat), _loader(ours))
    for key in ("loss", "ppl", "token_count", "correct", "rows") + (
            ("acc",) if kind == "acc" else ()):
        assert got[key] == want[key], key
    assert got["eval_type"] == kind and got["windows"] == len(ours)
    assert got["batches"] == -(-len(ours) // 4) and got["device"] == "cpu"
    assert got["launches"] == {"flash_attention_fwd": 0,
                               "fused_norm_fwd": 0,
                               "fused_norm_fwd_rows": 0}  # plain on the CPU


def test_eval_cli_data_eval_path_and_no_checkpoint_warning(files, tmp_path):
    """Without ``Offline_Eval``: ``EagerEngine(mode="eval").evaluate`` over
    a ``GPTDataset`` written by the port's ``write_corpus``; with no
    checkpoint configured the tool warns and evaluates seeded weights."""
    from fleetx_tpu_torch.core.engine import EagerEngine
    from fleetx_tpu_torch.data import build_dataloader, write_corpus
    from fleetx_tpu_torch.models import build_module
    from fleetx_tpu_torch.utils.config import get_config

    rng = np.random.RandomState(2)
    write_corpus(str(tmp_path / "c"),
                 [list(rng.randint(0, VOCAB, n)) for n in (300, 700, 90)])
    overrides = TINY + [f"Data.Eval.dataset.input_dir={tmp_path / 'c'}",
                        "Data.Eval.dataset.num_samples=8",
                        "Data.Eval.loader.batch_size=2",
                        "Engine.eval_iters=3"]
    out = subprocess.run(
        [sys.executable, "-m", "fleetx_tpu_torch.tools.eval", "-c",
         PRETRAIN_YAML, "--device", "cpu"] + sum(
            (["-o", o] for o in overrides), []),
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
        capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "NO CHECKPOINT FOUND" in out.stderr
    got = float(out.stdout.strip().splitlines()[-1].split(": ")[1])
    cfg = get_config(PRETRAIN_YAML, overrides)
    eng = EagerEngine(cfg, build_module(cfg), device="cpu", mode="eval")
    loader = build_dataloader(cfg["Data"], "Eval", seq_length=SEQ)
    assert got == eng.evaluate(loader) and np.isfinite(got)
    assert got == pytest.approx(np.log(VOCAB), abs=0.1)  # untrained


def test_eval_cli_refuses_a_corrupt_checkpoint(files, checkpoint, tmp_path):
    """A configured checkpoint that fails its audit raises; it never
    falls back to random weights."""
    import shutil

    from fleetx_tpu_torch.core import checkpoint as C

    ckpt = str(tmp_path / "bad")
    shutil.copytree(checkpoint[0], ckpt)
    step = C.completed_steps(ckpt)[-1]
    target = os.path.join(C.step_dir(ckpt, step), C.STATE_NAME)
    size = os.path.getsize(target)
    with open(target, "r+b") as f:
        f.seek(size // 2)
        byte = f.read(1)
        f.seek(size // 2)
        f.write(bytes([byte[0] ^ 0xFF]))
    out = _cli(["-c", EVAL_YAML, "--device", "cpu"] + sum(
        (["-o", o] for o in TINY + [
            f"Engine.save_load.ckpt_dir={ckpt}",
            f"Offline_Eval.tokenizer_dir={files['tok']}",
            f"Offline_Eval.eval_path={files['txt']}"]), []))
    assert out.returncode != 0
    assert "CheckpointIntegrityError" in out.stderr
    assert "NO CHECKPOINT FOUND" not in out.stderr
