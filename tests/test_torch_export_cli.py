"""The export and inference entry points as their own processes
(``python -m fleetx_tpu_torch.tools.export``, ``tools.inference`` and
``tasks.gpt.inference``, the API is ``tests/test_torch_export.py``), on
the inference recipe shrunk to the tiny model of that file and a seeded
checkpoint of it.

The processes' tokens must equal an in-process ``InferenceEngine``'s on
the same artifact and inputs exactly (the same programs on the same
inputs).
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
INF_YAML = os.path.join(REPO, "fleetx_tpu", "configs", "nlp", "gpt",
                        "inference_gpt_345M_single_card.yaml")
VOCAB, SEQ, PROMPT, NEW, EOS = 512, 128, 16, 6, 511
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
        "Global.micro_batch_size=2", f"Generation.max_dec_len={NEW}",
        f"Generation.eos_token_id={EOS}", f"Generation.pad_token_id={EOS}",
        f"Inference.prompt_len={PROMPT}", "Generation.min_dec_len=0",
        "Generation.decode_strategy=greedy_search"]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A checkpoint of the tiny model's seeded init: (dir,)."""
    from fleetx_tpu_torch.core.engine import EagerEngine
    from fleetx_tpu_torch.core.module import GPTModule

    out = str(tmp_path_factory.mktemp("ckpt"))
    cfg = {"Model": dict(MODEL), "Global": {"seed": 5},
           "Engine": {"save_load": {"output_dir": out}}}
    eng = EagerEngine(cfg, GPTModule(cfg), device="cpu")
    eng.prepare()
    eng.save()
    return (out,)


def _argv(module: str, args: list) -> list:
    return [sys.executable, "-m", module, "-c", INF_YAML, "--device",
            "cpu"] + sum((["-o", o] for o in args), [])


def _run_all(runs: dict) -> dict:
    """name → (module, overrides): run them as processes at once; name →
    (stdout, stderr), each asserted to exit 0."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = {name: subprocess.Popen(
        _argv(module, args), cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, (module, args) in runs.items()}
    out = {}
    for name, p in procs.items():
        stdout, stderr = p.communicate(timeout=120)
        assert p.returncode == 0, (name, stderr[-3000:])
        out[name] = (stdout, stderr)
    return out


@pytest.fixture(scope="module")
def exported(ckpt, tmp_path_factory):
    """``tools.export`` of both targets from the checkpoint, as two
    processes: target → (overrides, the printed record)."""
    root = tmp_path_factory.mktemp("exported")
    base = TINY + [f"Engine.save_load.ckpt_dir={ckpt[0]}"]
    args = {"generation": base + [f"Inference.model_dir={root / 'gen'}"],
            "forward": base + [f"Inference.model_dir={root / 'fwd'}",
                               "Inference.target=forward",
                               f"Inference.prompt_len={SEQ}"]}
    out = _run_all({k: ("fleetx_tpu_torch.tools.export", v)
                    for k, v in args.items()})
    return {k: (args[k], json.loads(out[k][0].strip().splitlines()[-1]))
            for k in args}


def test_export_then_inference_clis(exported, tmp_path):
    """``tools.export`` writes a generation artifact from the checkpoint;
    ``tools.inference`` and ``tasks.gpt.inference`` run it as their own
    processes; their tokens equal the in-process engine's on the same
    inputs."""
    from fleetx_tpu_torch.core.engine.inference_engine import \
        InferenceEngine
    from fleetx_tpu_torch.data.tokenizers.gpt_tokenizer import train_bpe
    from fleetx_tpu_torch.models.gpt.generation import left_pad

    base, rec = exported["generation"]
    model_dir = rec["model_dir"]
    assert rec["target"] == "generation" and rec["export_s"] > 0
    assert sorted(os.listdir(model_dir)) == ["meta.json", "params.npz",
                                            "program.pt2"]
    with open(os.path.join(REPO, "README.md"), encoding="utf-8") as f:
        tok = train_bpe([f.read()], 400)
    tok.save_pretrained(str(tmp_path / "tok"))
    res = _run_all({
        "tools": ("fleetx_tpu_torch.tools.inference", base),
        "task": ("fleetx_tpu_torch.tasks.gpt.inference", base + [
            f"Generation.tokenizer_dir={tmp_path / 'tok'}"])})
    eng = InferenceEngine(model_dir, device="cpu")
    demo = json.loads(res["tools"][0].strip().splitlines()[0])
    want = eng.predict([np.zeros((1, PROMPT), np.int64),
                        np.ones((1, PROMPT), np.int64),
                        np.zeros(2, np.uint32)])[0]
    assert demo["shape"] == [1, NEW] and demo["first_row"] == \
        want[0].tolist()
    lines = res["task"][0].strip().splitlines()
    text = "Where is the capital of China?"
    assert lines[0] == f"prompt: {text!r}"
    tokens, mask = left_pad([tok.encode(text)], EOS, width=PROMPT)
    row = eng.predict([tokens, mask, np.array([0, 1024], np.uint32)])[0][0]
    row = row.tolist()
    row = row[:row.index(EOS)] if EOS in row else row
    assert lines[1] == f"continuation: {tok.decode(row)!r}"


def test_export_forward_then_inference_cli(exported):
    """The forward target through both processes: the demo batch's logits
    have the exported shape."""
    base, rec = exported["forward"]
    assert rec["target"] == "forward"
    out = _run_all({"fwd": ("fleetx_tpu_torch.tools.inference", base)})
    first, last = (json.loads(l) for l in
                   out["fwd"][0].strip().splitlines())
    assert first == {"output": 0, "shape": [1, SEQ, VOCAB],
                     "dtype": "float32"}
    assert last["target"] == "forward" and last["seconds"] > 0
