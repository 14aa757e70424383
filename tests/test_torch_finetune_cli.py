"""The fine-tune and quantized-replica entry points of the port on the
CPU: ``python -m fleetx_tpu_torch.tools.finetune`` and ``tools.serve`` on
``finetune_gpt_345M_lora.yaml`` shrunk to a tiny model (2 layers, hidden
128, 2 heads, vocab 256, seq 128, f32) with synthetic tokens, a base
checkpoint of seeded weights, and their refusals.

The numbers are the port's own (the recipe against JAX is
``tests/test_torch_finetune.py``): the CLI's JSON line must report the
steps it ran with finite losses, every adapter leaf moved and the base
unchanged, the trainable fraction of the tiny model exactly, and an
artifact the auditor passes; the replica must answer from the merged,
quantized weights.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fleetx_tpu_torch.core import checkpoint as C
from fleetx_tpu_torch.finetune import checkpoint as TFT
from fleetx_tpu_torch.finetune import lora as TL
from fleetx_tpu_torch.models.gpt.model import config_from_dict, init_params

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
LORA_YAML = os.path.join(REPO, "fleetx_tpu", "configs", "nlp", "gpt",
                         "finetune_gpt_345M_lora.yaml")
MODEL = {"num_layers": 2, "hidden_size": 128, "num_attention_heads": 2,
         "vocab_size": 256, "max_position_embeddings": 128,
         "dtype": "float32"}
TINY = [f"Model.{k}={v}" for k, v in MODEL.items()] + [
    "Global.max_seq_len=128", "Global.global_batch_size=2",
    "Global.local_batch_size=2", "Global.micro_batch_size=2",
    "Engine.logging_freq=1", "Engine.max_steps=3",
    "Data.Train.dataset.name=SyntheticGPTDataset",
    "Data.Train.dataset.num_samples=64",
    "Data.Train.dataset.vocab_size=256",
    "Data.Train.dataset.seq_length=128",
    "Optimizer.lr.max_lr=1e-3", "Optimizer.lr.warmup_rate=0.0"]


def _overrides(pairs: list) -> list:
    return sum((["-o", p] for p in pairs), [])


@pytest.fixture(scope="module")
def base_ckpt(tmp_path_factory) -> str:
    """A checkpoint of the tiny model's seeded weights."""
    path = str(tmp_path_factory.mktemp("ft_cli") / "base")
    params = init_params(config_from_dict(MODEL), seed=3)
    C.save_checkpoint(path, 1, dict(step=1, **C.flatten(params, "params/")))
    return path


def _run(module: str, args: list, timeout: int = 300):
    return subprocess.run(
        [sys.executable, "-m", f"fleetx_tpu_torch.tools.{module}"] + args,
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=timeout)


def test_finetune_then_serve_through_the_clis(base_ckpt, tmp_path):
    out_dir = str(tmp_path / "ft")
    run = _run("finetune", ["-c", LORA_YAML, "--device", "cpu"]
               + _overrides(TINY + [f"FineTune.base_ckpt={base_ckpt}",
                                    "FineTune.adapter_dir=None",
                                    f"Engine.save_load.output_dir={out_dir}"]))
    assert run.returncode == 0, run.stderr[-3000:]
    rec = json.loads([l for l in run.stdout.splitlines()
                      if l.startswith("{")][-1])
    assert rec["steps"] == 3 and len(rec["losses"]) == 3
    assert all(np.isfinite(rec["losses"])) and \
        all(np.isfinite(rec["grad_norms"]))
    # the adapter leaves of the tiny model: (128·8 + 8·384) + (128·8 +
    # 8·128) + (128·8 + 8·512) + (512·8 + 8·128) a layer, 2 layers
    per_layer = (128 * 8 + 8 * 384) + (128 * 8 + 8 * 128) + \
        (128 * 8 + 8 * 512) + (512 * 8 + 8 * 128)
    assert rec["trainable_params"] == 2 * per_layer
    assert rec["trainable_params_frac"] == pytest.approx(
        2 * per_layer / rec["total_params"], rel=1e-12)
    assert len(rec["adapters_moved"]) == 8 and \
        min(rec["adapters_moved"].values()) > 0
    # no adapter_dir: the artifact lands under the output dir; the
    # auditor passes it and its stamped base is the checkpoint's
    assert rec["adapter_path"] == os.path.join(out_dir, "adapter", "step_3")
    assert rec["adapter_bytes"] == TFT.adapter_bytes(rec["adapter_path"])
    from fleetx_tpu_torch.tools import verify_ckpt

    assert verify_ckpt.audit_directory(os.path.join(out_dir, "adapter"))[
        "ok"]
    _, meta = TFT.load_adapter(os.path.join(out_dir, "adapter"))
    assert meta["base_leaves"] == TL.base_leaf_digests(
        C.load_params(base_ckpt))
    assert rec["launches"]["fused_norm_fwd"] == 0  # plain versions on CPU

    # the replica on the same yaml: quantized decode of the merged weights
    bench = _run("serve", ["-c", LORA_YAML, "--device", "cpu", "--bench",
                           "--requests", "3", "--rate", "50"]
                 + _overrides([f"Model.{k}={v}" for k, v in MODEL.items()]
                              + ["Serving.max_seq_len=128",
                                 "Serving.num_pages=40",
                                 "Serving.max_batch=4",
                                 f"Serving.ckpt_dir={base_ckpt}",
                                 "Serving.adapter_dir="
                                 + os.path.join(out_dir, "adapter"),
                                 "ServingBench.max_prompt=8",
                                 "ServingBench.max_new=4"]))
    assert bench.returncode == 0, bench.stderr[-3000:]
    assert "quantize_decode=True" in bench.stderr
    assert "base verified" in bench.stderr
    line = json.loads([l for l in bench.stdout.splitlines()
                       if l.startswith("{")][-1])
    assert line["value"] > 0


def test_finetune_cli_without_device_raises_when_no_cuda(base_ckpt):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    run = _run("finetune", ["-c", LORA_YAML] + _overrides(
        TINY + [f"FineTune.base_ckpt={base_ckpt}"]), timeout=120)
    assert run.returncode != 0
    assert "no CUDA device" in run.stderr, run.stderr[-2000:]


@pytest.mark.parametrize("what", ["module", "base_ckpt", "moe"])
def test_finetune_refuses_what_the_recipe_cannot_train(what, base_ckpt):
    from fleetx_tpu_torch.tools import finetune
    from fleetx_tpu_torch.tools.train import load_config

    extra = {"module": ["Model.module=GPTModule",
                        f"FineTune.base_ckpt={base_ckpt}"],
             "base_ckpt": ["FineTune.base_ckpt=None"],
             "moe": ["Model.moe_num_experts=4"]}[what]
    cfg = load_config(LORA_YAML, TINY + extra)
    match = {"module": "requires Model.module: LoRAGPTModule",
             "base_ckpt": "FineTune.base_ckpt must name",
             "moe": "dense GPT stack"}[what]
    with pytest.raises(ValueError, match=match):
        finetune.run(cfg, device="cpu")
