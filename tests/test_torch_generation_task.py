"""Port parity: the generation task (``GPTGenerationModule`` in
``fleetx_tpu_torch/core/module.py`` and ``python -m
fleetx_tpu_torch.tasks.gpt.generation``; the decoders themselves are
``tests/test_torch_generation.py``).

The weights are drawn with numpy from a seed as in
``tests/test_torch_generation.py`` (the tiny f32 model of
``tests/test_zz_serving.py``), fed to the JAX module as they are and to
the port through ``convert.params_from_jax``. Tokens must be IDENTICAL.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fleetx_tpu.core.module import GPTGenerationModule as JGenModule
from fleetx_tpu_torch.convert import params_from_jax
from fleetx_tpu_torch.core import checkpoint as C
from fleetx_tpu_torch.core.module import GPTGenerationModule
from fleetx_tpu_torch.data.tokenizers.gpt_tokenizer import train_bpe
from fleetx_tpu_torch.models import build_module
from fleetx_tpu_torch.models.gpt import model as M
from fleetx_tpu_torch.tasks.gpt import generation as task

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
GEN_YAML = os.path.join(REPO, "fleetx_tpu", "configs", "nlp", "gpt",
                        "generation_gpt_345M_single_card.yaml")
MODEL = dict(vocab_size=97, num_layers=2, max_position_embeddings=64,
             hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
             use_flash_attention=False, dtype="float32",
             param_dtype="float32", hidden_size=64, num_attention_heads=4,
             fused_residual_norm=False)
PROMPTS = [[5, 9, 23, 41, 7], [3, 4], [60, 61, 62, 63, 64, 65, 66, 2],
           [88]]
PAD = 0


@pytest.fixture(scope="module")
def tiny():
    """(jax params, port params): kernels and embeddings std 0.1, biases
    0.05, LayerNorm scales 1 ± 0.1."""
    rng = np.random.RandomState(1)

    def build(node, path):
        if isinstance(node, dict):
            return {k: build(v, path + (k,)) for k, v in node.items()}
        if path[-1] == "scale":
            return (1 + 0.1 * rng.randn(*node)).astype(np.float32)
        std = 0.05 if "bias" in path[-1] else 0.1
        return (std * rng.randn(*node)).astype(np.float32)

    tcfg = M.config_from_dict(MODEL)
    tree = build(M.param_shapes(tcfg), ())
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            params_from_jax(tree, tcfg))


# ----------------------------------------------------------------- module
MODULE_CASES = {
    "greedy_ret2": dict(decode_strategy="greedy_search",
                        num_return_sequences=2),
    "beam_ret2": dict(decode_strategy="beam_search", num_beams=4,
                      num_return_sequences=2, num_beam_groups=2,
                      diversity_rate=0.5),
}


@pytest.mark.parametrize("case", sorted(MODULE_CASES))
def test_generation_module_matches_jax(tiny, case):
    jparams, tparams = tiny
    cfg = {"Model": dict(MODEL, module="GPTGenerationModule"),
           "Generation": dict(max_dec_len=6, eos_token_id=96,
                              pad_token_id=PAD, **MODULE_CASES[case])}
    want = JGenModule(cfg).generate_ids(jparams, PROMPTS,
                                        jax.random.PRNGKey(0))
    module = build_module(cfg)
    assert isinstance(module, GPTGenerationModule)
    got = module.generate_ids(tparams, PROMPTS)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert got.shape == (len(PROMPTS) * 2, 6)


def test_generation_module_rejects_unknown_strategy():
    with pytest.raises(ValueError, match="decode_strategy"):
        GPTGenerationModule({"Model": dict(MODEL),
                             "Generation": {"decode_strategy": "nucleus"}})


# -------------------------------------------------------------------- CLI
TINY_OVERRIDES = [
    "Model.num_layers=2", "Model.hidden_size=64",
    "Model.num_attention_heads=4", "Model.vocab_size=512",
    "Model.max_position_embeddings=64", "Global.max_seq_len=64",
    "Model.dtype=float32", "Generation.max_dec_len=5",
    "Generation.eos_token_id=511", "Generation.pad_token_id=0",
    "Generation.input_text=Where is the README of this repository?"]


def _cli(*overrides):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "fleetx_tpu_torch.tasks.gpt.generation",
           "-c", GEN_YAML, "--device", "cpu"]
    for o in TINY_OVERRIDES + list(overrides):
        cmd += ["-o", o]
    return subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)


def test_generation_cli_prints_one_line_per_sample(tmp_path):
    """A trained tokenizer and a checkpoint of the tiny model: one printed
    line per returned sample; the params come from the checkpoint."""
    with open(os.path.join(REPO, "README.md")) as f:
        tok = train_bpe([f.read()], 400)
    tok.save_pretrained(str(tmp_path / "tok"))
    cfg = M.config_from_dict(dict(MODEL, vocab_size=512))
    params = M.init_params(cfg, seed=5)
    C.save_checkpoint(str(tmp_path / "ckpt"), 3,
                      C.flatten(params, "params/"))
    extra = [f"Generation.tokenizer_dir={tmp_path / 'tok'}",
             f"Engine.save_load.ckpt_dir={tmp_path / 'ckpt'}",
             "Generation.num_return_sequences=3",
             "Generation.decode_strategy=sampling"]
    out = _cli(*extra)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "restored params from" in out.stderr
    assert "RANDOM" not in out.stderr
    # a sample may itself hold a line break: the printed lines are the
    # three samples of the same seeded run, each followed by one newline
    samples = task.run(task.load_config(GEN_YAML, TINY_OVERRIDES + extra),
                       device="cpu")
    assert len(samples) == 3
    assert out.stdout == "".join(f"{t}\n" for t in samples)


def test_generation_cli_without_tokenizer_or_checkpoint(tmp_path):
    """No tokenizer: ids per line; no checkpoint configured: the
    random-weights warning."""
    out = _cli("Generation.tokenizer_dir=", "Generation.input_text=5 6 7",
               "Generation.decode_strategy=greedy_search")
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert len(lines) == 1 and len(lines[0].split()) == 5
    assert "RANDOM weights" in out.stderr


def test_generation_yaml_loads_through_the_base_chain():
    cfg = task.load_config(GEN_YAML)
    assert cfg["Model"]["module"] == "GPTGenerationModule"
    assert cfg["Model"]["num_layers"] == 24
    assert cfg["Generation"]["top_k"] == 50
    assert cfg["Generation"]["top_p"] == 0.75
    assert cfg["Engine"]["save_load"]["save_steps"] == 1000
    module = GPTGenerationModule(cfg)
    assert module.gen_cfg.do_sample and not module.use_beam_search
    assert module.gen_cfg.max_new_tokens == 64


def test_task_refuses_a_checkpoint_that_does_not_verify(tmp_path):
    """A configured checkpoint that is there but fails its digests raises:
    no fresh weights in its place."""
    cfg = M.config_from_dict(dict(MODEL, vocab_size=512))
    C.save_checkpoint(str(tmp_path), 1,
                      C.flatten(M.init_params(cfg, seed=0), "params/"))
    path = tmp_path / "step_1" / C.STATE_NAME
    data = bytearray(path.read_bytes())
    data[len(data) // 2] ^= 0xFF
    path.write_bytes(bytes(data))
    run_cfg = task.load_config(GEN_YAML, TINY_OVERRIDES + [
        "Generation.tokenizer_dir=", f"Engine.save_load.ckpt_dir={tmp_path}"])
    with pytest.raises(C.CheckpointIntegrityError):
        task.build(run_cfg, device="cpu")
