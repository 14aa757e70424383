"""Port parity: the real-corpus tools (``fleetx_tpu_torch/tools/
preprocess_data.py``, ``write_corpus``, ``build_blending_indices`` and
``BlendedDataset`` in ``data/dataset/gpt_dataset.py``, the blended entry
of ``data.build_dataset``) and a short training run on a corpus made from
the repository's own text.

The corpus: ``docs/*.md`` of this repository, tokenized by a byte-level
BPE that ``train_bpe`` fits to ``README.md`` (vocab 400), written by each
package's preprocessing tool run as its own process.

Tolerances: the preprocessing output byte for byte (``_ids.npy`` whole;
``_idx.npz`` member by member, since the zip container stamps each member
with the second it was written); blending indices and blended samples
exactly; the 3-step training curve against the JAX ``EagerEngine.fit``
on converted weights (f32, dropout 0) atol 1e-5, the bound
``tests/test_torch_checkpoint.py`` holds the resumed curve to.
"""

import glob
import json
import os
import subprocess
import sys
import zipfile

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
VOCAB, SEQ = 512, 128


@pytest.fixture(scope="module")
def tokenizer_dir(tmp_path_factory):
    from fleetx_tpu_torch.data.tokenizers.gpt_tokenizer import train_bpe

    with open(os.path.join(REPO, "README.md"), encoding="utf-8") as f:
        tok = train_bpe([f.read()], 400)
    out = str(tmp_path_factory.mktemp("tok"))
    tok.save_pretrained(out)
    return out


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The docs as plain text (blank lines split documents) and as jsonl
    (one document per line)."""
    root = tmp_path_factory.mktemp("corpus")
    text = "\n\n".join(open(p, encoding="utf-8").read()
                       for p in sorted(glob.glob(os.path.join(
                           REPO, "docs", "*.md"))))
    txt = root / "docs.txt"
    txt.write_text(text, encoding="utf-8")
    jsonl = root / "docs.jsonl"
    with open(jsonl, "w", encoding="utf-8") as f:
        for para in text.split("\n\n"):
            if para.strip():
                f.write(json.dumps({"text": para}) + "\n")
    return {"txt": str(txt), "jsonl": str(jsonl)}


def _run(cmd: list) -> None:
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    out = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]


def _preprocess(tool: list, src: str, tok: str, prefix: str) -> None:
    _run([sys.executable] + tool + [
        "--input", src, "--tokenizer", tok, "--output-prefix", prefix,
        "--workers", "2", "--append-eos"])


def _npz_members(path: str) -> dict:
    with zipfile.ZipFile(path) as z:
        return {name: z.read(name) for name in z.namelist()}


@pytest.fixture(scope="module")
def corpus(inputs, tokenizer_dir, tmp_path_factory):
    """The port's tool's output on the plain-text input: the prefix."""
    prefix = str(tmp_path_factory.mktemp("port") / "docs")
    _preprocess(["-m", "fleetx_tpu_torch.tools.preprocess_data",
                 "--device", "cpu"], inputs["txt"], tokenizer_dir, prefix)
    return prefix


@pytest.mark.parametrize("kind", ["txt", "jsonl"])
def test_preprocess_output_equals_the_root_tool(kind, inputs, tokenizer_dir,
                                                corpus, tmp_path):
    """The port's ``preprocess_data`` and the root ``tools/
    preprocess_data.py`` write the same bytes for the same input and
    tokenizer."""
    ref = str(tmp_path / "ref")
    _preprocess([os.path.join(REPO, "tools", "preprocess_data.py")],
                inputs[kind], tokenizer_dir, ref)
    port = corpus
    if kind != "txt":
        port = str(tmp_path / "port")
        _preprocess(["-m", "fleetx_tpu_torch.tools.preprocess_data",
                     "--device", "cpu"], inputs[kind], tokenizer_dir, port)
    with open(ref + "_ids.npy", "rb") as a, open(port + "_ids.npy",
                                                 "rb") as b:
        ref_ids, port_ids = a.read(), b.read()
    assert ref_ids == port_ids and len(ref_ids) > 20000
    assert _npz_members(ref + "_idx.npz") == _npz_members(port + "_idx.npz")


def test_write_corpus_equals_jax(tmp_path):
    from fleetx_tpu.data.dataset.gpt_dataset import write_corpus as jwrite
    from fleetx_tpu_torch.data import write_corpus

    rng = np.random.RandomState(0)
    docs = [list(rng.randint(0, 60000, n)) for n in (5, 300, 17, 1)]
    jwrite(str(tmp_path / "j"), docs)
    write_corpus(str(tmp_path / "t"), docs)
    assert (tmp_path / "j_ids.npy").read_bytes() == \
        (tmp_path / "t_ids.npy").read_bytes()
    assert _npz_members(str(tmp_path / "j_idx.npz")) == \
        _npz_members(str(tmp_path / "t_idx.npz"))


@pytest.mark.parametrize("weights, n", [([0.5, 0.5], 10), ([1.0, 3.0], 37),
                                        ([0.2, 0.3, 0.5], 101), ([1.0], 5)])
def test_blending_indices_equal_jax(weights, n):
    from fleetx_tpu.data.dataset.gpt_dataset import \
        build_blending_indices as jbuild
    from fleetx_tpu_torch.data.dataset.gpt_dataset import \
        build_blending_indices

    w = np.asarray(weights) / np.sum(weights)
    for got, want in zip(build_blending_indices(w, n), jbuild(w, n)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _blend_cfg(prefix: str) -> dict:
    child = {"name": "GPTDataset", "input_dir": prefix, "num_samples": 12,
             "seed": 3}
    return {"Train": {"dataset": {
        "name": "BlendedDataset", "weights": [0.25, 0.75],
        "num_samples": 20,
        "datasets": [dict(child, seed=3), dict(child, seed=5)]}}}


def test_blended_dataset_from_config_equals_jax(corpus):
    """``build_dataset`` with a ``BlendedDataset`` section: two GPTDatasets
    over the real corpus (different shuffles), mixed 1:3."""
    from fleetx_tpu.data import build_dataset as jbuild
    from fleetx_tpu_torch.data import BlendedDataset, build_dataset

    ours = build_dataset(_blend_cfg(corpus), "Train", seq_length=SEQ)
    ref = jbuild(_blend_cfg(corpus), "Train", seq_length=SEQ)
    assert isinstance(ours, BlendedDataset) and len(ours) == len(ref) == 20
    np.testing.assert_array_equal(ours.dataset_index, ref.dataset_index)
    np.testing.assert_array_equal(ours.dataset_sample_index,
                                  ref.dataset_sample_index)
    assert sorted(set(ours.dataset_index.tolist())) == [0, 1]
    for i in range(len(ours)):
        a, b = ours[i], ref[i]
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


MODEL = dict(vocab_size=VOCAB, hidden_size=128, num_layers=2,
             num_attention_heads=2, max_position_embeddings=SEQ,
             hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
             use_flash_attention=True, flash_fused_bwd=True,
             fused_residual_norm=True, use_recompute=False,
             dtype="float32", param_dtype="float32")
#: the JAX side runs the same model without its Pallas kernels (interpret
#: mode costs seconds a call on the CPU); the port runs its kernels'
#: plain versions
PLAIN = dict(MODEL, use_flash_attention=False, fused_residual_norm=False)


def test_training_on_the_real_corpus_matches_the_jax_engine(
        corpus, tokenizer_dir, devices8):
    """Three steps on batches of the preprocessed docs corpus (the port's
    ``GPTDataset`` and sampler; the JAX package's give the same batches),
    from converted weights: the port's losses against the JAX
    ``EagerEngine.fit``'s."""
    import jax
    from flax.core import meta

    from fleetx_tpu.core.engine import EagerEngine as JEngine
    from fleetx_tpu.core.module import GPTModule as JGPTModule
    from fleetx_tpu.data import build_dataloader as jloader
    from fleetx_tpu.optims import lr_scheduler as JLR
    from fleetx_tpu.optims import optimizer as JOPT
    from fleetx_tpu.parallel.mesh import build_mesh
    from fleetx_tpu_torch.convert import params_from_jax
    from fleetx_tpu_torch.core.engine import EagerEngine
    from fleetx_tpu_torch.core.module import GPTModule
    from fleetx_tpu_torch.data import build_dataloader
    from fleetx_tpu_torch.optims import lr_scheduler as TLR
    from fleetx_tpu_torch.optims import optimizer as TOPT

    from fleetx_tpu_torch.data.tokenizers.gpt_tokenizer import GPTTokenizer

    n = 3
    eos = GPTTokenizer.from_pretrained(tokenizer_dir).eos_token_id
    data = {"Train": {"dataset": {"name": "GPTDataset", "input_dir": corpus,
                                  "num_samples": 2 * n, "seed": 1234,
                                  "eos_id": eos},
                      "sampler": {"name": "GPTBatchSampler"}}}
    batches = list(build_dataloader(data, "Train", batch_size=2,
                                    seq_length=SEQ))
    ref_batches = list(jloader(data, "Train", batch_size=2,
                               seq_length=SEQ))
    assert len(batches) == len(ref_batches) == n
    for a, b in zip(batches, ref_batches):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert int(max(b["tokens"].max() for b in batches)) < VOCAB
    assert any((b["loss_mask"] == 0).any() for b in batches)  # eos docs

    cfg = {"Model": dict(MODEL),
           "Engine": {"max_steps": n, "logging_freq": 1, "eval_freq": 0},
           "Global": {"seed": 7},
           "Optimizer": {"name": "AdamW", "grad_clip": {"clip_norm": 1.0},
                         "lr": {"max_lr": 1e-3, "warmup_steps": 2,
                                "decay_steps": 100}}}
    j_cfg = dict(cfg, Model=dict(PLAIN))
    j_lr = JLR.build_lr_scheduler(cfg["Optimizer"]["lr"])
    j_eng = JEngine(j_cfg, JGPTModule(j_cfg),
                    optimizer=JOPT.build_optimizer(cfg["Optimizer"], j_lr),
                    lr_schedule=j_lr,
                    mesh=build_mesh({}, devices=devices8[:1]))
    j_eng.max_steps = n
    j_eng.prepare(batches[0])
    init = jax.device_get(meta.unbox(j_eng.state.params))
    j_losses = j_eng.fit(batches)

    lr = TLR.build_lr_scheduler(cfg["Optimizer"]["lr"])
    t_eng = EagerEngine(cfg, GPTModule(cfg),
                        optimizer=TOPT.build_optimizer(cfg["Optimizer"], lr),
                        lr_schedule=lr, device="cpu")
    t_eng.params = params_from_jax(init, t_eng.module.model_cfg)
    t_losses = t_eng.fit(batches)
    assert len(t_losses) == len(j_losses) == n
    assert all(np.isfinite(t_losses))
    np.testing.assert_allclose(t_losses, j_losses, rtol=0, atol=1e-5)
