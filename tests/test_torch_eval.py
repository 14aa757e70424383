"""Port parity: offline eval (``fleetx_tpu_torch/data/dataset/
eval_dataset.py``, ``GPTEvalModule`` and ``GPTModule.predict_step`` in
``core/module.py``, ``EagerEngine(mode="eval")`` with ``evaluate`` and
``predict``; ``python -m fleetx_tpu_torch.tools.eval`` as a process is
``tests/test_torch_eval_cli.py``).

The text is the repository's own (``docs/quick_start.md`` and
``docs/inference.md``), tokenized by a byte-level BPE that ``train_bpe``
fits to ``README.md`` (vocab 400); each package loads it with its own
tokenizer class. The model is the tiny f32 config of
``tests/test_torch_train.py`` with vocab 512 (hidden 128, 2 layers, 2
heads of 64, seq 128, dropout 0): the port runs its flash and norm
kernels' plain versions, the JAX side the same model without its Pallas
kernels, on weights converted by ``convert.params_from_jax``.

Tolerances: dataset samples exactly; ppl, loss and acc within 1e-5
(relative for ppl, absolute for loss and acc); the engine's ``evaluate``
within 1e-5 and ``predict``'s logits atol 1e-4 (the bound of
``tests/test_torch_train.py``'s logits: two 2-layer stacks summed in
another order).
"""

import json
import os

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
MODEL = dict(vocab_size=VOCAB, hidden_size=128, num_layers=2,
             num_attention_heads=2, max_position_embeddings=SEQ,
             hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
             use_flash_attention=True, fused_residual_norm=True,
             dtype="float32", param_dtype="float32")
PLAIN = dict(MODEL, use_flash_attention=False, fused_residual_norm=False)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The tokenizer dir, the eval text and its cloze jsonl (the last word
    of each paragraph of five or more words is the target)."""
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


def _datasets(files, kind: str, seq: int = SEQ, overlap: int = 32):
    from fleetx_tpu.data.dataset import eval_dataset as jev
    from fleetx_tpu.data.tokenizers.gpt_tokenizer import \
        GPTTokenizer as JTokenizer
    from fleetx_tpu_torch.data.dataset import eval_dataset as ev
    from fleetx_tpu_torch.data.tokenizers.gpt_tokenizer import GPTTokenizer

    jtok = JTokenizer.from_pretrained(files["tok"])
    tok = GPTTokenizer.from_pretrained(files["tok"])
    if kind == "acc":
        return (ev.lambada_from_jsonl(files["jsonl"], tok, seq),
                jev.lambada_from_jsonl(files["jsonl"], jtok, seq))
    return (ev.lm_eval_from_text(files["txt"], tok, seq, overlap),
            jev.lm_eval_from_text(files["txt"], jtok, seq, overlap))


@pytest.mark.parametrize("kind, seq, overlap", [
    ("ppl", SEQ, 32), ("ppl", 256, 0), ("ppl", SEQ, 100), ("acc", SEQ, 0),
    ("acc", 32, 0)])
def test_eval_datasets_equal_jax(files, kind, seq, overlap):
    """Sliding windows (every target counted exactly once) and cloze
    samples, array for array."""
    ours, ref = _datasets(files, kind, seq, overlap)
    assert len(ours) == len(ref) > 3
    counted = 0.0
    for i in range(len(ours)):
        a, b = ours[i], ref[i]
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
        counted += a["loss_mask"].sum()
    if kind == "ppl":
        assert counted == len(ours.tokens) - 1


@pytest.fixture(scope="module")
def weights():
    """(jax params, port params) of the tiny model."""
    import jax
    from flax.core import meta

    from fleetx_tpu.core.module import GPTModule as JGPTModule
    from fleetx_tpu_torch.convert import params_from_jax
    from fleetx_tpu_torch.models.gpt import model as M

    batch = {"tokens": np.zeros((1, SEQ), np.int32),
             "position_ids": np.arange(SEQ, dtype=np.int32)[None]}
    jparams = meta.unbox(JGPTModule({"Model": dict(PLAIN)}).init_variables(
        jax.random.PRNGKey(3), batch))
    return jparams, params_from_jax(jax.device_get(jparams),
                                    M.config_from_dict(MODEL))


def _loader(ds, bs: int = 4):
    from fleetx_tpu_torch.data.dataloader import DataLoader
    from fleetx_tpu_torch.data.sampler.batch_sampler import \
        DistributedBatchSampler

    return DataLoader(ds, DistributedBatchSampler(
        len(ds), bs, num_replicas=1, rank=0, drop_last=False))


@pytest.mark.parametrize("kind", ["ppl", "acc"])
def test_run_offline_eval_matches_jax(files, weights, kind):
    from fleetx_tpu.core.module import GPTEvalModule as JEval
    from fleetx_tpu_torch.core.module import GPTEvalModule

    jparams, tparams = weights
    ours_ds, ref_ds = _datasets(files, kind)
    section = {"Offline_Eval": {"eval_type": kind}}
    got = GPTEvalModule(dict(section, Model=dict(MODEL))).run_offline_eval(
        tparams, _loader(ours_ds))
    want = JEval(dict(section, Model=dict(PLAIN))).run_offline_eval(
        jparams, _loader(ref_ds))
    assert got["token_count"] == want["token_count"] > 0
    assert got["rows"] == want["rows"] and got["correct"] == want["correct"]
    assert got["loss"] == pytest.approx(want["loss"], rel=0, abs=1e-5)
    assert got["ppl"] == pytest.approx(want["ppl"], rel=1e-5)
    assert ("acc" in got) == (kind == "acc") == ("acc" in want)
    if kind == "acc":
        assert got["acc"] == pytest.approx(want["acc"], abs=1e-5)


def _batches(n: int, seed: int = 6) -> list:
    rng = np.random.RandomState(seed)
    return [{"tokens": rng.randint(0, VOCAB, (2, SEQ)).astype(np.int32),
             "position_ids": np.broadcast_to(
                 np.arange(SEQ, dtype=np.int32), (2, SEQ)).copy(),
             "labels": rng.randint(0, VOCAB, (2, SEQ)).astype(np.int32),
             "loss_mask": (rng.rand(2, SEQ) > 0.1).astype(np.float32)}
            for _ in range(n)]


def test_eval_engine_evaluate_and_predict_match_jax(weights, devices8):
    """``EagerEngine(mode="eval")``: no optimizer, nothing requires grad;
    ``evaluate`` and ``predict`` against the JAX engine's ``evaluate`` and
    ``predict`` on the same weights."""
    import jax
    from flax.core import meta

    from fleetx_tpu.core.engine import EagerEngine as JEngine
    from fleetx_tpu.core.module import GPTModule as JGPTModule
    from fleetx_tpu.parallel.mesh import build_mesh
    from fleetx_tpu_torch.convert import params_from_jax
    from fleetx_tpu_torch.core.engine import EagerEngine
    from fleetx_tpu_torch.core.module import GPTModule

    batches = _batches(3)
    cfg = {"Model": dict(MODEL), "Engine": {"eval_iters": 2}}
    j_cfg = dict(cfg, Model=dict(PLAIN))
    j_eng = JEngine(j_cfg, JGPTModule(j_cfg),
                    mesh=build_mesh({}, devices=devices8[:1]), mode="eval")
    j_eng.prepare(batches[0])
    init = jax.device_get(meta.unbox(j_eng.state.params))
    eng = EagerEngine(cfg, GPTModule(cfg), device="cpu", mode="eval")
    eng.params = params_from_jax(init, eng.module.model_cfg)
    assert eng.opt_state is None
    assert eng.evaluate(batches) == pytest.approx(j_eng.evaluate(batches),
                                                  rel=0, abs=1e-5)
    assert not any(p.requires_grad for p in jax.tree_util.tree_leaves(
        eng.params))
    got = eng.predict(batches, max_batches=2)
    want = j_eng.predict(batches, max_batches=2)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert a.shape == (2, SEQ, VOCAB)
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="mode"):
        EagerEngine(cfg, GPTModule(cfg), device="cpu", mode="serve")
