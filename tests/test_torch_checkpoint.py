"""Port parity: checkpoints (``fleetx_tpu_torch/core/checkpoint.py``,
``resilience/integrity.py``, the engine's save / load / resume,
``tools/verify_ckpt.py``, the sampler rewind and the AdamW flat state).

The trainer is the synthetic recipe shrunk to the tiny config of
``tests/test_torch_train.py`` (hidden 128, 2 layers, 2 heads of 64, seq
128, vocab 256, f32, batch 2), on the CPU.

Tolerances: a resumed run's losses, params, moments, step count and
``consumed_samples`` equal the uninterrupted run's bit for bit (the same
ops on the same inputs: dropout is a function of seed and step). Against
the JAX ``EagerEngine.fit`` curve on converted weights (dropout 0) the
resumed losses agree within 1e-5. Digests are integers and must be
equal.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
from flax.core import meta

from fleetx_tpu.core.engine import EagerEngine as JEngine
from fleetx_tpu.core.module import GPTModule as JGPTModule
from fleetx_tpu.optims import lr_scheduler as JLR
from fleetx_tpu.optims import optimizer as JOPT
from fleetx_tpu.parallel.mesh import build_mesh
from fleetx_tpu.resilience import integrity as JI
from fleetx_tpu_torch.convert import params_from_jax
from fleetx_tpu_torch.core import checkpoint as C
from fleetx_tpu_torch.core.engine import EagerEngine
from fleetx_tpu_torch.core.module import GPTModule
from fleetx_tpu_torch.data.sampler.batch_sampler import GPTBatchSampler
from fleetx_tpu_torch.optims import lr_scheduler as TLR
from fleetx_tpu_torch.optims import optimizer as TOPT
from fleetx_tpu_torch.optims.optimizer import tree_leaves_with_path
from fleetx_tpu_torch.resilience import integrity as TI
from fleetx_tpu_torch.tools import serve as S
from fleetx_tpu_torch.tools import train as T
from fleetx_tpu_torch.tools import verify_ckpt as V
from fleetx_tpu_torch.utils.log import logger as port_logger

pytestmark = pytest.mark.torch_port


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """This file's tensors are tiny: torch runs them on one intra-op
    thread, and its default pool (one thread a core, on cores the other
    test workers share) costs ~50x on a ``[256, 64] @ [64, 192]`` matmul.
    The count is restored for the files after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GPT_DIR = os.path.join(REPO, "fleetx_tpu", "configs", "nlp", "gpt")
SYNTH_YAML = os.path.join(GPT_DIR, "pretrain_gpt_345M_synthetic.yaml")
SINGLE_YAML = os.path.join(GPT_DIR, "pretrain_gpt_345M_single_card.yaml")
VOCAB, SEQ = 256, 128
#: the synthetic recipe at the tiny size, dropout 0.1 kept
TINY = ["Engine.logging_freq=1", "Model.num_layers=2",
        "Model.hidden_size=128", "Model.num_attention_heads=2",
        f"Model.vocab_size={VOCAB}", f"Model.max_position_embeddings={SEQ}",
        f"Global.max_seq_len={SEQ}", "Model.dtype=float32",
        "Global.global_batch_size=2", "Global.local_batch_size=2",
        "Global.micro_batch_size=2", "Data.Train.dataset.num_samples=32",
        "Data.Train.loader.prefetch=0"]


@pytest.fixture()
def port_log(caplog):
    """``caplog`` wired to the port's logger (which does not propagate)."""
    port_logger.addHandler(caplog.handler)
    try:
        yield caplog
    finally:
        port_logger.removeHandler(caplog.handler)


def _trainer(out_dir, max_steps, *extra):
    cfg = T.load_config(SYNTH_YAML, TINY + [
        f"Engine.max_steps={max_steps}",
        f"Engine.save_load.output_dir={out_dir}", *extra])
    return T.build_trainer(cfg, device="cpu")


def _fit(out_dir, max_steps, *extra):
    engine, train_dl, _ = _trainer(out_dir, max_steps, *extra)
    return engine, engine.fit(train_dl)


def _flat_state(engine) -> dict:
    """Copies of every tensor and scalar the checkpoint holds."""
    out = {}
    for k, v in engine.state_dict().items():
        out[k] = v.detach().clone() if torch.is_tensor(v) else v
    return out


def _assert_bitwise(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for k in a:
        if torch.is_tensor(a[k]):
            assert a[k].dtype == b[k].dtype, k
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The uninterrupted 6-step run, the 3-step run that saved, and the
    run resumed from it to step 6, each a fresh engine."""
    root = tmp_path_factory.mktemp("ckpt_runs")
    full, full_losses = _fit(root / "full", 6)
    saved, saved_losses = _fit(root / "saved", 3,
                               "Engine.save_load.save_steps=3")
    saved_state = _flat_state(saved)
    resumed, train_dl, _ = _trainer(
        root / "saved", 6, "Engine.save_load.save_steps=3",
        f"Engine.save_load.ckpt_dir={root / 'saved'}")
    resumed.prepare()
    restored_state = _flat_state(resumed)
    restored_consumed = resumed.consumed_samples
    resumed_losses = resumed.fit(train_dl)
    return dict(root=root, full=full, full_losses=full_losses,
                saved=saved, saved_losses=saved_losses,
                saved_state=saved_state, restored_state=restored_state,
                restored_consumed=restored_consumed, resumed=resumed,
                resumed_losses=resumed_losses)


def test_resumed_losses_equal_the_uninterrupted_run_bitwise(runs):
    assert len(runs["full_losses"]) == 6
    assert runs["saved_losses"] == runs["full_losses"][:3]
    assert runs["resumed_losses"] == runs["full_losses"][3:]
    assert [h["global_step"] for h in runs["resumed"].history] == [4, 5, 6]
    _assert_bitwise(_flat_state(runs["resumed"]), _flat_state(runs["full"]))
    assert runs["resumed"].consumed_samples == \
        runs["full"].consumed_samples == 12


def test_restore_brings_back_state_and_consumed_samples_bitwise(runs):
    """Params, AdamW ``count`` / ``mu`` / ``nu`` / decay flags, the step
    (the LR schedule's input) and ``consumed_samples``."""
    restored, saved = runs["restored_state"], runs["saved_state"]
    _assert_bitwise(restored, saved)
    assert restored["step"] == 3 and restored["opt_state/count"] == 3
    assert runs["restored_consumed"] == runs["saved"].consumed_samples == 6
    lr = runs["resumed"].lr_schedule
    assert lr(restored["opt_state/count"]) == lr(3)
    saved_dir = str(runs["root"] / "saved")
    assert C.completed_steps(saved_dir) == [3, 6]
    assert C.peek_meta(saved_dir) == {"consumed_samples": 12, "epoch": 0,
                                      "seed": 1024, "step": 6}


def test_checkpoint_layout_and_manifest(runs):
    step = runs["root"] / "saved" / "step_3"
    assert sorted(os.listdir(step)) == ["fleetx_integrity.json",
                                       "fleetx_meta.json", "state.npz"]
    manifest = json.loads((step / "fleetx_integrity.json").read_text())
    assert manifest["version"] == 1
    assert list(manifest["files"]) == ["state.npz"]
    with np.load(step / "state.npz") as data:
        names = list(data["__names__"])
        assert len(manifest["leaves"]) == len(names)
        assert names[0] == "step" and "params/gpt/ln_f/scale" in names
        assert "opt_state/mu/gpt/layers/attn/qkv_kernel" in names
        for i, want in enumerate(manifest["leaves"]):
            assert TI.digest_array(data[f"leaf_{i}"])["crc32"] == \
                want["crc32"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int64", "bool"])
def test_flat_state_round_trip_is_bitwise(tmp_path, dtype):
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((3, 5), generator=gen) * 1e3
    leaf = {"float32": x, "bfloat16": x.to(torch.bfloat16),
            "int64": x.to(torch.int64), "bool": x > 0}[dtype]
    state = {"a/b": leaf, "count": 7, "flags": [True, False, True]}
    C.save_checkpoint(str(tmp_path), 2, state, meta={"x": 1})
    got, meta_d = C.load_checkpoint(str(tmp_path), 2)
    assert meta_d == {"x": 1, "step": 2}
    assert got["a/b"].dtype == leaf.dtype and torch.equal(got["a/b"], leaf)
    assert int(got["count"]) == 7
    assert got["flags"].tolist() == [True, False, True]


def _flip_byte(path, offset=None):
    size = os.path.getsize(path)
    offset = size // 2 if offset is None else offset
    with open(path, "r+b") as f:
        f.seek(offset)
        byte = f.read(1)
        f.seek(offset)
        f.write(bytes([byte[0] ^ 0xFF]))


def _two_steps(tmp_path):
    """A checkpoint directory with steps 2 and 4 of the tiny trainer."""
    out = tmp_path / "ckpt"
    engine, _ = _fit(out, 4, "Engine.save_load.save_steps=2")
    return out, engine


def test_flipped_byte_is_refused_and_load_falls_back(tmp_path, port_log):
    out, engine = _two_steps(tmp_path)
    _flip_byte(out / "step_4" / "state.npz")
    with pytest.raises(C.CheckpointIntegrityError, match="state.npz"):
        C.load_checkpoint(str(out), 4)
    assert C.latest_verified_step(str(out)) == 2
    assert C.peek_meta(str(out))["step"] == 2
    resumed, _, _ = _trainer(out, 6, f"Engine.save_load.ckpt_dir={out}")
    resumed.prepare()
    assert resumed.step == 2 and resumed.consumed_samples == 4
    assert "refusing checkpoint step 4" in port_log.text
    assert "falling back past corrupt checkpoint step 4" in port_log.text
    _flip_byte(out / "step_2" / "state.npz")
    again, _, _ = _trainer(out, 6, f"Engine.save_load.ckpt_dir={out}")
    with pytest.raises(RuntimeError, match=r"refused steps: \[4, 2\]"):
        again.prepare()


def test_leaf_digest_mismatch_is_refused(tmp_path):
    """A payload whose file digest was rewritten to match still fails on
    its leaf digests."""
    C.save_checkpoint(str(tmp_path), 1, {"w": torch.ones(4)})
    path = tmp_path / "step_1"
    with np.load(path / "state.npz") as data:
        arrays = {k: data[k] for k in data.files}
    arrays["leaf_0"] = arrays["leaf_0"] * 2
    np.savez(path / "state.npz", **arrays)
    manifest = json.loads((path / "fleetx_integrity.json").read_text())
    manifest["files"] = TI.file_digests(str(path))
    (path / "fleetx_integrity.json").write_text(json.dumps(manifest))
    with pytest.raises(C.CheckpointIntegrityError, match="leaf 0"):
        C.load_checkpoint(str(tmp_path), 1)
    assert V.audit_directory(str(tmp_path))["steps"][0][
        "mismatched_leaves"] == [0]


def test_dir_without_meta_is_ignored_and_cleaned_at_next_save(tmp_path):
    C.save_checkpoint(str(tmp_path), 1, {"w": torch.ones(2)})
    half = tmp_path / "step_2"
    half.mkdir()
    (half / "state.npz").write_bytes(b"torn")
    assert C.completed_steps(str(tmp_path)) == [1]
    assert C.latest_step(str(tmp_path)) == 1
    assert V.audit_directory(str(tmp_path))["steps"][1]["status"] == \
        "incomplete"
    C.save_checkpoint(str(tmp_path), 2, {"w": torch.zeros(2)})
    assert C.completed_steps(str(tmp_path)) == [1, 2]
    got, _ = C.load_checkpoint(str(tmp_path), 2)
    assert torch.equal(got["w"], torch.zeros(2))


def test_step_dirs_lists_every_step_dir_in_step_order(tmp_path):
    for step in (10, 2):
        C.save_checkpoint(str(tmp_path), step, {"w": torch.ones(1)})
    for name in ("step_7", "step_x", "other"):
        (tmp_path / name).mkdir()
    assert C.step_dirs(str(tmp_path)) == [
        (s, os.path.join(str(tmp_path), f"step_{s}")) for s in (2, 7, 10)]
    assert C.completed_steps(str(tmp_path)) == [2, 10]
    assert [r["step"] for r in V.audit_directory(str(tmp_path))["steps"]] \
        == [2, 7, 10]
    assert C.step_dirs(str(tmp_path / "missing")) == []


def test_keep_last_never_prunes_the_newest_step(tmp_path):
    for step in range(1, 7):
        C.save_checkpoint(str(tmp_path), step, {"w": torch.ones(1)})
    assert C.gc_checkpoints(str(tmp_path), keep_last=0) == 5
    assert C.completed_steps(str(tmp_path)) == [6]
    for step in range(1, 6):
        C.save_checkpoint(str(tmp_path), step, {"w": torch.ones(1)})
    assert C.gc_checkpoints(str(tmp_path), keep_last=2, keep_every=3) == 3
    assert C.completed_steps(str(tmp_path)) == [3, 5, 6]


def test_engine_retention_keeps_the_newest_steps(tmp_path):
    out = tmp_path / "ckpt"
    engine, _ = _fit(out, 3, "Engine.save_load.save_steps=1",
                     "Engine.save_load.keep_last=2")
    assert C.completed_steps(str(out)) == [2, 3]
    assert engine.last_saved_step == 3


BLOBS = [b"", b"fleetx", bytes(range(256)) * 17]


def test_leaf_verification_equals_the_reference(tmp_path):
    """``verify_leaves`` / ``verify_npz_leaves`` / ``verify_checkpoint_dir``
    against the JAX package's on the same arrays and the same payload."""
    rng = np.random.RandomState(0)
    arrays = [rng.randn(4, 3).astype(np.float32), np.arange(7),
              np.ones((2, 2), bool)]
    digests = [TI.digest_array(a) for a in arrays]
    changed = [arrays[0], arrays[1] + 1, arrays[2].astype(np.float32)]
    for got in (arrays, changed):
        assert TI.verify_leaves(got, digests) == \
            JI.verify_leaves(got, digests)
    assert TI.verify_leaves(changed, digests) == [1]  # 2 was recast
    C.save_checkpoint(str(tmp_path), 1, {f"a{i}": a
                                         for i, a in enumerate(arrays)})
    path = str(tmp_path / "step_1")
    manifest = TI.read_manifest(path)
    assert TI.verify_npz_leaves(path, manifest["leaves"]) == \
        JI.verify_npz_leaves(path, manifest["leaves"]) == []
    assert TI.verify_checkpoint_dir(path) == JI.verify_checkpoint_dir(path)
    _flip_byte(tmp_path / "step_1" / "state.npz")
    assert TI.verify_checkpoint_dir(path) == JI.verify_checkpoint_dir(path)
    assert TI.verify_checkpoint_dir(path)["status"] == "corrupt"


@pytest.mark.parametrize("blob", BLOBS, ids=["empty", "word", "ramp"])
def test_digests_equal_the_reference(blob):
    assert TI.digest_bytes(blob) == JI.digest_bytes(blob)
    assert TI.digest_bytes(blob, 7) == JI.digest_bytes(blob, 7)
    arr = np.frombuffer(blob, np.uint8)
    assert TI.digest_array(arr) == JI.digest_array(arr)
    f32 = np.random.RandomState(len(blob)).randn(3, 4).astype(np.float32)
    assert TI.digest_array(f32) == JI.digest_array(f32)
    assert TI.digest_array(f32.T) == JI.digest_array(f32.T)


def _reference_verify(directory):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "verify_ckpt.py"),
         str(directory), "--json", "-"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120)


def test_reference_auditor_audits_a_port_checkpoint(tmp_path):
    """``tools/verify_ckpt.py`` of the JAX package, as its own process:
    ``ok`` with every leaf decoded, then ``corrupt`` after a byte flip."""
    state = {"params/w": torch.randn(64, 8), "opt_state/count": 3,
             "params/b": torch.randn(8).to(torch.bfloat16)}
    C.save_checkpoint(str(tmp_path), 5, state)
    out = _reference_verify(tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    report = json.loads(out.stdout)
    assert [s["status"] for s in report["steps"]] == ["ok"]
    assert report["steps"][0]["leaves_checked"] == 3
    _flip_byte(tmp_path / "step_5" / "state.npz")
    out = _reference_verify(tmp_path)
    assert out.returncode == 1, out.stderr[-2000:]
    step = json.loads(out.stdout)["steps"][0]
    assert step["status"] == "corrupt"
    assert step["mismatched_files"] == ["state.npz"]


def test_port_auditor_statuses_and_exit_codes(tmp_path, capsys):
    assert V.main([str(tmp_path / "none")]) == 2
    for step in (1, 2, 3):
        C.save_checkpoint(str(tmp_path), step, {"w": torch.ones(3) * step})
    os.remove(tmp_path / "step_2" / TI.MANIFEST_NAME)
    os.remove(tmp_path / "step_3" / C.META_NAME)
    assert V.main([str(tmp_path), "--json", "-"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert [s["status"] for s in report["steps"]] == \
        ["ok", "unverified", "incomplete"]
    _flip_byte(tmp_path / "step_1" / "state.npz")
    assert V.main([str(tmp_path)]) == 1
    assert "corrupt" in capsys.readouterr().out
    assert V.main([str(tmp_path), "--step", "2"]) == 0
    json_path = tmp_path / "report.json"
    assert V.main([str(tmp_path), "--step", "1", "--json",
                   str(json_path)]) == 1
    assert json.loads(json_path.read_text())["steps"][0]["status"] == \
        "corrupt"


def test_sampler_resumes_at_consumed_samples():
    """The batch after a resume is the one the uninterrupted stream takes
    next."""
    full = list(GPTBatchSampler(40, 4, consumed_samples=0))
    for consumed in (0, 4, 12, 36):
        assert list(GPTBatchSampler(40, 4, consumed_samples=consumed)) == \
            full[consumed // 4:]
    two = GPTBatchSampler(40, 2, num_replicas=2, rank=1, consumed_samples=8)
    assert next(iter(two)) == [10, 11]


def test_adamw_flat_state_round_trip_is_bitwise():
    rng = np.random.RandomState(0)
    params = {"gpt": {"w_kernel": torch.tensor(rng.randn(4, 3)),
                      "ln": {"scale": torch.tensor(rng.randn(3))}}}
    opt = TOPT.AdamW(lambda t: 1e-2)
    state = opt.init(params)
    leaves = [p for _, p in tree_leaves_with_path(params)]
    for _ in range(3):
        opt.update(leaves, [torch.tensor(rng.randn(*p.shape))
                            for p in leaves], state)
    flat = {k: (v.clone() if torch.is_tensor(v) else v)
            for k, v in TOPT.AdamW.flat_state(state, params).items()}
    assert sorted(flat) == ["count", "decay", "mu/gpt/ln/scale",
                            "mu/gpt/w_kernel", "nu/gpt/ln/scale",
                            "nu/gpt/w_kernel"]
    fresh = opt.init(params)
    TOPT.AdamW.load_flat_state(fresh, flat, params)
    assert fresh["count"] == 3 and fresh["decay"] == [True, False]
    for key in ("mu", "nu"):
        for a, b in zip(fresh[key], state[key]):
            assert torch.equal(a, b)
    flat["mu/gpt/w_kernel"] = torch.zeros(2)
    with pytest.raises(ValueError, match="mu/gpt/w_kernel"):
        TOPT.AdamW.load_flat_state(fresh, flat, params)


def test_save_steps_from_the_base_yaml_no_longer_raises():
    cfg = T.load_config(SINGLE_YAML, TINY + [
        "Data.Train.dataset.name=SyntheticGPTDataset",
        "Data.Train.dataset.num_samples=8", "Engine.eval_freq=0"])
    assert cfg["Engine"]["save_load"]["save_steps"] == 1000
    engine, _, _ = T.build_trainer(cfg, device="cpu")
    assert engine.save_steps == 1000 and engine.ckpt_dir is None


def test_run_saves_the_final_step_once(tmp_path):
    cfg = T.load_config(SYNTH_YAML, TINY + [
        "Engine.max_steps=3", "Engine.save_load.save_steps=2",
        f"Engine.save_load.output_dir={tmp_path}"])
    engine, _ = T.run(cfg, device="cpu")
    assert C.completed_steps(str(tmp_path)) == [2, 3]
    assert engine.last_saved_step == 3


def test_empty_ckpt_dir_warns_and_starts_fresh(tmp_path, port_log):
    engine, _, _ = _trainer(tmp_path / "out", 1,
                            f"Engine.save_load.ckpt_dir={tmp_path / 'none'}")
    engine.prepare()
    assert engine.step == 0 and "no completed checkpoint" in port_log.text


def test_serving_replica_loads_params_from_ckpt_dir(tmp_path):
    """``Serving.ckpt_dir``: the replica's params are the checkpoint's,
    verified; a missing checkpoint raises instead of serving seeded
    weights."""
    model = dict(vocab_size=97, hidden_size=64, num_layers=2,
                 num_attention_heads=4, max_position_embeddings=64,
                 hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                 dtype="float32", param_dtype="float32")
    module = GPTModule({"Model": model})
    params = module.init_params(3, "cpu")
    C.save_checkpoint(str(tmp_path), 7, C.flatten(params, "params/"))
    cfg = {"Model": model, "Global": {"seed": 0},
           "Serving": dict(max_batch=2, page_size=4, num_pages=17,
                           max_seq_len=32, prefill_chunk=8,
                           ckpt_dir=str(tmp_path)),
           "Generation": {"decode_strategy": "greedy_search",
                          "eos_token_id": 96, "pad_token_id": 0}}
    engine = S.build_engine(cfg, device="cpu")
    for (_, a), (_, b) in zip(tree_leaves_with_path(engine.params),
                              tree_leaves_with_path(params)):
        assert torch.equal(a, b)
    cfg["Serving"]["ckpt_dir"] = str(tmp_path / "empty")
    with pytest.raises(FileNotFoundError, match="no completed checkpoint"):
        S.build_engine(cfg, device="cpu")
    _flip_byte(tmp_path / "step_7" / "state.npz")
    cfg["Serving"]["ckpt_dir"] = str(tmp_path)
    with pytest.raises(C.CheckpointIntegrityError):
        S.build_engine(cfg, device="cpu")


# ------------------------------------------------ against the JAX engine
MODEL = dict(vocab_size=VOCAB, hidden_size=128, num_layers=2,
             num_attention_heads=2, max_position_embeddings=SEQ,
             hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
             use_flash_attention=True, flash_fused_bwd=True,
             fused_residual_norm=True, use_recompute=False,
             dtype="float32", param_dtype="float32")
PLAIN = dict(MODEL, use_flash_attention=False, fused_residual_norm=False)


def _engine_cfg(n: int, **save_load) -> dict:
    return {"Model": dict(MODEL),
            "Engine": {"max_steps": n, "logging_freq": 1, "eval_freq": 0,
                       "save_load": save_load},
            "Global": {"seed": 7},
            "Optimizer": {"name": "AdamW", "grad_clip": {"clip_norm": 1.0},
                          "lr": {"max_lr": 1e-3, "warmup_steps": 2,
                                 "decay_steps": 100}}}


def _engine(cfg: dict) -> EagerEngine:
    lr = TLR.build_lr_scheduler(cfg["Optimizer"]["lr"])
    return EagerEngine(cfg, GPTModule(cfg),
                       optimizer=TOPT.build_optimizer(cfg["Optimizer"], lr),
                       lr_schedule=lr, device="cpu")


def _batches(n: int, seed: int = 4) -> list:
    rng = np.random.RandomState(seed)
    return [{"tokens": rng.randint(0, VOCAB, (2, SEQ)).astype(np.int32),
             "position_ids": np.broadcast_to(
                 np.arange(SEQ, dtype=np.int32), (2, SEQ)).copy(),
             "labels": rng.randint(0, VOCAB, (2, SEQ)).astype(np.int32),
             "loss_mask": (rng.rand(2, SEQ) > 0.1).astype(np.float32)}
            for _ in range(n)]


def test_resumed_curve_matches_the_jax_engine(devices8, tmp_path):
    """Save at step 3 of 6 and resume in a fresh engine on converted JAX
    weights: the port's resumed losses 4-6 against the JAX engine's
    uninterrupted ``fit`` curve."""
    n = 6
    batches = _batches(n)
    cfg = _engine_cfg(n)
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

    first = _engine(_engine_cfg(3, save_steps=3, output_dir=str(tmp_path)))
    first.params = params_from_jax(init, first.module.model_cfg)
    head = first.fit(batches[:3])
    second = _engine(_engine_cfg(n, ckpt_dir=str(tmp_path),
                                 output_dir=str(tmp_path)))
    tail = second.fit(batches[3:])
    assert second.step == n and len(tail) == 3
    np.testing.assert_allclose(head + tail, j_losses, rtol=0, atol=1e-5)
