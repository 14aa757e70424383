"""Port parity: the LoRA fine-tune recipe (``fleetx_tpu_torch/finetune/``
against ``fleetx_tpu/finetune/``): 3 steps of ``recipe.finetune`` on both
sides, the adapter artifact across the two packages, the refusals, and a
bitwise resume.

Both sides start from the same weights: the JAX engine saves its seeded
base (Orbax, for the JAX recipe) and the same params go into a port
checkpoint (for the port recipe); the JAX ``LoRAGPTModule``'s injected
adapters are carried into the port engine through
``convert.params_from_jax``. Tiny config (vocab 128, hidden 64, 2 layers,
4 heads, seq 32, f32, dropout 0), one device on each side, the same numpy
batches, AdamW with a clip of 0.05, which every step's grad norm exceeds.

Tolerances (f32): losses within atol 1e-5 and grad norms within rtol
1e-5 (the same math in another library: measured ~1e-7); the adapters
after 3 steps within rtol 1e-6 and atol 1e-3 x the learning rate, a
thousandth of one step: the grads come from two libraries, and where a
clipped grad is near Adam's epsilon the step ``g / (|g| + eps)`` turns
their ~1e-6 relative difference into ~1e-4 of a step (measured: 1.4e-4);
merged trees from either package's artifact within 1e-6 relative to each
leaf's largest magnitude (a rank-4 product summed by another library);
the base leaves and the resumed run bit for bit.
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch
from flax.core import meta

from fleetx_tpu.core.engine import EagerEngine as JEngine
from fleetx_tpu.core import checkpoint as JCK
from fleetx_tpu.core.module import GPTModule as JGPTModule
from fleetx_tpu.finetune import checkpoint as JFT
from fleetx_tpu.finetune import lora as JL
from fleetx_tpu.finetune import recipe as JR
from fleetx_tpu.finetune.module import LoRAGPTModule as JLoRAModule
from fleetx_tpu.optims.lr_scheduler import build_lr_scheduler as j_lr
from fleetx_tpu.optims.optimizer import build_optimizer as j_opt
from fleetx_tpu.parallel import rules as R
from fleetx_tpu_torch.convert import params_from_jax
from fleetx_tpu_torch.core import checkpoint as C
from fleetx_tpu_torch.core.engine import EagerEngine
from fleetx_tpu_torch.finetune import checkpoint as TFT
from fleetx_tpu_torch.finetune import lora as TL
from fleetx_tpu_torch.finetune import recipe as TR
from fleetx_tpu_torch.finetune.module import LoRAGPTModule
from fleetx_tpu_torch.models.gpt.model import config_from_dict as t_config
from fleetx_tpu_torch.optims import build_lr_scheduler, build_optimizer
from fleetx_tpu_torch.resilience.integrity import CheckpointIntegrityError

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

TINY = dict(vocab_size=128, hidden_size=64, num_layers=2,
            num_attention_heads=4, max_position_embeddings=32,
            use_flash_attention=False, fused_residual_norm=False,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
            dtype="float32", param_dtype="float32")
RANK, ALPHA = 4, 8.0
CLIP = 0.05
LR = {"max_lr": 5e-3, "warmup_steps": 0, "decay_steps": 100}
OPT = {"name": "AdamW", "grad_clip": {"clip_norm": CLIP}}
STEPS = 3


def _batches(n: int, seed: int = 0, bs: int = 4, s: int = 32) -> list:
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        toks = rng.randint(0, 127, size=(bs, s + 1)).astype(np.int32)
        out.append({"tokens": toks[:, :-1],
                    "position_ids": np.broadcast_to(
                        np.arange(s, dtype=np.int32), (bs, s)).copy(),
                    "labels": toks[:, 1:],
                    "loss_mask": np.ones((bs, s), np.float32)})
    return out


def _ft_cfg(out_dir: str, base_dir: str, ad_dir: str, steps: int,
            **save_load) -> dict:
    return {"Model": dict(TINY, module="LoRAGPTModule"),
            "FineTune": {"base_ckpt": base_dir, "adapter_dir": ad_dir,
                         "lora": {"rank": RANK, "alpha": ALPHA}},
            "Engine": {"max_steps": steps, "logging_freq": 1,
                       "save_load": dict(output_dir=out_dir, **save_load)},
            "Global": {"seed": 11}, "Optimizer": dict(OPT, lr=LR)}


def _port_engine(cfg: dict, init: dict) -> EagerEngine:
    """A port fine-tune engine on the CPU starting from ``init`` (a
    numpy tree with adapters)."""
    lr = build_lr_scheduler(LR)
    eng = EagerEngine(cfg, LoRAGPTModule(cfg), optimizer=TL.lora_optimizer(
        build_optimizer(OPT, lr)), lr_schedule=lr, device="cpu")
    eng.params = params_from_jax(init, eng.module.model_cfg)
    return eng


@pytest.fixture(scope="module")
def runs(tmp_path_factory, devices8):
    """The JAX recipe and the port recipe, 3 steps each from the same
    base, adapters and batches."""
    from fleetx_tpu.parallel.mesh import build_mesh

    tmp = tmp_path_factory.mktemp("lora_port")
    mesh = build_mesh({}, devices=devices8[:1])
    j_base = str(tmp / "j_base")
    cfg = {"Model": dict(TINY),
           "Engine": {"max_steps": 1, "logging_freq": 1,
                      "save_load": {"output_dir": j_base}},
           "Global": {"seed": 7}}
    lr = j_lr(LR)
    pre = JEngine(cfg, JGPTModule(cfg), optimizer=j_opt({"name": "AdamW"},
                                                         lr),
                  lr_schedule=lr, mesh=mesh)
    batches = _batches(STEPS + 1)
    pre.prepare(batches[0])
    pre.save()
    base_np = jax.device_get(meta.unbox(pre.state.params))
    t_base = str(tmp / "t_base")
    tcfg = t_config(TINY)
    C.save_checkpoint(t_base, 0, dict(step=0, **C.flatten(
        params_from_jax(base_np, tcfg), "params/")))

    j_ad = str(tmp / "j_adapter")
    jcfg = _ft_cfg(str(tmp / "j_ft"), j_base, j_ad, STEPS)
    jmod = JLoRAModule(jcfg)
    j_eng = JEngine(jcfg, jmod, optimizer=JL.lora_optimizer(
        j_opt(OPT, lr)), lr_schedule=lr, mesh=mesh)
    JR.prepare_finetune(j_eng, batches[0], j_base)
    # host copies now: the donated train step deletes these buffers
    init = jax.device_get(meta.unbox(j_eng.state.params))
    j_norms = []
    emit = j_eng._emit_train_record

    def record(log_dict, metrics):
        j_norms.append(float(metrics["grad_norm"]))
        return emit(log_dict, metrics)

    j_eng._emit_train_record = record
    j_losses, j_path = JR.finetune(j_eng, iter(batches[:STEPS]),
                                   sample_batch=batches[0], base_dir=j_base,
                                   adapter_dir=j_ad)
    j_final = jax.device_get(meta.unbox(j_eng.state.params))

    t_ad = str(tmp / "t_adapter")
    t_eng = _port_engine(_ft_cfg(str(tmp / "t_ft"), t_base, t_ad, STEPS),
                         init)
    before = TL.base_leaf_digests(t_eng.params)
    t_losses, t_path = TR.finetune(t_eng, batches[:STEPS], base_dir=t_base,
                                   adapter_dir=t_ad)
    return dict(tmp=tmp, batches=batches, init=init, base_np=base_np,
                j_base=j_base, t_base=t_base, j_ad=j_ad, t_ad=t_ad,
                j_path=j_path, t_path=t_path, j_losses=j_losses,
                t_losses=t_losses, j_norms=j_norms, j_final=j_final,
                t_eng=t_eng, before=before)


def test_three_steps_match_the_jax_recipe(runs):
    """Losses and grad norms step for step, the clip triggered on every
    step; the grad norm is that of all grads (the base leaves' too)."""
    t_eng = runs["t_eng"]
    t_norms = [h["grad_norm"] for h in t_eng.history]
    assert len(runs["j_losses"]) == len(runs["t_losses"]) == STEPS
    np.testing.assert_allclose(runs["t_losses"], runs["j_losses"],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(t_norms, runs["j_norms"], rtol=1e-5)
    assert min(t_norms) > CLIP and min(runs["j_norms"]) > CLIP
    assert t_eng.step == STEPS
    # the adapters moved as JAX's did
    want = dict(R.tree_leaf_names(runs["j_final"]))
    for name, leaf in C.flatten(t_eng.params).items():
        if TL.is_adapter_name(name):
            np.testing.assert_allclose(leaf.detach().numpy(), want[name],
                                       rtol=1e-6, atol=1e-3 * LR["max_lr"],
                                       err_msg=name)
    # the moments exist for the adapters alone
    flat = t_eng.optimizer.flat_state(t_eng.opt_state, t_eng.params)
    assert sorted(k[3:] for k in flat if k.startswith("mu/")) == sorted(
        n for n in C.flatten(t_eng.params) if TL.is_adapter_name(n))


def test_base_bitwise_frozen_and_every_adapter_moved(runs):
    t_eng = runs["t_eng"]
    after = TL.base_leaf_digests(t_eng.params)
    assert after == runs["before"]
    TR.assert_base_frozen(runs["before"], after)
    for name, leaf in C.flatten(t_eng.params).items():
        if not TL.is_adapter_name(name):
            np.testing.assert_array_equal(
                leaf.detach().numpy(), dict(R.tree_leaf_names(
                    runs["base_np"]))[name], err_msg=name)
    start = dict(R.tree_leaf_names(runs["init"]))
    moved = [n for n, leaf in C.flatten(t_eng.params).items()
             if TL.is_adapter_name(n)
             and not np.array_equal(leaf.detach().numpy(), start[n])]
    assert len(moved) == 8, moved
    drifted = dict(after)
    name = sorted(drifted)[0]
    drifted[name] = dict(drifted[name], crc32=int(drifted[name]["crc32"]) ^ 1)
    with pytest.raises(RuntimeError, match=f"frozen-base violation: leaf "
                                           f"'{name}'"):
        TR.assert_base_frozen(drifted, after)


def _leafwise_close(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for name, leaf in got.items():
        w = np.asarray(want[name])
        err = np.abs(np.asarray(leaf) - w).max() / max(np.abs(w).max(),
                                                       1e-30)
        assert err <= 1e-6, (name, err)


def test_artifacts_cross_load_to_the_same_merged_tree(runs):
    """The port's artifact applied by JAX and by the port, and JAX's by
    both: each pair gives the same merged tree."""
    j_base = JCK.load_params(runs["j_base"])
    t_base = C.load_params(runs["t_base"])
    for ad_dir in (runs["t_ad"], runs["j_ad"]):
        j_merged = dict(R.tree_leaf_names(
            JFT.apply_adapter_checkpoint(j_base, ad_dir)))
        t_merged = {k: v.numpy() for k, v in C.flatten(
            TFT.apply_adapter_checkpoint(t_base, ad_dir)).items()}
        _leafwise_close(t_merged, j_merged)
    # the artifacts carry the same names, shapes and stamps
    t_ads, t_meta = TFT.load_adapter(runs["t_ad"])
    j_ads, j_meta = JFT.load_adapter(runs["j_ad"])
    assert {k: tuple(v.shape) for k, v in t_ads.items()} == \
        {k: tuple(v.shape) for k, v in j_ads.items()}
    for key in ("artifact", "spec_family", "spec_registry", "lora", "step"):
        assert t_meta[key] == j_meta[key], key
    assert {k: (v["crc32"], v["nbytes"]) for k, v in
            t_meta["base_leaves"].items()} == \
        {k: (v["crc32"], v["nbytes"]) for k, v in
         j_meta["base_leaves"].items()}
    # f32 adapters: 4 bytes a parameter plus the npz framing
    n = sum(int(np.prod(v.shape)) for v in t_ads.values())
    assert 4 * n < TFT.adapter_bytes(runs["t_path"]) < 4 * n + 8192


def test_the_auditors_read_the_port_artifact(runs):
    from fleetx_tpu_torch.tools import verify_ckpt

    report = verify_ckpt.audit_directory(runs["t_ad"])
    assert report["ok"] and [s["status"] for s in report["steps"]] == \
        ["ok"], report
    assert verify_ckpt.main([runs["j_ad"]]) == 0


def _copy_artifact(runs, name: str) -> tuple:
    src = os.path.dirname(runs["t_path"])
    dst = str(runs["tmp"] / name)
    shutil.copytree(src, dst)
    return dst, os.path.join(dst, os.path.basename(runs["t_path"]))


def test_refusals_name_what_drifted(runs):
    t_base = C.load_params(runs["t_base"])
    # a drifted base leaf, named
    drifted = {k: (v + 1e-3 if k == "gpt/embeddings/word_embeddings"
                   else v) for k, v in C.flatten(t_base).items()}
    with pytest.raises(TFT.AdapterDriftError,
                       match="word_embeddings.*drifted"):
        TFT.apply_adapter_checkpoint(C.unflatten(drifted), runs["t_ad"])
    # a base missing a leaf, and one with an extra leaf
    partial = dict(C.flatten(t_base))
    del partial["gpt/ln_f/bias"]
    with pytest.raises(TFT.AdapterDriftError, match="gpt/ln_f/bias"):
        TFT.apply_adapter_checkpoint(C.unflatten(partial), runs["t_ad"])
    # a corrupt payload, then no manifest at all
    dst, step = _copy_artifact(runs, "corrupt")
    payload = os.path.join(step, C.STATE_NAME)
    with open(payload, "r+b") as f:
        f.seek(os.path.getsize(payload) // 2)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0xFF]))
    with pytest.raises(CheckpointIntegrityError, match="integrity"):
        TFT.load_adapter(dst)
    os.remove(os.path.join(step, "fleetx_integrity.json"))
    with pytest.raises(CheckpointIntegrityError, match="manifest"):
        TFT.load_adapter(dst)
    # a wrong rule-table fingerprint: refused by the port and by JAX
    dst, step = _copy_artifact(runs, "fingerprint")
    meta_path = os.path.join(step, C.META_NAME)
    with open(meta_path) as f:
        meta_d = json.load(f)
    meta_d["spec_registry"] = "0" * 16
    with open(meta_path, "w") as f:
        json.dump(meta_d, f)
    with pytest.raises(TFT.AdapterDriftError, match="rule table"):
        TFT.apply_adapter_checkpoint(t_base, dst)
    with pytest.raises(JFT.AdapterDriftError, match="rule table"):
        JFT.load_adapter(dst)
    # a full checkpoint is not an adapter artifact
    with pytest.raises(TFT.AdapterDriftError, match="not an adapter"):
        TFT.load_adapter(runs["t_base"])


def test_graft_refuses_a_partial_or_foreign_base(runs):
    """Both directions, each naming the leaf, before any leaf is
    written."""
    eng = runs["t_eng"]
    snapshot = {k: v.detach().clone()
                for k, v in C.flatten(eng.params).items()}
    base = C.flatten(C.load_params(runs["t_base"]))
    partial = {k: v for k, v in base.items() if k != "gpt/ln_f/bias"}
    with pytest.raises(ValueError, match="'gpt/ln_f/bias' is absent from "
                                         "the pretrain"):
        TR.graft_base_params(eng, C.unflatten(partial))
    extra = dict(base, **{"gpt/extra": torch.zeros(3)})
    with pytest.raises(ValueError, match="carries leaf 'gpt/extra'"):
        TR.graft_base_params(eng, C.unflatten(extra))
    wide = {k: (torch.zeros(v.shape[0] + 1, *v.shape[1:])
                if k == "gpt/ln_f/scale" else v + 1.0)
            for k, v in base.items()}
    with pytest.raises(ValueError, match="'gpt/ln_f/scale'"):
        TR.graft_base_params(eng, C.unflatten(wide))
    for k, v in C.flatten(eng.params).items():
        assert torch.equal(v, snapshot[k]), k


def test_save_at_2_and_resume_to_4_is_bitwise_the_uninterrupted_run(runs):
    """The fine-tune state (base + adapters, the adapters' moments) saved
    at step 2 by the engine and resumed to step 4, the same base grafted
    again: losses and every parameter bit for bit those of 4 steps in one
    run."""
    tmp, batches, init = runs["tmp"], runs["batches"], runs["init"]
    full = _port_engine(_ft_cfg(str(tmp / "full"), runs["t_base"],
                                str(tmp / "full_ad"), 4), init)
    want, _ = TR.finetune(full, batches, base_dir=runs["t_base"],
                          adapter_dir=str(tmp / "full_ad"))
    out = str(tmp / "resume")
    head = _port_engine(_ft_cfg(out, runs["t_base"], str(tmp / "r_ad"), 2,
                                save_steps=2), init)
    first, _ = TR.finetune(head, batches[:2], base_dir=runs["t_base"],
                           adapter_dir=str(tmp / "r_ad"))
    assert C.completed_steps(out) == [2]
    state, _ = C.load_checkpoint(out, 2)
    assert not any(k.startswith("opt_state/mu/") and not TL.is_adapter_name(
        k) for k in state)
    tail = _port_engine(_ft_cfg(out, runs["t_base"], str(tmp / "r_ad"), 4,
                                save_steps=2, ckpt_dir=out), init)
    rest, path = TR.finetune(tail, batches[2:4], base_dir=runs["t_base"],
                             adapter_dir=str(tmp / "r_ad"))
    assert tail.step == 4 and first + rest == want
    for name, leaf in C.flatten(full.params).items():
        assert torch.equal(C.flatten(tail.params)[name], leaf), name
    assert os.path.basename(path) == "step_4"
