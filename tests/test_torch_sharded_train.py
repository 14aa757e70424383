"""Port parity: the sharded GPT training step over a gang of ranks
(``parallel/sharding.py``, the gang paths of ``core/engine/eager_engine.py``,
the tensor- and sequence-parallel forward of ``models/gpt/model.py``, the
gang save of ``core/checkpoint.py``, ``tools.train`` as a gang member)
against the JAX package and against one rank of the port, on the CPU.

One module fixture starts a gang of 4 gloo processes (this file is their
worker: ``python tests/test_torch_sharded_train.py worker <dir>``, one
torch thread each) that runs every case in turn and writes its results as
JSON; while it runs, this process computes the JAX engine's one-device
loss curves (``tests/test_engine.py``'s tiny GPT, ERNIE's and ViT's tiny
models) and the port's one-rank runs.

Tolerances: against JAX rtol/atol 2e-4, the bound JAX holds its own
sharded runs to (``tests/test_engine.py``); against one rank of the port
with dropout on, the losses within 1e-5 and every dropout draw bit for
bit (each rank's draws placed at its blocks of the global tensor; ranks
that hold the same block agree bit for bit). Every subprocess has its own
deadline; nothing here asserts a timing.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GPT_YAMLS = os.path.join(REPO, "fleetx_tpu", "configs", "nlp", "gpt")
WORLD = 4
DEADLINE_S = 300
STEPS = 4
VOCAB, SEQ, BATCH = 128, 32, 8
#: ``tests/test_engine.py``'s tiny GPT (flash and the fused norm off on
#: the JAX side; the port's fused norm is its plain version on the CPU)
GPT_MODEL = dict(vocab_size=VOCAB, hidden_size=64, num_layers=2,
                 num_attention_heads=4, max_position_embeddings=SEQ,
                 hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                 use_flash_attention=False, dtype="float32",
                 param_dtype="float32")
GPT_LR = {"name": "cosine", "max_lr": 1e-3, "min_lr": 1e-4,
          "warmup_steps": 2, "decay_steps": 100}
GPT_OPT = {"name": "AdamW", "weight_decay": 0.01,
           "grad_clip": {"clip_norm": 1.0}}
ERNIE_MODEL = dict(module="ErnieModule", vocab_size=VOCAB, hidden_size=64,
                   num_layers=2, num_attention_heads=4,
                   max_position_embeddings=32, type_vocab_size=2,
                   hidden_dropout_prob=0.0,
                   attention_probs_dropout_prob=0.0, dtype="float32",
                   param_dtype="float32")
VIT_MODEL = {"module": "GeneralClsModule", "name": "ViT_tiny_patch16_224",
             "num_classes": 10, "image_size": 32, "patch_size": 8,
             "num_layers": 2, "hidden_size": 64, "num_attention_heads": 4,
             "drop_path_rate": 0.0, "dtype": "float32",
             "param_dtype": "float32",
             "loss": {"name": "ViTCELoss", "epsilon": 0.0001},
             "metric": {"name": "TopkAcc", "topk": [1, 5]}}
ENC_OPT = {"name": "AdamW", "weight_decay": 0.01,
           "grad_clip": {"clip_norm": 1.0}}
ENC_LR = {"name": "CosineAnnealingWithWarmupDecay", "max_lr": 1e-3,
          "min_lr": 1e-4, "warmup_steps": 1, "decay_steps": 100}
DROPOUT = dict(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)

#: case → (family, Distributed, Model overrides, extras). The ``jax``
#: cases are held to the JAX engine's one-device curve, the others to
#: one rank of the port.
JAX_CASES = {
    "dp2_mp2": ("gpt", {"dp_degree": 2, "mp_degree": 2}, {}, {}),
    "dp2_fsdp2_stage1": ("gpt", {"dp_degree": 2, "fsdp_degree": 2,
                                 "sharding": {"sharding_stage": 1}}, {}, {}),
    "dp2_fsdp2_stage2": ("gpt", {"dp_degree": 2, "fsdp_degree": 2,
                                 "sharding": {"sharding_stage": 2}}, {}, {}),
    "dp2_fsdp2_stage3": ("gpt", {"dp_degree": 2, "fsdp_degree": 2,
                                 "sharding": {"sharding_stage": 3}}, {}, {}),
    "dp2_fsdp2_overlap": ("gpt", {"dp_degree": 2, "fsdp_degree": 2,
                                  "sharding": {"sharding_stage": 2,
                                               "overlap_update": True}},
                          {}, {}),
    "mp4_sp": ("gpt", {"mp_degree": 4, "sequence_parallel": True},
               {"sequence_parallel": True}, {}),
    "mp2_qat": ("gpt", {"mp_degree": 2}, {}, {"qat": True}),
    "ernie_dp4": ("ernie", {"dp_degree": 4}, {}, {}),
    "vit_dp4": ("vit", {"dp_degree": 4}, {}, {}),
}
PORT_CASES = {
    "dropout_dp2_mp2": ("gpt", {"dp_degree": 2, "mp_degree": 2}, DROPOUT,
                        {"record": True}),
    "dropout_mp4_sp": ("gpt", {"mp_degree": 4, "sequence_parallel": True},
                       dict(DROPOUT, sequence_parallel=True),
                       {"record": True}),
    "dropout_overlap_update": (
        "gpt", {"dp_degree": 2, "fsdp_degree": 2,
                "sharding": {"sharding_stage": 2, "overlap_update": True}},
        DROPOUT, {"record": True}),
    "dropout_stage3_recompute": (
        "gpt", {"dp_degree": 2, "fsdp_degree": 2,
                "sharding": {"sharding_stage": 3}},
        dict(DROPOUT, use_recompute=True), {"record": True}),
    # seq 128 takes the flash kernels' plain versions: their hash keyed on
    # the global batch-head index
    "dropout_flash_dp2_mp2_sp": (
        "gpt", {"dp_degree": 2, "mp_degree": 2, "sequence_parallel": True},
        dict(DROPOUT, use_flash_attention=True, max_position_embeddings=128,
             sequence_parallel=True), {"seq": 128, "seeded": True}),
    "dropout_ernie_dp4": ("ernie", {"dp_degree": 4}, DROPOUT,
                          {"record": True}),
    "dropout_vit_dp4": ("vit", {"dp_degree": 4},
                        {"drop_rate": 0.1, "attn_drop_rate": 0.1,
                         "drop_path_rate": 0.1}, {"record": True}),
    "uneven_mask_dp4": ("gpt", {"dp_degree": 4}, {}, {"uneven": True}),
    "clip_dp2_mp2": ("gpt", {"dp_degree": 2, "mp_degree": 2}, {},
                     {"clip": 0.05}),
    "accumulate_dp2_fsdp2": ("gpt", {"dp_degree": 2, "fsdp_degree": 2,
                                     "sharding": {"sharding_stage": 2}},
                             {}, {"accumulate": 2, "uneven": True}),
}
#: the ZeRO placement cases: the per-rank moment shapes against JAX's
ZERO_CASES = {
    "fsdp4_stage1": {"fsdp_degree": 4, "sharding": {"sharding_stage": 1}},
    "fsdp2_mp2_stage2": {"fsdp_degree": 2, "mp_degree": 2,
                         "sharding": {"sharding_stage": 2}},
}
CKPT_DIST = {"dp_degree": 2, "mp_degree": 2}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ------------------------------------------------------------ batches
def _gpt_batches(n: int, seq: int = SEQ, uneven: bool = False,
                 seed: int = 0) -> list:
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        mask = np.ones((BATCH, seq), np.float32)
        if uneven:  # the rows of the data ranks count different tokens
            for r in range(BATCH):
                mask[r, (r * seq) // BATCH:] = 0.0 if r % 3 == 0 else 1.0
            mask[1] = 0.0
        out.append({
            "tokens": rng.randint(0, VOCAB, (BATCH, seq)).astype(np.int32),
            "position_ids": np.broadcast_to(np.arange(seq, dtype=np.int32),
                                            (BATCH, seq)).copy(),
            "labels": rng.randint(0, VOCAB, (BATCH, seq)).astype(np.int32),
            "loss_mask": mask})
    return out


def _ernie_batches(n: int, seed: int = 8) -> list:
    seq = 16
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        labels = rng.randint(0, VOCAB, (BATCH, seq)).astype(np.int32)
        labels[rng.rand(BATCH, seq) > 0.3] = -100
        mask = np.ones((BATCH, seq), np.int32)
        mask[0, seq - 5:] = 0
        out.append({
            "input_ids": rng.randint(0, VOCAB, (BATCH, seq)).astype(np.int32),
            "token_type_ids": (np.arange(seq) >= seq // 2).astype(
                np.int32)[None].repeat(BATCH, 0),
            "attention_mask": mask, "mlm_labels": labels,
            "next_sentence_labels": rng.randint(0, 2, BATCH).astype(
                np.int32)})
    return out


def _vit_batches(n: int, seed: int = 10) -> list:
    rng = np.random.RandomState(seed)
    return [{"images": rng.randn(BATCH, 32, 32, 3).astype(np.float32),
             "labels": rng.randint(0, 10, BATCH).astype(np.int32)}
            for _ in range(n)]


def _batches(family: str, extra: dict) -> list:
    if family == "ernie":
        return _ernie_batches(STEPS)
    if family == "vit":
        return _vit_batches(STEPS)
    return _gpt_batches(STEPS, seq=extra.get("seq", SEQ),
                        uneven=bool(extra.get("uneven")))


def _cfg(family: str, dist: dict, model: dict, extra: dict) -> dict:
    base = {"gpt": GPT_MODEL, "ernie": ERNIE_MODEL, "vit": VIT_MODEL}[family]
    cfg = {"Model": dict(base, **model),
           "Engine": {"max_steps": STEPS, "logging_freq": 1, "eval_freq": 0,
                      "accumulate_steps": extra.get("accumulate", 1)},
           "Global": {"seed": 7}, "Distributed": dict(dist)}
    if extra.get("qat"):
        cfg["Quantization"] = {"enable": True}
    return cfg


# ------------------------------------------------- one run of the port
def _module(family: str, cfg: dict):
    from fleetx_tpu_torch.core.module import GPTModule
    from fleetx_tpu_torch.models.ernie.module import ErnieModule
    from fleetx_tpu_torch.models.vision.module import GeneralClsModule

    return {"gpt": GPTModule, "ernie": ErnieModule,
            "vit": GeneralClsModule}[family](cfg)


def _port_engine(family: str, cfg: dict, clip=None, one_rank=False):
    from fleetx_tpu_torch.core.engine import EagerEngine
    from fleetx_tpu_torch.optims import build_lr_scheduler, build_optimizer
    from fleetx_tpu_torch.parallel.mesh import build_mesh

    opt_cfg = dict(GPT_OPT if family == "gpt" else ENC_OPT)
    if clip is not None:
        opt_cfg["grad_clip"] = {"clip_norm": clip}
    lr = build_lr_scheduler(GPT_LR if family == "gpt" else ENC_LR)
    # a mesh of one rank: a one-rank engine inside a gang's process
    mesh = build_mesh({}, world_size=1) if one_rank else None
    return EagerEngine(cfg, _module(family, cfg),
                       optimizer=build_optimizer(opt_cfg, lr),
                       lr_schedule=lr, device="cpu", mesh=mesh)


def _init_params(workdir: str, family: str):
    """The JAX init of ``family`` (converted, whole), from the npz the
    test wrote."""
    from fleetx_tpu_torch.core.checkpoint import unflatten

    path = os.path.join(workdir, f"init_{family}.npz")
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        return unflatten({k: torch.from_numpy(z[k]) for k in z.files})


def run_case(workdir: str, family: str, dist: dict, model: dict,
             extra: dict, one_rank: bool = False,
             init_key: str = None) -> dict:
    """One case's fit: losses, grad norms, the rank's moment shapes and
    (``record``) every dropout draw with its place in the global tensor."""
    from fleetx_tpu_torch.parallel import sharding as SH

    cfg = _cfg(family, {} if one_rank else dist, model, extra)
    if one_rank:
        cfg["Distributed"] = {}
    eng = _port_engine(family, cfg, clip=extra.get("clip"),
                       one_rank=one_rank)
    init = None if extra.get("seeded") else \
        _init_params(workdir, init_key or family)
    if init is not None:
        eng.params = init
    records = []
    orig = SH.global_rand

    def recording(shape, blocks, gen, device):
        u = orig(shape, blocks, gen, device)
        full = list(shape)
        for d, (_, total) in blocks.items():
            full[d] = total
        records.append((full, {int(d): int(o) for d, (o, _) in
                               blocks.items()}, u.numpy().copy()))
        return u

    if extra.get("record"):
        SH.global_rand = recording
    try:
        losses = eng.fit(_batches(family, extra))
    finally:
        SH.global_rand = orig
    out = {"losses": losses,
           "grad_norms": [r["grad_norm"] for r in eng.history]}
    if eng.opt_state is not None and "mu" in eng.opt_state:
        flat = eng.optimizer.flat_state(eng.opt_state, eng.params)
        out["moments"] = {k[3:]: list(v.shape) for k, v in flat.items()
                          if k.startswith("mu/")}
    out["records"] = records
    return out


def fit_saving_step_2(eng, out_dir: str) -> list:
    """The uninterrupted 4-step curve of a run that saves step 2 (and only
    step 2) under ``out_dir``."""
    batches = _gpt_batches(STEPS)
    eng.save_steps, eng.output_dir, eng.max_steps = 2, out_dir, 2
    losses = eng.fit(batches)
    eng.save_steps, eng.max_steps = 0, STEPS
    return losses + eng.fit(batches[2:])


# ------------------------------------------------------------ the worker
def _worker(workdir: str) -> None:
    """Every case in turn on this rank of the gang; rank ``r`` writes
    ``rank<r>.json`` (and its dropout draws to ``draws_<case>_<r>.npz``)."""
    from fleetx_tpu_torch.core import checkpoint as ckpt_lib
    from fleetx_tpu_torch.parallel.mesh import build_mesh
    from fleetx_tpu_torch.utils.env import (close_dist_env, get_backend,
                                            get_rank, init_dist_env)

    init_dist_env(device="cpu")
    rank = get_rank()
    results = {"backend": get_backend()}

    def keep(case, got):
        records = got.pop("records")
        if records:
            np.savez(os.path.join(workdir, f"draws_{case}_{rank}.npz"),
                     **{f"u{i}": r[2] for i, r in enumerate(records)})
            got["places"] = [[r[0], r[1]] for r in records]
        results[case] = got

    for case, (family, dist, model, extra) in dict(JAX_CASES,
                                                   **PORT_CASES).items():
        keep(case, run_case(workdir, family, dist, model, extra,
                            init_key="gpt_qat" if extra.get("qat")
                            else None))
    for case, dist in ZERO_CASES.items():
        eng = _port_engine("gpt", _cfg("gpt", dist, {}, {}))
        eng.params = _init_params(workdir, "gpt")
        eng.prepare()
        flat = eng.optimizer.flat_state(eng.opt_state, eng.params)
        results[case] = {k[3:]: list(v.shape) for k, v in flat.items()
                         if k.startswith("mu/")}
    # the gang's checkpoint at step 2 and its uninterrupted curve
    eng = _port_engine("gpt", _cfg("gpt", CKPT_DIST, {}, {}))
    eng.params = _init_params(workdir, "gpt")
    results["ckpt_gang"] = {"losses": fit_saving_step_2(
        eng, os.path.join(workdir, "gang_ckpt"))}
    full = {k: v.numpy() for k, v in ckpt_lib.flatten(
        eng.full_params()).items()}
    if rank == 0:
        np.savez(os.path.join(workdir, "gang_final.npz"), **full)
    # the one-rank checkpoint resumed by the gang
    cfg = _cfg("gpt", CKPT_DIST, {}, {})
    cfg["Engine"]["save_load"] = {
        "ckpt_dir": os.path.join(workdir, "one_ckpt"),
        "output_dir": os.path.join(workdir, "gang_resume_out")}
    eng = _port_engine("gpt", cfg)
    results["resume_gang"] = {"losses": eng.fit(_gpt_batches(STEPS)[2:])}
    # a one-rank engine inside the gang's process, beside the gang
    eng = _port_engine("gpt", _cfg("gpt", {}, {}, {}), one_rank=True)
    results["one_rank_in_gang"] = {"mesh": eng.mesh is None}
    build_mesh(CKPT_DIST)  # every rank still answers after the cases
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(results, f)
    close_dist_env()


# ---------------------------------------------------------------- fixtures
def _jax_engine(devices, family: str, extra: dict, workdir: str, key: str):
    """The JAX engine of a case on one device, prepared, with its initial
    parameters converted to the port's tree and written for the gang;
    ``(engine, batches)``."""
    import jax
    from flax.core import meta

    from fleetx_tpu.core.engine import EagerEngine as JEngine
    from fleetx_tpu.core.module import GPTModule as JGPT
    from fleetx_tpu.models.ernie.module import ErnieModule as JErnie
    from fleetx_tpu.models.vision.module import GeneralClsModule as JCls
    from fleetx_tpu.optims import lr_scheduler as JLR
    from fleetx_tpu.optims import optimizer as JOPT
    from fleetx_tpu.parallel.mesh import build_mesh
    from fleetx_tpu_torch import convert
    from fleetx_tpu_torch.core.checkpoint import flatten

    cfg = _cfg(family, {}, {}, extra)
    cfg.pop("Distributed")
    batches = _batches(family, extra)
    lr = JLR.build_lr_scheduler(GPT_LR if family == "gpt" else ENC_LR)
    opt = JOPT.build_optimizer(GPT_OPT if family == "gpt" else ENC_OPT, lr)
    module = {"gpt": JGPT, "ernie": JErnie, "vit": JCls}[family](cfg)
    eng = JEngine(cfg, module, optimizer=opt, lr_schedule=lr,
                  mesh=build_mesh({}, devices=devices[:1]))
    eng.max_steps = STEPS
    eng.prepare(batches[0])
    init = jax.device_get(meta.unbox(eng.state.params))
    tmod = _module(family, _cfg(family, {}, {}, extra))
    conv = {"gpt": lambda: convert.params_from_jax(init, tmod.model_cfg),
            "ernie": lambda: convert.ernie_params_from_jax(
                init, tmod.model_cfg),
            "vit": lambda: convert.vit_params_from_jax(init, tmod.vit_cfg)}
    np.savez(os.path.join(workdir, f"init_{key}.npz"),
             **{k: v.numpy() for k, v in flatten(conv[family]()).items()})
    return eng, batches


@pytest.fixture(scope="module")
def gang(devices8, tmp_path_factory):
    """The JAX curves, the port's one-rank runs and the gang's results."""
    from fleetx_tpu_torch.core.checkpoint import flatten

    workdir = str(tmp_path_factory.mktemp("sharded_train"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        jax_engines = {key: _jax_engine(devices8, fam, extra, workdir, key)
                       for key, fam, extra in (
                           ("gpt", "gpt", {}), ("gpt_qat", "gpt",
                                                {"qat": True}),
                           ("ernie", "ernie", {}), ("vit", "vit", {}))}
        # the one-rank checkpoint the gang resumes, and its curve
        eng = _port_engine("gpt", _cfg("gpt", {}, {}, {}))
        eng.params = _init_params(workdir, "gpt")
        one_ckpt_losses = fit_saving_step_2(
            eng, os.path.join(workdir, "one_ckpt"))
        port = _free_port()
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                   FLEETX_LOG_LEVEL="WARNING")
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "worker", workdir],
            env=dict(env, FLEETX_COORDINATOR=f"127.0.0.1:{port}",
                     FLEETX_NUM_PROCESSES=str(WORLD),
                     FLEETX_PROCESS_ID=str(r)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(WORLD)]
        # the JAX curves and the port's one-rank runs, while the gang runs
        jax_losses = {k: e.fit(b) for k, (e, b) in jax_engines.items()}
        one = {case: run_case(workdir, fam, dist, model, extra,
                              one_rank=True)
               for case, (fam, dist, model, extra) in PORT_CASES.items()}
        outs = []
        for p in procs:
            try:
                out, _ = p.communicate(timeout=DEADLINE_S)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise AssertionError("the training gang did not finish")
            outs.append(out)
        for p, out in zip(procs, outs):
            assert p.returncode == 0, f"gang rank failed:\n{out[-6000:]}"
        ranks = []
        for r in range(WORLD):
            with open(os.path.join(workdir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        # the gang's checkpoint resumed by one rank
        cfg = _cfg("gpt", {}, {}, {})
        cfg["Engine"]["save_load"] = {
            "ckpt_dir": os.path.join(workdir, "gang_ckpt"),
            "output_dir": os.path.join(workdir, "one_resume_out")}
        eng = _port_engine("gpt", cfg)
        resumed = eng.fit(_gpt_batches(STEPS)[2:])
        yield {"workdir": workdir, "jax": jax_losses, "one": one,
               "ranks": ranks, "one_ckpt_losses": one_ckpt_losses,
               "one_resumed": resumed,
               "one_resumed_params": {k: v.detach() for k, v in
                                      flatten(eng.params).items()}}
    finally:
        torch.set_num_threads(threads)


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_gang_reproduces_the_jax_one_device_curve(gang, case):
    family, _, _, extra = JAX_CASES[case]
    key = "gpt_qat" if extra.get("qat") else family
    want = gang["jax"][key]
    for rank in gang["ranks"]:
        got = rank[case]["losses"]
        assert len(got) == len(want) == STEPS
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    assert gang["ranks"][0]["backend"] == "gloo"


def _assemble(gang, case: str) -> list:
    """Each dropout draw of the gang placed in its global tensor; ranks
    holding one block must agree bit for bit."""
    places = gang["ranks"][0][case]["places"]
    out = []
    draws = [np.load(os.path.join(gang["workdir"], f"draws_{case}_{r}.npz"))
             for r in range(WORLD)]
    for i, (full, _) in enumerate(places):
        glob = np.full(full, np.nan, np.float32)
        for r in range(WORLD):
            shape_r, offs = gang["ranks"][r][case]["places"][i]
            assert shape_r == full
            u = draws[r][f"u{i}"]
            index = tuple(slice(offs.get(str(d), 0),
                                offs.get(str(d), 0) + u.shape[d])
                          for d in range(u.ndim))
            seen = glob[index]
            known = ~np.isnan(seen)
            assert np.array_equal(seen[known], u[known]), (case, i, r)
            glob[index] = u
        assert not np.isnan(glob).any(), (case, i)
        out.append(glob)
    return out


@pytest.mark.parametrize("case", sorted(PORT_CASES))
def test_gang_equals_one_rank_of_the_port(gang, case):
    """Losses within 1e-5 of one rank (grad norms too); with dropout on
    every draw of the gang, assembled from the ranks' blocks, equals one
    rank's bit for bit."""
    family, _, model, extra = PORT_CASES[case]
    one = gang["one"][case]
    for rank in gang["ranks"]:
        np.testing.assert_allclose(rank[case]["losses"], one["losses"],
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(rank[case]["grad_norms"],
                                   one["grad_norms"], rtol=1e-5, atol=1e-6)
    if extra.get("record"):
        draws = _assemble(gang, case)
        assert len(draws) == len(one["records"]) > 0
        for got, (_, _, want) in zip(draws, one["records"]):
            assert got.tobytes() == want.tobytes()
    if extra.get("clip") is not None:
        # the clip triggers: every step's norm is above it
        assert min(one["grad_norms"]) > extra["clip"]


@pytest.mark.parametrize("case", sorted(ZERO_CASES))
def test_moment_shapes_are_the_jax_zero_placement(gang, devices8, case):
    """Each rank's AdamW moment shapes are the local shapes of the specs
    JAX's engine gives its optimizer state (``zero_sharding`` at stages 1
    and 2) on the same degrees."""
    import jax
    from flax.core import meta

    from fleetx_tpu.core.engine import EagerEngine as JEngine
    from fleetx_tpu.core.module import GPTModule as JGPT
    from fleetx_tpu.optims import lr_scheduler as JLR
    from fleetx_tpu.optims import optimizer as JOPT
    from fleetx_tpu.parallel.mesh import build_mesh

    dist = ZERO_CASES[case]
    cfg = _cfg("gpt", dist, {}, {})
    lr = JLR.build_lr_scheduler(GPT_LR)
    eng = JEngine(cfg, JGPT(cfg), optimizer=JOPT.build_optimizer(GPT_OPT, lr),
                  lr_schedule=lr, mesh=build_mesh(dist,
                                                  devices=devices8[:WORLD]))
    eng.prepare(_gpt_batches(1)[0])
    want, full = {}, {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            meta.unbox(eng.state.opt_state))[0]:
        keys = [str(getattr(p, "key", getattr(p, "name", "")))
                for p in path]
        if "mu" not in keys:
            continue
        name = "/".join(keys[keys.index("mu") + 1:])
        want[name] = list(leaf.sharding.shard_shape(leaf.shape))
        full[name] = list(leaf.shape)
    assert want and any(want[k] != full[k] for k in want)
    for rank in gang["ranks"]:
        got = rank[case]
        assert sorted(got) == sorted(want)
        for name, shape in want.items():
            assert got[name] == shape, name


def test_checkpoints_move_between_a_gang_and_one_rank(gang):
    """A dp2 × mp2 gang's save at step 2 resumed on one rank, and one
    rank's save at step 2 resumed by the gang: the resumed losses equal
    the uninterrupted runs' (one rank's and the gang's within 1e-5)."""
    gang_run = gang["ranks"][0]["ckpt_gang"]["losses"]
    one_run = gang["one_ckpt_losses"]
    np.testing.assert_allclose(gang_run, one_run, rtol=0, atol=1e-5)
    np.testing.assert_allclose(gang["one_resumed"], gang_run[2:], rtol=0,
                               atol=1e-5)
    for rank in gang["ranks"]:
        np.testing.assert_allclose(rank["resume_gang"]["losses"],
                                   one_run[2:], rtol=0, atol=1e-5)
        assert rank["one_rank_in_gang"]["mesh"]
    # the gang's gathered final parameters against the checkpoint
    from fleetx_tpu_torch.core import checkpoint as ckpt_lib

    # one rank's load of the gang's step 2 holds its gathered leaves: the
    # resumed run's parameters equal the gang's at the end
    state, meta = ckpt_lib.load_checkpoint(
        os.path.join(gang["workdir"], "gang_ckpt"), 2)
    assert meta["consumed_samples"] == 2 * BATCH and state["step"] == 2
    with np.load(os.path.join(gang["workdir"], "gang_final.npz")) as z:
        for k, v in gang["one_resumed_params"].items():
            np.testing.assert_allclose(v.numpy(), z[k], rtol=0, atol=1e-5)


# ------------------------------------------------------- no gang needed
def test_flash_head_map_draws_a_block_of_the_global_mask():
    """The flash kernels' plain versions key their dropout hash on the
    global batch-head index: a rank's block of rows and heads draws the
    slice of the one-rank mask."""
    from fleetx_tpu_torch.ops import flash_attention as FA

    b, n, s = 4, 8, 128
    full = FA.dropout_keep(11, b * n, s, s, 0.1).reshape(b, n, s, s)
    for b_off, h_off in ((0, 0), (2, 4), (3, 6)):
        part = FA.dropout_keep(11, 1 * 2, s, s, 0.1,
                               heads=(2, n, b_off, h_off)).reshape(1, 2, s, s)
        assert torch.equal(part, full[b_off:b_off + 1, h_off:h_off + 2])
    q = torch.randn(b, s, n, 64)
    ref = FA.flash_attention(q, q, q, dropout_rate=0.1, dropout_seed=5)
    blk = q[2:4, :, 4:8].contiguous()
    got = FA.flash_attention(blk, blk, blk, dropout_rate=0.1,
                             dropout_seed=5, heads=(4, n, 2, 4))
    assert torch.equal(got, ref[2:4, :, 4:8])
    with pytest.raises(ValueError, match="head map"):
        FA.flash_attention(blk, blk, blk, heads=(2, n, 0, 0))


def test_rank_rows_split_each_microbatch_over_the_data_ranks():
    """``batch_rows``: rank r's k-th microbatch is its block of the global
    k-th microbatch (JAX's reshape to ``[accumulate, rows/accumulate]``)."""
    from fleetx_tpu_torch.parallel.mesh import build_mesh
    from fleetx_tpu_torch.parallel.sharding import batch_rows

    rows = np.arange(16)[:, None]
    for rank in range(4):
        mesh = build_mesh({"dp_degree": 2, "fsdp_degree": 2}, world_size=4,
                          rank=rank)
        got = batch_rows({"x": rows}, mesh, accumulate_steps=2)["x"][:, 0]
        micro = [rows[:8, 0], rows[8:, 0]]
        want = np.concatenate([m[rank * 2:rank * 2 + 2] for m in micro])
        assert np.array_equal(got, want)
    with pytest.raises(ValueError, match="does not split"):
        batch_rows({"x": np.arange(6)}, build_mesh(
            {"dp_degree": 4}, world_size=4, rank=0), 1)


def test_zero_specs_equal_the_jax_helpers():
    """``zero_sharding`` / ``zero_grad_specs`` / ``with_fsdp_axis`` and the
    family tables copied as data give JAX's specs on every leaf."""
    from fleetx_tpu.parallel import rules as JR
    from fleetx_tpu_torch.models.gpt.model import config_from_dict, \
        param_shapes
    from fleetx_tpu_torch.optims.optimizer import tree_leaves_with_path
    from fleetx_tpu_torch.parallel import rules as TR
    from fleetx_tpu_torch.parallel import sharding as SH

    shapes = {"/".join(p): s for p, s in tree_leaves_with_path(
        param_shapes(config_from_dict(GPT_MODEL)),)}
    for stage in (0, 1, 2, 3):
        for sp in (False, True):
            jl, tl = JR.SpecLayout(stage, sp), TR.SpecLayout(stage, sp)
            specs = {k: TR.spec_for("gpt", k, s, tl)
                     for k, s in shapes.items()}
            assert specs == {k: JR.spec_for("gpt", k, s, jl)
                             for k, s in shapes.items()}
            for size in (2, 4):
                for k, s in shapes.items():
                    for only in (False, True):
                        assert TR.with_fsdp_axis(s, specs[k], size,
                                                 only_if_replicated=only) \
                            == JR.with_fsdp_axis(s, specs[k], size,
                                                 only_if_replicated=only)
                assert SH.zero_sharding(shapes, specs, size) == {
                    k: JR.with_fsdp_axis(s, specs[k], size,
                                         only_if_replicated=True)
                    for k, s in shapes.items()}
    for fam in ("gpt", "gpt_moe", "gpt_lora", "vision", "ernie", "imagen",
                "serving_kv"):
        assert [(p, t) for p, t in TR.PARTITION_RULES[fam]] == \
            [(p, t) for p, t in JR.PARTITION_RULES[fam]], fam
    assert TR.STACK_MARKERS == JR.STACK_MARKERS
    assert TR.batch_spec() == tuple(JR.batch_spec())
    assert [TR.stage_shards(t, s) for t in TR.ZERO_STAGE_TERMS
            for s in range(4)] == [JR.stage_shards(t, s)
                                   for t in JR.ZERO_STAGE_TERMS
                                   for s in range(4)]


def test_rng_streams_are_keyed_by_name():
    """``utils/env.rng_streams``: a stream's seed depends on the root and
    its name only (JAX folds the name's crc32 into the key), so adding or
    reordering names moves no stream."""
    from fleetx_tpu_torch.utils.env import STREAMS, rng_streams

    base = rng_streams(7)
    assert set(base) == set(STREAMS) and len(set(base.values())) == 4
    assert rng_streams(7, ("sample", "dropout", "extra"))["dropout"] == \
        base["dropout"]
    assert rng_streams(8)["dropout"] != base["dropout"]


#: what the loaders still refuse, with the world a member would load in
REFUSED = {
    "pipeline": ("pretrain_gpt_175B_mp8_pp16.yaml", [], 128 * 8),
    "ring_over_seq": ("pretrain_gpt_1.3B_seq8k_ring.yaml", [], 8),
    "moe_over_tensor": ("pretrain_gpt_moe_8expert_mp4.yaml",
                        ["Distributed.pp_degree=1"], 8),
    "moe_over_data": ("pretrain_gpt_moe_8expert_mp4.yaml",
                      ["Distributed.pp_degree=1", "Distributed.mp_degree=1",
                       "Distributed.dp_degree=2"], 2),
}


@pytest.mark.parametrize("what", sorted(REFUSED))
def test_item_12_refusals_through_the_loaders(what):
    from fleetx_tpu_torch.tools import train as T

    name, overrides, world = REFUSED[what]
    with pytest.raises(NotImplementedError, match="item 12"):
        T.load_config(os.path.join(GPT_YAMLS, name), overrides,
                      device="cpu", world_size=world)


@pytest.mark.parametrize("what", ["ernie_mp2", "vit_stage3", "imagen_mp2",
                                  "lora_mp2"])
def test_tensor_parallel_and_stage_3_are_dense_gpt_only(what):
    from fleetx_tpu_torch.utils.config import (check_covered,
                                               create_attr_dict,
                                               process_dist_config)

    def load(dist, n):
        cfg = create_attr_dict({"Model": {"module": module},
                                "Distributed": dist})
        process_dist_config(cfg, num_devices=n)
        check_covered(cfg)

    module = {"ernie": "ErnieModule", "vit": "GeneralClsModule",
              "imagen": "ImagenModule", "lora": "LoRAGPTModule"}[
        what.split("_")[0]]
    dist = {"mp_degree": 2} if what.endswith("mp2") else {
        "fsdp_degree": 2, "sharding": {"sharding_stage": 3}}
    with pytest.raises(NotImplementedError, match="item 12"):
        load(dist, 2)
    # data parallel and ZeRO 1-2 load
    load({"fsdp_degree": 2}, 4)


@pytest.mark.parametrize("what", ["resilience", "async_save", "no_group"])
def test_a_gang_member_refuses_before_it_joins(what, monkeypatch):
    """Resilience and asynchronous saves on a gang raise naming item 12
    before any connection; a member without a coordinator raises."""
    from fleetx_tpu_torch.tools import train as T

    monkeypatch.setenv("FLEETX_NUM_PROCESSES", "2")
    monkeypatch.delenv("FLEETX_COORDINATOR", raising=False)
    cfg = {"Resilience": {"enable": what == "resilience"},
           "Engine": {"save_load": {"async_save": what == "async_save"}}}
    if what == "no_group":
        with pytest.raises(RuntimeError, match="no FLEETX_COORDINATOR"):
            T.join_gang(cfg, "cpu")
        return
    with pytest.raises(NotImplementedError, match="item 12"):
        T.join_gang(cfg, "cpu")


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    torch.set_num_threads(1)
    {"worker": _worker}[sys.argv[1]](sys.argv[2])
