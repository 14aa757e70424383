"""Port parity: serving over a mesh of ranks (``parallel/mesh.py``, the
sharded pool of ``serving/paged_cache.py``, ``paged_attention_sharded``,
the tensor-parallel decode stack, ``ServingEngine(mesh=...)`` with its
leader and followers, ``tools.serve`` as a gang, and data-parallel
``InferenceEngine``) against the JAX package on the CPU.

The port side runs in CPU process gangs over gloo, all started together
by one module fixture: four ranks at (fsdp 2, mp 2) run every in-process
case (this file is their worker: ``python tests/test_torch_sharded_serving.py
<mode> <dir>``), four more are ``tools.supervise --num-procs 4 --
tools.serve --device cpu``, and two run ``InferenceEngine`` over dp 2.
JAX runs the same cases on ``build_mesh({"fsdp_degree": 2, "mp_degree":
2}, devices=jax.devices()[:4])`` of the 8 CPU devices, on the tiny model
of ``tests/test_zz_serving.py`` (its init converted by
``convert.params_from_jax``).

Tolerances: ``paged_attention_sharded`` within 1e-5 of JAX's (Pallas in
interpret mode; f32); greedy tokens identical, quantized too; the
data-parallel engine's outputs equal the one-rank engine's bit for bit.
Every subprocess has its own deadline; nothing here asserts a timing.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVE_YAML = os.path.join(REPO, "fleetx_tpu", "configs", "nlp", "gpt",
                          "serving_gpt_345M.yaml")
INF_YAML = os.path.join(REPO, "fleetx_tpu", "configs", "nlp", "gpt",
                        "inference_gpt_345M_dp8.yaml")
MODEL_DICT = dict(vocab_size=97, hidden_size=64, num_layers=2,
                  num_attention_heads=4, max_position_embeddings=64,
                  hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                  use_flash_attention=False, dtype="float32",
                  param_dtype="float32")
EOS = 96
DIST = {"fsdp_degree": 2, "mp_degree": 2}
SERVING = dict(max_batch=2, page_size=4, num_pages=32, max_seq_len=32,
               prefill_chunk=4)
QUANT_SERVING = dict(SERVING, prefill_chunk=8, quantize_decode=True)
PARITY_PROMPTS = [[5, 9, 23, 41], [7, 3]]
KERNEL_PROMPTS = [[5, 9, 23, 41]]
QUANT_PROMPTS = [[5, 9, 23, 41], [7, 3, 11]]
NEW = 6
#: the paged-attention case: 8 pages of 4 slots (shard 0 holds pages 0-3,
#: shard 1 pages 4-7), 4 heads of 16; row 0's pages interleave the
#: shards, row 1's all belong to shard 1, row 2 is inactive
PA_TABLES = [[1, 5, 2, 7], [5, 6, 0, 0], [0, 0, 0, 0], [3, 4, 0, 0]]
PA_LENS = [14, 6, -1, 5]
SUPERVISE = [sys.executable, "-m", "fleetx_tpu_torch.tools.supervise"]
DEADLINE_S = 300
#: seconds the serving gang sits idle between two requests (beyond the
#: leader's ``IDLE_BEAT_S``)
IDLE_S = 3


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tiny_overrides() -> list:
    return [f"Model.{k}={v}" for k, v in MODEL_DICT.items()
            if k not in ("use_flash_attention",)] + [
        "Model.use_flash_attention=False", "Model.fused_residual_norm=False",
        "Model.ffn_hidden_size=256"]


def _env() -> dict:
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               FLEETX_LOG_LEVEL="WARNING")
    for k in ("FLEETX_COORDINATOR", "FLEETX_NUM_PROCESSES",
              "FLEETX_PROCESS_ID"):
        env.pop(k, None)
    return env


def _gang(mode: str, workdir: str, n: int) -> list:
    """``n`` ranks of this file's worker in ``mode``."""
    port = _free_port()
    procs = []
    for rank in range(n):
        env = dict(_env(), FLEETX_COORDINATOR=f"127.0.0.1:{port}",
                   FLEETX_NUM_PROCESSES=str(n), FLEETX_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), mode, workdir],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    return procs


def _wait_all(procs: list, what: str) -> list:
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=DEADLINE_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise AssertionError(f"{what}: a rank did not finish")
        outs.append(out)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"{what} rank failed:\n{out[-4000:]}"
    return outs


# --------------------------------------------------------------- the port

def _worker_serve(workdir: str) -> None:
    """The (fsdp 2, mp 2) gang's cases; rank 0 writes the results."""
    import torch

    from fleetx_tpu_torch.models.gpt.model import config_from_dict
    from fleetx_tpu_torch.ops import paged_attention as PA
    from fleetx_tpu_torch.parallel import mesh as M
    from fleetx_tpu_torch.parallel.rules import shard_leaf
    from fleetx_tpu_torch.serving.engine import ServingConfig, ServingEngine
    from fleetx_tpu_torch.utils.env import (close_dist_env, get_backend,
                                            init_dist_env)

    init_dist_env(device="cpu")
    mesh = M.build_mesh(DIST)
    out = {"backend": get_backend(), "mesh": mesh.shape}
    case = dict(np.load(os.path.join(workdir, "pa_case.npz")))

    # paged_attention_sharded on this rank's shard of the case
    q = shard_leaf(torch.from_numpy(case["q"]), (None, "tensor"), mesh)
    pk, pv = (shard_leaf(torch.from_numpy(case[k]),
                         ("fsdp", None, "tensor"), mesh)
              for k in ("pk", "pv"))
    tables = torch.from_numpy(case["tables"])
    lens = torch.from_numpy(case["lens"])
    got = PA.paged_attention_sharded(q, pk.contiguous(), pv.contiguous(),
                                     tables, lens, mesh=mesh)
    out["pa"] = M.all_gather(got, "tensor", mesh, dim=1).tolist()
    # the raw triple of a shard whose pages a row does not hold at all
    lo = mesh.axis_index("fsdp") * pk.shape[0]
    local = PA._localize_tables(tables, lo, pk.shape[0])
    acc, m, l = PA.paged_call(q.contiguous(), pk.contiguous(),
                              pv.contiguous(), local, lens)
    empty = [row for row in range(len(PA_LENS))
             if bool((local[row] < 0).all())]
    out["empty_rows"] = M.gather_objects(
        {"rows": empty,
         "zero": all(bool((acc[r] == 0).all()) and bool((l[r] == 0).all())
                     and bool((m[r] == -1e30).all()) for r in empty)},
        mesh)

    params = torch.load(os.path.join(workdir, "params.pt"))

    def engine(serving: dict, quant: bool = False):
        cfg = config_from_dict(dict(MODEL_DICT, qat_act_bits=8)
                               if quant else MODEL_DICT)
        return ServingEngine(cfg, params, ServingConfig(**serving),
                             eos_token_id=EOS, device="cpu", mesh=mesh)

    def run(eng, prompts: list, tag: str) -> dict:
        if mesh.is_leader:
            reqs = [eng.submit(p, NEW, request_id=f"{tag}{i}")
                    for i, p in enumerate(prompts)]
            eng.run_until_drained()
            reports = eng.close(0)
            return {"tokens": [r.tokens for r in reqs],
                    "kernel": eng.paged_kernel_active,
                    "pool": list(eng.pool_k.shape), "reports": reports,
                    "n_chips": eng.n_chips}
        eng.follow()
        return {}

    out["parity"] = run(engine(SERVING), PARITY_PROMPTS, "m")
    out["kernel"] = run(engine(SERVING), KERNEL_PROMPTS, "k")
    out["quant"] = run(engine(QUANT_SERVING, quant=True), QUANT_PROMPTS,
                       "q")
    try:
        engine(dict(SERVING, num_pages=33))
        out["uneven"] = "built"
    except ValueError as e:
        out["uneven"] = str(e)
    # a replica of this mesh on a checkpoint deeper than its Model
    from fleetx_tpu_torch.tools.serve import build_engine

    try:
        build_engine({"Model": dict(MODEL_DICT, num_layers=1),
                      "Serving": dict(SERVING, ckpt_dir=os.path.join(
                          workdir, "ckpt")),
                      "Distributed": DIST}, device="cpu")
        refused = "built"
    except ValueError as e:
        refused = str(e)
    out["wrong_depth"] = M.gather_objects(refused, mesh)
    close_dist_env()
    if mesh.is_leader:
        with open(os.path.join(workdir, "serve.json"), "w") as f:
            json.dump(out, f)


def _worker_dp(workdir: str) -> None:
    """The dp 2 gang: the export through ``InferenceEngine`` on its
    batch shard, the outputs gathered."""
    from fleetx_tpu_torch.core.engine.inference_engine import (
        InferenceEngine, serving_mesh)
    from fleetx_tpu_torch.utils.env import close_dist_env

    mesh = serving_mesh({"dp_degree": 2}, device="cpu")
    eng = InferenceEngine(os.path.join(workdir, "export"), mesh=mesh,
                          device="cpu")
    inputs = dict(np.load(os.path.join(workdir, "dp_inputs.npz")))
    logits = eng.predict([inputs["tokens"], inputs["pos"]])[0]
    try:
        eng.predict([inputs["tokens"][:1], inputs["pos"][:1]])
        refused = ""
    except ValueError as e:
        refused = str(e)
    close_dist_env()
    np.savez(os.path.join(workdir, f"dp_out{mesh.rank}.npz"),
             logits=logits, dp=eng.dp, refused=refused)


# ---------------------------------------------------------------- fixtures

@pytest.fixture(scope="module")
def jax_side(devices8):
    """The tiny JAX model, its converted params, the JAX mesh."""
    import jax
    import jax.numpy as jnp
    from flax.core import meta

    from fleetx_tpu.models.gpt.model import (GPTForPretraining,
                                             config_from_dict)
    from fleetx_tpu.parallel.mesh import build_mesh
    from fleetx_tpu_torch.convert import params_from_jax
    from fleetx_tpu_torch.models.gpt.model import \
        config_from_dict as t_config

    cfg = config_from_dict(MODEL_DICT)
    params = meta.unbox(GPTForPretraining(cfg).init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 8), jnp.int32),
        None, deterministic=True)["params"])
    mesh = build_mesh(DIST, devices=jax.devices()[:4])
    tparams = params_from_jax(jax.device_get(params), t_config(MODEL_DICT))
    return cfg, params, mesh, tparams


@pytest.fixture(scope="module")
def gangs(jax_side, tmp_path_factory):
    """Every port-side gang, started together; their outputs."""
    import torch

    from fleetx_tpu_torch.core import checkpoint as C
    from fleetx_tpu_torch.tools import export as X
    from fleetx_tpu_torch.utils.config import get_config

    _, _, _, tparams = jax_side
    work = str(tmp_path_factory.mktemp("sharded"))
    rng = np.random.RandomState(3)
    np.savez(os.path.join(work, "pa_case.npz"),
             q=rng.randn(4, 4, 16).astype(np.float32),
             pk=rng.randn(8, 4, 4, 16).astype(np.float32),
             pv=rng.randn(8, 4, 4, 16).astype(np.float32),
             tables=np.asarray(PA_TABLES, np.int32),
             lens=np.asarray(PA_LENS, np.int32))
    torch.save(tparams, os.path.join(work, "params.pt"))
    # the replicas' checkpoint
    ckpt = os.path.join(work, "ckpt")
    C.save_checkpoint(ckpt, 1, dict(step=1, **C.flatten(tparams,
                                                        "params/")))
    serve_gang = _gang("serve", work, 4)

    # tools.serve as a gang of 4
    port = _free_port()
    ready = os.path.join(work, "ready.json")
    metrics = os.path.join(work, "metrics.jsonl")
    args = ["-c", SERVE_YAML, "--device", "cpu", "--port", str(port),
            "--ready-file", ready, "--metrics-out", metrics]
    for k, v in dict(SERVING, ckpt_dir=ckpt).items():
        args += ["-o", f"Serving.{k}={v}"]
    for o in _tiny_overrides() + ["Distributed.fsdp_degree=2",
                                  "Distributed.mp_degree=2",
                                  f"Generation.eos_token_id={EOS}"]:
        args += ["-o", o]
    supervisor = subprocess.Popen(
        SUPERVISE + ["--num-procs", "4", "--", sys.executable, "-m",
                     "fleetx_tpu_torch.tools.serve"] + args,
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, start_new_session=True)

    # the forward export, then InferenceEngine over dp 2
    seq = MODEL_DICT["max_position_embeddings"]
    cfg = get_config(INF_YAML, _tiny_overrides() + [
        f"Engine.save_load.ckpt_dir={ckpt}",
        f"Inference.model_dir={os.path.join(work, 'export')}",
        "Inference.target=forward", f"Global.max_seq_len={seq}",
        "Distributed.dp_degree=1", "Global.global_batch_size=1"])
    X.export(cfg, device="cpu")
    tokens = rng.randint(0, MODEL_DICT["vocab_size"], (2, seq))
    pos = np.broadcast_to(np.arange(seq), (2, seq)).copy()
    np.savez(os.path.join(work, "dp_inputs.npz"), tokens=tokens, pos=pos)
    dp_gang = _gang("dp", work, 2)

    out = {"work": work, "port": port, "ready": ready, "metrics": metrics,
           "supervisor": supervisor, "dp_inputs": (tokens, pos)}
    try:
        out["jax"] = _jax_references(jax_side, work)   # while they run
        _wait_all(serve_gang, "serve gang")
        _wait_all(dp_gang, "dp gang")
        with open(os.path.join(work, "serve.json")) as f:
            out["serve"] = json.load(f)
        out["dp"] = [dict(np.load(os.path.join(work, f"dp_out{r}.npz")))
                     for r in range(2)]
        yield out
    finally:
        # the supervisor forwards SIGTERM to its members (each in its own
        # session) and kills them past its grace; SIGKILL only after
        if supervisor.poll() is None:
            supervisor.send_signal(signal.SIGTERM)
            try:
                supervisor.wait(timeout=60)
            except subprocess.TimeoutExpired:
                supervisor.kill()
                supervisor.wait()


def _jax_references(jax_side, work: str) -> dict:
    """Every JAX result the tests hold the port to."""
    import jax.numpy as jnp

    from fleetx_tpu.ops.paged_attention import paged_attention_sharded

    case = np.load(os.path.join(work, "pa_case.npz"))
    refs = {"pa": np.asarray(paged_attention_sharded(
        *(jnp.asarray(case[k]) for k in ("q", "pk", "pv", "tables",
                                         "lens")), mesh=jax_side[2]))}
    for name, prompts in (("parity", PARITY_PROMPTS),
                          ("kernel", KERNEL_PROMPTS)):
        refs[name] = _jax_engine_tokens(jax_side, SERVING, prompts)
    refs["quant"] = _jax_engine_tokens(jax_side, QUANT_SERVING,
                                       QUANT_PROMPTS, quant=True)
    try:
        _jax_engine_tokens(jax_side, dict(SERVING, num_pages=33), [[5]])
        refs["uneven"] = "built"
    except ValueError as e:
        refs["uneven"] = str(e)
    return refs


def _jax_engine_tokens(jax_side, serving: dict, prompts: list,
                       quant: bool = False) -> tuple:
    from fleetx_tpu.models.gpt.model import config_from_dict
    from fleetx_tpu.serving import ServingConfig, ServingEngine

    cfg, params, mesh, _ = jax_side
    if quant:
        cfg = config_from_dict(dict(MODEL_DICT, qat_act_bits=8))
    eng = ServingEngine(cfg, params, ServingConfig(**serving),
                        eos_token_id=EOS, mesh=mesh)
    reqs = [eng.submit(p, NEW, request_id=f"j{i}")
            for i, p in enumerate(prompts)]
    eng.run_until_drained()
    return [r.tokens for r in reqs], eng.paged_kernel_active


# ------------------------------------------------------------------ tests

def test_gang_runs_on_gloo_at_the_asked_mesh(gangs):
    serve = gangs["serve"]
    assert serve["backend"] == "gloo"
    assert serve["mesh"] == {"pipe": 1, "data": 1, "fsdp": 2, "seq": 1,
                             "tensor": 2}


def test_paged_attention_sharded_matches_jax(gangs):
    want = gangs["jax"]["pa"]
    got = np.asarray(gangs["serve"]["pa"], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert (got[2] == 0).all()                # the inactive row
    # row 1's pages all sit on shard 1: shard 0's partial is the empty
    # (m = -1e30, l = 0, acc = 0) triple, on both of its tensor ranks (rank
    # r is fsdp shard r // 2); the inactive row 2 is empty everywhere
    by_rank = gangs["serve"]["empty_rows"]
    assert [r["rows"] for r in by_rank] == [[1, 2], [1, 2], [2], [2]]
    assert all(r["zero"] for r in by_rank)


@pytest.mark.parametrize("case,prompts", [("parity", PARITY_PROMPTS),
                                          ("kernel", KERNEL_PROMPTS)])
def test_mesh_engine_greedy_tokens_equal_jax(gangs, case, prompts):
    """``test_pool_sharded_over_mesh_keeps_parity`` and
    ``test_sharded_pool_runs_kernel_path``'s cases."""
    want, kernel = gangs["jax"][case]
    assert len(want) == len(prompts)
    got = gangs["serve"][case]
    assert got["tokens"] == want
    assert got["kernel"] is kernel is True
    assert got["pool"] == [2, 16, 4, 2, 16] and got["n_chips"] == 4
    steps = [r["steps"] for r in got["reports"]]
    assert all(s == steps[0] for s in steps) and steps[0]["decode"] > 0
    assert [r["pool_shape"] for r in got["reports"]] == [got["pool"]] * 4


def test_quantized_decode_under_the_mesh_matches_jax(gangs):
    want, kernel = gangs["jax"]["quant"]
    assert gangs["serve"]["quant"]["kernel"] is kernel is True
    assert gangs["serve"]["quant"]["tokens"] == want


def test_uneven_page_count_is_refused_as_in_jax(gangs):
    assert "divisible" in gangs["jax"]["uneven"]
    assert "does not split" in gangs["serve"]["uneven"]


def test_mesh_replica_refuses_a_checkpoint_of_another_depth(gangs):
    """A 2-layer checkpoint under a 1-layer Model: every rank of the mesh
    replica refuses it before cutting a leaf, as one rank does."""
    refused = gangs["serve"]["wrong_depth"]
    assert len(refused) == 4
    for msg in refused:
        assert "!= expected" in msg and "(1," in msg, msg


def test_serve_gang_answers_idles_and_drains(gangs):
    from fleetx_tpu_torch.serving.server import request

    sup = gangs["supervisor"]
    deadline = time.monotonic() + DEADLINE_S
    while not os.path.exists(gangs["ready"]):
        assert sup.poll() is None, sup.communicate()[0][-4000:]
        assert time.monotonic() < deadline, "the replica never came up"
        time.sleep(0.2)
    with open(gangs["ready"]) as f:
        port = json.load(f)["port"]
    want, _ = gangs["jax"]["parity"]
    first = request(("127.0.0.1", port), {"id": "a", "prompt":
                                          PARITY_PROMPTS[0],
                                          "max_new_tokens": NEW},
                    timeout=DEADLINE_S)
    assert first["tokens"] == want[0]
    time.sleep(IDLE_S)                # idle past the leader's beat
    second = request(("127.0.0.1", port), {"id": "b", "prompt":
                                           PARITY_PROMPTS[1],
                                           "max_new_tokens": NEW},
                     timeout=DEADLINE_S)
    assert second["tokens"] == want[1]
    os.killpg(sup.pid, signal.SIGTERM)
    out, _ = sup.communicate(timeout=DEADLINE_S)
    assert sup.returncode == 75, out[-4000:]
    with open(gangs["metrics"]) as f:
        records = [json.loads(line) for line in f]
    ranks = records[-1]["ranks"]
    assert records[-1]["scope"] == "serving_mesh"
    assert [r["rank"] for r in ranks] == [0, 1, 2, 3]
    assert all(r["backend"] == "gloo" for r in ranks)
    assert all(r["steps"] == ranks[0]["steps"] for r in ranks)
    assert ranks[0]["steps"]["decode"] >= 2 * (NEW - 1)


def test_data_parallel_inference_equals_one_rank(gangs):
    from fleetx_tpu_torch.core.engine.inference_engine import \
        InferenceEngine

    tokens, pos = gangs["dp_inputs"]
    one = InferenceEngine(os.path.join(gangs["work"], "export"),
                          device="cpu")
    want = np.concatenate([one.predict([tokens[i:i + 1], pos[i:i + 1]])[0]
                           for i in range(2)])
    for rank in gangs["dp"]:
        assert int(rank["dp"]) == 2
        np.testing.assert_array_equal(rank["logits"], want)
        assert "not divisible by dp=2" in str(rank["refused"])


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    import torch

    torch.set_num_threads(1)
    {"serve": _worker_serve, "dp": _worker_dp}[sys.argv[1]](sys.argv[2])
