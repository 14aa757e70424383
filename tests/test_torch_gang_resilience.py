"""Port parity: the gang resilience runtime (``resilience/coordination.py``'s
``DistributedCoordinator`` over the gang's ``TCPStore``, the arrival side
of ``observability/gang.py``, ``PreemptionHandler.latch``,
``GangWatchdog``, the per-rank mode and the two-phase commit of
``core/checkpoint.py``, ``Observability.gang`` and the engine's voted
loop) against the JAX package's tests of the same behaviour
(``tests/test_zz_multihost.py``).

The units run in process against a fake store with ``TCPStore``'s API and
against a real in-process ``TCPStore``. The drills are the eight
2-process drills of ``tests/test_zz_multihost.py`` (the SIGTERM resume,
the collective rollback, the uneven stream, the corrupt shard, the bit
flip, divergent checkpoint views, the metric merge, the crash's flight
dumps): each is ``python -m fleetx_tpu_torch.tools.supervise
--num-procs 2 -- python tests/test_torch_gang_resilience.py worker ...``
(this file is the worker: a per-rank replica of ``tests/test_engine.py``'s
tiny GPT on the CPU, gloo, one torch thread), and each asserts what the
JAX drill asserts: exit codes, steps, counters and files. One module
fixture starts every gang at once, each on its own port and directory,
and computes JAX's one-device curve and the port's uninterrupted
one-rank run while they train.

Tolerances: decisions, steps, counters and files are equal; the resumed
losses within 1e-5 of JAX's one-device curve (the port's one-rank
tolerance, ``tests/test_torch_train.py``) and bit for bit the port's
uninterrupted one-rank run. Every subprocess has its own deadline;
nothing here asserts a timing beyond it.
"""

import argparse
import datetime
import glob
import json
import os
import shutil
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUPERVISE = [sys.executable, "-m", "fleetx_tpu_torch.tools.supervise"]
DEADLINE_S = 180
#: ``tests/test_engine.py``'s tiny GPT and batches
VOCAB, SEQ, BATCH = 128, 32, 8
LR = {"name": "cosine", "max_lr": 1e-3, "min_lr": 1e-4, "warmup_steps": 2,
      "decay_steps": 100}
OPT = {"name": "AdamW", "weight_decay": 0.01,
       "grad_clip": {"clip_norm": 1.0}}


def make_batches(n: int, seed: int = 0) -> list:
    """``tests/test_engine.make_batches`` (numpy only: the worker imports
    no JAX; the fixture checks the two agree)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        tokens = rng.randint(0, VOCAB, size=(BATCH, SEQ)).astype(np.int32)
        out.append({
            "tokens": tokens,
            "position_ids": np.broadcast_to(np.arange(SEQ, dtype=np.int32),
                                            (BATCH, SEQ)).copy(),
            "labels": rng.randint(0, VOCAB, size=(BATCH, SEQ)).astype(
                np.int32),
            "loss_mask": np.ones((BATCH, SEQ), np.float32)})
    return out


def _port_engine(cfg: dict, workdir: str, mesh=None):
    """The port's engine of ``cfg`` on the CPU from the JAX init the
    fixture converted (``init.npz``)."""
    from fleetx_tpu_torch.core.checkpoint import unflatten
    from fleetx_tpu_torch.core.engine import EagerEngine
    from fleetx_tpu_torch.core.module import GPTModule
    from fleetx_tpu_torch.optims import build_lr_scheduler, build_optimizer

    lr = build_lr_scheduler(LR)
    eng = EagerEngine(cfg, GPTModule(cfg),
                      optimizer=build_optimizer(OPT, lr), lr_schedule=lr,
                      device="cpu", mesh=mesh)
    with np.load(os.path.join(workdir, "init.npz")) as z:
        eng.params = unflatten({k: torch.from_numpy(z[k]) for k in z.files})
    return eng


# -------------------------------------------------------------- the worker
def _worker_args(argv: list) -> argparse.Namespace:
    """``tests/gang_worker.py``'s arguments, plus the fixture's
    directory."""
    p = argparse.ArgumentParser()
    p.add_argument("--workdir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--status", required=True)
    p.add_argument("--steps", type=int, default=6)
    p.add_argument("--seed", type=int, default=21)
    p.add_argument("--save-steps", type=int, default=0)
    p.add_argument("--exit-code", type=int, default=75)
    p.add_argument("--faults", default="")
    p.add_argument("--guard-rollback", action="store_true")
    p.add_argument("--uneven", action="store_true")
    p.add_argument("--sdc-every", type=int, default=0)
    p.add_argument("--sdc-action", default="log")
    p.add_argument("--obs", action="store_true")
    p.add_argument("--coord-timeout", type=float, default=120.0)
    return p.parse_args(argv)


def _worker(argv: list) -> int:
    """One member of a drill gang (``tests/gang_worker.py``'s logic):
    joins the gang, trains its own replica on a mesh of one with
    ``per_rank_dirs``, and writes its status JSON."""
    args = _worker_args(argv)
    if args.faults:
        os.environ["FLEETX_FAULTS"] = args.faults
    from fleetx_tpu_torch.core import checkpoint as ckpt_lib
    from fleetx_tpu_torch.observability.metrics import get_registry
    from fleetx_tpu_torch.parallel.mesh import build_mesh
    from fleetx_tpu_torch.resilience import TrainingAborted
    from fleetx_tpu_torch.utils.env import (close_dist_env, get_rank,
                                            init_dist_env)

    init_dist_env(device="cpu")
    rank = get_rank()
    with open(os.path.join(args.workdir, "cfg.json")) as f:
        cfg = json.load(f)
    cfg["Engine"]["max_steps"] = args.steps
    cfg["Engine"]["save_load"] = {"output_dir": args.out,
                                  "per_rank_dirs": True,
                                  "save_steps": args.save_steps}
    res_cfg = {
        "enable": True,
        "retry": {"max_attempts": 2, "backoff_s": 0.0, "jitter": 0.0},
        "coordination": {"timeout_s": args.coord_timeout},
        "preemption": {"enable": True, "save_on_exit": True,
                       "exit_code": args.exit_code, "sync_every": 1},
        "guard": {"enable": False},
    }
    if args.obs:
        cfg["Observability"] = {"enable": True, "gang": True,
                                "sinks": ["jsonl"],
                                "trace": {"enable": False}}
    if args.guard_rollback:
        res_cfg["guard"] = {"enable": True, "nonfinite_action": "rollback",
                            "nonfinite_streak": 2, "max_rollbacks": 1,
                            "skip_nonfinite_update": False}
    if args.sdc_every:
        res_cfg["integrity"] = {"sentinel_every": args.sdc_every,
                                "sentinel_action": args.sdc_action}
    cfg["Resilience"] = res_cfg
    eng = _port_engine(cfg, args.workdir,
                       mesh=build_mesh({}, world_size=1))
    # the engine suffixed output_dir with rank_<i>: the batch list starts
    # at this rank's local resume point, clamped so a divergent local view
    # cannot over-slice it before the engine rules on the divergence
    start = min(ckpt_lib.latest_step(eng.output_dir) or 0, args.steps - 1)
    batches = make_batches(args.steps, seed=args.seed)
    if args.uneven and rank == 1:
        batches = batches[:-1]
    stream = batches[start:]
    if args.uneven:  # one-shot: the drill needs a stream that runs dry
        stream = iter(stream)
    status: dict = {"rank": int(rank), "resume_from": int(start)}
    rc = 0
    try:
        status["losses"] = [float(x) for x in eng.fit(stream) or []]
        status["exit"] = "completed"
    except SystemExit as e:  # the graceful preemption path
        rc = int(e.code or 0)
        status["exit"] = "preempted"
        status["code"] = rc
    except TrainingAborted as e:
        rc = 3
        status["exit"] = "aborted"
        status["error"] = str(e)
    except Exception as e:  # noqa: BLE001 — the status file is the report
        rc = 4
        status["exit"] = "error"
        status["error"] = f"{type(e).__name__}: {e}"
    status["final_step"] = int(eng.step)
    reg = get_registry()
    status["rollbacks"] = reg.counter("rollbacks_total").value
    status["preemption_exits"] = reg.counter("preemption_exits").value
    status["ckpt_latest"] = ckpt_lib.latest_step(eng.output_dir)
    status["ckpt_completed"] = ckpt_lib.completed_steps(eng.output_dir)
    for key in ("sdc_checks_total", "sdc_replay_mismatches",
                "sdc_fingerprint_mismatches", "ckpt_verify_failed",
                "ckpt_verify_fallbacks", "ckpt_commit_aborts"):
        status[key] = reg.counter(key).value
    status["coord_agreements"] = reg.counter("coord_agreements_total").value
    status["barrier_waits"] = reg.histogram("barrier_wait_ms") \
        .summary().get("count", 0)
    status["rank_skew"] = reg.gauge("rank_skew").value
    status["telemetry_dir"] = eng.obs.output_dir if eng.obs.enabled else None
    path = args.status.format(rank=rank)
    with open(f"{path}.tmp", "w") as f:
        json.dump(status, f)
    os.replace(f"{path}.tmp", path)
    close_dist_env()
    return rc


def _refusal_member(argv: list) -> int:
    """A member of the step-0 gang: builds ``EagerEngine(mesh=build_mesh(
    {}, world_size=1))`` without ``per_rank_dirs`` and reports what it
    raised."""
    from fleetx_tpu_torch.parallel.mesh import build_mesh
    from fleetx_tpu_torch.utils.env import (close_dist_env, get_rank,
                                            init_dist_env)

    workdir = argv[0]
    init_dist_env(device="cpu")
    with open(os.path.join(workdir, "cfg.json")) as f:
        cfg = json.load(f)
    out = {"rank": get_rank(), "raised": None}
    try:
        _port_engine(cfg, workdir, mesh=build_mesh({}, world_size=1))
    except Exception as e:  # noqa: BLE001 — the report is the test's
        out["raised"] = [type(e).__name__, str(e)]
    with open(os.path.join(workdir, f"refusal{out['rank']}.json"),
              "w") as f:
        json.dump(out, f)
    close_dist_env()
    return 0


# --------------------------------------------------------------- fixtures
def _env() -> dict:
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               FLEETX_LOG_LEVEL="WARNING")
    for var in ("FLEETX_FAULTS", "FLEETX_COORDINATOR",
                "FLEETX_NUM_PROCESSES", "FLEETX_PROCESS_ID",
                "FLEETX_FLIGHT_DIR"):
        env.pop(var, None)
    return env


def _supervise(workdir: str, extra: list, worker: list) -> tuple:
    """One supervised 2-rank gang of this file's worker, to its end:
    ``(rc, stderr)``."""
    proc = subprocess.Popen(
        SUPERVISE + ["--num-procs", "2", "--max-restart", "0",
                     "--preemption-code", "75"] + extra + ["--"]
        + [sys.executable, os.path.abspath(__file__), "worker",
           "--workdir", workdir] + worker,
        cwd=REPO, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        _, err = proc.communicate(timeout=DEADLINE_S)
    except subprocess.TimeoutExpired:
        proc.terminate()
        _, err = proc.communicate(timeout=60)
        return None, f"supervise exceeded {DEADLINE_S}s\n{err[-3000:]}"
    return proc.returncode, err


def _statuses(tpl: str) -> dict:
    out = {}
    for rank in (0, 1):
        path = tpl.format(rank=rank)
        if os.path.exists(path):
            with open(path) as f:
                out[rank] = json.load(f)
    return out


def _gen(workdir: str, root: str, steps: int, seed: int, extra=(),
         **kw) -> dict:
    """One generation of a drill: ``{"rc", "err", "status"}`` (the status
    files of this generation only)."""
    tpl = os.path.join(root, "status_{rank}.json")
    for rank in (0, 1):
        if os.path.exists(tpl.format(rank=rank)):
            os.remove(tpl.format(rank=rank))
    worker = ["--out", os.path.join(root, "ckpt"), "--status", tpl,
              "--steps", str(steps), "--seed", str(seed)]
    for key, flag in (("save_steps", "--save-steps"), ("faults", "--faults"),
                      ("sdc_every", "--sdc-every"),
                      ("coord_timeout", "--coord-timeout")):
        if kw.get(key):
            worker += [flag, str(kw[key])]
    for key in ("guard_rollback", "uneven", "obs"):
        if kw.get(key):
            worker.append("--" + key.replace("_", "-"))
    rc, err = _supervise(workdir, list(extra), worker)
    return {"rc": rc, "err": err, "status": _statuses(tpl)}


def _drill_sigterm(workdir, root):
    first = _gen(workdir, root, 6, 21, faults="sigterm_at=3,only_rank=0")
    latest = [_latest(os.path.join(root, "ckpt", f"rank_{r}"))
              for r in (0, 1)]
    return {"first": first, "latest": latest,
            "resumed": _gen(workdir, root, 6, 21)}


def _drill_nan_rollback(workdir, root):
    return _gen(workdir, root, 6, 4, save_steps=2, guard_rollback=True,
                faults="nan_loss_at=2:3,only_rank=1")


def _drill_uneven(workdir, root):
    return _gen(workdir, root, 5, 11, uneven=True)


def _drill_corrupt_shard(workdir, root):
    return _gen(workdir, root, 4, 23, save_steps=2,
                faults="corrupt_ckpt_at=2,only_rank=1")


def _drill_bitflip(workdir, root):
    return _gen(workdir, root, 4, 27, sdc_every=1,
                faults="bitflip_param_at=2,only_rank=1")


def _drill_divergent_views(workdir, root):
    """Step 2 saved on both ranks; then, on two copies of that state at
    once, rank 1's directory grows a fake newer step (meta only), and
    rank 1's directory loses rank 0's step."""
    from fleetx_tpu_torch.core import checkpoint as C

    out = {"first": _gen(workdir, root, 2, 5, save_steps=2)}
    rank1 = os.path.join(root, "ckpt", "rank_1")
    out["rank1_latest"] = _latest(rank1)
    roots = {}
    for case in ("newer", "lacking"):
        roots[case] = os.path.join(root, case)
        shutil.copytree(os.path.join(root, "ckpt"),
                        os.path.join(roots[case], "ckpt"))
    fake = os.path.join(roots["newer"], "ckpt", "rank_1", "step_4")
    os.makedirs(fake)
    with open(os.path.join(fake, C.META_NAME), "w") as f:
        json.dump({"step": 4, "consumed_samples": 999}, f)
    shutil.rmtree(os.path.join(roots["lacking"], "ckpt", "rank_1",
                               "step_2"))
    shutil.copytree(fake, os.path.join(roots["lacking"], "ckpt", "rank_1",
                                       "step_4"))
    with ThreadPoolExecutor(2) as pool:
        futs = {case: pool.submit(_gen, workdir, r, 2, 5, save_steps=2)
                for case, r in roots.items()}
        out.update({case: f.result() for case, f in futs.items()})
    return out


def _drill_metric_merge(workdir, root):
    return _gen(workdir, root, 4, 33, obs=True,
                extra=["--flight-dir", os.path.join(root, "flight")])


def _drill_crash_flight(workdir, root):
    return _gen(workdir, root, 6, 13, obs=True, coord_timeout=10,
                faults="data_raise_at=2,only_rank=1",
                extra=["--flight-dir", os.path.join(root, "flight")])


def _latest(directory: str):
    from fleetx_tpu_torch.core import checkpoint as C

    return C.latest_step(directory)


DRILLS = {
    "sigterm_one_rank_saves_same_step_then_resumes": _drill_sigterm,
    "nan_on_one_rank_collective_rollback": _drill_nan_rollback,
    "uneven_stream_exhaustion_is_collective": _drill_uneven,
    "corrupt_shard_aborts_commit_on_both_ranks": _drill_corrupt_shard,
    "bitflip_on_one_rank_trips_fingerprint": _drill_bitflip,
    "divergent_checkpoint_views_follow_rank0_or_fail":
        _drill_divergent_views,
    "metric_aggregation_merges_ranks": _drill_metric_merge,
    "crash_leaves_flight_dumps_postmortem_names_rank": _drill_crash_flight,
}


def _refusal_gang(workdir: str) -> list:
    """The step-0 gang: two gloo ranks, each building an engine on a mesh
    of one without ``per_rank_dirs``."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "refusal", workdir],
        cwd=REPO, env=dict(_env(), FLEETX_COORDINATOR=f"127.0.0.1:{port}",
                           FLEETX_NUM_PROCESSES="2",
                           FLEETX_PROCESS_ID=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    out = []
    for r, p in enumerate(procs):
        try:
            log, _ = p.communicate(timeout=DEADLINE_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise AssertionError("the step-0 gang did not finish")
        path = os.path.join(workdir, f"refusal{r}.json")
        assert p.returncode == 0 and os.path.exists(path), log[-4000:]
        with open(path) as f:
            out.append(json.load(f))
    return out


@pytest.fixture(scope="module")
def drills(tmp_path_factory):
    """Every drill gang at once; meanwhile JAX's one-device curve and the
    port's uninterrupted one-rank run of the SIGTERM drill's batches."""
    import jax
    from flax.core import meta

    from fleetx_tpu.parallel.mesh import build_mesh
    from fleetx_tpu_torch.convert import params_from_jax
    from fleetx_tpu_torch.core.checkpoint import flatten
    from fleetx_tpu_torch.core.module import GPTModule
    from test_engine import build_engine
    from test_engine import make_batches as j_batches
    from test_engine import tiny_cfg

    workdir = str(tmp_path_factory.mktemp("gang_resilience"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = tiny_cfg()
        cfg["Engine"]["max_steps"] = 6
        with open(os.path.join(workdir, "cfg.json"), "w") as f:
            json.dump(tiny_cfg(), f)
        jeng = build_engine(cfg, build_mesh({}, devices=jax.devices()[:1]))
        ref_batches = make_batches(6, seed=21)
        for mine, theirs in zip(ref_batches, j_batches(6, seed=21)):
            assert all(np.array_equal(mine[k], theirs[k]) for k in mine)
        jeng.prepare(ref_batches[0])
        init = jax.device_get(meta.unbox(jeng.state.params))
        conv = params_from_jax(init, GPTModule(tiny_cfg()).model_cfg)
        np.savez(os.path.join(workdir, "init.npz"),
                 **{k: v.numpy() for k, v in flatten(conv).items()})
        with ThreadPoolExecutor(len(DRILLS) + 1) as pool:
            futures = {}
            for name, fn in DRILLS.items():
                root = os.path.join(workdir, name)
                os.makedirs(root)
                futures[name] = pool.submit(fn, workdir, root)
            refusal = pool.submit(_refusal_gang, workdir)
            jax_losses = jeng.fit(ref_batches)
            one_cfg = tiny_cfg()
            one_cfg["Engine"]["max_steps"] = 6
            one = _port_engine(one_cfg, workdir).fit(make_batches(6, 21))
            results = {name: _outcome(f) for name, f in futures.items()}
            refused = _outcome(refusal)
        yield {"workdir": workdir, "jax": jax_losses, "one": one,
               "results": results, "refusal": refused}
    finally:
        torch.set_num_threads(threads)


def _outcome(future):
    """A gang's result, or the exception its driver raised: each test
    re-raises its own, so one gang's failure fails only its test."""
    try:
        return future.result()
    except Exception as e:  # noqa: BLE001 — re-raised by the test
        return e


def _result(outcome):
    if isinstance(outcome, Exception):
        raise outcome
    return outcome


# ----------------------------------------------------------- drill checks
def _ok(gen: dict, rc: int) -> dict:
    assert gen["rc"] == rc, gen["err"][-4000:]
    assert sorted(gen["status"]) == [0, 1], gen["err"][-4000:]
    return gen["status"]


def check_sigterm(drills, r):
    """SIGTERM on rank 0 alone: both ranks save step 3 and exit 75; the
    next gang resumes step 3 on both ranks and its losses are JAX's
    one-device curve's and bit for bit the port's uninterrupted run's."""
    for st in _ok(r["first"], 75).values():
        assert st["exit"] == "preempted", st
        assert st["final_step"] == 3 and st["ckpt_latest"] == 3, st
        assert st["preemption_exits"] == 1, st
    assert r["latest"] == [3, 3]
    for st in _ok(r["resumed"], 0).values():
        assert st["exit"] == "completed", st
        assert st["resume_from"] == 3 and st["final_step"] == 6, st
        np.testing.assert_allclose(st["losses"], drills["jax"][3:],
                                   rtol=0, atol=1e-5)
        assert st["losses"] == drills["one"][3:]


def check_nan_rollback(drills, r):
    """A NaN window on rank 1 rolls BOTH ranks back once to step 2; the
    replayed poison then aborts both (rc 3) at step 4."""
    for st in _ok(r, 3).values():
        assert st["exit"] == "aborted", st
        assert st["rollbacks"] == 1, st
        assert st["final_step"] == 4 and st["ckpt_latest"] == 2, st


def check_uneven(drills, r):
    """Rank 1's stream runs dry one batch early: the exit is voted and
    both ranks end at its step count."""
    for st in _ok(r, 0).values():
        assert st["exit"] == "completed", st
        assert st["final_step"] == 4 and len(st["losses"]) == 4, st


def check_corrupt_shard(drills, r):
    """Rank 1's step-2 shard fails its read-back: the commit aborts on
    both ranks (no step 2 anywhere), step 4 commits, training goes on."""
    sts = _ok(r, 0)
    for st in sts.values():
        assert st["exit"] == "completed" and st["final_step"] == 4, st
        assert st["ckpt_completed"] == [4], st
        assert st["ckpt_commit_aborts"] >= 1, st
    assert sts[1]["ckpt_verify_failed"] >= 1
    assert sts[0]["ckpt_verify_failed"] == 0


def check_bitflip(drills, r):
    """A bit flipped on rank 1 after step 2: the fingerprint census
    diverges on BOTH ranks; each replay is self-consistent."""
    for st in _ok(r, 0).values():
        assert st["exit"] == "completed", st
        assert st["sdc_checks_total"] >= 3, st
        assert st["sdc_fingerprint_mismatches"] >= 1, st
        assert st["sdc_replay_mismatches"] == 0, st


def check_divergent_views(drills, r):
    """A rank with a newer local step follows rank 0's; a rank lacking
    rank 0's step refuses ("divergent checkpoint views", rc 4)."""
    _ok(r["first"], 0)
    assert r["rank1_latest"] == 2
    for st in _ok(r["newer"], 0).values():
        assert st["final_step"] == 2, st
    assert r["lacking"]["rc"] == 4, r["lacking"]["err"][-4000:]
    st1 = r["lacking"]["status"][1]
    assert st1["exit"] == "error", st1
    assert "divergent checkpoint views" in st1["error"], st1


def check_metric_merge(drills, r):
    """Per-rank ``metrics.rank<i>.jsonl`` stamped with rank, world and
    schema version; rank 0's ``metrics.gang.jsonl`` holds the merged
    windows; the offline report merges the per-rank files; no flight
    dump on a clean run."""
    from fleetx_tpu_torch.tools import metrics_report as mr

    root = os.path.join(drills["workdir"],
                        "metric_aggregation_merges_ranks")
    out = os.path.join(root, "ckpt")
    for rank, st in _ok(r, 0).items():
        assert st["exit"] == "completed", st
        assert st["barrier_waits"] > 0 and st["coord_agreements"] > 0, st
        per_rank = os.path.join(out, f"rank_{rank}", "telemetry",
                                f"metrics.rank{rank}.jsonl")
        with open(per_rank) as f:
            records = [json.loads(line) for line in f]
        assert len(records) == 4
        for rec in records:
            assert rec["rank"] == rank and rec["world"] == 2, rec
            assert rec["schema_version"] == 2, rec
    gang_file = os.path.join(out, "rank_0", "telemetry", "metrics.gang.jsonl")
    assert not os.path.exists(os.path.join(
        out, "rank_1", "telemetry", "metrics.gang.jsonl"))
    with open(gang_file) as f:
        merged = [json.loads(line) for line in f]
    assert len(merged) == 4
    for rec in merged:
        assert rec["scope"] == "gang" and rec["world"] == 2, rec
        assert rec["ranks_reported"] == 2, rec
        assert rec["step_time_max_rank"] in (0, 1), rec
        assert rec["step_time_min"] <= rec["step_time_median"] \
            <= rec["step_time_max"], rec
        assert rec["step_time"] == rec["step_time_max"], rec
        assert rec["tokens_per_sec"] > 0, rec
        assert rec["rollbacks_total"] == 0 and rec["preemption_exits"] == 0
    assert [rec["step"] for rec in merged] == [1, 2, 3, 4]
    assert mr.main([os.path.join(out, "rank_*", "telemetry",
                                 "metrics.rank*.jsonl")]) == 0
    assert not glob.glob(os.path.join(root, "flight", "**",
                                      "flight_rank*.json"), recursive=True)


def check_crash_flight(drills, r):
    """Rank 1 dies in its data path: rank 0's next vote expires with the
    census naming rank 1, both flight rings are dumped under the
    supervisor's per-generation directories, and the post-mortem names
    rank 1 as first diverging."""
    from fleetx_tpu_torch.tools import postmortem as pm

    assert r["rc"] == 4, r["err"][-4000:]
    sts = r["status"]
    assert sts[1]["exit"] == "error" and "InjectedFault" in sts[1]["error"]
    assert sts[0]["exit"] == "error", sts[0]
    assert "CoordinationTimeout" in sts[0]["error"], sts[0]
    flight_dir = os.path.join(
        drills["workdir"], "crash_leaves_flight_dumps_postmortem_names_rank",
        "flight")
    r0 = os.path.join(flight_dir, "gen0", "rank0", "flight_rank0.json")
    r1 = os.path.join(flight_dir, "gen0", "rank1", "flight_rank1.json")
    assert os.path.exists(r0) and os.path.exists(r1), r["err"][-4000:]
    assert "flight-recorder dumps" in r["err"]
    assert "postmortem" in r["err"]
    with open(r0) as f:
        dump0 = json.load(f)
    assert dump0["reason"].startswith("crash:CoordinationTimeout")
    assert any(e["kind"] == "coord_timeout" and e["missing"] == [1]
               for e in dump0["events"]), dump0["events"][-5:]
    with open(r1) as f:
        assert json.load(f)["reason"].startswith("crash:InjectedFault")
    dumps, errors = pm.load_dumps(pm.find_flight_files([flight_dir]))
    assert errors == [] and sorted(dumps) == [0, 1]
    rep = pm.report(dumps, tail=20)
    assert rep["first_diverging_rank"] == 1, rep
    assert rep["diverging_evidence"] == "coordination-timeout census"
    assert pm.main([os.path.join(flight_dir, "gen0")]) == 0


CHECKS = {
    "sigterm_one_rank_saves_same_step_then_resumes": check_sigterm,
    "nan_on_one_rank_collective_rollback": check_nan_rollback,
    "uneven_stream_exhaustion_is_collective": check_uneven,
    "corrupt_shard_aborts_commit_on_both_ranks": check_corrupt_shard,
    "bitflip_on_one_rank_trips_fingerprint": check_bitflip,
    "divergent_checkpoint_views_follow_rank0_or_fail":
        check_divergent_views,
    "metric_aggregation_merges_ranks": check_metric_merge,
    "crash_leaves_flight_dumps_postmortem_names_rank": check_crash_flight,
}


@pytest.mark.parametrize("drill", sorted(DRILLS))
def test_gang_drill(drills, drill):
    CHECKS[drill](drills, _result(drills["results"][drill]))


def test_resumed_losses_hold_to_jax_and_the_uninterrupted_run(drills):
    """The port's uninterrupted one-rank run of the SIGTERM drill's
    batches is JAX's one-device curve within 1e-5 (the gang's resumed
    losses are held to both in the SIGTERM drill)."""
    np.testing.assert_allclose(drills["one"], drills["jax"], rtol=0,
                               atol=1e-5)


def test_one_rank_mesh_on_a_gang_needs_per_rank_dirs(drills):
    """The step-0 fault: a rank of a 2-process gang given a mesh of one
    rank, without ``per_rank_dirs``, raises JAX's ``ValueError`` in its
    words (``fleetx_tpu/core/engine/eager_engine.py:218-228``)."""
    for r, out in enumerate(_result(drills["refusal"])):
        assert out["rank"] == r
        assert out["raised"] == [
            "ValueError",
            "a multi-process run on a process-local mesh requires "
            "Engine.save_load.per_rank_dirs: true — shared checkpoint "
            "storage only composes with a mesh that spans processes"]


# ------------------------------------------------------------------- units
class _FakeStore:
    """An in-process stand-in with ``TCPStore``'s API (thread-safe): a
    ``wait`` that runs out of time raises ``DistStoreError``."""

    def __init__(self):
        self.data = {}
        self.lock = threading.Lock()
        self.checks = 0

    def set(self, key, value):
        with self.lock:
            self.data[key] = value.encode() if isinstance(value, str) \
                else value

    def get(self, key):
        with self.lock:
            return self.data[key]

    def check(self, keys):
        with self.lock:
            self.checks += 1
            return all(k in self.data for k in keys)

    def delete_key(self, key):
        with self.lock:
            return self.data.pop(key, None) is not None

    def wait(self, keys, timeout):
        deadline = time.monotonic() + timeout.total_seconds()
        while time.monotonic() < deadline:
            with self.lock:
                if all(k in self.data for k in keys):
                    return
            time.sleep(0.002)
        raise torch.distributed.DistStoreError(f"wait timeout: {keys}")


def test_local_coordinator_is_inert_and_severity_orders_like_jax():
    """The world-1 coordinator and ``most_severe`` give JAX's values on
    the same calls."""
    from fleetx_tpu.resilience import coordination as J
    from fleetx_tpu_torch.resilience.coordination import (LocalCoordinator,
                                                          most_severe)

    for c in (LocalCoordinator(), J.LocalCoordinator()):
        assert c.world == 1 and c.rank == 0
        c.barrier("b")
        assert c.broadcast("x", {"step": 3}) == {"step": 3}
        assert c.any_flag("f", False) is False
        assert c.any_flag("f", True) is True
        assert c.all_gather("g", 7) == {0: 7}
        assert c.majority("m", "v") == "v"
    for votes in ([None, None], [None, "rollback"],
                  ["rollback", "abort", None], []):
        assert most_severe(votes) == J.most_severe(votes)


def _pair(store):
    from fleetx_tpu_torch.resilience.coordination import \
        DistributedCoordinator

    return (DistributedCoordinator(store, 0, 2),
            DistributedCoordinator(store, 1, 2))


def _tcp_pair():
    """Rank 0's coordinator on a real in-process ``TCPStore`` master, rank
    1's on a client of it; ``(r0, r1, master)``."""
    import torch.distributed as dist

    from fleetx_tpu_torch.resilience.coordination import (
        NAMESPACE, DistributedCoordinator)

    t = datetime.timedelta(seconds=30)
    master = dist.TCPStore("127.0.0.1", 0, 2, True, timeout=t,
                           wait_for_workers=False)
    client = dist.TCPStore("127.0.0.1", master.port, 2, False, timeout=t)
    r0 = DistributedCoordinator(dist.PrefixStore(NAMESPACE, master), 0, 2)
    r1 = DistributedCoordinator(dist.PrefixStore(NAMESPACE, client), 1, 2)
    return r0, r1, master


@pytest.mark.parametrize("store", ["fake", "tcp"])
def test_distributed_any_flag_or_and_gather(store):
    r0, r1 = _pair(_FakeStore()) if store == "fake" else _tcp_pair()[:2]
    with ThreadPoolExecutor(2) as pool:
        f1 = pool.submit(r1.any_flag, "preempt", True)
        f0 = pool.submit(r0.any_flag, "preempt", False)
        assert f0.result(timeout=10) is True  # one rank's flag ORs to all
        assert f1.result(timeout=10) is True
        g1 = pool.submit(r1.all_gather, "d", "rollback")
        g0 = pool.submit(r0.all_gather, "d", None)
        assert g0.result(timeout=10) == {0: None, 1: "rollback"}
        assert g1.result(timeout=10) == {0: None, 1: "rollback"}


def test_distributed_gather_success_needs_no_census_probe():
    """The per-peer waits return every payload: a successful agreement
    probes no key (the once-per-step ``loop_flags`` vote)."""
    store = _FakeStore()
    r0, r1 = _pair(store)
    with ThreadPoolExecutor(2) as pool:
        g1 = pool.submit(r1.all_gather, "d", 1)
        g0 = pool.submit(r0.all_gather, "d", 0)
        assert g0.result(timeout=10) == {0: 0, 1: 1}
        assert g1.result(timeout=10) == {0: 0, 1: 1}
    assert store.checks == 0


@pytest.mark.parametrize("store", ["fake", "tcp"])
def test_distributed_barrier_timeout_names_stragglers(store):
    from fleetx_tpu_torch.resilience.coordination import CoordinationTimeout

    r0 = _pair(_FakeStore())[0] if store == "fake" else _tcp_pair()[0]
    with pytest.raises(CoordinationTimeout) as excinfo:
        r0.barrier("sync", timeout_s=0.2)
    assert excinfo.value.arrived == [0]
    assert excinfo.value.missing == [1]  # the straggler set, by rank
    assert "missing ranks [1]" in str(excinfo.value)


def test_distributed_client_error_is_not_a_straggler_census():
    """A wait that fails FAST (a dropped connection, not an expired
    deadline) re-raises the store's error; a real client whose store host
    is gone fails at once (``DistNetworkError``), well within the
    deadline."""
    import torch.distributed as dist

    from fleetx_tpu_torch.resilience.coordination import \
        DistributedCoordinator

    class _BrokenStore(_FakeStore):
        def wait(self, keys, timeout):
            raise RuntimeError("UNAVAILABLE: connection dropped")

    r0 = DistributedCoordinator(_BrokenStore(), 0, 2)
    with pytest.raises(RuntimeError, match="UNAVAILABLE"):
        r0.barrier("sync", timeout_s=5.0)
    r1 = DistributedCoordinator(_BrokenStore(), 1, 2)
    with pytest.raises(RuntimeError, match="UNAVAILABLE"):
        r1.broadcast("resume", None, timeout_s=5.0)
    r0, r1, master = _tcp_pair()
    del r0, master  # the store's host goes
    t0 = time.monotonic()
    with pytest.raises(dist.DistNetworkError):
        r1.barrier("sync", timeout_s=20.0)
    assert time.monotonic() - t0 < 10.0


@pytest.mark.parametrize("store", ["fake", "tcp"])
def test_distributed_broadcast_and_rank0_absence(store):
    from fleetx_tpu_torch.resilience.coordination import CoordinationTimeout

    r0, r1 = _pair(_FakeStore()) if store == "fake" else _tcp_pair()[:2]
    with ThreadPoolExecutor(2) as pool:
        got = pool.submit(r1.broadcast, "resume", None)
        assert r0.broadcast("resume", {"step": 5}) == {"step": 5}
        assert got.result(timeout=10) == {"step": 5}
    with pytest.raises(CoordinationTimeout) as excinfo:
        r1.broadcast("other", None, timeout_s=0.2)
    assert excinfo.value.missing == [0]  # rank 0 never published
    assert excinfo.value.arrived == []


def test_distributed_majority_deterministic_tie_break():
    r0, r1 = _pair(_FakeStore())
    with ThreadPoolExecutor(2) as pool:
        f1 = pool.submit(r1.majority, "m", "b")
        f0 = pool.submit(r0.majority, "m", "a")
        # 1-1 tie: both ranks resolve the SAME winner (lowest rank's)
        assert f0.result(timeout=10) == "a"
        assert f1.result(timeout=10) == "a"


def test_collective_wait_metrics_and_skew():
    """Every agreement records its wait into ``barrier_wait_ms`` and
    feeds the arrival census to the installed hook: the rolling skew
    names the straggler."""
    from fleetx_tpu_torch.observability import gang as obs_gang
    from fleetx_tpu_torch.observability.metrics import (DerivedMetrics,
                                                        get_registry)

    r0, r1 = _pair(_FakeStore())
    derived = DerivedMetrics(ewma_alpha=1.0)
    censuses = []

    def hook(arrivals):
        censuses.append(arrivals)
        derived.update_arrivals(arrivals)

    prev = obs_gang.set_arrival_hook(hook)
    reg = get_registry()
    base = reg.histogram("barrier_wait_ms").summary().get("count", 0)
    try:
        with ThreadPoolExecutor(2) as pool:
            f1 = pool.submit(r1.all_gather, "skew_probe", 1)
            time.sleep(0.25)  # rank 0 is the straggler this round
            f0 = pool.submit(r0.all_gather, "skew_probe", 0)
            assert f0.result(timeout=10) == {0: 0, 1: 1}
            assert f1.result(timeout=10) == {0: 0, 1: 1}
    finally:
        obs_gang.set_arrival_hook(prev)
    assert len(censuses) == 2
    assert censuses[0][0] - censuses[0][1] > 0.15
    assert derived.slowest_rank() == 0
    assert derived.rank_skew()[0] > 0.05
    assert reg.histogram("barrier_wait_ms").summary()["count"] >= base + 2
    assert reg.gauge("coord_last_rank").value == 0


def test_distributed_gather_garbage_collects_old_generations():
    store = _FakeStore()
    r0, r1 = _pair(store)
    with ThreadPoolExecutor(2) as pool:
        for _ in range(3):
            a = pool.submit(r1.barrier, "gc")
            r0.barrier("gc")
            a.result(timeout=10)
    live = [k for k in store.data if k.startswith("gc/")]
    # generations 0..1 pruned by both ranks; only the newest remains
    assert live and all(k.split("/")[1] == "2" for k in live), live


def test_gang_coordinator_needs_the_gang_store(monkeypatch):
    """A process group of more than one rank without the gang's store
    raises: a gang never decides as a world of one."""
    from fleetx_tpu_torch.resilience import coordination
    from fleetx_tpu_torch.utils import env

    monkeypatch.setattr(coordination, "_coordinator", None)
    monkeypatch.setattr(env, "get_world_size", lambda: 2)
    monkeypatch.setattr(env, "get_store", lambda: None)
    with pytest.raises(RuntimeError, match="without the gang's store"):
        coordination.get_coordinator()
    monkeypatch.setattr(coordination, "_coordinator", None)


def test_preemption_latch_propagates_without_a_signal():
    from fleetx_tpu_torch.resilience.preemption import PreemptionHandler

    h = PreemptionHandler()
    assert not h.triggered
    h.latch("peer rank")
    h.latch("again")  # idempotent
    assert h.triggered


def test_gang_watchdog_names_stragglers_and_counts(monkeypatch):
    """``GangWatchdog`` rendezvous every ``gang_sync_steps`` calls; a
    timeout logs the census and counts ``watchdog_gang_stalls``; it is
    None at world 1 (JAX's ``from_cfg``)."""
    from fleetx_tpu_torch.observability import flight
    from fleetx_tpu_torch.observability.metrics import MetricsRegistry
    from fleetx_tpu_torch.resilience import Resilience
    from fleetx_tpu_torch.resilience.coordination import LocalCoordinator
    from fleetx_tpu_torch.resilience.watchdog import GangWatchdog

    cfg = {"enable": True, "watchdog": {"enable": True,
                                        "gang_sync_steps": 2,
                                        "gang_timeout_s": 0.2}}
    assert Resilience(cfg).make_gang_watchdog(LocalCoordinator()) is None
    r0, r1 = _pair(_FakeStore())
    reg = MetricsRegistry()
    monkeypatch.setattr(flight, "dump", lambda reason: None)
    wd = GangWatchdog.from_cfg(cfg["watchdog"], r0, registry=reg)
    assert wd.sync_steps == 2 and wd.timeout_s == 0.2
    wd.check(1)  # odd call: no rendezvous
    wd.check(2)  # rank 1 never arrives
    assert reg.counter("watchdog_gang_stalls").value == 1
    # a healthy gang meets every second call and counts nothing
    r0, r1 = _pair(_FakeStore())
    wds = [GangWatchdog.from_cfg(cfg["watchdog"], c, registry=reg)
           for c in (r0, r1)]
    with ThreadPoolExecutor(2) as pool:
        futs = [pool.submit(lambda w=w: [w.check(i) for i in (1, 2, 3, 4)])
                for w in wds]
        for fut in futs:
            fut.result(timeout=10)
    assert reg.counter("watchdog_gang_stalls").value == 1


def test_per_rank_checkpoint_codec_roundtrip(tmp_path):
    """The per-rank mode's save and restore: meta published by this rank,
    ``latest_step`` sees it, bf16 and int leaves round-trip bit for
    bit."""
    from fleetx_tpu_torch.core import checkpoint as C

    C.set_per_rank_mode(True)
    try:
        state = {"w": torch.arange(8, dtype=torch.float32).reshape(2, 4),
                 "b": torch.arange(4).to(torch.bfloat16), "step": 3}
        path = C.save_checkpoint(str(tmp_path), 3, state,
                                 meta={"consumed_samples": 48})
        assert os.path.exists(os.path.join(path, C.STATE_NAME))
        assert C.latest_step(str(tmp_path)) == 3
        got, meta = C.load_checkpoint(str(tmp_path), 3)
        assert torch.equal(got["w"], state["w"])
        assert got["b"].dtype == torch.bfloat16 and \
            torch.equal(got["b"], state["b"])
        assert int(got["step"]) == 3
        assert meta["consumed_samples"] == 48 and meta["step"] == 3
    finally:
        C.set_per_rank_mode(False)


def test_per_rank_mode_is_engine_scoped_global():
    from fleetx_tpu_torch.core import checkpoint as C

    assert C.per_rank_mode() is False
    C.set_per_rank_mode(True)
    assert C.per_rank_mode() is True
    C.set_per_rank_mode(False)
    assert C.per_rank_mode() is False


def test_gang_commit_gate_skips_agreement_when_disabled(monkeypatch,
                                                        tmp_path):
    """With the commit off a save completes without touching the
    coordinator (an unmatched vote would wedge for the deadline)."""
    from fleetx_tpu_torch.core import checkpoint as C
    from fleetx_tpu_torch.resilience import coordination

    class _Tripwire:
        world = 2

        def barrier(self, *a, **k):
            raise AssertionError("commit vote must be skipped")

        any_flag = all_gather = broadcast = barrier

    monkeypatch.setattr(coordination, "_coordinator", _Tripwire())
    C.set_per_rank_mode(True)
    C.set_gang_commit(False)
    try:
        C.save_checkpoint(str(tmp_path), 1, {"w": np.zeros(2, np.float32)},
                          meta={})
        assert C.latest_step(str(tmp_path)) == 1
    finally:
        C.set_per_rank_mode(False)
        C.set_gang_commit(True)
        monkeypatch.setattr(coordination, "_coordinator", None)


def test_commit_vote_of_a_failed_shard_aborts_and_a_peer_vote_abandons(
        monkeypatch, tmp_path):
    """A sticky read-back failure on a gang becomes this rank's failed
    ``ckpt_commit`` vote (no meta, ``ckpt_commit_aborts``); an
    asynchronous save whose local write succeeded is abandoned when a peer
    votes a failure, and the vote carries the LOCAL outcome."""
    from fleetx_tpu_torch.core import checkpoint as C
    from fleetx_tpu_torch.observability.metrics import get_registry
    from fleetx_tpu_torch.resilience import coordination
    from fleetx_tpu_torch.resilience import faults as F

    calls = []

    class _Coord:
        world = 2
        peer_fails = False

        def any_flag(self, name, flag, timeout_s=None):
            calls.append((name, flag))
            return flag or self.peer_fails

    coord = _Coord()
    monkeypatch.setattr(coordination, "_coordinator", coord)
    reg = get_registry()
    aborts = reg.counter("ckpt_commit_aborts").value
    C.set_per_rank_mode(True)
    try:
        F.install_plan(F.FaultPlan(corrupt_ckpt_at=2))
        # a leaf large enough that the middle byte of the file is its own
        C.save_checkpoint(str(tmp_path), 2,
                          {"w": np.ones(4096, np.float32)})
        assert calls == [("ckpt_commit", True)]
        assert C.latest_step(str(tmp_path)) is None
        assert not os.path.exists(os.path.join(str(tmp_path), "step_2"))
        assert reg.counter("ckpt_commit_aborts").value == aborts + 1
        F.install_plan(None)
        coord.peer_fails = True
        calls.clear()
        C.save_checkpoint(str(tmp_path), 4, {"w": np.ones(4, np.float32)},
                          async_save=True)
        C.finalize_async_saves()
        assert calls == [("ckpt_commit", False)]  # voted the local outcome
        assert C._pending == []
        assert not os.path.exists(os.path.join(str(tmp_path), "step_4"))
        assert C.latest_step(str(tmp_path)) is None
    finally:
        F.install_plan(None)
        C.set_per_rank_mode(False)
        monkeypatch.setattr(coordination, "_coordinator", None)


class _Gang2:
    """A coordinator stand-in of a 2-rank gang (no agreement is run)."""

    world = 2

    def __init__(self, rank: int):
        self.rank = rank


def _gang_engine(monkeypatch, tmp_path, rank: int, cfg: dict):
    from fleetx_tpu_torch.core import checkpoint as C
    from fleetx_tpu_torch.parallel.mesh import build_mesh
    from fleetx_tpu_torch.resilience import coordination
    from fleetx_tpu_torch.utils.log import set_rank_context

    from fleetx_tpu_torch.core.engine import EagerEngine
    from fleetx_tpu_torch.core.module import GPTModule

    monkeypatch.setattr(coordination, "_coordinator", _Gang2(rank))
    try:
        return EagerEngine(cfg, GPTModule(cfg), device="cpu",
                           mesh=build_mesh({}, world_size=1))
    finally:
        C.set_per_rank_mode(False)
        C.set_gang_commit(True)
        set_rank_context(0, 1)
        monkeypatch.setattr(coordination, "_coordinator", None)


def _tiny_gpt_cfg() -> dict:
    return {"Model": {"vocab_size": VOCAB, "hidden_size": 64,
                      "num_layers": 2, "num_attention_heads": 4,
                      "max_position_embeddings": SEQ,
                      "use_flash_attention": False, "dtype": "float32"},
            "Engine": {"max_steps": 1}, "Global": {"seed": 7}}


def test_per_rank_warm_start_falls_back_to_shared_layout(monkeypatch,
                                                         tmp_path):
    """``per_rank_dirs`` keeps a shared-layout ``ckpt_dir`` that has no
    ``rank_<i>`` subdirectory (restoring it directly), and takes the
    rank's subdirectory when there is one."""
    shared = tmp_path / "shared_ckpt"
    shared.mkdir()
    cfg = _tiny_gpt_cfg()
    cfg["Engine"]["save_load"] = {"per_rank_dirs": True,
                                  "ckpt_dir": str(shared),
                                  "output_dir": str(tmp_path / "out")}
    eng = _gang_engine(monkeypatch, tmp_path, 1, cfg)
    assert eng.ckpt_dir == str(shared)
    assert eng.output_dir.endswith("rank_1") and eng.per_rank_ckpt
    (shared / "rank_1").mkdir()
    eng = _gang_engine(monkeypatch, tmp_path, 1, cfg)
    assert eng.ckpt_dir == str(shared / "rank_1")


def test_per_rank_gang_forces_in_step_skip_off(monkeypatch, tmp_path):
    from fleetx_tpu_torch.resilience import coordination, faults
    from fleetx_tpu_torch.resilience.policy import set_default_policy

    cfg = _tiny_gpt_cfg()
    cfg["Engine"]["save_load"] = {"per_rank_dirs": True,
                                  "output_dir": str(tmp_path / "out")}
    cfg["Resilience"] = {"enable": True,
                         "guard": {"enable": True,
                                   "skip_nonfinite_update": True}}
    try:
        eng = _gang_engine(monkeypatch, tmp_path, 0, cfg)
        assert eng.resilience.guard_skip is False
        assert eng.resilience.guard.skip_active is False
        assert eng.check_finite is False
    finally:
        faults.install_plan(None)
        set_default_policy(None)
        coordination.configure(None, None)


def test_engine_refuses_shared_dir_on_process_local_mesh(monkeypatch,
                                                         tmp_path):
    with pytest.raises(ValueError, match="per_rank_dirs"):
        _gang_engine(monkeypatch, tmp_path, 0, _tiny_gpt_cfg())


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    torch.set_num_threads(1)
    sys.exit({"worker": _worker, "refusal": _refusal_member}[sys.argv[1]](
        sys.argv[2:]))
