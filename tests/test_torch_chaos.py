"""The replica's chaos knobs and the router in front of real replicas,
against the JAX package.

- ``FaultPlan`` built from the same ``FLEETX_FAULTS`` spec gives the same
  ``decode_delay_s``, ``blackholed`` and ``take_crash_mid_write``
  decisions as JAX's over a scripted sequence of work steps and
  responses; ``NOT_PORTED`` is empty.
- Weights: ``tests/test_zz_serving.py``'s tiny config, initialised by
  JAX and converted with ``convert.params_from_jax``, saved as a port
  checkpoint the replicas serve (``Serving.ckpt_dir``). The reference is
  the JAX ``ServingEngine``'s greedy tokens for the same prompts (its
  Pallas decode in interpret mode).
- In process: the port's ``Router`` in front of two in-process
  ``ReplicaServer``s, one blackholed after its first response and one a
  straggler; every answer equals JAX's, the blackholed backend's breaker
  opens on a failed probe, and ``close()`` releases the connections it
  holds.
- Subprocesses: ``tools.serve --router`` in front of two ``--device cpu``
  replica processes, one of them with ``crash_mid_write``: every answer
  equals JAX's, the crashed replica exits 70, its torn response is
  re-dispatched (the router's counters, fleet records valid under both
  packages' schema, a merged ``trace``); and a replica with
  ``Resilience.faults.sigterm_at`` in its config drains and exits with
  ``--preemption-code``, as the JAX replica does.

Tolerance: greedy tokens identical.
"""

import json
import os
import socket
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import pytest
import torch
import yaml

from fleetx_tpu.models.gpt.model import GPTForPretraining
from fleetx_tpu.models.gpt.model import config_from_dict as j_config
from fleetx_tpu.observability.schema import \
    validate_fleet_record as j_validate
from fleetx_tpu.resilience import faults as j_faults
from fleetx_tpu.serving.engine import ServingConfig as JServingConfig
from fleetx_tpu.serving.engine import ServingEngine as JServingEngine
from fleetx_tpu_torch.convert import params_from_jax
from fleetx_tpu_torch.core import checkpoint as C
from fleetx_tpu_torch.models.gpt.model import config_from_dict as t_config
from fleetx_tpu_torch.observability.schema import \
    validate_fleet_record as t_validate
from fleetx_tpu_torch.resilience import faults as t_faults
from fleetx_tpu_torch.serving import router as R
from fleetx_tpu_torch.serving.engine import ServingConfig as TServingConfig
from fleetx_tpu_torch.serving.engine import ServingEngine as TServingEngine
from fleetx_tpu_torch.serving.server import ReplicaServer, request

pytestmark = pytest.mark.torch_port


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """This file's tensors are tiny: torch runs them on one intra-op
    thread. The count is restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: ``tests/test_zz_serving.py``'s tiny model and replica geometry
MODEL_DICT = dict(vocab_size=97, hidden_size=64, num_layers=2,
                  num_attention_heads=4, max_position_embeddings=64,
                  hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                  use_flash_attention=False, dtype="float32",
                  param_dtype="float32")
SERVING = dict(max_batch=4, page_size=4, num_pages=33, max_seq_len=32,
               prefill_chunk=8)
EOS = 96
PROMPTS = [[5, 9, 23, 41], [7, 3], [11, 2, 8], [13, 4, 6, 1, 2], [9, 9],
           [21, 17, 3]]
MAX_NEW = 8
#: every subprocess's own deadline (generous: the host is shared)
PROC_TIMEOUT_S = 240


def _loopback_available() -> bool:
    try:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
    except OSError:
        return False
    return True


# ----------------------------------------------------------- the fault plan
FAULT_SPECS = ["slow_decode_ms_at=3:40", "blackhole_after=2",
               "crash_mid_write=3", "blackhole_after=0,crash_mid_write=1",
               "slow_decode_ms_at=0:5,blackhole_after=4,crash_mid_write=2",
               ""]


def _decisions(plan) -> list:
    """The serving triggers over 8 work steps, with one response answered
    after each step."""
    out = []
    for step in range(8):
        out.append((plan.decode_delay_s(step), plan.blackholed(),
                    plan.take_crash_mid_write(), plan.armed))
        plan.note_response()
    return out


@pytest.mark.parametrize("spec", FAULT_SPECS)
def test_serving_triggers_equal_the_jax_plan(spec):
    tp = t_faults.FaultPlan.from_cfg({}, env=spec, rank=0)
    jp = j_faults.FaultPlan.from_cfg({}, env=spec, rank=0)
    for key in ("slow_decode_ms_at", "blackhole_after", "crash_mid_write"):
        assert getattr(tp, key) == getattr(jp, key), key
    assert _decisions(tp) == _decisions(jp)
    # the config block reaches the same knobs (env empty)
    cfg = t_faults._parse_env(spec)
    assert _decisions(t_faults.FaultPlan.from_cfg(cfg, env="")) == \
        _decisions(j_faults.FaultPlan.from_cfg(cfg, env=""))


def test_every_knob_is_ported_and_a_bad_straggler_pair_raises():
    assert t_faults.NOT_PORTED == {}
    with pytest.raises(ValueError, match="work_step, extra_ms"):
        t_faults.FaultPlan(slow_decode_ms_at=[1, 2, 3])
    # only_rank disarms the serving knobs on the other ranks too
    tp = t_faults.FaultPlan.from_cfg({"only_rank": 1, "blackhole_after": 1},
                                     env="", rank=0)
    assert not tp.armed and not tp.blackholed()


# ---------------------------------------------------------------- weights
@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """JAX-initialised weights converted and saved as a port checkpoint,
    the port's config and params, and the JAX engine's greedy tokens for
    ``PROMPTS``."""
    from flax.core import meta

    jcfg = j_config(MODEL_DICT)
    jparams = meta.unbox(GPTForPretraining(jcfg).init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 8), jnp.int32),
        None, deterministic=True)["params"])
    tcfg = t_config(MODEL_DICT)
    tparams = params_from_jax(jax.device_get(jparams), tcfg, "cpu")
    ckpt = str(tmp_path_factory.mktemp("chaos_ckpt"))
    C.save_checkpoint(ckpt, 1, C.flatten(tparams, "params/"),
                      meta={"consumed_samples": 0, "epoch": 0, "seed": 0})
    jeng = JServingEngine(jcfg, jparams, JServingConfig(**SERVING),
                          eos_token_id=EOS)
    reqs = [jeng.submit(p, MAX_NEW, request_id=f"j{i}")
            for i, p in enumerate(PROMPTS)]
    jeng.run_until_drained()
    want = {tuple(p): r.tokens for p, r in zip(PROMPTS, reqs)}
    assert all(want.values())
    return dict(ckpt=ckpt, tcfg=tcfg, tparams=tparams, want=want)


def _port_engine(served) -> TServingEngine:
    return TServingEngine(served["tcfg"], served["tparams"],
                          TServingConfig(**SERVING), eos_token_id=EOS,
                          device="cpu")


# ------------------------------------------------------------- in process
class _Stop:
    def __init__(self):
        self.flag = threading.Event()

    @property
    def triggered(self) -> bool:
        return self.flag.is_set()


def _start_replica(engine, plan):
    """An in-process replica with its loop on a thread: (server, stop,
    loop thread)."""
    server = ReplicaServer(engine, fault_plan=plan)
    server.start()
    stop = _Stop()
    loop = threading.Thread(target=server.run, kwargs=dict(preemption=stop),
                            daemon=True, name="test-replica-loop")
    loop.start()
    return server, stop, loop


def test_router_over_a_blackholed_and_a_slow_replica(served):
    if not _loopback_available():
        pytest.skip("loopback networking unavailable")
    hole, hole_stop, hole_loop = _start_replica(
        _port_engine(served), t_faults.FaultPlan(blackhole_after=1))
    slow, slow_stop, slow_loop = _start_replica(
        _port_engine(served), t_faults.FaultPlan(slow_decode_ms_at=[2, 5]))
    router = R.Router([("127.0.0.1", hole.port), ("127.0.0.1", slow.port)],
                      config=R.RouterConfig(
                          hedge_ms=100.0, verb_timeout_s=1.0,
                          probe_interval_s=0.1, penalty_s=0.2,
                          request_timeout_s=60.0))
    held = None
    try:
        # one direct answer from the replica that then goes silent
        first = request(("127.0.0.1", hole.port),
                        {"id": "h0", "prompt": PROMPTS[0],
                         "max_new_tokens": MAX_NEW}, timeout=60)
        assert first["tokens"] == served["want"][tuple(PROMPTS[0])]
        port = router.start()
        deadline = time.monotonic() + 60
        while router.breaker_states()[f"127.0.0.1:{hole.port}"] != R.OPEN:
            assert time.monotonic() < deadline, router.breaker_states()
            time.sleep(0.05)
        answers = {}

        def ask(i):
            answers[i] = request(("127.0.0.1", port),
                                 {"id": f"r{i}", "prompt": PROMPTS[i],
                                  "max_new_tokens": MAX_NEW}, timeout=120)

        threads = [threading.Thread(target=ask, args=(i,))
                   for i in range(len(PROMPTS))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
        assert not any(t.is_alive() for t in threads)
        for i, p in enumerate(PROMPTS):
            assert answers[i]["tokens"] == served["want"][tuple(p)], i
        counters = router.router_counters()
        assert counters["completed_total"] == len(PROMPTS)
        assert counters["breaker_opens_total"] >= 1
        # a connection the blackholed replica holds open unanswered ...
        held = socket.create_connection(("127.0.0.1", hole.port), timeout=30)
        held.sendall(b'{"verb": "ping"}\n')
        time.sleep(0.2)
    finally:
        router.close()
        for stop in (hole_stop, slow_stop):
            stop.flag.set()
        hole.close()
        slow.close()
    # ... is released by close(): EOF, not a hang until the request timeout
    try:
        assert held.recv(4096) == b""
    finally:
        held.close()
    for loop in (hole_loop, slow_loop):
        loop.join(timeout=60)
        assert not loop.is_alive()


# ----------------------------------------------------------- subprocesses
def _yaml(tmp_path, name: str, served, **extra) -> str:
    cfg = {"Model": MODEL_DICT,
           "Serving": dict(SERVING, ckpt_dir=served["ckpt"],
                           router=dict(penalty_s=0.3, verb_timeout_s=5.0,
                                       request_timeout_s=120.0,
                                       hedge_ms=0.0, probe_interval_s=0.2,
                                       dispatch_deadline_s=180.0)),
           "Generation": {"decode_strategy": "greedy_search",
                          "eos_token_id": EOS, "pad_token_id": 0},
           "Global": {"seed": 7}}
    cfg.update(extra)
    path = tmp_path / name
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _env(tmp_path, faults: str = "") -> dict:
    return dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                FLEETX_FAULTS=faults,
                FLEETX_FLIGHT_DIR=str(tmp_path / "flight"))


def _wait_ready(path, proc, deadline: float) -> dict:
    while True:
        assert proc.poll() is None, f"replica died rc={proc.returncode}"
        assert time.monotonic() < deadline, f"{path} never appeared"
        if os.path.exists(path):
            try:
                with open(path) as f:
                    return json.load(f)
            except ValueError:
                pass  # torn write: retry
        time.sleep(0.1)


@pytest.fixture(scope="module")
def replicas(served, tmp_path_factory):
    """Three ``--device cpu`` replica processes, started together: a
    healthy one, one with ``crash_mid_write=3`` and one whose config sets
    ``Resilience.faults.sigterm_at``; name → (process, port)."""
    if not _loopback_available():
        pytest.skip("loopback networking unavailable")
    tmp = tmp_path_factory.mktemp("chaos_fleet")
    plain = _yaml(tmp, "plain.yaml", served)
    drill = _yaml(tmp, "sigterm.yaml", served,
                  Resilience={"faults": {"sigterm_at": 6}})
    specs = {"healthy": (plain, "", "75"),
             "crashing": (plain, "crash_mid_write=3", "75"),
             "sigterm": (drill, "", "77")}
    procs = {}
    try:
        for name, (cfg, faults, code) in specs.items():
            procs[name] = subprocess.Popen(
                [sys.executable, "-m", "fleetx_tpu_torch.tools.serve", "-c",
                 cfg, "--device", "cpu", "--ready-file",
                 str(tmp / f"{name}.json"), "--preemption-code", code,
                 "--metrics-out", str(tmp / f"{name}_metrics.jsonl")],
                cwd=REPO, env=_env(tmp, faults), stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL)
        deadline = time.monotonic() + PROC_TIMEOUT_S
        ports = {name: _wait_ready(str(tmp / f"{name}.json"), proc,
                                   deadline)["port"]
                 for name, proc in procs.items()}
        yield dict(tmp=tmp, plain=plain,
                   procs={n: (procs[n], ports[n]) for n in procs})
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=60)


def test_cli_router_redispatches_a_torn_response(replicas, served):
    tmp = replicas["tmp"]
    healthy, h_port = replicas["procs"]["healthy"]
    crashing, c_port = replicas["procs"]["crashing"]
    fleet = tmp / "fleet.jsonl"
    # one direct answer from each first (the crash counts it: the third
    # data response it answers is torn)
    for port in (h_port, c_port):
        resp = request(("127.0.0.1", port),
                       {"id": f"warm{port}", "prompt": PROMPTS[0],
                        "max_new_tokens": MAX_NEW}, timeout=PROC_TIMEOUT_S)
        assert resp["tokens"] == served["want"][tuple(PROMPTS[0])]
    router = subprocess.Popen(
        [sys.executable, "-m", "fleetx_tpu_torch.tools.serve", "--router",
         "-c", replicas["plain"], "--port", "0", "--backends",
         f"127.0.0.1:{h_port},127.0.0.1:{c_port}",
         "--fleet-out", str(fleet), "--poll-interval", "0.2"],
        cwd=REPO, env=_env(tmp), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        line = router.stdout.readline()
        assert "listening on" in line, line
        rport = int(line.split(":")[-1].split()[0])
        answers = {}

        def ask(i):
            answers[i] = request(("127.0.0.1", rport),
                                 {"id": f"c{i}", "prompt": PROMPTS[i],
                                  "max_new_tokens": MAX_NEW},
                                 timeout=PROC_TIMEOUT_S)

        threads = [threading.Thread(target=ask, args=(i,))
                   for i in range(len(PROMPTS))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=PROC_TIMEOUT_S)
        assert not any(t.is_alive() for t in threads)
        for i, p in enumerate(PROMPTS):
            assert answers[i].get("tokens") == \
                served["want"][tuple(p)], (i, answers[i])
        assert crashing.wait(timeout=PROC_TIMEOUT_S) == 70
        assert healthy.poll() is None
        stats = request(("127.0.0.1", rport), {"verb": "stats"},
                        timeout=60)
        assert t_validate(stats) == [] and j_validate(stats) == []
        assert stats["completed_total"] == len(PROMPTS)
        assert stats["redispatched_total"] >= 1
        assert stats["penalties_total"] >= 1
        assert stats["breaker_opens_total"] >= 1
        assert stats["breakers"][f"127.0.0.1:{c_port}"] == "open"
        # a re-dispatched request's story through the router's trace verb
        traces = [request(("127.0.0.1", rport),
                          {"verb": "trace", "id": f"c{i}"}, timeout=60)
                  for i in range(len(PROMPTS))]
        torn = [tr for tr in traces if any(
            e["name"] == "transport_retry" for e in tr["events"])]
        assert torn, traces
        names = [e["name"] for e in torn[0]["events"]
                 if e["source"] == "router"]
        assert names[0] == "dispatch" and names[-1] == "completed"
        assert f"127.0.0.1:{h_port}" in torn[0]["sources"]
        deadline = time.monotonic() + 60
        while True:                         # the poll loop's records
            lines = [json.loads(x) for x in fleet.read_text().splitlines()
                     if x.strip()] if fleet.exists() else []
            if lines and lines[-1].get("redispatched_total", 0) >= 1:
                break
            assert time.monotonic() < deadline, lines[-1:]
            time.sleep(0.1)
        for rec in lines:
            assert t_validate(rec) == [] and j_validate(rec) == []
    finally:
        router.terminate()
        try:
            router.wait(timeout=30)
        except subprocess.TimeoutExpired:
            router.kill()
            router.wait(timeout=30)
        router.stdout.close()


def test_cli_replica_drains_on_configured_sigterm_at(replicas, served):
    """``Resilience.faults.sigterm_at: 6`` (the config block, not the env):
    the replica SIGTERMs itself after 6 work steps, mid-stream; every
    admitted request completes token-correct and later arrivals get the
    explicit ``draining`` refusal; it exits with ``--preemption-code``."""
    proc, port = replicas["procs"]["sigterm"]
    results = [None] * 3

    def ask(i):
        try:
            results[i] = request(("127.0.0.1", port),
                                 {"id": f"d{i}", "prompt": PROMPTS[i],
                                  "max_new_tokens": MAX_NEW},
                                 timeout=PROC_TIMEOUT_S)
        except OSError as e:  # the socket closed with the process
            results[i] = {"error": f"transport: {e}"}

    threads = [threading.Thread(target=ask, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=PROC_TIMEOUT_S)
    assert proc.wait(timeout=PROC_TIMEOUT_S) == 77
    completed = 0
    for i, resp in enumerate(results):
        if "tokens" in resp:
            completed += 1
            assert resp["tokens"] == served["want"][tuple(PROMPTS[i])], i
        else:
            assert resp.get("error") == "draining", (i, resp)
    assert completed >= 1, results
    snap = json.loads((replicas["tmp"] / "sigterm_metrics.jsonl")
                      .read_text().splitlines()[-1])
    assert snap["requests_completed"] == completed
