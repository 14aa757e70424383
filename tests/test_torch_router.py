"""The port's request router against the JAX package's, on scripted
transports.

Both ``Router`` classes run the same scenarios with ``_forward`` and
``_ask`` monkeypatched on the class (no network): the breaker walk
(open → half-open → closed, and a failed trial back to open), the
half-open trial race, a hedged dispatch that cancels its loser, the retry
budget's classified refusal, a drain refusal and a transport failure each
re-dispatched, the fleet poll that merges what reports, and ``trace``.
Each scenario must give the same responses, the same
``router_counters()`` and ``breaker_states()`` after every step, and the
same journal event names and backends. ``merge_fleet_snapshots`` must
equal JAX's on the same snapshots, and the port's records must pass JAX's
``validate_fleet_record``. A fresh interpreter that imports the router
loads neither torch nor JAX. Tolerance: exact (no arithmetic beyond the
fleet merge's float means, which run the same expressions in the same
order).
"""

import json
import os
import queue
import subprocess
import sys
import threading

import pytest

from fleetx_tpu.observability import tsan as j_tsan
from fleetx_tpu.observability.schema import \
    validate_fleet_record as j_validate
from fleetx_tpu.serving import router as j_router
from fleetx_tpu_torch.observability import tsan as t_tsan
from fleetx_tpu_torch.observability.schema import \
    validate_fleet_record as t_validate
from fleetx_tpu_torch.serving import router as t_router

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = {"torch": t_router, "jax": j_router}


@pytest.fixture()
def tsan_on(monkeypatch):
    """Both packages' lock sanitizers on around the test body."""
    monkeypatch.setenv("FLEETX_TSAN", "1")
    j_tsan.reset()
    t_tsan.reset()
    yield
    assert t_tsan.violations() == [] and j_tsan.violations() == []
    j_tsan.reset()
    t_tsan.reset()


def _router(mod, n_backends=2, **cfg_kw):
    """``test_zz_chaos_serving.py``'s scripted router on module ``mod``."""
    kw = dict(hedge_ms=0.0, penalty_s=0.05, probe_interval_s=0.05,
              breaker_threshold=1, request_timeout_s=5.0)
    kw.update(cfg_kw)
    backends = [("127.0.0.1", 10000 + i) for i in range(n_backends)]
    return mod.Router(backends, config=mod.RouterConfig(**kw))


def _journal(router, rid) -> list:
    """The journal without its timestamps: (name, backend, attempt)."""
    return [(e["name"], e.get("backend"), e.get("attempt"), e["source"])
            for e in router.journal.events(rid)]


def _state(router) -> tuple:
    return (router.router_counters(), router.breaker_states(),
            [(b.state, b.trial_in_flight, b.outstanding)
             for b in router.backends])


def _both(scenario, monkeypatch) -> dict:
    """``scenario(mod, monkeypatch)`` on each package; name → record."""
    return {name: scenario(mod, monkeypatch) for name, mod in MODULES.items()}


# ---------------------------------------------------------------- scenarios
def _breaker_walk(mod, monkeypatch) -> list:
    r = _router(mod, 2)
    b = r.backends[0]
    steps = [("start", _state(r))]
    r._breaker_failure(b)                 # threshold 1: opens
    steps.append(("failure", _state(r)))
    r._note_probe_success(b)              # observed recovery: half-open
    steps.append(("probe", _state(r)))
    picked = r.pick()                     # the trial slot, atomically
    steps.append(("pick", picked is b, _state(r)))
    r._note_success(b)                    # the trial succeeds: closed
    steps.append(("success", _state(r)))
    r._note_probe_success(b)              # a closed backend stays closed
    b.state = mod.HALF_OPEN
    r._breaker_failure(b)                 # a failed trial: open again
    steps.append(("trial_failed", _state(r)))
    r._note_failure(r.backends[1])        # a dispatch-path failure
    steps.append(("dispatch_failure", _state(r), r.retries))
    return steps


def test_breaker_walk_equals_the_jax_router(tsan_on, monkeypatch):
    got = _both(_breaker_walk, monkeypatch)
    assert got["torch"] == got["jax"]
    states = {step[0]: step[-1] if step[0] != "dispatch_failure"
              else step[1] for step in got["torch"]}
    walk = [states[k][1]["127.0.0.1:10000"]
            for k in ("start", "failure", "probe", "pick", "success",
                      "trial_failed")]
    assert walk == ["closed", "open", "half_open", "half_open", "closed",
                    "open"]
    assert got["torch"][3][1] is True and states["pick"][2][0][1]
    last = states["dispatch_failure"][0]
    assert last["breaker_opens_total"] == 3
    assert last["breaker_closes_total"] == 1
    assert got["torch"][-1][2] == 1                 # the retry count


def _trial_race(mod, monkeypatch) -> tuple:
    r = _router(mod, 2)
    r.backends[1].state = mod.OPEN
    r.backends[0].state = mod.HALF_OPEN
    n = 8
    barrier = threading.Barrier(n)
    got: "queue.Queue" = queue.Queue()

    def racer():
        barrier.wait()
        got.put(r.pick())

    threads = [threading.Thread(target=racer) for _ in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    winners = [b for b in (got.get_nowait() for _ in range(n))
               if b is not None]
    return ([w.addr for w in winners], _state(r))


def test_half_open_trial_race_has_one_winner_in_both(tsan_on, monkeypatch):
    got = _both(_trial_race, monkeypatch)
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == [("127.0.0.1", 10000)]
    assert all(v == 0 for v in got["torch"][1][0].values())


def _hedge(mod, monkeypatch) -> dict:
    """A silent primary: the hedge fires, the second backend answers, the
    loser gets ``cancel``. The primary is released only by that cancel,
    so the race's order does not depend on the host's speed."""
    r = _router(mod, 2, hedge_ms=40.0, request_timeout_s=30.0)
    slow = r.backends[0].addr              # first pick: round-robin tie
    release = threading.Event()
    cancels: "queue.Queue" = queue.Queue()

    def forward(backend, payload):
        if backend.addr == slow:
            release.wait(20)
        return {"id": payload["id"], "tokens": [1, 2, 3]}

    def ask(addr, payload, timeout=10.0):
        cancels.put((addr, payload))
        release.set()
        return {"ok": True}

    monkeypatch.setattr(mod.Router, "_forward", staticmethod(forward))
    monkeypatch.setattr(mod.Router, "_ask", staticmethod(ask))
    resp = r.dispatch({"id": "h1", "prompt": [5, 9], "max_new_tokens": 3})
    addr, payload = cancels.get(timeout=20)
    for _ in range(2000):                  # the loser's bookkeeping lands
        if r.backends[0].outstanding == 0:
            break
        threading.Event().wait(0.01)
    return dict(resp=resp, cancel=(addr, payload), state=_state(r),
                journal=_journal(r, "h1"))


def test_hedged_dispatch_equals_the_jax_router(monkeypatch):
    got = _both(_hedge, monkeypatch)
    assert got["torch"] == got["jax"]
    t = got["torch"]
    assert t["resp"] == {"id": "h1", "tokens": [1, 2, 3]}
    counters = t["state"][0]
    assert counters["hedges_total"] == 1
    assert counters["hedge_cancels_total"] == 1
    assert counters["completed_total"] == 1
    assert counters["dispatched_total"] == 1
    assert t["cancel"] == (("127.0.0.1", 10000),
                           {"verb": "cancel", "id": "h1"})
    assert [e[0] for e in t["journal"]] == ["dispatch", "hedge",
                                            "hedge_cancel", "completed"]
    assert t["journal"][1][1] == "127.0.0.1:10001"
    assert t["state"][1] == {"127.0.0.1:10000": "closed",
                             "127.0.0.1:10001": "closed"}


def _budget(mod, monkeypatch) -> dict:
    r = _router(mod, 2, retry_budget=3, breaker_threshold=100,
                dispatch_deadline_s=30.0)

    def forward(backend, payload):
        raise OSError("down")

    monkeypatch.setattr(mod.Router, "_forward", staticmethod(forward))
    resp = r.dispatch({"id": "b1", "prompt": [5], "max_new_tokens": 2})
    return dict(resp=resp, state=_state(r), journal=_journal(r, "b1"))


def test_retry_budget_exhaustion_is_classified_as_in_jax(monkeypatch):
    got = _both(_budget, monkeypatch)
    assert got["torch"] == got["jax"]
    t = got["torch"]
    assert t["resp"] == {"id": "b1",
                         "error": "retry budget exhausted (3 attempts)"}
    c = t["state"][0]
    assert c["dispatched_total"] == 3 and c["penalties_total"] == 3
    assert c["no_backend_total"] == 1 and c["completed_total"] == 0
    names = [e[0] for e in t["journal"]]
    assert names.count("transport_retry") == 3
    assert names[-1] == "budget_exhausted"


def _redispatch(mod, monkeypatch) -> dict:
    """Backend 1 refuses ``draining``, then backend 1 of a second router
    drops the connection: each request moves on and completes."""
    out = {}
    for kind in ("drain", "transport"):
        r = mod.Router([("127.0.0.1", 1), ("127.0.0.1", 2)])
        calls = []

        def forward(backend, payload, kind=kind, calls=calls):
            calls.append(backend.addr[1])
            if backend.addr[1] == 1:
                if kind == "drain":
                    return {"id": payload.get("id"), "error": "draining"}
                raise ConnectionError("replica died")
            return {"id": payload.get("id"), "tokens": [1, 2]}

        def ask(addr, payload, timeout=10.0):
            raise ConnectionError("no live replica")

        monkeypatch.setattr(mod.Router, "_forward", staticmethod(forward))
        monkeypatch.setattr(mod.Router, "_ask", staticmethod(ask))
        resp = r.dispatch({"id": "r1", "prompt": [1], "max_new_tokens": 2})
        tr = r.trace("r1")
        out[kind] = dict(resp=resp, calls=calls, state=_state(r),
                         journal=_journal(r, "r1"),
                         trace=(tr["sources"], [e["name"]
                                                for e in tr["events"]]),
                         ghost=r.trace("ghost"))
    return out


def test_drain_and_transport_redispatch_equal_the_jax_router(monkeypatch):
    got = _both(_redispatch, monkeypatch)
    assert got["torch"] == got["jax"]
    drain, transport = got["torch"]["drain"], got["torch"]["transport"]
    for run, refusal in ((drain, "drain_refusal"),
                         (transport, "transport_retry")):
        assert run["resp"]["tokens"] == [1, 2] and run["calls"] == [1, 2]
        assert [e[0] for e in run["journal"]] == [
            "dispatch", refusal, "dispatch", "completed"]
        assert run["trace"] == (["router"], [e[0] for e in run["journal"]])
        assert run["ghost"] == {"id": "ghost", "error": "unknown request id"}
    c = drain["state"][0]
    assert c["dispatched_total"] == 2 and c["redispatched_total"] == 1
    assert c["penalties_total"] == 1 and c["drain_refusals_total"] == 1
    assert transport["state"][0]["drain_refusals_total"] == 0


def _snap(ts, admitted, completed, refused, tokens, tps, occ, ttft, itl,
          chips=1, att=None, qd=0):
    """``test_zz_fleet.py``'s replica snapshot."""
    return {"ts": ts, "scope": "serving", "requests_admitted": admitted,
            "requests_completed": completed, "requests_refused": refused,
            "tokens_total": tokens, "tokens_per_sec": tps,
            "queue_depth": qd, "active_requests": 0,
            "page_occupancy": occ, "chips": chips, "ttft": ttft,
            "itl": itl, "slo_attainment": att}


GOOD = _snap(9.0, 2, 2, 0, 20, 10.0, 0.25,
             {"count": 2, "mean": 0.1, "p99": 0.2},
             {"count": 10, "mean": 0.01, "p99": 0.02})


def _poll(mod, monkeypatch) -> dict:
    """One backend reports, the other is gone; the open one that answers
    ``stats`` is half-opened (a stats answer is as good as a ping); then
    a probe sweep with the reporting one now silent."""
    r = mod.Router([("127.0.0.1", 1), ("127.0.0.1", 2)])
    r.backends[0].state = mod.OPEN
    silent = set()

    def ask(addr, payload, timeout=10.0):
        if addr[1] == 1 and addr not in silent:
            return dict(GOOD) if payload.get("verb") == "stats" else \
                {"ok": True, "draining": False}
        raise ConnectionError("draining replica does not report")

    monkeypatch.setattr(mod.Router, "_ask", staticmethod(ask))
    rec = r.poll_fleet()
    first = _state(r)
    r.cfg = mod.RouterConfig(penalty_s=1e-3)
    silent.add(("127.0.0.1", 1))
    r.probe_once()
    return dict(rec=rec, last_is_rec=r.last_fleet is rec, first=first,
                after_probe=_state(r))


def test_poll_fleet_and_probes_equal_the_jax_router(monkeypatch):
    got = _both(_poll, monkeypatch)
    assert got["torch"] == got["jax"]
    t = got["torch"]
    assert t_validate(t["rec"]) == [] and j_validate(t["rec"]) == []
    assert t["rec"]["replicas_total"] == 2
    assert t["rec"]["replicas_reported"] == 1
    assert t["rec"]["requests_completed"] == 2 and t["last_is_rec"]
    assert t["rec"]["breakers"] == {"127.0.0.1:1": "half_open",
                                    "127.0.0.1:2": "closed"}
    assert all(t["rec"][name] == 0 for name in t_router.ROUTER_COUNTERS)
    # both silent now: each probe failure opens (the half-open one again)
    assert t["after_probe"][1] == {"127.0.0.1:1": "open",
                                   "127.0.0.1:2": "open"}
    assert t["after_probe"][0]["breaker_opens_total"] == 2


MERGE_CASES = {
    "two_replicas": (dict(
        a=_snap(10.0, 6, 5, 1, 50, 25.0, 0.4,
                {"count": 4, "mean": 0.10, "p99": 0.20},
                {"count": 40, "mean": 0.010, "p99": 0.015}, att=1.0),
        b=_snap(11.0, 4, 3, 0, 30, 15.0, 0.7,
                {"count": 2, "mean": 0.40, "p99": 0.90},
                {"count": 20, "mean": 0.040, "p99": 0.060}, att=0.9,
                chips=4)), 2),
    "partial_null_gauges": (dict(
        a=dict(_snap(5.0, 0, 0, 0, 0, 0.0, None, {"count": 0},
                     {"count": 0}), queue_depth=None,
               active_requests=None)), 3),
    "one_reporting": ({"127.0.0.1:1": dict(GOOD)}, 2),
    "nobody": ({}, 2),
}


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_merge_fleet_snapshots_equals_the_jax_merge(case):
    snaps, total = MERGE_CASES[case]
    counters = {n: i for i, n in enumerate(t_router.ROUTER_COUNTERS)}
    breakers = {"127.0.0.1:1": "open", "127.0.0.1:2": "closed"}
    got = t_router.merge_fleet_snapshots(snaps, total, counters, breakers)
    want = j_router.merge_fleet_snapshots(snaps, total, counters, breakers)
    assert t_validate(got) == [] and j_validate(got) == []
    if not snaps:                     # no replica: the merge's own clock
        assert abs(got.pop("ts") - want.pop("ts")) < 60
    assert got == want
    bare = t_router.merge_fleet_snapshots(snaps, total)
    assert "breakers" not in bare and "dispatched_total" not in bare


def test_request_journal_bounds_equal_the_jax_journal():
    got = {}
    for name, mod in MODULES.items():
        j = mod.RequestJournal(max_requests=2, events_per_request=8)
        for i in range(12):
            j.note("r1", "dispatch", attempt=i)
        first = [e["attempt"] for e in j.events("r1")]
        j.note("r2", "dispatch")
        j.note("r3", "dispatch")
        j.note(None, "dispatch")
        got[name] = (first, j.events("r1"), [e["name"]
                                            for e in j.events("r3")])
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == list(range(4, 12))


def test_router_constants_equal_the_jax_router():
    for key in ("ROUTER_COUNTERS", "FLEET_SCHEMA_VERSION", "CLOSED", "OPEN",
                "HALF_OPEN", "DEFAULT_POLL_INTERVAL_S"):
        assert getattr(t_router, key) == getattr(j_router, key), key
    assert t_router.RouterConfig() == t_router.RouterConfig(
        **{f: getattr(j_router.RouterConfig(), f)
           for f in j_router.RouterConfig.__dataclass_fields__})


def test_router_import_path_loads_no_torch_and_no_jax():
    """The counterpart of ``test_zz_fleet.py``'s jax-free router import:
    the router and every module it reuses at run time come up without
    torch, so the fleet front starts before its replicas."""
    code = ("import sys, json\n"
            "import fleetx_tpu_torch.serving.router\n"
            "import fleetx_tpu_torch.tools.serve\n"
            "from fleetx_tpu_torch.observability.sinks import JsonlSink\n"
            "from fleetx_tpu_torch.observability.schema import "
            "validate_fleet_record\n"
            "from fleetx_tpu_torch.utils import config\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "torch" not in loaded and "jax" not in loaded
    assert not [m for m in loaded if m.split(".")[0] == "fleetx_tpu"]
    assert "fleetx_tpu_torch.serving.engine" not in loaded
