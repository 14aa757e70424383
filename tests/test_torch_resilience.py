"""Port parity: the resilience runtime (``fleetx_tpu_torch/resilience/``:
``policy``, ``faults``, ``guard``, ``watchdog``, ``coordination``, the
``Resilience`` facade; the engine's guard skip, rollback, abort,
preemption exit and auto-resume; the checkpoint layer's retries and
corruption points; ``tools/train.py``'s preemption exit code).

Both engines train the tiny GPT of ``tests/test_engine.py`` (hidden 64, 2
layers, 4 heads, seq 32, vocab 128, batch 8, f32, dropout 0, the kernels'
gates closed at this width on both sides) from the same initial weights
(the JAX engine's, converted) on the same numpy batches, driven by the
same ``Resilience`` blocks the JAX drills in ``tests/test_resilience.py``
use.

Tolerances: decisions, steps, counters and checkpoint steps are equal.
The port's own runs are compared bit for bit (a resumed run against the
uninterrupted one; the params around a skipped batch). Losses against
the JAX engine agree within 1e-5 (f32: the same ops summed in another
order by another library).
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax
from flax.core import meta

from fleetx_tpu.observability.metrics import get_registry as j_registry
from fleetx_tpu.parallel.mesh import build_mesh
from fleetx_tpu.resilience import TrainingAborted as JAborted
from fleetx_tpu.resilience import faults as j_faults
from fleetx_tpu.resilience import guard as j_guard
from fleetx_tpu.resilience import policy as j_policy
from fleetx_tpu.resilience.policy import set_default_policy as j_set_policy
from fleetx_tpu_torch.convert import params_from_jax
from fleetx_tpu_torch.core import checkpoint as C
from fleetx_tpu_torch.core.engine import EagerEngine
from fleetx_tpu_torch.core.module import GPTModule
from fleetx_tpu_torch.observability.metrics import MetricsRegistry
from fleetx_tpu_torch.observability.metrics import get_registry
from fleetx_tpu_torch.optims import lr_scheduler as TLR
from fleetx_tpu_torch.optims import optimizer as TOPT
from fleetx_tpu_torch.optims.optimizer import tree_leaves_with_path
from fleetx_tpu_torch.resilience import (Resilience, TrainingAborted,
                                         coordination)
from fleetx_tpu_torch.resilience import faults as faults_mod
from fleetx_tpu_torch.resilience import guard as G
from fleetx_tpu_torch.resilience import policy as P
from fleetx_tpu_torch.resilience.integrity import WriteVerifyError
from fleetx_tpu_torch.resilience.watchdog import StepWatchdog

from test_engine import build_engine, make_batches, tiny_cfg

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
SYNTH_YAML = os.path.join(REPO, "fleetx_tpu", "configs", "nlp", "gpt",
                          "pretrain_gpt_345M_synthetic.yaml")
#: ``tests/test_engine.py``'s optimizer and schedule
LR = {"name": "cosine", "max_lr": 1e-3, "min_lr": 1e-4, "warmup_steps": 2,
      "decay_steps": 100}
OPT = {"name": "AdamW", "weight_decay": 0.01,
       "grad_clip": {"clip_norm": 1.0}}
#: the synthetic recipe shrunk for the CLI drill
TINY = ["Engine.logging_freq=1", "Model.num_layers=2",
        "Model.hidden_size=128", "Model.num_attention_heads=2",
        "Model.vocab_size=256", "Model.max_position_embeddings=128",
        "Global.max_seq_len=128", "Model.dtype=float32",
        "Global.global_batch_size=2", "Global.local_batch_size=2",
        "Global.micro_batch_size=2", "Data.Train.dataset.num_samples=32",
        "Data.Train.loader.prefetch=0"]


@pytest.fixture(autouse=True)
def _isolate_process_state():
    """Clear both packages' process-wide fault plans and retry policies
    after each test, so no armed plan leaks into another test's saves."""
    yield
    faults_mod.install_plan(None)
    P.set_default_policy(None)
    j_faults.install_plan(None)
    j_set_policy(None)


def _jax_engine(cfg, devices8, batch):
    """``(JAX engine, its initial params as host numpy)``: every
    ``tiny_cfg()`` engine starts from the same seeded params."""
    eng = build_engine(cfg, build_mesh({}, devices=devices8[:1]))
    eng.prepare(batch)
    return eng, jax.device_get(meta.unbox(eng.state.params))


def _port_engine(cfg, params=None):
    """A CPU port engine with ``tests/test_engine.py``'s optimizer and LR;
    ``params`` (JAX numpy params) converted when given."""
    lr = TLR.build_lr_scheduler(LR)
    eng = EagerEngine(cfg, GPTModule(cfg),
                      optimizer=TOPT.build_optimizer(OPT, lr),
                      lr_schedule=lr, device="cpu")
    if params is not None:
        eng.params = params_from_jax(params, eng.module.model_cfg)
    return eng


def _cfg(max_steps, **sections):
    cfg = tiny_cfg()
    cfg["Engine"]["max_steps"] = max_steps
    cfg.update(sections)
    return cfg


def _count(name):
    return get_registry().counter(name).value


def _j_count(name):
    return j_registry().counter(name).value


def _state(eng) -> list:
    """Copies of the params and AdamW moments, and the counters."""
    out = [p.detach().clone() for _, p in tree_leaves_with_path(eng.params)]
    out += [t.clone() for key in ("mu", "nu") for t in eng.opt_state[key]]
    return out + [eng.opt_state["count"], eng.step]


def _bitwise(a: list, b: list) -> bool:
    return all(torch.equal(x, y) if torch.is_tensor(x) else x == y
               for x, y in zip(a, b)) and len(a) == len(b)


# ------------------------------------------------------------- host units
GUARD_CASES = {
    "rollback_then_abort": (
        dict(nonfinite_action="rollback", nonfinite_streak=2,
             max_rollbacks=1),
        [float("nan"), float("nan"), "note_rollback", 1.0, float("nan"),
         float("nan")]),
    "skip_counts_only": (
        dict(nonfinite_action="skip", nonfinite_streak=2),
        [float("nan")] * 5),
    "spike_abort": (
        dict(spike_action="abort", spike_factor=2.0, spike_min_steps=2,
             spike_ewma_alpha=0.5), [1.0, 1.0, 1.0, 10.0]),
    "spike_rollback_budget": (
        dict(spike_action="rollback", spike_factor=1.5, spike_min_steps=1,
             max_rollbacks=0), [2.0, 2.1, 1.9, 5.0, 2.0]),
    "streak_reset_by_finite": (
        dict(nonfinite_action="abort", nonfinite_streak=3),
        [float("nan"), float("nan"), 3.0, float("nan"), float("inf"),
         float("nan")]),
    "skip_inactive_counts_windows": (
        dict(nonfinite_action="skip", skip_active=False),
        [float("nan"), 2.0, float("inf")]),
}


@pytest.mark.parametrize("case", sorted(GUARD_CASES))
def test_guard_decisions_equal_the_jax_guards(case):
    """The same loss sequence through the port's and the JAX
    ``TrainingGuard``: the same decision at every window and the same
    counters."""
    kwargs, seq = GUARD_CASES[case]
    from fleetx_tpu.observability.metrics import MetricsRegistry as JReg

    t_reg, j_reg = MetricsRegistry(), JReg()
    tg = G.TrainingGuard(registry=t_reg, **kwargs)
    jg = j_guard.TrainingGuard(registry=j_reg, **kwargs)
    got, want = [], []
    for step, loss in enumerate(seq):
        if loss == "note_rollback":
            tg.note_rollback()
            jg.note_rollback()
            continue
        got.append(tg.observe(step, loss))
        want.append(jg.observe(step, loss))
    assert got == want
    for name in ("nonfinite_skips", "nonfinite_windows",
                 "loss_spikes_total"):
        assert t_reg.counter(name).value == j_reg.counter(name).value, name
    assert tg.rollbacks == jg.rollbacks


def test_guard_from_cfg_equals_the_jax_defaults():
    cfg = {"nonfinite_action": "rollback", "max_rollbacks": 0}
    tg = G.TrainingGuard.from_cfg(cfg, registry=MetricsRegistry())
    jg = j_guard.TrainingGuard.from_cfg(cfg)
    for key in ("nonfinite_action", "nonfinite_streak", "spike_action",
                "spike_factor", "spike_ewma_alpha", "spike_min_steps",
                "max_rollbacks", "skip_active"):
        assert getattr(tg, key) == getattr(jg, key), key


def test_retry_and_backoff_bounds_equal_the_jax_policy():
    cfg = {"max_attempts": 4, "backoff_s": 0.5, "max_backoff_s": 1.5,
           "jitter": 0.25}
    tp, jp = P.RetryPolicy.from_cfg(cfg), j_policy.RetryPolicy.from_cfg(cfg)
    assert (tp.max_attempts, tp.backoff_s, tp.max_backoff_s, tp.jitter) == \
        (jp.max_attempts, jp.backoff_s, jp.max_backoff_s, jp.jitter)
    import random

    for attempt in range(1, 7):
        base = min(0.5 * 2.0 ** (attempt - 1), 1.5)
        got = tp.sleep_for(attempt, random.Random(attempt))
        assert got == jp.sleep_for(attempt, random.Random(attempt))
        assert 0.75 * base <= got <= 1.25 * base
    no_jitter = P.RetryPolicy(backoff_s=0.1, jitter=0.0)
    assert [no_jitter.sleep_for(a) for a in (1, 2, 3)] == [0.1, 0.2, 0.4]
    # transient errors are retried and counted, up to max_attempts
    calls, slept = [], []
    counter = MetricsRegistry().counter("retries")

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("blip")
        return "ok"

    assert P.call_with_retry(flaky, policy=tp, counter=counter,
                             sleep=slept.append) == "ok"
    assert len(calls) == 3 and counter.value == 2 and len(slept) == 2
    calls.clear()
    with pytest.raises(OSError):
        P.call_with_retry(lambda: calls.append(1) or (_ for _ in ()).throw(
            OSError("down")), policy=tp, sleep=lambda s: None)
    assert len(calls) == 4
    # fatal errors and an expired agreement are never retried
    calls.clear()
    with pytest.raises(ValueError):
        P.call_with_retry(lambda: calls.append(1) or (_ for _ in ()).throw(
            ValueError("bug")), policy=tp, sleep=lambda s: None)
    assert len(calls) == 1
    timeout = coordination.CoordinationTimeout("x", [0], [1], 1.0)
    assert not P.is_transient(timeout) and P.is_transient(OSError())


@pytest.mark.parametrize("env", [
    "ckpt_write_fail_times=2,nan_loss_at=1:2,sigterm_at=5",
    "corrupt_ckpt_at=4,corrupt_restore_at=2,data_raise_at=3",
    "only_rank=1,sigterm_at=2", ""])
def test_fault_plan_and_env_override_equal_the_jax_plans(env, monkeypatch):
    """Config merged with ``FLEETX_FAULTS`` (env wins per key), the
    ``only_rank`` disarm, and the knobs the port does not cover."""
    cfg = {"sigterm_at": 9, "data_raise_at": 1}
    monkeypatch.setenv("FLEETX_FAULTS", env)
    tp = faults_mod.FaultPlan.from_cfg(cfg, rank=0)
    jp = j_faults.FaultPlan.from_cfg(cfg, rank=0)
    for key in ("data_raise_at", "nan_loss_at", "sigterm_at",
                "ckpt_write_fail_times", "corrupt_ckpt_at",
                "corrupt_restore_at", "armed"):
        assert getattr(tp, key) == getattr(jp, key), key
    if env.startswith("ckpt"):
        assert tp.sigterm_at == 5 and tp.nan_loss_at == {1, 2}
    for knob, item in faults_mod.NOT_PORTED.items():
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            faults_mod.FaultPlan.from_cfg({knob: 3}, env="")


def test_nan_batch_poisoning_and_data_raise_equal_the_jax_plan():
    batch = make_batches(1)[0]
    tp = faults_mod.FaultPlan(nan_loss_at=[2], data_raise_at=3)
    jp = j_faults.FaultPlan(nan_loss_at=[2], data_raise_at=3)
    assert tp.on_batch(1, batch) is batch
    got, want = tp.on_batch(2, batch), jp.on_batch(2, batch)
    assert np.isnan(got["loss_mask"]).all() and got["loss_mask"].dtype == \
        want["loss_mask"].dtype
    assert np.array_equal(batch["loss_mask"], np.ones_like(
        batch["loss_mask"]))  # the source batch is not touched
    with pytest.raises(faults_mod.InjectedFault):
        tp.on_batch(3, batch)
    assert tp.on_batch(3, batch) is batch  # once
    late = faults_mod.FaultPlan(sigterm_at=2)
    late.maybe_sigterm(5, start_step=3)  # a resumed run sails past
    assert late.sigterm_at == 2


def test_disabled_facade_clears_leaked_globals():
    """A disabled facade resets the fault plan, retry policy and
    agreement deadlines an enabled one left behind."""
    res = Resilience({"enable": True,
                      "faults": {"ckpt_write_fail_times": 5},
                      "retry": {"max_attempts": 7},
                      "coordination": {"timeout_s": 3.0, "poll_s": 0.5}})
    assert res.guard is not None and res.guard_skip and res.auto_resume
    assert faults_mod.active_plan() is not None
    assert P.get_default_policy().max_attempts == 7
    assert coordination._timeout_s == 3.0
    off = Resilience({"enable": False, "watchdog": {"enable": True}})
    assert faults_mod.active_plan() is None
    faults_mod.fire("ckpt_write")  # a no-op now: must not raise
    assert P.get_default_policy() is P.DEFAULT_POLICY
    assert (coordination._timeout_s, coordination._poll_s) == \
        (coordination.DEFAULT_TIMEOUT_S, 0.05)
    assert not off.enabled and not off.auto_resume and off.guard is None
    assert off.preemption is None and not off.preempted
    assert off.make_watchdog() is None and not off.faults.armed


# ------------------------------------------------------------ the engine
def test_guard_skip_keeps_the_state_bitwise_and_counts_like_jax(
        devices8, tmp_path):
    """``nan_loss_at: [1]`` with the guard's skip: the poisoned batch
    changes no param, moment or counter; training sails past it to
    ``max_steps`` optimizer steps; ``nonfinite_skips`` and the losses
    equal the JAX engine's."""
    res = {"enable": True, "guard": {"nonfinite_action": "skip",
                                     "nonfinite_streak": 100},
           "faults": {"nan_loss_at": [1]}}
    batches = make_batches(5, seed=6)
    j_cfg = _cfg(4, Resilience=res)
    j_cfg["Engine"]["save_load"] = {"output_dir": str(tmp_path / "j")}
    j_eng, init_params = _jax_engine(j_cfg, devices8, batches[0])
    j_before = _j_count("nonfinite_skips")
    j_losses = j_eng.fit(list(batches))
    j_skips = _j_count("nonfinite_skips") - j_before

    t_cfg = _cfg(4, Resilience=res)
    t_cfg["Engine"]["save_load"] = {"output_dir": str(tmp_path / "t")}
    eng = _port_engine(t_cfg, init_params)
    assert eng.check_finite and eng.scaler is None
    around = []
    train_step = eng.train_step

    def spy(batch):
        poisoned = bool(torch.isnan(batch["loss_mask"]).any())
        before = _state(eng) if poisoned else None
        metrics = train_step(batch)
        if poisoned:
            around.append((before, _state(eng), metrics["finite"]))
        return metrics

    eng.train_step = spy
    before = _count("nonfinite_skips")
    losses = eng.fit(list(batches))
    assert len(around) == 1
    pre, post, finite = around[0]
    assert finite is False and _bitwise(pre, post)
    assert eng.step == int(jax.device_get(j_eng.state.step)) == 4
    assert _count("nonfinite_skips") - before == j_skips == 1
    assert len(losses) == len(j_losses) == 5
    assert np.isnan(losses[1]) and np.isnan(j_losses[1])
    finite_t = [l for l in losses if np.isfinite(l)]
    finite_j = [l for l in j_losses if np.isfinite(l)]
    np.testing.assert_allclose(finite_t, finite_j, rtol=0, atol=1e-5)
    assert [h["global_step"] for h in eng.history] == [1, 1, 2, 3, 4]


def _record_decisions(guard, log: list) -> None:
    observe = guard.observe

    def recording(step, loss, finite=None):
        decision = observe(step, loss, finite=finite)
        log.append((int(step), decision))
        return decision

    guard.observe = recording


def test_rollback_then_abort_takes_the_jax_decisions(devices8, tmp_path):
    """NaN-poisoned batches 2 and 3 trip a streak of 2: both engines roll
    back to step 2 and rewind the data, meet the same poison, and abort
    with the rollback budget spent, at the same steps."""
    res = {"enable": True,
           "guard": {"nonfinite_action": "rollback", "nonfinite_streak": 2,
                     "max_rollbacks": 1},
           "faults": {"nan_loss_at": [2, 3]}}
    from fleetx_tpu.core.checkpoint import latest_step as j_latest_step

    batches = make_batches(8, seed=4)
    logs = {}
    for side in ("jax", "port"):
        out = str(tmp_path / side)
        cfg = _cfg(8, Resilience=res)
        cfg["Engine"]["save_load"] = {"output_dir": out, "save_steps": 2}
        if side == "jax":
            eng, init_params = _jax_engine(cfg, devices8, batches[0])
            aborted, rollbacks, latest_step = JAborted, _j_count, \
                j_latest_step
        else:
            eng = _port_engine(cfg, init_params)
            aborted, rollbacks, latest_step = TrainingAborted, _count, \
                C.latest_step
        logs[side] = []
        _record_decisions(eng.resilience.guard, logs[side])
        before = rollbacks("rollbacks_total")
        with pytest.raises(aborted, match="guard abort"):
            eng.fit(batches)
        assert rollbacks("rollbacks_total") - before == 1
        assert latest_step(out) == 2
        step = eng.step if side == "port" else int(
            jax.device_get(eng.state.step))
        assert step == 2  # parked at the last good checkpoint
    assert logs["port"] == logs["jax"]
    assert [d for _, d in logs["port"]] == \
        [None, None, None, "rollback", None, "abort"]


def test_sigterm_exit_then_auto_resume_is_bitwise_the_uninterrupted_run(
        devices8, tmp_path):
    """SIGTERM before step 3: the step is saved, ``preemption_exits``
    counts it and ``SystemExit`` carries the configured code; the
    auto-resumed run's losses and final state equal the uninterrupted
    run's bit for bit, and that run's curve the JAX engine's within
    1e-5."""
    batches = make_batches(6, seed=21)
    j_eng, init_params = _jax_engine(_cfg(6), devices8, batches[0])
    j_losses = j_eng.fit(list(batches))
    ref = _port_engine(_cfg(6), init_params)
    ref_losses = ref.fit(list(batches))
    np.testing.assert_allclose(ref_losses, j_losses, rtol=0, atol=1e-5)

    out = str(tmp_path / "ckpt")
    cfg_a = _cfg(6, Resilience={"enable": True,
                                "faults": {"sigterm_at": 3},
                                "preemption": {"exit_code": 75}})
    cfg_a["Engine"]["save_load"] = {"output_dir": out}
    eng_a = _port_engine(cfg_a, init_params)
    exits = _count("preemption_exits")
    with pytest.raises(SystemExit) as excinfo:
        eng_a.fit(list(batches))
    assert excinfo.value.code == 75
    assert _count("preemption_exits") - exits == 1
    assert C.latest_step(out) == 3
    assert C.peek_meta(out)["consumed_samples"] == 3 * 8

    cfg_b = _cfg(6, Resilience={"enable": True})
    cfg_b["Engine"]["save_load"] = {"output_dir": out}
    eng_b = _port_engine(cfg_b)
    part2 = eng_b.fit(list(batches[3:]))
    assert eng_b.ckpt_dir == out  # auto-resume picked the checkpoint up
    assert part2 == ref_losses[3:]
    assert _bitwise(_state(eng_b), _state(ref))


def test_injected_ckpt_write_failure_is_retried(tmp_path):
    out = str(tmp_path / "ckpt")
    cfg = _cfg(4, Resilience={"enable": True,
                              "retry": {"max_attempts": 3, "backoff_s": 0.0,
                                        "jitter": 0.0},
                              "faults": {"ckpt_write_fail_times": 1}})
    cfg["Engine"]["save_load"] = {"output_dir": out, "save_steps": 2}
    eng = _port_engine(cfg)
    retries = _count("ckpt_retries_total")
    losses = eng.fit(make_batches(4, seed=3))
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert _count("ckpt_retries_total") - retries == 1
    assert C.completed_steps(out) == [2, 4]
    assert faults_mod.active_plan().ckpt_write_fail_times == 0


def test_data_raise_propagates_and_a_restart_resumes(tmp_path):
    out = str(tmp_path / "ckpt")
    batches = make_batches(4, seed=8)
    cfg = _cfg(4, Resilience={"enable": True,
                              "faults": {"data_raise_at": 2}})
    cfg["Engine"]["save_load"] = {"output_dir": out, "save_steps": 1}
    with pytest.raises(faults_mod.InjectedFault):
        _port_engine(cfg).fit(list(batches))
    assert C.latest_step(out) == 2
    cfg2 = _cfg(4, Resilience={"enable": True})
    cfg2["Engine"]["save_load"] = {"output_dir": out, "save_steps": 1}
    eng2 = _port_engine(cfg2)
    part2 = eng2.fit(list(batches[2:]))
    assert len(part2) == 2 and all(np.isfinite(part2))
    assert eng2.step == 4 and C.completed_steps(out) == [1, 2, 3, 4]


def test_corrupt_checkpoint_drills(tmp_path):
    """``corrupt_ckpt_at``: the save-side read-back refuses the step after
    the retries (no meta marker); ``corrupt_restore_at``: the restore
    refuses the corrupt step and falls back to the newest that
    verifies."""
    out = str(tmp_path / "ckpt")
    cfg = _cfg(2, Resilience={"enable": True,
                              "retry": {"max_attempts": 2, "backoff_s": 0.0,
                                        "jitter": 0.0},
                              "faults": {"corrupt_ckpt_at": 2}})
    cfg["Engine"]["save_load"] = {"output_dir": out, "save_steps": 1}
    eng = _port_engine(cfg)
    retries = _count("ckpt_retries_total")
    with pytest.raises(WriteVerifyError, match="read-back"):
        eng.fit(make_batches(2, seed=1))
    assert _count("ckpt_retries_total") - retries == 1
    assert C.completed_steps(out) == [1]
    assert os.path.isdir(os.path.join(out, "step_2"))  # never marked
    with pytest.raises(WriteVerifyError):  # the drill is sticky
        eng.save()
    faults_mod.install_plan(None)
    eng.save()
    assert C.completed_steps(out) == [1, 2]

    fresh = _port_engine(_cfg(2))
    faults_mod.install_plan(faults_mod.FaultPlan(corrupt_restore_at=2))
    fallbacks = _count("ckpt_verify_fallbacks")
    assert fresh.load(out) and fresh.step == 1
    assert _count("ckpt_verify_fallbacks") - fallbacks == 1


def test_watchdog_quiet_through_a_fit(tmp_path):
    cfg = _cfg(3, Resilience={"enable": True,
                              "watchdog": {"enable": True,
                                           "min_timeout_s": 120.0,
                                           "poll_s": 0.05}})
    cfg["Engine"]["save_load"] = {"output_dir": str(tmp_path / "out"),
                                  "save_steps": 2}
    eng = _port_engine(cfg)
    stalls = _count("watchdog_stalls")
    assert len(eng.fit(make_batches(3, seed=9))) == 3
    assert _count("watchdog_stalls") == stalls
    import threading

    assert not any(t.name == "fleetx-watchdog"
                   for t in threading.enumerate())


def test_watchdog_fires_once_per_stall_episode():
    reg = MetricsRegistry()
    reg.histogram("step_time").record(0.01)
    flushed = []
    wd = StepWatchdog(stall_factor=2.0, min_timeout_s=0.05, poll_s=0.01,
                      on_stall=lambda: flushed.append(1), registry=reg)
    wd.start()
    try:
        time.sleep(0.2)  # unarmed until the first beat
        assert reg.counter("watchdog_stalls").value == 0
        wd.beat(1)
        time.sleep(0.4)  # one stall episode, fired once
        assert reg.counter("watchdog_stalls").value == 1 and flushed == [1]
        with wd.suspended():
            time.sleep(0.3)  # a save or restore: not a stall
        assert reg.counter("watchdog_stalls").value == 1
        wd.beat(2)  # progress re-arms
        time.sleep(0.4)
        assert reg.counter("watchdog_stalls").value == 2
    finally:
        wd.stop()


def test_preemption_through_the_real_cli_then_resume(tmp_path):
    """``FLEETX_FAULTS=sigterm_at=2`` on the training CLI: rc is
    ``preemption.exit_code`` and step 2 is saved; the same command without
    the fault resumes from it and finishes."""
    out = str(tmp_path / "out")
    cmd = [sys.executable, "-m", "fleetx_tpu_torch.tools.train", "-c",
           SYNTH_YAML, "--device", "cpu"]
    for o in TINY + ["Engine.max_steps=4", "Resilience.enable=True",
                     "Resilience.preemption.exit_code=75",
                     f"Engine.save_load.output_dir={out}"]:
        cmd += ["-o", o]
    env = dict(os.environ, PYTHONPATH=REPO, FLEETX_FAULTS="sigterm_at=2",
               OMP_NUM_THREADS="1")
    first = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                           text=True, timeout=300)
    assert first.returncode == 75, first.stderr[-3000:]
    assert C.completed_steps(out) == [2]
    env.pop("FLEETX_FAULTS")
    second = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                            text=True, timeout=300)
    assert second.returncode == 0, second.stderr[-3000:]
    assert "auto-resume: restoring step 2" in second.stderr
    steps = [l.split("global step ")[1].split(",")[0]
             for l in second.stderr.splitlines() if "[train] global" in l]
    assert steps == ["3", "4"]
