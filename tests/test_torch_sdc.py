"""Port parity: the SDC sentinel (``EagerEngine._sdc_check`` and its
replay), the parameter fingerprint (``resilience/integrity.
params_fingerprint``) and the bit-flip drill (``_apply_bitflip``,
``FaultPlan.take_bitflip``), against the JAX engine's and module's
(``tests/test_zz_integrity.py``'s sentinel tests mirrored).

Both engines train the tiny GPT of ``tests/test_engine.py`` (hidden 64, 2
layers, seq 32, vocab 128, batch 8, f32, dropout 0) from the same
initial weights (the JAX engine's, converted) on the same numpy batches.

Tolerances: counts, actions, marker keys and fingerprints are equal
(fingerprints are integers). The port's runs with the sentinel on and off
are equal bit for bit, and so are the step's metrics and the replay's.
Losses against the JAX engine agree within 1e-5 (f32: the same ops
summed in another order by another library).
"""

import json

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.core import meta

from fleetx_tpu.observability.metrics import get_registry as j_registry
from fleetx_tpu.parallel.mesh import build_mesh
from fleetx_tpu.resilience import faults as j_faults
from fleetx_tpu.resilience import integrity as j_integrity
from fleetx_tpu.resilience.policy import set_default_policy as j_set_policy
from fleetx_tpu_torch.convert import jax_leaves, params_from_jax
from fleetx_tpu_torch.core.engine import EagerEngine
from fleetx_tpu_torch.core.module import GPTModule
from fleetx_tpu_torch.observability.metrics import get_registry
from fleetx_tpu_torch.optims import lr_scheduler as TLR
from fleetx_tpu_torch.optims import optimizer as TOPT
from fleetx_tpu_torch.resilience import TrainingAborted
from fleetx_tpu_torch.resilience import faults as faults_mod
from fleetx_tpu_torch.resilience import integrity
from fleetx_tpu_torch.resilience import policy as P

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


@pytest.fixture(autouse=True)
def _isolate_process_state():
    """Clear both packages' fault plans and retry policies after each
    test."""
    yield
    faults_mod.install_plan(None)
    P.set_default_policy(None)
    j_faults.install_plan(None)
    j_set_policy(None)


#: ``tests/test_engine.py``'s optimizer and schedule
LR = {"name": "cosine", "max_lr": 1e-3, "min_lr": 1e-4, "warmup_steps": 2,
      "decay_steps": 100}
OPT = {"name": "AdamW", "weight_decay": 0.01,
       "grad_clip": {"clip_norm": 1.0}}
STEPS = 4
SEED = 16


def _res(every: int, action: str = "log") -> dict:
    return {"enable": True, "guard": {"enable": False},
            "integrity": {"sentinel_every": every,
                          "sentinel_action": action}}


def _cfg(max_steps: int, **sections) -> dict:
    cfg = tiny_cfg()
    cfg["Engine"]["max_steps"] = max_steps
    cfg.update(sections)
    return cfg


def _port_engine(cfg: dict, params: dict) -> EagerEngine:
    lr = TLR.build_lr_scheduler(LR)
    eng = EagerEngine(cfg, GPTModule(cfg),
                      optimizer=TOPT.build_optimizer(OPT, lr),
                      lr_schedule=lr, device="cpu")
    eng.params = params_from_jax(params, eng.module.model_cfg)
    return eng


def _count(name: str) -> float:
    return get_registry().counter(name).value


def _j_count(name: str) -> float:
    return j_registry().counter(name).value


@pytest.fixture(scope="module")
def jax_run(devices8, tmp_path_factory):
    """The JAX engine's sentinel run (every step, 4 steps: only its
    non-donating twin compiles), its initial params, and its quarantine
    marker for a poisoned metric (the compiled twin re-used)."""
    out = tmp_path_factory.mktemp("jax_sdc")
    cfg = _cfg(STEPS, Resilience=_res(1))
    cfg["Engine"]["save_load"] = {"output_dir": str(out)}
    eng = build_engine(cfg, build_mesh({}, devices=devices8[:1]))
    batches = make_batches(STEPS, seed=SEED)
    eng.prepare(batches[0])
    params = jax.device_get(meta.unbox(eng.state.params))
    checks = _j_count("sdc_checks_total")
    mism = _j_count("sdc_replay_mismatches")
    losses = eng.fit(batches)
    checks = _j_count("sdc_checks_total") - checks
    mism = _j_count("sdc_replay_mismatches") - mism
    # a quarantine: the step's loss poisoned, the replay honest
    eng.resilience.sentinel_action = "quarantine"
    sharded = eng.shard_batch(batches[0])
    _, real = eng._train_step_nodonate(eng.state, sharded)
    eng._sdc_check(eng.state, sharded, dict(real, loss=real["loss"] + 1.0),
                   STEPS, False)
    with open(out / "sdc_quarantine.json") as f:
        marker = json.load(f)
    return {"params": params, "losses": losses, "checks": checks,
            "mismatches": mism, "marker": marker, "engine": eng,
            "batches": batches}


def test_sentinel_on_is_bitwise_off_and_within_jax(jax_run):
    """Sentinel off, every step and every 2nd step: the same losses bit
    for bit; the off run builds no snapshot (JAX: no twin); every step
    checks 4 times, as JAX's run, and every 2nd step steps 2 and 4 (JAX's
    ``test_sentinel_cadence_subsamples``); no mismatch on healthy
    hardware; the losses within 1e-5 of the JAX engine's sentinel run."""
    batches = jax_run["batches"]
    runs = {}
    for every in (0, 1, 2):
        eng = _port_engine(_cfg(STEPS, Resilience=_res(every)),
                           jax_run["params"])
        snaps = []
        real = eng._sentinel_snapshot
        eng._sentinel_snapshot = lambda: snaps.append(1) or real()
        checks = _count("sdc_checks_total")
        mism = _count("sdc_replay_mismatches")
        runs[every] = eng.fit(batches)
        assert _count("sdc_checks_total") - checks == \
            (STEPS // every if every else 0)
        assert len(snaps) == (STEPS // every if every else 0)
        assert _count("sdc_replay_mismatches") == mism
    assert runs[0] == runs[1] == runs[2]
    assert len(runs[2]) == STEPS
    assert jax_run["checks"] == STEPS and jax_run["mismatches"] == 0
    np.testing.assert_allclose(runs[2], jax_run["losses"], rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("accumulate", [1, 2])
def test_replay_metrics_equal_the_step_bit_for_bit(jax_run, accumulate):
    """The replay on the snapshot from before a step gives the step's
    ``loss`` and ``grad_norm`` bit for bit (the replay stops before the
    optimizer; both norms come from ``optimizer.grad_norm``), with and
    without the finite check and under microbatch accumulation, and moves
    no step, moment or parameter."""
    for guard in (False, True):
        res = _res(0)
        res["guard"] = {"enable": guard}
        cfg = _cfg(STEPS, Resilience=res)
        cfg["Engine"]["accumulate_steps"] = accumulate
        eng = _port_engine(cfg, jax_run["params"])
        eng.prepare()
        assert eng.check_finite == guard
        batch = eng.to_device(jax_run["batches"][0])
        prev = eng._sentinel_snapshot()
        metrics = eng.train_step(batch)
        after = [p.detach().clone() for p in eng._leaves]
        count = eng.opt_state["count"]
        replay = eng._replay(prev, batch)
        for key in ("loss", "grad_norm"):
            assert torch.equal(torch.as_tensor(metrics[key]), replay[key])
        assert eng.step == 1 and eng.opt_state["count"] == count
        assert all(torch.equal(a, p) for a, p in zip(after, eng._leaves))


def _poisoned(eng: EagerEngine) -> EagerEngine:
    """Every replay sees a loss 1.0 off the step's: the staged compute
    fault between the two runs (JAX's ``_engine_with_poisoned_replay``)."""
    real = eng._replay

    def replay(prev, batch):
        out = real(prev, batch)
        return dict(out, loss=out["loss"] + 1.0)

    eng._replay = replay
    return eng


def test_poisoned_replay_aborts(jax_run, tmp_path):
    cfg = _cfg(3, Resilience=_res(1, "abort"))
    cfg["Engine"]["save_load"] = {"output_dir": str(tmp_path / "out")}
    eng = _poisoned(_port_engine(cfg, jax_run["params"]))
    mism = _count("sdc_replay_mismatches")
    with pytest.raises(TrainingAborted, match="SDC sentinel"):
        eng.fit(jax_run["batches"][:3])
    assert _count("sdc_replay_mismatches") - mism == 1
    assert eng.step == 1


def test_poisoned_replay_quarantines_with_jax_marker(jax_run, tmp_path):
    """``quarantine`` counts every check, writes the marker with the JAX
    marker's keys and evidence form, and training goes on."""
    cfg = _cfg(3, Resilience=_res(1, "quarantine"))
    cfg["Engine"]["save_load"] = {"output_dir": str(tmp_path / "out")}
    eng = _poisoned(_port_engine(cfg, jax_run["params"]))
    q = _count("sdc_quarantines")
    losses = eng.fit(jax_run["batches"][:3])
    assert len(losses) == 3
    assert _count("sdc_quarantines") - q == 3
    with open(tmp_path / "out" / "sdc_quarantine.json") as f:
        record = json.load(f)
    want = jax_run["marker"]
    assert sorted(record) == sorted(want)
    assert record["rank"] == want["rank"] == 0 and record["step"] == 3
    assert [e.split(":")[0] for e in record["evidence"]] == \
        [e.split(":")[0] for e in want["evidence"]] == ["replay loss"]
    assert record["evidence"][0].split(": ")[1].startswith("array(")
    assert want["evidence"][0].split(": ")[1].startswith("array(")


def _mixed_tree() -> dict:
    """Every dtype branch of the fingerprint: bf16, f16, f32, f64, int32
    with negatives, int8, bool; keys out of order on purpose."""
    rng = np.random.RandomState(3)
    return {
        "z": {"b": rng.randn(5, 3).astype(ml_dtypes.bfloat16),
              "a": rng.randn(7).astype(np.float16)},
        "m": rng.randint(-2 ** 31, 2 ** 31 - 1, size=(4, 4)).astype(
            np.int32),
        "c": {"f64": rng.randn(6), "i8": np.array([-128, -1, 0, 5, 127],
                                                  dtype=np.int8),
              "flag": np.array([True, False, True])},
        "a": rng.randn(2, 3, 4).astype(np.float32) * 1e30,
    }


def _to_port(node):
    if isinstance(node, dict):
        return {k: _to_port(v) for k, v in node.items()}
    if node.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(node.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(node))


def test_fingerprint_equals_jax_on_every_dtype():
    tree = _mixed_tree()
    # JAX without x64 holds the f64 leaf as f32: the port's downcast
    want = int(jax.jit(j_integrity.params_fingerprint)(
        jax.tree.map(jnp.asarray, tree)))
    assert integrity.params_fingerprint(jax_leaves(_to_port(tree))) == want


def test_fingerprint_and_bitflip_equal_jax_on_converted_params(jax_run):
    """``params_fingerprint`` of the converted params equals JAX's on
    the JAX params exactly (f32 and bf16), before and after each side's
    ``_apply_bitflip``; a second flip restores the value."""
    jeng = jax_run["engine"]
    params = jax_run["params"]
    fp = jax.jit(j_integrity.params_fingerprint)
    eng = _port_engine(_cfg(1), params)
    eng.prepare()
    mine = lambda: integrity.params_fingerprint(jax_leaves(eng.params))
    state = jeng.state.replace(params=jax.tree.map(jnp.asarray, params))
    with jeng._ctx():
        before = int(fp(state.params))
        flipped = jeng._apply_bitflip(state)
        after = int(fp(flipped.params))
    assert mine() == before
    eng._apply_bitflip()
    assert mine() == after != before
    eng._apply_bitflip()
    assert mine() == before
    # bf16 leaves: the 16-bit branch on both sides
    half = jax.tree.map(lambda x: np.asarray(x).astype(ml_dtypes.bfloat16),
                        params)
    assert integrity.params_fingerprint(jax_leaves(_to_port(half))) == \
        int(fp(jax.tree.map(jnp.asarray, half)))


def test_bitflip_plan_and_drill_through_fit(jax_run):
    """``bitflip_param_at`` parses from config and ``FLEETX_FAULTS`` as
    JAX's plan does and fires once; through ``fit`` it flips exactly bit
    0 of the first float leaf (JAX order) after that step, so the run
    differs from a clean one in that one bit after 2 steps."""
    for cfg, env in (({"bitflip_param_at": 2}, ""),
                     ({"bitflip_param_at": 9}, "bitflip_param_at=3")):
        tp = faults_mod.FaultPlan.from_cfg(cfg, env=env)
        jp = j_faults.FaultPlan.from_cfg(cfg, env=env)
        assert tp.bitflip_param_at == jp.bitflip_param_at and tp.armed
        got = [tp.take_bitflip(s) for s in range(5)]
        assert got == [jp.take_bitflip(s) for s in range(5)]
        assert sum(got) == 1
    runs = {}
    for flip in (None, 2):
        res = {"enable": True, "guard": {"enable": False},
               "faults": {"bitflip_param_at": flip}}
        eng = _port_engine(_cfg(2, Resilience=res), jax_run["params"])
        eng.fit(jax_run["batches"][:2])
        runs[flip] = [p.detach() for p in jax_leaves(eng.params)]
    first = runs[None][0].reshape(-1).view(torch.int32)
    flipped = runs[2][0].reshape(-1).view(torch.int32)
    assert int(first[0] ^ flipped[0]) == 1
    assert torch.equal(first[1:], flipped[1:])
    assert all(torch.equal(a, b) for a, b in zip(runs[None][1:], runs[2][1:]))


def test_integrity_knobs_roundtrip_and_validation():
    """The loader's and the facade's checks of ``Resilience.integrity``,
    as JAX's (``test_config_integrity_knobs_roundtrip_and_validation``)."""
    from fleetx_tpu.resilience import Resilience as JRes
    from fleetx_tpu.utils.config import create_attr_dict as j_attr
    from fleetx_tpu.utils.config import process_resilience_config as j_proc
    from fleetx_tpu_torch.resilience import Resilience
    from fleetx_tpu_torch.utils.config import (create_attr_dict,
                                               process_resilience_config)

    good = {"Resilience": {"integrity": {
        "verify_checkpoints": True, "sentinel_every": 8,
        "sentinel_action": "quarantine"}}}
    cfg = process_resilience_config(create_attr_dict(good))
    integ = cfg["Resilience"]["integrity"]
    assert integ["sentinel_every"] == 8 and \
        integ["sentinel_action"] == "quarantine"
    for bad in ({"sentinel_every": -1}, {"sentinel_action": "explode"},
                {"verify_checkpoints": "yes"}):
        with pytest.raises(ValueError):
            process_resilience_config(create_attr_dict({"Resilience": {
                "integrity": bad}}))
        with pytest.raises(ValueError):
            j_proc(j_attr({"Resilience": {"integrity": bad}}))
    with pytest.raises(ValueError):
        Resilience({"enable": True,
                    "integrity": {"sentinel_action": "explode"}})
    for block in ({"enable": True, "integrity": {"sentinel_every": 4}},
                  {"enable": True, "integrity": {
                      "verify_checkpoints": False}},
                  None, {"integrity": {"sentinel_every": 4}}):
        mine, want = Resilience(block), JRes(block)
        for key in ("sentinel_every", "sentinel_action",
                    "integrity_verify"):
            assert getattr(mine, key) == getattr(want, key), (block, key)

