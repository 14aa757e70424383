"""Port parity: the trainer's telemetry (``fleetx_tpu_torch/observability/``:
``metrics``' ``mfu`` and ``DerivedMetrics``, ``sinks``, ``schema``,
``trace``, ``memory``, ``gang``'s merges and the ``Observability``
facade; ``utils/config.process_observability_config``;
``data/prefetch.DevicePrefetcher``; the engine's wiring; the report
tools under ``fleetx_tpu_torch/tools/``).

Each piece is held against the JAX package on the same inputs: the same
window sequences, the same records (files byte for byte), the same
verdicts, the same state transitions (a fake profiler on both sides, as
``tests/test_zz_perf.py`` fakes ``jax.profiler``). The engines train the
tiny GPT of ``tests/test_observability.py`` (hidden 64, 2 layers, 4 heads,
seq 32, vocab 128, batch 8, f32, dropout 0) from the JAX engine's
initial weights, converted, on the same numpy batches, with telemetry on.

Tolerances: losses against the JAX engine within 1e-5 (f32: the same ops
summed in another order by another library); the port's own runs with
the prefetcher at depth 0, 1 and 2 bit for bit; everything else equal.
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

from fleetx_tpu import observability as jobs
from fleetx_tpu.observability import gang as jgang
from fleetx_tpu.observability import memory as jmemory
from fleetx_tpu.observability import schema as jschema
from fleetx_tpu.observability import sinks as jsinks
from fleetx_tpu.observability import trace as jtrace
from fleetx_tpu.utils import config as jconfig
from fleetx_tpu_torch import observability as obs
from fleetx_tpu_torch.convert import params_from_jax
from fleetx_tpu_torch.core.engine import EagerEngine
from fleetx_tpu_torch.core.module import GPTModule
from fleetx_tpu_torch.data.prefetch import DevicePrefetcher
from fleetx_tpu_torch.observability import gang, memory, schema, sinks
from fleetx_tpu_torch.observability import trace
from fleetx_tpu_torch.optims import lr_scheduler as TLR
from fleetx_tpu_torch.optims import optimizer as TOPT
from fleetx_tpu_torch.utils import config as tconfig

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEBUG_YAML = os.path.join(REPO, "fleetx_tpu", "configs", "nlp", "gpt",
                          "pretrain_gpt_debug_obs.yaml")
SERVING_YAML = os.path.join(REPO, "fleetx_tpu", "configs", "nlp", "gpt",
                            "serving_gpt_345M.yaml")
VOCAB, SEQ, BATCH = 128, 32, 8
LOSS_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """Tiny tensors: torch on one intra-op thread, restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------ derived

@pytest.mark.parametrize("args", [
    (70_000.0, 2.5e9, 989e12, 1), (1.0, 6.0, 1.0, 4), (None, 1.0, 1.0, 1),
    (5.0, None, 1.0, 1), (5.0, 1.0, None, 1), (0.0, 1.0, 1.0, 1),
    (10.0, 3.0, 7.0, 0)])
def test_mfu_matches_jax(args):
    assert obs.mfu(*args) == jobs.mfu(*args)


def test_derived_metrics_window_sequence_matches_jax():
    windows = [(0.25, 8, 1024, 2, 0.0), (0.5, 8, 1024, 2, 0.1),
               (0.125, 8, None, 1, 0.05), (1e-15, 4, 1024, 3, 0.6),
               (0.3, 8, 1024, 2, 0.7)]
    for alpha in (0.1, 0.0, 1.0):
        j = jobs.DerivedMetrics(2.5e9, 989e12, n_devices=1, ewma_alpha=alpha)
        t = obs.DerivedMetrics(2.5e9, 989e12, n_devices=1, ewma_alpha=alpha)
        for st, gbs, tps, steps, stall in windows:
            kw = dict(tokens_per_sample=tps, steps_in_window=steps,
                      stall_seconds_total=stall)
            assert t.update(st, gbs, **kw) == j.update(st, gbs, **kw)
        for census in ({0: 1.0, 1: 1.5, 2: 0.9}, {0: 2.0, 1: 2.6, 2: 2.1},
                       {0: 3.0}, {0: 4.0, 1: 4.1, 2: 4.0, 3: 5.0}):
            j.update_arrivals(census)
            t.update_arrivals(census)
            assert t.rank_skew() == j.rank_skew()
            assert t.slowest_rank() == j.slowest_rank()


def test_registry_snapshot_and_default_window_match_jax():
    regs = (obs.MetricsRegistry(), jobs.MetricsRegistry())
    for r in regs:
        r.set_default_window(3)
        r.counter("c").inc(2.5)
        r.gauge("g").set(7)
        for v in (1.0, 5.0, 2.0, 9.0):
            r.histogram("h").record(v)
        with r.timer("phase"):
            pass
    snaps = [r.snapshot() for r in regs]
    for snap in snaps:  # wall-clock timings differ; their shape does not
        assert snap.pop("phase")["count"] == 1
        assert snap.pop("phase_seconds_total") > 0
    assert snaps[0] == snaps[1]
    assert snaps[0]["h"]["count"] == 3  # the default window took


# ------------------------------------------------------------------ sinks

RECORDS = [
    {"ts": 1.5, "step": 1, "loss": np.float32(2.75), "step_time": 0.25,
     "tokens_per_sec": 32768.0, "mfu": None, "flag": True,
     "nested": {"a": [np.int64(1), 2.5], "b": None}, "name": "x,y\"z"},
    {"ts": 2.5, "step": 2, "loss": 2.5, "step_time": 0.5,
     "tokens_per_sec": None, "mfu": 0.31, "extra": np.float64(1e-9)},
    {"step": 3, "loss": float("inf"), "ts": 3.0, "step_time": 1,
     "tokens_per_sec": 1, "mfu": 0.0, "engine": "EagerEngine"},
]


def _write(build, out_dir, names):
    made = build(names, str(out_dir))
    for rec in RECORDS:
        for s in made:
            s.emit(dict(rec))
    for s in made:
        s.flush()
        s.close()
    return sorted(os.listdir(out_dir))


def test_sinks_write_byte_identical_files(tmp_path):
    names = ["jsonl", "csv", "prometheus", "bogus"]
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    files = _write(jsinks.build_sinks, jdir, names)
    assert _write(sinks.build_sinks, tdir, names) == files == \
        ["metrics.csv", "metrics.jsonl", "metrics.prom"]
    for f in files:
        assert (tdir / f).read_bytes() == (jdir / f).read_bytes(), f
    # a resumed CsvSink keeps the header of the file it appends to
    for d, mod in ((jdir, jsinks), (tdir, sinks)):
        s = mod.CsvSink(str(d / "metrics.csv"))
        s.emit({"step": 9, "loss": 1.0, "new_key": 3})
        s.close()
    assert (tdir / "metrics.csv").read_bytes() == \
        (jdir / "metrics.csv").read_bytes()
    suffixed = sinks.build_sinks(["jsonl"], str(tdir), suffix=".rank0")
    assert [os.path.basename(s.path) for s in suffixed] == \
        ["metrics.rank0.jsonl"]
    suffixed[0].close()


# ----------------------------------------------------------------- schema

def _cases():
    good = {"step": 1, "ts": 1.0, "loss": 2.0, "step_time": 0.1,
            "tokens_per_sec": None, "mfu": None}
    return [good, dict(good, hbm_stats="ok", hbm_peak_bytes=5),
            dict(good, loss=float("nan")), dict(good, loss=True),
            {k: v for k, v in good.items() if k != "mfu"},
            dict(good, step="1"), dict(good, rank=0, world=2,
                                       schema_version=2),
            dict(good, hbm_stats=3), [1, 2], "x", None,
            {"ts": 1.0, "scope": "serving"}]


def test_validators_give_jax_verdicts(tmp_path):
    for rec in _cases():
        assert schema.validate_record(rec) == jschema.validate_record(rec)
        assert schema.validate_serving_record(rec) == \
            jschema.validate_serving_record(rec)
        assert schema.validate_fleet_record(rec) == \
            jschema.validate_fleet_record(rec)
        if isinstance(rec, dict):
            assert schema.record_schema_version(rec) == \
                jschema.record_schema_version(rec)
    path = tmp_path / "m.jsonl"
    path.write_text("\n".join(json.dumps(c) for c in _cases())
                    + "\n{not json\n\n")
    assert schema.validate_jsonl(str(path)) == jschema.validate_jsonl(
        str(path))
    assert schema.validate_jsonl(str(path), max_errors=2) == \
        jschema.validate_jsonl(str(path), max_errors=2)
    traces = [
        {"traceEvents": [{"name": "a", "ph": "X", "ts": 1.0, "dur": 2.0,
                          "pid": 0, "tid": 1}]},
        {"traceEvents": [{"name": "a", "ph": "X", "ts": 1.0, "pid": 0,
                          "tid": 1}]},
        {"traceEvents": [{"name": 3, "ph": "B", "ts": "x", "pid": "Spans",
                          "tid": 1}, "junk"]},
        {"traceEvents": "nope"}, [], {"traceEvents": [
            {"name": "a", "ph": "X", "ts": 1.0, "pid": 0}] * 30}]
    for t in traces:
        assert schema.chrome_trace_errors(t) == \
            jschema.chrome_trace_errors(t)


# ------------------------------------------------------------------- gang

def _window(step, step_time, tps, loss, mfu=None, skew=None):
    rec = {"ts": 100.0 + step, "step": step, "loss": loss,
           "step_time": step_time, "tokens_per_sec": tps,
           "samples_per_sec": tps / 1024.0, "mfu": mfu,
           "global_batch_size": 8}
    if skew is not None:
        rec["rank_skew"] = skew
    return rec


def test_gang_merges_match_jax():
    regs = []
    for mod in (obs, jobs):
        r = mod.MetricsRegistry()
        r.counter("nonfinite_skips").inc(2)
        r.counter("rollbacks_total").inc()
        for v in (1.0, 4.0, 2.0):
            r.histogram("barrier_wait_ms").record(v)
        regs.append(r)
    rec = _window(2, 0.5, 4000.0, 2.5, mfu=0.3, skew=0.01)
    assert gang.snapshot(rec, regs[0], 1, 3) == \
        jgang.snapshot(rec, regs[1], 1, 3)
    snaps = {
        0: [jgang.snapshot(_window(2, 0.5, 4000.0, 2.5, 0.3, 0.0),
                           regs[1], 0, 0),
            jgang.snapshot(_window(4, 0.4, 5000.0, 2.4, 0.31), regs[1], 0,
                           1)],
        1: [jgang.snapshot(_window(2, 0.7, 3000.0, 2.6, None, 0.2),
                           regs[1], 1, 0)],
        2: [{"w": 1, "rank": 2, "record": _window(4, 0.45, 4500.0, 2.3),
             "counters": {}}],
    }
    assert gang.merge_snapshots(snaps, world=4) == \
        jgang.merge_snapshots(snaps, world=4)
    by_rank = {"metrics.rank1.jsonl": [dict(_window(2, 0.6, 10.0, 1.0),
                                            rank=1)],
               "metrics.rank0.jsonl": [_window(2, 0.5, 20.0, 2.0),
                                       _window(4, 0.5, 21.0, 1.5)]}
    assert gang.merge_rank_records(by_rank) == \
        jgang.merge_rank_records(by_rank)
    assert gang.merge_rank_records(by_rank, world=3) == \
        jgang.merge_rank_records(by_rank, world=3)


def test_gang_mode_raises_naming_item_12(tmp_path):
    with pytest.raises(NotImplementedError, match="item 12"):
        obs.Observability({"enable": True, "gang": True,
                           "output_dir": str(tmp_path)})


# ------------------------------------------------------- profiler window

class _FakeProfile:
    """``torch.profiler.profile`` stand-in: counts set-ups and recordings
    and writes an empty trace."""

    opened = 0
    recording = 0

    def __init__(self, **kwargs):
        self.kwargs = kwargs

    def prepare_trace(self):
        _FakeProfile.opened += 1

    def start_trace(self):
        _FakeProfile.recording += 1

    def stop_trace(self):
        _FakeProfile.recording -= 1

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            f.write('{"traceEvents": []}')


def _transitions(pw, stop_calls) -> list:
    """Two fits of 10 steps each over one window object: every
    ``maybe_start`` / ``maybe_stop`` result and the active flag."""
    out = []
    step = 0
    for _fit in range(2):
        pw.arm()
        for _ in range(10):
            out.append(("start", step, pw.maybe_start(step), pw.active))
            step += 1
            out.append(("stop", step, pw.maybe_stop(step), pw.active))
        pw.stop()
        out.append(("end", pw.active, len(stop_calls)))
    return out


@pytest.mark.parametrize("cfg", [
    {"enable": True, "scheduler": [3, 6]},
    {"enable": True, "start_step": 0, "stop_step": 1},
    {"enable": True, "scheduler": [4]},
    {"enable": True, "scheduler": [8, 30]},
    {"enable": False, "scheduler": [3, 6]}])
def test_profiler_window_transitions_match_jax(cfg, tmp_path, monkeypatch):
    import torch.profiler

    monkeypatch.setattr(jax.profiler, "start_trace", lambda *a, **k: None)
    monkeypatch.setattr(jax.profiler, "stop_trace", lambda: None)
    monkeypatch.setattr(torch.profiler, "profile", _FakeProfile)
    cfg = dict(cfg, output_dir=str(tmp_path))
    jcalls, tcalls = [], []
    jpw, tpw = jtrace.ProfilerWindow(cfg), trace.ProfilerWindow(cfg)
    jpw.on_stop, tpw.on_stop = jcalls.append, tcalls.append
    assert (tpw.start_step, tpw.stop_step, tpw.output_dir) == \
        (jpw.start_step, jpw.stop_step, jpw.output_dir)
    assert _transitions(tpw, tcalls) == _transitions(jpw, jcalls)
    assert tcalls == jcalls
    if cfg["enable"]:
        assert tpw.trace_path.endswith(".pt.trace.json")
        assert os.path.exists(tpw.trace_path)
    # a raising hook never escapes stop()
    tpw.arm()
    tpw.on_stop = lambda d: (_ for _ in ()).throw(RuntimeError("boom"))
    if tpw.maybe_start(10 ** 6):
        assert tpw.maybe_stop(10 ** 6)
    # the step and region marks are null contexts outside the window
    assert not tpw.active
    with tpw.step_span(3), tpw.annotate("fwd_scan"):
        pass


def test_profiler_warms_up_one_step_before_the_window(tmp_path,
                                                     monkeypatch):
    import torch.profiler

    monkeypatch.setattr(torch.profiler, "profile", _FakeProfile)
    pw = trace.ProfilerWindow({"enable": True, "scheduler": [3, 6],
                               "output_dir": str(tmp_path)})
    opened, recording = _FakeProfile.opened, _FakeProfile.recording
    assert not pw.maybe_start(1) and _FakeProfile.opened == opened
    # the step before the window: the profiler is set up, not recording
    assert not pw.maybe_start(2) and _FakeProfile.opened == opened + 1
    assert _FakeProfile.recording == recording and not pw.active
    with pw.step_span(2):  # the warm-up step is not marked
        pass
    assert pw.maybe_start(3) and pw.active
    assert _FakeProfile.opened == opened + 1  # the same profile records
    assert _FakeProfile.recording == recording + 1
    pw.stop()
    assert _FakeProfile.recording == recording
    # a fit that ends in the warm-up step drops it, exporting nothing
    pw.arm()
    pw.trace_path = None
    assert not pw.maybe_start(2)
    pw.stop()
    assert pw.trace_path is None and not pw.active
    assert _FakeProfile.recording == recording


# ----------------------------------------------------------------- memory

def test_memory_monitor_matches_jax():
    seq = [None, {"bytes_in_use": 10, "peak_bytes_in_use": 40,
                  "bytes_limit": 100}, None,
           {"bytes_in_use": 30, "peak_bytes_in_use": 90}, {"bytes_in_use": 5}]
    for predicted in (None, 64.0, 128):
        mons = []
        for mod, reg in ((memory, obs.MetricsRegistry()),
                         (jmemory, jobs.MetricsRegistry())):
            it = iter(seq)
            mons.append((mod.MemoryMonitor(registry=reg,
                                           predicted_bytes=predicted,
                                           stats_fn=lambda it=it: next(it)),
                         reg))
        for phase in ("first_step", "steady_state", "eval", "profile_stop",
                      "checkpoint_save"):
            (t, treg), (j, jreg) = mons
            assert t.sample(phase) == j.sample(phase)
            assert t.record_keys() == j.record_keys()
            assert t.snapshot() == j.snapshot()
            assert treg.snapshot() == jreg.snapshot()
    assert memory.sample_memory_stats(torch.device("cpu")) is None


def test_memory_monitor_unavailable_on_cpu():
    mon = memory.MemoryMonitor(
        stats_fn=lambda: memory.sample_memory_stats("cpu"))
    assert mon.sample("first_step") is None
    assert mon.record_keys() == {"hbm_stats": "unavailable",
                                 "hbm_peak_bytes": None,
                                 "hbm_model_error": None}


# ----------------------------------------------------------------- config

@pytest.mark.parametrize("block", [
    None, {"enable": True}, {"enable": True, "flight": {"capacity": 8}},
    {"flight": {"capacity": 0}}, {"perf": {"top_k": 0}},
    {"perf": {"top_k": 3}, "gang": False}])
def test_process_observability_config_matches_jax(block):
    def run(mod):
        cfg = mod.AttrDict()
        if block is not None:
            cfg["Observability"] = mod.AttrDict(block)
        try:
            return mod.process_observability_config(cfg)["Observability"]
        except ValueError as e:
            return str(e)
    assert run(tconfig) == run(jconfig)


def test_get_config_fills_the_block():
    cfg = tconfig.get_config(DEBUG_YAML)
    # the JAX loader derives its mesh from the 8 test devices; its
    # Observability step is this one
    jcfg = jconfig.process_observability_config(
        jconfig.parse_config(DEBUG_YAML))
    assert dict(cfg["Observability"]) == dict(jcfg["Observability"])
    assert tconfig.get_config(os.path.join(
        REPO, "fleetx_tpu", "configs", "nlp", "gpt",
        "pretrain_gpt_345M_synthetic.yaml"))["Observability"] == \
        {"enable": False, "gang": False}


# ----------------------------------------------------------------- engine

def _cfg(tmp_path, tag, max_steps=4, prefetch=0, **obs_over):
    return {
        "Model": dict(vocab_size=VOCAB, hidden_size=64, num_layers=2,
                      num_attention_heads=4, max_position_embeddings=SEQ,
                      hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0,
                      use_flash_attention=False, dtype="float32",
                      param_dtype="float32"),
        "Engine": {"max_steps": max_steps, "logging_freq": 1,
                   "eval_freq": 0, "prefetch_to_device": prefetch,
                   "save_load": {"save_steps": max_steps,
                                 "output_dir": str(tmp_path / tag / "ckpt")}},
        "Global": {"seed": 7},
        "Observability": dict({"enable": True,
                               "output_dir": str(tmp_path / tag / "tel"),
                               "sinks": ["jsonl", "csv", "prometheus"]},
                              **obs_over),
    }


def _batches(n):
    rng = np.random.RandomState(0)
    out = []
    for _ in range(n):
        tokens = rng.randint(0, VOCAB, size=(BATCH, SEQ)).astype(np.int32)
        out.append({
            "tokens": tokens,
            "position_ids": np.broadcast_to(
                np.arange(SEQ, dtype=np.int32), (BATCH, SEQ)).copy(),
            "labels": tokens,
            "loss_mask": np.ones((BATCH, SEQ), np.float32)})
    return out


LR = {"max_lr": 1e-3, "warmup_steps": 1, "decay_steps": 10}


def _port_engine(cfg, params):
    lr = TLR.build_lr_scheduler(LR)
    eng = EagerEngine(cfg, GPTModule(cfg),
                      optimizer=TOPT.build_optimizer({"name": "AdamW"}, lr),
                      lr_schedule=lr, device="cpu")
    eng.params = params_from_jax(params, eng.module.model_cfg)
    return eng


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory, devices8):
    """The JAX engine's 4 telemetry steps: (initial params, losses, its
    records)."""
    from fleetx_tpu.core.engine import EagerEngine as JEngine
    from fleetx_tpu.core.module import GPTModule as JModule
    from fleetx_tpu.optims.lr_scheduler import build_lr_scheduler
    from fleetx_tpu.optims.optimizer import build_optimizer
    from fleetx_tpu.parallel.mesh import build_mesh

    tmp = tmp_path_factory.mktemp("jax_obs")
    cfg = _cfg(tmp, "jax")
    lr = build_lr_scheduler(LR)
    eng = JEngine(cfg, JModule(cfg),
                  optimizer=build_optimizer({"name": "AdamW"}, lr),
                  lr_schedule=lr, mesh=build_mesh({}, devices=devices8[:1]))
    batches = _batches(4)
    eng.prepare(batches[0])
    params = jax.device_get(meta.unbox(eng.state.params))
    losses = eng.fit(batches)
    eng.obs.close()
    jobs.set_tracer(None)
    records = [json.loads(l) for l in
               open(tmp / "jax" / "tel" / "metrics.jsonl")]
    return params, losses, records


@pytest.fixture(scope="module")
def port_run(tmp_path_factory, jax_run):
    """The port engine's same 4 steps: (engine, losses, telemetry dir)."""
    tmp = tmp_path_factory.mktemp("port_obs")
    eng = _port_engine(_cfg(tmp, "port"), jax_run[0])
    losses = eng.fit(_batches(4))
    eng.obs.close()
    return eng, losses, tmp / "port" / "tel"


def test_engine_losses_match_jax_with_telemetry_on(jax_run, port_run):
    _, jlosses, _ = jax_run
    _, losses, _ = port_run
    assert len(losses) == len(jlosses) == 4
    assert np.max(np.abs(np.array(losses) - np.array(jlosses))) < LOSS_TOL


def test_engine_records_pass_jax_schema(jax_run, port_run):
    _, _, jrecords = jax_run
    eng, losses, tel = port_run
    count, errors = jschema.validate_jsonl(str(tel / "metrics.jsonl"))
    assert errors == [] and count == 4
    records = [json.loads(l) for l in open(tel / "metrics.jsonl")]
    assert [set(r) for r in records] == [set(r) for r in jrecords]
    assert [r["step"] for r in records] == [1, 2, 3, 4]
    for r, loss in zip(records, losses):
        assert r["loss"] == pytest.approx(loss, abs=1e-7)
        assert r["mfu"] is None and r["tokens_per_sec"] > 0
        assert r["engine"] == "EagerEngine"
        assert r["hbm_stats"] == "unavailable"
        assert r["hbm_peak_bytes"] is None
    assert eng.obs.registry.counter("ckpt_saves_total").value >= 1
    assert eng.obs.registry.gauge("ckpt_bytes").value > 0
    assert (tel / "metrics.csv").exists()
    assert "fleetx_loss" in (tel / "metrics.prom").read_text()


def test_engine_trace_spans_and_nesting(port_run):
    _, _, tel = port_run
    tr = json.loads((tel / "trace.json").read_text())
    assert jschema.chrome_trace_errors(tr) == []
    events = tr["traceEvents"]
    names = {e["name"] for e in events}
    for expected in ("data_fetch", "shard_batch", "train_step",
                     "optimizer_update", "checkpoint_save",
                     "checkpoint_write", "ckpt_finalize"):
        assert expected in names, (expected, names)

    def inside(child, parent):
        return any(p["ts"] <= c["ts"] and c["ts"] + c["dur"]
                   <= p["ts"] + p["dur"] + 1.0
                   for c in events if c["name"] == child
                   for p in events if p["name"] == parent)
    assert inside("checkpoint_write", "checkpoint_save")
    assert inside("ckpt_finalize", "checkpoint_save")
    assert inside("optimizer_update", "train_step")
    assert not inside("data_fetch", "train_step")


def test_engine_trace_restore_span(tmp_path, jax_run, port_run):
    eng = _port_engine(_cfg(tmp_path, "resume", max_steps=4),
                       jax_run[0])
    eng.ckpt_dir = str(port_run[0].output_dir)
    eng.prepare()
    eng.obs.close()
    tr = json.loads((tmp_path / "resume" / "tel" / "trace.json").read_text())
    assert "checkpoint_restore" in {e["name"] for e in tr["traceEvents"]}
    assert eng.step == 4


def test_disabled_facade_is_null(tmp_path):
    o = obs.Observability(None, default_output_dir=str(tmp_path))
    assert not o.enabled and o.sinks == [] and o.tracer is None
    import contextlib
    assert isinstance(o.span("x"), contextlib.nullcontext)
    assert isinstance(o.timed_span("x"), contextlib.nullcontext)
    o.emit({"step": 1})
    o.emit_perf({"step_ms": 1.0})
    o.flush()
    o.close()
    assert os.listdir(tmp_path) == []


def test_inference_predict_span_only_while_traced(tmp_path):
    """``inference_predict`` records while a tracer, the flight recorder
    or a profiler window reads it, and is a null context otherwise."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile

    from fleetx_tpu_torch.core.engine.inference_engine import \
        InferenceEngine
    from fleetx_tpu_torch.observability import flight
    from fleetx_tpu_torch.observability.metrics import MetricsRegistry

    assert trace.get_tracer() is None and flight.get_recorder() is None
    assert isinstance(trace.span_if_traced("x"), contextlib.nullcontext)
    eng = object.__new__(InferenceEngine)
    eng._warm, eng.metrics = False, MetricsRegistry()
    eng._predict = lambda inputs: [np.asarray(inputs[0]) + 1]
    tracer = trace.Tracer()
    prev = trace.set_tracer(tracer)
    try:
        assert eng.predict([np.zeros(2)])[0].tolist() == [1.0, 1.0]
    finally:
        trace.set_tracer(prev)
    assert [e["name"] for e in tracer.events] == ["inference_predict"]
    prev = flight.install(flight.FlightRecorder(str(tmp_path)))
    try:
        assert isinstance(trace.span_if_traced("x"), trace.span)
    finally:
        flight.install(prev)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.predict([np.zeros(2)])
    assert "inference_predict" in {e.key for e in prof.key_averages()}
    eng.predict([np.zeros(2)])
    assert tracer.events[-1]["name"] == "inference_predict" and \
        len(tracer.events) == 1
    assert eng.metrics.counter("requests_total").value == 3


def test_engine_profiler_window_on_the_cpu(tmp_path, jax_run):
    """The window opens and closes inside fit on the CPU too; a CPU trace
    has no device events, so the analysis logs and training goes on."""
    cfg = _cfg(tmp_path, "prof", max_steps=4)
    cfg["Profiler"] = {"enable": True, "scheduler": [1, 3],
                       "profiler_log": str(tmp_path / "plog")}
    eng = _port_engine(cfg, jax_run[0])
    losses = eng.fit(_batches(4))
    eng.obs.close()
    assert len(losses) == 4 and not eng.profiler.active
    assert eng.profiler.trace_path.endswith(".pt.trace.json")
    tr = json.load(open(eng.profiler.trace_path))
    names = {e.get("name") for e in tr["traceEvents"]}
    assert {"ProfilerStep#1", "ProfilerStep#2", "fwd_scan",
            "bwd_scan", "train_step"} <= names
    assert "ProfilerStep#3" not in names and "ProfilerStep#0" not in names
    assert eng._perf_report is None  # no device events: logged, not raised


def test_on_profiler_stop_emits_a_perf_record(tmp_path, jax_run):
    from test_torch_perf import autograd_trace

    eng = _port_engine(_cfg(tmp_path, "perf", max_steps=1), jax_run[0])
    eng.prepare()
    d = tmp_path / "plog"
    d.mkdir()
    (d / "h_1.1.pt.trace.json").write_text(json.dumps(autograd_trace()))
    eng._on_profiler_stop(str(d))
    eng._on_profiler_stop(str(tmp_path / "missing"))  # logs, no raise
    eng.obs.flush()
    recs = [json.loads(l) for l in
            open(tmp_path / "perf" / "tel" / "perf.jsonl")]
    assert len(recs) == 1 and recs[0]["n_steps"] == 1
    assert recs[0]["phases"]["bwd_scan"]["layers"] == 1
    assert recs[0]["hbm"]["available"] is False
    assert eng.obs.registry.gauge("perf_step_ms").value == \
        pytest.approx(0.08)
    eng.obs.close()


FREED_AFTER_DEL = """
import gc, weakref
import numpy as np, torch
from fleetx_tpu_torch.core.engine import EagerEngine
from fleetx_tpu_torch.core.module import GPTModule
from fleetx_tpu_torch.optims import lr_scheduler, optimizer
torch.set_num_threads(1)
cfg = {{
    "Model": dict(vocab_size=128, hidden_size=128, num_layers=2,
                  num_attention_heads=4, max_position_embeddings=32,
                  hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                  use_flash_attention=True, fused_residual_norm=True,
                  use_recompute=True, recompute_granularity="full",
                  dtype="float32", param_dtype="float32"),
    "Engine": {{"max_steps": 2, "logging_freq": 1, "eval_freq": 0,
                "prefetch_to_device": 2,
                "save_load": {{"save_steps": 2, "output_dir": "ckpt"}}}},
    "Global": {{"seed": 7}},
    "Observability": {{"enable": True, "output_dir": "tel",
                       "sinks": ["jsonl"]}},
    "Profiler": {{"enable": True, "scheduler": [1, 2],
                  "profiler_log": "plog"}}}}
lr = lr_scheduler.build_lr_scheduler({lr!r})
eng = EagerEngine(cfg, GPTModule(cfg),
                  optimizer=optimizer.build_optimizer({{"name": "AdamW"}}, lr),
                  lr_schedule=lr, device="cpu")
rng = np.random.RandomState(0)
tokens = [rng.randint(0, 128, size=(8, 32)) for _ in range(2)]
gc.disable()
eng.fit([{{"tokens": t, "labels": t,
          "position_ids": np.broadcast_to(np.arange(32), (8, 32)).copy(),
          "loss_mask": np.ones((8, 32), np.float32)}} for t in tokens])
eng.obs.close()
ref = weakref.ref(eng)
del eng
print("FREED" if ref() is None else "ALIVE")
"""

def test_finished_engine_is_freed_without_the_cyclic_collector(tmp_path):
    """A fresh process (torch's lazy imports not yet done) trains the tiny
    GPT through the custom ops, recompute, the prefetcher, telemetry and
    the profiler window with the cyclic collector off: the engine dies
    with its last name, so its parameters and optimizer state leave the
    card at once."""
    code = FREED_AFTER_DEL.format(lr=LR)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=str(tmp_path), env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "FREED"


# -------------------------------------------------------------- prefetch

def test_prefetcher_depths_give_the_same_batches_and_losses(tmp_path,
                                                            jax_run):
    runs = []
    for depth in (0, 1, 2):
        eng = _port_engine(_cfg(tmp_path, f"pf{depth}", prefetch=depth),
                           jax_run[0])
        seen = []
        train_step = eng.train_step

        def record(batch, _step=train_step, _seen=seen):
            _seen.append({k: v.clone() for k, v in batch.items()})
            return _step(batch)
        eng.train_step = record
        losses = eng.fit(_batches(4))
        eng.obs.close()
        runs.append((losses, seen, [p.detach().clone()
                                    for p in eng._leaves]))
    for losses, seen, leaves in runs[1:]:
        assert losses == runs[0][0]
        assert all(torch.equal(a[k], b[k]) for a, b in zip(seen, runs[0][1])
                   for k in a)
        assert all(torch.equal(a, b) for a, b in zip(leaves, runs[0][2]))
    # with the prefetcher the copy is the producer's shard_batch_async
    tel = json.loads((tmp_path / "pf2" / "tel" / "trace.json").read_text())
    names = {e["name"] for e in tel["traceEvents"]}
    assert "shard_batch_async" in names and "shard_batch" not in names


def test_prefetcher_contract():
    items = list(range(7))
    pf = DevicePrefetcher(iter(items), lambda x: x * 10, depth=2,
                          device="cpu")
    assert list(pf) == [x * 10 for x in items]
    assert pf.close()

    def bad():
        yield 1
        raise RuntimeError("producer boom")
    pf = DevicePrefetcher(bad(), lambda x: x, depth=1)
    assert next(pf) == 1
    with pytest.raises(RuntimeError, match="producer boom"):
        next(pf)
    with pytest.raises(StopIteration):
        next(pf)
    assert pf.close()

    # closed mid-stream with the producer blocked on a full queue
    pf = DevicePrefetcher(iter(range(1000)), lambda x: x, depth=1)
    assert next(pf) == 0
    assert pf.close() is True
    assert pf.close() is True  # idempotent


# ------------------------------------------------------------------ tools

def _run(argv, cwd, env_extra=None, timeout=240):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu", **(env_extra or {}))
    return subprocess.run([sys.executable] + argv, capture_output=True,
                          text=True, cwd=str(cwd), env=env, timeout=timeout)


def _serving_stream(path):
    """Three replica snapshots of the port's engine (the tiny serving
    config of ``tests/test_torch_port_boundary.py``), as ``tools.serve
    --metrics-out`` writes them."""
    from fleetx_tpu_torch.tools.serve import build_engine

    cfg = {"Model": dict(vocab_size=97, hidden_size=64, num_layers=2,
                         num_attention_heads=4, max_position_embeddings=64,
                         hidden_dropout_prob=0.0,
                         attention_probs_dropout_prob=0.0, dtype="float32",
                         param_dtype="float32"),
           "Serving": dict(max_batch=4, page_size=4, num_pages=33,
                           max_seq_len=32, prefill_chunk=8),
           "Generation": {"decode_strategy": "greedy_search",
                          "eos_token_id": 96, "pad_token_id": 0},
           "Global": {"seed": 7}}
    engine = build_engine(cfg, device="cpu")
    with open(path, "w") as f:
        for i in range(3):
            engine.submit([5, 9, 23, 41][: i + 2], 4, request_id=f"r{i}")
            engine.run_until_drained()
            f.write(json.dumps(engine.serving_snapshot()) + "\n")


def test_cli_telemetry_run_and_the_report_tools(tmp_path):
    # the debug recipe through the port's CLI, steps cut to 4
    out = _run(["-m", "fleetx_tpu_torch.tools.train", "-c", DEBUG_YAML,
                "--device", "cpu", "-o", "Engine.max_steps=4"], tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    tel = tmp_path / "output" / "debug_obs" / "telemetry"
    assert {"metrics.jsonl", "metrics.csv", "metrics.prom",
            "trace.json"} <= set(os.listdir(tel))
    assert jschema.validate_jsonl(str(tel / "metrics.jsonl")) == (2, [])
    names = {e["name"] for e in json.loads(
        (tel / "trace.json").read_text())["traceEvents"]}
    assert {"data_fetch", "train_step", "shard_batch_async",
            "checkpoint_save", "checkpoint_write"} <= names

    def both(port_mod, jax_tool, args):
        port = _run(["-m", f"fleetx_tpu_torch.tools.{port_mod}"] + args,
                    tmp_path)
        ref = _run([os.path.join(REPO, "tools", jax_tool)] + args, tmp_path)
        assert port.returncode == ref.returncode == 0, \
            (port.stderr[-2000:], ref.stderr[-2000:])
        assert port.stdout == ref.stdout
        return port

    both("metrics_report", "metrics_report.py", [str(tel / "metrics.jsonl")])
    both("metrics_report", "metrics_report.py", [str(tel), "--json", "-"])
    stream = tmp_path / "serving.jsonl"
    _serving_stream(stream)
    both("metrics_report", "metrics_report.py", [str(stream)])
    both("slo_report", "slo_report.py", [str(stream), "-c", SERVING_YAML])
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"step": "oops"}\n')
    assert _run(["-m", "fleetx_tpu_torch.tools.metrics_report", str(bad)],
                tmp_path).returncode == 1

    # a run that dies in its data path leaves a flight dump
    crash = tmp_path / "crash"
    crash.mkdir()
    out = _run(["-m", "fleetx_tpu_torch.tools.train", "-c", DEBUG_YAML,
                "--device", "cpu", "-o", "Engine.max_steps=4", "-o",
                "Resilience.enable=True", "-o",
                "Resilience.faults.data_raise_at=2"], crash)
    assert out.returncode != 0 and "data_raise_at" in out.stderr
    flight_dir = crash / "output" / "debug_obs" / "telemetry" / "flight"
    dump = json.loads((flight_dir / "flight_rank0.json").read_text())
    assert dump["reason"].startswith("crash:")
    kinds = [e["kind"] for e in dump["events"]]
    assert "span" in kinds and kinds[-1] == "crash"
    report = both("postmortem", "postmortem.py", [str(flight_dir)])
    assert "reason='crash:" in report.stdout
    # a second rank whose stream stops earlier is named first-diverging
    peer = dict(dump, rank=1, world=2, events=dump["events"][:-3])
    (flight_dir / "flight_rank1.json").write_text(json.dumps(peer))
    report = both("postmortem", "postmortem.py",
                  [str(flight_dir), "--json", "-"])
    assert "first-diverging rank: 1" in report.stdout
