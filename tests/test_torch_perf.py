"""Port parity: the trace decomposition (``fleetx_tpu_torch/observability/
perf.py``), the roofline (``utils/hardware.py``) and the trace CLI
(``fleetx_tpu_torch/tools/trace_report.py``).

The JAX module reads XLA traces, the port Kineto traces. The bridge is a
Kineto rendering of the JAX package's committed 2-step fixture
(``tests/fixtures/trace_gpt_2step.json.gz``, GPT-345M): every XLA op
becomes a device event on one GPU stream (a ``gpu_memcpy`` for JAX's
copies, a kernel named for its JAX category otherwise, flash kernels
keeping one name an op), every ``Steps`` event a ``ProfilerStep#<n>``
``gpu_user_annotation`` and every scan ``while`` a ``fwd_scan`` /
``bwd_scan`` one, labelled by JAX's rule. The port's ``decompose`` of the
rendering must give JAX's ``decompose`` of the fixture: step ms, host
gap, per-phase ms, layers (24 / 24), flash passes a layer, and every
category that maps one-to-one (matmul, flash, copy; the port's
elementwise is JAX's elementwise + dus + rng), within 1e-6. ``mfu_gap``
is pure arithmetic and gives JAX's numbers exactly on the same dict.

A hand-built trace holds the part the rendering cannot: device spans
derived from host annotations when the backward's kernels come from
another thread (autograd's) and one kernel carries no correlation.
"""

import gzip
import json
import os
import subprocess
import sys

import pytest
import torch

from fleetx_tpu.observability import perf as jperf
from fleetx_tpu.utils.hardware import gpt_flops_per_token as j_fpt
from fleetx_tpu.utils.hardware import roofline as j_roofline
from fleetx_tpu_torch.observability import perf
from fleetx_tpu_torch.utils import hardware

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "trace_gpt_2step.json.gz")
FLOPS_PER_STEP = j_fpt(24, 1024, 1024, vocab_size=50304) * 8 * 1024
TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """Tiny tensors: torch on one intra-op thread, restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def kineto_rendering(jtrace: dict) -> dict:
    """The JAX fixture as a Kineto trace of one GPU stream (see the module
    docstring)."""
    events = jtrace["traceEvents"]
    x = [e for e in events if e.get("ph") == "X" and e.get("pid") == 3]
    steps = sorted((e for e in x if e.get("tid") == 1),
                   key=lambda e: e["ts"])
    ops = [e for e in x if e.get("tid") == 3]
    whiles = [e for e in ops
              if (e.get("args") or {}).get("hlo_category") == "while"]
    out = [{"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
            "args": {"name": "python3"}},
           {"ph": "M", "name": "thread_name", "pid": 0, "tid": 7,
            "args": {"name": "stream 7 "}}]

    def device(cat, name, ts, dur, args=None):
        evt = {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7,
               "ts": ts, "dur": dur}
        if args:
            evt["args"] = args
        out.append(evt)

    for i, s in enumerate(steps):
        device("gpu_user_annotation", f"ProfilerStep#{i}", s["ts"], s["dur"])
        inside = sorted((w for w in whiles
                         if s["ts"] <= w["ts"] < s["ts"] + s["dur"]),
                        key=lambda w: w["ts"])
        rest = inside[1:]
        bwd = max(rest, key=lambda w: w["dur"]) if rest else None
        for w in inside:
            label = ("fwd_scan" if w is inside[0] else "bwd_scan"
                     if w is bwd else "extra_scan")
            device("gpu_user_annotation", label, w["ts"], w["dur"])
    for i, o in enumerate(ops):
        args = o.get("args") or {}
        if args.get("hlo_category") == "while":
            continue
        jcat = jperf.classify_event(o["name"], args.get("hlo_category", ""),
                                    args.get("long_name", ""))
        if jcat == "copy":
            device("gpu_memcpy", f"Memcpy {i}", o["ts"], o["dur"])
        elif jcat == "flash":
            device("kernel", f"flash.{o['name']}", o["ts"], o["dur"])
        elif jcat == "matmul":
            device("kernel", f"gemm.{i}", o["ts"], o["dur"])
        elif jcat == "fused_norm" or jcat.startswith("collective"):
            device("kernel", o["name"], o["ts"], o["dur"])
        else:  # elementwise, dus, rng: the port's elementwise
            device("kernel", f"pointwise.{i}", o["ts"], o["dur"])
    return {"traceEvents": out}


@pytest.fixture(scope="module")
def fixture_pair():
    """(the JAX decomposition of the fixture, the port's of its Kineto
    rendering)."""
    with gzip.open(FIXTURE, "rt") as f:
        jtrace = json.load(f)
    return jperf.decompose(jtrace), perf.decompose(kineto_rendering(jtrace))


# -------------------------------------------------------------- classifier

@pytest.mark.parametrize("name,cat,want", [
    ("void (anonymous namespace)::flash_fwd_kernel_tc<__nv_bfloat16, 64>"
     "(CUtensorMap_st, CUtensorMap_st)", "kernel", "flash"),
    ("void (anonymous namespace)::flash_bwd_kernel_tc<__nv_bfloat16, 64>"
     "(CUtensorMap_st)", "kernel", "flash"),
    ("void (anonymous namespace)::fused_norm_fwd_rows_kernel<__nv_bfloat16,"
     " __nv_bfloat16, true, true>(__nv_bfloat16 const*)", "kernel",
     "fused_norm"),
    ("void (anonymous namespace)::fused_norm_bwd_kernel<__nv_bfloat16, 8, "
     "false>(float const*)", "kernel", "fused_norm"),
    ("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT", "kernel", "matmul"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64",
     "kernel", "matmul"),
    ("void cutlass::Kernel2<cutlass_80_wmma_tensorop_bf16_s161616gemm>",
     "kernel", "matmul"),
    ("void splitKreduce_kernel<32, 16, int, float>(cublasSplitKParams)",
     "kernel", "matmul"),
    ("void at::native::unrolled_elementwise_kernel<at::native::"
     "direct_copy_kernel_cuda(at::TensorIteratorBase&)>", "kernel", "copy"),
    ("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", "copy"),
    ("Memset (Device)", "gpu_memset", "copy"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevComm*)", "kernel",
     "collective"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "CUDAFunctor_add<float>>", "kernel", "elementwise"),
    ("void at::native::reduce_kernel<512, 1>", "kernel", "elementwise"),
])
def test_classifier_names_the_cards_kernels(name, cat, want):
    assert perf.classify_event(name, cat) == want


# ---------------------------------------------------- fixture decomposition

def test_decompose_reproduces_jax_on_the_kineto_rendering(fixture_pair):
    jrep, rep = fixture_pair
    assert rep["n_steps"] == jrep["n_steps"] == 2
    assert rep["n_devices"] == jrep["n_devices"] == 1
    assert abs(rep["step_ms"] - jrep["step_ms"]) < TOL
    assert abs(rep["host_gap_ms_per_step"]
               - jrep["host_gap_ms_per_step"]) < TOL
    assert set(rep["phases"]) == set(jrep["phases"]) == \
        {"fwd_scan", "bwd_scan", "outside"}
    for label, jph in jrep["phases"].items():
        ph = rep["phases"][label]
        assert abs(ph["ms_per_step"] - jph["ms_per_step"]) < TOL, label
        for key in ("layers", "ms_per_layer", "flash_passes_per_layer"):
            if key in jph:
                assert abs(ph[key] - jph[key]) < TOL, (label, key)
    assert rep["phases"]["fwd_scan"]["layers"] == 24
    assert rep["phases"]["bwd_scan"]["layers"] == 24
    assert rep["phases"]["fwd_scan"]["flash_passes_per_layer"] == 1.0
    assert rep["phases"]["bwd_scan"]["flash_passes_per_layer"] == 3.0
    jcats, cats = jrep["categories_ms_per_step"], rep["categories_ms_per_step"]
    for cat in ("matmul", "flash", "copy", "fused_norm", "collective"):
        assert abs(cats.get(cat, 0.0) - jcats.get(cat, 0.0)) < TOL, cat
    assert abs(cats["elementwise"] - sum(
        jcats.get(c, 0.0) for c in ("elementwise", "dus", "rng"))) < 1e-3
    # per phase too: the one-to-one categories
    for label in ("fwd_scan", "bwd_scan"):
        jc = jrep["phases"][label]["categories_ms_per_step"]
        c = rep["phases"][label]["categories_ms_per_step"]
        for cat in ("matmul", "flash", "copy"):
            assert abs(c.get(cat, 0.0) - jc.get(cat, 0.0)) < TOL


def test_categories_and_host_gap_add_up_to_the_step(fixture_pair):
    _, rep = fixture_pair
    total = sum(rep["categories_ms_per_step"].values()) \
        + rep["host_gap_ms_per_step"]
    assert abs(total - rep["step_ms"]) < 0.01 * rep["step_ms"]


def test_top_kernels_list_names_ms_and_launches(fixture_pair):
    _, rep = fixture_pair
    top = rep["top_kernels"]
    assert len(top) == 10
    assert [k["ms_per_step"] for k in top] == \
        sorted((k["ms_per_step"] for k in top), reverse=True)
    assert all(set(k) == {"name", "category", "ms_per_step",
                          "launches_per_step"} for k in top)
    # the listed launches are counts a step of that exact name
    flash = [k for k in top if k["category"] == "flash"]
    assert flash and all(k["launches_per_step"] == 24.0 for k in flash)
    assert perf.decompose(kineto_rendering(json.load(
        gzip.open(FIXTURE, "rt"))), top_kernels=3)["top_kernels"] == top[:3]


# ----------------------------------------------------------- roofline score

def test_mfu_gap_is_jax_arithmetic_on_the_same_dict(fixture_pair):
    # the rendering's flash kernels carry the XLA op names, which do not
    # say their direction, so the JAX passes rule scores the recompute
    _, rep = fixture_pair
    assert "flash_recompute_ms_per_step" not in rep["phases"]["bwd_scan"]
    rl = j_roofline("TPU v5 lite")
    for decomp in (rep, dict(rep, n_devices=8)):
        for kwargs in (dict(flops_per_step=FLOPS_PER_STEP, roofline=rl),
                       dict(flops_per_step=None, roofline=None),
                       dict(flops_per_step=FLOPS_PER_STEP, roofline=rl,
                            top_k=3)):
            want = jperf.mfu_gap(decomp, **kwargs)
            got = perf.mfu_gap(decomp, **kwargs)
            for key in ("flops_per_step", "peak_flops", "matmul_flops",
                        "hbm_bytes_per_s", "measured_step_ms",
                        "ideal_step_ms", "gap_ms", "mfu", "accounted_ms"):
                assert got[key] == want[key], key
            strip = [{k: v for k, v in c.items() if k != "detail"}
                     for c in want["contributors"]]
            assert [{k: v for k, v in c.items() if k != "detail"}
                    for c in got["contributors"]] == strip


def recompute_trace(bwd_kernels: list, layers: int = 2) -> dict:
    """One step, ``layers`` layers: the forward launches
    ``flash_fwd_kernel_tc`` (10 µs) and a matmul (5 µs) a layer, the
    backward ``bwd_kernels`` ((name, µs) pairs) a layer, back to back on
    one stream under device annotations."""
    events = []
    t = 0.0

    def kernel(name, dur):
        nonlocal t
        events.append(_kernel(name, t, dur))
        t += dur

    for _ in range(layers):
        kernel("flash_fwd_kernel_tc", 10.0)
        kernel("nvjet_gemm", 5.0)
    fwd_end = t
    for _ in range(layers):
        for name, dur in bwd_kernels:
            kernel(name, dur)
    for name, t0, t1 in (("ProfilerStep#0", 0.0, t), ("fwd_scan", 0.0,
                                                        fwd_end),
                         ("bwd_scan", fwd_end, t)):
        events.append({"ph": "X", "cat": "gpu_user_annotation",
                       "name": name, "pid": 0, "tid": 7, "ts": t0,
                       "dur": t1 - t0})
    return {"traceEvents": events}


@pytest.mark.parametrize("bwd_kernels,passes,recompute_ms", [
    # full recompute over the fused backward (row 4): 2 passes a layer,
    # which the JAX rule (beyond 2) reads as no recompute
    ([("flash_fwd_kernel_tc", 10.0), ("flash_bwd_kernel_tc", 25.0)],
     2.0, 0.020),
    # full recompute over the split backward (rows 2 and 3)
    ([("flash_fwd_kernel_tc", 10.0), ("flash_bwd_dq_kernel_tc", 15.0),
      ("flash_bwd_dkv_kernel_tc", 20.0)], 3.0, 0.020),
    # no recompute: the fused backward alone
    ([("flash_bwd_kernel_tc", 25.0)], 1.0, 0.0),
], ids=["fused-full", "split-full", "fused-none"])
def test_flash_recompute_is_the_forward_kernels_inside_the_backward(
        bwd_kernels, passes, recompute_ms):
    rep = perf.decompose(recompute_trace(bwd_kernels))
    bwd = rep["phases"]["bwd_scan"]
    assert bwd["layers"] == 2
    assert bwd["flash_passes_per_layer"] == passes
    assert bwd["flash_recompute_ms_per_step"] == pytest.approx(recompute_ms)
    rl = {"peak_flops": 1e12, "matmul_flops": 1e12,
          "hbm_bytes_per_s": 1e12}
    gap = perf.mfu_gap(rep, flops_per_step=1e6, roofline=rl, top_k=10)
    named = {c["name"]: c["ms_per_step"] for c in gap["contributors"]}
    assert named.get("flash_recompute", 0.0) == pytest.approx(recompute_ms)
    # the replay is taken out of the matmul+flash time above the floor
    cats = rep["categories_ms_per_step"]
    assert named["matmul_inefficiency"] == pytest.approx(
        cats["matmul"] + cats["flash"] - recompute_ms
        - gap["ideal_step_ms"], abs=1e-4)


def test_summary_matches_jax_on_the_same_report(fixture_pair):
    jrep, rep = fixture_pair
    for r in (jrep, rep):
        r = dict(r, mfu_gap=jperf.mfu_gap(r, FLOPS_PER_STEP,
                                          j_roofline("TPU v5 lite")))
        assert perf.summary(r) == jperf.summary(r)


def test_roofline_is_the_data_sheet_and_the_cards_calibration():
    # the MFU denominator is the data sheet's peak; the matmul and HBM
    # rates the card's measured ones where recorded
    rl = hardware.roofline("NVIDIA H100 80GB HBM3")
    cal = hardware.CALIBRATED_ROOFLINE["h100 80gb hbm3"]
    assert cal["card"].startswith("NVIDIA H100 80GB HBM3, ")
    assert rl == dict({"peak_flops": 989e12}, **cal["rates"])
    assert 0 < rl["matmul_flops"] <= 989e12
    assert hardware.roofline("NVIDIA H100 PCIe") == {
        "peak_flops": 756e12, "matmul_flops": 756e12,
        "hbm_bytes_per_s": 2.0e12}
    assert hardware.roofline("cpu") is None
    assert hardware.roofline("") is None
    # no TPU figure crossed over
    assert hardware.roofline("TPU v5 lite") is None


# ------------------------------------------------- host-annotation spans

def _launch(tid, ts, corr):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "pid": 100, "tid": tid, "ts": ts, "dur": 1.0,
            "args": {"correlation": corr}}


def _kernel(name, ts, dur, corr=None, tid=7, cat="kernel"):
    evt = {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": tid,
           "ts": ts, "dur": dur, "args": {}}
    if corr is not None:
        evt["args"]["correlation"] = corr
    return evt


def _host(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "pid": 100,
            "tid": tid, "ts": ts, "dur": dur}


def autograd_trace() -> dict:
    """One step of an eager training step as Kineto writes it: the
    forward launched by the main thread (tid 1; two matmuls of one name),
    the backward by autograd's
    thread (tid 2) while the main thread sits in ``bwd_scan``, Kineto's
    device annotation for ``bwd_scan`` only the 1 µs seed kernel and none
    for the step; one backward kernel without a correlation (a launch the
    trace did not link); the prefetcher's copy (tid 3) on a side stream."""
    return {"traceEvents": [
        _host("ProfilerStep#0", 0.0, 100.0),
        _host("fwd_scan", 5.0, 25.0),
        _host("bwd_scan", 30.0, 50.0),
        _host("optimizer_update", 82.0, 10.0),
        _host("shard_batch_async", 44.0, 3.0, tid=3),
        _launch(1, 10.0, 1), _launch(1, 20.0, 2), _launch(1, 31.0, 3),
        _launch(2, 40.0, 4), _launch(2, 50.0, 5), _launch(2, 60.0, 6),
        _launch(3, 45.0, 9), _launch(1, 85.0, 7), _launch(1, 25.0, 10),
        _kernel("flash_fwd_kernel_tc", 100.0, 10.0, 1),
        _kernel("nvjet_gemm", 110.0, 10.0, 2),
        _kernel("nvjet_gemm", 120.0, 3.0, 10),
        _kernel("fill_seed", 125.0, 1.0, 3),
        _kernel("nvjet_gemm_bwd", 128.0, 7.0, 4),
        _kernel("flash_bwd_kernel_tc", 135.0, 10.0, 5),
        _kernel("fused_norm_bwd_kernel", 146.0, 3.0),  # no correlation
        _kernel("vectorized_elementwise_kernel", 150.0, 10.0, 6),
        _kernel("adam_elementwise", 170.0, 10.0, 7),
        _kernel("Memcpy HtoD", 126.0, 4.0, 9, tid=13, cat="gpu_memcpy"),
        {"ph": "X", "cat": "gpu_user_annotation", "name": "bwd_scan",
         "pid": 0, "tid": 7, "ts": 125.0, "dur": 1.0},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "fwd_scan",
         "pid": 0, "tid": 7, "ts": 100.0, "dur": 20.0},
    ], "deviceProperties": [{"id": 0, "name": "NVIDIA H100 80GB HBM3"}]}


def test_spans_from_host_annotations_cover_the_autograd_thread():
    rep = perf.decompose(autograd_trace())
    assert rep["device"] == "NVIDIA H100 80GB HBM3 (0)"
    assert rep["n_steps"] == 1
    # the step: first main-stream kernel launched in it to the last's end
    assert rep["step_ms"] == pytest.approx(0.080)
    fwd, bwd = rep["phases"]["fwd_scan"], rep["phases"]["bwd_scan"]
    assert fwd["ms_per_step"] == pytest.approx(0.023)
    # the backward from the seed kernel to the last autograd kernel, the
    # side stream's copy not stretching it
    assert bwd["ms_per_step"] == pytest.approx(0.035)
    # the uncorrelated kernel lands by its device timestamp
    assert bwd["categories_ms_per_step"]["fused_norm"] == \
        pytest.approx(0.003)
    assert rep["phases"]["outside"]["categories_ms_per_step"] == \
        {"elementwise": pytest.approx(0.010)}
    # a layer launches its matmul kernel twice, its flash kernel once
    assert fwd["layers"] == bwd["layers"] == 1
    cats = rep["categories_ms_per_step"]
    assert cats["copy"] == pytest.approx(0.004)
    # card idle inside the step: 80 µs − the union of the device events
    assert rep["host_gap_ms_per_step"] == pytest.approx(0.080 - 0.066)
    assert rep["categories_launches_per_step"]["flash"] == 2.0


def test_no_step_markers_is_one_step_of_the_whole_timeline():
    trace = {"traceEvents": [_kernel("nvjet", 0.0, 10.0),
                             _kernel("add", 20.0, 10.0)]}
    rep = perf.decompose(trace)
    assert rep["n_steps"] == 1 and rep["step_ms"] == pytest.approx(0.030)
    assert rep["host_gap_ms_per_step"] == pytest.approx(0.010)
    with pytest.raises(ValueError, match="no device"):
        perf.decompose({"traceEvents": [_host("ProfilerStep#0", 0, 1)]})


# ----------------------------------------------------------------- loading

def test_load_trace_shapes(tmp_path):
    trace = autograd_trace()
    assert perf.load_trace(trace) is trace
    gz = tmp_path / "a.trace.json.gz"
    gz.write_bytes(gzip.compress(json.dumps(trace).encode()))
    assert perf.load_trace(str(gz)) == trace
    d = tmp_path / "profiler_log"
    d.mkdir()
    (d / "host_1.1.pt.trace.json").write_text(json.dumps(trace))
    assert perf.load_trace(str(d)) == trace
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError):
        perf.load_trace(str(empty))


# -------------------------------------------------------------------- CLI

def _report(argv: list) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "fleetx_tpu_torch.tools.trace_report"] + argv,
        capture_output=True, text=True, cwd=REPO, env=env, timeout=120)


def test_trace_report_cli_on_a_kineto_trace(tmp_path):
    with gzip.open(FIXTURE, "rt") as f:
        trace = kineto_rendering(json.load(f))
    path = tmp_path / "host_1.1.pt.trace.json"
    path.write_text(json.dumps(trace))
    out = tmp_path / "report.json"
    proc = _report([str(tmp_path), "--json", str(out), "--device-name",
                    ""])
    assert proc.returncode == 0, proc.stderr
    rep = json.loads(out.read_text())
    want = perf.analyze(trace, flops_per_step=FLOPS_PER_STEP)
    assert rep == json.loads(json.dumps(want))
    assert "bwd_scan" in proc.stdout and "top kernels" in proc.stdout
    # the JAX tool prints the same phase table for its own fixture
    jproc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "trace_report.py"),
         FIXTURE, "--device-kind", ""], capture_output=True, text=True,
        cwd=REPO, timeout=120)
    assert jproc.returncode == 0, jproc.stderr
    table = lambda s: s[s.index("phase decomposition"):
                        s.index("category ms/step")]  # noqa: E731
    assert table(proc.stdout) == table(jproc.stdout)
    # the card's roofline by default
    proc = _report([str(path), "--json", "-"])
    assert proc.returncode == 0, proc.stderr
    rep = json.loads(proc.stdout[proc.stdout.index("\n{") + 1:])
    assert rep["mfu_gap"]["peak_flops"] == 989e12
    bad = tmp_path / "bad.json"
    bad.write_text("{}")
    proc = _report([str(bad)])
    assert proc.returncode == 2 and "cannot analyze" in proc.stderr
