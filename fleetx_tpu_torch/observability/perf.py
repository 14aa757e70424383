"""Trace decomposition and roofline MFU-gap attribution for Kineto traces
(port of ``fleetx_tpu/observability/perf.py``).

Given the Chrome-trace JSON a ``torch.profiler`` window exports
(``observability/trace.ProfilerWindow``), this module

- classifies every device event (``kernel``, ``gpu_memcpy``,
  ``gpu_memset``) into a small taxonomy by its name: the port's flash
  kernels, its fused-norm kernels, matmuls (cuBLAS / CUTLASS), copies,
  collectives (NCCL), and elementwise for the rest;
- finds each step and each region on the card. A step is a
  ``ProfilerStep#<n>`` annotation, a region a ``fwd_scan`` / ``bwd_scan``
  one (the engine's ``record_function`` ranges around the forward and the
  backward; the labels are the JAX scan regions'). The device span of an
  annotation is the hull of the ``gpu_user_annotation`` Kineto wrote for
  it and of the device events launched (``cuda_runtime`` /
  ``cuda_driver``, any thread: autograd runs the backward on its own
  thread, which Kineto's device annotation misses) while its host range
  was open, on the main stream. Device events are then assigned to steps
  and regions by their device timestamps, as the JAX module assigns XLA
  ops, so a kernel whose launch the trace does not correlate is still
  counted;
- infers each region's trip count (= layers) from repeated kernels: the
  most frequent flash kernel's count a region instance (an eager step
  launches several elementwise kernels and matmuls of one name a layer,
  the flash kernels once), else the most frequent kernel's, as JAX does;
- scores the result against a roofline (``utils/hardware.roofline``) into
  the MFU-gap report naming the top-k contributors, and lists the top
  kernels by device ms a step with their launches a step.

Stdlib and the trace JSON only: the offline CLI
(``tools/trace_report.py``) runs on a saved trace anywhere, and the
engine hook adds no device work.
"""

from __future__ import annotations

import bisect
import gzip
import json
import os
from typing import Any, Optional

__all__ = [
    "load_trace", "classify_event", "decompose", "mfu_gap", "analyze",
    "summary", "CATEGORIES",
]

#: event-category taxonomy: the classifier's output values, in the order
#: reports render them.
CATEGORIES = ("matmul", "flash", "fused_norm", "copy", "collective",
              "elementwise", "host_gap")

#: the port's flash kernels (``csrc/flash_attention.cu``:
#: ``flash_fwd_kernel_tc``, ``flash_bwd_kernel_tc``, ...)
_FLASH_MARKER = "flash"
#: the port's fused residual+LayerNorm kernels (``csrc/fused_norm.cu``),
#: matched before anything else so they never fold into elementwise
_FUSED_NORM_MARKER = "fused_norm"
_COLLECTIVE_MARKERS = ("nccl", "all-reduce", "all-gather", "reduce-scatter",
                       "all-to-all", "collective-permute",
                       "collective-broadcast", "allreduce", "allgather",
                       "reducescatter", "alltoall", "sendrecv")
# cuBLAS (nvjet, sm90_xmma, gemv, its split-k reduction) and CUTLASS
_MATMUL_MARKERS = ("gemm", "gemv", "nvjet", "xmma", "cutlass",
                   "splitkreduce")
#: Kineto's device-event categories
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_COPY_CATS = ("gpu_memcpy", "gpu_memset")
#: host events that launch device work, linked by ``args.correlation``
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
#: the step annotation's prefix and the region labels
STEP_PREFIX = "ProfilerStep#"
REGIONS = ("fwd_scan", "bwd_scan")


# ---------------------------------------------------------------------------
# loading
# ---------------------------------------------------------------------------

def _read_json(data: bytes) -> dict:
    if data[:2] == b"\x1f\x8b":  # gzip magic
        data = gzip.decompress(data)
    return json.loads(data.decode("utf-8", errors="replace"))


def _is_trace_file(name: str) -> bool:
    return name.endswith(".trace.json.gz") or name.endswith(".trace.json")


def load_trace(source: Any) -> dict:
    """Resolve ``source`` to the Chrome-trace JSON dict.

    Accepts: an already-parsed dict; a ``.json`` / ``.json.gz`` file; or a
    profiler output DIRECTORY (the newest ``*.trace.json[.gz]`` inside it wins, the
    ``*.pt.trace.json`` a ``ProfilerWindow`` exports included).
    """
    if isinstance(source, dict):
        return source
    path = str(source)
    if os.path.isdir(path):
        hits = []
        for root, _dirs, files in os.walk(path):
            hits.extend(os.path.join(root, f) for f in files
                        if _is_trace_file(f))
        if not hits:
            raise FileNotFoundError(
                f"no *.trace.json[.gz] under {path} — was the profiler "
                f"window ever closed?")
        path = max(hits, key=os.path.getmtime)
    with open(path, "rb") as f:
        return _read_json(f.read())


# ---------------------------------------------------------------------------
# classification
# ---------------------------------------------------------------------------

def classify_event(name: str, cat: str = "kernel") -> str:
    """Category of one device event, by its name first and its Kineto
    ``cat`` second.

    Kernels whose names carry none of the markers are ``elementwise``
    (PyTorch's pointwise, reduction and indexing kernels); a kernel named
    for a copy, and every memcpy and memset, is ``copy``.
    """
    n = (name or "").lower()
    if any(m in n for m in _COLLECTIVE_MARKERS):
        return "collective"
    if _FUSED_NORM_MARKER in n:
        return "fused_norm"
    if _FLASH_MARKER in n:
        return "flash"
    if any(m in n for m in _MATMUL_MARKERS):
        return "matmul"
    if cat in _COPY_CATS or "copy" in n:
        return "copy"
    return "elementwise"


# ---------------------------------------------------------------------------
# timeline extraction
# ---------------------------------------------------------------------------

def _merge(intervals: list) -> list:
    """Overlapping or touching ``(start, end)`` intervals merged."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _device_spans(events: list, pid: Any, stream: Any, wanted) -> dict:
    """name → merged device ``(start, end)`` spans of the annotations
    ``wanted(name)`` admits: the hull of Kineto's ``gpu_user_annotation``
    and of the main-stream device events launched inside the host range
    of the same-named ``user_annotation``."""
    spans: dict = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "gpu_user_annotation" \
                and e.get("pid") == pid and wanted(e.get("name", "")):
            spans.setdefault(e["name"], []).append(
                (e["ts"], e["ts"] + e.get("dur", 0.0)))
    hosts = [e for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"
             and wanted(e.get("name", ""))]
    if hosts:
        device_by_corr = {}
        for e in events:
            if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS and \
                    e.get("pid") == pid and e.get("tid") == stream:
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    device_by_corr[corr] = (e["ts"],
                                            e["ts"] + e.get("dur", 0.0))
        launches = sorted(
            (e["ts"], (e.get("args") or {}).get("correlation"))
            for e in events if e.get("ph") == "X"
            and e.get("cat") in _LAUNCH_CATS
            and (e.get("args") or {}).get("correlation") in device_by_corr)
        starts = [t for t, _ in launches]
        for h in hosts:
            lo = bisect.bisect_left(starts, h["ts"])
            hi = bisect.bisect_left(starts, h["ts"] + h.get("dur", 0.0))
            hit = [device_by_corr[c] for _, c in launches[lo:hi]]
            if hit:
                spans.setdefault(h["name"], []).append(
                    (min(s for s, _ in hit), max(e for _, e in hit)))
    return {name: _merge(iv) for name, iv in spans.items()}


def _device_timeline(trace: dict) -> dict:
    """Steps / regions / device events / name of the FIRST device in a
    Kineto trace (the lowest device id with kernel, memcpy or memset
    events)."""
    events = trace.get("traceEvents") or []
    device = [e for e in events if e.get("ph") == "X"
              and e.get("cat") in _DEVICE_CATS]
    if not device:
        raise ValueError("trace has no device kernel / memcpy / memset "
                         "events — not a torch.profiler trace with CUDA "
                         "activity")
    pids = sorted({e["pid"] for e in device}, key=str)
    pid = pids[0]
    ops = sorted((e for e in device if e["pid"] == pid),
                 key=lambda e: e["ts"])
    busy: dict = {}
    for e in ops:
        busy[e.get("tid")] = busy.get(e.get("tid"), 0.0) + e.get("dur", 0.0)
    stream = max(busy, key=lambda t: busy[t])
    spans = _device_spans(
        events, pid, stream,
        lambda n: n.startswith(STEP_PREFIX) or n in REGIONS)
    steps = sorted(({"name": n, "ts": s, "dur": e - s}
                    for n, iv in spans.items() if n.startswith(STEP_PREFIX)
                    for s, e in iv), key=lambda e: e["ts"])
    regions = sorted((s, e, n) for n, iv in spans.items() if n in REGIONS
                     for s, e in iv)
    name = f"GPU {pid}"
    for props in trace.get("deviceProperties") or []:
        if str(props.get("id")) == str(pid) and props.get("name"):
            name = f"{props['name']} ({pid})"
    return {"pid": pid, "device": name, "stream": stream, "steps": steps,
            "regions": regions, "ops": ops, "n_devices": len(pids)}


def _covered_us(intervals: list) -> float:
    """Total µs covered by the union of (start, end) intervals."""
    total, cur_start, cur_end = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_end is None or s > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = s, e
        else:
            cur_end = max(cur_end, e)
    if cur_end is not None:
        total += cur_end - cur_start
    return total


def _locate(spans: list, ts: float) -> Optional[int]:
    """Index of the ``(start, end, ...)`` span (sorted, disjoint) that
    holds ``ts``, else None."""
    i = bisect.bisect_right([s[0] for s in spans], ts) - 1
    if i >= 0 and ts < spans[i][1]:
        return i
    return None


# ---------------------------------------------------------------------------
# decomposition
# ---------------------------------------------------------------------------

def decompose(trace: Any, num_layers: Optional[int] = None,
              top_kernels: int = 10) -> dict:
    """Decompose a device trace into per-category / per-region time.

    Returns a JSON-ready dict: mean ``step_ms``, per-category ms, launches
    and bytes a step, the device idle inside the steps
    (``host_gap_ms_per_step``), a ``phases`` table (``fwd_scan`` /
    ``bwd_scan`` / ``outside``) with per-layer times for the regions, and
    ``top_kernels`` (name, category, ms and launches a step). Only device
    events that start inside a step count. ``num_layers`` overrides the
    inferred trip count.

    Where the flash kernels' names say their direction (``flash_fwd_*`` /
    ``flash_bwd_*``, as the port's do), ``bwd_scan`` also carries
    ``flash_recompute_ms_per_step``: the forward flash kernels that ran
    inside the backward, i.e. the forward a recompute policy replays.
    """
    tl = _device_timeline(load_trace(trace))
    steps, ops = tl["steps"], tl["ops"]
    if not steps:
        # no step markers: the whole device timeline is one step
        t0 = min(e["ts"] for e in ops)
        t1 = max(e["ts"] + e.get("dur", 0.0) for e in ops)
        steps = [{"name": "all", "ts": t0, "dur": t1 - t0}]
    n_steps = len(steps)
    step_spans = [(s["ts"], s["ts"] + s["dur"]) for s in steps]
    leaves = [e for e in ops if _locate(step_spans, e["ts"]) is not None]
    # a region belongs to the step holding its midpoint: Kineto's device
    # annotations and kernel timestamps disagree by up to a nanosecond
    regions = [r for r in tl["regions"]
               if _locate(step_spans, (r[0] + r[1]) / 2.0) is not None]
    instances: dict[str, int] = {}
    for _r0, _r1, label in regions:
        instances[label] = instances.get(label, 0) + 1

    def region_of(e) -> str:
        i = _locate(regions, e["ts"])
        return "outside" if i is None else regions[i][2]

    cat_ms: dict[str, float] = {}
    cat_n: dict[str, int] = {}
    cat_bytes: dict[str, float] = {}
    phase_cat_ms: dict[str, dict[str, float]] = {}
    phase_flash_names: dict[str, dict[str, int]] = {}
    phase_flash_fwd_ms: dict[str, float] = {}
    flash_directed = False
    name_counts: dict[str, dict[str, int]] = {}
    kernels: dict[str, list] = {}
    intervals = []
    for e in leaves:
        args = e.get("args") or {}
        cat = classify_event(e.get("name", ""), e.get("cat", ""))
        dur_ms = e.get("dur", 0.0) / 1000.0
        cat_ms[cat] = cat_ms.get(cat, 0.0) + dur_ms
        cat_n[cat] = cat_n.get(cat, 0) + 1
        try:
            cat_bytes[cat] = cat_bytes.get(cat, 0.0) + \
                float(args.get("bytes") or args.get("bytes_accessed") or 0)
        except (TypeError, ValueError):
            pass
        ph = region_of(e)
        phase_cat_ms.setdefault(ph, {})
        phase_cat_ms[ph][cat] = phase_cat_ms[ph].get(cat, 0.0) + dur_ms
        if cat == "flash":
            counts = phase_flash_names.setdefault(ph, {})
            counts[e["name"]] = counts.get(e["name"], 0) + 1
            n = e["name"].lower()
            flash_directed |= "fwd" in n or "bwd" in n
            if "fwd" in n:
                phase_flash_fwd_ms[ph] = \
                    phase_flash_fwd_ms.get(ph, 0.0) + dur_ms
        if ph != "outside":
            d = name_counts.setdefault(ph, {})
            d[e["name"]] = d.get(e["name"], 0) + 1
        k = kernels.setdefault(e["name"], [cat, 0.0, 0])
        k[1] += dur_ms
        k[2] += 1
        intervals.append((e["ts"], e["ts"] + e.get("dur", 0.0)))

    step_ms = sum(s["dur"] for s in steps) / n_steps / 1000.0
    covered_ms = _covered_us(intervals) / 1000.0 / n_steps
    host_gap = max(step_ms - covered_ms, 0.0)

    region_ms: dict[str, float] = {}
    for r0, r1, label in regions:
        region_ms[label] = region_ms.get(label, 0.0) + (r1 - r0) / 1000.0

    phases: dict[str, dict] = {}
    for label in sorted(set(list(region_ms) + list(phase_cat_ms))):
        entry: dict[str, Any] = {
            "ms_per_step": round(
                (region_ms.get(label, 0.0)
                 if label != "outside" else
                 sum(phase_cat_ms.get("outside", {}).values())) / n_steps, 4),
            "categories_ms_per_step": {
                k: round(v / n_steps, 4)
                for k, v in sorted(phase_cat_ms.get(label, {}).items(),
                                   key=lambda kv: -kv[1])},
        }
        if label != "outside":
            n_inst = max(instances.get(label, 0), 1)
            counts = name_counts.get(label, {})
            flash = phase_flash_names.get(label, {})
            trips = max((flash or counts).values()) // n_inst \
                if counts else 0
            layers = int(num_layers or trips)
            entry["layers"] = layers
            if n_inst != n_steps:
                entry["instances_per_step"] = round(n_inst / n_steps, 4)
            if layers:
                # one instance a step (the JAX layout): from the rounded
                # ms_per_step, as the JAX module computes it
                per_inst = entry["ms_per_step"] if n_inst == n_steps \
                    else region_ms.get(label, 0.0) / n_inst
                entry["ms_per_layer"] = round(per_inst / layers, 4)
            flash_n = sum(flash.values())
            if layers and flash_n:
                entry["flash_passes_per_layer"] = round(
                    flash_n / n_inst / layers, 2)
            if label == "bwd_scan" and flash_directed:
                entry["flash_recompute_ms_per_step"] = round(
                    phase_flash_fwd_ms.get(label, 0.0) / n_steps, 4)
        phases[label] = entry

    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])
    return {
        "device": tl["device"],
        "n_devices": tl["n_devices"],
        "n_steps": n_steps,
        "step_ms": round(step_ms, 4),
        "categories_ms_per_step": {
            k: round(v / n_steps, 4)
            for k, v in sorted(cat_ms.items(), key=lambda kv: -kv[1])},
        "categories_launches_per_step": {
            k: round(v / n_steps, 4) for k, v in sorted(cat_n.items())},
        "categories_bytes_per_step": {
            k: int(v / n_steps) for k, v in cat_bytes.items() if v},
        "host_gap_ms_per_step": round(host_gap, 4),
        "phases": phases,
        "top_kernels": [
            {"name": name, "category": cat,
             "ms_per_step": round(ms / n_steps, 4),
             "launches_per_step": round(n / n_steps, 4)}
            for name, (cat, ms, n) in top[:max(int(top_kernels), 0)]],
    }


# ---------------------------------------------------------------------------
# roofline scoring
# ---------------------------------------------------------------------------

def _flash_recompute(decomp: dict) -> tuple[float, str]:
    """(recomputed flash ms/step, how it was read).

    Measured where the trace names the flash kernels' direction: the
    forward kernels inside ``bwd_scan``. Else the JAX module's rule:
    backward flash passes a layer beyond 2 (a split dq + dkv backward),
    their share of the backward's flash time."""
    bwd = decomp.get("phases", {}).get("bwd_scan", {})
    if "flash_recompute_ms_per_step" in bwd:
        return (float(bwd["flash_recompute_ms_per_step"]),
                "forward flash kernels inside the backward — the recompute "
                "policy replays the forward")
    passes = float(bwd.get("flash_passes_per_layer") or 0.0)
    bwd_flash_ms = float(bwd.get("categories_ms_per_step", {})
                         .get("flash", 0.0))
    ms = bwd_flash_ms * (passes - 2.0) / passes \
        if passes > 2 and bwd_flash_ms else 0.0
    return ms, (f"{passes:.0f} backward flash passes/layer where the "
                "backward needs at most 2 — the recompute policy replays "
                "the forward kernel")


def mfu_gap(decomp: dict, flops_per_step: Optional[float] = None,
            roofline: Optional[dict] = None, top_k: int = 5) -> dict:
    """Score a decomposition against the roofline → top-k gap report.

    ``flops_per_step`` is the model FLOPs of the batch the trace's devices
    process per step; ``ideal_step_ms`` is ``flops_per_step /
    (matmul_flops × n_devices)``, the compute floor. The gap to the
    measured device step is attributed to contributors that sum to it:

    - ``flash_recompute`` — the forward flash kernel replayed by a
      recompute policy (``_flash_recompute``);
    - ``copy_traffic`` — copies, casts, memcpy and memset (HBM bandwidth,
      with the bytes-at-bandwidth floor where the trace carries bytes);
    - ``collective`` — collective time;
    - ``fused_norm`` / ``elementwise`` — non-matmul compute;
    - ``matmul_inefficiency`` — matmul + flash time above the floor;
    - ``host_gap`` — the card idle inside the step (launch-bound steps,
      input stalls).

    With ``flops_per_step`` or
    ``roofline`` unknown the report still ranks the raw category costs
    (ideal / gap / MFU null).
    """
    rl = roofline or {}
    cats = dict(decomp.get("categories_ms_per_step") or {})
    bytes_per_step = decomp.get("categories_bytes_per_step") or {}
    step_ms = float(decomp["step_ms"])
    peak = rl.get("peak_flops")
    matmul_peak = rl.get("matmul_flops") or peak
    hbm_bw = rl.get("hbm_bytes_per_s")
    # the decomposed timeline is ONE device's; flops_per_step covers the
    # batch the trace's devices share
    n_dev = max(int(decomp.get("n_devices") or 1), 1)

    recompute_ms, recompute_detail = _flash_recompute(decomp)

    ideal_ms = mfu_measured = gap_ms = None
    if flops_per_step and matmul_peak:
        ideal_ms = flops_per_step / (matmul_peak * n_dev) * 1000.0
        gap_ms = max(step_ms - ideal_ms, 0.0)
    if flops_per_step and peak:
        mfu_measured = flops_per_step / (step_ms / 1000.0) / \
            (peak * n_dev)

    def bw_floor(cat: str) -> Optional[float]:
        if not hbm_bw or cat not in bytes_per_step:
            return None
        return round(bytes_per_step[cat] / hbm_bw * 1000.0, 4)

    contributors = []

    def add(name: str, ms: float, detail: str, **extra) -> None:
        if ms <= 0.0:
            return
        contributors.append({"name": name, "ms_per_step": round(ms, 4),
                             "detail": detail, **extra})

    add("flash_recompute", recompute_ms, recompute_detail)
    add("copy_traffic", cats.get("copy", 0.0),
        "copies, casts, memcpy and memset — HBM bandwidth",
        hbm_floor_ms=bw_floor("copy"))
    add("collective", cats.get("collective", 0.0), "NCCL collective time")
    add("fused_norm", cats.get("fused_norm", 0.0),
        "fused residual+LayerNorm kernels (csrc/fused_norm.cu)",
        hbm_floor_ms=bw_floor("fused_norm"))
    add("elementwise", cats.get("elementwise", 0.0),
        "non-matmul kernels (PyTorch's pointwise, reduction, indexing and "
        "optimizer kernels)", hbm_floor_ms=bw_floor("elementwise"))
    math_ms = cats.get("matmul", 0.0) + cats.get("flash", 0.0) - recompute_ms
    if ideal_ms is not None:
        add("matmul_inefficiency", math_ms - ideal_ms,
            "matmul+flash time above the roofline floor")
    add("host_gap", float(decomp.get("host_gap_ms_per_step") or 0.0),
        "card idle inside the step span (launches, input stalls)")

    contributors.sort(key=lambda c: -c["ms_per_step"])
    if gap_ms:
        for c in contributors:
            c["share_of_gap"] = round(c["ms_per_step"] / gap_ms, 4)
    accounted = round(sum(c["ms_per_step"] for c in contributors), 4)
    return {
        "flops_per_step": flops_per_step,
        "peak_flops": peak,
        "matmul_flops": matmul_peak,
        "hbm_bytes_per_s": hbm_bw,
        "measured_step_ms": round(step_ms, 4),
        "ideal_step_ms": None if ideal_ms is None else round(ideal_ms, 4),
        "gap_ms": None if gap_ms is None else round(gap_ms, 4),
        "mfu": None if mfu_measured is None else round(mfu_measured, 4),
        "accounted_ms": accounted,
        "contributors": contributors[:max(int(top_k), 1)],
    }


def analyze(source: Any, flops_per_step: Optional[float] = None,
            roofline: Optional[dict] = None, num_layers: Optional[int] = None,
            top_k: int = 5,
            top_kernels: int = 10) -> dict:
    """load → decompose → roofline-score: the ``decompose`` keys plus
    ``mfu_gap``. What ``tools/trace_report.py`` prints and what the engine
    emits into the perf stream after every closed profiler window."""
    decomp = decompose(source, num_layers=num_layers,
                       top_kernels=top_kernels)
    decomp["mfu_gap"] = mfu_gap(decomp, flops_per_step=flops_per_step,
                                roofline=roofline, top_k=top_k)
    return decomp


def summary(report: dict) -> dict:
    """Slim, record-friendly view of an ``analyze`` report (what rides in
    the gauges and the flight ring)."""
    phases = report.get("phases", {})
    gap = report.get("mfu_gap", {})
    out = {
        "step_ms": report.get("step_ms"),
        "host_gap_ms": report.get("host_gap_ms_per_step"),
        "mfu": gap.get("mfu"),
        "gap_ms": gap.get("gap_ms"),
        "top_contributors": [
            {"name": c["name"], "ms_per_step": c["ms_per_step"]}
            for c in gap.get("contributors", [])[:3]],
    }
    for label in REGIONS:
        ph = phases.get(label)
        if ph and ph.get("ms_per_layer") is not None:
            out[f"{label}_ms_per_layer"] = ph["ms_per_layer"]
    bwd = phases.get("bwd_scan") or {}
    if bwd.get("flash_passes_per_layer") is not None:
        out["bwd_flash_passes_per_layer"] = bwd["flash_passes_per_layer"]
    # 0/1 int: did any fused-norm kernel run on the card?
    cats = report.get("categories_ms_per_step") or {}
    out["norm_fused"] = 1 if cats.get("fused_norm") else 0
    return out
