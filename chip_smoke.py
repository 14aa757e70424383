#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU: build, check and time its
kernels, then serve GPT-345M at full width through the port's replica.

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure raises, exit code != 0):

0. environment: torch/CUDA versions, ``nvcc --version``, the card's name
   and power limit; TF32 is switched off for matmuls and cuDNN.
1. kernels: build every CUDA kernel from ``fleetx_tpu_torch/csrc``, run
   each at the shapes GPT-345M serving gives it (B 16, nh 16, hd 64,
   page 16, 64 pages per request, 513 pages) in f32 and bf16, hold it to
   its plain PyTorch version, and time it, the plain version and one
   PyTorch library call computing the same function (the yardstick; the
   port never calls it), each the median of CUDA-event timings with the
   L2 cache flushed before every launch.
2. main path: ``serving_gpt_345M.yaml`` through the port's own config
   loader and ``build_engine`` (seeded bf16 weights, full width), an
   in-process ``ReplicaServer`` answering concurrent requests over TCP.
   Kernel launch counts are zeroed just before and read just after; the
   decode path must be the kernel and it must have run in all 24 layers
   of every decode step.
   Then a short trace on the same engine: host wall per decode step,
   device time per step by kernel (``torch.profiler``), device busy share.
3. kernel against gather on the main path: the same full-width engine
   built twice on the same weights, ``Serving.paged_kernel`` on and off;
   f32 greedy tokens must be identical, and in bf16 the one-step logit
   difference and the share of agreeing tokens are printed.

Tolerances, kernel against its plain version (both compute in f32 after
casting q and k; only the summation order differs): ``acc`` and ``l``
rtol 1e-5 / atol 1e-4 (sums of up to 1024 O(1) terms), ``m`` rtol 1e-5 /
atol 1e-5; the normalised output atol 1e-5 with rtol 1e-5 in f32 and
one bf16 ulp (2**-7) in bf16.

The second-to-last line is the ``kernels`` JSON record; the last line is
``{"ok": true, "device": {...}}``. Without CUDA the script exits non-zero
and prints no result.
"""

import json
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
YAML = os.path.join(REPO, "fleetx_tpu", "configs", "nlp", "gpt",
                    "serving_gpt_345M.yaml")

#: H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and f32
#: FLOP/s outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12

# 345M serving decode geometry (serving_gpt_345M.yaml)
B, NH, HD, PS, PPR, PAGES = 16, 16, 64, 16, 64, 513
#: ragged query positions: inactive (-1), the first slot (0), the last
#: slot of page 0 (15), the first slot of page 1 (16), the full table
#: (1023), and a spread in between
LENS = [-1, 0, 15, 16, 1023, 511, 100, 777, 256, 31, 1000, 64, 900, 5,
        300, 1022]


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# --------------------------------------------------------------- phase 0
def phase_env(build) -> str:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    nvcc = subprocess.run([build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[-1]
    card = smi_line()
    emit("env", python=sys.version.split()[0], torch=torch.__version__,
         torch_cuda=torch.version.cuda, nvcc=nvcc, nvidia_smi=card,
         device=torch.cuda.get_device_name(0),
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    return card


# --------------------------------------------------------------- phase 1
def time_ms(fn, flush: torch.Tensor, iters: int = 50,
            warmup: int = 5) -> float:
    """Median device time of ``fn`` over ``iters`` launches, each after
    an L2 flush (a decode step reads every layer's pool cold)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def decode_case(dtype: torch.dtype, dev: torch.device):
    """Seeded inputs at the 345M decode shapes: pools, q, raw tables
    (NULL_PAGE tails), localized tables (-1 tails), lens."""
    from fleetx_tpu_torch.serving.paged_cache import NULL_PAGE

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    shape = (PAGES, PS, NH, HD)
    pk = torch.randn(shape, generator=gen, device=dev).to(dtype)
    pv = torch.randn(shape, generator=gen, device=dev).to(dtype)
    q = torch.randn((B, NH, HD), generator=gen, device=dev).to(dtype)
    rng = np.random.RandomState(0)
    free = list(rng.permutation(np.arange(1, PAGES)))
    tables = np.full((B, PPR), NULL_PAGE, np.int32)
    for b, n in enumerate(LENS):
        used = -(-(n + 1) // PS) if n >= 0 else 0
        tables[b, :used] = [free.pop() for _ in range(used)]
    local = np.where(tables != NULL_PAGE, tables, -1).astype(np.int32)
    as_dev = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return (q, pk, pv, as_dev(tables), as_dev(local),
            as_dev(np.asarray(LENS, np.int32)))


def paged_bound(itemsize: int):
    """(bound_ms, bound_by): each input read once, each output written
    once, the K/V rows this run's lens need and no more."""
    rows = sum(n + 1 for n in LENS if n >= 0)
    nbytes = (B * NH * HD * itemsize              # q
              + rows * NH * HD * 2 * itemsize     # K and V rows read
              + B * PPR * 4 + B * 4               # tables, lens
              + B * NH * HD * 4 + 2 * B * NH * 4)  # acc, m, l
    flops = rows * NH * HD * 4                    # q.k and p.v, f32 FMAs
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_kernels(build, dev: torch.device) -> dict:
    from fleetx_tpu_torch.ops import paged_attention as PA

    t0 = time.monotonic()
    build.build()
    build_s = time.monotonic() - t0
    emit("build", seconds=build_s, libraries=sorted(build.SOURCES),
         ptxas=[l for log in build.build_logs.values()
                for l in log.splitlines() if "registers" in l
                or "Compiling entry" in l])
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    result = {}
    for name, dtype in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        q, pk, pv, tables, local, lens = decode_case(dtype, dev)
        acc, m, l = PA.paged_call(q, pk, pv, local, lens)
        r_acc, r_m, r_l = PA.paged_call_plain(q, pk, pv, local, lens)
        torch.cuda.synchronize()
        torch.testing.assert_close(acc, r_acc, rtol=1e-5, atol=1e-4)
        torch.testing.assert_close(l, r_l, rtol=1e-5, atol=1e-4)
        torch.testing.assert_close(m, r_m, rtol=1e-5, atol=1e-5)
        out = PA.paged_attention(q, pk, pv, tables, lens)
        ref = PA._normalize(r_acc, r_l, dtype)
        rtol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
        torch.testing.assert_close(out, ref, rtol=rtol, atol=1e-5)
        check(bool((out[LENS.index(-1)] == 0).all()),
              "inactive row is not exact zeros")
        err = float((out.float() - ref.float()).abs().max())

        # the yardstick: one gather + PyTorch's fused attention with the
        # same mask (never called by the port)
        safe = torch.where(local >= 0, local, 0).long()
        pos = torch.arange(PPR * PS, device=dev)
        mask = ((local >= 0).repeat_interleave(PS, dim=1)
                & (pos[None] <= lens[:, None].long())
                & (lens[:, None] >= 0))[:, None, None, :]

        def library():
            kd = pk[safe].reshape(B, PPR * PS, NH, HD).transpose(1, 2)
            vd = pv[safe].reshape(B, PPR * PS, NH, HD).transpose(1, 2)
            return torch.nn.functional.scaled_dot_product_attention(
                q[:, :, None], kd, vd, attn_mask=mask)

        ms = time_ms(lambda: PA.paged_call(q, pk, pv, local, lens), flush)
        plain_ms = time_ms(
            lambda: PA.paged_call_plain(q, pk, pv, local, lens), flush)
        library_ms = time_ms(library, flush)
        bound_ms, bound_by = paged_bound(pk.element_size())
        result[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            library_ms=library_ms, bound_ms=bound_ms,
                            bound_by=bound_by)
        emit("kernel", name="paged_attention_decode", dtype=name,
             acc_max_abs_err=float((acc - r_acc).abs().max()),
             m_max_abs_err=float((m - r_m).abs().max()),
             l_max_abs_err=float((l - r_l).abs().max()),
             **result[name])
    return result


# --------------------------------------------------------------- phase 2
class _Stop:
    """Preemption stand-in the client thread latches once it is done."""

    def __init__(self):
        self._flag = threading.Event()

    @property
    def triggered(self) -> bool:
        return self._flag.is_set()

    def set(self) -> None:
        self._flag.set()


def _prompts(seed: int, lengths, vocab: int = 50000):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, size=n).tolist() for n in lengths]


def phase_main_path(dev: torch.device, card: str) -> dict:
    from fleetx_tpu_torch.ops import paged_attention as PA
    from fleetx_tpu_torch.serving.server import ReplicaServer, request
    from fleetx_tpu_torch.tools.serve import build_engine, load_config

    cfg = load_config(YAML)
    engine = build_engine(cfg, device=dev)
    mc = engine.cfg
    check(mc.num_layers == 24 and mc.hidden_size == 1024
          and mc.num_attention_heads == 16 and mc.vocab_size == 50304
          and mc.dtype == torch.bfloat16, "not the full-width 345M config")
    # warm-up off the measurement: first-call allocations, cuBLAS handles
    engine.submit(_prompts(1, [8])[0], 2, request_id="warmup")
    engine.run_until_drained()
    engine.reset_stats()

    server = ReplicaServer(engine)
    port = server.start()
    max_new = 32
    prompts = _prompts(2, [200, 37, 5, 90, 128, 16, 300, 64])
    responses = [None] * len(prompts)
    stats = {}
    stop = _Stop()
    window = {}

    def client():
        try:
            def ask(i):
                responses[i] = request(
                    ("127.0.0.1", port),
                    {"id": f"s{i}", "prompt": prompts[i],
                     "max_new_tokens": max_new}, timeout=600)

            threads = [threading.Thread(target=ask, args=(i,))
                       for i in range(len(prompts))]
            window["t0"] = time.monotonic()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            window["t1"] = time.monotonic()
            stats.update(request(("127.0.0.1", port), {"verb": "stats"}))
        finally:
            stop.set()

    decode_hist = engine.metrics.histogram("serving_decode_step")
    steps0 = decode_hist.total_count
    PA.paged_call.launches = 0        # zero every count just before
    worker = threading.Thread(target=client, name="chip-smoke-client")
    worker.start()
    try:
        server.run(preemption=stop)
    finally:
        server.close()
    worker.join(timeout=60)
    launches = PA.paged_call.launches  # read just after
    decode_steps = decode_hist.total_count - steps0

    check(not worker.is_alive(), "client thread did not finish")
    for i, resp in enumerate(responses):
        check(resp is not None and "tokens" in resp,
              f"request {i} got no tokens: {resp}")
        check(1 <= len(resp["tokens"]) <= max_new, f"request {i} length")
        check(all(0 <= t < mc.vocab_size for t in resp["tokens"]),
              f"request {i} token out of vocab")
    check(stats.get("decode_path") == "paged_kernel",
          f"decode_path {stats.get('decode_path')}")
    check(decode_steps > 0, "no decode step ran")
    check(launches >= mc.num_layers * decode_steps,
          f"{launches} kernel launches < {mc.num_layers} x "
          f"{decode_steps} decode steps")
    wall = window["t1"] - window["t0"]
    tokens = sum(len(r["tokens"]) for r in responses)
    out = dict(requests=len(prompts), prompt_lens=[len(p) for p in prompts],
               max_new_tokens=max_new, tokens=tokens, wall_s=wall,
               tokens_per_s=tokens / wall, ttft_p50_s=stats["ttft_p50_s"],
               ttft_p99_s=stats["ttft_p99_s"], itl_p50_s=stats["itl_p50_s"],
               itl_p99_s=stats["itl_p99_s"], decode_steps=decode_steps,
               kernel_launches=launches,
               launches_per_decode_step=launches / decode_steps,
               decode_path=stats["decode_path"], nvidia_smi=card)
    emit("main_path", **out)
    del engine, server
    torch.cuda.empty_cache()
    return out


def _device_us(evt) -> float:
    """Self device time of one profiler row, in microseconds."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        value = getattr(evt, attr, None)
        if value is not None:
            return float(value)
    return 0.0


def phase_trace(dev: torch.device, card: str, n_steps: int = 10) -> None:
    """Where a decode step's time goes on the main path's engine
    (``serving_gpt_345M.yaml``, 8 running requests): host wall per step
    (unprofiled), device time per step by kernel (``torch.profiler`` over
    a second, profiled window), and the device busy share = device time /
    unprofiled wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from fleetx_tpu_torch.tools.serve import build_engine, load_config

    engine = build_engine(load_config(YAML), device=dev)
    for i, p in enumerate(_prompts(4, [100] * 8)):
        engine.submit(p, 64, request_id=f"t{i}")
    while engine._waiting or engine._prefilling:
        engine.step()
    for _ in range(3):
        engine.step()
    check(sum(r is not None and r.state == "running"
              for r in engine._slots) == 8, "trace: 8 requests running")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        engine.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            engine.step()
        torch.cuda.synchronize()
    # device-side rows only (kernels, copies): a CPU op's row carries its
    # kernels' device time too, and would count it twice
    rows = [(e.key, _device_us(e)) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    rows = [(k, us) for k, us in rows if us > 0]
    device_ms = sum(us for _, us in rows) / 1e3 / n_steps
    paged_ms = sum(us for k, us in rows
                   if "paged_decode_kernel" in k) / 1e3 / n_steps
    top = sorted(rows, key=lambda r: -r[1])[:8]
    engine.run_until_drained()
    del engine
    torch.cuda.empty_cache()
    emit("trace", decode_batch=8, context_tokens=100, steps=n_steps,
         wall_ms_per_step=wall_ms,
         device_ms_per_step=device_ms if rows else None,
         device_busy_share=device_ms / wall_ms if rows else None,
         paged_kernel_ms_per_step=paged_ms if rows else None,
         top_kernels_ms_per_step=[[k[:80], us / 1e3 / n_steps]
                                  for k, us in top],
         nvidia_smi=card)


# --------------------------------------------------------------- phase 3
def _pair(dtype: str, dev: torch.device, prompts, max_new: int):
    """Kernel and gather engines on the same seeded weights: the one-step
    decode logit difference on identical state, then full greedy runs."""
    from fleetx_tpu_torch.tools.serve import build_engine, load_config

    engines = [build_engine(load_config(
        YAML, [f"Model.dtype={dtype}", f"Serving.paged_kernel={flag}"]),
        device=dev) for flag in (True, False)]
    check([e.paged_kernel_active for e in engines] == [True, False],
          "engine paths")
    reqs = []
    for e in engines:
        reqs.append([e.submit(p, max_new, request_id=f"p{i}")
                     for i, p in enumerate(prompts)])
        # prefill every request (gather path on both engines, so both
        # pools end identical) before any decode step runs
        while e._waiting or e._prefilling:
            e._admit()
            e._prefill_step()
    logits = []
    for e in engines:
        _, _, _, lg = e._fns["decode"](e.params, e.pool_k, e.pool_v,
                                       e._last_tokens, e._block_tables,
                                       e._lens, e._next_rng())
        logits.append(lg[torch.from_numpy(e._lens >= 0).to(dev)])
    diff = float((logits[0] - logits[1]).abs().max())
    for e in engines:
        e.run_until_drained()
    toks = [[r.tokens for r in rs] for rs in reqs]
    pairs = [(a, b) for ra, rb in zip(*toks) for a, b in zip(ra, rb)]
    agree = sum(a == b for a, b in pairs) / max(len(pairs), 1)
    del engines
    torch.cuda.empty_cache()
    return toks, diff, agree


def phase_kernel_vs_gather(dev: torch.device, card: str) -> None:
    prompts = _prompts(3, [150, 40, 7, 64])
    max_new = 24
    toks, diff32, agree32 = _pair("float32", dev, prompts, max_new)
    check(toks[0] == toks[1], f"f32 kernel and gather tokens differ: "
                              f"{toks[0]} vs {toks[1]}")
    _, diff16, agree16 = _pair("bfloat16", dev, prompts, max_new)
    emit("kernel_vs_gather", prompt_lens=[len(p) for p in prompts],
         max_new_tokens=max_new, f32_tokens_identical=True,
         f32_max_logit_diff=diff32, bf16_max_logit_diff=diff16,
         bf16_token_agreement=agree16, f32_token_agreement=agree32,
         nvidia_smi=card)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from fleetx_tpu_torch.kernels import build

    dev = torch.device("cuda", 0)
    card = phase_env(build)
    kernels = phase_kernels(build, dev)
    main_path = phase_main_path(dev, card)
    phase_trace(dev, card)
    phase_kernel_vs_gather(dev, card)
    bf16 = kernels["bfloat16"]
    print(json.dumps({"kernels": [{
        "name": "paged_attention_decode", "route": "cuda",
        "source": "fleetx_tpu_torch/csrc/paged_attention.cu",
        "replaces": "fleetx_tpu/ops/paged_attention.py:144",
        "launches": main_path["kernel_launches"],
        "max_abs_err": bf16["max_abs_err"], "ms": bf16["ms"],
        "plain_ms": bf16["plain_ms"], "bound_ms": bf16["bound_ms"],
        "bound_by": bf16["bound_by"], "library_ms": bf16["library_ms"],
    }]}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
