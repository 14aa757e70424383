"""Offline trace decomposition: a Kineto trace split into the per-phase /
per-category / MFU-gap report (port of ``tools/trace_report.py``).

Usage::

    python -m fleetx_tpu_torch.tools.trace_report profiler_log/
    python -m fleetx_tpu_torch.tools.trace_report host_123.pt.trace.json --json -
    python -m fleetx_tpu_torch.tools.trace_report trace.json.gz --batch 4 --seq 2048

Accepts any trace ``observability/perf.py`` can load: a Chrome-trace
``.json`` / ``.json.gz`` that ``torch.profiler`` exported (the
``*.pt.trace.json`` a ``Profiler`` window writes), or a profiler output
directory (the newest trace inside). Defaults
describe GPT-345M (24 × 1024, seq 1024, batch 8, vocab 50304) on an H100
SXM; pass ``--layers/--hidden/--seq/--batch/--vocab`` (or
``--flops-per-step``) for other runs, ``--device-name`` for other cards
(``''`` skips the roofline), ``--top-kernels`` for a longer kernel list.
The analysis is host-side Python: no card needed.

Exit codes follow ``tools/metrics_report.py``: 0 report printed,
2 usage/load error.
"""

import argparse
import json
import sys

from fleetx_tpu_torch.observability import perf
from fleetx_tpu_torch.utils.hardware import gpt_flops_per_token, roofline

#: GPT-345M's training recipe on the card the port targets
DEFAULTS = {"layers": 24, "hidden": 1024, "seq": 1024, "batch": 8,
            "vocab": 50304, "device_name": "NVIDIA H100 80GB HBM3"}


def print_report(report: dict) -> None:
    """Render the analyze() report as the BENCHMARKS-style text tables."""
    gap = report.get("mfu_gap", {})
    print(f"trace: {report['device']}  steps: {report['n_steps']}  "
          f"step: {report['step_ms']:.1f} ms"
          + (f"  MFU: {gap['mfu']:.3f}" if gap.get("mfu") else ""))

    print("\nphase decomposition")
    hdr = f"{'phase':<12} {'ms/step':>9} {'ms/layer':>9} {'layers':>7} " \
          f"{'flash/layer':>12}"
    print(hdr)
    print("-" * len(hdr))
    for label in ("fwd_scan", "bwd_scan", "extra_scan", "outside"):
        ph = report.get("phases", {}).get(label)
        if not ph:
            continue
        ml = ph.get("ms_per_layer")
        fl = ph.get("flash_passes_per_layer")
        print(f"{label:<12} {ph['ms_per_step']:>9.2f} "
              f"{(f'{ml:.3f}' if ml is not None else '—'):>9} "
              f"{ph.get('layers', '—'):>7} "
              f"{(f'{fl:.1f}' if fl is not None else '—'):>12}")

    print("\ncategory ms/step")
    for cat, ms in report.get("categories_ms_per_step", {}).items():
        print(f"  {cat:<14} {ms:>9.2f}")
    print(f"  {'host_gap':<14} {report.get('host_gap_ms_per_step', 0):>9.2f}")

    if gap:
        ideal = gap.get("ideal_step_ms")
        print(f"\nMFU gap: measured {gap['measured_step_ms']:.1f} ms vs "
              f"roofline {f'{ideal:.1f}' if ideal else '?'} ms → "
              f"gap {gap.get('gap_ms') if gap.get('gap_ms') is not None else '?'} ms "
              f"(accounted {gap['accounted_ms']:.1f})")
        for c in gap.get("contributors", []):
            share = c.get("share_of_gap")
            print(f"  {c['name']:<22} {c['ms_per_step']:>8.2f} ms"
                  + (f"  ({share * 100:.0f}% of gap)" if share else ""))
            print(f"      {c['detail']}")

    kernels = report.get("top_kernels") or []
    if kernels:
        print("\ntop kernels (ms/step, launches/step)")
        for k in kernels:
            print(f"  {k['ms_per_step']:>9.3f} {k['launches_per_step']:>8.1f}"
                  f"  {k['category']:<12} {k['name'][:100]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="decompose a torch.profiler (Kineto) Chrome trace into "
                    "the per-phase / per-category / MFU-gap report")
    ap.add_argument("trace", help="trace .json[.gz] / profiler output "
                                  "directory")
    ap.add_argument("--json", metavar="OUT", nargs="?", const="-",
                    default=None,
                    help="also write the full report as JSON to OUT "
                         "(bare --json streams to stdout)")
    ap.add_argument("--layers", type=int, default=None,
                    help="scan trip count override (default: inferred "
                         "from the trace; FLOPs math falls back to "
                         f"{DEFAULTS['layers']})")
    ap.add_argument("--hidden", type=int, default=DEFAULTS["hidden"])
    ap.add_argument("--seq", type=int, default=DEFAULTS["seq"])
    ap.add_argument("--batch", type=int, default=DEFAULTS["batch"])
    ap.add_argument("--vocab", type=int, default=DEFAULTS["vocab"])
    ap.add_argument("--params", type=int, default=None,
                    help="exact parameter count (else approximated from "
                         "the architecture flags)")
    ap.add_argument("--flops-per-step", type=float, default=None,
                    help="override the model-FLOPs estimate entirely")
    ap.add_argument("--device-name", default=DEFAULTS["device_name"],
                    help="card name for the roofline table "
                         "(utils/hardware.py); pass '' to skip roofline "
                         "scoring")
    ap.add_argument("--top-k", type=int, default=5,
                    help="gap contributors to name")
    ap.add_argument("--top-kernels", type=int, default=10,
                    help="kernels to list by ms a step")
    args = ap.parse_args(argv)

    flops = args.flops_per_step
    if flops is None:
        flops = gpt_flops_per_token(
            args.layers or DEFAULTS["layers"], args.hidden, args.seq,
            num_params=args.params,
            vocab_size=args.vocab) * args.batch * args.seq
    try:
        report = perf.analyze(
            args.trace, flops_per_step=flops,
            roofline=roofline(args.device_name) if args.device_name else None,
            num_layers=args.layers,
            top_k=args.top_k, top_kernels=args.top_kernels)
    except (OSError, ValueError) as e:
        print(f"error: cannot analyze {args.trace}: {e}", file=sys.stderr)
        return 2

    print_report(report)
    if args.json:
        payload = json.dumps(report, indent=1)
        if args.json == "-":
            print(payload)
        else:
            with open(args.json, "w") as f:
                f.write(payload + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
