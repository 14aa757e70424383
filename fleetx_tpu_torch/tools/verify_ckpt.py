"""Offline checkpoint integrity auditor (port of ``tools/verify_ckpt.py``).

Walks a checkpoint directory's ``step_<N>`` directories and re-digests
every payload file, and every leaf of a ``state.npz`` payload, against
the ``fleetx_integrity.json`` manifest the save wrote::

    python -m fleetx_tpu_torch.tools.verify_ckpt output           # table
    python -m fleetx_tpu_torch.tools.verify_ckpt output --json -  # JSON
    python -m fleetx_tpu_torch.tools.verify_ckpt output --step 400

Per-step statuses: ``ok`` (the manifest re-digests clean), ``corrupt``
(a file or leaf mismatch), ``unverified`` (no manifest), ``incomplete``
(no meta marker: a half-written save). Exit code 1 when any audited step
is corrupt, 2 when there is no step directory, else 0.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

from fleetx_tpu_torch.core.checkpoint import META_NAME, step_dirs
from fleetx_tpu_torch.resilience import integrity


def audit_directory(directory: str, step: Optional[int] = None) -> dict:
    """Re-digest every (or one) step directory against its manifest:
    ``{"directory", "steps": [per-step reports], "ok"}``, ``ok`` meaning
    no audited step is corrupt."""
    steps = []
    for s, path in step_dirs(directory):
        if step is not None and s != step:
            continue
        if not os.path.exists(os.path.join(path, META_NAME)):
            report = {"status": "incomplete", "files_checked": 0,
                      "leaves_checked": 0, "mismatched_files": [],
                      "mismatched_leaves": []}
        else:
            report = integrity.verify_checkpoint_dir(path)
        steps.append(dict(report, step=s, path=path))
    return {"directory": os.path.abspath(directory), "steps": steps,
            "ok": all(r["status"] != "corrupt" for r in steps)}


def main(argv: Optional[list] = None) -> int:
    """CLI entry point; returns the exit code (0 verified, 1 any
    corruption, 2 nothing to audit)."""
    parser = argparse.ArgumentParser(
        description="offline checkpoint integrity auditor")
    parser.add_argument("directory", help="checkpoint dir (step_<N> dirs)")
    parser.add_argument("--step", type=int, default=None,
                        help="audit only this step")
    parser.add_argument("--json", dest="json_out", default=None,
                        help="write the JSON report here ('-' = stdout)")
    args = parser.parse_args(argv)

    report = audit_directory(args.directory, step=args.step)
    if args.json_out == "-":
        print(json.dumps(report, indent=2))
    elif args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(report, f, indent=2)
    else:
        for r in report["steps"]:
            detail = ""
            if r["mismatched_files"] or r["mismatched_leaves"]:
                detail = (f"  files={r['mismatched_files']} "
                          f"leaves={r['mismatched_leaves']}")
            print(f"step {r['step']:>10}  {r['status']:<11} "
                  f"({r['files_checked']} files, {r['leaves_checked']} "
                  f"leaves checked){detail}")
    if not report["steps"]:
        print(f"no step dirs under {args.directory}", file=sys.stderr)
        return 2
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
