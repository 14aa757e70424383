"""Merge crash flight-recorder dumps into one timeline; name the first
diverging rank.

Port of ``tools/postmortem.py``::

    python -m fleetx_tpu_torch.tools.postmortem out/flight/   # recursive
    python -m fleetx_tpu_torch.tools.postmortem 'flight/*/flight_rank*.json'
    python -m fleetx_tpu_torch.tools.postmortem out/flight/ --json r.json

Each rank dumps a bounded ring of its final events
(``fleetx_tpu_torch/observability/flight.py``: spans, metric windows, votes,
guard/rollback/commit outcomes) as ``flight_rank<i>.json`` when the run
dies. One file says what one process saw; the merged timeline says what
the GANG did — and, crucially, *who stopped first*. The first-diverging
rank is resolved from two independent signals:

1. any recorded ``coord_timeout`` event's missing-rank census (a healthy
   rank's agreement expired naming the dead peers — the strongest
   evidence), earliest such event winning;
2. otherwise the rank whose event stream ends earliest — in a lockstep
   gang every rank records the same vote/span cadence, so the stream that
   stops first belongs to the process that died (or wedged) first.

Stdlib-only; the port's trainer runs one rank, whose dump this reads the
same way.
"""

from __future__ import annotations

import argparse
import glob as glob_mod
import json
import os
import sys


def find_flight_files(specs: list[str]) -> list[str]:
    """Expand files / directories (recursive) / globs into flight dumps."""
    out: list[str] = []
    for spec in specs:
        if os.path.isdir(spec):
            for root, _dirs, names in os.walk(spec):
                out.extend(os.path.join(root, n) for n in sorted(names)
                           if n.startswith("flight_rank")
                           and n.endswith(".json"))
        elif os.path.exists(spec):
            out.append(spec)
        else:
            out.extend(sorted(glob_mod.glob(spec)))
    # stable + deduplicated: generation dirs may overlap with globs
    seen: set[str] = set()
    uniq = []
    for path in out:
        ap = os.path.abspath(path)
        if ap not in seen:
            seen.add(ap)
            uniq.append(path)
    return uniq


def load_dumps(paths: list[str]) -> tuple[dict, list[str]]:
    """Parse dumps → ``{rank: dump}``; unreadable files become errors.

    A rank appearing twice (two generations globbed together) keeps the
    NEWEST dump by ``dumped_at`` — the post-mortem wants the final word.
    """
    dumps: dict = {}
    errors: list[str] = []
    for path in paths:
        try:
            with open(path) as f:
                dump = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            errors.append(f"{path}: {e}")
            continue
        if not isinstance(dump, dict) or "rank" not in dump:
            errors.append(f"{path}: not a flight dump (no 'rank')")
            continue
        dump["_path"] = path
        rank = int(dump["rank"])
        if rank not in dumps or (dump.get("dumped_at") or 0) > \
                (dumps[rank].get("dumped_at") or 0):
            dumps[rank] = dump
    return dumps, errors


def merge_timeline(dumps: dict) -> list[dict]:
    """All ranks' events, rank-tagged, sorted by wall-clock time."""
    events = []
    for rank, dump in dumps.items():
        for evt in dump.get("events") or []:
            events.append(dict(evt, rank=int(rank)))
    events.sort(key=lambda e: float(e.get("t") or 0.0))
    return events


def first_diverging_rank(dumps: dict) -> tuple[int | None, str]:
    """(rank, how-it-was-resolved) — see the module docstring."""
    # signal 1: the earliest recorded coordination-timeout census
    best_t, best_missing = None, None
    for dump in dumps.values():
        for evt in dump.get("events") or []:
            if evt.get("kind") == "coord_timeout" and evt.get("missing"):
                t = float(evt.get("t") or 0.0)
                if best_t is None or t < best_t:
                    best_t, best_missing = t, evt["missing"]
    if best_missing:
        return int(sorted(best_missing)[0]), "coordination-timeout census"
    # signal 2: whose event stream ends earliest
    last_seen = {rank: max((float(e.get("t") or 0.0)
                            for e in dump.get("events") or []), default=0.0)
                 for rank, dump in dumps.items()}
    if not last_seen:
        return None, "no events"
    if len(set(last_seen.values())) == 1:
        return None, "all ranks stopped together"
    rank = min(last_seen, key=lambda r: last_seen[r])
    return int(rank), "earliest last-recorded event"


def _fmt_event(evt: dict, t0: float) -> str:
    extra = {k: v for k, v in evt.items()
             if k not in ("t", "kind", "name", "rank")}
    tail = f"  {json.dumps(extra, sort_keys=True)}" if extra else ""
    return (f"+{float(evt.get('t') or 0.0) - t0:9.3f}s  "
            f"r{evt.get('rank')}  {evt.get('kind'):<12} "
            f"{evt.get('name')}{tail}")


def report(dumps: dict, tail: int) -> dict:
    """Build the machine-readable report (the text view prints from it)."""
    timeline = merge_timeline(dumps)
    diverging, how = first_diverging_rank(dumps)
    per_rank = {}
    for rank, dump in sorted(dumps.items()):
        events = dump.get("events") or []
        per_rank[str(rank)] = {
            "path": dump.get("_path"),
            "reason": dump.get("reason"),
            "dumped_at": dump.get("dumped_at"),
            "events": len(events),
            "last_event": events[-1] if events else None,
        }
    return {
        "ranks": sorted(int(r) for r in dumps),
        "world": max((int(d.get("world") or 1) for d in dumps.values()),
                     default=1),
        "first_diverging_rank": diverging,
        "diverging_evidence": how,
        "per_rank": per_rank,
        "timeline_tail": timeline[-max(tail, 0):],
    }


def print_report(rep: dict) -> None:
    """Human view: per-rank last words, the verdict, the merged tail."""
    print(f"flight dumps: ranks {rep['ranks']} of world {rep['world']}")
    missing = sorted(set(range(rep["world"])) - set(rep["ranks"]))
    if missing:
        print(f"  no dump from ranks {missing} "
              f"(died without reaching a dump trigger — already suspect)")
    for rank, info in sorted(rep["per_rank"].items(), key=lambda kv: int(kv[0])):
        last = info["last_event"] or {}
        print(f"  r{rank}: reason={info['reason']!r} "
              f"events={info['events']} "
              f"last={last.get('kind')}/{last.get('name')}")
    verdict = rep["first_diverging_rank"]
    if verdict is None:
        print(f"first-diverging rank: undetermined "
              f"({rep['diverging_evidence']})")
    else:
        print(f"first-diverging rank: {verdict} "
              f"(by {rep['diverging_evidence']})")
    timeline = rep["timeline_tail"]
    if timeline:
        t0 = float(timeline[0].get("t") or 0.0)
        print(f"\nmerged timeline (last {len(timeline)} events):")
        for evt in timeline:
            print(f"  {_fmt_event(evt, t0)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="merge flight-recorder dumps into one timeline and "
                    "name the first-diverging rank")
    ap.add_argument("paths", nargs="+",
                    help="flight_rank*.json files, directories (searched "
                         "recursively), or globs")
    ap.add_argument("--json", metavar="OUT",
                    help="also write the report as JSON (- for stdout)")
    ap.add_argument("--tail", type=int, default=25,
                    help="merged-timeline events to show (default 25)")
    args = ap.parse_args(argv)

    files = find_flight_files(args.paths)
    if not files:
        print("error: no flight_rank*.json dumps found", file=sys.stderr)
        return 2
    dumps, errors = load_dumps(files)
    for err in errors:
        print(f"warning: {err}", file=sys.stderr)
    if not dumps:
        print("error: no readable flight dumps", file=sys.stderr)
        return 2

    rep = report(dumps, tail=args.tail)
    print_report(rep)
    if args.json:
        payload = json.dumps(rep, indent=1)
        if args.json == "-":
            print(payload)
        else:
            with open(args.json, "w") as f:
                f.write(payload + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
