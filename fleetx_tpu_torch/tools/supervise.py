"""Gang supervisor of the port (port of the repository's
``tools/supervise.py``, stdlib only, as that tool)::

    python -m fleetx_tpu_torch.tools.supervise [--max-restart N] \
        [--preflight] -- python -m fleetx_tpu_torch.tools.train -c cfg.yaml ...
    python -m fleetx_tpu_torch.tools.supervise --elastic --num-procs 3 \
        --min-healthy 2 -- python -m fleetx_tpu_torch.tools.serve -c ...

It owns the training command's process lifecycle:

- **launch**: ``--num-procs N`` starts N copies of the command, each in
  its own process group, with the gang environment
  (``FLEETX_COORDINATOR`` / ``FLEETX_NUM_PROCESSES`` /
  ``FLEETX_PROCESS_ID``) for N > 1; the port's trainer refuses to be a
  member of such a gang (ROADMAP.md, port queue item 12), so N = 1, the
  restart wrapper, is what it runs under;
- **monitor and restart**: when a member dies with a crash code the
  others are killed (SIGTERM, a grace wait, SIGKILL) and the whole gang
  restarts after ``--backoff`` seconds, up to ``--max-restart`` times;
  each retry resumes from the newest checkpoint;
- **signal forwarding**: SIGTERM / SIGINT to the supervisor go to every
  member's process group, and the supervisor waits for the graceful
  (checkpoint-and-exit) exits;
- **preemption**: exit 0 and ``--preemption-code`` are clean stops,
  never restarted;
- **flight directories**: every member gets a per-rank, per-generation
  ``FLEETX_FLIGHT_DIR`` under ``--flight-dir``, so a restart never
  overwrites the dump that explains it;
- **preflight** (``--preflight``): before the launch, each member's
  ``python -m fleetx_tpu_torch.resilience.integrity --selftest`` (on
  ``cuda``, or ``--preflight-device``) runs in a child process, and a
  failing member refuses the launch with exit 41, named;
- **elastic serving** (``--elastic``): members restart individually with
  per-member backoff, ``--min-healthy`` gates the launch and trips the
  supervisor, and a scale rung moves the live count on the SLO burn rate
  of the router's ``--fleet-out`` records.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import signal
import socket
import subprocess
import sys
import time

#: clean-preemption exit code the supervisor treats like rc 0 (override
#: with --preemption-code; match it in Resilience.preemption.exit_code
#: when you want a supervisor to distinguish preemption from success)
PREEMPTION_EXIT_CODE = 75

#: exit code for a refused launch: a gang member failed its preflight
#: compute+digest self-test (distinct from every trainer/crash code)
PREFLIGHT_EXIT_CODE = 41


def _free_port() -> int:
    """An OS-assigned free TCP port for the gang's local coordinator."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Gang:
    """One generation of N child processes forming a gang."""

    def __init__(self, cmd: list, num_procs: int,
                 flight_base: str | None = None):
        self.cmd = list(cmd)
        self.num_procs = int(num_procs)
        self.flight_base = flight_base
        self.generation = -1  # bumped to 0 by the first launch
        self.procs: list = []

    def launch(self) -> None:
        """Start all members; multi-process gangs get a fresh coordinator
        address per generation (the previous service's port may linger in
        TIME_WAIT after a gang kill).

        Every member also gets a per-rank, per-generation
        ``FLEETX_FLIGHT_DIR`` so a restarted gang's crash flight dumps
        (docs/observability.md "Multi-host") never overwrite the previous
        generation's evidence — the dump that explains restart N is
        useless if restart N+1 clobbers it.
        """
        self.generation += 1
        env = dict(os.environ)
        if self.num_procs > 1:
            env["FLEETX_COORDINATOR"] = f"127.0.0.1:{_free_port()}"
            env["FLEETX_NUM_PROCESSES"] = str(self.num_procs)
        self.procs = []
        for rank in range(self.num_procs):
            child_env = dict(env)
            if self.num_procs > 1:
                child_env["FLEETX_PROCESS_ID"] = str(rank)
            if self.flight_base:
                child_env["FLEETX_FLIGHT_DIR"] = os.path.join(
                    self.flight_base, f"gen{self.generation}",
                    f"rank{rank}")
            # own process group/session: signals forwarded with killpg
            # reach the trainer AND anything it spawned (data workers)
            self.procs.append(subprocess.Popen(self.cmd, env=child_env,
                                               start_new_session=True))

    def collect_flights(self) -> list:
        """The current generation's flight dumps (survivors' evidence,
        gathered after a gang kill so the operator — and the restart's
        logs — know where the post-mortem material landed)."""
        if not self.flight_base or self.generation < 0:
            return []
        pattern = os.path.join(self.flight_base,
                               f"gen{self.generation}", "*",
                               "flight_rank*.json")
        return sorted(glob.glob(pattern))

    def poll(self) -> dict:
        """rank → returncode for members that have exited."""
        return {i: p.returncode for i, p in enumerate(self.procs)
                if p.poll() is not None}

    def signal_all(self, sig: int) -> None:
        """Deliver ``sig`` to every live member's process group."""
        for p in self.procs:
            if p.poll() is None:
                try:
                    os.killpg(os.getpgid(p.pid), sig)
                except (ProcessLookupError, PermissionError):
                    pass

    def wait_all(self, timeout: float) -> bool:
        """Wait up to ``timeout`` seconds for every member to exit."""
        deadline = time.monotonic() + timeout
        for p in self.procs:
            remaining = deadline - time.monotonic()
            try:
                p.wait(timeout=max(remaining, 0.1))
            except subprocess.TimeoutExpired:
                return False
        return True

    def kill_all(self, grace: float) -> None:
        """Gang kill: SIGTERM every member, grace wait, then SIGKILL."""
        self.signal_all(signal.SIGTERM)
        if not self.wait_all(grace):
            print("[supervise] grace expired — SIGKILL to remaining gang "
                  "members", file=sys.stderr)
            self.signal_all(signal.SIGKILL)
            self.wait_all(10.0)

    def returncodes(self) -> list:
        """Final returncodes (None for still-running members)."""
        return [p.returncode for p in self.procs]


def _preflight(num_procs: int, timeout: float,
               device: str | None = None) -> list:
    """Run the per-member compute+digest self-test; returns failures as
    ``(member, why, output_tail)`` tuples (empty = all hosts healthy).

    Each member gets its own child process running the integrity
    module's ``--selftest`` on ``device`` (cuda unless given; the
    supervisor never imports torch itself); ``FLEETX_PREFLIGHT_MEMBER``
    tells the child which gang slot it is probing."""
    cmd = [sys.executable, "-m", "fleetx_tpu_torch.resilience.integrity",
           "--selftest"] + (["--device", device] if device else [])
    procs = []
    for member in range(num_procs):
        env = dict(os.environ, FLEETX_PREFLIGHT_MEMBER=str(member))
        procs.append((member, subprocess.Popen(
            cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failures = []
    for member, proc in procs:
        try:
            out, _ = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
            failures.append((member, "timeout", (out or "")[-500:]))
            continue
        if proc.returncode != 0:
            failures.append((member, f"rc={proc.returncode}",
                             (out or "")[-500:]))
    return failures


class Member:
    """One elastic serving replica slot — launched, restarted and
    drained INDIVIDUALLY (never gang-killed with its siblings)."""

    def __init__(self, cmd: list, rank: int, flight_base: str | None):
        self.cmd = list(cmd)
        self.rank = int(rank)
        self.flight_base = flight_base
        self.generation = -1
        self.proc: subprocess.Popen | None = None
        self.restarts = 0
        self.next_launch_at = 0.0  # monotonic; backoff gate
        self.stopped = False       # retired/scaled-down rung

    def launch(self) -> None:
        """(Re)start this slot. ``FLEETX_PROCESS_ID`` gives the replica
        its port offset — not a gang rank: elastic members never get a
        coordinator address."""
        self.generation += 1
        env = dict(os.environ, FLEETX_PROCESS_ID=str(self.rank))
        if self.flight_base:
            env["FLEETX_FLIGHT_DIR"] = os.path.join(
                self.flight_base, f"member{self.rank}",
                f"gen{self.generation}")
        self.proc = subprocess.Popen(self.cmd, env=env,
                                     start_new_session=True)
        self.stopped = False

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def signal(self, sig: int) -> None:
        if self.alive():
            try:
                os.killpg(os.getpgid(self.proc.pid), sig)
            except (ProcessLookupError, PermissionError):
                pass


def _read_last_record(path: str) -> dict | None:
    """Last JSONL record of the router's ``--fleet-out`` stream (None
    when the file is missing/empty/torn — the scale rung then holds)."""
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(size - 65536, 0))
            lines = [ln for ln in f.read().splitlines() if ln.strip()]
    except OSError:
        return None
    for ln in reversed(lines):
        try:
            rec = json.loads(ln.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            continue  # torn tail line mid-append
        if isinstance(rec, dict):
            return rec
    return None


def _burn_rate(record: dict | None, slo_target: float) -> float | None:
    """SLO error-budget burn rate from one fleet record: how fast the
    fleet is spending its ``1 - target`` budget (1.0 = exactly on
    budget, >1 = burning, 0 = full attainment). None when the record
    carries no attainment (no completed requests in the window)."""
    if not record:
        return None
    att = record.get("slo_attainment")
    if not isinstance(att, (int, float)) or isinstance(att, bool):
        return None
    budget = max(1.0 - float(slo_target), 1e-6)
    return max(1.0 - float(att), 0.0) / budget


class _ElasticEvents:
    """Append-only JSONL of supervisor decisions (``--events-out``) —
    the drill reads launches/restarts/scale moves off this stream."""

    def __init__(self, path: str | None):
        self.path = path

    def emit(self, event: str, **data) -> None:
        """One decision: its ``[supervise]`` line on stderr and, with
        ``--events-out``, its JSONL record."""
        print(f"[supervise] {event} "
              + " ".join(f"{k}={v}" for k, v in data.items()),
              file=sys.stderr)
        if not self.path:
            return
        rec = {"ts": time.time(), "event": event, **data}
        try:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        except OSError:
            pass  # evidence stream must never kill the control loop


def _run_elastic(args, cmd: list, clean_codes: set,
                 forwarded: dict, members: list) -> int:
    """Elastic serving supervision loop (``--elastic``).

    Invariants: a crashed member restarts alone with per-member
    exponential backoff; a preemption/rc-0 exit retires its rung; the
    live count never intentionally drops below ``--min-healthy`` and
    the supervisor exits 1 when crashes make the gate unreachable; the
    scale rung moves one member at a time on sustained SLO burn-rate
    evidence from the router's fleet records.
    """
    events = _ElasticEvents(args.events_out)
    desired = len(members)
    burn_high = 0  # consecutive windows over budget
    burn_zero = 0  # consecutive windows at full attainment
    last_scale_check = time.monotonic()
    for m in members:
        m.launch()
        events.emit("launch", member=m.rank, pid=m.proc.pid)

    # ---- launch gate: min-healthy must come up (and stay up through
    # the settle window) before this supervisor calls the fleet live
    gate_deadline = time.monotonic() + args.gate_timeout
    while time.monotonic() < gate_deadline:
        if forwarded["sig"] is not None:
            break
        if sum(m.alive() for m in members) >= args.min_healthy:
            events.emit("gate_passed",
                        healthy=sum(m.alive() for m in members),
                        min_healthy=args.min_healthy)
            break
        time.sleep(0.2)
    else:
        events.emit("gate_failed",
                    healthy=sum(m.alive() for m in members),
                    min_healthy=args.min_healthy)
        for m in members:
            m.signal(signal.SIGTERM)
        return 1

    while True:
        now = time.monotonic()
        if forwarded["sig"] is not None:
            # operator/scheduler stop: drain every live member and wait
            for m in members:
                m.signal(forwarded["sig"])
            deadline = now + args.grace
            while any(m.alive() for m in members) and \
                    time.monotonic() < deadline:
                time.sleep(0.2)
            for m in members:
                if m.alive():
                    m.signal(signal.SIGKILL)
            events.emit("stopped", signal=forwarded["sig"])
            return 0

        # ---- individual restart path (the anti-gang): classify exits
        for m in members:
            if m.proc is None or m.alive() or m.stopped:
                continue
            rc = m.proc.returncode
            if rc in clean_codes:
                # graceful drain (scale-down, preemption, clean stop):
                # the rung retires; scale-up may relaunch it later
                m.stopped = True
                events.emit("retired", member=m.rank, rc=rc)
                continue
            m.restarts += 1
            if m.restarts > args.max_restart:
                m.stopped = True
                events.emit("gave_up", member=m.rank,
                            restarts=m.restarts - 1, rc=rc)
                continue
            backoff = args.backoff * (2 ** (m.restarts - 1))
            m.next_launch_at = now + backoff
            m.proc = None
            events.emit("crash", member=m.rank, rc=_shell_code(rc),
                        restart_in_s=round(backoff, 2),
                        attempt=m.restarts)
        for m in members:
            if m.proc is None and not m.stopped \
                    and now >= m.next_launch_at:
                live = sum(x.alive() for x in members)
                if live >= desired:
                    continue  # rung shrank while this slot backed off
                m.launch()
                events.emit("restart", member=m.rank, pid=m.proc.pid,
                            attempt=m.restarts)

        # ---- min-healthy trip: count slots that can still serve
        viable = sum(1 for m in members
                     if m.alive() or (m.proc is None and not m.stopped))
        recoverable = viable + sum(1 for m in members
                                   if m.stopped and
                                   m.restarts <= args.max_restart)
        if recoverable < args.min_healthy:
            events.emit("below_min_healthy", viable=viable,
                        min_healthy=args.min_healthy)
            for m in members:
                m.signal(signal.SIGTERM)
            return 1

        # ---- scale rung: one member per sustained burn-rate signal
        if args.fleet_records and \
                now - last_scale_check >= args.scale_interval:
            last_scale_check = now
            burn = _burn_rate(_read_last_record(args.fleet_records),
                              args.slo_target)
            if burn is None:
                pass  # no attainment evidence — hold the rung
            elif burn > 1.0:
                burn_high, burn_zero = burn_high + 1, 0
            elif burn == 0.0:
                burn_zero, burn_high = burn_zero + 1, 0
            else:
                burn_high = burn_zero = 0
            if burn_high >= args.scale_window and desired < len(members):
                desired += 1
                burn_high = 0
                stopped = [m for m in members
                           if m.stopped or m.proc is None]
                if stopped:
                    m = min(stopped, key=lambda x: x.rank)
                    m.restarts = 0
                    m.launch()
                    events.emit("scale_up", member=m.rank,
                                desired=desired, burn_rate=round(burn, 3))
            if burn_zero >= args.scale_window and \
                    desired > args.min_healthy:
                desired -= 1
                burn_zero = 0
                live = [m for m in members if m.alive()]
                if len(live) > args.min_healthy:
                    m = max(live, key=lambda x: x.rank)
                    m.stopped = True  # retire BEFORE the drain lands
                    m.signal(signal.SIGTERM)
                    events.emit("scale_down", member=m.rank,
                                desired=desired)
        time.sleep(0.2)


def main(argv=None) -> int:
    """Supervisor entry point; returns the process exit code."""
    parser = argparse.ArgumentParser(
        prog="python -m fleetx_tpu_torch.tools.supervise",
        description="fleetx gang supervisor")
    parser.add_argument("--max-restart", type=int, default=3,
                        help="gang restarts after a crash (reference "
                             "launcher default: 3)")
    parser.add_argument("--backoff", type=float, default=5.0,
                        help="seconds to wait before a restart")
    parser.add_argument("--num-procs", type=int, default=1,
                        help="gang size: >1 launches a gang against a "
                             "local coordinator")
    parser.add_argument("--grace", type=float, default=30.0,
                        help="seconds between gang SIGTERM and SIGKILL")
    parser.add_argument("--preemption-code", type=int,
                        default=PREEMPTION_EXIT_CODE,
                        help="exit code treated as a clean preemption stop "
                             "(never restarted); match "
                             "Resilience.preemption.exit_code")
    parser.add_argument("--preflight", action="store_true",
                        help="run a compute+digest self-test per member "
                             "BEFORE forming the gang; refuse to launch "
                             f"(exit {PREFLIGHT_EXIT_CODE}) with a failing "
                             "host, naming it")
    parser.add_argument("--preflight-timeout", type=float, default=120.0,
                        help="seconds each preflight self-test may take")
    parser.add_argument("--preflight-device", default=None,
                        help="the device the preflight self-test runs on "
                             "(default: cuda)")
    parser.add_argument("--flight-dir", default=None,
                        help="base directory for crash flight-recorder "
                             "dumps; each member gets a per-rank, "
                             "per-generation FLEETX_FLIGHT_DIR under it "
                             "(default: $FLEETX_FLIGHT_DIR or "
                             "./flight_recorder)")
    parser.add_argument("--elastic", action="store_true",
                        help="serving mode: members restart individually "
                             "with backoff instead of gang-restarting "
                             "(they share no collective)")
    parser.add_argument("--min-healthy", type=int, default=1,
                        help="elastic: launch gate + floor — the live "
                             "member count the fleet must reach and hold")
    parser.add_argument("--gate-timeout", type=float, default=120.0,
                        help="elastic: seconds the launch gate waits for "
                             "--min-healthy members to come up")
    parser.add_argument("--fleet-records", default=None,
                        help="elastic: the router's --fleet-out JSONL; "
                             "its slo_attainment drives the scale rung")
    parser.add_argument("--slo-target", type=float, default=0.99,
                        help="elastic: attainment target whose error "
                             "budget the burn rate is measured against")
    parser.add_argument("--scale-interval", type=float, default=2.0,
                        help="elastic: seconds between burn-rate checks")
    parser.add_argument("--scale-window", type=int, default=3,
                        help="elastic: consecutive over/under-budget "
                             "checks before the rung moves one member")
    parser.add_argument("--events-out", default=None,
                        help="elastic: append supervisor decision events "
                             "(launch/crash/restart/scale) as JSONL here")
    parser.add_argument("cmd", nargs=argparse.REMAINDER,
                        help="-- followed by the training command")
    args = parser.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd[:1] == ["--"] else args.cmd
    if not cmd:
        parser.error("no command given (expected: -- python -m "
                     "fleetx_tpu_torch.tools.train ...)")
    clean_codes = {0, args.preemption_code}

    if args.preflight:
        failures = _preflight(args.num_procs, args.preflight_timeout,
                              args.preflight_device)
        if failures:
            for member, why, tail in failures:
                print(f"[supervise] preflight FAILED for gang member "
                      f"{member} ({why}): {tail}", file=sys.stderr)
            print(f"[supervise] refusing to launch: {len(failures)} of "
                  f"{args.num_procs} members failed preflight",
                  file=sys.stderr)
            return PREFLIGHT_EXIT_CODE
        print(f"[supervise] preflight passed on all {args.num_procs} "
              f"members", file=sys.stderr)

    flight_base = (args.flight_dir
                   or os.environ.get("FLEETX_FLIGHT_DIR")
                   or "./flight_recorder")

    if args.elastic:
        assert 1 <= args.min_healthy <= args.num_procs, \
            "--min-healthy must be within [1, --num-procs]"
        members = [Member(cmd, rank, flight_base)
                   for rank in range(args.num_procs)]
        forwarded = {"sig": None}

        def _note(signum, frame):
            # elastic members are signaled by the control loop itself —
            # the handler only records the stop ask
            forwarded["sig"] = signum
            print(f"[supervise] signal {signum} — draining the fleet",
                  file=sys.stderr)

        previous = {s: signal.signal(s, _note)
                    for s in (signal.SIGTERM, signal.SIGINT)}
        try:
            return _run_elastic(args, cmd, clean_codes, forwarded,
                                members)
        finally:
            for s, h in previous.items():
                signal.signal(s, h)

    gang = Gang(cmd, args.num_procs, flight_base=flight_base)
    forwarded = {"sig": None}

    def _forward(signum, frame):
        """Relay the operator's/scheduler's signal to the gang and let the
        monitor loop wait for the graceful (emergency-checkpoint) exit."""
        forwarded["sig"] = signum
        # snapshot of who was visible at delivery: a member spawned
        # mid-launch after this point never saw the signal, and _run must
        # deliver to it exactly once (a SECOND signal to a member that
        # already got one forces its immediate death, skipping the
        # emergency checkpoint)
        forwarded["signaled"] = list(gang.procs)
        print(f"[supervise] forwarding signal {signum} to the gang",
              file=sys.stderr)
        gang.signal_all(signum)

    previous = {s: signal.signal(s, _forward)
                for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        rc = _run(gang, args, clean_codes, forwarded)
    finally:
        for s, h in previous.items():
            signal.signal(s, h)
    return rc


def _shell_code(rc: int) -> int:
    """Map a Popen returncode to a shell exit status (128+N for signals)
    — ``sys.exit(-9)`` would otherwise truncate to 247, not 137."""
    return 128 - rc if rc < 0 else rc


def _report_flights(gang: Gang) -> None:
    """Name the generation's flight dumps after an abnormal stop — the
    survivors' evidence a gang kill would otherwise bury under the next
    generation's logs."""
    flights = gang.collect_flights()
    if not flights:
        return
    print(f"[supervise] flight-recorder dumps (generation "
          f"{gang.generation}):", file=sys.stderr)
    for path in flights:
        print(f"[supervise]   {path}", file=sys.stderr)
    print(f"[supervise] merge the timeline with: python -m "
          f"fleetx_tpu_torch.tools.postmortem "
          f"{os.path.join(gang.flight_base or '', f'gen{gang.generation}')}",
          file=sys.stderr)


def _run(gang: Gang, args, clean_codes: set, forwarded: dict) -> int:
    """Launch/monitor/restart loop; returns the supervisor exit code."""
    rc = 1
    for attempt in range(args.max_restart + 1):
        if attempt:
            print(f"[supervise] restart {attempt}/{args.max_restart} "
                  f"(resuming from last checkpoint) ...", file=sys.stderr)
            time.sleep(args.backoff)
        if forwarded["sig"] is not None:
            # signal arrived before this generation launched (including
            # DURING the backoff sleep — checking only at loop top raised
            # a fresh gang on a machine that was just told to stop): the
            # previous gang is already down, do not start another
            return _shell_code(rc)
        gang.launch()
        if forwarded["sig"] is not None:
            # landed while launch was mid-spawn: the handler signaled the
            # members it could see at delivery; hand it to the rest
            # exactly once (never re-signal — a second delivery forces
            # immediate death, skipping the emergency checkpoint)
            seen = forwarded.get("signaled") or []
            for p in gang.procs:
                if p not in seen and p.poll() is None:
                    try:
                        os.killpg(os.getpgid(p.pid), forwarded["sig"])
                    except (ProcessLookupError, PermissionError):
                        pass
        crashed = None
        while True:
            exited = gang.poll()
            if forwarded["sig"] is not None:
                # a forwarded signal means the machine/operator wants us
                # gone: wait for the graceful exits (the trainer is
                # emergency-checkpointing), never restart
                if not gang.wait_all(args.grace):
                    gang.kill_all(args.grace)
                rcs = gang.returncodes()
                print(f"[supervise] gang stopped after signal "
                      f"{forwarded['sig']} (rcs={rcs})", file=sys.stderr)
                # a killed/crashed member must not be masked by a
                # sibling's clean rc 0 — the outer scheduler needs to know
                # an emergency checkpoint may be incomplete; negative rcs
                # (signal kills) map to the shell's 128+N convention, and a
                # member still alive after SIGKILL (returncode None — stuck
                # in uninterruptible I/O) counts as SIGKILLed, not clean
                bad = [r for r in rcs if r != 0]
                crashed = [r for r in bad if r is None or r not in clean_codes]
                if crashed:
                    rc = next((r for r in crashed if r is not None), None)
                    if rc is None:
                        print("[supervise] gang member still running after "
                              "SIGKILL — reporting failure", file=sys.stderr)
                        rc = -signal.SIGKILL
                    _report_flights(gang)
                else:
                    rc = bad[0] if bad else 0
                return _shell_code(rc)
            crashed = next((r for r in exited.values()
                            if r not in clean_codes), None)
            if crashed is not None or len(exited) == gang.num_procs:
                break
            time.sleep(0.2)
        if crashed is None:
            rcs = gang.returncodes()
            if any(r == args.preemption_code for r in rcs):
                print(f"[supervise] gang preempted cleanly (rc="
                      f"{args.preemption_code}) — not restarting; re-run "
                      f"to resume from the emergency checkpoint",
                      file=sys.stderr)
                return args.preemption_code
            return 0
        rc = crashed
        print(f"[supervise] command exited rc={rc}", file=sys.stderr)
        # a gang cannot shrink around a lost member: tear the whole
        # generation down before the restart brings N fresh processes up
        gang.kill_all(args.grace)
        # collect the survivors' flight dumps NOW, while the generation's
        # identity is known — the restart reuses the base dir with a new
        # generation suffix, so nothing is overwritten either way
        _report_flights(gang)
    print(f"[supervise] giving up after {args.max_restart} restarts",
          file=sys.stderr)
    return _shell_code(rc)


if __name__ == "__main__":
    sys.exit(main())
