"""Parallel shell-command runner for data preparation (port of
``fleetx_tpu/tools/multiprocess_tool.py``; reference
``ppfleetx/tools/multiprocess_tool.py:49-87``).

Runs a list of shell commands with bounded parallelism and reports
failures — the reference uses it for sharded corpus download/convert jobs;
same contract here. The returned exit codes distinguish every terminal
state a sharded prep job can reach: the command's own code, ``RC_TIMEOUT``
for a per-command deadline kill, and ``RC_CANCELLED`` for commands
``stop_on_error`` cancelled before they started — a cancelled shard needs
a re-run, a timed-out one needs a bigger deadline or a smaller shard, and
conflating them (the old single ``-1``) hid which.
"""

from __future__ import annotations

import os
import signal
import subprocess
from concurrent.futures import ThreadPoolExecutor, as_completed
from typing import Optional

from fleetx_tpu_torch.utils.log import logger

#: command never started: stop_on_error cancelled it while still queued
RC_CANCELLED = -1
#: command killed by its per-command ``timeout`` deadline
RC_TIMEOUT = -2


def run_commands(commands: list[str], num_workers: int = 4,
                 stop_on_error: bool = False,
                 timeout: Optional[float] = None) -> list[int]:
    """Execute shell commands in parallel; returns per-command exit codes.

    ``timeout`` (seconds, per command) kills an overrunning command and
    records ``RC_TIMEOUT`` for it. With ``stop_on_error``, the first
    non-zero exit cancels all not-yet-started commands (``RC_CANCELLED``);
    commands already running are allowed to finish and report their REAL
    code — the old behaviour lumped them in with the failures as ``-1``.
    """
    results: list = [None] * len(commands)

    def run(i: int) -> int:
        # own session so a timeout kill reaches the WHOLE pipeline: with
        # shell=True a plain timeout kills only the shell, and the
        # `wget | tar` grandchildren keep writing the shard after
        # RC_TIMEOUT was reported — the re-run then races the orphan
        proc = subprocess.Popen(commands[i], shell=True,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True,
                                start_new_session=True)
        try:
            _, stderr = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
            proc.communicate()
            logger.error("command timed out after %.0fs: %s", timeout,
                         commands[i])
            return RC_TIMEOUT
        rc = proc.returncode
        if rc < 0:
            # shell killed by signal N: report the 128+N shell convention —
            # a raw negative collides with the RC_* sentinels (SIGINT
            # -> -2 reads as a timeout, SIGHUP -> -1 as a cancellation)
            rc = 128 - rc
        if rc != 0:
            logger.error("command failed (%d): %s\n%s", rc, commands[i],
                         stderr[-500:])
        return rc

    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        futures = {pool.submit(run, i): i for i in range(len(commands))}
        for fut in as_completed(futures):
            results[futures[fut]] = fut.result()
            if stop_on_error and results[futures[fut]] != 0:
                for other in futures:
                    other.cancel()
                break
        # drain: in-flight commands run to completion (pool shutdown joins
        # them) and report their genuine code; only never-started ones are
        # recorded as cancelled
        for fut, i in futures.items():
            if results[i] is None:
                results[i] = RC_CANCELLED if fut.cancelled() else fut.result()
    ok = sum(1 for r in results if r == 0)
    timed_out = sum(1 for r in results if r == RC_TIMEOUT)
    cancelled = sum(1 for r in results if r == RC_CANCELLED)
    failed = len(results) - ok - timed_out - cancelled
    logger.info("ran %d commands: %d ok, %d failed, %d timed out, "
                "%d cancelled", len(commands), ok, failed, timed_out,
                cancelled)
    return results
