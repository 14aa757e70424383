"""Port parity: the port's supervisor (``python -m
fleetx_tpu_torch.tools.supervise``) against the repository's
``tools/supervise.py`` on the stub-child scenarios of
``tests/test_zz_multihost.py`` and the preflight of
``tests/test_zz_integrity.py``, the preflight selftest
(``resilience/integrity.selftest``) against the JAX module's, and the
``FLEETX_FAULT_STEP`` restart drill through the port's trainer
(``tests/test_cli.py::test_supervisor_restarts_after_crash`` at the tiny
size).

Tolerances: exit codes, ``[supervise]`` lines (paths, pids and the
post-mortem command normalised), elastic events, report keys and
checkpoint steps are equal.
"""

import argparse
import importlib.util
import json
import os
import re
import signal
import subprocess
import sys
import time

import pytest

from fleetx_tpu.resilience import integrity as j_integrity
from fleetx_tpu_torch.core import checkpoint as C
from fleetx_tpu_torch.resilience import integrity
from fleetx_tpu_torch.tools import supervise as port_sup

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT_TOOL = os.path.join(REPO, "tools", "supervise.py")
#: the two supervisors' command lines
TOOLS = {"jax": [sys.executable, ROOT_TOOL],
         "port": [sys.executable, "-m", "fleetx_tpu_torch.tools.supervise"]}
SYNTH_YAML = os.path.join(REPO, "fleetx_tpu", "configs", "nlp", "gpt",
                          "pretrain_gpt_345M_synthetic.yaml")
TINY = ["Engine.logging_freq=1", "Model.num_layers=2",
        "Model.hidden_size=128", "Model.num_attention_heads=2",
        "Model.vocab_size=256", "Model.max_position_embeddings=128",
        "Global.max_seq_len=128", "Model.dtype=float32",
        "Global.global_batch_size=2", "Global.local_batch_size=2",
        "Global.micro_batch_size=2", "Data.Train.dataset.num_samples=32",
        "Data.Train.loader.prefetch=0", "Engine.eval_freq=0"]


def _env(**extra) -> dict:
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("FLEETX_SELFTEST_FORCE_FAIL", None)
    env.update(extra)
    return env


def _start(side: str, extra_args: list, cmd: list, env=None):
    return subprocess.Popen(TOOLS[side] + extra_args + ["--"] + cmd,
                            cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env=env or _env())


def _finish(proc, timeout_s=120) -> tuple:
    """Wait for a supervisor; on a timeout SIGTERM it (it forwards to its
    children) and fail."""
    try:
        out, err = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        proc.terminate()
        out, err = proc.communicate(timeout=60)
        pytest.fail(f"supervisor exceeded {timeout_s}s\n{err[-2000:]}")
    return proc.returncode, out, err


def _supervise(side: str, extra_args: list, cmd: list, timeout_s=120,
               env=None) -> tuple:
    """Run one supervisor to completion."""
    return _finish(_start(side, extra_args, cmd, env), timeout_s)


def _lines(err: str, tmp) -> list:
    """The ``[supervise]`` lines, the per-test paths and the post-mortem
    command (each tool names its own) normalised."""
    out = []
    for line in err.splitlines():
        if not line.startswith("[supervise]"):
            continue
        line = line.replace(str(tmp), "<tmp>")
        line = line.replace("python -m fleetx_tpu_torch.tools.postmortem",
                            "<postmortem>")
        line = line.replace("python tools/postmortem.py", "<postmortem>")
        out.append(re.sub(r"pid=\d+", "pid=<pid>", line))
    return out


CRASH_ONCE = ("import os, sys\n"
              "m = sys.argv[1]\n"
              "if os.path.exists(m):\n"
              "    sys.exit(0)\n"
              "open(m, 'w').write('x')\n"
              "sys.exit(1)\n")
FLIGHT_LOG = ("import os, sys\n"
              "rank = os.environ.get('FLEETX_PROCESS_ID', '0')\n"
              "with open(sys.argv[2] + rank, 'a') as f:\n"
              "    f.write(os.environ.get('FLEETX_FLIGHT_DIR', '') + '\\n')\n"
              "m = sys.argv[1]\n"
              "if os.path.exists(m):\n"
              "    sys.exit(0)\n"
              "open(m, 'w').write('x')\n"
              "sys.exit(1)\n")
#: name → (supervisor args, child -c script, child args as a function of
#: the test's directory, the exit code both must give)
SCENARIOS = {
    "crash_then_succeed": (["--max-restart", "2", "--backoff", "0"],
                           CRASH_ONCE, lambda d: [str(d / "m")], 0),
    "flight_dir_per_rank_and_generation": (
        ["--num-procs", "2", "--max-restart", "2", "--backoff", "0",
         "--grace", "5"], FLIGHT_LOG,
        lambda d: [str(d / "m"), str(d / "envs")], 0),
    "give_up_maps_signal_exit": (
        ["--max-restart", "1", "--backoff", "0"],
        "import os, signal; os.kill(os.getpid(), signal.SIGKILL)",
        lambda d: [], 128 + signal.SIGKILL),
    "preemption_code_not_restarted": (
        ["--max-restart", "2", "--backoff", "0", "--preemption-code", "75"],
        "import sys; sys.exit(75)", lambda d: [], 75),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_stub_child_scenarios_equal_the_root_supervisor(name, tmp_path):
    args, script, child, rc = SCENARIOS[name]
    got, procs = {}, {}
    for side in TOOLS:  # both at once
        d = tmp_path / side
        d.mkdir()
        flight = ["--flight-dir", str(d / "fl")] if "--num-procs" in args \
            else []
        procs[side] = _start(side, args + flight,
                             [sys.executable, "-c", script] + child(d))
    for side, proc in procs.items():
        d = tmp_path / side
        code, _, err = _finish(proc)
        assert code == rc, err[-1500:]
        got[side] = _lines(err, d)
        if name == "flight_dir_per_rank_and_generation":
            gens0 = (d / "envs0").read_text().splitlines()
            assert gens0[0] == str(d / "fl" / "gen0" / "rank0")
            assert gens0[-1] == str(d / "fl" / "gen1" / "rank0")
            gens1 = (d / "envs1").read_text().splitlines()
            assert gens1[-1] == str(d / "fl" / "gen1" / "rank1")
    assert got["port"] == got["jax"]
    assert got["port"], "no [supervise] line"


FORWARD = ("import signal, sys, time\n"
           "flag = sys.argv[1]\n"
           "def h(s, f):\n"
           "    open(flag, 'w').write('got\\n')\n"
           "    sys.exit(0)\n"
           "signal.signal(signal.SIGTERM, h)\n"
           "open(flag + '.ready', 'w').write('r')\n"
           "for _ in range(600):\n"
           "    time.sleep(0.1)\n"
           "sys.exit(9)\n")
KILLED = ("import os, signal, sys, time\n"
          "rank = os.environ.get('FLEETX_PROCESS_ID', '0')\n"
          "if rank == '0':\n"
          "    signal.signal(signal.SIGTERM, lambda s, f: sys.exit(0))\n"
          "else:\n"
          "    signal.signal(signal.SIGTERM, signal.SIG_IGN)\n"
          "open(sys.argv[1] + '.ready' + rank, 'w').write('r')\n"
          "for _ in range(600):\n"
          "    time.sleep(0.1)\n"
          "sys.exit(9)\n")


@pytest.mark.parametrize("case", ["forward_and_wait", "killed_member"])
def test_forwarded_sigterm_equals_the_root_supervisor(case, tmp_path):
    """SIGTERM to the supervisor reaches the children and it waits: the
    graceful child's rc 0; a member that ignores it is SIGKILLed after
    ``--grace`` and reported as 137, not masked by its sibling's 0."""
    got, procs = {}, {}
    for side in TOOLS:  # both at once
        flag = str(tmp_path / f"{side}_f")
        if case == "forward_and_wait":
            args, script = ["--max-restart", "0", "--grace", "20"], FORWARD
            ready = [flag + ".ready"]
        else:
            args = ["--num-procs", "2", "--max-restart", "0", "--grace",
                    "2", "--flight-dir", str(tmp_path / f"{side}_fl")]
            script, ready = KILLED, [flag + ".ready0", flag + ".ready1"]
        procs[side] = (_start(side, args, [sys.executable, "-c", script,
                                           flag]), flag, ready)
    for side, (proc, flag, ready) in procs.items():
        deadline = time.monotonic() + 60
        while not all(os.path.exists(r) for r in ready):
            assert time.monotonic() < deadline, "children never came up"
            assert proc.poll() is None, proc.communicate()[1][-1000:]
            time.sleep(0.05)
        os.kill(proc.pid, signal.SIGTERM)
    for side, (proc, flag, ready) in procs.items():
        _, err = proc.communicate(timeout=60)
        if case == "forward_and_wait":
            assert os.path.exists(flag) and proc.returncode == 0, err
        else:
            assert proc.returncode == 137, err[-1500:]
        got[side] = (proc.returncode, _lines(err, tmp_path))
    assert got["port"][0] == got["jax"][0]
    # the same lines, the rcs' order aside (it follows the exit order)
    assert [re.sub(r"rcs=\[.*\]", "rcs", l) for l in got["port"][1]] == \
        [re.sub(r"rcs=\[.*\]", "rcs", l) for l in got["jax"][1]]


def _root_module():
    spec = importlib.util.spec_from_file_location("_root_supervise",
                                                  ROOT_TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_run_loop_edges_equal_the_root_supervisor():
    """``_run`` on stand-in gangs (``tests/test_zz_multihost.py``): a
    member alive after SIGKILL is reported as 137; a signal before the
    launch raises no gang; ``_burn_rate`` and ``_shell_code`` agree."""
    root = _root_module()

    class _Stuck:
        num_procs = 2
        procs = []

        def __init__(self, fwd):
            self.fwd = fwd

        def launch(self):
            self.fwd["sig"] = signal.SIGTERM

        def poll(self):
            return {}

        def wait_all(self, timeout):
            return False

        def kill_all(self, grace):
            pass

        def collect_flights(self):
            return []

        def returncodes(self):
            return [0, None]

    class _NeverLaunch:
        num_procs = 1
        procs = []

        def launch(self):
            raise AssertionError("must not launch after a signal")

    args = argparse.Namespace(max_restart=0, backoff=0.0, grace=0.01,
                              num_procs=2, preemption_code=75)
    for mod in (root, port_sup):
        fwd = {"sig": None}
        assert mod._run(_Stuck(fwd), args, {0, 75}, fwd) == 137
        args2 = argparse.Namespace(max_restart=2, backoff=0.0, grace=0.01,
                                   num_procs=1, preemption_code=75)
        assert mod._run(_NeverLaunch(), args2, {0, 75},
                        {"sig": signal.SIGTERM, "signaled": []}) == 1
    for rec in (None, {}, {"slo_attainment": 0.95}, {"slo_attainment": 1},
                {"slo_attainment": True}, {"slo_attainment": 0.999}):
        assert port_sup._burn_rate(rec, 0.99) == root._burn_rate(rec, 0.99)
    for rc in (0, 1, -9, -15, 75):
        assert port_sup._shell_code(rc) == root._shell_code(rc)


ELASTIC_CHILD = ("import os, signal, sys, time\n"
                 "rank = os.environ['FLEETX_PROCESS_ID']\n"
                 "m = sys.argv[1] + rank\n"
                 "if rank == '0' and not os.path.exists(m):\n"
                 "    open(m, 'w').write('x')\n"
                 "    sys.exit(3)\n"
                 "signal.signal(signal.SIGTERM, lambda s, f: sys.exit(0))\n"
                 "open(m + '.up', 'a').write('u')\n"
                 "for _ in range(600):\n"
                 "    time.sleep(0.1)\n")


def test_elastic_member_restarts_alone_like_the_root_supervisor(tmp_path):
    """``--elastic``: a crashed member restarts alone with backoff, its
    sibling untouched; SIGTERM drains the fleet with rc 0. The events
    stream is the root supervisor's."""
    got, procs = {}, {}
    for side in TOOLS:  # both at once
        d = tmp_path / side
        d.mkdir()
        procs[side] = _start(side, [
            "--elastic", "--num-procs", "2", "--min-healthy", "1",
            "--backoff", "0.2", "--max-restart", "2", "--grace", "10",
            "--events-out", str(d / "events.jsonl"), "--flight-dir",
            str(d / "fl")], [sys.executable, "-c", ELASTIC_CHILD,
                             str(d / "m")])
    for side, proc in procs.items():
        d = tmp_path / side
        events = d / "events.jsonl"
        deadline = time.monotonic() + 60
        while not (os.path.exists(d / "m0.up") and
                   os.path.exists(d / "m1.up")):
            assert time.monotonic() < deadline, "members never came up"
            assert proc.poll() is None, proc.communicate()[1][-1000:]
            time.sleep(0.05)
        os.kill(proc.pid, signal.SIGTERM)
        _, err = proc.communicate(timeout=60)
        assert proc.returncode == 0, err[-1500:]
        recs = [json.loads(l) for l in events.read_text().splitlines()]
        got[side] = [(r["event"], r.get("member")) for r in recs]
        assert (d / "m1.up").read_text() == "u"  # never restarted
    assert got["port"] == got["jax"]
    assert ("crash", 0) in got["port"] and ("restart", 0) in got["port"]


@pytest.mark.parametrize("forced", [None, "", "*", "1", "0"])
def test_selftest_keys_and_force_fail_equal_jax(forced, monkeypatch):
    """The port's selftest on the CPU has the JAX report's keys (and the
    device) and JAX's ``FLEETX_SELFTEST_FORCE_FAIL`` semantics for gang
    member 1."""
    monkeypatch.setenv("FLEETX_PREFLIGHT_MEMBER", "1")
    if forced is None:
        monkeypatch.delenv("FLEETX_SELFTEST_FORCE_FAIL", raising=False)
    else:
        monkeypatch.setenv("FLEETX_SELFTEST_FORCE_FAIL", forced)
    mine = integrity.selftest(size=64, device="cpu")
    want = j_integrity.selftest(size=64)
    assert sorted(mine) == sorted(list(want) + ["device"])
    for key in ("ok", "member", "compute_ok", "crc_ok", "forced_fail"):
        assert mine[key] == want[key], key
    assert mine["device"] == "cpu" and len(set(mine["digests"])) == 1
    assert integrity._SELFTEST_INPUT_CRC == j_integrity._SELFTEST_INPUT_CRC


def test_preflight_gates_the_launch(tmp_path):
    """``--preflight``: healthy members run the command; a member forced
    to fail refuses the launch with 41, named, and the command never runs
    (both supervisors, the same lines)."""
    marker = str(tmp_path / "ran")
    child = [sys.executable, "-c", f"open({marker!r}, 'w').write('x')"]
    code, _, err = _supervise(
        "port", ["--preflight", "--preflight-device", "cpu", "--num-procs",
                 "1", "--max-restart", "0"], child)
    assert code == 0 and os.path.exists(marker), err[-2000:]
    assert "[supervise] preflight passed on all 1 members" in err
    os.remove(marker)
    got, procs = {}, {}
    for side in TOOLS:  # both at once
        args = ["--preflight", "--num-procs", "2", "--max-restart", "0"]
        if side == "port":
            args += ["--preflight-device", "cpu"]
        procs[side] = _start(side, args, child,
                             env=_env(FLEETX_SELFTEST_FORCE_FAIL="1"))
    for side, proc in procs.items():
        code, _, err = _finish(proc)
        assert code == 41, err[-2000:]
        assert not os.path.exists(marker)
        got[side] = [l.split(" (rc=1)")[0] for l in _lines(err, tmp_path)]
    assert got["port"] == got["jax"] == [
        "[supervise] preflight FAILED for gang member 1",
        "[supervise] refusing to launch: 1 of 2 members failed preflight"]


def test_fault_step_restart_drill_through_the_port_trainer(tmp_path):
    """``tests/test_cli.py::test_supervisor_restarts_after_crash`` on the
    port: ``FLEETX_FAULT_STEP=3`` kills the fresh run after step 3 (step 2
    saved), the supervisor restarts it, the retry resumes from step 2 and
    finishes; the newest step is 6."""
    out = str(tmp_path / "output")
    cmd = [sys.executable, "-m", "fleetx_tpu_torch.tools.train", "-c",
           SYNTH_YAML, "--device", "cpu"]
    for o in TINY + ["Engine.max_steps=6", "Engine.save_load.save_steps=2",
                     f"Engine.save_load.output_dir={out}",
                     f"Engine.save_load.ckpt_dir={out}"]:
        cmd += ["-o", o]
    code, stdout, err = _supervise(
        "port", ["--max-restart", "2", "--backoff", "0"], cmd,
        timeout_s=300, env=_env(FLEETX_FAULT_STEP="3"))
    text = stdout + err
    assert code == 0, text[-3000:]
    assert "fault injection: dying at step 3" in text
    assert "[supervise] restart 1/2" in text
    assert "restored checkpoint" in text and "(step 2)" in text
    assert C.latest_step(out) == 6 and C.completed_steps(out) == [2, 4, 6]


def test_a_gang_member_refuses_to_train():
    """A trainer started as a member of a gang of 2 raises naming item
    12: a multi-rank gang is not ported."""
    from fleetx_tpu_torch.tools import train

    env = dict(os.environ, FLEETX_NUM_PROCESSES="2")
    old = os.environ.copy()
    os.environ.update(env)
    try:
        with pytest.raises(NotImplementedError, match="item 12"):
            train.main(["-c", SYNTH_YAML, "--device", "cpu"])
    finally:
        os.environ.clear()
        os.environ.update(old)
