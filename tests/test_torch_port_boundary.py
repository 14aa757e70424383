"""The port's boundary: no JAX, no ``fleetx_tpu``, no silent CPU path.

- every ``.py`` under ``fleetx_tpu_torch/`` imports none of ``jax``,
  ``jaxlib``, ``flax``, ``optax``, ``fleetx_tpu`` or ``fleetx_tpu.*``
  (an AST scan, plus a fresh interpreter's ``sys.modules``);
- an engine asked for no device on a host without CUDA raises, and so
  do the training, eval, export, inference and preprocessing CLIs without
  ``--device cpu``;
- config values the slice does not cover raise ``NotImplementedError``;
- a CPU replica started by the real CLI answers over TCP with the
  in-process engine's tokens and drains on SIGTERM with rc 75.
"""

import ast
import json
import os
import signal
import socket
import subprocess
import sys
import time

import pytest
import torch
import yaml

pytestmark = pytest.mark.torch_port


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """This file's tensors are tiny: torch runs them on one intra-op
    thread (its default pool, on cores the other test workers share,
    costs far more than the work). The count is restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "fleetx_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "fleetx_tpu")

MODEL_DICT = dict(vocab_size=97, hidden_size=64, num_layers=2,
                  num_attention_heads=4, max_position_embeddings=64,
                  hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                  dtype="float32", param_dtype="float32")
EOS = 96


def _forbidden(module: str) -> bool:
    """Exact top-level match: ``fleetx_tpu_torch`` is not ``fleetx_tpu``."""
    return module.split(".")[0] in FORBIDDEN


def _port_sources() -> list:
    """Every ``.py`` of the package, and ``chip_smoke.py``."""
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        paths += [os.path.join(root, n) for n in files if n.endswith(".py")]
    return sorted(paths)


def test_the_scan_reaches_every_module_of_the_port():
    scanned = {os.path.relpath(p, REPO) for p in _port_sources()}
    for rel in ("chip_smoke.py",
                "fleetx_tpu_torch/tasks/gpt/generation.py",
                "fleetx_tpu_torch/tools/verify_ckpt.py",
                "fleetx_tpu_torch/core/checkpoint.py",
                "fleetx_tpu_torch/resilience/integrity.py",
                "fleetx_tpu_torch/data/tokenizers/gpt_tokenizer.py",
                "fleetx_tpu_torch/models/gpt/generation.py",
                "fleetx_tpu_torch/data/dataset/eval_dataset.py",
                "fleetx_tpu_torch/core/engine/inference_engine.py",
                "fleetx_tpu_torch/utils/export.py",
                "fleetx_tpu_torch/tools/eval.py",
                "fleetx_tpu_torch/tools/export.py",
                "fleetx_tpu_torch/tools/inference.py",
                "fleetx_tpu_torch/tools/preprocess_data.py",
                "fleetx_tpu_torch/tasks/gpt/inference.py",
                "fleetx_tpu_torch/resilience/__init__.py",
                "fleetx_tpu_torch/resilience/policy.py",
                "fleetx_tpu_torch/resilience/faults.py",
                "fleetx_tpu_torch/resilience/guard.py",
                "fleetx_tpu_torch/resilience/watchdog.py",
                "fleetx_tpu_torch/resilience/coordination.py",
                "fleetx_tpu_torch/parallel/auto_layout.py",
                "fleetx_tpu_torch/ops/save_points.py",
                "fleetx_tpu_torch/tools/auto.py",
                "fleetx_tpu_torch/core/engine/auto_engine.py",
                "fleetx_tpu_torch/core/engine/basic_engine.py",
                "fleetx_tpu_torch/models/ernie/model.py",
                "fleetx_tpu_torch/models/ernie/module.py",
                "fleetx_tpu_torch/models/vision/vit.py",
                "fleetx_tpu_torch/models/vision/loss.py",
                "fleetx_tpu_torch/models/vision/module.py",
                "fleetx_tpu_torch/data/dataset/ernie_dataset.py",
                "fleetx_tpu_torch/data/dataset/vision_dataset.py",
                "fleetx_tpu_torch/data/transforms/preprocess.py",
                "fleetx_tpu_torch/data/sampler/collate.py",
                "fleetx_tpu_torch/models/gpt/moe.py",
                "fleetx_tpu_torch/models/imagen/unet.py",
                "fleetx_tpu_torch/models/imagen/modeling.py",
                "fleetx_tpu_torch/models/imagen/module.py",
                "fleetx_tpu_torch/data/dataset/multimodal_dataset.py",
                "fleetx_tpu_torch/tasks/imagen/generate.py",
                "fleetx_tpu_torch/tools/supervise.py",
                "fleetx_tpu_torch/serving/router.py",
                "fleetx_tpu_torch/data/native/__init__.py",
                "fleetx_tpu_torch/tools/multiprocess_tool.py",
                "fleetx_tpu_torch/parallel/sharding.py",
                "fleetx_tpu_torch/utils/env.py",
                "fleetx_tpu_torch/observability/__init__.py",
                "fleetx_tpu_torch/observability/gang.py",
                "fleetx_tpu_torch/resilience/preemption.py",
                "fleetx_tpu_torch/core/engine/eager_engine.py",
                "fleetx_tpu_torch/tools/train.py"):
        assert rel in scanned, rel


def test_port_sources_import_no_jax_and_no_reference_package():
    offenders = []
    n_files = 0
    for path in _port_sources():
        n_files += 1
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            offenders += [f"{os.path.relpath(path, REPO)}:{node.lineno} "
                          f"{m}" for m in mods if _forbidden(m)]
    assert n_files >= 15
    assert not offenders, offenders
    assert not _forbidden("fleetx_tpu_torch.serving")
    assert _forbidden("fleetx_tpu.serving") and _forbidden("jax.numpy")


def test_entry_points_load_no_jax_modules():
    code = ("import sys, json\n"
            "import fleetx_tpu_torch.tools.serve\n"
            "import fleetx_tpu_torch.tools.train\n"
            "import fleetx_tpu_torch.core.engine\n"
            "import fleetx_tpu_torch.serving.engine\n"
            "import fleetx_tpu_torch.serving.bench\n"
            "import fleetx_tpu_torch.tasks.gpt.generation\n"
            "import fleetx_tpu_torch.tools.verify_ckpt\n"
            "import fleetx_tpu_torch.core.checkpoint\n"
            "import fleetx_tpu_torch.data.tokenizers.gpt_tokenizer\n"
            "import fleetx_tpu_torch.data.dataset.eval_dataset\n"
            "import fleetx_tpu_torch.core.engine.inference_engine\n"
            "import fleetx_tpu_torch.parallel.sharding\n"
            "import fleetx_tpu_torch.core.engine.eager_engine\n"
            "import fleetx_tpu_torch.utils.export\n"
            "import fleetx_tpu_torch.tools.eval\n"
            "import fleetx_tpu_torch.tools.export\n"
            "import fleetx_tpu_torch.tools.inference\n"
            "import fleetx_tpu_torch.tools.preprocess_data\n"
            "import fleetx_tpu_torch.tasks.gpt.inference\n"
            "import fleetx_tpu_torch.resilience\n"
            "import fleetx_tpu_torch.tools.auto\n"
            "import fleetx_tpu_torch.parallel.auto_layout\n"
            "import fleetx_tpu_torch.core.engine.auto_engine\n"
            "import fleetx_tpu_torch.core.engine.basic_engine\n"
            "import fleetx_tpu_torch.models.ernie.module\n"
            "import fleetx_tpu_torch.models.vision.module\n"
            "import fleetx_tpu_torch.data.sampler.collate\n"
            "import fleetx_tpu_torch.models.gpt.moe\n"
            "import fleetx_tpu_torch.models.imagen.module\n"
            "import fleetx_tpu_torch.data.dataset.multimodal_dataset\n"
            "import fleetx_tpu_torch.tasks.imagen.generate\n"
            "import fleetx_tpu_torch.tools.supervise\n"
            "import fleetx_tpu_torch.serving.router\n"
            "import fleetx_tpu_torch.data.native\n"
            "import fleetx_tpu_torch.tools.multiprocess_tool\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "fleetx_tpu_torch.serving.engine" in loaded
    assert "fleetx_tpu_torch.core.engine.eager_engine" in loaded
    assert "fleetx_tpu_torch.tasks.gpt.generation" in loaded
    assert "fleetx_tpu_torch.core.engine.inference_engine" in loaded
    assert "fleetx_tpu_torch.tasks.gpt.inference" in loaded
    assert "fleetx_tpu_torch.parallel.auto_layout" in loaded
    for name in ("policy", "faults", "guard", "watchdog", "coordination"):
        assert f"fleetx_tpu_torch.resilience.{name}" in loaded, name
    for name in ("models.ernie.model", "models.vision.vit",
                 "data.dataset.vision_dataset", "data.transforms.preprocess"):
        assert f"fleetx_tpu_torch.{name}" in loaded, name
    assert "PIL" not in loaded  # the card's machine has no Pillow
    assert "regex" not in loaded  # the card's machine has no regex
    assert [m for m in loaded if _forbidden(m)] == []


def test_the_mesh_modules_and_a_rank_process_load_no_jax():
    """``parallel/`` and ``utils/env.py`` are in the scan, and a rank of a
    two-rank gloo world (``init_dist_env``, ``build_mesh``, the serving
    and inference modules) has no JAX module in its ``sys.modules``."""
    scanned = {os.path.relpath(p, PKG) for p in _port_sources()}
    for name in ("parallel/mesh.py", "parallel/rules.py",
                 "parallel/sharding.py", "utils/env.py"):
        assert name in scanned, name
    code = ("import sys, json\n"
            "from fleetx_tpu_torch.utils.env import init_dist_env\n"
            "from fleetx_tpu_torch.parallel.mesh import build_mesh, psum\n"
            "import fleetx_tpu_torch.tools.serve, torch\n"
            "import fleetx_tpu_torch.core.engine.inference_engine\n"
            "import fleetx_tpu_torch.parallel.sharding\n"
            "import fleetx_tpu_torch.core.engine.eager_engine\n"
            "from fleetx_tpu_torch.resilience.coordination import "
            "get_coordinator\n"
            "init_dist_env(device='cpu')\n"
            "mesh = build_mesh({'dp_degree': 2})\n"
            "assert psum(torch.ones(1), 'data', mesh).item() == 2.0\n"
            "assert get_coordinator().any_flag('probe', mesh.rank == 1)\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-c", code], cwd=REPO, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                 FLEETX_COORDINATOR=f"127.0.0.1:{port}",
                 FLEETX_NUM_PROCESSES="2", FLEETX_PROCESS_ID=str(rank)))
        for rank in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        loaded = json.loads(out.strip().splitlines()[-1])
        assert "torch.distributed" in loaded
        assert [m for m in loaded if _forbidden(m)] == []


def test_the_supervisor_is_stdlib_only():
    """``python -m fleetx_tpu_torch.tools.supervise`` loads neither torch
    nor JAX (its preflight runs the selftest in a child process) and its
    ``--help`` runs."""
    code = ("import sys, json\n"
            "import fleetx_tpu_torch.tools.supervise\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "torch" not in loaded and "numpy" not in loaded
    assert [m for m in loaded if _forbidden(m)] == []
    helped = subprocess.run(
        [sys.executable, "-m", "fleetx_tpu_torch.tools.supervise", "--help"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=60)
    assert helped.returncode == 0 and "--preflight-device" in helped.stdout


def test_a_cuda_device_without_an_index_gets_the_current_one(monkeypatch):
    """``cuda`` resolves to ``cuda:<current>``, the device tensors made on
    it report: the trainer compares its parameters' device with it."""
    from fleetx_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert resolve_device(None) == torch.device("cuda", 0)
    assert resolve_device("cuda") == torch.device("cuda", 0)
    assert resolve_device("cuda:0") == torch.device("cuda", 0)
    assert resolve_device("cpu") == torch.device("cpu")


def test_train_cli_without_device_raises_when_no_cuda(no_device_runs):
    """``python -m fleetx_tpu_torch.tools.train`` defaults to cuda: on a
    host without a GPU it fails instead of training on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = no_device_runs["tools.train"]
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert "[train]" not in out.stderr


#: the slice-8 entry points and the arguments that reach their device
#: choice; each defaults to cuda
_SLICE8_CLIS = {
    "tools.eval": ["-c", "fleetx_tpu/configs/nlp/gpt/"
                   "eval_gpt_345M_single_card.yaml"],
    "tools.export": ["-c", "fleetx_tpu/configs/nlp/gpt/"
                     "inference_gpt_345M_single_card.yaml"],
    "tools.inference": ["-c", "fleetx_tpu/configs/nlp/gpt/"
                        "inference_gpt_345M_single_card.yaml"],
    "tasks.gpt.inference": ["-c", "fleetx_tpu/configs/nlp/gpt/"
                            "inference_gpt_345M_single_card.yaml"],
    "tools.preprocess_data": ["--input", "README.md", "--tokenizer",
                              "no_such_dir", "--output-prefix",
                              "no_such_prefix"],
    # the auto-layout entry point: the planner's budget is the card's
    # memory, so it stops at the device too
    "tools.auto": ["-c", "fleetx_tpu/configs/nlp/gpt/auto/"
                   "pretrain_gpt_1.3B_single_card.yaml"],
}


@pytest.fixture(scope="module")
def no_device_runs():
    """Every entry point of the no-GPU tests run without ``--device``, the
    processes started at once (each is a torch import and a refusal):
    module → the finished process. Nothing runs where a card is present."""
    if torch.cuda.is_available():
        return {}
    yaml_path = os.path.join(REPO, "fleetx_tpu", "configs", "nlp", "gpt",
                             "pretrain_gpt_345M_synthetic.yaml")
    argv = dict(_SLICE8_CLIS)
    argv["tools.train"] = ["-c", yaml_path, "-o", "Model.num_layers=1",
                           "-o", "Engine.max_steps=1"]
    procs = {cli: subprocess.Popen(
        [sys.executable, "-m", f"fleetx_tpu_torch.{cli}"] + args, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for cli, args in argv.items()}
    out = {}
    try:
        for cli, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=120)
            out[cli] = subprocess.CompletedProcess(proc.args, proc.returncode,
                                                   stdout, stderr)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return out


@pytest.mark.parametrize("cli", sorted(_SLICE8_CLIS))
def test_slice8_clis_without_device_raise_when_no_cuda(cli, no_device_runs):
    """Each eval / export / inference / preprocessing entry point defaults
    to cuda: on a host without a GPU it fails before any work."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = no_device_runs[cli]
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr, out.stderr[-2000:]
    assert not os.path.exists(os.path.join(REPO, "no_such_prefix_ids.npy"))


def _tiny_cfg(**serving_over):
    serving = dict(max_batch=4, page_size=4, num_pages=33, max_seq_len=32,
                   prefill_chunk=8)
    serving.update(serving_over)
    return {"Model": dict(MODEL_DICT), "Serving": serving,
            "Generation": {"decode_strategy": "greedy_search",
                           "eos_token_id": EOS, "pad_token_id": 0},
            "Global": {"seed": 7}}


def test_engine_without_device_raises_when_no_cuda(monkeypatch):
    from fleetx_tpu_torch.models.gpt.model import config_from_dict, init_params
    from fleetx_tpu_torch.serving.engine import ServingEngine
    from fleetx_tpu_torch.tools.serve import build_engine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = config_from_dict(MODEL_DICT)
    params = init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(cfg, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_engine(_tiny_cfg())
    assert ServingEngine(cfg, params, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("what", ["quantize_decode", "ckpt_dir",
                                  "adapter_dir", "mp_degree", "router"])
def test_uncovered_config_values_raise(what, tmp_path):
    from fleetx_tpu_torch.tools import serve

    cfg = _tiny_cfg()
    if what == "router":
        # ported: the router needs its backends, and a bad Serving.router
        # block is refused before the front binds
        with pytest.raises(SystemExit):
            serve.main(["--router", "-c", "unused.yaml"])
        cfg["Serving"]["router"] = {"hedge_ms": -1}
        path = tmp_path / "bad_router.yaml"
        path.write_text(yaml.safe_dump(cfg))
        with pytest.raises(ValueError, match="Serving.router invalid"):
            serve.main(["--router", "-c", str(path), "--backends",
                        "127.0.0.1:1"])
        return
    if what == "ckpt_dir":
        # the checkpoint loader is ported: a configured checkpoint that is
        # not there is refused, never replaced by seeded weights
        cfg["Serving"][what] = "/x"
        with pytest.raises(FileNotFoundError, match="no completed "
                                                    "checkpoint"):
            serve.build_engine(cfg, device="cpu")
        return
    if what == "quantize_decode":
        # ported: the replica decodes with int8 fake-quant, its kernels
        # quantized once at construction
        plain = serve.build_engine(cfg, device="cpu")
        cfg["Serving"][what] = True
        engine = serve.build_engine(cfg, device="cpu")
        kernel = engine.params["gpt"]["layers"]["attn"]["qkv_kernel"]
        assert engine.serving.quantize_decode and not torch.equal(
            kernel, plain.params["gpt"]["layers"]["attn"]["qkv_kernel"])
        return
    if what == "adapter_dir":
        # the LoRA merge is ported; an adapter without its base
        # checkpoint is refused, never merged into seeded weights
        cfg["Serving"][what] = "/x"
        with pytest.raises(ValueError, match="requires Serving.ckpt_dir"):
            serve.build_engine(cfg, device="cpu")
        return
    # in a world of one rank mp 2 is JAX's world mismatch; pipeline and
    # sequence parallelism wait for distributed training
    cfg["Distributed"] = {"mp_degree": 2}
    with pytest.raises(ValueError, match=r"mesh shape .* != 1 devices"):
        serve.build_engine(cfg, device="cpu")
    for key in ("pp_degree", "seq_degree"):
        cfg["Distributed"] = {key: 2}
        with pytest.raises(NotImplementedError, match="item 12"):
            serve.build_engine(cfg, device="cpu")


def _loopback_available() -> bool:
    try:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
    except OSError:
        return False
    return True


def test_cpu_replica_round_trip_and_sigterm_drain(tmp_path):
    if not _loopback_available():
        pytest.skip("loopback networking unavailable")
    from fleetx_tpu_torch.serving.server import request
    from fleetx_tpu_torch.tools.serve import build_engine

    cfg = _tiny_cfg()
    path = tmp_path / "serving.yaml"
    path.write_text(yaml.safe_dump(cfg))
    ready = tmp_path / "ready.json"
    env = dict(os.environ, PYTHONPATH=REPO,
               FLEETX_FLIGHT_DIR=str(tmp_path / "flight"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "fleetx_tpu_torch.tools.serve", "-c",
         str(path), "--device", "cpu", "--ready-file", str(ready),
         "--metrics-out", str(tmp_path / "metrics.jsonl")],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + 120
        info = None
        while info is None:
            assert proc.poll() is None, f"replica died rc={proc.returncode}"
            assert time.monotonic() < deadline, "replica never became ready"
            if ready.exists():
                try:
                    info = json.loads(ready.read_text())
                except ValueError:
                    pass  # torn write — retry
            time.sleep(0.1)
        addr = ("127.0.0.1", info["port"])
        prompt = [5, 9, 23, 41]
        resp = request(addr, {"id": "t0", "prompt": prompt,
                              "max_new_tokens": 6}, timeout=90)
        engine = build_engine(cfg, device="cpu")
        want = engine.submit(prompt, 6, request_id="t0")
        engine.run_until_drained()
        assert resp["id"] == "t0" and resp["tokens"] == want.tokens
        assert resp["ttft_s"] >= 0 and resp["latency_s"] >= resp["ttft_s"]
        assert request(addr, {"verb": "ping"}) == {"ok": True,
                                                   "draining": False}
        stats = request(addr, {"verb": "stats"})
        assert stats["decode_path"] == "paged_kernel"
        assert stats["requests_completed"] == 1
        trace = request(addr, {"verb": "trace", "id": "t0"})
        assert trace["state"] == "finished"
        assert request(addr, {"verb": "cancel", "id": "t0"}) == \
            {"id": "t0", "cancelled": False}
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 75
        snap = json.loads((tmp_path / "metrics.jsonl").read_text())
        assert snap["tokens_total"] == len(want.tokens)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
