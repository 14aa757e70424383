"""Port parity: the auto-layout planner (``parallel/auto_layout.py``),
``Distributed.auto_layout`` in the config loader, and the
``tools.auto`` entry point.

The planner is plain Python on both sides, so its results are held
equal, not close: the same dicts and the same bytes, for the four
``configs/nlp/gpt/auto/`` recipes and GPT-175B, at 1, 8, 64 and 256
devices and budgets of 16 and 80 GB. ``get_config(auto_layout=True)`` on
each auto recipe is held to the JAX loader's at one device (the port
trains on one): the same ``Distributed`` degrees and ``Global`` batch
values, or, where the recipe pins a degree above 1, a refusal on both
sides. The CLI trains 2 steps at a tiny width on the CPU.
"""

import logging
import os
import subprocess
import sys

import pytest
import torch

from fleetx_tpu.parallel import auto_layout as JA
from fleetx_tpu.utils import config as JC
from fleetx_tpu_torch.parallel import auto_layout as TA
from fleetx_tpu_torch.utils import config as TC

pytestmark = pytest.mark.torch_port


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """This file's tensors are tiny: torch runs them on one intra-op
    thread, and its default pool (one thread a core, on cores the other
    test workers share) costs ~50x on a ``[256, 64] @ [64, 192]`` matmul.
    The count is restored for the files after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GPT = os.path.join(REPO, "fleetx_tpu", "configs", "nlp", "gpt")
AUTO = {name: os.path.join(GPT, "auto", f"pretrain_gpt_{name}.yaml")
        for name in ("345M_single_card", "1.3B_single_card", "1.3B_dp8",
                     "6.7B_sharding16")}
RECIPES = dict(AUTO, **{"175B": os.path.join(
    GPT, "pretrain_gpt_175B_mp8_pp16.yaml")})
DEVICES = (1, 8, 64, 256)
BUDGETS = (16.0, 80.0)
DEGREES = ("dp_degree", "mp_degree", "pp_degree", "fsdp_degree",
           "seq_degree")


def _outcome(fn, *args, **kwargs):
    """``("ok", result)`` or ``("raises", exception type name)``."""
    try:
        return "ok", fn(*args, **kwargs)
    except (ValueError, AssertionError, NotImplementedError) as e:
        return "raises", type(e).__name__


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_planner_equals_jax(recipe):
    config = JC.parse_config(RECIPES[recipe])
    model = dict(config["Model"])
    assert TA.estimate_params(model) == JA.estimate_params(model)
    assert TA.ZERO_STAGE_TERMS == {"moments": 1, "grads": 2, "weights": 3}
    for n in DEVICES:
        advice = TA.advice_inputs(config, data_world=n)
        assert advice == JA.advice_inputs(config, data_world=n)
        mdl, mb, gran = advice
        assert TA.estimate_memory_terms(mdl, mb, gran) == \
            JA.estimate_memory_terms(mdl, mb, gran)
        for hbm_gb in BUDGETS:
            got = _outcome(TA.suggest_layout, mdl, n, hbm_gb=hbm_gb,
                           micro_batch=mb, recompute=gran)
            assert got == _outcome(JA.suggest_layout, mdl, n, hbm_gb=hbm_gb,
                                   micro_batch=mb, recompute=gran), (n, hbm_gb)
            if got[0] != "ok":
                continue
            layout = got[1]
            assert TA.predicted_step_bytes(mdl, layout, mb, gran) == \
                JA.predicted_step_bytes(mdl, layout, mb, gran)
            assert TA.offload_is_needed(mdl, layout, mb, gran, hbm_gb) == \
                JA.offload_is_needed(mdl, layout, mb, gran, hbm_gb)


def _loaded(loader, path: str):
    """The loaded config's ``Distributed`` degrees and sharding, and its
    ``Global`` batch values; or the refusal's type."""
    kind, cfg = _outcome(loader, path)
    if kind != "ok":
        return kind, cfg
    dist = cfg["Distributed"]
    sharding = dist.get("sharding") or {}
    glb = cfg["Global"]
    return kind, (
        {k: dist[k] for k in DEGREES}, "auto_layout" in dist,
        (sharding.get("sharding_degree"), sharding.get("sharding_stage")),
        {k: glb[k] for k in ("global_batch_size", "local_batch_size",
                             "micro_batch_size")},
        cfg["Engine"]["accumulate_steps"])


@pytest.mark.parametrize("recipe", sorted(AUTO))
def test_get_config_auto_layout_equals_jax(recipe):
    got = _loaded(lambda p: TC.get_config(p, auto_layout=True,
                                          device="cpu"), AUTO[recipe])
    want = _loaded(lambda p: JC.get_config(p, num_devices=1,
                                           auto_layout=True), AUTO[recipe])
    if want[0] == "raises":
        # a degree above 1 pinned by the recipe: neither loader lays it on
        # one device (JAX asserts, the port raises JAX's message)
        assert recipe in ("1.3B_dp8", "6.7B_sharding16")
        assert got == ("raises", "ValueError")
        return
    assert got == want
    assert got[1][0] == dict.fromkeys(DEGREES, 1) and not got[1][1]


def test_the_budget_is_the_card_memory_unless_the_yaml_gives_one(
        monkeypatch, caplog):
    """On a CUDA device the planner's budget is the card's memory (the
    1.3B recipe fits an 80 GB card, and nothing warns); the YAML's
    ``hbm_gb`` wins; on the CPU it is the JAX default."""

    class Props:
        name, total_memory = "NVIDIA H100 80GB HBM3", 85_045_395_456

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: Props)
    gb = Props.total_memory / 2 ** 30
    assert TC.layout_budget_gb(True) == (gb, "the memory of " + Props.name)
    assert TC.layout_budget_gb({"hbm_gb": 32}, "cuda")[0] == 32.0
    assert TC.layout_budget_gb(True, "cpu")[0] == TC.DEFAULT_HBM_GB == 16.0
    logger = logging.getLogger("fleetx_tpu_torch")
    monkeypatch.setattr(logger, "propagate", True)
    with caplog.at_level(logging.INFO, logger="fleetx_tpu_torch"):
        cfg = TC.get_config(AUTO["1.3B_single_card"], device="cuda")
    assert "exceeds the" not in caplog.text
    assert f"budget {gb:.2f} GB" in caplog.text
    assert {k: cfg["Distributed"][k] for k in DEGREES} == \
        dict.fromkeys(DEGREES, 1)
    # at JAX's 16 GB the same model does not fit, and the planner says so
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="fleetx_tpu_torch"):
        TC.get_config(AUTO["1.3B_single_card"], device="cpu")
    assert "exceeds the" in caplog.text


def test_auto_cli_trains_on_cpu():
    """``python -m fleetx_tpu_torch.tools.auto --device cpu`` on the 345M
    auto recipe at a tiny width: the planner's degrees, 2 steps."""
    cmd = [sys.executable, "-m", "fleetx_tpu_torch.tools.auto", "-c",
           AUTO["345M_single_card"], "--device", "cpu"]
    for o in ("Engine.max_steps=2", "Engine.logging_freq=1",
              "Engine.eval_freq=0", "Engine.save_load.save_steps=0",
              "Model.num_layers=2", "Model.hidden_size=128",
              "Model.num_attention_heads=2", "Model.vocab_size=256",
              "Model.max_position_embeddings=128", "Global.max_seq_len=128",
              "Model.dtype=float32", "Global.global_batch_size=2",
              "Global.local_batch_size=2", "Global.micro_batch_size=2",
              "Data.Train.dataset.name=SyntheticGPTDataset",
              "Data.Train.dataset.num_samples=16"):
        cmd += ["-o", o]
    # one intra-op thread, as the in-process tests here: the tiny model
    # on a pool per core of shared cores is what would take the time
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "auto layout for" in out.stderr
    assert "budget 16.00 GB" in out.stderr
    assert ("resolved Distributed {'dp_degree': 1, 'mp_degree': 1, "
            "'pp_degree': 1, 'fsdp_degree': 1, 'seq_degree': 1}"
            in out.stderr)
    steps = [l for l in out.stderr.splitlines() if "[train] global step" in l]
    assert len(steps) == 2 and "global step 2," in steps[-1]
