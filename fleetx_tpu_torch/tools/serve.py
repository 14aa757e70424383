"""Serving entry point of the port: replica, router or Poisson bench.

Port of ``tools/serve.py``, with the same flags::

    python -m fleetx_tpu_torch.tools.serve \
        -c fleetx_tpu/configs/nlp/gpt/serving_gpt_345M.yaml [-o Key.Sub=v]
        [--device cuda|cpu] [--port N] [--ready-file f] [--bench]
    python -m fleetx_tpu_torch.tools.serve --router [-c cfg.yaml] \
        --backends 127.0.0.1:9000,127.0.0.1:9001 [--fleet-out f.jsonl]

- **replica** (default): build the model from ``-c cfg.yaml`` (the
  params of the newest checkpoint under ``Serving.ckpt_dir`` when given,
  verified against its digests; else seeded init from ``Global.seed``;
  with ``Serving.adapter_dir`` the LoRA adapter artifact there, verified
  against the base it stamps, merged into them), run one
  ``ServingEngine`` behind the
  JSON-lines TCP front. SIGTERM/SIGINT latch the preemption handler → the
  replica stops admitting, finishes every in-flight decode, and exits
  with ``--preemption-code``. The fault plan of ``Resilience.faults`` and
  ``FLEETX_FAULTS`` is built, installed and handed to the replica (the
  chaos drills: ``sigterm_at``, ``slow_decode_ms_at``,
  ``blackhole_after``, ``crash_mid_write``).
- **router** (``--router``): the stdlib-only front over the replicas of
  ``--backends`` (``serving/router.py``), the config's ``Serving.router``
  block validated first and passed on as JSON; it starts before anything
  imports torch. ``--fleet-out`` appends the merged fleet records.
- **bench** (``--bench``): the in-process Poisson serving bench; prints
  one JSON line.

The replica runs on ``cuda`` unless ``--device cpu`` is given.
``Serving.quantize_decode`` decodes with int8 fake-quant. The fine-tune
recipe's config (``Model.module: LoRAGPTModule`` and its ``FineTune:``
section) serves as it is: the replica reads ``Model`` for the
architecture and ignores the rest.

**A replica that is a gang of ranks.** ``Distributed`` degrees with a
product above 1 (``dp_degree``, ``fsdp_degree`` / ``sharding_degree``,
``mp_degree``) serve one replica over a mesh of ranks, started by
``python -m fleetx_tpu_torch.tools.supervise --num-procs N -- python -m
fleetx_tpu_torch.tools.serve ...`` with N the product: pages over
``fsdp``, heads and the Megatron splits over ``tensor``, replicated over
``data``. Rank 0 is the replica: its ``ReplicaServer``, port, fault plan
and drain; the other ranks run ``ServingEngine.follow()``, ignore the
signals the supervisor forwards, and exit with the leader's code when
its drain broadcasts stop. Each rank's device is ``cuda:{local_rank %
device_count}``; ranks that share a card talk over gloo
(``utils/env.py``). ``pp_degree`` and ``seq_degree`` above 1 raise
``NotImplementedError`` (ROADMAP.md, port queue item 12). Otherwise,
under a supervisor gang (``FLEETX_PROCESS_ID`` set), each member is a
replica of its own that offsets its port by the member id.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys

#: ``Distributed`` keys a replica does not serve above 1 yet
_DEEP_KEYS = ("pp_degree", "seq_degree")


def _check_ported(cfg: dict) -> None:
    """Refuse the config values the serving slices do not cover."""
    dist = dict(cfg.get("Distributed") or {})
    deep = {k: dist.get(k) for k in _DEEP_KEYS
            if dist.get(k) is not None and int(dist.get(k)) > 1}
    if deep:
        raise NotImplementedError(
            f"Distributed degrees {deep} need pipeline / sequence "
            f"parallelism, not ported yet (ROADMAP.md, port queue item 12)")


def build_engine(cfg: dict, device=None):
    """Config sections → a ready ``ServingEngine``: the params of
    ``Serving.ckpt_dir``'s newest checkpoint when it is set (a checkpoint
    that is missing or fails its digests raises), else seeded weights;
    then the adapter artifact of ``Serving.adapter_dir`` merged in (it
    needs ``ckpt_dir``: an adapter is refused on any base but its own)."""
    from fleetx_tpu_torch.core.checkpoint import load_params
    from fleetx_tpu_torch.core.engine.inference_engine import serving_mesh
    from fleetx_tpu_torch.models.gpt.model import config_from_dict, init_params
    from fleetx_tpu_torch.parallel.rules import SpecLayout
    from fleetx_tpu_torch.serving.decode import SamplingParams
    from fleetx_tpu_torch.serving.engine import ServingConfig, ServingEngine
    from fleetx_tpu_torch.utils.device import resolve_device
    from fleetx_tpu_torch.utils.env import rank_device

    _check_ported(cfg)
    dist = dict(cfg.get("Distributed") or {})
    mesh = serving_mesh(dist, device=device)
    layout = SpecLayout.from_dist_config(dist)
    device = resolve_device(rank_device(device) if mesh is not None
                            else device)
    model_cfg = config_from_dict(dict(cfg.get("Model") or {}))
    serving = ServingConfig.from_dict(dict(cfg.get("Serving") or {}))

    gen = dict(cfg.get("Generation") or {})
    strategy = gen.get("decode_strategy") or "greedy_search"
    sampling = SamplingParams(
        do_sample=strategy == "sampling",
        temperature=float(gen.get("temperature", 1.0)),
        top_k=int(gen.get("top_k", 0)),
        top_p=float(gen.get("top_p", 0.0)))
    eos = int(gen.get("eos_token_id", 50256))
    seed = int((cfg.get("Global") or {}).get("seed", 0))
    if serving.ckpt_dir:
        from fleetx_tpu_torch.convert import check_tree

        # the full leaves, checked against the model on every rank; the
        # engine cuts each rank's slices (after a LoRA merge and the
        # kernels' quantization, which need them whole)
        params = load_params(str(serving.ckpt_dir), device=device)
        check_tree(params, model_cfg)
    else:
        params = init_params(model_cfg, seed=seed, device=device)
    if serving.adapter_dir:
        if not serving.ckpt_dir:
            raise ValueError("Serving.adapter_dir requires Serving.ckpt_dir "
                             "(the adapter's frozen base)")
        from fleetx_tpu_torch.finetune.checkpoint import \
            apply_adapter_checkpoint

        params = apply_adapter_checkpoint(params, str(serving.adapter_dir))
    return ServingEngine(model_cfg, params, serving, sampling,
                         eos_token_id=eos, seed=seed, device=device,
                         mesh=mesh, layout=layout)


def _run_replica(args, cfg: dict) -> int:
    """Replica role: engine + socket front + preemption-drain loop."""
    from fleetx_tpu_torch.observability import flight
    from fleetx_tpu_torch.resilience.faults import FaultPlan, install_plan
    from fleetx_tpu_torch.resilience.preemption import PreemptionHandler
    from fleetx_tpu_torch.serving.server import ReplicaServer
    from fleetx_tpu_torch.utils.log import logger

    flight_dir = os.environ.get(flight.ENV_DIR) or "./flight_recorder"
    flight.install(flight.FlightRecorder(flight_dir))

    plan = FaultPlan.from_cfg(
        dict((cfg.get("Resilience") or {}).get("faults") or {}))
    install_plan(plan)

    engine = build_engine(cfg, device=args.device)
    if engine.mesh is not None and not engine.mesh.is_leader:
        # the leader decides when the gang stops: a forwarded signal
        # must not take a follower out of the leader's collectives
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, signal.SIG_IGN)
        code = engine.follow()
        logger.info("follower rank %d stopped by its leader (code %d)",
                    engine.mesh.rank, code)
        return code

    if args.attn_tap:
        from fleetx_tpu_torch.serving.decode import tap_next_decode

        def tap(attn) -> None:
            import numpy as np

            np.save(args.attn_tap, attn.float().cpu().numpy())

        tap_next_decode(tap)

    port = args.port
    member = os.environ.get("FLEETX_PROCESS_ID")
    if port and member and engine.mesh is None:
        port += int(member)
    server = ReplicaServer(engine, host=args.host, port=port,
                           fault_plan=plan if plan.armed else None)
    bound = server.start()
    if args.ready_file:
        with open(args.ready_file, "w") as f:
            json.dump({"pid": os.getpid(), "port": bound}, f)
    handler = PreemptionHandler()
    with handler.installed():
        try:
            server.run(preemption=handler)
        finally:
            server.close()
    reports = engine.close(args.preemption_code)
    if args.metrics_out:
        with open(args.metrics_out, "a") as f:
            f.write(json.dumps(engine.serving_snapshot()) + "\n")
            if engine.mesh is not None:
                f.write(json.dumps({"scope": "serving_mesh",
                                    "mesh": engine.mesh.shape,
                                    "ranks": reports}) + "\n")
    flight.dump("serving preemption drain")
    logger.warning("replica drained — exiting with preemption code %d",
                   args.preemption_code)
    return args.preemption_code


def _run_bench(args, cfg: dict) -> int:
    """Bench role: in-process Poisson load, one JSON line on stdout."""
    from fleetx_tpu_torch.serving import bench as B

    engine = build_engine(cfg, device=args.device)
    if engine.mesh is not None and not engine.mesh.is_leader:
        return engine.follow()
    bcfg = dict(cfg.get("ServingBench") or {})
    result = B.run_serving_bench(
        engine,
        n_requests=args.requests or int(bcfg.get("requests", 32)),
        rate_rps=args.rate or float(bcfg.get("rate_rps", 8.0)),
        max_prompt=int(bcfg.get("max_prompt", 24)),
        max_new=int(bcfg.get("max_new", 16)),
        seed=args.seed,
        metric=str(bcfg.get("metric", "serving_poisson_tokens_per_s")))
    B.emit(result, out=args.json_out)
    engine.close(0)
    return 0


def _run_router(args) -> int:
    """Router role: the stdlib-only front, its ``Serving.router`` block
    (from ``-c``, validated here, before the front binds) passed on as
    JSON."""
    from fleetx_tpu_torch.serving.router import main as router_main

    router_argv = ["--port", str(args.port), "--host", args.host,
                   "--backends", args.backends,
                   "--poll-interval", str(args.poll_interval)]
    if args.fleet_out:
        router_argv += ["--fleet-out", args.fleet_out]
    if args.config:
        cfg = load_config(args.config, args.override)
        block = dict((cfg.get("Serving") or {}).get("router") or {})
        if block:
            router_argv += ["--router-config", json.dumps(block)]
    return router_main(router_argv)


def load_config(path: str, overrides=None):
    """Parse + override + validate the Serving block (the training
    post-processing has no meaning for a serving process)."""
    from fleetx_tpu_torch.utils import config as config_mod

    cfg = config_mod.parse_config(path)
    config_mod.override_config(cfg, overrides)
    config_mod.process_serving_config(cfg)
    return cfg


def main(argv=None) -> int:
    """CLI dispatch across the replica and bench roles."""
    ap = argparse.ArgumentParser(description="fleetx serving runtime "
                                             "(PyTorch/CUDA port)")
    ap.add_argument("-c", "--config", help="YAML config (replica/bench)")
    ap.add_argument("-o", "--override", action="append", default=[],
                    help="dotted config overrides")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="listen port (0 = OS-assigned; offset by "
                         "FLEETX_PROCESS_ID under a supervisor gang)")
    ap.add_argument("--ready-file", default=None,
                    help="write {pid, port} JSON here once listening")
    ap.add_argument("--metrics-out", default=None,
                    help="append the final serving snapshot JSONL here")
    ap.add_argument("--preemption-code", type=int, default=75,
                    help="exit code after a graceful drain")
    ap.add_argument("--attn-tap", default=None,
                    help="write layer 0's attention output of the first "
                         "decode step (rank 0's heads) to this .npy: "
                         "holds a mesh replica against a one-rank engine")
    ap.add_argument("--router", action="store_true",
                    help="run the request router instead of a replica")
    ap.add_argument("--backends", default=None,
                    help="router mode: comma-separated host:port replicas")
    ap.add_argument("--fleet-out", default=None,
                    help="router mode: append merged fleet records "
                         "(FLEET_RECORD_SCHEMA JSONL) here")
    ap.add_argument("--poll-interval", type=float, default=1.0,
                    help="router mode: seconds between backend stats polls")
    ap.add_argument("--bench", action="store_true",
                    help="run the Poisson serving bench and exit")
    ap.add_argument("--requests", type=int, default=0,
                    help="bench: request count (0 = config/default)")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="bench: Poisson arrival rate, req/s")
    ap.add_argument("--seed", type=int, default=0, help="bench: stream seed")
    ap.add_argument("--json-out", default=None,
                    help="bench: also write the JSON line to this path")
    args = ap.parse_args(argv)

    if args.router:
        if not args.backends:
            ap.error("--router requires --backends host:port,host:port")
        return _run_router(args)
    if not args.config:
        ap.error("replica/bench mode requires -c config.yaml")
    cfg = load_config(args.config, args.override)
    from fleetx_tpu_torch.utils.env import close_dist_env

    try:
        if args.bench:
            return _run_bench(args, cfg)
        return _run_replica(args, cfg)
    finally:
        close_dist_env()


if __name__ == "__main__":
    # die by default signal only until the preemption handler is installed;
    # afterwards SIGTERM means "drain gracefully"
    signal.signal(signal.SIGTERM, signal.SIG_DFL)
    sys.exit(main())
