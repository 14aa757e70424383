"""Task modules: the protocol (``BasicModule``), the GPT pretraining
recipe, offline eval and text generation (port of
``fleetx_tpu/core/module.py:21-410``; the ERNIE and vision modules are
in ``models/ernie/module.py`` and ``models/vision/module.py``).

A module builds the model config from the YAML ``Model`` section, makes
seeded parameters, and exposes the losses the engine differentiates:
``GPTModule.training_loss(params, batch, seed, step)`` (dropout on, its
randomness from one generator seeded by ``seed`` with ``step`` folded in)
and ``validation_loss(params, batch)`` (dropout off), ``predict_step``
(the logits) and ``input_spec`` (the forward's export signature).
``GPTEvalModule`` aggregates WikiText-style perplexity and LAMBADA-style
cloze accuracy over a loader (``run_offline_eval``). The host-side log
hooks print the reference's line: loss, step time, tokens/s and, on a
card the peak table knows, MFU against its bf16 dense peak (fp16's dense
tensor-core peak is the same), and the fp16 loss scale when the scaler
is on.

Model knobs this slice does not cover raise ``NotImplementedError``
naming their ROADMAP item (``check_model_config``). With
``Model.vocab_chunk`` set, both losses go through the chunked LM head
(the model returns the masked loss, never the ``[b, s, vocab]`` logits),
as the JAX module does.

Knobs of the long-context recipe (``pretrain_gpt_1.3B_seq8k_ring.yaml``)
and what they do here: ``use_ring_attention`` routes attention through
``ops/ring_attention.py`` at ring size 1 (the training slice runs on one
device: ``Distributed.seq_degree`` above 1 raises in the config loader,
port queue item 12); ``ring_kv_chunk`` acts only on the ring's
einsum path, which the recipe's shapes (seq 8192, head_dim 128) never
take;
``attention_probs_dropout_prob`` must be 0.0 there, as JAX asserts;
``use_recompute`` with ``recompute_granularity`` full / full_attn /
core_attn checkpoints the layer / the attention call / the attention
core, and ``dots`` the layer under the saved-dots policy
(``remat_save_dtype``, ``remat_consumed_layout``). ``Quantization.enable``
turns on QAT, with ``weight_bits`` / ``activation_bits`` as its widths. ``fused_linear``, ``scan_layers`` and ``scan_unroll`` are XLA
compile knobs with no effect on this eager port and are read by nothing.

``Model.moe_num_experts`` above 0 makes every FFN a mixture of experts
(``models/gpt/moe.py``; ``moe_top_k``, ``moe_capacity_factor``,
``moe_aux_weight``): the training loss is the LM loss plus the layers'
weighted load-balance losses, with metrics ``loss`` (the LM loss) and
``moe_aux``; ``validation_loss``, eval and generation ignore the aux, as
JAX's non-mutable apply does. A pipeline (``Distributed.pp_degree`` above
1) raises in the config loader, MoE or not, and so does MoE over more
than one rank (item 12).

On a mesh (``attach_shard``: the engine hands the module its
``parallel/sharding.ShardCtx``) the GPT losses are the global masked mean
(``models/gpt/model.masked_mean``: the psum of the ranks' masked sums over
the psum of their masks across ``(data, fsdp)``), ``predict_step``
returns the whole vocab, and ``Model.sequence_parallel`` (or
``Distributed.sequence_parallel``) puts the residual stream on sequence
blocks under tensor parallelism; on one rank it changes nothing.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from fleetx_tpu_torch.models.gpt import model as M
from fleetx_tpu_torch.utils.log import logger

#: (predicate on GPTConfig, what, ROADMAP port queue item) of the model
#: knobs the port does not cover
_UNCOVERED: tuple = ()


#: recompute granularities the port implements (``dots``: recompute that
#: keeps the matmul and kernel outputs, ``models/gpt/model.dots_policy``)
RECOMPUTE_GRANULARITIES = ("full", "full_attn", "core_attn", "dots")


def check_model_config(cfg: M.GPTConfig) -> None:
    """Raise on a model knob the training slice does not cover."""
    if cfg.use_recompute and \
            cfg.recompute_granularity not in RECOMPUTE_GRANULARITIES:
        raise ValueError(f"Model.recompute_granularity "
                         f"{cfg.recompute_granularity!r} is not one of "
                         f"{RECOMPUTE_GRANULARITIES}")
    for uncovered, what, item in _UNCOVERED:
        if uncovered(cfg):
            raise NotImplementedError(
                f"{what} is not ported yet (ROADMAP.md, port queue item "
                f"{item})")


class BasicModule:
    """The task protocol the engine drives (port of
    ``fleetx_tpu/core/module.py:21-80``): a module makes seeded parameters
    (``init_params(seed, device)``), checks a loaded tree
    (``check_params``) and exposes ``training_loss(params, batch, seed,
    step)`` and ``validation_loss(params, batch)``, each ``(loss,
    metrics)``; ``batch`` is a dict of tensors whose leading dim is the
    batch. The host-side hooks log the JAX module's lines."""

    #: the mesh context of a sharded run (None on one rank)
    shard = None

    def __init__(self, cfg: Any):
        self.cfg = cfg

    def attach_shard(self, shard) -> None:
        """Run the losses on a mesh (``parallel/sharding.ShardCtx``)."""
        self.shard = shard

    def pretreating_batch(self, batch: dict) -> dict:
        return batch

    def training_step_end(self, log_dict: dict) -> None:
        logger.info(
            "[train] epoch: %d, batch: %d, loss: %.9f, avg_batch_cost: %.5f "
            "sec", log_dict.get("epoch", 0), log_dict["batch"],
            log_dict["loss"], log_dict.get("train_cost", 0.0))

    def validation_step_end(self, log_dict: dict) -> None:
        logger.info(
            "[eval] epoch: %d, batch: %d, loss: %.9f, avg_eval_cost: %.5f "
            "sec", log_dict.get("epoch", 0), log_dict["batch"],
            log_dict["loss"], log_dict.get("eval_cost", 0.0))


class LanguageModule(BasicModule):
    """Shared GPT-family glue: the token/ips/MFU log line and the
    model-size banner."""

    tokens_per_sample: int = 1024

    def flops_per_token(self):
        """fwd+bwd model FLOPs per trained token (for the MFU line)."""
        from fleetx_tpu_torch.utils.hardware import gpt_flops_per_token

        c = getattr(self, "model_cfg", None)
        if c is None:
            return None
        return gpt_flops_per_token(c.num_layers, c.hidden_size,
                                   self.tokens_per_sample,
                                   vocab_size=c.vocab_size)

    def training_step_end(self, log_dict: dict) -> None:
        """``log_dict['device']`` names the device the step ran on; MFU is
        printed only for a card in the peak table."""
        from fleetx_tpu_torch.utils.hardware import peak_flops

        speed = 1.0 / max(log_dict.get("train_cost", 1e-9), 1e-9)
        tokens = log_dict.get("global_batch_size",
                              log_dict.get("batch_size", 1)) \
            * self.tokens_per_sample
        mfu = ""
        fpt = self.flops_per_token()
        device = log_dict.get("device")
        if fpt and device is not None and torch.device(device).type == "cuda":
            peak = peak_flops(torch.cuda.get_device_name(device))
            if peak:
                mfu = f", mfu: {fpt * tokens * speed / peak:.1%}"
        if "loss_scale" in log_dict:  # the fp16 dynamic loss scaler
            mfu += f", loss_scale: {log_dict['loss_scale']:g}"
        logger.info(
            "[train] global step %d, epoch: %d, batch: %d, loss: %.9f, "
            "avg_batch_cost: %.5f sec, speed: %.2f step/s, "
            "ips_total: %.0f tokens/s, ips: %.0f tokens/s, learning rate: "
            "%.5e%s", log_dict["global_step"], log_dict.get("epoch", 0),
            log_dict["batch"], log_dict["loss"],
            log_dict.get("train_cost", 0.0), speed, tokens * speed,
            tokens * speed, log_dict.get("lr", 0.0), mfu)

    def validation_step_end(self, log_dict: dict) -> None:
        speed = 1.0 / max(log_dict.get("eval_cost", 1e-9), 1e-9)
        logger.info(
            "[eval] step %d, batch: %d, loss: %.9f, avg_eval_cost: %.5f sec, "
            "speed: %.2f step/s", log_dict.get("global_step", 0),
            log_dict["batch"], log_dict["loss"],
            log_dict.get("eval_cost", 0.0), speed)

    @staticmethod
    def model_size(num_layers: int, hidden_size: int,
                   vocab_size: int) -> float:
        """Parameter-count formula in billions."""
        return (num_layers * (12.0 * hidden_size * hidden_size)
                + vocab_size * hidden_size) / 1e9


class GPTModule(LanguageModule):
    """GPT pretraining task."""

    @property
    def spec_family(self) -> str:
        """``gpt_moe`` when the FFN stack is mixture-of-experts, ``gpt``
        otherwise (the JAX module's partition-rule family)."""
        return "gpt_moe" if self.model_cfg.moe_num_experts > 0 else "gpt"

    def __init__(self, cfg: Any):
        model_cfg = dict(cfg.get("Model", cfg)) if isinstance(cfg, dict) \
            else dict(cfg)
        quant = dict((cfg.get("Quantization") or {})
                     if isinstance(cfg, dict) else {})
        if quant.get("enable"):
            # QAT (``fleetx_tpu/core/module.py:172-181``): each width only
            # where the block sets it
            model_cfg["use_qat"] = True
            if quant.get("weight_bits"):
                model_cfg["qat_bits"] = int(quant["weight_bits"])
            if quant.get("activation_bits"):
                model_cfg["qat_act_bits"] = int(quant["activation_bits"])
        self.model_cfg = M.config_from_dict(model_cfg)
        check_model_config(self.model_cfg)
        self.tokens_per_sample = self.model_cfg.max_position_embeddings
        super().__init__(cfg)
        c = self.model_cfg
        logger.info("GPT model: layers=%d hidden=%d heads=%d vocab=%d "
                    "(~%.2fB params)", c.num_layers, c.hidden_size,
                    c.num_attention_heads, c.vocab_size,
                    self.model_size(c.num_layers, c.hidden_size,
                                    c.vocab_size))

    def init_params(self, seed: int, device) -> dict:
        """Seeded parameters in the JAX layout on ``device``."""
        return M.init_params(self.model_cfg, seed=seed, device=device)

    def attach_shard(self, shard) -> None:
        """The model's forward runs on the mesh too (``GPTConfig.shard``)."""
        super().attach_shard(shard)
        self.model_cfg.shard = shard

    def check_params(self, params: dict) -> None:
        """Raise unless ``params`` has the tree of this config (LoRA
        adapter pairs included)."""
        from fleetx_tpu_torch.convert import check_tree

        check_tree(params, self.model_cfg)

    def training_loss(self, params: dict, batch: dict, seed: int,
                      step: int):
        """``(loss, metrics)`` with dropout on; for MoE the loss is the LM
        loss plus the summed aux, with metrics ``loss`` and ``moe_aux``
        (``fleetx_tpu/core/module.py:209-235``)."""
        c = self.model_cfg
        rng = M.dropout_rng(seed, step, c.num_layers, batch["tokens"].device,
                            self.shard)
        if c.moe_num_experts > 0:
            loss, aux = self._loss(params, batch, deterministic=False,
                                   rng=rng, return_aux=True)
            return loss + aux, {"loss": loss, "moe_aux": aux}
        loss = self._loss(params, batch, deterministic=False, rng=rng)
        return loss, {"loss": loss}

    def validation_loss(self, params: dict, batch: dict):
        """``(loss, metrics)`` with dropout off."""
        loss = self._loss(params, batch, deterministic=True, rng=None)
        return loss, {"loss": loss}

    def _loss(self, params: dict, batch: dict, *, deterministic: bool,
              rng, return_aux: bool = False):
        """The masked LM loss: through the chunked head when
        ``vocab_chunk`` is set, else from the full logits; with
        ``return_aux``, ``(loss, aux)``."""
        c = self.model_cfg
        if c.vocab_chunk:
            return M.gpt_for_pretraining(
                params, c, batch["tokens"], batch["position_ids"],
                deterministic=deterministic, rng=rng,
                labels=batch["labels"], loss_mask=batch["loss_mask"],
                return_aux=return_aux)
        logits, aux = M.gpt_for_pretraining(
            params, c, batch["tokens"], batch["position_ids"],
            deterministic=deterministic, rng=rng, return_aux=True)
        loss = M.cross_entropy_loss(logits, batch["labels"],
                                    batch["loss_mask"], c)
        return (loss, aux) if return_aux else loss

    @torch.no_grad()
    def predict_step(self, params: dict, batch: dict) -> torch.Tensor:
        """The forward's logits ``[b, s, vocab]``, dropout off (the whole
        vocab on a mesh)."""
        return M.gather_logits(M.gpt_for_pretraining(
            params, self.model_cfg, batch["tokens"],
            batch.get("position_ids")), self.model_cfg)

    def input_spec(self) -> dict:
        """The forward's inputs as the exporter traces them: name →
        ``(shape, dtype)``, one row of ``max_position_embeddings``."""
        s = self.model_cfg.max_position_embeddings
        return {"tokens": ((1, s), torch.int64),
                "position_ids": ((1, s), torch.int64)}


#: ``Offline_Eval.eval_type`` values
EVAL_TYPES = ("ppl", "acc")


class GPTEvalModule(GPTModule):
    """Offline eval (port of ``fleetx_tpu/core/module.py:283-333``):
    WikiText-style perplexity (``eval_type: ppl``) or LAMBADA-style cloze
    accuracy (``acc``) from the ``Offline_Eval`` section."""

    def __init__(self, cfg: Any):
        ev = dict(cfg.get("Offline_Eval") or {}) if isinstance(cfg, dict) \
            else {}
        self.eval_type = ev.get("eval_type", "ppl")
        if self.eval_type not in EVAL_TYPES:
            raise ValueError(f"Offline_Eval.eval_type {self.eval_type!r} "
                             f"is not one of {EVAL_TYPES}")
        super().__init__(cfg)

    @torch.no_grad()
    def batch_metrics(self, params: dict, batch: dict) -> dict:
        """One batch's sums: the masked loss sum, the token count, the rows
        whose every target token is the argmax prediction, and the rows
        with a target."""
        logits = M.gpt_for_pretraining(params, self.model_cfg,
                                       batch["tokens"],
                                       batch["position_ids"])
        losses = M.cross_entropy_per_token(logits, batch["labels"])
        mask = batch["loss_mask"].float()
        preds = torch.argmax(logits, dim=-1)
        tok_correct = torch.where(mask > 0, preds == batch["labels"],
                                  torch.ones_like(mask, dtype=torch.bool))
        row_has_target = mask.sum(dim=1) > 0
        row_correct = tok_correct.all(dim=1) & row_has_target
        return {"loss_sum": (losses * mask).sum(),
                "token_count": mask.sum(),
                "correct": row_correct.sum(),
                "rows": row_has_target.sum()}

    def run_offline_eval(self, params: dict, data_loader) -> dict:
        """Aggregate over a loader of numpy batches: ``loss`` (the mean
        over counted tokens), ``ppl = exp(min(loss, 30))`` and, under
        ``eval_type: acc``, ``acc`` (correct rows / rows), with the
        sums."""
        device = params["gpt"]["embeddings"]["word_embeddings"].device
        totals = {"loss_sum": 0.0, "token_count": 0.0, "correct": 0.0,
                  "rows": 0.0}
        for batch in data_loader:
            batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                     for k, v in batch.items()}
            out = self.batch_metrics(params, batch)
            for k in totals:
                totals[k] += float(out[k])
        results: dict = dict(totals)
        if totals["token_count"]:
            avg = totals["loss_sum"] / totals["token_count"]
            results["loss"] = avg
            results["ppl"] = float(np.exp(min(avg, 30.0)))
        if self.eval_type == "acc" and totals["rows"]:
            results["acc"] = totals["correct"] / totals["rows"]
        logger.info("[eval] offline results: %s",
                    {k: round(v, 6) for k, v in results.items()})
        return results


#: ``Generation.decode_strategy`` values
DECODE_STRATEGIES = ("sampling", "greedy_search", "beam_search")


class GPTGenerationModule(GPTModule):
    """Text generation (port of ``fleetx_tpu/core/module.py:336-410``):
    the ``Generation`` section → a ``GenerationConfig``, and the host glue
    around ``models/gpt/generation.py``: tokenize, left-pad, decode,
    detokenize.

    ``decode_strategy`` is ``sampling``, ``greedy_search`` or
    ``beam_search``; without one, ``use_topp_sampling`` (default True)
    picks sampling. Set ``module.tokenizer`` before ``generate``."""

    def __init__(self, cfg: Any):
        from fleetx_tpu_torch.models.gpt.generation import GenerationConfig

        gen = dict(cfg.get("Generation") or {}) if isinstance(cfg, dict) \
            else {}
        strategy = gen.get("decode_strategy")
        if strategy is not None:
            if strategy not in DECODE_STRATEGIES:
                raise ValueError(f"Generation.decode_strategy {strategy!r} "
                                 f"is not one of {DECODE_STRATEGIES}")
            do_sample = strategy == "sampling"
        else:
            do_sample = bool(gen.get("use_topp_sampling", True))
        self.use_beam_search = strategy == "beam_search"
        self.gen_cfg = GenerationConfig(
            max_new_tokens=int(gen.get("max_dec_len", 64)),
            min_new_tokens=int(gen.get("min_dec_len", 0)),
            temperature=float(gen.get("temperature", 1.0)),
            top_k=int(gen.get("top_k", 0)),
            top_p=float(gen.get("top_p", 0.0)),
            repetition_penalty=float(gen.get("repetition_penalty", 1.0)),
            do_sample=do_sample,
            num_return_sequences=int(gen.get("num_return_sequences", 1)),
            eos_token_id=int(gen.get("eos_token_id", 50256)),
            pad_token_id=int(gen.get("pad_token_id", 50256)),
            num_beams=int(gen.get("num_beams", 1)),
            num_beam_groups=int(gen.get("num_beam_groups", 1)),
            diversity_rate=float(gen.get("diversity_rate", 0.0)),
            length_penalty=float(gen.get("length_penalty", 0.0)))
        if self.use_beam_search and \
                self.gen_cfg.num_return_sequences > self.gen_cfg.num_beams:
            raise ValueError("Generation.num_return_sequences exceeds "
                             "num_beams under beam_search")
        self.tokenizer = None
        super().__init__(cfg)

    def generate_ids(self, params: dict, prompts: list,
                     generator: Optional[torch.Generator] = None):
        """Token-id prompts → ``[len(prompts) * num_return_sequences,
        max_new_tokens]`` numpy ids, prompt-major (rows ``i*n .. i*n+n-1``
        continue prompt ``i``); the device is the params'."""
        from fleetx_tpu_torch.models.gpt import generation as G

        device = params["gpt"]["embeddings"]["word_embeddings"].device
        tokens, mask = G.to_tensors(
            *G.left_pad(prompts, self.gen_cfg.pad_token_id), device)
        return G.generate_rows(self.model_cfg, params, self.gen_cfg, tokens,
                               mask, self.use_beam_search,
                               generator).cpu().numpy()

    def generate(self, params: dict, texts: list,
                 generator: Optional[torch.Generator] = None) -> list:
        """Texts → continuations (one per returned sample, cut at eos)."""
        if self.tokenizer is None:
            raise ValueError("set module.tokenizer before generate()")
        prompts = [self.tokenizer.encode(t) for t in texts]
        out = self.generate_ids(params, prompts, generator)
        eos = self.gen_cfg.eos_token_id
        results = []
        for row in out:
            ids = [int(t) for t in row]
            if eos in ids:
                ids = ids[:ids.index(eos)]
            results.append(self.tokenizer.decode(ids))
        return results
