"""Autoregressive generation: logits processors, sampling transforms,
``generate`` and ``beam_search`` (port of
``fleetx_tpu/models/gpt/generation.py``: the processors :34-131, the
sampling transforms :134-162, ``GenerationConfig`` :170, ``left_pad``
:200, ``build_processors`` :216, ``generate`` :235 and ``beam_search``
:328).

Both decoders run one batched prefill over the left-padded prompts into
a dense ``DecodeCache`` (``models/gpt/model.py``) and then one-token
steps against it. The JAX ``lax.while_loop`` is a Python loop here that
stops once every row is done (or at ``max_new_tokens``); the cache is
written in place.

The two model calls go through a ``Decoder``: ``prefill(tokens, mask,
max_new) -> (logits, cache)`` and ``step(tok, pos, cache) -> logits``.
``eager_decoder`` runs the model's forward (``_prefill`` / ``_step``);
``exported_decoder`` runs the two programs ``torch.export`` made of the
same functions (``prefill_program`` / ``decode_program``, exported by
``utils/export.py``), the cache crossing the boundary as its four
tensors with the write position a 0-d tensor, so one decode program
serves every step. The loop itself stays here in Python: the JAX
export is one ``lax.while_loop`` program, the port's is two programs
and this loop.

Sampling draws from an explicit ``torch.Generator`` by the Gumbel-max
rule (``argmax(logits + Gumbel noise)``, the rule of
``jax.random.categorical``): the same distribution and support as the
JAX decoder, reproducible under one seed, but not the same draws as
``jax.random`` (a documented difference). Greedy decoding and beam search
draw nothing and match the JAX decoders token for token. Ties between
equal scores go to the lower index, as ``argmax`` and ``lax.top_k`` do
(stable sorts).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from fleetx_tpu_torch.models.gpt import model as M

NEG_INF = torch.finfo(torch.float32).min


# ------------------------------------------------------ logits processors
def min_length_processor(min_length: int, eos_token_id: int):
    """Suppress eos before ``min_length`` generated tokens."""

    def apply(logits, generated_len, sequences, sequences_mask=None):
        if generated_len >= min_length:
            return logits
        eos = torch.arange(logits.shape[-1], device=logits.device) \
            == eos_token_id
        return torch.where(eos, torch.full_like(logits, NEG_INF), logits)

    return apply


def repetition_penalty_processor(penalty: float):
    """Divide positive and multiply negative scores of the tokens already
    in the context (prompt and generated). ``sequences_mask`` marks the
    slots of ``sequences`` that hold real tokens (without it, the first
    ``generated_len`` slots); a pad id at an unmarked slot never erases a
    real hit of the same id (a scatter-max)."""

    def apply(logits, generated_len, sequences, sequences_mask=None):
        if penalty == 1.0:
            return logits
        if sequences_mask is None:
            sequences_mask = (torch.arange(sequences.shape[1],
                                           device=sequences.device)
                              < generated_len).expand(sequences.shape)
        valid = sequences_mask.to(torch.int32).reshape(sequences.shape)
        seen = torch.zeros(logits.shape, dtype=torch.int32,
                           device=logits.device)
        seen = seen.scatter_reduce(1, sequences.long(), valid,
                                   reduce="amax") > 0
        penalised = torch.where(logits > 0, logits / penalty,
                                logits * penalty)
        return torch.where(seen, penalised, logits)

    return apply


def _forced(logits: torch.Tensor, token_id: int) -> torch.Tensor:
    """0 at ``token_id``, ``NEG_INF`` elsewhere (an id past the vocabulary
    leaves every entry masked, as the JAX scatter drops it)."""
    hit = torch.arange(logits.shape[-1], device=logits.device) == token_id
    return torch.where(hit, torch.zeros_like(logits),
                       torch.full_like(logits, NEG_INF))


def forced_bos_processor(bos_token_id: int):
    """Force the first generated token."""

    def apply(logits, generated_len, sequences, sequences_mask=None):
        return _forced(logits, bos_token_id) if generated_len == 0 \
            else logits

    return apply


def forced_eos_processor(max_length: int, eos_token_id: int):
    """Force eos at the length limit."""

    def apply(logits, generated_len, sequences, sequences_mask=None):
        return _forced(logits, eos_token_id) \
            if generated_len == max_length - 1 else logits

    return apply


def hamming_diversity_processor(diversity_rate: float, num_beams: int,
                                num_beam_groups: int):
    """Group beam-search diversity penalty: subtract ``diversity_rate`` ×
    (the token's count among the earlier groups' tokens of this step)
    from the current group's logits.

    ``apply(logits, current_tokens, beam_group_idx)``: ``logits`` holds the
    group's rows ``[batch * group_size, vocab]``, ``current_tokens`` every
    beam's ``[batch * num_beams]``.
    """
    group_size = num_beams // num_beam_groups

    def apply(logits, current_tokens, beam_group_idx):
        if diversity_rate == 0.0:
            return logits
        batch = current_tokens.shape[0] // num_beams
        toks = current_tokens.reshape(batch, num_beams).long()
        valid = torch.arange(num_beams, device=logits.device)[None, :] \
            < beam_group_idx * group_size
        ones = valid.to(logits.dtype).expand(batch, num_beams)
        freq = torch.zeros((batch, logits.shape[-1]), dtype=logits.dtype,
                           device=logits.device).scatter_add(1, toks, ones)
        penalty = diversity_rate * freq.repeat_interleave(group_size, dim=0)
        return logits - penalty

    return apply


# -------------------------------------------------- sampling transforms
def apply_temperature(logits: torch.Tensor, temperature: float
                      ) -> torch.Tensor:
    """Scale logits by 1/temperature (no-op at 1.0)."""
    if temperature in (None, 1.0):
        return logits
    return logits / max(float(temperature), 1e-6)


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Mask everything below the k-th largest logit."""
    if not k or k <= 0:
        return logits
    k = min(int(k), logits.shape[-1])
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, torch.full_like(logits, NEG_INF), logits)


def apply_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering: keep the smallest prefix of the sorted
    distribution with cumulative probability >= p."""
    if not p or p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = cum - probs < p  # always keeps the top token
    kth = torch.where(keep_sorted, sorted_logits,
                      torch.full_like(sorted_logits, float("inf")))
    kth = kth.min(dim=-1, keepdim=True).values
    return torch.where(logits < kth, torch.full_like(logits, NEG_INF), logits)


def categorical(logits: torch.Tensor,
                generator: Optional[torch.Generator]) -> torch.Tensor:
    """One draw per row from ``softmax(logits)`` by the Gumbel-max rule;
    masked (``NEG_INF``) entries are never drawn while a row has an
    unmasked one."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp(min=tiny)))
    return torch.argmax(logits + gumbel, dim=-1)


# -------------------------------------------------------------- generate
@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    """Sampling knobs (the ``Generation:`` YAML section)."""

    max_new_tokens: int = 64
    min_new_tokens: int = 0
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 0.0
    repetition_penalty: float = 1.0
    do_sample: bool = True
    # independent samples per prompt: outputs come back
    # [b * n, new_tokens], prompt-major (rows i*n .. i*n+n-1 continue
    # prompt i)
    num_return_sequences: int = 1
    eos_token_id: int = 50256
    pad_token_id: int = 50256
    forced_bos_token_id: Optional[int] = None
    forced_eos_token_id: Optional[int] = None
    # diverse group beam search (decode_strategy "beam_search")
    num_beams: int = 1
    num_beam_groups: int = 1
    diversity_rate: float = 0.0
    length_penalty: float = 0.0


def left_pad(prompts: Sequence[Sequence[int]], pad_id: int,
             width: Optional[int] = None):
    """Host-side left padding of ragged prompts: ``(tokens, mask)`` int32
    numpy arrays ``[len(prompts), width]``."""
    width = width or max(len(p) for p in prompts)
    tokens = np.full((len(prompts), width), pad_id, np.int32)
    mask = np.zeros((len(prompts), width), np.int32)
    for i, p in enumerate(prompts):
        p = list(p)[-width:]
        tokens[i, width - len(p):] = p
        mask[i, width - len(p):] = 1
    return tokens, mask


def build_processors(gen_cfg: GenerationConfig) -> list:
    """The processor chain both decoders share."""
    processors = []
    if gen_cfg.forced_bos_token_id is not None:
        processors.append(forced_bos_processor(gen_cfg.forced_bos_token_id))
    if gen_cfg.min_new_tokens:
        processors.append(min_length_processor(gen_cfg.min_new_tokens,
                                               gen_cfg.eos_token_id))
    if gen_cfg.repetition_penalty != 1.0:
        processors.append(
            repetition_penalty_processor(gen_cfg.repetition_penalty))
    if gen_cfg.forced_eos_token_id is not None:
        processors.append(forced_eos_processor(gen_cfg.max_new_tokens,
                                               gen_cfg.forced_eos_token_id))
    return processors


def _run_processors(processors, logits, step, ctx, prompt_mask, max_new):
    """The chain over the full context (prompt + generated so far), with
    the left-pad prompt slots and unfilled generated slots unmarked."""
    if not processors:
        return logits
    gen_valid = (torch.arange(max_new, device=ctx.device) < step).expand(
        ctx.shape[0], max_new)
    ctx_mask = torch.cat([prompt_mask.bool(), gen_valid], dim=1)
    for proc in processors:
        logits = proc(logits, step, ctx, ctx_mask)
    return logits


def _prefill(cfg: M.GPTConfig, params: dict, tokens: torch.Tensor,
             attention_mask: torch.Tensor, max_new: int):
    """One forward over the left-padded prompts into a fresh cache:
    ``(last position's f32 logits, cache)``."""
    b, prompt_len = tokens.shape
    cache = M.init_cache(cfg, b, prompt_len + max_new, device=tokens.device)
    logits, cache = M.gpt_for_pretraining(
        params, cfg, tokens, cache=cache, attention_mask=attention_mask)
    return logits[:, -1].float(), cache


def _step(cfg: M.GPTConfig, params: dict, tok: torch.Tensor,
          pos: torch.Tensor, cache: M.DecodeCache) -> torch.Tensor:
    """One one-token forward against the cache: its f32 logits."""
    logits, _ = M.gpt_for_pretraining(params, cfg, tok[:, None],
                                      pos[:, None], cache=cache)
    return logits[:, -1].float()


@dataclasses.dataclass
class Decoder:
    """The decoders' two model calls: ``prefill(tokens, attention_mask,
    max_new) -> (last position's f32 logits, cache)`` and ``step(tok,
    pos, cache) -> f32 logits`` (the cache advanced in place)."""

    prefill: Callable
    step: Callable


def eager_decoder(cfg: M.GPTConfig, params: dict) -> Decoder:
    """The model's own forward."""
    return Decoder(functools.partial(_prefill, cfg, params),
                   functools.partial(_step, cfg, params))


def prefill_program(cfg: M.GPTConfig, max_new: int) -> Callable:
    """``fn(params, tokens, attention_mask) -> (logits, key, value,
    mask)``: the prefill with the fresh cache's tensors as outputs (what
    ``torch.export`` traces)."""

    def fn(params, tokens, attention_mask):
        logits, cache = _prefill(cfg, params, tokens, attention_mask,
                                 max_new)
        return logits, cache.key, cache.value, cache.mask

    return fn


def decode_program(cfg: M.GPTConfig) -> Callable:
    """``fn(params, tok, pos, key, value, mask, index) -> logits``: one
    step against the cache's tensors, written in place at ``index`` (a
    0-d int64 tensor)."""

    def fn(params, tok, pos, key, value, mask, index):
        return _step(cfg, params, tok, pos,
                     M.DecodeCache(key, value, index, mask))

    return fn


def exported_decoder(prefill: Callable, decode: Callable,
                     params: dict) -> Decoder:
    """A ``Decoder`` over the two exported programs (``prefill_program``
    and ``decode_program`` as ``torch.export`` saved them, each called
    with ``params`` first); the cache index lives on the device."""

    def run_prefill(tokens, attention_mask, max_new):
        logits, key, value, mask = prefill(params, tokens, attention_mask)
        if key.shape[2] != tokens.shape[1] + max_new:
            raise ValueError(f"the exported prefill holds a cache of "
                             f"{key.shape[2]} positions, not prompt "
                             f"{tokens.shape[1]} + {max_new} new tokens")
        index = torch.full((), tokens.shape[1], dtype=torch.long,
                           device=tokens.device)
        return logits, M.DecodeCache(key, value, index, mask)

    def run_step(tok, pos, cache):
        logits = decode(params, tok, pos, cache.key, cache.value,
                        cache.mask, cache.index)
        cache.index = cache.index + 1
        return logits

    return Decoder(run_prefill, run_step)


@torch.no_grad()
def generate(cfg: M.GPTConfig, params: dict, gen_cfg: GenerationConfig,
             tokens: torch.Tensor, attention_mask: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             decoder: Optional[Decoder] = None) -> torch.Tensor:
    """Continue left-padded prompts (``tokens`` / ``attention_mask``
    ``[b, prompt_len]``): ``[b * num_return_sequences, max_new_tokens]``
    int32, prompt-major, padded with ``pad_token_id`` after a row emits
    eos. Greedy unless ``do_sample``; sampling draws from ``generator``.
    The model calls go through ``decoder`` (default: the eager model)."""
    decoder = decoder or eager_decoder(cfg, params)
    n_ret = max(int(gen_cfg.num_return_sequences), 1)
    max_new = int(gen_cfg.max_new_tokens)
    pad, eos = gen_cfg.pad_token_id, gen_cfg.eos_token_id
    tokens, attention_mask = tokens.long(), attention_mask.long()
    b0, prompt_len = tokens.shape
    next_logits, cache = decoder.prefill(tokens, attention_mask, max_new)
    if n_ret > 1:
        # prefill ran once per prompt; the decode rows repeat it
        # prompt-major
        rows = torch.arange(b0, device=tokens.device).repeat_interleave(
            n_ret)
        tokens, attention_mask = tokens[rows], attention_mask[rows]
        next_logits, cache = next_logits[rows], cache.select(rows)
    b = b0 * n_ret
    processors = build_processors(gen_cfg)

    def sample_token(logits, step, ctx):
        logits = _run_processors(processors, logits, step, ctx,
                                 attention_mask, max_new)
        if gen_cfg.do_sample:
            logits = apply_temperature(logits, gen_cfg.temperature)
            logits = apply_top_k(logits, gen_cfg.top_k)
            logits = apply_top_p(logits, gen_cfg.top_p)
            return categorical(logits, generator)
        return torch.argmax(logits, dim=-1)

    ctx = torch.cat([tokens, torch.full((b, max_new), pad, dtype=torch.long,
                                        device=tokens.device)], dim=1)
    last = sample_token(next_logits, 0, ctx)
    ctx[:, prompt_len] = last
    done = last == eos
    # the next token's position: the number of real prompt tokens + step
    base_pos = attention_mask.sum(dim=1)
    step = 1
    while step < max_new and not bool(done.all()):
        tok = torch.where(done, torch.full_like(last, pad), last)
        logits = decoder.step(tok, base_pos + step - 1, cache)
        nxt = sample_token(logits, step, ctx)
        nxt = torch.where(done, torch.full_like(nxt, pad), nxt)
        ctx[:, prompt_len + step] = nxt
        done = done | (nxt == eos)
        last = nxt
        step += 1
    return ctx[:, prompt_len:].to(torch.int32)


def _top(scores: torch.Tensor, k: int):
    """``lax.top_k`` over the last dim: the k largest, ties to the lower
    index (a stable descending sort)."""
    values, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


@torch.no_grad()
def beam_search(cfg: M.GPTConfig, params: dict, gen_cfg: GenerationConfig,
                tokens: torch.Tensor, attention_mask: torch.Tensor,
                decoder: Optional[Decoder] = None):
    """Diverse group beam search: ``(sequences, scores)``,
    ``[b * num_beams, max_new_tokens]`` int32 (prompt-major, best-first
    per prompt) and ``[b, num_beams]`` length-penalised scores in that
    order.

    ``num_beams`` beams split into ``num_beam_groups`` groups. Each step
    one batched forward scores every beam; then the groups select in
    turn: group g's log-probs lose ``diversity_rate`` × the count of each
    token among the earlier groups' picks of this step, and its top
    ``group_size`` over ``group_size × vocab`` candidates are kept. The
    cache follows the chosen parents. A finished beam (it emitted eos)
    proposes only the pad token at zero added score, so its total stays.
    The model calls go through ``decoder`` (default: the eager model).
    """
    decoder = decoder or eager_decoder(cfg, params)
    nb, ng = int(gen_cfg.num_beams), max(int(gen_cfg.num_beam_groups), 1)
    if nb < 1 or nb % ng:
        raise ValueError(f"num_beams {nb} is not a positive multiple of "
                         f"num_beam_groups {ng}")
    gs = nb // ng
    pad, eos = gen_cfg.pad_token_id, gen_cfg.eos_token_id
    dev = tokens.device
    tokens, attention_mask = tokens.long(), attention_mask.long()
    b0, prompt_len = tokens.shape
    B = b0 * nb
    max_new = int(gen_cfg.max_new_tokens)
    div = hamming_diversity_processor(gen_cfg.diversity_rate, nb, ng)

    first_logits, cache = decoder.prefill(tokens, attention_mask, max_new)
    V = first_logits.shape[-1]
    rows = torch.arange(b0, device=dev).repeat_interleave(nb)
    cache = cache.select(rows)
    beam_tokens, beam_mask = tokens[rows], attention_mask[rows]
    base_pos = beam_mask.sum(dim=1)
    pad_only = torch.full((V,), NEG_INF, device=dev)
    pad_only[pad] = 0.0
    processors = build_processors(gen_cfg)

    def process_logits(logits, seqs, step):
        ctx = torch.cat([beam_tokens, seqs], dim=1)
        return _run_processors(processors, logits, step, ctx, beam_mask,
                               max_new)

    def select(lp_flat, scores, done):
        """One step's group-by-group update: within-prompt parents
        ``[b0, nb]``, tokens ``[b0, nb]``, new scores ``[b0, ng, gs]``."""
        lp = lp_flat.reshape(b0, ng, gs, V)
        current = torch.full((b0, nb), pad, dtype=torch.long, device=dev)
        parents, toks, new_scores = [], [], []
        for g in range(ng):
            lp_g = lp[:, g].reshape(b0 * gs, V)
            if gen_cfg.diversity_rate:
                lp_g = div(lp_g, current.reshape(-1), g)
            lp_g = lp_g.reshape(b0, gs, V)
            lp_g = torch.where(done[:, g, :, None], pad_only[None, None, :],
                               lp_g)
            cand = scores[:, g, :, None] + lp_g
            top_s, top_i = _top(cand.reshape(b0, gs * V), gs)
            parents.append(g * gs + top_i // V)
            toks.append(top_i % V)
            new_scores.append(top_s)
            current[:, g * gs:(g + 1) * gs] = toks[-1]
        return (torch.cat(parents, dim=1), torch.cat(toks, dim=1),
                torch.stack(new_scores, dim=1))

    def reorder(parent, tok, cache, seqs, done, lens, step):
        """Beam state behind the chosen parents, with the tokens added."""
        flat = (torch.arange(b0, device=dev)[:, None] * nb
                + parent).reshape(-1)
        cache = cache.select(flat)
        seqs, done, lens = seqs[flat], done.reshape(-1)[flat], lens[flat]
        tokf = torch.where(done, torch.full_like(flat, pad), tok.reshape(-1))
        seqs[:, step] = tokf
        lens = lens + (~done).to(lens.dtype)
        done = done | (tokf == eos)
        return cache, seqs, done.reshape(b0, ng, gs), lens, tokf

    # within each group only beam 0 starts live: otherwise every beam of
    # a group proposes the same candidates
    scores = torch.where(torch.arange(gs, device=dev)[None, None, :] == 0,
                         0.0, NEG_INF).expand(b0, ng, gs).contiguous()
    done = torch.zeros((b0, ng, gs), dtype=torch.bool, device=dev)
    seqs = torch.full((B, max_new), pad, dtype=torch.long, device=dev)
    lens = torch.zeros((B,), dtype=torch.long, device=dev)

    lp = torch.log_softmax(process_logits(first_logits[rows], seqs, 0),
                           dim=-1)
    parent, tok, scores = select(lp, scores, done)
    cache, seqs, done, lens, last = reorder(parent, tok, cache, seqs, done,
                                            lens, 0)
    step = 1
    while step < max_new and not bool(done.all()):
        tok_in = torch.where(done.reshape(-1), torch.full_like(last, pad),
                             last)
        logits = decoder.step(tok_in, base_pos + step - 1, cache)
        lp = torch.log_softmax(process_logits(logits, seqs, step), dim=-1)
        parent, tok, scores = select(lp, scores, done)
        cache, seqs, done, lens, last = reorder(parent, tok, cache, seqs,
                                                done, lens, step)
        step += 1

    final = scores.reshape(b0, nb)
    if gen_cfg.length_penalty:
        final = final / torch.clamp(lens.reshape(b0, nb), min=1).to(
            torch.float32) ** gen_cfg.length_penalty
    order = torch.sort(-final, dim=1, stable=True).indices
    flat = (torch.arange(b0, device=dev)[:, None] * nb + order).reshape(-1)
    return seqs[flat].to(torch.int32), torch.gather(final, 1, order)


def generate_rows(cfg: Optional[M.GPTConfig], params: Optional[dict],
                  gen_cfg: GenerationConfig, tokens: torch.Tensor,
                  attention_mask: torch.Tensor, beam: bool = False,
                  generator: Optional[torch.Generator] = None,
                  decoder: Optional[Decoder] = None) -> torch.Tensor:
    """``[b * num_return_sequences, max_new_tokens]`` int32, prompt-major:
    ``generate``'s rows, or under ``beam`` the first
    ``num_return_sequences`` of each prompt's best-first beams. ``cfg`` and
    ``params`` serve the eager decoder only."""
    if not beam:
        return generate(cfg, params, gen_cfg, tokens, attention_mask,
                        generator, decoder)
    seqs, _ = beam_search(cfg, params, gen_cfg, tokens, attention_mask,
                          decoder)
    b0 = tokens.shape[0]
    nb, nr = gen_cfg.num_beams, gen_cfg.num_return_sequences
    seqs = seqs.reshape(b0, nb, -1)[:, :nr]
    return seqs.reshape(b0 * nr, -1)


def to_tensors(tokens: Any, mask: Any, device) -> tuple:
    """``left_pad`` output as int64 tensors on ``device``."""
    return (torch.as_tensor(np.asarray(tokens), dtype=torch.long,
                            device=device),
            torch.as_tensor(np.asarray(mask), dtype=torch.long,
                            device=device))
