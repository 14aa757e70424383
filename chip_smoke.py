#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU: build, check and time its
kernels, serve GPT-345M at full width through the port's replica, train
GPT-345M at full width and GPT-1.3B at seq 8192 at full width and depth
through the port's trainer, save, audit and resume GPT-345M training,
generate from its checkpoint with the port's generation task, evaluate
it offline, export it and run the exported programs, fine-tune it with
LoRA adapters and serve the merged weights with int8 fake-quant decode,
train GPT-345M in fp16 under the loss scaler and run the resilience
drills, train GPT-345M with QAT and under the dots recompute policy and
GPT-1.3B through the auto-layout entry point, pretrain ERNIE-345M and
train and evaluate ViT-B/16 through the same trainer, and train,
evaluate and generate with the 8-expert MoE GPT-345M and train and
sample the Imagen cascade (64² base, SR-256), train GPT-345M with
the telemetry, the profiler window and the device prefetcher on,
train it under the SDC sentinel with an asynchronous save and run the
supervisor's preflight, serve it through the request router in front of
replicas in process and of a supervised fleet under chaos, train it
on a blended corpus indexed by the native builder, serve it over a mesh
of ranks, and train it sharded over a gang of ranks with the gang
resilience runtime (a preemption and its resume, a per-rank pair's
collective outcomes).

    python3 chip_smoke.py
    python3 chip_smoke.py --paged-shapes   # row 7's three timings alone
    python3 chip_smoke.py --serving        # phase 2 and its trace alone
    python3 chip_smoke.py --eval-export    # phases 10-11 and row 1 at the
                                           # eval shape, seeded weights
    python3 chip_smoke.py --fp16-resilience  # 1b's fp16 rows, 4 and 12
    python3 chip_smoke.py --train-paths    # phases 4 and 6 alone
    python3 chip_smoke.py --finetune-serving  # phases 2, 4, 8, 9's
                                           # tokenizer, 10's corpus, 13
    python3 chip_smoke.py --gpt-knobs      # phases 4 and 14
    python3 chip_smoke.py --encoders       # phase 15
    python3 chip_smoke.py --families       # phase 16
    python3 chip_smoke.py --norm-shapes    # phase 1d alone (row 5's
                                           # routes, timings, host µs)
    python3 chip_smoke.py --telemetry      # phases 4 and 17
    python3 chip_smoke.py --resilience-runtime  # phases 4 and 18
    python3 chip_smoke.py --router-corpus  # phase 19 on seeded weights
    python3 chip_smoke.py --mesh           # phase 20 on seeded weights
    python3 chip_smoke.py --train-mesh     # phase 1b's offsets, 4 and 21

Phases (each prints one JSON line; any failure raises, exit code != 0):

0. environment: torch/CUDA versions, ``nvcc --version``, the card's name
   and power limit; TF32 is switched off for matmuls and cuDNN.
1. kernels: build every CUDA kernel from ``fleetx_tpu_torch/csrc`` (one
   ``nvcc`` a source, all at once, while phase 15 trains: its paths take
   none of the kernels, and the card would otherwise idle through the
   build). The
   paged decode kernel at the shapes GPT-345M serving gives it (B 16, nh
   16, hd 64, page 16, 64 pages per request, 513 pages) with three lens
   sets (``PAGED_SHAPES``: ragged, the main path's decode step, the full
   pool) in f32 and bf16, and at ``PAGED_GEOMETRIES`` (hd 128, page 8, a
   head block that does not divide nh, hd 256 in f32, B 1): held to its
   plain version and to the split plain version at the kernel's own
   chunking, inactive rows exact zeros, a repeated call bitwise
   identical, the planner's shared memory equal to the kernel's. Then the
   three bf16 shapes timed: the kernel, the plain version and one PyTorch
   library call computing the same function (the yardstick; the port
   never calls it), each the median of CUDA-event timings with the L2
   cache flushed before every launch, and the kernel's device time from
   ``torch.profiler`` (``device_ms``).
2. main path: ``serving_gpt_345M.yaml`` through the port's own config
   loader and ``build_engine`` (seeded bf16 weights, full width), an
   in-process ``ReplicaServer`` answering concurrent requests over TCP.
   Kernel launch counts are zeroed just before and read just after; the
   decode path must be the kernel and it must have run in all 24 layers
   of every decode step.
   Then a short trace on the same engine: host wall per decode step,
   device time per step by kernel (``torch.profiler``), device busy share.
1b. training kernels: flash-attention forward and fused backward
   (q/k/v ``[128, 1024, 64]``, causal, dropout 0.1) and the fused
   residual+LayerNorm forward and backward (``[8, 1024, 1024]``, with the
   residual / ``ds_in``), at the GPT-345M training shapes in f32, bf16 and
   fp16:
   each held to its plain version (the bf16 forward and fused backward,
   on the tensor cores, to the rounded one and within the drift bound to
   the unrounded one: see Tolerances), timed beside its plain version and
   one library call (SDPA's flash backend forward / its autograd
   backward; ``F.layer_norm`` after the add / its autograd backward), with
   its bound; the bf16 norms and their yardsticks five times more at the
   345M shape (``norm_spread``: median and range). The bf16 fused backward
   is called twice on the same inputs
   and must give bitwise-identical dq, dk and dv (it is deterministic).
   The dropout masks of the flash kernels are recovered bit for bit with
   identity probes (q = k = 0, v or do one-hot) and must equal the plain
   version's hash mask; the keep rate is printed.
1c. split backward kernels: the dq and dk/dv kernels against their plain
   versions at ``[8, 1024, d]`` for d 64/128/256, f32 and bf16, causal
   and not (also sq 1024 / sk 512), dropout 0 and 0.1, fed an lse that is
   not the rows' own (the ring's global-lse contract); where bf16 / fp16
   at d 64/128 take the tensor-core forward, dq and dk/dv, each held to
   the rounded plain version and within the drift bound to the unrounded
   one in every one of those cases; the dq kernel called twice on the
   same inputs (dropout 0.1) must give bitwise-identical dq; the split
   pair against the fused kernel (d <= 128, dropout 0.1) in f32 on the
   SIMT kernels (1e-5) and in bf16 with both on the tensor cores (within
   the drift bound); their dropout masks are recovered by the phase-1b
   probes. Then the seq-8192 path's kernels at its shapes (forward, dq,
   dk/dv at ``[32, 8192, 128]`` bf16 causal; the norms at ``[2, 8192,
   2048]``): each against its plain version (the attention ones on 4 of
   the 32 heads), timed over three calls beside its bound, the plain
   version (attention at bh 4) and the yardstick (SDPA flash forward /
   one SDPA flash backward giving dq, dk and dv together;
   ``F.layer_norm``).
1d. row 5's two routes (``ops/fused_norm.py:plan_fwd``): ``"rows"`` (the
   persistent warp-per-row kernel fed by bulk copies) held to
   ``fwd_plain`` at hidden 128, 1024, 2048 and 4096 and ``"row_block"``
   (a block per row) at 8192 and 32768, rows 1, 7 and 8195, every dtype
   pair (f32, bf16, fp16 in; the input dtype or f32 out), with and
   without the residual: ``s`` bitwise, the stats at the f32 tolerance,
   ``out`` at its dtype's; each "rows" call repeated bitwise; the
   planner's shared memory equal to the kernel's
   (``fleetx_fused_norm_fwd_smem_bytes``). Then the 345M, seq-8192 and
   decode shapes in bf16 and the 345M shape in fp16, each held to the
   plain version and timed in turns (rows, row_block, add +
   ``F.layer_norm``, and back): CUDA-event ``ms`` (L2 flushed),
   ``graph_ms`` (CUDA-graph replay), ``device_ms`` (profiler), the bound
   and each one's share of it; bf16 and fp16 at 345M in turns, three
   repeats, on both routes (``norm_fp16_turns``); and at the decode shape
   ``host_us``, the wall of 1000 back-to-back calls with no synchronise
   over 1000: the eager non-grad path the generation model calls, each
   route's ``fwd_call``, the custom op's dispatch and add +
   ``F.layer_norm``, in turns, and the launch path's pieces. Every later
   path's norm forward launches must all take ``"rows"``
   (``read_counts``).
3. kernel against gather on the main path: the same full-width engine
   built twice on the same weights, ``Serving.paged_kernel`` on and off;
   f32 greedy tokens must be identical, and in bf16 the one-step logit
   difference and the share of agreeing tokens are printed.
4. training main path: ``pretrain_gpt_345M_synthetic.yaml`` through the
   port's config loader and ``tools/train.py`` (``build_trainer`` →
   ``EagerEngine.fit``) at full width, uncut, for 10 steps
   (``Engine.max_steps=10``, ``logging_freq=1``). Launch counts are
   zeroed just before and read just after: 24 flash forward and 24 fused
   backward (all on the tensor cores: ``tc_launches`` of both equal
   their ``launches``), 49 norm forward and 49 norm backward launches per
   step.
   Every loss and grad norm is finite and the first loss is within 0.1
   of the untrained model's expectation ``ln(vocab) + hidden·r²/2`` (the
   tied head's logits have variance ``hidden·r²`` at init range r).
   Step time, tokens/s, MFU against the card's bf16 dense peak and peak
   memory are printed; then a ``torch.profiler`` trace of 3 more steps:
   device time per step by kernel and the device busy share.
5. kernels against plain on the training path: the same full-width
   weights and batch in f32 with dropout 0, one loss+grad evaluation with
   ``use_flash_attention``/``fused_residual_norm`` on and one with them
   off; the bf16 loss and grad differences are printed.
6. long-context main path: ``pretrain_gpt_1.3B_seq8k_ring.yaml`` with
   ``SEQ8K_OVERRIDES`` (one card, synthetic data, 3 steps) through
   ``build_trainer`` → ``fit`` at full width and depth: ring attention at
   ring size 1, full recompute, the chunked LM head, 4 micro-batches of
   2. Launch counts zeroed just before and read just after: per step 192
   flash forwards, 96 dq, 96 dk/dv, 0 fused backward, 388 norm forwards
   and 196 norm backwards; every forward, dq and dk/dv launch on the
   tensor cores (``tc_launches``). Finite losses and grad norms, the first
   loss within 0.1 of ``ln(vocab) + hidden·r²/2``, the losses within 1e-3
   (step 1, which depends only on the forward) and 1e-2 (steps 2-3) of a
   run on the SIMT kernels (``SEQ8K_SIMT_LOSSES``);
   step time (median of steps
   2-3), tokens/s, MFU, peak memory; then one profiled step.
7. split against fused and recompute on against off, on the 345M
   training path cut to 4 layers, one loss+grad evaluation each on the
   same weights, batch and seed: attention dropout 0.1 with
   ``flash_fused_bwd`` on and off (f32, SIMT kernels: loss within 1e-6,
   grads within 1e-5 of each leaf's largest magnitude; bf16, both on the
   tensor cores, printed); hidden and
   attention dropout 0.1, f32, ``use_recompute`` full / full_attn /
   core_attn / dots against off (loss within 1e-6, grads within 1e-6 of
   each leaf's largest magnitude), and dots with ``remat_save_dtype:
   bfloat16`` against off (the forward rounds the named residuals to
   bf16: loss within ``DOTS_BF16_LOSS_TOL``, grads within ``TC_DRIFT``).

8. checkpoint: ``pretrain_gpt_345M_synthetic.yaml`` at full width, uncut
   (after checking the temp dir has 10 GB free): a fresh engine trains 5
   steps and saves step 5 (``save_steps`` 5); a new engine with
   ``ckpt_dir`` on that dir restores it (params, AdamW moments, step and
   ``consumed_samples`` equal to the saved ones bit for bit) and trains
   to step 10, saving step 10. Launch counts zeroed just before the
   resumed run and read just after: phase 4's per-step counts × 5. The
   resumed run's first batch must be the one phase 4 took at step 6, and
   its losses must equal phase 4's steps 6-10 bit for bit (dropout is a
   function of seed and step; every kernel and op of the step is
   deterministic). Then
   ``tools/verify_ckpt`` reports both steps ``ok``; one flipped byte of
   step 10's payload makes it exit 1 with ``corrupt`` (one audit: its
   exit code and its JSON report) and ``load()`` fall back to step 5 with
   its warning; the byte flipped back, step 10 is ``ok`` again. Save and
   load seconds and GB/s, peak memory. Phases 9-11 and 13 then take step
   10's params cut to their first ``CUT_LAYERS`` (4) layers, saved as a
   params-only checkpoint (a depth cut, for the time limit).
9. generation: ``generation_gpt_345M_single_card.yaml`` through the
   port's config loader and ``tasks/gpt/generation.py``'s ``build`` at
   full width (bf16) with phase 8's cut checkpoint, a tokenizer trained with
   ``train_bpe`` on README.md (vocab 2000) and read back through
   ``Generation.tokenizer_dir``; the YAML's ``input_text`` and a batch of
   8 prompts of 5-300 tokens, 64 new tokens, for ``sampling`` (the
   YAML's top-k 50, top-p 0.75), ``greedy_search`` and ``beam_search``
   (4 beams, 2 returned). Launch counts zeroed just before each batch
   and read just after: 9 norm forwards a model call, nothing else.
   Each batch's ``generate_ids`` is timed whole, its prefill (the first
   model call) within it: prefill ms, ms per decode step (the rest of
   the wall over the decode steps), new tokens/s (the returned rows'
   tokens up to eos), computed row-steps/s (every row of the batched
   forward, beams included, each model call) and peak memory.
   Then in f32, greedy ``generate`` of 32 tokens on 4 prompts against
   the replica ``tools/serve.build_engine`` builds with
   ``Serving.ckpt_dir`` on the same checkpoint (the paged kernel): the
   tokens must be identical, or differ only where the top-two logit gap
   is under 1e-3.
10. offline eval: ``python -m fleetx_tpu_torch.tools.eval`` on
   ``eval_gpt_345M_single_card.yaml`` as its own process, from phase 8's
   cut checkpoint with phase 9's tokenizer, on ``docs/*.md`` sorted and
   concatenated (the repository's own English text; wikitext-103 and
   LAMBADA are not in the repository): ``eval_type: ppl`` (windows of
   1024 at stride 32) and ``acc`` (a cloze jsonl of the same text's
   paragraphs of five words or more, the last word of each the target).
   Each prints its results, window and batch counts, ms per batch, window
   tokens/s, peak memory and the launches of kernels 1 and 5 (4 and 9
   per batch). In this process the same eval on its first
   ``EVAL_PREFIX`` windows with both kernels off must agree with it on
   the loss within ``EVAL_F32_RTOL`` (f32) and ``EVAL_BF16_RTOL`` (bf16;
   reasons beside the constants); one batch is traced. The ``Data.Eval``
   path (a ``GPTDataset`` of the same text written by the port's
   ``tools.preprocess_data``) runs 3 batches as its own process. The
   three eval processes run while this one compares (for the time
   limit: a process start is ~20 s; their ms per batch are taken beside
   that work).
11. export and inference: ``python -m fleetx_tpu_torch.tools.export`` of
   ``inference_gpt_345M_single_card.yaml`` from phase 8's cut checkpoint,
   target ``forward`` and then ``generation`` (batch 1, prompt 128, 64
   new tokens), each its own process. The exported forward at
   ``[1, 1024]`` must equal the eager forward bit for bit and launch
   kernels 1 and 5 4 and 9 times a call; its first call and warm p50 /
   p99 over 20 calls
   are printed beside the program alone and the eager forward. Through
   the generation programs, greedy (bf16, and an f32 export made in this
   process of the checkpoint's first ``F32_EXPORT_LAYERS`` layers, a depth
   cut) and seeded sampling must equal eager generation token for
   token, with 9 launches of kernel 5 a model call; ms per decode step
   and new tokens/s. ``tools.inference`` and ``tasks.gpt.inference`` run
   the bf16 export as their own processes. For the time limit the f32
   export runs while the two export processes do, and the two entry
   points while this process checks the programs (their timings are
   taken beside that work); phase 13's fine-tune process starts before
   this phase, on phase 10's corpus. The temp dirs are removed whether
   the run passed or failed.

12. fp16 and resilience (345M full width and depth through
   ``build_trainer``; each part one JSON line): 20 fp16 steps at
   ``scale_loss`` 32768 with ``Resilience.enable`` and the step watchdog
   on (counts zeroed just before and read just after: phase 4's per batch,
   rows 1 and 4 on the tensor cores, rows 5 and 6 on the ``__half``
   instantiation; losses, the scale per step, skipped steps, step time,
   tokens/s, MFU, peak memory, 0 watchdog stalls); rows 1 and 4 on layer
   24's inputs of a further step, at the real loss-scaled dO, against both
   plain versions, then with dO pushed past the fp16 range, where every
   finite output must agree with the f32 reference and the overflow must
   make the grad norm non-finite; 3 fp16 steps with the kernels on and
   off (dropout 0) within ``FP16_DRIFT``; the overflow drill (2**125 over
   5 one-shot batches: step 0, scale 2**120, params and moments bit for
   bit; a re-iterable run from 2**40 reaches ``max_steps``); the guard
   skip (bf16, ``nan_loss_at: [3]``: the state bit for bit across the
   poisoned batch, ``nonfinite_skips`` 1) and the guard's per-step cost
   (blocks of steps with the check off and on, alternating); rollback then
   abort (save at 4, batches 5-7 poisoned: the restore of step 4 timed,
   ``rollbacks_total`` 1, the guard's decisions at every window, then
   ``TrainingAborted``); a preemption through ``python -m
   fleetx_tpu_torch.tools.train`` (``sigterm_at: 5``: exit code 75, a
   verified step-5 checkpoint, the save timed; the same command resumed
   to step 10: steps 1-10 equal the same recipe's uninterrupted losses
   in this process bit for bit). The rollback and preemption drills run
   the recipe cut to ``DRILL_LAYERS`` (4) layers (a depth cut, for the
   time limit: their saves and restores); the preempted process starts
   with the phase and the resumed one beside the rollback drill (the
   phase's step timings are taken beside them).
13. LoRA fine-tuning and quantized serving (run before phase 12, while
   phase 8's checkpoint and phase 10's corpus exist): ``python -m
   fleetx_tpu_torch.tools.finetune`` on ``finetune_gpt_345M_lora.yaml``
   as its own process, full width (bf16, rank 8, alpha 16),
   ``FineTune.base_ckpt`` on phase 8's cut checkpoint, phase 10's
   ``GPTDataset`` of ``docs/*.md``, 20 steps at a constant LR of 1e-3
   (``FT_LR``), the fine-tune state saved at step 20. The CLI's counts,
   zeroed just before its fit and read just after: 4 / 4 / 9 / 9 per
   step (rows 1 and 4 on the tensor cores). Finite losses and grad norms,
   the mean of the last 5 losses below the first; 524,288 adapter
   parameters; every adapter leaf
   moved; the artifact and the saved state ``ok`` under
   ``tools.verify_ckpt``; the artifact's stamped base digests and the
   saved state's base leaves equal the cut checkpoint's, and its
   adapters the state's, bit for bit. Step time beside phase 4's, tokens/s,
   peak memory. Then ``tools/serve.build_engine`` on the same yaml
   (the cut checkpoint, the adapters merged, ``quantize_decode``, bf16,
   16 slots, 513 pages) answers phase 2's requests over TCP, in turns
   with the unquantized replica of the same merged weights (quantized,
   unquantized, unquantized, quantized): row 7 in all 4 layers of every
   decode step, tokens/s, TTFT and ITL of each run, beside phase 2's.
   ``python -m fleetx_tpu_torch.tools.serve --bench`` on the same yaml,
   as its own process, must serve its 8 requests on the paged kernel with
   the adapters verified against the base and ``quantize_decode`` on. In
   f32 on the same merged weights, quantize on against off: the
   first-chunk logit drift relative to the largest logit under 0.05 and
   at least half the greedy tokens agreeing; the unquantized replica
   against greedy generation from the saved fine-tune state folded in
   memory (4 prompts × 32 tokens): identical, or apart only where the
   top-two logit gap is under 1e-3.

14. QAT, the dots granularity and the auto-layout entry point (run after
   phase 7; each counted from 0 around its own run):
   (a) ``pretrain_gpt_345M_mp8_qat.yaml`` with ``Distributed.mp_degree=1``
   and phase 4's ``Data`` section at full width, bf16, 10 steps: 8-bit
   fake-quant on, finite losses, phase 4's per-step counts, the step beside
   phase 4's and a 3-step trace; then one f32 loss+grad at 4 layers with
   the kernels on and off (``QAT_ONOFF_*_TOL``). (b) phase 4's recipe,
   seed and batches with ``use_recompute`` and ``recompute_granularity:
   dots`` for 10 steps: the losses equal phase 4's bit for bit
   (``DOTS_LOSS_TOL``), phase 4's per-step counts (the backward reruns
   neither the flash forward nor a norm forward), the peak memory below
   phase 4's; two steps of ``full`` beside it (48 flash and 97 norm
   forwards a step). (c) ``python -m fleetx_tpu_torch.tools.auto`` on
   ``auto/pretrain_gpt_1.3B_single_card.yaml`` (``AUTO_OVERRIDES``:
   synthetic data, 3 steps) as its own process, full width and depth:
   every planned degree 1, the card's memory as the planner's budget and
   no budget warning in its log, the first loss within 0.1 of ``ln(vocab)
   + hidden·r²/2``, ``FULL_PER_STEP`` launches a step on the tensor cores;
   step ms, tokens/s, MFU, peak memory; it starts with the phase and
   runs beside (a) and (b) (their step timings share the card with its
   3 steps). Then rows 1 and 4 at the 1.3B
   attention shape ``[128, 1024, 128]`` bf16 (held and timed as in 1b).

15. the encoder families (run first, while the kernels build; each
   counted from 0 around its own run; no kernel of the port is on their
   path, as no Pallas
   kernel is on JAX's, so every count must stay 0): (a)
   ``pretrain_ernie_345M.yaml`` through ``build_trainer`` → ``fit`` at full
   width (24 layers, hidden 1024, 16 heads, vocab 40000, seq 512, batch
   16, bf16, dropout 0.1) on ``SyntheticErnieDataset`` (``ERNIE_OVERRIDES``;
   the corpus is not in the repository; the LR warmup off, so ten steps
   move the weights) for 10 steps: finite losses, the first within 0.1 of
   ``ln(vocab) + ln 2 + hidden·r²/2``, and the loss of the first step's
   batch (dropout off) at least 0.05 lower after the 10 steps than before
   (an unseen batch's printed beside it); step (median of steps 2-10),
   tokens/s, peak memory, each step's
   ``mlm_loss`` / ``nsp_loss``, a 3-step trace. (b)
   ``ViT_base_patch16_224_pretrain.yaml`` (``VIT_OVERRIDES``: global batch
   4096 → 256, i.e. dp 16 → 1, and ``SyntheticVisionDataset``) at full
   width (12 blocks, 768, patch 16 at 224, 1000 classes, batch 256, bf16,
   DropPath 0.1) for 5 steps: every loss within 1e-2 of ln 1000 (the zero
   head; the labels are random, so no loss can fall below it in
   expectation); step, images/s, peak memory; ``EagerEngine.evaluate`` over
   2 eval batches (samples no step trains on), with top-1 / top-5 from
   ``validation_loss``; a 3-step
   trace of the step alone (device ms beside the host-bound wall). (c)
   ``Engine.run_mode: epoch``: ViT at 2 blocks, ``num_train_epochs`` 2
   over 4 batches of 64 through ``tools.train.run``: 8 steps, epochs 0 and 1 in
   the log, epoch 2 in the checkpoint meta, and the run resumed from it
   takes no step.

16. the last model families (run after phase 15, each counted from 0
   around its own run): (a) ``pretrain_gpt_moe_8expert_mp4.yaml``
   (``MOE_OVERRIDES``: dp 2 and mp 4 → 1, phase 4's synthetic data)
   through ``build_trainer`` → ``fit`` at full width and depth (24 × 1024,
   16 heads, 8 experts, top-2, capacity factor 1.25, aux weight 0.01,
   bf16, global batch 16 in 2 micro-batches of 8) for 10 steps: phase 4's
   per-step counts twice a step (rows 1, 4, 5, 6: 480 / 480 / 980 / 980),
   finite losses, the first LM loss within 0.1 of ``ln(vocab) +
   hidden·r²/2``, the summed aux at step 1 near 24 × 0.01; step (median of
   steps 2-10), tokens/s, peak memory, ``moe_aux`` at every step; an eval
   pass of 4 batches no step trains on (the share of token-choices dropped
   a layer from its routing); greedy generation of 8 prompts × 32 tokens
   on the trained weights (row 5 only, 49 a model call; the decode steps'
   capacity and dropped share); kernels on against off at 4 layers, f32
   (``MOE_ONOFF_TOL``, the flipped token-choices counted). (b)
   ``imagen_397M_text2im_64x64.yaml`` (``IMAGEN_OVERRIDES``:
   ``SyntheticImagenDataset`` at T5 width 1024) at full width, batch 16,
   bf16, for 10 steps, saving step 10: no kernel launches, finite losses,
   the first within a factor 1.5 of 1 plus the untrained output's
   variance; step, images/s, peak memory, the parameter count, a 3-step
   trace (device ms beside the host-bound wall); then one step of
   ``imagen_super_resolution_256.yaml`` at the YAML's batch 8 on 64²
   low-res images. (c) ``tasks/imagen/generate.py``'s cascade: the base
   stage from (b)'s checkpoint, a seeded SR-256 stage, batch 2, guidance
   5.0, dynamic thresholding, ``CASCADE_TIMESTEPS`` steps a stage (cut
   from 1000): ms per denoise step of each stage, the output ``[2, 256,
   256, 3]``, finite, within [-1, 1]; no kernel launches. For the time
   limit (b)'s base run and (c) are a process of their own
   (``imagen_child``, its launches counted there) started with the
   phase, beside (a) (host-bound, 6 GB; the timings of (a), (b) and (c)
   share the card); the SR-256 step (28 GB) follows (a) here.

17. telemetry (run after phase 16): ``pretrain_gpt_345M_synthetic.yaml``
   through ``build_trainer`` → ``fit`` at full width and depth for 10
   steps with ``pretrain_gpt_debug_obs.yaml``'s telemetry (sinks jsonl,
   csv, prometheus; trace, flight, perf), ``Profiler.scheduler: [3, 6]``,
   the recipe's ``prefetch_to_device: 2`` and no save
   (``_telemetry_overrides``). Counts zeroed just before and read just
   after: phase 4's per step. Every step's loss equals phase 4's bit for
   bit, and every batch the step read (copied on the compute stream where
   the step reads it) equals the host batch. ``metrics.jsonl`` holds 5
   schema-valid windows with ``tokens_per_sec``, ``mfu`` and ``hbm_stats:
   "ok"``, the last ``hbm_peak_bytes`` within 1 % of
   ``max_memory_allocated``; ``trace.json`` holds the loop's spans
   (``data_fetch``, ``shard_batch_async``, ``train_step``,
   ``optimizer_update``; no ``shard_batch``); ``perf.jsonl`` one report
   over the window's 3 steps: ``layers`` 24 in both regions, the
   categories and the host gap adding up to the step within 1 %, the
   flash and fused-norm ms a step within 1 % of ``_trace_rows`` on the
   same profile, and rows 1 / 4 / 5 / 6 at 24 / 24 / 49 / 49 launches a
   step in the window, classified ``flash`` / ``fused_norm``; the batch's
   host-to-device copies on a stream other than the compute stream. Then
   ``metrics_report``, ``trace_report``, ``postmortem`` (on a flight dump
   the phase takes) and ``slo_report`` (on phase 2's replica snapshot)
   each as its own process; phase 4's step and the telemetry step in
   turns (4 turns of 6 steps a side, both logging every step, the
   profiler window closed); a bf16 8192³ matmul and a 1 GiB device copy
   timed for the roofline (``calibration``).
18. the resilience runtime (run after phase 12): phase 4's recipe with
   ``Resilience.enable``, the SDC sentinel every 2nd step with
   ``sentinel_action: abort`` (a false positive fails the phase) and
   ``async_save`` at step 5, 8 steps through ``build_trainer`` → ``fit``.
   Counts zeroed just before and read just after: 12 × phase 4's per step
   (8 steps, 4 replays); 4 checks, 0 mismatches; the losses equal phase
   4's first 8 bit for bit. Each check's wall, each step's host wall, the
   save's stall (step 5's wall less the median of steps 3 and 7, the
   steps with neither a check nor a save; the phase's own clone of the
   live state excluded) beside phase 8's synchronous ``save_s``, the
   steps over the write (6-8) against 2-4, the finalize wait at fit's
   end. The payload: completed steps ``[5]``, ``verify_ckpt`` ok, and the
   manifest's leaf digests (the writer's) equal to the crc32 of every leaf
   of a clone of the live state taken as the save returned. ``params_fingerprint`` of
   the final params on the card equals the CPU's; ``_apply_bitflip``
   changes it and a second flip restores it. ``python -m
   fleetx_tpu_torch.resilience.integrity --selftest`` reports ok on
   ``cuda``; ``python -m fleetx_tpu_torch.tools.supervise --preflight``
   with ``FLEETX_SELFTEST_FORCE_FAIL=*`` exits 41 and its command never
   runs.

19. the router, the fleet and a real corpus (run after phase 13, while
   phase 8's cut checkpoint, phase 9's tokenizer and ``docs/*.md`` are
   there; the fleet boots and the shards preprocess while 19a runs):
   (a) the port's ``Router`` (``serving/router.py``, ``ROUTER_BLOCK``:
   hedge after ``ROUTER_HEDGE_MS``) in front of two in-process
   ``ReplicaServer``s, each its own engine from ``serving_gpt_345M.yaml``
   through ``tools.serve``'s config and ``build_engine`` on the cut
   checkpoint (full width, bf16, ``CUT_LAYERS`` layers), the second a
   straggler (``slow_decode_ms_at``, ``STRAGGLER_MS`` a step): phase 2's 8
   requests of 32 new tokens through the router, each token-identical to
   the first replica's direct answer; the counts zeroed just before and
   read just after: row 7's launches equal ``CUT_LAYERS`` × the decode
   steps of both engines; at least one hedge and one cancel. (b) ``python
   -m fleetx_tpu_torch.tools.supervise --elastic`` over ``FLEET_SIZE``
   replica processes (``python -m fleetx_tpu_torch.tools.serve`` on the
   same config) on this card, started together, each armed by its member
   id (``FLEET_FAULTS``: a straggler, a replica silent after 4
   responses, one that tears its 3rd response and exits), warmed directly
   (identical answers); ``tools.serve --router --fleet-out`` in front:
   a burst of ``FLEET_BURST`` requests, each token-identical to 19a's
   direct answer or a classified refusal, none lost; the supervisor
   restarts the crashed member alone, the router's probe half-opens it and
   a trial request closes it; the fleet records validate and show breaker
   opens and closes, hedges and a re-dispatch; a re-dispatched request's
   merged ``trace`` through the router. (c) ``run_commands`` preprocesses
   ``docs/*.md`` in ``CORPUS_SHARDS`` shards, one ``tools.preprocess_data``
   process each; a ``BlendedDataset`` of their ``GPTDataset``s, through
   ``build_trainer``, takes its indices from the native builder
   (``data/native``, built with ``g++`` into ``fleetx_tpu_torch/_build/``;
   held to the numpy builders byte for byte); phase 4's recipe at full
   width and depth at ``FT_LR`` trains ``CORPUS_STEPS`` steps on it: the
   last loss below the first, phase 4's per-step counts.
20. serving over a mesh of ranks on this card (``MESH_RANKS`` processes
   sharing it over gloo, the backend rule's choice for ranks without a
   card each): (a) ``python -m fleetx_tpu_torch.tools.supervise
   --num-procs 4 -- python -m fleetx_tpu_torch.tools.serve`` on
   ``serving_gpt_345M.yaml`` at fsdp 2 × mp 2 on phase 8's checkpoint
   (24 layers, f32; the pool cut from 513 to ``MESH_PAGES`` = 514 pages
   to split over fsdp): a warm-up request alone, then phase 2's 8
   requests (32 new) over TCP, every answer token-identical to the
   one-rank f32 engine on the same checkpoint in this process; every
   rank on gloo with a ``[24, 257, 16, 8, 64]`` pool and row 7 at 24 ×
   its decode steps (its own count, reported at the drain); rank 0's
   heads of the first decode step's layer-0 attention (``--attn-tap``)
   within ``MESH_ATTN_ATOL`` of the one-rank engine's; SIGTERM drains
   every rank with 75. (b) the recipe's bf16 on seeded weights: a gang of
   ``mesh_child`` (rank 0 submits phase 2's prompts to
   ``ServingEngine(mesh=...)``, the others ``follow()``): greedy
   agreement and the first decode step's logits drift below
   ``MESH_DRIFT`` of the largest magnitude against the one-rank bf16
   engine. (c) ``tools.inference`` on ``inference_gpt_345M_dp8.yaml``
   at dp ``DP_RANKS`` over phase 11's bf16 generation export
   (``inference_child`` counts each rank's launches): its outputs equal
   the one-rank ``InferenceEngine``'s on the same inputs, and each
   rank's launches of rows 1 and 5 equal one call's; a batch of distinct
   rows, one a rank, gathered on every rank, equals the one-rank
   engine's ids on each row. Phase 1 holds row
   7 at a shard's shape too (8 and 4 heads, 257 local pages, the other
   shard's pages as ``-1`` entries through the tables, a row of only
   foreign pages exactly ``(-1e30, 0, 0)``).
21. sharded training over a gang of ``TRAIN_MESH_RANKS`` (4) ranks on
   this card, each gang ``tools.supervise --num-procs 4 --
   tools.train`` (its members ``train_mesh_child``: ``tools.train``'s
   ``main`` with the launch counts zeroed just before ``fit`` and read
   just after; one JSON report a rank), gloo over the shared card. 21a:
   phase 4's recipe (GPT-345M at full width and depth, its seed and
   synthetic batches) at dp 2 × mp 2 with sequence parallelism and the
   gang resilience runtime (``MESH_RESILIENCE``: the gang watchdog's
   barrier every step, the loop vote every step, the SDC sentinel every
   2nd round, asynchronous saves, ``Observability.gang``), in two
   generations: a SIGTERM on rank 1 alone (``MESH_FAULTS``) makes every
   rank save step 3 through the two-phase commit and exit 75, the saved
   parameters' fingerprint (each leaf's block sums psum'd) equal on every
   rank and to the gathered tree's; a second ``tools.supervise`` resumes
   every rank from that step (the restored fingerprint the saved one)
   and trains step 4. Each rank holds 8 of the 16 heads, half the
   vocabulary and a half of the sequence between the regions; the 4
   losses within ``MESH_345M_LOSS_ATOL`` of phase 4's first 4, every
   rank the same losses; one sentinel check with a clean census; a
   gang-watchdog barrier a step; rank 0's ``metrics.gang.jsonl`` with the
   4 windows of all 4 ranks; rows 1, 4, 5 and 6 launched 24 / 24 / 49 /
   49 times a step and a replay on every rank in each generation (tensor
   cores, the norms on route "rows"); each rank's peak memory, step
   walls and collectives. 21b: GPT-6.7B's recipe
   (``pretrain_gpt_6.7B_sharding16.yaml``: width 4096, 32 heads of 128,
   full recompute) at fsdp 4, ZeRO stage 2, cut to ``SIXB_LAYERS`` layer
   and 2 rows a rank, 3 steps and the gang's save; this process loads
   that checkpoint on one rank (an eval engine) and its
   ``params_fingerprint`` must equal the one every rank computed on its
   gathered parameters; 2 / 1 / 5 / 3 launches a step a rank. 21c: a
   per-rank pair (``per_rank_member``: two processes, each a 345M
   replica at full width and ``DRILL_LAYERS`` deep on a mesh of one with
   ``per_rank_dirs``); rank 1 alone gets a bit flip after step 2 and NaN
   losses at steps 6-7 (``PAIR_FAULTS``): the census of round 5 counts
   one fingerprint mismatch on both ranks, both roll back once to step 5,
   and both abort at step 7 (exit 3). 21a's first generation and 21b run
   at once (host-bound steps; each rank's allocator on expandable
   segments, and the engine releases each leaf's raw grad as it syncs
   it); when 21b exits, 21c and 21a's second generation start, the
   second generation held at a gate until the first has exited. Phase
   1b holds rows 1-4 at a rank's block of the 345M launch
   (``OFFSET_HEADS``: rows 4-7, heads 8-15) against their plain versions
   with the same head map, in f32 and bf16, and recovers the four
   kernels' dropout masks there by the identity probes: the block of the
   one-rank mask, bit for bit.

Each phase's wall is printed as it ends (``phase_wall``) and collected in
the ``smoke`` line.

Last, row 1 at the eval shape ``[128, 1024, 64]`` bf16 causal with no
dropout against its plain versions, timed (CUDA events with the L2
flushed, and profiler device time) beside SDPA's flash forward and its
bound, and again at rate 0.1 in the same call.

Tolerances, kernel against its plain version (both compute in f32 after
casting q and k; only the summation order differs): ``acc`` and ``l``
rtol 1e-5 / atol 1e-4 (sums of up to 1024 O(1) terms), ``m`` rtol 1e-5 /
atol 1e-5; the normalised output atol 1e-5 with rtol 1e-5 in f32 and
one bf16 ulp (2**-7) in bf16.

Tolerances of the training kernels against their plain versions (both
compute in f32 from the same operands; only summation order and the
rounding of a bf16 output differ): f32 outputs rtol 1e-5 / atol 1e-5
(flash ``out``/``lse``/dq/dk/dv of the fused and split backward, norm
``out``/``mean``/``var``/dx; the split pair against the fused kernel);
bf16 outputs one bf16 ulp (rtol 2**-7, atol 1e-5); the norm's ``s`` and
the dropout masks exactly. The tensor-core kernels (forward, fused
backward, dq and dk/dv; bf16 / fp16 at head_dim 64 and 128) round P and
dS to the operand type before their products, as every GPU
FlashAttention does; they are held to the plain
version that rounds at the same places (``round_operands``) within
``TC_RTOL`` of each element plus ``TC_ATOL_SHARE`` of the largest
magnitude, and to the unrounded plain version within ``TC_DRIFT`` of the
largest magnitude (reasons beside the constants). Training path, kernels on against off (f32):
loss within 1e-4 and every grad leaf within 1e-3 of its largest
magnitude (24 layers of f32 summed in another order).

The build also prints ``ptxas -v`` of every tensor-core kernel
(registers, spill bytes) beside its dynamic shared memory. The
third-to-last line is the ``kernels`` JSON record (each row's
``launches`` from its main path, and ``launches_by_path`` from every
path that runs it, each counted from 0 around its own run); the last
line is ``{"ok": true, "device": {...}}``. Without CUDA the script exits
non-zero and prints no result.
"""

import ast
import concurrent.futures
import ctypes
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from typing import Optional

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
YAML = os.path.join(REPO, "fleetx_tpu", "configs", "nlp", "gpt",
                    "serving_gpt_345M.yaml")
TRAIN_YAML = os.path.join(REPO, "fleetx_tpu", "configs", "nlp", "gpt",
                          "pretrain_gpt_345M_synthetic.yaml")
SEQ8K_YAML = os.path.join(REPO, "fleetx_tpu", "configs", "nlp", "gpt",
                          "pretrain_gpt_1.3B_seq8k_ring.yaml")
#: the long-context recipe on one card with synthetic data (README)
SEQ8K_OVERRIDES = ["Distributed.dp_degree=1", "Distributed.seq_degree=1",
                   "Data.Train.dataset.name=SyntheticGPTDataset",
                   "Data.Train.dataset.seq_length=8192",
                   "Data.Train.dataset.vocab_size=50304",
                   "Engine.max_steps=3", "Engine.eval_freq=0",
                   "Engine.save_load.save_steps=0"]

#: H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, f32
#: FLOP/s outside the tensor cores, bf16 dense tensor-core FLOP/s (fp16's
#: dense tensor-core peak is the same)
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
#: the dtypes whose products run on the tensor cores at PEAK_BF16_FLOPS
TC_PEAK_DTYPES = (torch.bfloat16, torch.float16)

# 345M serving decode geometry (serving_gpt_345M.yaml)
B, NH, HD, PS, PPR, PAGES = 16, 16, 64, 16, 64, 513
#: ragged query positions: inactive (-1), the first slot (0), the last
#: slot of page 0 (15), the first slot of page 1 (16), the full table
#: (1023), and a spread in between
LENS = [-1, 0, 15, 16, 1023, 511, 100, 777, 256, 31, 1000, 64, 900, 5,
        300, 1022]


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


#: bytes of the card that each peak reset's collect freed, in run order
COLLECT_FREED: list = []
#: what held the card bytes a collect freed: the reset's index and the
#: Python frames and classes among the collected objects
COLLECT_HOLDERS: list = []


def reset_peak(dev: Optional[torch.device] = None) -> None:
    """Free the earlier phases' unreachable objects first, recording the
    card bytes that freed (a finished engine caught in a reference cycle
    would hold its parameters and optimizer state until the cyclic
    collector ran) and, when it freed any, the frames and classes of what
    it collected; then start the card's peak memory count afresh: each
    peak is its own run's."""
    before = torch.cuda.memory_allocated(dev)
    gc.set_debug(gc.DEBUG_SAVEALL)     # keep what the collect finds
    try:
        gc.collect()
    finally:
        gc.set_debug(0)
    garbage, gc.garbage[:] = list(gc.garbage), []
    frames = sorted({f"{os.path.basename(o.f_code.co_filename)}:"
                     f"{o.f_code.co_name}" for o in garbage
                     if type(o).__name__ == "frame"})
    classes = sorted({type(o).__name__ for o in garbage
                      if type(o).__module__.startswith("fleetx_tpu_torch")})
    del garbage
    gc.collect()
    freed = before - torch.cuda.memory_allocated(dev)
    COLLECT_FREED.append(freed)
    if freed:
        COLLECT_HOLDERS.append(dict(reset=len(COLLECT_FREED) - 1,
                                    freed=freed, classes=classes,
                                    frames=frames[:40]))
    torch.cuda.reset_peak_memory_stats(dev)


#: phase → seconds of wall, in the order the phases ran
PHASE_WALLS: dict = {}


def timed(phase: str, fn, *args):
    """``fn(*args)`` with its wall recorded under ``phase`` and printed."""
    t0 = time.perf_counter()
    try:
        return fn(*args)
    finally:
        PHASE_WALLS[phase] = time.perf_counter() - t0
        emit("phase_wall", of=phase, seconds=PHASE_WALLS[phase])


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# --------------------------------------------------------------- phase 0
def phase_env(build) -> str:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    nvcc = subprocess.run([build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[-1]
    card = smi_line()
    emit("env", python=sys.version.split()[0], torch=torch.__version__,
         torch_cuda=torch.version.cuda, nvcc=nvcc, nvidia_smi=card,
         device=torch.cuda.get_device_name(0),
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    return card


# --------------------------------------------------------------- phase 1
def time_ms(fn, flush: torch.Tensor, iters: int = 50,
            warmup: int = 5) -> float:
    """Median device time of ``fn`` over ``iters`` launches, each after
    an L2 flush (a decode step reads every layer's pool cold)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


#: the three decode shapes row 7 is timed at (B, NH, HD, PS, PPR, PAGES
#: as above; bf16): ``LENS`` (ragged), the main path's decode step as the
#: trace phase runs it (8 rows at ~100 positions, 8 inactive slots), and
#: the full pool (512 usable pages, every row at 511)
PAGED_SHAPES = {"ragged": LENS,
                "main_path": [100, 101, 102, 103, 104, 100, 101, 102]
                + [-1] * 8,
                "full_pool": [511] * 16}
#: geometries beyond the 345M one the kernel is held to its plain
#: versions at: (name, dtype, B, nh, hd, ps, pages per request, pages,
#: lens). nh 14: head blocks of 4, 4, 4 and 2 (the last box reads two
#: heads past the row as zeros); hd 256 at ps 32 in f32: a page is two row
#: tiles of one head; B 1: one request split over the most chunks, merged
#: by one block
PAGED_GEOMETRIES = (
    ("hd128", torch.bfloat16, 16, 16, 128, 16, 64, 513, LENS),
    ("hd128_f32", torch.float32, 16, 16, 128, 16, 64, 513, LENS),
    ("ps8", torch.bfloat16, 16, 16, 64, 8, 128, 1025, LENS),
    ("nh14", torch.bfloat16, 16, 14, 64, 16, 64, 513, LENS),
    ("hd256_ps32_f32", torch.float32, 4, 3, 256, 32, 32, 129,
     [-1, 1023, 40, 31]),
    ("b1", torch.bfloat16, 1, 16, 64, 16, 64, 65, [1023]),
)


def device_ms(fn, flush: Optional[torch.Tensor], pattern: str = "",
              iters: int = 20, exclude: tuple = ()) -> float:
    """Device time per call of ``fn`` spent in the kernels whose name holds
    ``pattern`` (every kernel: "") and none of ``exclude`` (the flush's
    fill), each call after an L2 flush (L2 warm when ``flush`` is None):
    ``torch.profiler``'s record of the kernel alone, without the launch
    and event overhead that ``time_ms`` also holds (about 5 µs for an
    empty op)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            if flush is not None:
                flush.zero_()
            fn()
        torch.cuda.synchronize()
    return sum(_device_us(e) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and pattern in e.key
               and not any(s in e.key for s in exclude)) / 1e3 / iters


def decode_case(dtype: torch.dtype, dev: torch.device, lens=LENS, b=B,
                nh=NH, hd=HD, ps=PS, ppr=PPR, pages=PAGES):
    """Seeded inputs at one decode geometry (default: 345M's): pools, q,
    raw tables (NULL_PAGE tails), localized tables (-1 tails), lens. Each
    row holds the pages its lens need, drawn without replacement."""
    from fleetx_tpu_torch.serving.paged_cache import NULL_PAGE

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    shape = (pages, ps, nh, hd)
    pk = torch.randn(shape, generator=gen, device=dev).to(dtype)
    pv = torch.randn(shape, generator=gen, device=dev).to(dtype)
    q = torch.randn((b, nh, hd), generator=gen, device=dev).to(dtype)
    rng = np.random.RandomState(0)
    free = list(rng.permutation(np.arange(1, pages)))
    tables = np.full((b, ppr), NULL_PAGE, np.int32)
    for row, n in enumerate(lens):
        used = -(-(n + 1) // ps) if n >= 0 else 0
        tables[row, :used] = [free.pop() for _ in range(used)]
    local = np.where(tables != NULL_PAGE, tables, -1).astype(np.int32)
    as_dev = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return (q, pk, pv, as_dev(tables), as_dev(local),
            as_dev(np.asarray(lens, np.int32)))


def paged_bound(itemsize: int, lens=LENS, b=B, nh=NH, hd=HD, ppr=PPR):
    """(bound_ms, bound_by): each input read once, each output written
    once, the K/V rows this run's lens need and no more."""
    rows = sum(n + 1 for n in lens if n >= 0)
    nbytes = (b * nh * hd * itemsize              # q
              + rows * nh * hd * 2 * itemsize     # K and V rows read
              + b * ppr * 4 + b * 4               # tables, lens
              + b * nh * hd * 4 + 2 * b * nh * 4)  # acc, m, l
    flops = rows * nh * hd * 4                    # q.k and p.v, f32 FMAs
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _hold_paged(PA, case, lens, what: str) -> dict:
    """Hold the kernel to both plain versions (the split one at the
    kernel's own chunking) on one case: the inactive row exact zeros, a
    repeated call bitwise identical. Returns the largest errors."""
    q, pk, pv, tables, local, lens_t = case
    acc, m, l = PA.paged_call(q, pk, pv, local, lens_t)
    again = PA.paged_call(q, pk, pv, local, lens_t)
    plan = PA._plan_for(q, pk, local)
    refs = {"plain": PA.paged_call_plain(q, pk, pv, local, lens_t),
            "plain_split": PA.paged_call_plain_split(
                q, pk, pv, local, lens_t, plan.pages_per_chunk)}
    torch.cuda.synchronize()
    errs = {}
    for name, (r_acc, r_m, r_l) in refs.items():
        msg = f"paged {what} vs {name}"
        torch.testing.assert_close(acc, r_acc, rtol=1e-5, atol=1e-4, msg=msg)
        torch.testing.assert_close(l, r_l, rtol=1e-5, atol=1e-4, msg=msg)
        torch.testing.assert_close(m, r_m, rtol=1e-5, atol=1e-5, msg=msg)
        errs[f"{name}_max_abs_err"] = _max_err(
            [(acc, r_acc), (m, r_m), (l, r_l)])
    check(all(torch.equal(x, y) for x, y in zip((acc, m, l), again)),
          f"paged {what}: a repeated call is not bitwise identical")
    dtype = q.dtype
    out = PA.paged_attention(q, pk, pv, tables, lens_t)
    ref = PA._normalize(refs["plain"][0], refs["plain"][2], dtype)
    rtol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(out, ref, rtol=rtol, atol=1e-5,
                               msg=f"paged {what} normalised")
    for row, n in enumerate(lens):
        if n < 0:
            check(bool((out[row] == 0).all()),
                  f"paged {what}: inactive row {row} is not exact zeros")
    errs["out_max_abs_err"] = float((out.float() - ref.float()).abs().max())
    errs["plan"] = [plan.route, plan.head_block, plan.rows_per_tile,
                    plan.pages_per_chunk, plan.slots, plan.smem_bytes]
    return errs


def time_paged(PA, dev: torch.device, flush: torch.Tensor) -> dict:
    """Row 7 at the three bf16 decode shapes: the kernel, its plain
    version and gather + SDPA (the yardstick; the port never calls it),
    each with the bound of that shape's lens. Uses only ``paged_call``
    and ``paged_call_plain``, so ``--paged-shapes`` can time an earlier
    tree's kernel too."""
    out = {}
    for shape, lens in PAGED_SHAPES.items():
        q, pk, pv, _, local, lens_t = decode_case(torch.bfloat16, dev, lens)
        safe = torch.where(local >= 0, local, 0).long()
        pos = torch.arange(PPR * PS, device=dev)
        mask = ((local >= 0).repeat_interleave(PS, dim=1)
                & (pos[None] <= lens_t[:, None].long())
                & (lens_t[:, None] >= 0))[:, None, None, :]

        def library():
            kd = pk[safe].reshape(B, PPR * PS, NH, HD).transpose(1, 2)
            vd = pv[safe].reshape(B, PPR * PS, NH, HD).transpose(1, 2)
            return torch.nn.functional.scaled_dot_product_attention(
                q[:, :, None], kd, vd, attn_mask=mask)

        kernel = lambda: PA.paged_call(q, pk, pv, local, lens_t)  # noqa: E731
        ms = time_ms(kernel, flush)
        plain_ms = time_ms(
            lambda: PA.paged_call_plain(q, pk, pv, local, lens_t), flush)
        library_ms = time_ms(library, flush)
        bound_ms, bound_by = paged_bound(pk.element_size(), lens)
        rows = sum(n + 1 for n in lens if n >= 0)
        out[shape] = dict(ms=ms, device_ms=device_ms(kernel, flush, "paged_"),
                          plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          kv_bytes=rows * NH * HD * 2 * pk.element_size())
        emit("paged_shape", shape=shape, **out[shape])
    return out


def phase_kernels(build, dev: torch.device, build_s: float) -> dict:
    from fleetx_tpu_torch.ops import paged_attention as PA

    emit("build", seconds=build_s, libraries=sorted(build.SOURCES),
         ptxas=[l for log in build.build_logs.values()
                for l in log.splitlines() if "registers" in l
                or "Compiling entry" in l or "spill" in l])
    smem_bytes = build.load("flash_attention").fleetx_flash_tc_smem_bytes
    smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    smem_bytes.restype = ctypes.c_int
    emit("ptxas_tensor_core", kernels=_ptxas_summary(
        build.build_logs.get("flash_attention", ""), "_kernel_tc"),
        dynamic_smem_bytes={
            name: {d: smem_bytes(i, d) for d in (64, 128)}
            for i, name in enumerate(TC_KERNELS)})
    paged_smem = build.load("paged_attention").fleetx_paged_smem_bytes
    paged_smem.argtypes = [ctypes.c_int] * 6
    paged_smem.restype = ctypes.c_int
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    result = {}
    for name, dtype in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        for shape, lens in PAGED_SHAPES.items():
            errs = _hold_paged(PA, decode_case(dtype, dev, lens), lens,
                               f"{name} {shape}")
            emit("paged_check", dtype=name, shape=shape, **errs)
            if shape == "ragged":
                result[name] = dict(max_abs_err=errs["out_max_abs_err"],
                                    variant=errs["plan"][0])
    for what, dtype, b, nh, hd, ps, ppr, pages, lens in PAGED_GEOMETRIES:
        case = decode_case(dtype, dev, lens, b, nh, hd, ps, ppr, pages)
        errs = _hold_paged(PA, case, lens, what)
        _, hb, rb, ppc, slots, smem = errs["plan"]
        check(paged_smem(hb, rb, hd, case[1].element_size(), slots,
                         ppc) == smem,
              f"paged {what}: plan_split's shared memory differs from the "
              f"kernel's")
        emit("paged_check", geometry=what, dtype=str(dtype), B=b, nh=nh,
             hd=hd, ps=ps, pages_per_req=ppr, **errs)
    result["shard_shapes"] = _hold_shard_shapes(PA, paged_smem, dev)
    shapes = time_paged(PA, dev, flush)
    result["bfloat16"].update(shapes["ragged"])
    result["bfloat16"]["shapes"] = shapes
    emit("kernel", name="paged_attention_decode", dtype="bfloat16",
         **{k: v for k, v in result["bfloat16"].items() if k != "shapes"})
    return result


def _ptxas_summary(log: str, pattern: str) -> list:
    """``[kernel, "Used ... registers ... smem", "... spill ..."]`` of
    every kernel whose name holds ``pattern``, from ``nvcc -Xptxas -v``
    (the smem there is the static part; the tiles are dynamic)."""
    out = []
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line
            short = re.search(r"([a-z_]+_kernel_tc)I\d+(\w+?)Li(\d+)E",
                              name)
            if short:  # e.g. flash_fwd_kernel_tc<__nv_bfloat16, 128>
                name = f"{short[1]}<{short[2]}, {short[3]}>"
            out.append([name] if pattern in name else None)
        elif out and out[-1] is not None and (
                "spill" in line or "Used" in line):
            out[-1].append(line.strip())
    return [entry for entry in out if entry is not None]


# -------------------------------------------------------------- phase 1b
#: GPT-345M training shapes (pretrain_gpt_345M_synthetic.yaml): batch 8,
#: seq 1024, 16 heads of 64, hidden 1024; attention dropout 0.1
TB, TS, TNH, THD, TH, RATE = 8, 1024, 16, 64, 1024, 0.1
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.bfloat16: dict(rtol=2.0 ** -7, atol=1e-5),
       # one fp16 ulp (10 mantissa bits): both round the same f32 value
       torch.float16: dict(rtol=2.0 ** -10, atol=1e-5)}
#: the tensor-core kernels (forward and dk/dv, bf16 / fp16 at head_dim 64
#: and 128) against the plain version that rounds P / dS where they do
#: (``round_operands``): one bf16 ulp of each element (rtol 2**-7) plus
#: one bf16 ulp of the tensor's largest magnitude (the forward rounds P
#: against the running max, the plain version against the final one, and
#: exp2 is not exp, so single P terms may round to neighbouring bf16
#: values; a layout or pipeline fault moves outputs by O(largest))
TC_RTOL, TC_ATOL_SHARE = 2.0 ** -7, 2.0 ** -7
#: ... and against the unrounded plain version: the largest difference at
#: most 2**-6 of the tensor's largest magnitude (one bf16 rounding of a P
#: or dS term is a relative error of at most 2**-9; summed over a row with
#: mixed signs the drift stays within a few bf16 ulps of the largest
#: output)
TC_DRIFT = 2.0 ** -6
#: the tensor-core kernels, in the order of ``fleetx_flash_tc_smem_bytes``
TC_KERNELS = ("flash_fwd_kernel_tc", "flash_bwd_kernel_tc",
              "flash_bwd_dq_kernel_tc", "flash_bwd_dkv_kernel_tc")


def _hold_tc(got, rounded, unrounded, what: str):
    """Hold a tensor-core output to the rounded plain version (tight) and
    to the unrounded one (drift bound); returns both largest errors."""
    got, rounded, unrounded = (t.float() for t in (got, rounded, unrounded))
    torch.testing.assert_close(
        got, rounded, rtol=TC_RTOL,
        atol=TC_ATOL_SHARE * float(rounded.abs().max()), msg=what)
    err = float((got - rounded).abs().max())
    drift = float((got - unrounded).abs().max())
    check(drift <= TC_DRIFT * float(unrounded.abs().max()),
          f"{what}: drift {drift} from the unrounded plain version exceeds "
          f"2**-6 of its largest magnitude")
    return err, drift


def _peak_flops(dtype: torch.dtype) -> float:
    return PEAK_BF16_FLOPS if dtype in TC_PEAK_DTYPES else PEAK_F32_FLOPS


def _bound(nbytes: float, flops: float, dtype: torch.dtype):
    """(bound_ms, bound_by): bytes over HBM rate vs ops over the dtype's
    peak, whichever is larger."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / _peak_flops(dtype)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _max_err(pairs) -> float:
    return max(float((a.float() - b.float()).abs().max()) for a, b in pairs)


def _flash_case(dtype: torch.dtype, dev: torch.device,
                shape=(TB, TNH, TS, THD)):
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    b, nh, s, hd = shape
    return [torch.randn((b * nh, s, hd), generator=gen, device=dev).to(dtype)
            for _ in range(4)]


def _flash_rows(dtype, dev, flush, shape=(TB, TNH, TS, THD)) -> dict:
    """Flash forward and fused backward against their plain versions, with
    dropout 0.1, and their timings, at ``shape`` = ``(batch, heads, seq,
    head_dim)`` (default: the GPT-345M training shape)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from fleetx_tpu_torch.ops import flash_attention as FA

    fb, fnh, fs, fhd = shape
    q, k, v, do = _flash_case(dtype, dev, shape)
    seed, scale = 20240607, fhd ** -0.5
    tc = FA.tc_route(dtype, fhd)
    out, lse = FA.fwd_call(q, k, v, seed, scale, True, RATE)
    p_out, p_lse = FA.fwd_plain(q, k, v, seed, scale, True, RATE,
                                round_operands=tc)
    torch.cuda.synchronize()
    tc_errs = {}
    if tc:
        tc_errs["fwd_vs_rounded"], tc_errs["fwd_drift"] = _hold_tc(
            out, p_out, FA.fwd_plain(q, k, v, seed, scale, True, RATE)[0],
            "flash fwd (tensor cores)")
    else:
        torch.testing.assert_close(out, p_out, **TOL[dtype])
    torch.testing.assert_close(lse, p_lse, **TOL[torch.float32])
    delta = (out.float() * do.float()).sum(-1)
    bwd_args = (q, k, v, do, lse, delta, seed, scale, True, RATE)
    bwd_tc = {}
    dq, dk, dv = FA.bwd_call(*bwd_args)
    p_dq, p_dk, p_dv = FA.bwd_plain(*bwd_args, round_operands=tc)
    torch.cuda.synchronize()
    if tc:
        unrounded = FA.bwd_plain(*bwd_args)
        for name, got, want, plain in zip(("dq", "dk", "dv"), (dq, dk, dv),
                                          (p_dq, p_dk, p_dv), unrounded):
            bwd_tc[f"{name}_vs_rounded"], bwd_tc[f"{name}_drift"] = \
                _hold_tc(got, want, plain, f"fused bwd {name} (tensor cores)")
        del unrounded
        # deterministic: one CTA per head adds its dq partials in a fixed
        # order, so a second call gives the same bits
        again = FA.bwd_call(*bwd_args)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again)),
              "fused bwd (tensor cores): a repeated call differs")
        bwd_tc["bitwise_repeatable"] = True
        del again
    else:
        torch.testing.assert_close(dq, p_dq, **TOL[torch.float32])
        torch.testing.assert_close(dk, p_dk, **TOL[dtype])
        torch.testing.assert_close(dv, p_dv, **TOL[dtype])
    fwd_err = _max_err([(out, p_out), (lse, p_lse)])
    bwd_err = _max_err([(dq, p_dq), (dk, p_dk), (dv, p_dv)])
    del p_out, p_lse, p_dq, p_dk, p_dv

    # the yardsticks: SDPA (flash backend in bf16 / fp16) forward and its
    # autograd backward on the same data in [b, heads, s, d] (never called
    # by the port)
    def four(t):
        return t.reshape(fb, fnh, fs, fhd)

    backend = ([SDPBackend.FLASH_ATTENTION] if dtype in TC_PEAK_DTYPES else
               [SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH])
    sq, sk, sv = (four(t).detach().clone().requires_grad_(True)
                  for t in (q, k, v))
    with sdpa_kernel(backend):
        def lib_fwd():
            return torch.nn.functional.scaled_dot_product_attention(
                four(q), four(k), four(v), dropout_p=RATE, is_causal=True)
        lib_out = torch.nn.functional.scaled_dot_product_attention(
            sq, sk, sv, dropout_p=RATE, is_causal=True)
        fwd_lib_ms = time_ms(lib_fwd, flush)
        bwd_lib_ms = time_ms(lambda: torch.autograd.grad(
            lib_out, (sq, sk, sv), four(do), retain_graph=True), flush)
    del lib_out, sq, sk, sv

    bh = fb * fnh
    pairs = fs * (fs + 1) // 2          # causal (row, col) pairs per head
    item = q.element_size()
    fwd_bytes = 4 * bh * fs * fhd * item + bh * fs * 4   # q,k,v,out + lse
    bwd_bytes = (6 * bh * fs * fhd * item + 2 * bh * fs * 4  # q,k,v,do,dk,dv
                 + bh * fs * fhd * 4)                        # + lse,delta,dq
    fwd = dict(
        max_abs_err=fwd_err, variant="wgmma" if tc else "simt", **tc_errs,
        ms=time_ms(lambda: FA.fwd_call(q, k, v, seed, scale, True, RATE),
                   flush),
        plain_ms=time_ms(lambda: FA.fwd_plain(q, k, v, seed, scale, True,
                                              RATE), flush, iters=10),
        library_ms=fwd_lib_ms)
    fwd["bound_ms"], fwd["bound_by"] = _bound(
        fwd_bytes, 2 * 2 * pairs * fhd * bh, dtype)
    bwd = dict(
        max_abs_err=bwd_err, variant="wgmma" if tc else "simt", **bwd_tc,
        ms=time_ms(lambda: FA.bwd_call(q, k, v, do, lse, delta, seed, scale,
                                       True, RATE), flush, iters=20),
        plain_ms=time_ms(lambda: FA.bwd_plain(q, k, v, do, lse, delta, seed,
                                              scale, True, RATE), flush,
                         iters=10),
        library_ms=bwd_lib_ms)
    bwd["bound_ms"], bwd["bound_by"] = _bound(
        bwd_bytes, 5 * 2 * pairs * fhd * bh, dtype)
    return {"flash_attention_fwd": fwd, "flash_attention_bwd_fused": bwd}


def _norm_rows(dtype, dev, flush, shape=(TB, TS, TH)) -> dict:
    """Fused residual+LayerNorm forward and backward against their plain
    versions, with and without the residual / ``ds_in``, and timings, at
    ``shape`` (default: the GPT-345M training rows)."""
    from fleetx_tpu_torch.ops import fused_norm as FN

    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    hidden, eps = shape[-1], 1e-5
    x, r, dout, ds_in = (torch.randn(shape, generator=gen, device=dev).to(
        dtype) for _ in range(4))
    w = 1.0 + 0.1 * torch.randn(hidden, generator=gen, device=dev)
    b = 0.1 * torch.randn(hidden, generator=gen, device=dev)
    errs = {"fwd": [], "bwd": []}
    for res in (r, None):
        got = FN.fwd_call(x, res, w, b, eps, dtype)
        want = FN.fwd_plain(x, res, w, b, eps, dtype)
        torch.cuda.synchronize()
        torch.testing.assert_close(got[0], want[0], **TOL[dtype])
        torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
        for i in (2, 3):
            torch.testing.assert_close(got[i], want[i],
                                       **TOL[torch.float32])
        errs["fwd"].append(_max_err(zip(got, want)))
        s, mean, var = got[1], got[2], got[3]
        for dsi in (ds_in, None):
            dx = FN.bwd_call(s, w, mean, var, dout, eps, dsi)
            p_dx = FN.bwd_plain(s, w, mean, var, dout, eps, dsi)
            torch.cuda.synchronize()
            torch.testing.assert_close(dx, p_dx, **TOL[dtype])
            errs["bwd"].append(_max_err([(dx, p_dx)]))
    out, s, mean, var = FN.fwd_call(x, r, w, b, eps, dtype)

    # the yardsticks: F.layer_norm after the add, and its autograd
    # backward for the input plus the downstream ds_in (layer_norm takes
    # its affine parameters in the input dtype)
    lw, lb = w.to(dtype), b.to(dtype)
    s_leaf = (r + x).detach().requires_grad_(True)
    lib_out = torch.nn.functional.layer_norm(s_leaf, (hidden,), lw, lb, eps)
    fwd_lib_ms = time_ms(lambda: torch.nn.functional.layer_norm(
        r + x, (hidden,), lw, lb, eps), flush)
    bwd_lib_ms = time_ms(lambda: torch.autograd.grad(
        lib_out, s_leaf, dout, retain_graph=True)[0] + ds_in, flush)
    del lib_out, s_leaf

    item, n = x.element_size(), x.numel()
    rows = n // hidden
    fwd = dict(
        max_abs_err=max(errs["fwd"]),
        ms=time_ms(lambda: FN.fwd_call(x, r, w, b, eps, dtype), flush),
        plain_ms=time_ms(lambda: FN.fwd_plain(x, r, w, b, eps, dtype),
                         flush, iters=20),
        library_ms=fwd_lib_ms)
    # x, residual read; out, s written; scale/bias read; mean/var written
    fwd["bound_ms"], fwd["bound_by"] = _bound(
        4 * n * item + 2 * hidden * 4 + 2 * rows * 4, 8 * n, torch.float32)
    bwd = dict(
        max_abs_err=max(errs["bwd"]),
        ms=time_ms(lambda: FN.bwd_call(s, w, mean, var, dout, eps, ds_in),
                   flush),
        plain_ms=time_ms(lambda: FN.bwd_plain(s, w, mean, var, dout, eps,
                                              ds_in), flush, iters=20),
        library_ms=bwd_lib_ms)
    # s, dout, ds_in read; dx written; scale, mean, var read
    bwd["bound_ms"], bwd["bound_by"] = _bound(
        4 * n * item + hidden * 4 + 2 * rows * 4, 14 * n, torch.float32)
    return {"fused_norm_fwd": fwd, "fused_norm_bwd": bwd}


#: a rank's block of the 345M flash launches on a dp 2 × mp 2 gang (phase
#: 21a): 8 of the 16 heads (the second block) of 4 of the 8 rows (the
#: second block), as ``flash_attention``'s head map
OFFSET_HEADS = (8, TNH, 4, 8)


def _dropout_probes(dev: torch.device, heads=None) -> float:
    """Recover the flash kernels' dropout masks bit for bit at the 345M
    shapes and hold them to the plain version's hash mask; returns the
    kernel's keep rate over the causal triangle. With ``heads`` (a head
    map, ``OFFSET_HEADS``) the launches are a rank's block of the rows and
    heads, and their masks must be that block of the one-rank mask.

    With q = 0 every score is 0, so P = 1/(row+1) below the diagonal.
    Forward: k = 0, v one-hot on columns [64p, 64p+64) makes
    ``out[h, r, d] > 0`` exactly where column 64p+d is kept for row r.
    Fused and dk/dv backward: k = v = 0, do one-hot on rows [64p, 64p+64)
    makes ``dv[h, c, d] > 0`` exactly where row 64p+d keeps column c. dq
    backward: k one-hot on columns [64p, 64p+64), v = e_0, do = e_0 and
    delta = 0 make dP = 1, so ``dq[h, r, d] > 0`` exactly where column
    64p+d is kept for row r."""
    from fleetx_tpu_torch.ops import flash_attention as FA

    bh, seed, scale = TB * TNH, 424242, THD ** -0.5
    hm = {}
    if heads is not None:
        bh, hm = heads[0] * (TB // 2), {"heads": heads}
    zero = torch.zeros((bh, TS, THD), dtype=torch.bfloat16, device=dev)
    e0 = zero.clone()
    e0[:, :, 0] = 1
    tril = torch.ones((TS, TS), dtype=torch.bool, device=dev).tril()
    keeps = {name: torch.zeros((bh, TS, TS), dtype=torch.bool, device=dev)
             for name in ("forward", "fused backward", "dk/dv backward",
                          "dq backward")}
    eye = torch.eye(THD, dtype=torch.bfloat16, device=dev)
    _, lse = FA.fwd_call(zero, zero, zero, seed, scale, True, RATE, **hm)
    delta = torch.zeros((bh, TS), device=dev)
    for p in range(TS // THD):
        cols = slice(p * THD, (p + 1) * THD)
        probe = zero.clone()
        probe[:, cols, :] = eye
        out, _ = FA.fwd_call(zero, zero, probe, seed, scale, True, RATE, **hm)
        keeps["forward"][:, :, cols] = out > 0
        _, _, dv = FA.bwd_call(zero, zero, zero, probe, lse, delta, seed,
                               scale, True, RATE, **hm)
        keeps["fused backward"][:, cols, :] = (dv > 0).transpose(1, 2)
        _, dv = FA.bwd_dkv_call(zero, zero, zero, probe, lse, delta, seed,
                                scale, True, RATE, **hm)
        keeps["dk/dv backward"][:, cols, :] = (dv > 0).transpose(1, 2)
        dq = FA.bwd_dq_call(zero, probe, e0, e0, lse, delta, seed, scale,
                            True, RATE, **hm)
        keeps["dq backward"][:, :, cols] = dq > 0
    if heads is None:
        want = FA.dropout_keep(seed, bh, TS, TS, RATE, dev) & tril
    else:  # the block of the one-rank mask
        n, _, b_off, h_off = heads
        want = FA.dropout_keep(seed, TB * TNH, TS, TS, RATE, dev).reshape(
            TB, TNH, TS, TS)[b_off:b_off + TB // 2, h_off:h_off + n] \
            .reshape(bh, TS, TS) & tril
    for name, keep in keeps.items():
        check(torch.equal(keep & tril, want),
              f"flash {name} dropout mask differs from the plain version's")
    return float(want.sum()) / float(bh * tril.sum())


# -------------------------------------------------------------- phase 1c
#: split-kernel check shapes: bh 8, seq 1024 (and sk 512 non-causal); the
#: kernels' q and k tiles differ (dk/dv at head_dim 128: BQ 32, BK 64), so
#: the diagonal crosses tiles unevenly
SB, SS = 8, 1024
#: the GPT-1.3B seq-8192 path: micro-batch 2 x 16 heads, head_dim 128
LB, LS, LHD = 32, 8192, 128


def _split_case(dtype, dev, sq, sk, d, seed):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    q, do = (torch.randn((SB, sq, d), generator=gen, device=dev).to(dtype)
             for _ in range(2))
    k, v = (torch.randn((SB, sk, d), generator=gen, device=dev).to(dtype)
            for _ in range(2))
    return q, k, v, do


def _split_checks(dev: torch.device) -> dict:
    """The split kernels against their plain versions at ``[8, 1024, d]``
    for d 64/128/256, f32 and bf16, causal and not (also sq 1024 / sk
    512), dropout 0 and 0.1, with an lse that is not the rows' own (the
    forward's plus 0.25: the ring's global-lse contract); then the split
    pair against the fused kernel (d <= 128, dropout 0.1, f32)."""
    from fleetx_tpu_torch.ops import flash_attention as FA

    errs = {"float32": [0.0, 0.0], "bfloat16": [0.0, 0.0]}
    # tensor-core route: largest error against the rounded plain version
    # and drift from the unrounded one, forward and dk/dv, per dtype
    tc_errs = {}
    simt_cases = tc_cases = repeats = 0

    def hold_tc(dtype, kernel, got, rounded, unrounded, what):
        err, drift = _hold_tc(got, rounded, unrounded, what)
        key = f"{str(dtype)[6:]}_{kernel}"
        tc_errs[f"{key}_vs_rounded"] = max(
            tc_errs.get(f"{key}_vs_rounded", 0.0), err)
        tc_errs[f"{key}_drift"] = max(tc_errs.get(f"{key}_drift", 0.0), drift)

    for d in (64, 128, 256):
        for name, dtype in (("float32", torch.float32),
                            ("bfloat16", torch.bfloat16),
                            ("float16", torch.float16)):
            tc = FA.tc_route(dtype, d)
            if dtype == torch.float16 and not tc:
                continue  # fp16 is checked on its tensor-core route only
            for causal, sk in ((True, SS), (False, SS), (False, SS // 2)):
                q, k, v, do = _split_case(dtype, dev, SS, sk, d, d + sk)
                scale = d ** -0.5
                out, lse = FA.fwd_call(q, k, v, 0, scale, causal, 0.0)
                lse = lse + 0.25
                delta = (out.float() * do.float()).sum(-1)
                for rate in (0.0, 0.1):
                    tag = f"{name} d{d} causal {causal} sk {sk} rate {rate}"
                    args = (q, k, v, do, lse, delta, 77 + d, scale, causal,
                            rate)
                    dk, dv = FA.bwd_dkv_call(*args)
                    p_dk, p_dv = FA.bwd_dkv_plain(*args, round_operands=tc)
                    torch.cuda.synchronize()
                    check(dk.dtype == dtype and dv.dtype == dtype,
                          "split grads' dtypes")
                    if tc:
                        u_dk, u_dv = FA.bwd_dkv_plain(*args)
                        hold_tc(dtype, "dkv", dk, p_dk, u_dk, f"dk {tag}")
                        hold_tc(dtype, "dkv", dv, p_dv, u_dv, f"dv {tag}")
                        fwd = (q, k, v, 5 + d, scale, causal, rate)
                        f_out, f_lse = FA.fwd_call(*fwd)
                        r_out, r_lse = FA.fwd_plain(*fwd, round_operands=True)
                        u_out = FA.fwd_plain(*fwd)[0]
                        torch.cuda.synchronize()
                        hold_tc(dtype, "fwd", f_out, r_out, u_out,
                                f"fwd {tag}")
                        torch.testing.assert_close(f_lse, r_lse,
                                                   **TOL[torch.float32])
                        tc_cases += 1
                        del u_dk, u_dv, f_out, f_lse, r_out, r_lse, u_out
                    else:
                        for got, want in ((dk, p_dk), (dv, p_dv)):
                            torch.testing.assert_close(got, want,
                                                       **TOL[dtype])
                        errs[name][1] = max(errs[name][1], _max_err(
                            [(dk, p_dk), (dv, p_dv)]))
                    dq = FA.bwd_dq_call(*args)
                    p_dq = FA.bwd_dq_plain(*args, round_operands=tc)
                    torch.cuda.synchronize()
                    check(dq.dtype == dtype, "split dq's dtype")
                    if tc:
                        hold_tc(dtype, "dq", dq, p_dq,
                                FA.bwd_dq_plain(*args), f"dq {tag}")
                        if rate > 0.0:  # deterministic: no atomics
                            again = FA.bwd_dq_call(*args)
                            torch.cuda.synchronize()
                            check(torch.equal(dq, again),
                                  f"dq {tag}: a repeated call differs")
                            repeats += 1
                    else:
                        torch.testing.assert_close(dq, p_dq, **TOL[dtype])
                        errs[name][0] = max(errs[name][0],
                                            _max_err([(dq, p_dq)]))
                        simt_cases += 1
                    del p_dq, p_dk, p_dv
    # split against fused: f32 on the SIMT kernels (both f32 sums of the
    # same products, 1e-5), bf16 with both on the tensor cores (each
    # rounds dS once, the split dq also its bf16 output: the drift bound)
    fused_err, fused_drift = 0.0, 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for d in (64, 128):
            q, k, v, do = _split_case(dtype, dev, SS, SS, d, 5 * d)
            scale = d ** -0.5
            out, lse = FA.fwd_call(q, k, v, 99, scale, True, 0.1)
            delta = (out.float() * do.float()).sum(-1)
            args = (q, k, v, do, lse, delta, 99, scale, True, 0.1)
            f_dq, f_dk, f_dv = FA.bwd_call(*args)
            dq = FA.bwd_dq_call(*args)
            dk, dv = FA.bwd_dkv_call(*args)
            torch.cuda.synchronize()
            pairs = ((dq, f_dq), (dk, f_dk), (dv, f_dv))
            if dtype == torch.float32:
                for got, want in pairs:
                    torch.testing.assert_close(got, want,
                                               **TOL[torch.float32])
                fused_err = max(fused_err, _max_err(pairs))
                continue
            for (got, want), name in zip(pairs, ("dq", "dk", "dv")):
                diff = float((got.float() - want.float()).abs().max())
                check(diff <= TC_DRIFT * float(want.float().abs().max()),
                      f"bf16 split {name} vs fused d{d}: {diff} exceeds "
                      f"2**-6 of the largest magnitude")
                fused_drift = max(fused_drift, diff)
    torch.cuda.empty_cache()
    out = dict(simt_cases=simt_cases, tc_cases=tc_cases,
               tc_dq_repeats=repeats,
               dq_max_abs_err=errs["float32"][0],
               dkv_max_abs_err=errs["float32"][1],
               bf16_simt_dq_max_abs_err=errs["bfloat16"][0],
               bf16_simt_dkv_max_abs_err=errs["bfloat16"][1],
               tensor_core=tc_errs, split_vs_fused_max_abs_err=fused_err,
               bf16_split_vs_fused_max_abs_diff=fused_drift)
    emit("split_kernels_vs_plain", **out)
    return out


def _split_timings(dev: torch.device, flush: torch.Tensor) -> dict:
    """dq, dk/dv and the forward at ``[32, 8192, 128]`` bf16 causal (the
    seq-8192 path's shape): CUDA events, L2 flushed, median of three calls;
    each with its bound, the plain version at bh 4 (dense f32 scores there
    are 1 GB a tensor; at bh 32 they would be 8.6 GB) and the yardstick:
    one SDPA flash backward at ``[2, 16, 8192, 128]``, which gives dq, dk
    and dv together, and the SDPA flash forward."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from fleetx_tpu_torch.ops import flash_attention as FA

    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    q, k, v, do = (torch.randn((LB, LS, LHD), generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(4))
    scale = LHD ** -0.5
    out, lse = FA.fwd_call(q, k, v, 0, scale, True, 0.0)
    delta = (out.float() * do.float()).sum(-1)
    args = (q, k, v, do, lse, delta, 0, scale, True, 0.0)
    small = tuple(t[:4].contiguous() for t in (q, k, v, do, lse, delta))
    small_args = small + (0, scale, True, 0.0)
    # the kernels against their plain versions at the full sequence, on
    # the first 4 heads (the plain versions' dense scores at bh 32 would
    # not fit beside the rest)
    # (the forward, dq and dk/dv take the tensor-core route here: held to
    # the rounded plain version and, within the drift bound, to the
    # unrounded)
    errs, drifts = {}, {}
    got = FA.fwd_call(*small[:3], 0, scale, True, 0.0)
    want = FA.fwd_plain(*small[:3], 0, scale, True, 0.0, round_operands=True)
    plain = FA.fwd_plain(*small[:3], 0, scale, True, 0.0)
    torch.cuda.synchronize()
    _, drifts["flash_attention_fwd"] = _hold_tc(got[0], want[0], plain[0],
                                                "seq-8192 forward")
    torch.testing.assert_close(got[1], want[1], **TOL[torch.float32])
    errs["flash_attention_fwd"] = _max_err(zip(got, want))
    del plain
    got = FA.bwd_dkv_call(*small_args)
    want = FA.bwd_dkv_plain(*small_args, round_operands=True)
    plain = FA.bwd_dkv_plain(*small_args)
    torch.cuda.synchronize()
    drifts["flash_attention_bwd_dkv"] = max(
        _hold_tc(a, b, c, f"seq-8192 {n}")[1]
        for a, b, c, n in zip(got, want, plain, ("dk", "dv")))
    errs["flash_attention_bwd_dkv"] = _max_err(zip(got, want))
    del plain
    got = FA.bwd_dq_call(*small_args)
    want = FA.bwd_dq_plain(*small_args, round_operands=True)
    plain = FA.bwd_dq_plain(*small_args)
    torch.cuda.synchronize()
    _, drifts["flash_attention_bwd_dq"] = _hold_tc(got, want, plain,
                                                   "seq-8192 dq")
    errs["flash_attention_bwd_dq"] = _max_err([(got, want)])
    del got, want, plain
    torch.cuda.empty_cache()
    few = dict(iters=3, warmup=1)
    rows = {
        "flash_attention_fwd": dict(
            ms=time_ms(lambda: FA.fwd_call(q, k, v, 0, scale, True, 0.0),
                       flush, **few),
            plain_ms=time_ms(lambda: FA.fwd_plain(
                *small[:3], 0, scale, True, 0.0), flush, **few)),
        "flash_attention_bwd_dq": dict(
            ms=time_ms(lambda: FA.bwd_dq_call(*args), flush, **few),
            plain_ms=time_ms(lambda: FA.bwd_dq_plain(*small_args), flush,
                             **few)),
        "flash_attention_bwd_dkv": dict(
            ms=time_ms(lambda: FA.bwd_dkv_call(*args), flush, **few),
            plain_ms=time_ms(lambda: FA.bwd_dkv_plain(*small_args), flush,
                             **few)),
    }

    def four(t):
        return t.reshape(LB // 16, 16, LS, LHD)

    sq_, sk_, sv_ = (four(t).detach().clone().requires_grad_(True)
                     for t in (q, k, v))
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
        lib_out = torch.nn.functional.scaled_dot_product_attention(
            sq_, sk_, sv_, is_causal=True)
        rows["flash_attention_fwd"]["library_ms"] = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                four(q), four(k), four(v), is_causal=True), flush, **few)
        bwd_lib_ms = time_ms(lambda: torch.autograd.grad(
            lib_out, (sq_, sk_, sv_), four(do), retain_graph=True), flush,
            **few)
    del lib_out, sq_, sk_, sv_
    rows["flash_attention_bwd_dq"]["library_ms"] = bwd_lib_ms
    rows["flash_attention_bwd_dkv"]["library_ms"] = bwd_lib_ms

    bh, item = LB, q.element_size()
    pairs = LS * (LS + 1) // 2
    tensor = bh * LS * LHD * item
    vec = bh * LS * 4
    # bytes: each input read once, each output written once
    for name, nbytes, products in (
            ("flash_attention_fwd", 4 * tensor + vec, 2),      # q,k,v,out,lse
            ("flash_attention_bwd_dq", 5 * tensor + 2 * vec, 3),  # +do,delta
            ("flash_attention_bwd_dkv", 6 * tensor + 2 * vec, 4)):
        flops = products * 2 * pairs * LHD * bh
        rows[name]["max_abs_err"] = errs[name]
        rows[name]["variant"] = "wgmma" if name in drifts else "simt"
        rows[name]["bound_ms"], rows[name]["bound_by"] = _bound(
            nbytes, flops, torch.bfloat16)
        emit("kernel_seq8k", name=name, shape=[LB, LS, LHD],
             dtype="bfloat16", causal=True, plain_bh=4,
             drift_from_unrounded=drifts.get(name),
             tflop_s=flops / rows[name]["ms"] / 1e9, **rows[name])
    pair_ms = rows["flash_attention_bwd_dq"]["ms"] + \
        rows["flash_attention_bwd_dkv"]["ms"]
    emit("split_pair_vs_sdpa_backward", split_pair_ms=pair_ms,
         sdpa_flash_backward_ms=bwd_lib_ms, ratio=pair_ms / bwd_lib_ms)
    del q, k, v, do, out, lse, delta, args, small, small_args
    torch.cuda.empty_cache()
    return rows


def phase_split_kernels(dev: torch.device) -> dict:
    """Phase 1c: the split backward kernels against their plain versions
    and the fused kernel; then the kernels of the seq-8192 path at its
    shapes, each against its plain version and timed (the dropout masks
    are probed in phase 1b's ``_dropout_probes``)."""
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    _split_checks(dev)
    rows = _split_timings(dev, flush)
    # the norms at the seq-8192 path's rows: micro-batch 2 x 8192, 2048
    norms = _norm_rows(torch.bfloat16, dev, flush, shape=(2, LS, 2048))
    for name, row in norms.items():
        emit("kernel_seq8k", name=name, shape=[2, LS, 2048],
             dtype="bfloat16", **row)
    rows.update(norms)
    torch.cuda.empty_cache()
    return rows


# -------------------------------------------------------------- phase 1d
#: the "rows" route held to the plain version at these hidden sizes and
#: rows (every dtype pair, with and without the residual), "row_block" at
#: NORM_BLOCK_HIDDEN
NORM_ROWS_HIDDEN = (128, 1024, 2048, 4096)
NORM_BLOCK_HIDDEN = (8192, 32768)
NORM_ROWS = (1, 7, 8195)
#: the forward's (input, output) dtype pairs
NORM_PAIRS = ((torch.float32, torch.float32),
              (torch.bfloat16, torch.bfloat16),
              (torch.bfloat16, torch.float32),
              (torch.float16, torch.float16),
              (torch.float16, torch.float32))
#: row 5 timed at the main paths' shapes (with the residual): the 345M
#: training rows, the seq-8192 path's, the generation path's one-token
#: rows, and the 345M rows in fp16
NORM_TIMED = (("345M", (TB, TS, TH), torch.bfloat16),
              ("seq8192", (2, 8192, 2048), torch.bfloat16),
              ("decode", (8, 1, 1024), torch.bfloat16),
              ("345M_fp16", (TB, TS, TH), torch.float16))
#: back-to-back calls behind ``host_us`` (no synchronise among them)
HOST_CALLS = 1000
#: repeats of the bf16 / fp16 turns at the 345M shape (``fp16_turns``)
FP16_TURN_REPEATS = 3


def _norm_inputs(shape, dtype, dev, seed: int = 2):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    hidden = shape[-1]
    x, r = (torch.randn(shape, generator=gen, device=dev).to(dtype)
            for _ in range(2))
    w = 1.0 + 0.1 * torch.randn(hidden, generator=gen, device=dev)
    b = 0.1 * torch.randn(hidden, generator=gen, device=dev)
    return x, r, w, b


def _hold_norm_fwd(FN, x, r, w, b, out_dtype, route=None) -> float:
    """One forward launch held to ``fwd_plain`` (``s`` bitwise, the stats
    at the f32 tolerance, ``out`` at its dtype's) and, on "rows", a second
    launch bitwise equal to the first; the largest error."""
    kw = {"route": route} if route else {}  # an earlier tree: no routes
    got = FN.fwd_call(x, r, w, b, 1e-5, out_dtype, **kw)
    want = FN.fwd_plain(x, r, w, b, 1e-5, out_dtype)
    torch.cuda.synchronize()
    what = (f"norm fwd {route or 'planned'} {tuple(x.shape)} {x.dtype} -> "
            f"{out_dtype} residual={r is not None}")
    torch.testing.assert_close(got[0], want[0], **TOL[out_dtype], msg=what)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0, msg=what)
    for i in (2, 3):
        torch.testing.assert_close(got[i], want[i], **TOL[torch.float32],
                                   msg=what)
    if route != "row_block":
        again = FN.fwd_call(x, r, w, b, 1e-5, out_dtype, **kw)
        check(all(torch.equal(a, c) for a, c in zip(got, again)),
              f"{what}: a repeated call is not bitwise identical")
    return _max_err(zip(got, want))


def _norm_coverage(FN, build, dev) -> dict:
    """Phase 1d's checks: the planner's shared memory against the
    kernel's, and both routes against the plain version over the
    coverage grid."""
    smem = build.load("fused_norm").fleetx_fused_norm_fwd_smem_bytes
    smem.argtypes = [ctypes.c_int] * 5
    smem.restype = ctypes.c_longlong
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    errs = {"rows": 0.0, "row_block": 0.0}
    cases = {"rows": 0, "row_block": 0}
    plans = {}
    codes = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
    for hidden in NORM_ROWS_HIDDEN + NORM_BLOCK_HIDDEN:
        route = "rows" if hidden in NORM_ROWS_HIDDEN else "row_block"
        for dtype, out_dtype in NORM_PAIRS:
            for rows in NORM_ROWS:
                x, r, w, b = _norm_inputs((rows, hidden), dtype, dev,
                                          seed=rows + hidden)
                for res in (r, None):
                    plan = FN.plan_fwd(rows, hidden, dtype, out_dtype,
                                       res is not None, sms)
                    check(plan.route == route,
                          f"hidden {hidden}: planned {plan.route}")
                    if route == "rows":
                        check(smem(hidden, codes[dtype], int(res is not None),
                                   plan.rows_per_tile, plan.stages)
                              == plan.smem_bytes,
                              f"plan_fwd's shared memory {plan} differs "
                              f"from the kernel's")
                        plans[f"{rows}x{hidden}"] = plan._asdict()
                    errs[route] = max(errs[route], _hold_norm_fwd(
                        FN, x, res, w, b, out_dtype, route))
                    cases[route] += 1
                del x, r
        torch.cuda.empty_cache()
    out = dict(cases=cases, max_abs_err=errs, sm_count=sms,
               plans={k: v for k, v in plans.items()
                      if k.startswith("8195x")})
    emit("norm_check", **out)
    return out


def _host_us(fn, calls: int = HOST_CALLS) -> float:
    """Host wall of ``calls`` back-to-back calls of ``fn`` with no
    synchronise among them, over ``calls``, in µs (after 50 warm calls;
    the device work is drained before and after)."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    return wall / calls * 1e6


def _norm_timings(FN, dev, flush, name, shape, dtype, routes) -> dict:
    """Row 5 at ``shape`` (with the residual) in turns: each route and
    add + ``F.layer_norm`` forward then backward through the list (e.g.
    rows, row_block, library, library, row_block, rows): CUDA-event ``ms``
    (L2 flushed before every launch) and ``graph_ms`` each turn;
    ``device_ms`` once each; the bound."""
    x, r, w, b = _norm_inputs(shape, dtype, dev)
    hidden = shape[-1]
    lw, lb = w.to(dtype), b.to(dtype)
    fns = {route or "kernel": (lambda route=route: FN.fwd_call(
        x, r, w, b, 1e-5, dtype, **({"route": route} if route else {})))
        for route in routes}
    fns["library"] = lambda: torch.nn.functional.layer_norm(
        r + x, (hidden,), lw, lb, 1e-5)
    for route in routes:
        _hold_norm_fwd(FN, x, r, w, b, dtype, route)
    order = list(fns) + list(fns)[::-1]
    rec = {k: {"ms": [], "graph_ms": []} for k in fns}
    for k in order:
        rec[k]["ms"].append(time_ms(fns[k], flush))
        rec[k]["graph_ms"].append(graph_ms(fns[k]))
    patterns = {"kernel": "fused_norm_fwd", "rows": "fused_norm_fwd_rows",
                "row_block": "fused_norm_fwd_kernel", "library": ""}
    # the decode step's norm reads what the op before it just wrote: its
    # device time is taken L2 warm
    dev_flush = None if name == "decode" else flush
    n, item = x.numel(), x.element_size()
    bound_ms, bound_by = _bound(4 * n * item + 2 * hidden * 4
                                + 2 * (n // hidden) * 4, 8 * n,
                                torch.float32)
    for k, fn in fns.items():
        rec[k]["device_ms"] = device_ms(fn, dev_flush, patterns[k],
                                        exclude=("fill", "Fill", "Memset"))
        rec[k]["bound_share"] = {
            m: bound_ms / min(rec[k][m]) for m in ("ms", "graph_ms")}
        rec[k]["bound_share"]["device_ms"] = (
            bound_ms / rec[k]["device_ms"] if rec[k]["device_ms"] else None)
    # a device copy of the bytes the kernel reads and writes (x and the
    # residual in, out and s out): what this card's memory gives a
    # streaming kernel at this size
    src = torch.empty(2 * n, dtype=dtype, device=dev)
    dst = torch.empty_like(src)
    copy = dict(graph_ms=graph_ms(lambda: dst.copy_(src)),
                device_ms=device_ms(lambda: dst.copy_(src), dev_flush,
                                    exclude=("fill", "Fill", "Memset")))
    del src, dst
    out = dict(shape=list(shape), dtype=str(dtype).split(".")[-1],
               bound_ms=bound_ms, bound_by=bound_by,
               device_l2="warm" if dev_flush is None else "flushed",
               copy_same_bytes=copy, **rec)
    emit("norm_shape", name=name, **out)
    return out


def _fp16_turns(FN, dev, flush, routes) -> dict:
    """bf16 and fp16 at the 345M shape in turns, ``FP16_TURN_REPEATS``
    times, for each route: is a spread of fp16's times the kernel or the
    measurement?"""
    cases = {}
    for dtype in (torch.bfloat16, torch.float16):
        x, r, w, b = _norm_inputs((TB, TS, TH), dtype, dev)
        for route in routes:
            cases[(str(dtype).split(".")[-1], route or "kernel")] = (
                lambda x=x, r=r, w=w, b=b, dtype=dtype, route=route:
                FN.fwd_call(x, r, w, b, 1e-5, dtype,
                            **({"route": route} if route else {})))
    rec = {f"{d}_{route}": {"ms": [], "graph_ms": []}
           for d, route in cases}
    for _ in range(FP16_TURN_REPEATS):
        for (d, route), fn in cases.items():
            rec[f"{d}_{route}"]["ms"].append(time_ms(fn, flush))
            rec[f"{d}_{route}"]["graph_ms"].append(graph_ms(fn))
    emit("norm_fp16_turns", shape=[TB, TS, TH], repeats=FP16_TURN_REPEATS,
         **rec)
    return rec


def _norm_host(FN, build, dev) -> dict:
    """Host µs a call at the decode shape ``[8, 1, 1024]`` bf16: the eager
    non-grad path the generation model calls (``fused_residual_norm``),
    ``fwd_call`` on each route, the custom op's dispatch, and add +
    ``F.layer_norm``, in turns; then the launch path's pieces."""
    x, r, w, b = _norm_inputs((8, 1, 1024), torch.bfloat16, dev)
    lw, lb = w.to(torch.bfloat16), b.to(torch.bfloat16)
    new = hasattr(FN, "plan_fwd")
    fns = {
        "eager_path": lambda: FN.fused_residual_norm(
            x, w, b, residual=r, eps=1e-5, out_dtype=torch.bfloat16),
        "fwd_call": lambda: FN.fwd_call(x, r, w, b, 1e-5, torch.bfloat16),
        "custom_op": lambda: FN.fused_norm_fwd(x, r, w, b, 1e-5,
                                               torch.bfloat16),
        "library": lambda: torch.nn.functional.layer_norm(
            r + x, (1024,), lw, lb, 1e-5)}
    if new:
        fns["fwd_call_row_block"] = lambda: FN.fwd_call(
            x, r, w, b, 1e-5, torch.bfloat16, route="row_block")
    rec = {k: [] for k in fns}
    with torch.no_grad():
        for k in list(fns) + list(fns)[::-1]:
            rec[k].append(_host_us(fns[k]))
    stat = (8, 1, 1)
    pieces = {
        "build_load": lambda: build.load("fused_norm"),
        "stream_object": lambda: torch.cuda.current_stream(
            x.device).cuda_stream,
        "vec_to_contiguous": lambda: w.reshape(-1).to(
            device=x.device, dtype=torch.float32).contiguous(),
        "stats_two_empty": lambda: (
            torch.empty(stat, dtype=torch.float32, device=x.device),
            torch.empty(stat, dtype=torch.float32, device=x.device)),
        "stats_one_empty_unbind": lambda: torch.empty(
            (2,) + stat, dtype=torch.float32, device=x.device).unbind(0),
        "empty_like": lambda: torch.empty_like(x)}
    if new:
        entry, idx = FN._fns()[0], x.get_device()
        pieces.update({
            # the ctypes call alone: a dtype code the entry refuses at once
            "ctypes_call_refused": lambda: entry(
                x.data_ptr(), r.data_ptr(), w.data_ptr(), b.data_ptr(),
                x.data_ptr(), r.data_ptr(), None, None, 8, 1024, 15, 1, 8,
                1e-5, FN._stream(idx)),
            "checks": lambda: FN._check("fused_norm fwd", x, r),
            "launch_no_stats": lambda: FN._fwd_launch(
                x, r, w, b, 1e-5, torch.bfloat16, stats=False),
            "entry_cached": FN._fns,
            "stream_raw": lambda: FN._stream(idx),
            "vec_pass_through": lambda: FN._vec(w, 1024, x),
            "plan_cached": lambda: FN._plan(8, 1024, torch.bfloat16,
                                            torch.bfloat16, True, idx,
                                            None),
            "traced_check": lambda: FN._traced(x)})
    piece_us = {k: _host_us(fn, 10000) for k, fn in pieces.items()}
    out = dict(shape=[8, 1, 1024], calls=HOST_CALLS,
               host_us={k: statistics.mean(v) for k, v in rec.items()},
               host_us_turns=rec, pieces_us=piece_us)
    emit("norm_host", **out)
    return out


def phase_norm_fwd(build, dev: torch.device, card: str) -> dict:
    """Phase 1d: row 5's two routes. The coverage checks (``"rows"`` at
    ``NORM_ROWS_HIDDEN``, ``"row_block"`` at ``NORM_BLOCK_HIDDEN``, every
    dtype pair, with and without the residual, rows 1, 7 and 8195), then
    the ``NORM_TIMED`` shapes in turns against ``"row_block"`` and add +
    ``F.layer_norm``, bf16 against fp16 in turns, and the host µs of a
    decode-shape call. On an earlier tree, whose wrapper has one route and
    no planner, only its timings and host µs."""
    from fleetx_tpu_torch.ops import fused_norm as FN

    build.build(["fused_norm"])
    emit("ptxas_norm", kernels=_ptxas_summary(
        build.build_logs.get("fused_norm", ""), "fused_norm_fwd"))
    new = hasattr(FN, "plan_fwd")
    routes = ("rows", "row_block") if new else (None,)
    out = {"routes": [r or "kernel" for r in routes]}
    if new:
        out["check"] = _norm_coverage(FN, build, dev)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    out["shapes"] = {name: _norm_timings(FN, dev, flush, name, shape, dtype,
                                         routes)
                     for name, shape, dtype in NORM_TIMED}
    out["fp16_turns"] = _fp16_turns(FN, dev, flush, routes)
    del flush
    out["host"] = _norm_host(FN, build, dev)
    torch.cuda.empty_cache()
    emit("norm_fwd", nvidia_smi=card, routes=out["routes"])
    return out


#: repeats of the norm timings at the 345M shape (``norm_spread``)
NORM_REPEATS = 5


def _norm_spread(dev: torch.device, flush: torch.Tensor) -> dict:
    """The fused norm forward and backward at the 345M shape in bf16,
    each ``time_ms`` (L2 flushed) ``NORM_REPEATS`` times beside its
    yardstick (add + ``F.layer_norm`` / its autograd backward + add):
    median and range of each; and each kernel's ``device_ms``."""
    from fleetx_tpu_torch.ops import fused_norm as FN

    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    dtype, hidden, eps = torch.bfloat16, TH, 1e-5
    x, r, dout, ds_in = (torch.randn((TB, TS, TH), generator=gen,
                                     device=dev).to(dtype) for _ in range(4))
    w = 1.0 + 0.1 * torch.randn(hidden, generator=gen, device=dev)
    b = 0.1 * torch.randn(hidden, generator=gen, device=dev)
    _, s, mean, var = FN.fwd_call(x, r, w, b, eps, dtype)
    lw, lb = w.to(dtype), b.to(dtype)
    s_leaf = (r + x).detach().requires_grad_(True)
    lib_out = torch.nn.functional.layer_norm(s_leaf, (hidden,), lw, lb, eps)
    fns = {
        "fwd": lambda: FN.fwd_call(x, r, w, b, eps, dtype),
        "fwd_library": lambda: torch.nn.functional.layer_norm(
            r + x, (hidden,), lw, lb, eps),
        "bwd": lambda: FN.bwd_call(s, w, mean, var, dout, eps, ds_in),
        "bwd_library": lambda: torch.autograd.grad(
            lib_out, s_leaf, dout, retain_graph=True)[0] + ds_in}
    out = {}
    for name, fn in fns.items():
        times = [time_ms(fn, flush) for _ in range(NORM_REPEATS)]
        out[name] = dict(median_ms=statistics.median(times),
                         min_ms=min(times), max_ms=max(times), ms=times)
    # the kernels' own device time, without launch and event overhead
    for name in ("fwd", "bwd"):
        out[name]["device_ms"] = device_ms(fns[name], flush,
                                           f"fused_norm_{name}")
    emit("norm_spread", shape=[TB, TS, TH], dtype="bfloat16",
         repeats=NORM_REPEATS, **out)
    return out


#: phase 1b's dtypes
TRAIN_DTYPES = (("float32", torch.float32), ("bfloat16", torch.bfloat16),
                ("float16", torch.float16))


def _train_kernel_rows(dev: torch.device, flush: torch.Tensor,
                       dtypes=TRAIN_DTYPES) -> dict:
    """The four training kernels against their plain versions, timed, at
    the 345M shapes, in each of ``dtypes``: ``{dtype name: rows}``."""
    result = {}
    for name, dtype in dtypes:
        rows = {**_flash_rows(dtype, dev, flush),
                **_norm_rows(dtype, dev, flush)}
        for kernel, row in rows.items():
            emit("kernel", name=kernel, dtype=name, **row)
        result[name] = rows
        torch.cuda.empty_cache()
    return result


def phase_train_kernels(dev: torch.device) -> dict:
    """Phase 1b: the four training kernels against their plain versions,
    timed, in f32, bf16 and fp16; the norms' spread at the 345M shape;
    then the dropout-mask probes."""
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    result = _train_kernel_rows(dev, flush)
    result["norm_spread"] = _norm_spread(dev, flush)
    keep_rate = _dropout_probes(dev)
    emit("dropout_masks", rate=RATE, shape=[TB * TNH, TS, TS],
         fwd_bit_identical=True, bwd_bit_identical=True,
         dq_bit_identical=True, dkv_bit_identical=True,
         keep_rate=keep_rate)
    result["offsets"] = _offset_checks(dev)
    torch.cuda.empty_cache()
    return result


def _offset_checks(dev: torch.device) -> dict:
    """Rows 1-4 on a rank's block of the 345M launch (``OFFSET_HEADS``):
    each kernel against its plain version with the same head map, dropout
    0.1, in f32 (SIMT) and bf16 (tensor cores); the map changes the
    masks; and the four kernels' masks, recovered by the identity probes,
    are that block of the one-rank mask bit for bit."""
    from fleetx_tpu_torch.ops import flash_attention as FA

    hm, out = {"heads": OFFSET_HEADS}, {}
    seed, scale = 20240607, THD ** -0.5
    for name, dtype in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        q, k, v, do = _flash_case(dtype, dev, (TB // 2, OFFSET_HEADS[0],
                                               TS, THD))
        tc = FA.tc_route(dtype, THD)
        o, lse = FA.fwd_call(q, k, v, seed, scale, True, RATE, **hm)
        p_o, p_lse = FA.fwd_plain(q, k, v, seed, scale, True, RATE,
                                  round_operands=tc, **hm)
        torch.testing.assert_close(lse, p_lse, **TOL[torch.float32])
        delta = (o.float() * do.float()).sum(-1)
        args = (q, k, v, do, lse, delta, seed, scale, True, RATE)
        got = {"fwd": (o,), "fused": FA.bwd_call(*args, **hm),
               "dq": (FA.bwd_dq_call(*args, **hm),),
               "dkv": FA.bwd_dkv_call(*args, **hm)}
        want = {"fwd": (p_o,),
                "fused": FA.bwd_plain(*args, round_operands=tc, **hm),
                "dq": (FA.bwd_dq_plain(*args, round_operands=tc, **hm),),
                "dkv": FA.bwd_dkv_plain(*args, round_operands=tc, **hm)}
        torch.cuda.synchronize()
        errs = {}
        for kernel in got:
            for i, (g, w) in enumerate(zip(got[kernel], want[kernel])):
                what = f"flash {kernel} [{i}] with a head map ({name})"
                if tc:
                    torch.testing.assert_close(
                        g.float(), w.float(), rtol=TC_RTOL,
                        atol=TC_ATOL_SHARE * float(w.float().abs().max()),
                        msg=what)
                else:
                    torch.testing.assert_close(
                        g, w, **TOL[torch.float32 if kernel == "fused"
                                    and i == 0 else dtype], msg=what)
            errs[kernel] = _max_err(zip(got[kernel], want[kernel]))
        unmapped, _ = FA.fwd_call(q, k, v, seed, scale, True, RATE)
        torch.cuda.synchronize()
        check(not torch.equal(unmapped, o),
              f"flash fwd ({name}): the head map changed no mask")
        out[name] = errs
        emit("kernel_offsets", dtype=name, heads=list(OFFSET_HEADS),
             rate=RATE, shape=[(TB // 2) * OFFSET_HEADS[0], TS, THD],
             max_abs_err=errs)
    out["keep_rate"] = _dropout_probes(dev, OFFSET_HEADS)
    emit("dropout_masks_offsets", heads=list(OFFSET_HEADS), rate=RATE,
         bit_identical=True, keep_rate=out["keep_rate"])
    return out


# --------------------------------------------------------------- phase 2
class _Stop:
    """Preemption stand-in the client thread latches once it is done."""

    def __init__(self):
        self._flag = threading.Event()

    @property
    def triggered(self) -> bool:
        return self._flag.is_set()

    def set(self) -> None:
        self._flag.set()


def _prompts(seed: int, lengths, vocab: int = 50000):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, size=n).tolist() for n in lengths]


#: phase 2's requests: prompt lengths (random ids) and new tokens each
SERVE_PROMPT_LENS = (200, 37, 5, 90, 128, 16, 300, 64)
SERVE_MAX_NEW = 32


def _serve_tcp(engine, prompts: list, max_new: int) -> dict:
    """Concurrent requests to an in-process ``ReplicaServer`` over TCP on
    ``engine`` (warmed up first, off the measurement), every launch count
    zeroed just before and read just after: the responses, the replica's
    ``stats``, the client's wall, the counts and the decode steps."""
    from fleetx_tpu_torch.serving.server import ReplicaServer, request

    # an engine an earlier run drained admits again; then a warm-up off the
    # measurement: first-call allocations, cuBLAS handles
    engine.draining = False
    engine.submit(_prompts(1, [8])[0], 2, request_id="warmup")
    engine.run_until_drained()
    engine.reset_stats()

    server = ReplicaServer(engine)
    port = server.start()
    responses = [None] * len(prompts)
    stats = {}
    stop = _Stop()
    window = {}

    def client():
        try:
            def ask(i):
                responses[i] = request(
                    ("127.0.0.1", port),
                    {"id": f"s{i}", "prompt": prompts[i],
                     "max_new_tokens": max_new}, timeout=600)

            threads = [threading.Thread(target=ask, args=(i,))
                       for i in range(len(prompts))]
            window["t0"] = time.monotonic()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            window["t1"] = time.monotonic()
            stats.update(request(("127.0.0.1", port), {"verb": "stats"}))
        finally:
            stop.set()

    decode_hist = engine.metrics.histogram("serving_decode_step")
    steps0 = decode_hist.total_count
    zero_counts()                     # zero every count just before
    worker = threading.Thread(target=client, name="chip-smoke-client")
    worker.start()
    try:
        server.run(preemption=stop)
    finally:
        server.close()
    worker.join(timeout=60)
    counts = read_counts()            # read just after
    check(not worker.is_alive(), "client thread did not finish")
    mc = engine.cfg
    for i, resp in enumerate(responses):
        check(resp is not None and "tokens" in resp,
              f"request {i} got no tokens: {resp}")
        check(1 <= len(resp["tokens"]) <= max_new, f"request {i} length")
        check(all(0 <= t < mc.vocab_size for t in resp["tokens"]),
              f"request {i} token out of vocab")
    return dict(responses=responses, stats=stats,
                wall=window["t1"] - window["t0"], counts=counts,
                decode_steps=decode_hist.total_count - steps0)


def _serving_record(run: dict, prompts: list, max_new: int,
                    layers: int) -> dict:
    """Phase 2's fields of one ``_serve_tcp`` run; checks that the decode
    path was the kernel and that it ran in every layer of every decode
    step."""
    stats, steps = run["stats"], run["decode_steps"]
    launches = run["counts"]["paged_attention_decode"]
    check(stats.get("decode_path") == "paged_kernel",
          f"decode_path {stats.get('decode_path')}")
    check(steps > 0, "no decode step ran")
    check(launches == layers * steps,
          f"{launches} kernel launches != {layers} x {steps} decode steps")
    tokens = sum(len(r["tokens"]) for r in run["responses"])
    return dict(requests=len(prompts), prompt_lens=[len(p) for p in prompts],
                max_new_tokens=max_new, tokens=tokens, wall_s=run["wall"],
                tokens_per_s=tokens / run["wall"],
                ttft_p50_s=stats["ttft_p50_s"], ttft_p99_s=stats["ttft_p99_s"],
                itl_p50_s=stats["itl_p50_s"], itl_p99_s=stats["itl_p99_s"],
                decode_steps=steps, kernel_launches=launches,
                launches_per_decode_step=launches / steps,
                decode_path=stats["decode_path"])


def phase_main_path(dev: torch.device, card: str) -> dict:
    from fleetx_tpu_torch.tools.serve import build_engine, load_config

    cfg = load_config(YAML)
    engine = build_engine(cfg, device=dev)
    mc = engine.cfg
    check(mc.num_layers == 24 and mc.hidden_size == 1024
          and mc.num_attention_heads == 16 and mc.vocab_size == 50304
          and mc.dtype == torch.bfloat16, "not the full-width 345M config")
    prompts = _prompts(2, SERVE_PROMPT_LENS)
    run = _serve_tcp(engine, prompts, SERVE_MAX_NEW)
    out = dict(_serving_record(run, prompts, SERVE_MAX_NEW, mc.num_layers),
               nvidia_smi=card)
    emit("main_path", **out)
    del engine
    torch.cuda.empty_cache()
    # the replica's snapshot (the stats verb's serving record) for phase
    # 17's slo_report
    return dict(out, serving_snapshot=run["stats"])


def _device_us(evt) -> float:
    """Self device time of one profiler row, in microseconds."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        value = getattr(evt, attr, None)
        if value is not None:
            return float(value)
    return 0.0


def _trace_rows(prof) -> list:
    """(kernel name, self device us) of every device row with time: a
    CPU op's row carries its kernels' device time too, and would count it
    twice."""
    from torch.autograd import DeviceType

    rows = [(e.key, _device_us(e)) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    return [(k, us) for k, us in rows if us > 0]


def _trace_window(step, n_steps: int, n_top: int = 8) -> tuple:
    """Run ``step`` ``n_steps`` times unprofiled (host wall per step), then
    ``n_steps`` more under ``torch.profiler``: ``(fields, per_step)``, the
    fields every trace reports (wall and device ms per step, the device
    busy share = device time / unprofiled wall, the top kernels) and
    ``per_step(*patterns)``, the device ms per step of the kernels whose
    name holds any of ``patterns`` (all kernels without one)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
    rows = _trace_rows(prof)

    def per_step(*patterns) -> float:
        return sum(us for k, us in rows if not patterns
                   or any(p in k for p in patterns)) / 1e3 / n_steps

    device_ms = per_step()
    top = sorted(rows, key=lambda r: -r[1])[:n_top]
    fields = dict(steps=n_steps, wall_ms_per_step=wall_ms,
                  device_ms_per_step=device_ms if rows else None,
                  device_busy_share=device_ms / wall_ms if rows else None,
                  top_kernels_ms_per_step=[[k[:80], us / 1e3 / n_steps]
                                           for k, us in top])
    return fields, per_step


def phase_trace(dev: torch.device, card: str, n_steps: int = 10) -> None:
    """Where a decode step's time goes on the main path's engine
    (``serving_gpt_345M.yaml``, 8 running requests): host wall per step
    (unprofiled), device time per step by kernel (``torch.profiler`` over
    a second, profiled window), and the device busy share = device time /
    unprofiled wall."""
    from fleetx_tpu_torch.tools.serve import build_engine, load_config

    engine = build_engine(load_config(YAML), device=dev)
    for i, p in enumerate(_prompts(4, [100] * 8)):
        engine.submit(p, 64, request_id=f"t{i}")
    while engine._waiting or engine._prefilling:
        engine.step()
    for _ in range(3):
        engine.step()
    check(sum(r is not None and r.state == "running"
              for r in engine._slots) == 8, "trace: 8 requests running")
    fields, per_step = _trace_window(engine.step, n_steps)
    engine.run_until_drained()
    del engine
    torch.cuda.empty_cache()
    # the decode kernel's rows (paged_split_kernel; an earlier tree's
    # paged_decode_kernel under --serving)
    emit("trace", decode_batch=8, context_tokens=100, **fields,
         paged_kernel_ms_per_step=per_step("paged_")
         if fields["device_ms_per_step"] is not None else None,
         nvidia_smi=card)


# --------------------------------------------------------------- phase 3
def _pair(dtype: str, dev: torch.device, prompts, max_new: int):
    """Kernel and gather engines on the same seeded weights: the one-step
    decode logit difference on identical state, then full greedy runs."""
    from fleetx_tpu_torch.tools.serve import build_engine, load_config

    engines = [build_engine(load_config(
        YAML, [f"Model.dtype={dtype}", f"Serving.paged_kernel={flag}"]),
        device=dev) for flag in (True, False)]
    check([e.paged_kernel_active for e in engines] == [True, False],
          "engine paths")
    reqs = []
    for e in engines:
        reqs.append([e.submit(p, max_new, request_id=f"p{i}")
                     for i, p in enumerate(prompts)])
        # prefill every request (gather path on both engines, so both
        # pools end identical) before any decode step runs
        while e._waiting or e._prefilling:
            e._admit()
            e._prefill_step()
    logits = []
    for e in engines:
        _, _, _, lg = e._fns["decode"](e.params, e.pool_k, e.pool_v,
                                       e._last_tokens, e._block_tables,
                                       e._lens, e._next_rng())
        logits.append(lg[torch.from_numpy(e._lens >= 0).to(dev)])
    diff = float((logits[0] - logits[1]).abs().max())
    for e in engines:
        e.run_until_drained()
    toks = [[r.tokens for r in rs] for rs in reqs]
    pairs = [(a, b) for ra, rb in zip(*toks) for a, b in zip(ra, rb)]
    agree = sum(a == b for a, b in pairs) / max(len(pairs), 1)
    del engines
    torch.cuda.empty_cache()
    return toks, diff, agree


def phase_kernel_vs_gather(dev: torch.device, card: str) -> None:
    prompts = _prompts(3, [150, 40, 7, 64])
    max_new = 24
    toks, diff32, agree32 = _pair("float32", dev, prompts, max_new)
    check(toks[0] == toks[1], f"f32 kernel and gather tokens differ: "
                              f"{toks[0]} vs {toks[1]}")
    _, diff16, agree16 = _pair("bfloat16", dev, prompts, max_new)
    emit("kernel_vs_gather", prompt_lens=[len(p) for p in prompts],
         max_new_tokens=max_new, f32_tokens_identical=True,
         f32_max_logit_diff=diff32, bf16_max_logit_diff=diff16,
         bf16_token_agreement=agree16, f32_token_agreement=agree32,
         nvidia_smi=card)


# --------------------------------------------------------------- phase 4
TRAIN_STEPS = 10
#: per training step at GPT-345M: one flash forward and one fused
#: backward per layer; one norm forward and backward per LayerNorm call
#: (ln1 and ln2 in each of 24 layers, plus ln_f)
PER_STEP = {"flash_attention_fwd": 24, "flash_attention_bwd_fused": 24,
            "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
            "fused_norm_fwd": 49, "fused_norm_bwd": 49,
            # bf16 at head_dim 64: every forward and fused backward on the
            # tensor cores
            "flash_attention_fwd_tc": 24, "flash_attention_bwd_fused_tc": 24,
            "flash_attention_bwd_dq_tc": 0, "flash_attention_bwd_dkv_tc": 0}


def _per_step(layers: int) -> dict:
    """``PER_STEP`` for the recipe cut to ``layers`` layers."""
    return {k: {24: layers, 49: 2 * layers + 1, 0: 0}[v]
            for k, v in PER_STEP.items()}


def _counters() -> dict:
    """Name → the wrapper whose ``launches`` counts that kernel."""
    from fleetx_tpu_torch.ops import flash_attention as FA
    from fleetx_tpu_torch.ops import fused_norm as FN
    from fleetx_tpu_torch.ops import paged_attention as PA

    return {"paged_attention_decode": PA.paged_call,
            "flash_attention_fwd": FA.fwd_call,
            "flash_attention_bwd_fused": FA.bwd_call,
            "flash_attention_bwd_dq": FA.bwd_dq_call,
            "flash_attention_bwd_dkv": FA.bwd_dkv_call,
            "fused_norm_fwd": FN.fwd_call, "fused_norm_bwd": FN.bwd_call}


#: the per-route counts: launches of the tensor-core kernels
#: (``tc_launches``, a subset of ``launches``), under these names
TC_COUNTS = {"flash_attention_fwd_tc": "flash_attention_fwd",
             "flash_attention_bwd_fused_tc": "flash_attention_bwd_fused",
             "flash_attention_bwd_dq_tc": "flash_attention_bwd_dq",
             "flash_attention_bwd_dkv_tc": "flash_attention_bwd_dkv"}
#: ... and the norms' launches of their fp16 (``__half``) instantiation
#: (``fp16_launches``)
FP16_COUNTS = {"fused_norm_fwd_fp16": "fused_norm_fwd",
               "fused_norm_bwd_fp16": "fused_norm_bwd"}
#: ... and the norm forward's launches on route "rows" (``rows_launches``;
#: the rest took "row_block")
ROWS_COUNT = "fused_norm_fwd_rows"


def zero_counts() -> None:
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    for kernel in TC_COUNTS.values():
        counters[kernel].tc_launches = 0
    for kernel in FP16_COUNTS.values():
        counters[kernel].fp16_launches = 0
    counters["fused_norm_fwd"].rows_launches = 0


def read_counts() -> dict:
    """The counts since ``zero_counts``; every main path's norm forward
    launches must all have taken route "rows"."""
    counters = _counters()
    counts = {name: fn.launches for name, fn in counters.items()}
    counts.update({name: counters[kernel].tc_launches
                   for name, kernel in TC_COUNTS.items()})
    counts.update({name: counters[kernel].fp16_launches
                   for name, kernel in FP16_COUNTS.items()})
    counts[ROWS_COUNT] = counters["fused_norm_fwd"].rows_launches
    check(counts[ROWS_COUNT] == counts["fused_norm_fwd"],
          f"{counts['fused_norm_fwd'] - counts[ROWS_COUNT]} norm forward "
          f"launches off route \"rows\"")
    return counts


def phase_trainer(dev: torch.device, card: str) -> dict:
    """Phase 4: the training main path for ``TRAIN_STEPS`` steps with the
    launch counts zeroed before and read after, then a short trace."""
    from fleetx_tpu_torch.tools.train import build_trainer, load_config
    from fleetx_tpu_torch.utils.hardware import peak_flops

    cfg = load_config(TRAIN_YAML, [f"Engine.max_steps={TRAIN_STEPS}",
                                   "Engine.logging_freq=1"])
    engine, train_dl, _ = build_trainer(cfg, device=dev)
    mc = engine.module.model_cfg
    glb = cfg["Global"]
    check(mc.num_layers == 24 and mc.hidden_size == 1024
          and mc.num_attention_heads == 16 and mc.vocab_size == 50304
          and mc.dtype == torch.bfloat16 and glb["max_seq_len"] == 1024
          and glb["global_batch_size"] == 8 and engine.accumulate_steps == 1
          and mc.use_flash_attention and mc.flash_fused_bwd
          and mc.fused_residual_norm and not mc.use_recompute
          and mc.hidden_dropout_prob == 0.1
          and mc.attention_probs_dropout_prob == 0.1,
          "not the full-width 345M training recipe")
    reset_peak(dev)
    zero_counts()                   # every count to 0 just before
    losses = engine.fit(train_dl)
    torch.cuda.synchronize()
    counts = read_counts()          # read just after
    for name, per_step in PER_STEP.items():
        check(counts[name] == per_step * TRAIN_STEPS,
              f"{name}: {counts[name]} launches, want {per_step} x "
              f"{TRAIN_STEPS} steps")
    check(counts["paged_attention_decode"] == 0, "paged kernel in training")
    hist = engine.history
    check(len(losses) == TRAIN_STEPS and len(hist) == TRAIN_STEPS,
          "a step was not logged")
    check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    norms = [h["grad_norm"] for h in hist]
    check(all(np.isfinite(norms)), f"non-finite grad norm: {norms}")
    expect = float(np.log(mc.vocab_size)
                   + mc.hidden_size * mc.initializer_range ** 2 / 2)
    check(abs(losses[0] - expect) < 0.1,
          f"first loss {losses[0]} is not within 0.1 of {expect}")
    step_s = statistics.median(h["train_cost"] for h in hist[1:])
    tokens = glb["global_batch_size"] * glb["max_seq_len"]
    fpt = engine.module.flops_per_token()
    peak = peak_flops(torch.cuda.get_device_name(dev)) or PEAK_BF16_FLOPS
    out = dict(steps=TRAIN_STEPS, losses=losses, grad_norms=norms,
               first_loss=losses[0], expected_first_loss=expect,
               first_loss_minus_ln_vocab=losses[0] - float(
                   np.log(mc.vocab_size)),
               step_ms_median=step_s * 1e3,
               step_ms=[h["train_cost"] * 1e3 for h in hist],
               tokens_per_s=tokens / step_s,
               model_flops_per_step=fpt * tokens,
               mfu=fpt * tokens / step_s / peak, peak_flops=peak,
               max_memory_allocated_gb=torch.cuda.max_memory_allocated(dev)
               / 2 ** 30,
               launches=counts,
               launches_per_step={k: counts[k] / TRAIN_STEPS
                                  for k in PER_STEP},
               nvidia_smi=card)
    emit("train_main_path", **out)

    # where a step's time goes: 3 unprofiled steps for the wall, 3 more
    # under the profiler for device time by kernel
    batch = engine.to_device(next(iter(train_dl)))
    fields, share = _trace_window(lambda: engine.train_step(batch), 3,
                                  n_top=12)
    matmul_ms = share("nvjet", "gemm", "cutlass", "sm90_xmma")
    kernels_ms = share("flash_fwd_kernel", "flash_bwd_kernel",
                       "fused_norm_fwd", "fused_norm_bwd_kernel")
    emit("train_trace", **fields, matmul_ms_per_step=matmul_ms,
         other_ms_per_step=share() - matmul_ms - kernels_ms,
         flash_fwd_ms_per_step=share("flash_fwd_kernel"),
         flash_fwd_tc_ms_per_step=share("flash_fwd_kernel_tc"),
         flash_bwd_ms_per_step=share("flash_bwd_kernel"),
         flash_bwd_tc_ms_per_step=share("flash_bwd_kernel_tc"),
         norm_fwd_ms_per_step=share("fused_norm_fwd"),
         norm_bwd_ms_per_step=share("fused_norm_bwd_kernel"),
         nvidia_smi=card)
    del engine, batch
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------- phase 5
def _loss_and_grads(cfg_overrides: list, params: dict, batch: dict,
                    yaml: str = TRAIN_YAML):
    from fleetx_tpu_torch.core.module import GPTModule
    from fleetx_tpu_torch.optims.optimizer import tree_leaves_with_path
    from fleetx_tpu_torch.tools.train import load_config

    module = GPTModule(load_config(yaml, cfg_overrides))
    leaves = [p for _, p in tree_leaves_with_path(params)]
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = module.training_loss(params, batch, seed=0, step=0)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), [g.detach() for g in grads]


def phase_train_kernel_vs_plain(dev: torch.device, card: str) -> None:
    """The training path's loss and grads with the kernels on and off, on
    the same full-width weights and batch, dropout 0."""
    from fleetx_tpu_torch.data import build_dataloader
    from fleetx_tpu_torch.models.gpt.model import config_from_dict, init_params
    from fleetx_tpu_torch.tools.train import load_config

    cfg = load_config(TRAIN_YAML)
    glb = cfg["Global"]
    batch_np = next(iter(build_dataloader(
        cfg["Data"], "Train", batch_size=glb["global_batch_size"],
        seq_length=glb["max_seq_len"], vocab_size=cfg["Model"]["vocab_size"])))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}
    result = {}
    for dtype in ("float32", "bfloat16"):
        base = [f"Model.dtype={dtype}", "Model.hidden_dropout_prob=0.0",
                "Model.attention_probs_dropout_prob=0.0"]
        params = init_params(config_from_dict(dict(cfg["Model"])), seed=0,
                             device=dev)
        runs = []
        for on in (True, False):
            runs.append(_loss_and_grads(
                base + [f"Model.use_flash_attention={on}",
                        f"Model.fused_residual_norm={on}"], params, batch))
            torch.cuda.empty_cache()
        (loss_on, g_on), (loss_off, g_off) = runs
        rel = max(float((a.float() - b.float()).abs().max())
                  / max(float(b.float().abs().max()), 1e-30)
                  for a, b in zip(g_on, g_off))
        result[dtype] = dict(loss_on=loss_on, loss_off=loss_off,
                             loss_diff=abs(loss_on - loss_off),
                             max_grad_diff_over_leaf_max=rel)
        if dtype == "float32":
            check(abs(loss_on - loss_off) <= 1e-4,
                  f"f32 loss kernels on {loss_on} vs off {loss_off}")
            check(rel <= 1e-3, f"f32 grads kernels on vs off: {rel}")
        del params, runs, g_on, g_off
        torch.cuda.empty_cache()
    emit("train_kernel_vs_plain", **result, nvidia_smi=card)


# --------------------------------------------------------------- phase 6
SEQ8K_STEPS = 3
#: per step of the seq-8192 path (24 layers x 4 micro-batches, full
#: recompute): the forward and the norm forwards inside each layer run
#: twice (forward, then recomputed in the backward), ln_f once; one split
#: backward pair per layer; the fused backward never
SEQ8K_PER_STEP = {"flash_attention_fwd": 2 * 24 * 4,
                  "flash_attention_bwd_dq": 24 * 4,
                  "flash_attention_bwd_dkv": 24 * 4,
                  "flash_attention_bwd_fused": 0,
                  "fused_norm_fwd": (2 * 48 + 1) * 4,
                  "fused_norm_bwd": 49 * 4,
                  "paged_attention_decode": 0,
                  # bf16 at head_dim 128: every forward, dq and dk/dv
                  # launch on the tensor cores
                  "flash_attention_fwd_tc": 2 * 24 * 4,
                  "flash_attention_bwd_fused_tc": 0,
                  "flash_attention_bwd_dq_tc": 24 * 4,
                  "flash_attention_bwd_dkv_tc": 24 * 4}
#: the seq-8192 losses of a run on the SIMT forward and dk/dv (same seeds,
#: every product in f32; NVIDIA H100 80GB HBM3, 700 W): the first depends
#: only on the forward, steps 2-3 on the backward too
SEQ8K_SIMT_LOSSES = (11.234864234924316, 11.242216110229492,
                    11.232942581176758)
SEQ8K_LOSS_TOL = (1e-3, 1e-2, 1e-2)


def phase_seq8k_trainer(dev: torch.device, card: str) -> dict:
    """Phase 6: GPT-1.3B at seq 8192 (``pretrain_gpt_1.3B_seq8k_ring.yaml``
    with ``SEQ8K_OVERRIDES``: ring attention at ring size 1, full
    recompute, the chunked LM head, 4 micro-batches of 2) through
    ``build_trainer`` / ``fit`` at full width and depth for
    ``SEQ8K_STEPS`` steps, the launch counts zeroed just before and read
    just after; then one profiled step."""
    from torch.profiler import ProfilerActivity, profile

    from fleetx_tpu_torch.tools.train import build_trainer, load_config
    from fleetx_tpu_torch.utils.hardware import peak_flops

    cfg = load_config(SEQ8K_YAML, SEQ8K_OVERRIDES + ["Engine.logging_freq=1"])
    engine, train_dl, _ = build_trainer(cfg, device=dev)
    mc = engine.module.model_cfg
    glb = cfg["Global"]
    check(mc.num_layers == 24 and mc.hidden_size == 2048
          and mc.num_attention_heads == 16 and mc.vocab_size == 50304
          and mc.dtype == torch.bfloat16 and glb["max_seq_len"] == 8192
          and mc.max_position_embeddings == 8192
          and glb["global_batch_size"] == 8 and glb["micro_batch_size"] == 2
          and engine.accumulate_steps == 4 and mc.use_ring_attention
          and mc.use_recompute
          and mc.recompute_granularity == "full" and mc.vocab_chunk == 6288
          and mc.hidden_dropout_prob == 0.1
          and mc.attention_probs_dropout_prob == 0.0,
          "not the full-width GPT-1.3B seq-8192 recipe")
    torch.cuda.empty_cache()
    reset_peak(dev)
    zero_counts()                   # every count to 0 just before
    losses = engine.fit(train_dl)
    torch.cuda.synchronize()
    counts = read_counts()          # read just after
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    for name, per_step in SEQ8K_PER_STEP.items():
        check(counts[name] == per_step * SEQ8K_STEPS,
              f"seq8k {name}: {counts[name]} launches, want {per_step} x "
              f"{SEQ8K_STEPS} steps")
    hist = engine.history
    check(len(losses) == SEQ8K_STEPS and len(hist) == SEQ8K_STEPS,
          "a step was not logged")
    check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    norms = [h["grad_norm"] for h in hist]
    check(all(np.isfinite(norms)), f"non-finite grad norm: {norms}")
    expect = float(np.log(mc.vocab_size)
                   + mc.hidden_size * mc.initializer_range ** 2 / 2)
    check(abs(losses[0] - expect) < 0.1,
          f"first loss {losses[0]} is not within 0.1 of {expect}")
    loss_diffs = [abs(a - b) for a, b in zip(losses, SEQ8K_SIMT_LOSSES)]
    check(all(d <= tol for d, tol in zip(loss_diffs, SEQ8K_LOSS_TOL)),
          f"seq8k losses {losses} against the SIMT run's "
          f"{SEQ8K_SIMT_LOSSES}: "
          f"differences {loss_diffs} exceed {SEQ8K_LOSS_TOL}")
    step_s = statistics.median(h["train_cost"] for h in hist[1:])
    tokens = glb["global_batch_size"] * glb["max_seq_len"]
    fpt = engine.module.flops_per_token()
    peak = peak_flops(torch.cuda.get_device_name(dev)) or PEAK_BF16_FLOPS
    out = dict(steps=SEQ8K_STEPS, losses=losses, grad_norms=norms,
               loss_diffs_from_simt_run=loss_diffs,
               first_loss=losses[0], expected_first_loss=expect,
               step_ms=[h["train_cost"] * 1e3 for h in hist],
               step_ms_median_of_steps_2_3=step_s * 1e3,
               tokens_per_step=tokens, tokens_per_s=tokens / step_s,
               model_flops_per_step=fpt * tokens,
               mfu=fpt * tokens / step_s / peak, peak_flops=peak,
               max_memory_allocated_gb=peak_gb, launches=counts,
               launches_per_step={k: counts[k] / SEQ8K_STEPS
                                  for k in SEQ8K_PER_STEP},
               nvidia_smi=card)
    emit("seq8k_train_main_path", **out)

    # where one step's time goes, from a profiled step
    batch = engine.to_device(next(iter(train_dl)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.train_step(batch)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows = _trace_rows(prof)
    ms = lambda us: us / 1e3  # noqa: E731

    def share(pattern: str) -> float:
        return ms(sum(us for k, us in rows if pattern in k))

    device_ms = ms(sum(us for _, us in rows))
    matmul_ms = ms(sum(us for k, us in rows if any(
        m in k for m in ("nvjet", "gemm", "cutlass", "sm90_xmma"))))
    # "flash_fwd_kernel" / "flash_bwd_dq_kernel" / "flash_bwd_dkv_kernel"
    # also match the tensor-core kernels (``..._kernel_tc``), whose own
    # rows are shown too
    kernels = {"flash_fwd_ms": share("flash_fwd_kernel"),
               "flash_bwd_dq_ms": share("flash_bwd_dq_kernel"),
               "flash_bwd_dkv_ms": share("flash_bwd_dkv_kernel"),
               "norm_fwd_ms": share("fused_norm_fwd"),
               "norm_bwd_ms": share("fused_norm_bwd_kernel")}
    top = sorted(rows, key=lambda r: -r[1])[:12]
    emit("seq8k_train_trace", steps=1, profiled_wall_ms=wall_ms,
         flash_fwd_tc_ms=share("flash_fwd_kernel_tc"),
         flash_bwd_dq_tc_ms=share("flash_bwd_dq_kernel_tc"),
         flash_bwd_dkv_tc_ms=share("flash_bwd_dkv_kernel_tc"),
         unprofiled_step_ms=step_s * 1e3,
         device_ms=device_ms if rows else None,
         device_busy_share=device_ms / (step_s * 1e3) if rows else None,
         matmul_ms=matmul_ms,
         other_ms=device_ms - matmul_ms - sum(kernels.values()),
         **kernels,
         top_kernels_ms=[[k[:80], ms(us)] for k, us in top],
         nvidia_smi=card)
    del engine, batch, prof
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------- phase 7
#: the training path at reduced depth for the on/off comparisons
SHORT = ["Model.num_layers=4"]
#: dots with ``remat_save_dtype: bfloat16`` in f32 against recompute off:
#: the four named residuals a layer (and their cotangents) are rounded to
#: bf16, a relative error of at most 2**-9 each, so the loss may move by
#: ~1e-3 of its ~11 and the grads are held within the tensor-core drift
#: bound (2**-6 of each leaf's largest magnitude), which covers one
#: bf16 rounding summed over a row with mixed signs
DOTS_BF16_LOSS_TOL = 1e-2


def phase_split_and_recompute_on_path(dev: torch.device, card: str) -> None:
    """Phase 7, on ``pretrain_gpt_345M_synthetic.yaml`` cut to 4 layers,
    one loss+grad evaluation per variant on the same weights, batch and
    seed: (a) attention dropout 0.1, ``flash_fused_bwd`` on against off
    (fused kernel against the split pair), f32 and bf16; (b) hidden and
    attention dropout 0.1, f32, ``use_recompute`` with each granularity
    against off."""
    from fleetx_tpu_torch.data import build_dataloader
    from fleetx_tpu_torch.models.gpt.model import config_from_dict, init_params
    from fleetx_tpu_torch.tools.train import load_config

    cfg = load_config(TRAIN_YAML, SHORT)
    glb = cfg["Global"]
    batch_np = next(iter(build_dataloader(
        cfg["Data"], "Train", batch_size=glb["global_batch_size"],
        seq_length=glb["max_seq_len"], vocab_size=cfg["Model"]["vocab_size"])))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}

    def rel(g_a, g_b) -> float:
        return max(float((a.float() - b.float()).abs().max())
                   / max(float(b.float().abs().max()), 1e-30)
                   for a, b in zip(g_a, g_b))

    result = {}
    for dtype in ("float32", "bfloat16"):
        base = SHORT + [f"Model.dtype={dtype}",
                        "Model.hidden_dropout_prob=0.0",
                        "Model.attention_probs_dropout_prob=0.1"]
        params = init_params(config_from_dict(dict(cfg["Model"])), seed=0,
                             device=dev)
        zero_counts()
        fused = _loss_and_grads(base, params, batch)
        split = _loss_and_grads(base + ["Model.flash_fused_bwd=False"],
                                params, batch)
        counts = read_counts()
        layers = int(cfg["Model"]["num_layers"])
        check(counts["flash_attention_bwd_fused"] == layers
              and counts["flash_attention_bwd_dq"] == layers
              and counts["flash_attention_bwd_dkv"] == layers,
              f"split vs fused: launches {counts}")
        diff = rel(split[1], fused[1])
        result[f"split_vs_fused_{dtype}"] = dict(
            loss_fused=fused[0], loss_split=split[0],
            loss_diff=abs(fused[0] - split[0]),
            max_grad_diff_over_leaf_max=diff)
        if dtype == "float32":
            check(abs(fused[0] - split[0]) <= 1e-6,
                  f"f32 loss fused {fused[0]} vs split {split[0]}")
            check(diff <= 1e-5, f"f32 grads split vs fused: {diff}")
        del fused, split
        torch.cuda.empty_cache()
    base = SHORT + ["Model.dtype=float32", "Model.hidden_dropout_prob=0.1",
                    "Model.attention_probs_dropout_prob=0.1"]
    off = _loss_and_grads(base, params, batch)
    for granularity in ("full", "full_attn", "core_attn", "dots"):
        on = _loss_and_grads(base + ["Model.use_recompute=True",
                                     f"Model.recompute_granularity="
                                     f"{granularity}"], params, batch)
        diff = rel(on[1], off[1])
        result[f"recompute_{granularity}_vs_off_float32"] = dict(
            loss_on=on[0], loss_off=off[0], loss_diff=abs(on[0] - off[0]),
            max_grad_diff_over_leaf_max=diff)
        check(abs(on[0] - off[0]) <= 1e-6,
              f"recompute {granularity}: loss {on[0]} vs {off[0]}")
        check(diff <= 1e-6, f"recompute {granularity}: grads {diff}")
        del on
        torch.cuda.empty_cache()
    # dots with the named residuals saved in bf16: the forward rounds them
    # too, so this is a drift from off, not an equality
    on = _loss_and_grads(base + DOTS_OVERRIDES
                         + ["Model.remat_save_dtype=bfloat16"], params, batch)
    diff = rel(on[1], off[1])
    result["recompute_dots_bf16_vs_off_float32"] = dict(
        loss_on=on[0], loss_off=off[0], loss_diff=abs(on[0] - off[0]),
        max_grad_diff_over_leaf_max=diff, loss_tol=DOTS_BF16_LOSS_TOL,
        grad_tol=TC_DRIFT)
    check(abs(on[0] - off[0]) <= DOTS_BF16_LOSS_TOL,
          f"dots bf16: loss {on[0]} vs {off[0]}")
    check(diff <= TC_DRIFT, f"dots bf16: grads {diff}")
    del params, off, on
    torch.cuda.empty_cache()
    emit("split_and_recompute_on_path", layers=int(cfg["Model"]["num_layers"]),
         **result, nvidia_smi=card)


# --------------------------------------------------------------- phase 8
GEN_YAML = os.path.join(REPO, "fleetx_tpu", "configs", "nlp", "gpt",
                        "generation_gpt_345M_single_card.yaml")
#: phases 9-11 and 13 take phase 8's newest params cut to their first
#: CUT_LAYERS layers, as a params-only checkpoint (a depth cut, for the
#: smoke's time limit: every process and engine of those phases restores
#: the checkpoint, ~5 s of verified reads of the 4.26 GB state at 24
#: layers, and their generation, eval, fine-tune and serving runs grow
#: with the layers; every checked property is per layer, per call or a
#: comparison on the same params)
CUT_LAYERS = 4
CUT_DEPTH = [f"Model.num_layers={CUT_LAYERS}"]
#: the resume run: steps 1-5 saved by one engine, 6-10 by a new one
CKPT_STEPS = 5
#: a 345M state is ~4.3 GB (f32 params and two AdamW moments, ~355 M x
#: 12 B); two steps of it and room to spare
CKPT_MIN_FREE_BYTES = 10e9


class _Records:
    """Log records of the port's logger (it does not propagate)."""

    def __init__(self):
        import logging

        self.lines: list = []
        self.handler = logging.Handler()
        self.handler.emit = lambda rec: self.lines.append(rec.getMessage())

    def __enter__(self):
        from fleetx_tpu_torch.utils.log import logger

        logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        from fleetx_tpu_torch.utils.log import logger

        logger.removeHandler(self.handler)


def _timed(obj, name: str, times: list) -> None:
    """Record the host wall of every call of ``obj.name`` in ``times``
    (device work synchronised before and after)."""
    fn = getattr(obj, name)

    def wrapper(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return out

    setattr(obj, name, wrapper)


def _unpatch(obj, *names: str) -> None:
    """Drop the instance attributes ``names`` that shadow ``obj``'s
    methods (``_timed``, ``_first_batch``, a phase's spy), so its class's
    own run again. A patch holding a bound method of ``obj`` ties ``obj``
    into a reference cycle: an engine's parameters and optimizer state
    would stay on the card until the cyclic collector ran."""
    for name in names:
        obj.__dict__.pop(name, None)


def _first_batch(engine, out: list) -> None:
    """Keep in ``out`` the tokens of the first batch ``engine`` trains on
    (on the host)."""
    fn = engine.train_step

    def wrapper(batch, *a, **k):
        if not out:
            out.append(batch["tokens"].cpu())
        return fn(batch, *a, **k)

    engine.train_step = wrapper


def _host_batches(cfg: dict, n: int) -> list:
    """The first ``n`` host batches of a fresh train loader of ``cfg``."""
    from fleetx_tpu_torch.data import build_dataloader

    glb = cfg["Global"]
    it = iter(build_dataloader(
        cfg["Data"], "Train", batch_size=glb["global_batch_size"],
        seq_length=glb["max_seq_len"], vocab_size=cfg["Model"]["vocab_size"]))
    return [next(it) for _ in range(n)]


def _nth_batch(cfg: dict, n: int) -> torch.Tensor:
    """The tokens of batch ``n`` (from 0) of a fresh train loader of
    ``cfg``: the batch an uninterrupted run trains on at step ``n + 1``."""
    return torch.from_numpy(_host_batches(cfg, n + 1)[-1]["tokens"])


def _state_bytes(state: dict) -> int:
    return sum(v.numel() * v.element_size() for v in state.values()
               if torch.is_tensor(v))


def phase_checkpoint(dev: torch.device, card: str, uninterrupted: list,
                     root: str) -> dict:
    """Phase 8: save at step 5 of the 345M recipe, resume to step 10 in a
    new engine, audit, corrupt, fall back."""
    from fleetx_tpu_torch.core import checkpoint as C
    from fleetx_tpu_torch.tools import verify_ckpt
    from fleetx_tpu_torch.tools.train import build_trainer, load_config

    free = shutil.disk_usage(root).free
    check(free >= CKPT_MIN_FREE_BYTES,
          f"{root} has {free / 1e9:.1f} GB free; the 345M checkpoints need "
          f"{CKPT_MIN_FREE_BYTES / 1e9:.0f} GB")
    out = os.path.join(root, "ckpt")
    base = ["Engine.logging_freq=1",
            f"Engine.save_load.save_steps={CKPT_STEPS}",
            f"Engine.save_load.output_dir={out}"]
    cfg = load_config(TRAIN_YAML, base + [f"Engine.max_steps={CKPT_STEPS}"])
    first, dl, _ = build_trainer(cfg, device=dev)
    mc = first.module.model_cfg
    check(mc.num_layers == 24 and mc.hidden_size == 1024
          and mc.num_attention_heads == 16 and mc.vocab_size == 50304
          and mc.dtype == torch.bfloat16 and mc.hidden_dropout_prob == 0.1,
          "not the full-width 345M training recipe")
    save_s: list = []
    _timed(first, "save", save_s)
    reset_peak(dev)
    head = first.fit(dl)
    check(C.completed_steps(out) == [CKPT_STEPS] and len(save_s) == 1,
          f"steps saved: {C.completed_steps(out)}")
    saved = first.state_dict()
    nbytes = _state_bytes(saved)
    payload = os.path.getsize(os.path.join(C.step_dir(out, CKPT_STEPS),
                                           C.STATE_NAME))

    second, dl2, _ = build_trainer(load_config(TRAIN_YAML, base + [
        f"Engine.max_steps={2 * CKPT_STEPS}",
        f"Engine.save_load.ckpt_dir={out}"]), device=dev)
    load_s: list = []
    _timed(second, "load", load_s)
    _timed(second, "save", save_s)
    trained: list = []
    _first_batch(second, trained)
    second.prepare()
    restored = second.state_dict()
    check(sorted(restored) == sorted(saved), "restored leaf names")
    for k, v in saved.items():
        same = torch.equal(restored[k], v) if torch.is_tensor(v) \
            else restored[k] == v
        check(same, f"restored {k} differs from the saved one")
    check(second.consumed_samples == first.consumed_samples
          == CKPT_STEPS * 8, f"consumed_samples {second.consumed_samples}")
    _unpatch(first, "save")
    del first, saved, restored
    torch.cuda.empty_cache()
    zero_counts()                   # every count to 0 just before
    tail = second.fit(dl2)
    torch.cuda.synchronize()
    counts = read_counts()          # read just after
    for name, per_step in PER_STEP.items():
        check(counts[name] == per_step * CKPT_STEPS,
              f"resume: {name} {counts[name]} launches, want {per_step} x "
              f"{CKPT_STEPS}")
    check(C.completed_steps(out) == [CKPT_STEPS, 2 * CKPT_STEPS],
          f"steps saved: {C.completed_steps(out)}")
    # the data position: the first batch after the resume is the one the
    # uninterrupted run took at step 6
    check(torch.equal(trained[0], _nth_batch(cfg, CKPT_STEPS)),
          f"the resumed run's first batch is not batch {CKPT_STEPS + 1}")
    # bitwise: dropout is a function of seed and step, and every kernel
    # and op of the step is deterministic
    want = uninterrupted[CKPT_STEPS:2 * CKPT_STEPS]
    diffs = [abs(a - b) for a, b in zip(tail, want)]
    check(len(tail) == CKPT_STEPS and max(diffs) == 0.0,
          f"resumed losses {tail} vs phase 4's {want}")
    check(head == uninterrupted[:CKPT_STEPS],
          f"first five losses {head} vs phase 4's")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2 ** 30

    # the auditor: both steps ok; a flipped byte of step 10's payload is
    # corrupt (exit 1) and load() falls back to step 5; flipped back, ok
    audit = verify_ckpt.audit_directory(out)
    statuses = [r["status"] for r in audit["steps"]]
    check(statuses == ["ok", "ok"], f"audit {statuses}")
    target = os.path.join(C.step_dir(out, 2 * CKPT_STEPS), C.STATE_NAME)

    def flip():
        with open(target, "r+b") as f:
            f.seek(payload // 2)
            byte = f.read(1)
            f.seek(payload // 2)
            f.write(bytes([byte[0] ^ 0xFF]))

    flip()
    # the CLI's one audit of step 10 gives both its exit code and its
    # report (each audit re-digests the 4.26 GB payload)
    report = os.path.join(root, "verify_ckpt.json")
    code = verify_ckpt.main([out, "--step", str(2 * CKPT_STEPS),
                             "--json", report])
    with open(report) as f:
        bad = json.load(f)["steps"][0]
    check(code == 1 and bad["status"] == "corrupt",
          f"flipped payload: exit {code}, {bad['status']}")
    with _Records() as records:
        check(second.load(out), "load() restored nothing")
    check(second.step == CKPT_STEPS
          and second.consumed_samples == CKPT_STEPS * 8,
          f"fallback landed at step {second.step}")
    warned = [l for l in records.lines if "falling back past corrupt "
              f"checkpoint step {2 * CKPT_STEPS}" in l]
    check(len(warned) == 1, f"fallback warning: {records.lines}")
    flip()
    # step 5 is as the first audit found it; step 10 is audited again
    restored = verify_ckpt.audit_directory(out, step=2 * CKPT_STEPS)
    statuses = [statuses[0]] + [r["status"] for r in restored["steps"]]
    check(statuses == ["ok", "ok"], f"audit after the flip back {statuses}")
    _unpatch(second, "load", "save", "train_step")
    del second
    torch.cuda.empty_cache()
    result = dict(
        steps=[CKPT_STEPS, 2 * CKPT_STEPS], first_losses=head,
        resumed_losses=tail, uninterrupted_losses=want,
        max_abs_loss_diff=max(diffs), bitwise=max(diffs) == 0.0,
        resumed_batch_equal=True,
        state_gb=nbytes / 1e9, payload_gb=payload / 1e9,
        save_s=save_s, save_gb_per_s=[payload / 1e9 / t for t in save_s],
        load_s=load_s[0], load_gb_per_s=payload / 1e9 / load_s[0],
        fallback_load_s=load_s[1], audit=statuses,
        corrupt_exit_code=code, fallback_step=CKPT_STEPS,
        fallback_warning=warned[0], peak_memory_gb=peak_gb,
        launches=counts, disk_free_gb=free / 1e9, nvidia_smi=card)
    emit("checkpoint", **result)
    return result


# --------------------------------------------------------------- phase 9
#: the batch of generation prompts, tokens (cut from README.md's ids)
GEN_PROMPT_LENS = (300, 5, 37, 120, 64, 200, 16, 90)
#: the strategies: the YAML's own (sampling, top-k 50, top-p 0.75),
#: greedy, and beam search
GEN_STRATEGIES = (
    ("sampling", []),
    ("greedy_search", ["Generation.decode_strategy=greedy_search"]),
    ("beam_search", ["Generation.decode_strategy=beam_search",
                     "Generation.num_beams=4",
                     "Generation.num_return_sequences=2"]),
)
#: the f32 cross-check against the replica: prompts, new tokens
CROSS_PROMPT_LENS = (150, 40, 7, 64)
CROSS_NEW = 32


class _CountCalls:
    """Count the model calls of the generation path (the forward the
    decoders call) while the context is open, and time the first (the
    prefill) on the host's clock, device work synchronised around it."""

    def __init__(self):
        from fleetx_tpu_torch.models.gpt import model as M

        self.M, self.calls, self.real = M, 0, M.gpt_for_pretraining
        self.prefill_s = None

    def __enter__(self):
        def counting(*a, **k):
            self.calls += 1
            if self.calls > 1:
                return self.real(*a, **k)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self.real(*a, **k)
            torch.cuda.synchronize()
            self.prefill_s = time.perf_counter() - t0
            return out

        self.M.gpt_for_pretraining = counting
        return self

    def __exit__(self, *exc):
        self.M.gpt_for_pretraining = self.real


def _cut_checkpoint(dev: torch.device, root: str, ckpt_dir: str) -> str:
    """The newest params under ``ckpt_dir`` cut to their first
    ``CUT_LAYERS`` layers, saved as a params-only checkpoint (step 1)
    under ``root``; its directory."""
    from fleetx_tpu_torch.core import checkpoint as C

    params = _first_layers(C.load_params(ckpt_dir, device=dev), CUT_LAYERS)
    cut_dir = os.path.join(root, "ckpt_cut")
    C.save_checkpoint(cut_dir, 1, dict(step=1, **C.flatten(params,
                                                           "params/")))
    del params
    torch.cuda.empty_cache()
    return cut_dir


def _top2_gap(cfg, params, ids: list) -> float:
    """The gap between the two largest next-token logits after ``ids``."""
    from fleetx_tpu_torch.models.gpt import model as M

    with torch.no_grad():
        logits = M.gpt_for_pretraining(
            params, cfg, torch.tensor([ids], device=params["gpt"][
                "embeddings"]["word_embeddings"].device))[0, -1].float()
    top = torch.topk(logits, 2).values
    return float(top[0] - top[1])


def _generation_trace(dev: torch.device, card: str, base: list,
                      prompts: list, n_steps: int = 8) -> dict:
    """Where a greedy dense-cache decode step's time goes on ``prompts``
    (``_trace_window``), and the fused norm's share."""
    from fleetx_tpu_torch.models.gpt import generation as G
    from fleetx_tpu_torch.tasks.gpt import generation as task

    module, params, _ = task.build(task.load_config(GEN_YAML, base + [
        "Generation.decode_strategy=greedy_search"]), device=dev)
    mc, gc = module.model_cfg, module.gen_cfg
    tokens, mask = G.to_tensors(*G.left_pad(prompts, gc.pad_token_id), dev)
    # a warm window, then the unprofiled and the profiled one
    with torch.no_grad():
        logits, cache = G._prefill(mc, params, tokens, mask, 3 * n_steps)
    pos = mask.sum(dim=1)
    state = dict(tok=torch.argmax(logits, dim=-1), i=0)

    @torch.no_grad()
    def step():
        state["tok"] = torch.argmax(G._step(mc, params, state["tok"],
                                            pos + state["i"], cache), dim=-1)
        state["i"] += 1

    for _ in range(n_steps):
        step()
    fields, per_step = _trace_window(step, n_steps)
    out = dict(batch=len(prompts), context_tokens=int(tokens.shape[1]),
               **fields, norm_ms_per_step=per_step("fused_norm"),
               nvidia_smi=card)
    emit("generation_trace", **out)
    del module, params, cache
    torch.cuda.empty_cache()
    return out


def phase_generation(dev: torch.device, card: str, ckpt_dir: str,
                     root: str) -> dict:
    """Phase 9: the generation task from phase 8's checkpoint cut to
    ``CUT_LAYERS`` layers (``ckpt_dir``), three strategies at full width;
    f32 greedy against the replica serving the same checkpoint through
    the paged kernel."""
    from fleetx_tpu_torch.data.tokenizers.gpt_tokenizer import train_bpe
    from fleetx_tpu_torch.models.gpt import generation as G
    from fleetx_tpu_torch.tasks.gpt import generation as task
    from fleetx_tpu_torch.tools.serve import build_engine
    from fleetx_tpu_torch.tools.serve import load_config as serve_config

    with open(os.path.join(REPO, "README.md"), encoding="utf-8") as f:
        readme = f.read()
    tok = train_bpe([readme], 2000)
    tok_dir = os.path.join(root, "tokenizer")
    tok.save_pretrained(tok_dir)
    ids = tok.encode(readme)
    check(tok.vocab_size <= 2000 and max(ids) < 50304
          and len(ids) >= sum(GEN_PROMPT_LENS), "tokenizer")
    offsets = np.cumsum((0,) + GEN_PROMPT_LENS)
    prompts = [ids[o:o + n] for o, n in zip(offsets, GEN_PROMPT_LENS)]
    base = [f"Generation.tokenizer_dir={tok_dir}",
            f"Engine.save_load.ckpt_dir={ckpt_dir}"] + CUT_DEPTH
    per_model_call = None
    strategies = {}
    for name, extra in GEN_STRATEGIES:
        cfg = task.load_config(GEN_YAML, base + extra)
        with _Records() as records:
            module, params, gen = task.build(cfg, device=dev)
        check(any("restored params from" in l for l in records.lines),
              "params did not come from the checkpoint")
        mc = module.model_cfg
        check(mc.num_layers == CUT_LAYERS and mc.hidden_size == 1024
              and mc.num_attention_heads == 16 and mc.vocab_size == 50304
              and mc.dtype == torch.bfloat16, "not the full-width 345M model")
        per_model_call = 2 * mc.num_layers + 1
        texts = module.generate(params, [cfg["Generation"]["input_text"]],
                                gen)
        # the batch: one untimed prefill at its shape (a first call's
        # costs), then generate_ids timed whole, its prefill within it
        tokens, mask = G.to_tensors(*G.left_pad(
            prompts, module.gen_cfg.pad_token_id), dev)
        with torch.no_grad():
            G._prefill(mc, params, tokens, mask,
                       module.gen_cfg.max_new_tokens)
        del tokens, mask
        reset_peak(dev)
        zero_counts()               # every count to 0 just before
        with _CountCalls() as calls:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = module.generate_ids(params, prompts, gen)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = read_counts()      # read just after
        check(counts["fused_norm_fwd"] == per_model_call * calls.calls,
              f"{name}: {counts['fused_norm_fwd']} norm launches for "
              f"{calls.calls} model calls")
        check(all(counts[k] == 0 for k in counts
                  if k not in ("fused_norm_fwd", ROWS_COUNT)),
              f"{name}: other kernels launched {counts}")
        rows = out.shape[0]
        check(rows == len(prompts) * module.gen_cfg.num_return_sequences
              and out.shape[1] == module.gen_cfg.max_new_tokens
              and int(out.max()) < 50304 and int(out.min()) >= 0,
              f"{name}: output {out.shape}")
        # new tokens: each returned row's up to and including its eos (the
        # padding after it is not generated); computed rows: every row of
        # the batched forward (beam search: every beam), finished or not
        eos = module.gen_cfg.eos_token_id
        new_tokens = sum(int(np.argmax(r == eos)) + 1 if (r == eos).any()
                         else len(r) for r in out)
        computed = len(prompts) * (module.gen_cfg.num_beams
                                   if module.use_beam_search else
                                   module.gen_cfg.num_return_sequences)
        decode_steps = calls.calls - 1
        strategies[name] = dict(
            input_text=cfg["Generation"]["input_text"],
            continuations=texts, rows=rows, computed_rows=computed,
            model_calls=calls.calls, wall_s=wall,
            prefill_ms=calls.prefill_s * 1e3,
            # the rest of the call's wall per decode step: the step's
            # forward and its host-side selection
            ms_per_decode_step=(wall - calls.prefill_s) * 1e3 / max(
                decode_steps, 1),
            new_tokens=new_tokens, new_tokens_per_s=new_tokens / wall,
            computed_row_steps_per_s=computed * calls.calls / wall,
            peak_memory_gb=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
            fused_norm_fwd_launches=counts["fused_norm_fwd"],
            beams=module.gen_cfg.num_beams)
        print(f"generation {name}: {texts!r}", flush=True)
        del module, params, out
        torch.cuda.empty_cache()

    trace = _generation_trace(dev, card, base, prompts)

    # f32 greedy against the replica on the same checkpoint
    cross = [ids[o:o + n] for o, n in zip(np.cumsum(
        (0,) + CROSS_PROMPT_LENS), CROSS_PROMPT_LENS)]
    cfg = task.load_config(GEN_YAML, base + [
        "Generation.decode_strategy=greedy_search", "Model.dtype=float32",
        f"Generation.max_dec_len={CROSS_NEW}"])
    module, params, _ = task.build(cfg, device=dev)
    gen_rows = module.generate_ids(params, cross)
    eos = module.gen_cfg.eos_token_id
    replica = build_engine(serve_config(YAML, [
        f"Serving.ckpt_dir={ckpt_dir}", "Model.dtype=float32"] + CUT_DEPTH),
        device=dev)
    check(replica.paged_kernel_active, "replica not on the paged kernel")
    check(replica.eos_token_id == eos, "eos ids differ")
    zero_counts()                   # every count to 0 just before
    reqs = [replica.submit(p, CROSS_NEW, request_id=f"x{i}")
            for i, p in enumerate(cross)]
    replica.run_until_drained()
    paged = read_counts()["paged_attention_decode"]  # read just after
    check(paged > 0, "the replica launched no paged kernel")
    mismatches = []
    for i, (req, row) in enumerate(zip(reqs, gen_rows)):
        want = [int(t) for t in row]
        if eos in want:
            want = want[:want.index(eos) + 1]
        got = list(req.tokens)
        if got != want:
            pos = next((j for j, (a, b) in enumerate(zip(got, want))
                        if a != b), min(len(got), len(want)))
            gap = _top2_gap(module.model_cfg, params,
                            cross[i] + want[:pos])
            mismatches.append(dict(prompt=i, position=pos, top2_gap=gap))
            check(gap < 1e-3, f"prompt {i}: replica and generate differ at "
                              f"{pos} with a top-two logit gap of {gap}")
    del module, params, replica
    torch.cuda.empty_cache()
    result = dict(strategies=strategies, per_model_call=per_model_call,
                  trace=trace,
                  tokenizer_vocab=tok.vocab_size, prompt_lens=list(
                      GEN_PROMPT_LENS),
                  cross_check=dict(prompt_lens=list(CROSS_PROMPT_LENS),
                                   new_tokens=CROSS_NEW,
                                   identical=not mismatches,
                                   mismatches=mismatches,
                                   replica_paged_launches=paged),
                  nvidia_smi=card)
    emit("generation", **{k: v for k, v in result.items()
                          if k != "strategies"},
         strategies={k: {kk: vv for kk, vv in v.items()
                         if kk != "continuations"}
                     for k, v in strategies.items()})
    return result


# -------------------------------------------------------------- phase 10
EVAL_YAML = os.path.join(REPO, "fleetx_tpu", "configs", "nlp", "gpt",
                         "eval_gpt_345M_single_card.yaml")
PRETRAIN_YAML = os.path.join(REPO, "fleetx_tpu", "configs", "nlp", "gpt",
                             "pretrain_gpt_345M_single_card.yaml")
INF_YAML = os.path.join(REPO, "fleetx_tpu", "configs", "nlp", "gpt",
                        "inference_gpt_345M_single_card.yaml")
#: the in-process comparisons of phase 10 (kernels on against off, f32 and
#: bf16) run on the first EVAL_PREFIX windows of the ppl eval
EVAL_PREFIX = 256
#: kernels on against off in bf16, relative on the eval loss: the flash
#: kernel rounds the unnormalised P to bf16 against the running max, the
#: plain path the normalised probabilities, so each attention output moves
#: by a few bf16 ulps (2**-8 relative) either way; the loss is a mean over
#: ~10**5 tokens, where such differences average out (phase 5 measures
#: 9.6e-5 on an 11.03 loss at the training shape, 9e-6 relative): 1e-3,
#: a hundred times that
EVAL_BF16_RTOL = 1e-3
#: ... and in f32 (both paths compute every product in f32)
EVAL_F32_RTOL = 1e-5
#: the eval recipe's batch (``Offline_Eval.batch_size``)
EVAL_BATCH = 8
#: exported forward: calls timed after the first
FORWARD_CALLS = 20
#: depth of phase 11's f32 generation export (the checkpoint's first
#: layers; the bf16 exports run all CUT_LAYERS), cut to keep the smoke
#: inside its limit on a slow host
F32_EXPORT_LAYERS = 2


def _cli_start(module: str, args: list) -> tuple:
    """Start ``python -m fleetx_tpu_torch.<module> <args>`` as its own
    process on this card; ``_cli_wait`` collects it. Its output goes to
    unnamed temporary files, so a process left running beside this one's
    work never stalls on a full pipe."""
    logs = (tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+"))
    proc = subprocess.Popen(
        [sys.executable, "-m", f"fleetx_tpu_torch.{module}"] + args,
        cwd=REPO, stdout=logs[0], stderr=logs[1], text=True,
        env=dict(os.environ, PYTHONPATH=REPO))
    proc.logs = logs
    return module, proc


def _cli_wait(started: tuple, timeout: int = 600, want: int = 0) -> tuple:
    """(its JSON lines, its stdout, its stderr); an exit code other than
    ``want`` raises with its stderr, and a process past ``timeout`` is
    killed."""
    module, proc = started
    try:
        proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    for f in proc.logs:
        f.seek(0)
    stdout, stderr = (f.read() for f in proc.logs)
    for f in proc.logs:
        f.close()
    check(proc.returncode == want, f"{module} exited {proc.returncode}: "
                                   f"{stderr[-3000:]}")
    lines = [json.loads(line) for line in stdout.splitlines()
             if line.startswith("{")]
    return lines, stdout, stderr


def _cli(module: str, args: list) -> tuple:
    """``_cli_start`` then ``_cli_wait``."""
    return _cli_wait(_cli_start(module, args))


def _overrides(pairs: list) -> list:
    return sum((["-o", p] for p in pairs), [])


def _eval_texts(root: str) -> tuple:
    """``docs/*.md`` sorted and concatenated (the ppl text), and a cloze
    jsonl of its paragraphs of five words or more, the last word of each
    the target (the acc text)."""
    import glob

    text = "".join(open(p, encoding="utf-8").read()
                   for p in sorted(glob.glob(os.path.join(REPO, "docs",
                                                          "*.md"))))
    os.makedirs(os.path.join(root, "eval"), exist_ok=True)
    txt = os.path.join(root, "eval", "docs.txt")
    with open(txt, "w", encoding="utf-8") as f:
        f.write(text)
    jsonl = os.path.join(root, "eval", "docs_cloze.jsonl")
    n = 0
    with open(jsonl, "w", encoding="utf-8") as f:
        for para in text.split("\n\n"):
            para = " ".join(para.split())
            if len(para.split()) >= 5:
                f.write(json.dumps({"text": para}) + "\n")
                n += 1
    return txt, jsonl, n


def _docs_corpus(root: str, txt: str, tok_dir: str) -> str:
    """``txt`` as a ``GPTDataset`` corpus written by the port's
    ``tools.preprocess_data`` with the tokenizer of ``tok_dir``; returns
    its prefix (phases 10 and 13 read it)."""
    prefix = os.path.join(root, "eval", "docs_corpus")
    _cli("tools.preprocess_data", [
        "--input", txt, "--tokenizer", tok_dir, "--output-prefix", prefix,
        "--workers", "4", "--append-eos"])
    return prefix


def _eval_loader(ds):
    from fleetx_tpu_torch.data.dataloader import DataLoader
    from fleetx_tpu_torch.data.sampler.batch_sampler import \
        DistributedBatchSampler

    return DataLoader(ds, DistributedBatchSampler(
        len(ds), EVAL_BATCH, num_replicas=1, rank=0, drop_last=False))


def _eval_module(dtype: str, kernels: bool):
    from fleetx_tpu_torch.core.module import GPTEvalModule
    from fleetx_tpu_torch.tools.eval import load_config

    return GPTEvalModule(load_config(EVAL_YAML, [
        f"Model.dtype={dtype}", f"Model.use_flash_attention={kernels}",
        f"Model.fused_residual_norm={kernels}"] + CUT_DEPTH))


def _eval_kernels_vs_plain(base: list, txt: str, params: dict) -> tuple:
    """Phase 10 in this process: the eval on its first ``EVAL_PREFIX``
    windows with the kernels on and off, f32 and bf16, on the
    checkpoint's params; ``(comparison, the prefix dataset)``."""
    from fleetx_tpu_torch.tools.eval import eval_dataset, load_config

    cfg = load_config(EVAL_YAML, base + [f"Offline_Eval.eval_path={txt}"])
    ds = eval_dataset(cfg)
    prefix = torch.utils.data.Subset(ds, range(min(EVAL_PREFIX, len(ds))))
    compare = {}
    for dtype, rtol in (("float32", EVAL_F32_RTOL),
                        ("bfloat16", EVAL_BF16_RTOL)):
        res = {k: _eval_module(dtype, k).run_offline_eval(
            params, _eval_loader(prefix)) for k in (True, False)}
        rel = abs(res[True]["loss"] - res[False]["loss"]) / abs(
            res[False]["loss"])
        check(rel <= rtol, f"eval {dtype}: kernels on {res[True]['loss']} "
                           f"vs off {res[False]['loss']} ({rel} > {rtol})")
        compare[dtype] = dict(loss_on=res[True]["loss"],
                              loss_off=res[False]["loss"],
                              ppl_on=res[True]["ppl"],
                              ppl_off=res[False]["ppl"], rel_diff=rel,
                              bound=rtol)
        torch.cuda.empty_cache()
    return compare, prefix


def phase_eval(dev: torch.device, card: str, root: str, ckpt_dir: str,
               tok_dir: str, params: dict) -> dict:
    """Phase 10: ``tools.eval`` on ``eval_gpt_345M_single_card.yaml`` from
    phase 8's checkpoint cut to ``CUT_LAYERS`` layers (``ckpt_dir``), ppl
    and acc, each its own process; the
    ``Data.Eval`` path on a corpus written by the port's
    ``preprocess_data``; in this process, while those run, kernels on
    against off (f32 and bf16), then one traced batch."""
    from fleetx_tpu_torch.data.tokenizers.gpt_tokenizer import GPTTokenizer

    txt, jsonl, n_cloze = _eval_texts(root)
    base = [f"Engine.save_load.ckpt_dir={ckpt_dir}",
            f"Offline_Eval.tokenizer_dir={tok_dir}"] + CUT_DEPTH
    runs = {}
    # the two evals, the corpus's preprocessing and then the Data.Eval
    # path run as processes while this one compares (the smoke's time
    # limit: each process start is ~20 s)
    started = {kind: _cli_start("tools.eval", ["-c", EVAL_YAML] + _overrides(
        base + [f"Offline_Eval.eval_path={path}",
                f"Offline_Eval.eval_type={kind}"]))
        for kind, path in (("ppl", txt), ("acc", jsonl))}
    try:
        tok = GPTTokenizer.from_pretrained(tok_dir)
        # the Data.Eval path: a GPTDataset of the same text written by the
        # port's preprocessing tool, a few batches through
        # EagerEngine(mode="eval")
        prefix_path = _docs_corpus(root, txt, tok_dir)
        data_eval_run = _cli_start("tools.eval", ["-c", PRETRAIN_YAML]
                                   + _overrides([
            f"Engine.save_load.ckpt_dir={ckpt_dir}",
            f"Data.Eval.dataset.input_dir={prefix_path}", *CUT_DEPTH,
            "Data.Eval.dataset.num_samples=32",
            f"Data.Eval.dataset.eos_id={tok.eos_token_id}",
            "Engine.eval_iters=3"]))
        started["data_eval"] = data_eval_run
        compare, prefix = _eval_kernels_vs_plain(base, txt, params)
        outputs = {kind: _cli_wait(started[kind]) for kind in ("ppl", "acc")}
        _, stdout, _ = _cli_wait(data_eval_run)
    finally:
        for _, proc in started.values():
            if proc.poll() is None:   # another one failed first
                proc.kill()
                proc.communicate()
    for kind, (lines, _, _) in outputs.items():
        rec = lines[-1]
        check(rec["eval_type"] == kind and rec["device"].startswith("cuda"),
              f"eval {kind}: {rec}")
        check(np.isfinite(rec["loss"]) and np.isfinite(rec["ppl"])
              and (kind != "acc" or 0.0 <= rec["acc"] <= 1.0),
              f"eval {kind}: {rec}")
        per_batch = {k: v / rec["batches"]
                     for k, v in rec["launches"].items()}
        check(per_batch == {"flash_attention_fwd": CUT_LAYERS,
                            "fused_norm_fwd": 2 * CUT_LAYERS + 1,
                            ROWS_COUNT: 2 * CUT_LAYERS + 1},
              f"eval {kind}: launches per batch {per_batch}")
        runs[kind] = dict(rec, launches_per_batch=per_batch)
    stream = len(tok.encode(open(txt, encoding="utf-8").read()))
    check(runs["ppl"]["stream_tokens"] == stream
          and runs["acc"]["windows"] == n_cloze,
          f"eval sizes: {stream} tokens, {n_cloze} cloze paragraphs")
    # one traced batch (bf16, kernels on), the card to itself again
    module = _eval_module("bfloat16", True)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             next(iter(_eval_loader(prefix))).items()}
    trace, _ = _trace_window(lambda: module.batch_metrics(params, batch), 3)

    data_eval = float([l for l in stdout.splitlines()
                       if l.startswith("eval loss:")][-1].split(": ")[1])
    check(np.isfinite(data_eval), f"Data.Eval loss {data_eval}")
    for rec in runs.values():
        # window tokens over the wall after the first batch (which pays the
        # process's one-off costs: module imports on the custom ops' first
        # call, cuBLAS and kernel-library loads)
        rec["warm_tokens_per_s"] = (rec["windows"] - EVAL_BATCH) * \
            rec["seq_length"] / (rec["wall_s"] - rec["first_batch_ms"] / 1e3)
    out = dict(text="docs/*.md", stream_tokens=stream,
               corpus_prefix=prefix_path,
               cloze_paragraphs=n_cloze, ppl=runs["ppl"], acc=runs["acc"],
               kernels_vs_plain=compare, prefix_windows=len(prefix),
               trace=trace, data_eval_loss=data_eval, data_eval_batches=3,
               nvidia_smi=card)
    emit("eval", **out)
    del module, batch
    torch.cuda.empty_cache()
    return out


# -------------------------------------------------------------- phase 11
def _first_layers(params: dict, n: int) -> dict:
    """``params`` with its stacked ``[layers, ...]`` leaves cut to the
    first ``n`` layers (views; the other leaves as they are)."""
    gpt = dict(params["gpt"])
    gpt["layers"] = {k: {kk: vv[:n] for kk, vv in v.items()}
                     for k, v in gpt["layers"].items()}
    return {**params, "gpt": gpt}


def p50_ms(fn, calls: int = FORWARD_CALLS) -> float:
    """Median host wall of ``fn`` over ``calls`` calls after one, device
    work synchronised around each."""
    fn()
    walls = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls) * 1e3


def graph_ms(fn, n: int = 20, replays: int = 10) -> float:
    """Device time per call of ``fn``: ``n`` calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events (median per
    call). No host work and no L2 flush: every input of the calls timed
    with it exceeds the L2's 50 MB, so each call reads its inputs from
    memory all the same. ``device_ms`` reads the same quantity from
    ``torch.profiler``, whose sessions can misattribute kernels when many
    have run in one process; this does not."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    del graph
    return statistics.median(times)


def _timed_decoder(eng) -> dict:
    """Count the model calls of ``eng``'s decoder and time its prefill
    (device work synchronised around it); the record it fills."""
    rec = {"calls": 0, "prefill_s": None}
    prefill, step = eng.decoder.prefill, eng.decoder.step

    def timed_prefill(*a):
        rec["calls"] += 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = prefill(*a)
        torch.cuda.synchronize()
        rec["prefill_s"] = time.perf_counter() - t0
        return out

    def counted_step(*a):
        rec["calls"] += 1
        return step(*a)

    eng.decoder.prefill, eng.decoder.step = timed_prefill, counted_step
    return rec


def _generate_timed(eng, inputs: list, layers: int = 24) -> tuple:
    """``eng.predict(inputs)`` with its model calls counted and its launch
    counts zeroed before and read after: (ids, record). Each model call
    of a ``layers``-layer model launches kernel 5 ``2 * layers + 1``
    times."""
    rec = _timed_decoder(eng)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids = eng.predict(inputs)[0]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    rec.update(wall_s=wall, ms_per_decode_step=(wall - rec["prefill_s"])
               * 1e3 / max(rec["calls"] - 1, 1),
               new_tokens=int(ids.size), new_tokens_per_s=ids.size / wall,
               fused_norm_fwd=counts["fused_norm_fwd"],
               other_launches=sum(v for k, v in counts.items()
                                  if k not in ("fused_norm_fwd", ROWS_COUNT)))
    check(rec["fused_norm_fwd"] == (2 * layers + 1) * rec["calls"]
          and rec["other_launches"] == 0,
          f"generation: {counts} launches for {rec['calls']} model calls")
    return ids, rec


def phase_export(dev: torch.device, card: str, root: str, ckpt_dir: str,
                 tok_dir: str, params: dict) -> dict:
    """Phase 11: ``tools.export`` of both targets of
    ``inference_gpt_345M_single_card.yaml`` from phase 8's checkpoint cut
    to its first ``CUT_LAYERS`` layers (``ckpt_dir``, ``params``), the
    exported forward against the eager one with its latencies, the
    generation programs against eager generation (greedy in bf16 and f32,
    sampling under one seed), ``tools.inference`` and
    ``tasks.gpt.inference`` as their own processes."""
    from fleetx_tpu_torch.core.checkpoint import flatten
    from fleetx_tpu_torch.core.engine.inference_engine import \
        InferenceEngine
    from fleetx_tpu_torch.core.module import GPTGenerationModule
    from fleetx_tpu_torch.data.tokenizers.gpt_tokenizer import GPTTokenizer
    from fleetx_tpu_torch.models.gpt import generation as G
    from fleetx_tpu_torch.models.gpt import model as M
    from fleetx_tpu_torch.tools import export as X
    from fleetx_tpu_torch.utils.export import export_model

    base = [f"Engine.save_load.ckpt_dir={ckpt_dir}"] + CUT_DEPTH
    fwd_dir = os.path.join(root, "exported_forward")
    gen_dir = os.path.join(root, "exported_generation")
    exports = {}
    # both exports at once, each its own process (the smoke's time limit)
    started = {target: _cli_start("tools.export", ["-c", INF_YAML]
                                  + _overrides(base + [
                                      f"Inference.model_dir={d}",
                                      f"Inference.target={target}"]))
               for target, d in (("forward", fwd_dir),
                                 ("generation", gen_dir))}
    # while they run: the generation prompt (batch 1, prompt 128, 64 new
    # tokens) and the f32 export in this process
    tok = GPTTokenizer.from_pretrained(tok_dir)
    text = open(os.path.join(REPO, "README.md"), encoding="utf-8").read()
    gcfg = X.load_config(INF_YAML, base)
    width = int(gcfg["Inference"]["prompt_len"])
    new_tokens = int(gcfg["Generation"]["max_dec_len"])
    # a prompt of about three quarters of the exported width, left-padded
    prompt = tok.encode(text)[:width * 3 // 4]
    tokens, mask = G.left_pad([prompt], int(gcfg["Generation"][
        "pad_token_id"]), width=width)
    seed = np.array([0, int(gcfg["Global"]["seed"])], np.uint32)
    generation = {}
    # f32 greedy: an f32 export of the same target in this process, on the
    # checkpoint's first F32_EXPORT_LAYERS layers (a depth cut: tracing
    # time grows with the layers, and the f32 check is of the export
    # itself, which the bf16 programs above run at full depth)
    f32_dir = os.path.join(root, "exported_generation_f32")
    f32_cfg = X.load_config(INF_YAML, base + [
        "Model.dtype=float32", "Generation.decode_strategy=greedy_search",
        f"Model.num_layers={F32_EXPORT_LAYERS}"])
    module = GPTGenerationModule(f32_cfg)
    cut = _first_layers(params, F32_EXPORT_LAYERS)
    _, fns, example, meta = X.programs(f32_cfg, module, dev)
    t0 = time.perf_counter()
    export_model(fns, example, f32_dir, cut, meta=meta)
    f32_export_s = time.perf_counter() - t0
    del example
    eng = InferenceEngine(f32_dir, device=dev)
    ids, rec = _generate_timed(eng, [tokens, mask, seed], F32_EXPORT_LAYERS)
    want = G.generate_rows(module.model_cfg, cut, module.gen_cfg,
                           *G.to_tensors(tokens, mask, dev), False
                           ).cpu().numpy()
    check(np.array_equal(ids, want), "generation f32 greedy: exported vs "
                                     "eager")
    generation["greedy_f32"] = dict(rec, identical=True,
                                    export_s=f32_export_s,
                                    layers=F32_EXPORT_LAYERS)
    del eng
    torch.cuda.empty_cache()

    for target, proc in started.items():
        lines, _, _ = _cli_wait(proc)
        exports[target] = lines[-1]
        check(lines[-1]["target"] == target, f"export {lines[-1]}")
    generation["export"] = exports["generation"]
    # the entry points as processes on the bf16 generation export, while
    # this one checks the programs
    args = ["-c", INF_YAML] + _overrides(base + [
        f"Inference.model_dir={gen_dir}",
        f"Generation.tokenizer_dir={tok_dir}"])
    started = [_cli_start(m, args) for m in ("tools.inference",
                                             "tasks.gpt.inference")]

    # the forward program at [1, 1024] against the eager forward, both on
    # the checkpoint's params (the artifact's params.npz holds them)
    eng = InferenceEngine(fwd_dir, device=dev)
    want_params = flatten(params)
    got_params = flatten(eng.params)
    check(sorted(got_params) == sorted(want_params)
          and all(torch.equal(v, want_params[k])
                  for k, v in got_params.items()),
          "the exported params are not the checkpoint's")
    cfg = GPTGenerationModule(X.load_config(INF_YAML, base)).model_cfg
    seq, vocab = cfg.max_position_embeddings, cfg.vocab_size
    gen = torch.Generator(device="cpu")
    gen.manual_seed(11)
    fwd_tokens = torch.randint(0, vocab, (1, seq), generator=gen)
    pos = torch.arange(seq)[None]
    zero_counts()
    times = []
    for _ in range(FORWARD_CALLS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = eng.predict([fwd_tokens.numpy(), pos.numpy()])[0]
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counts = read_counts()

    # where predict's time goes: the program alone on device inputs, and
    # the eager forward it was exported from
    dev_in = (fwd_tokens.to(dev), pos.to(dev))
    with torch.no_grad():
        program_ms = p50_ms(lambda: eng.programs["model"](eng.params,
                                                          *dev_in))
        eager_ms = p50_ms(lambda: M.gpt_for_pretraining(params, cfg,
                                                        *dev_in))
    per_call = {k: counts[k] / len(times) for k in ("flash_attention_fwd",
                                                    "fused_norm_fwd")}
    check(per_call == {"flash_attention_fwd": CUT_LAYERS,
                       "fused_norm_fwd": 2 * CUT_LAYERS + 1},
          f"exported forward: launches per call {per_call}")
    with torch.no_grad():
        want = M.gpt_for_pretraining(params, cfg, fwd_tokens.to(dev),
                                     pos.to(dev)).float().cpu().numpy()
    fwd_diff = float(np.abs(logits - want).max())
    check(logits.shape == (1, seq, vocab) and np.isfinite(logits).all(),
          f"exported forward logits {logits.shape}")
    check(fwd_diff == 0.0, f"exported forward differs from the eager "
                           f"forward by {fwd_diff}")
    warm = sorted(times[1:])
    forward = dict(export=exports["forward"], load_s=eng.load_s,
                   first_call_ms=times[0] * 1e3,
                   warm_p50_ms=float(np.percentile(warm, 50)) * 1e3,
                   warm_p99_ms=float(np.percentile(warm, 99)) * 1e3,
                   program_p50_ms=program_ms, eager_p50_ms=eager_ms,
                   calls=len(times), launches=counts,
                   launches_per_call=per_call, max_abs_diff=fwd_diff,
                   bitwise=fwd_diff == 0.0)
    del eng, logits, want
    torch.cuda.empty_cache()

    # the bf16 generation programs against eager generation
    launches = 0
    eng = InferenceEngine(gen_dir, device=dev)
    sampling_cfg = eng.gen_cfg
    generation["load_s"] = eng.load_s
    dp_reference = _dp_reference(eng)      # phase 20c's, on this engine
    _generate_timed(eng, [tokens, mask, seed], CUT_LAYERS)  # first call
    for name, extra in (("greedy", ["Generation.decode_strategy="
                                    "greedy_search"]), ("sampling", [])):
        # the programs do not depend on the strategy: greedy is the
        # sampling export's engine with do_sample off
        eng.gen_cfg = dataclasses.replace(sampling_cfg,
                                          do_sample=name == "sampling")
        ids, rec = _generate_timed(eng, [tokens, mask, seed],
                                   CUT_LAYERS)
        launches += rec["fused_norm_fwd"]
        module = GPTGenerationModule(X.load_config(INF_YAML, base + extra))
        check(module.gen_cfg == eng.gen_cfg, f"{name}: generation configs "
                                             f"differ")
        g = torch.Generator(device=dev)
        g.manual_seed(int(seed[1]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = G.generate_rows(module.model_cfg, params, module.gen_cfg,
                               *G.to_tensors(tokens, mask, dev), False,
                               g).cpu().numpy()
        eager_s = time.perf_counter() - t0
        check(np.array_equal(ids, want), f"generation {name}: exported "
                                         f"{ids.tolist()} vs eager "
                                         f"{want.tolist()}")
        generation[name] = dict(rec, identical=True, eager_wall_s=eager_s,
                                eager_ms_per_model_call=eager_s * 1e3
                                / rec["calls"], ids=ids[0, :16].tolist())
    # one decode step alone on a prefilled cache: the exported program
    # (with the module's input checks) against the eager step
    tok_t, mask_t = G.to_tensors(tokens, mask, dev)
    with torch.no_grad():
        _, cache = G._prefill(cfg, params, tok_t, mask_t, new_tokens)
        last = tok_t[:, -1]
        step_pos = mask_t.sum(dim=1)
        index = torch.full((), width, dtype=torch.long, device=dev)
        decode = eng.programs["decode"]
        generation["decode_program_p50_ms"] = p50_ms(lambda: decode(
            eng.params, last, step_pos, cache.key, cache.value, cache.mask,
            index))
        generation["eager_step_p50_ms"] = p50_ms(lambda: G._step(
            cfg, params, last, step_pos, M.DecodeCache(
                cache.key, cache.value, width, cache.mask)))
    del eng, cache


    demo, _, _ = _cli_wait(started[0])
    _, task_out, _ = _cli_wait(started[1])
    check(demo[0]["shape"] == [1, new_tokens], f"tools.inference {demo}")
    task_lines = task_out.strip().splitlines()
    check(task_lines[-2].startswith("prompt: ")
          and task_lines[-1].startswith("continuation: "),
          f"tasks.gpt.inference printed {task_lines[-2:]}")
    out = dict(forward=forward, generation=generation,
               inference_demo=demo, task_output=task_lines[-2:],
               inference_generation_launches=launches, nvidia_smi=card)
    emit("export", **out)
    return dict(out, dp_reference=dp_reference)


def phase_row1_eval_shape(dev: torch.device, card: str,
                          rate01_ms: float) -> dict:
    """Row 1 at the eval path's shape ``[128, 1024, 64]`` bf16 causal with
    no dropout, held to its plain versions, timed (CUDA events with the L2
    flushed, profiler device time, and device time from CUDA-graph
    replays) beside SDPA's flash forward at the same shape and its bound;
    the same at rate 0.1 in this call, to tell what the dropout hash
    costs."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from fleetx_tpu_torch.ops import flash_attention as FA

    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    q, k, v, _ = _flash_case(torch.bfloat16, dev)
    scale = THD ** -0.5
    out, lse = FA.fwd_call(q, k, v, 0, scale, True, 0.0)
    err, drift = _hold_tc(out, FA.fwd_plain(q, k, v, 0, scale, True, 0.0,
                                            round_operands=True)[0],
                          FA.fwd_plain(q, k, v, 0, scale, True, 0.0)[0],
                          "flash fwd at rate 0 (tensor cores)")
    bh = TB * TNH
    pairs = TS * (TS + 1) // 2
    bound, bound_by = _bound(4 * bh * TS * THD * 2 + bh * TS * 4,
                             2 * 2 * pairs * THD * bh, torch.bfloat16)

    def four(t):
        return t.reshape(TB, TNH, TS, THD)

    result = dict(shape=[bh, TS, THD], dtype="bfloat16", causal=True,
                  max_abs_err=err, drift=drift, bound_ms=bound,
                  bound_by=bound_by, rate01_ms_phase1b=rate01_ms)
    for rate in (0.0, RATE):
        def kernel():
            return FA.fwd_call(q, k, v, 20240607, scale, True, rate)

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                four(q), four(k), four(v), dropout_p=rate, is_causal=True)

        with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
            lib_ms = time_ms(sdpa, flush)
            lib_dev = device_ms(sdpa, flush, "pytorch_flash::flash_fwd")
            lib_graph = graph_ms(sdpa)
        result[f"rate_{rate}"] = dict(
            ms=time_ms(kernel, flush), device_ms=device_ms(
                kernel, flush, "flash_fwd_kernel_tc"),
            graph_ms=graph_ms(kernel), library_ms=lib_ms,
            library_device_ms=lib_dev, library_graph_ms=lib_graph)
    del flush
    torch.cuda.empty_cache()
    emit("row1_eval_shape", **result, nvidia_smi=card)
    return result


# -------------------------------------------------------------- phase 12
#: the fp16 recipe: pure fp16 under the dynamic loss scaler
FP16 = ["Engine.mix_precision.use_pure_fp16=True", "Model.dtype=float16"]
FP16_STEPS = 20
#: the recipe's initial loss scale (pretrain_gpt_base.yaml ``scale_loss``)
FP16_SCALE = 32768.0
#: per batch of the fp16 path: phase 4's counts, and every norm launch on
#: the ``__half`` instantiation
FP16_PER_STEP = dict(PER_STEP, fused_norm_fwd_fp16=49, fused_norm_bwd_fp16=49)
#: steps of the kernels-on / kernels-off fp16 pair (dropout 0, the same
#: seeded weights and batches)
FP16_OFF_STEPS = 3
#: their losses' largest allowed difference: both paths round the
#: attention probabilities and a 24-layer fp16 residual stream, at other
#: points; one fp16 rounding (2**-11 relative) of an O(1) logit moves a
#: token's loss by ~5e-4, and the loss is the mean over 8192 tokens, whose
#: roundings mostly cancel (phase 10 finds the bf16 forward's kernels on
#: against off within 8.8e-6 relative, ~1e-4 of an 11.0 loss, on an H100
#: 80GB HBM3 at 700 W; fp16 has 3 more mantissa bits): 2e-3 leaves 20x
#: that
FP16_DRIFT = 2e-3
#: the fp16 range: a value past it rounds to inf
FP16_MAX = 65504.0
#: the overflow drill: an initial scale that overflows every scaled
#: backward, over one-shot batches; then a re-iterable run from a scale
#: that overflows the first ~25 backwards (8192 tokens: 2**40 / 8192 is
#: ~2**27 on a logit's cotangent) until it reaches max_steps
OVERFLOW_SCALE = 2.0 ** 125
OVERFLOW_BATCHES = 5
REITER_SCALE = 2.0 ** 40
REITER_STEPS = 3
#: the guard skip: the batch index poisoned with a NaN loss_mask
GUARD_NAN_AT = 3
GUARD_STEPS = 5
#: rollback then abort: save every 4 steps, batches 5-7 poisoned, a
#: streak of 3 rolls back once, the second streak aborts
ROLLBACK_OVERRIDES = ["Resilience.enable=True",
                      "Engine.save_load.save_steps=4",
                      "Resilience.faults.nan_loss_at=[5, 6, 7]",
                      "Resilience.guard.nonfinite_streak=3",
                      "Resilience.guard.nonfinite_action=rollback",
                      "Resilience.guard.max_rollbacks=1",
                      "Engine.max_steps=10"]
#: the preemption drill: SIGTERM before step 6 (a step-5 checkpoint), the
#: exit code, then a resumed process to step 10
PREEMPT_AT = CKPT_STEPS
PREEMPT_EXIT = 75
#: the guard's per-step cost: rounds of check-off / check-on step blocks
GUARD_COST_ROUNDS, GUARD_COST_STEPS = 3, 6
#: the rollback and preemption drills run the 345M recipe at full width
#: cut to its first DRILL_LAYERS layers (a depth cut, for the smoke's time
#: limit: their 4.26 GB saves and restores at 24 layers took ~20 and ~12 s
#: each; every checked property, the guard's decisions, the exit code, the
#: audit and the bitwise resume, does not depend on the depth)
DRILL_LAYERS = 4
DRILL_DEPTH = [f"Model.num_layers={DRILL_LAYERS}"]


def _trainer_345m(dev: torch.device, overrides: list,
                  layers: int = 24) -> tuple:
    """``(cfg, engine, train loader)`` of the 345M recipe at full width
    and depth (or ``layers``, which ``overrides`` then set) through
    ``build_trainer``, with ``overrides``."""
    from fleetx_tpu_torch.tools.train import build_trainer, load_config

    cfg = load_config(TRAIN_YAML, ["Engine.logging_freq=1"] + overrides)
    engine, dl, _ = build_trainer(cfg, device=dev)
    mc = engine.module.model_cfg
    check(mc.num_layers == layers and mc.hidden_size == 1024
          and mc.num_attention_heads == 16 and mc.vocab_size == 50304
          and cfg["Global"]["max_seq_len"] == 1024
          and cfg["Global"]["global_batch_size"] == 8,
          "not the full-width 345M training recipe")
    return cfg, engine, dl


def _counter(name: str) -> float:
    from fleetx_tpu_torch.observability.metrics import get_registry

    return get_registry().counter(name).value


def _engine_state(engine) -> list:
    """Device copies of the params and AdamW moments, and the counters."""
    from fleetx_tpu_torch.optims.optimizer import tree_leaves_with_path

    out = [p.detach().clone() for _, p in tree_leaves_with_path(engine.params)]
    out += [t.clone() for key in ("mu", "nu") for t in engine.opt_state[key]]
    return out + [engine.opt_state["count"], engine.step]


def _same_state(a: list, b: list) -> bool:
    return len(a) == len(b) and all(
        torch.equal(x, y) if torch.is_tensor(x) else x == y
        for x, y in zip(a, b))


def _capture_flash_args(engine, batch: dict) -> tuple:
    """One train step on ``batch`` recording copies of the arguments of
    its last flash forward and its first flash backward: layer 24's, whose
    dO carries the loss scale straight from the head."""
    from fleetx_tpu_torch.ops import flash_attention as FA

    fwd, bwd = FA.fwd_call, FA.bwd_call
    seen: dict = {}

    def copy(args):
        return tuple(a.clone() if torch.is_tensor(a) else a for a in args)

    def rec_fwd(*args):
        seen["fwd"] = copy(args)
        return fwd(*args)

    def rec_bwd(*args):
        seen.setdefault("bwd", copy(args))
        return bwd(*args)

    # the wrappers count through their module-level names: this step's
    # launches land on the recorders and are dropped with them
    for rec in (rec_fwd, rec_bwd):
        rec.launches = rec.tc_launches = 0
    FA.fwd_call, FA.bwd_call = rec_fwd, rec_bwd
    try:
        engine.train_step(batch)
    finally:
        FA.fwd_call, FA.bwd_call = fwd, bwd
    return seen["fwd"], seen["bwd"]


def _flash_at_scaled_cotangents(fwd_args: tuple, bwd_args: tuple) -> dict:
    """Rows 1 and 4 in fp16 on the inputs of the fp16 path's layer 24 at
    ``scale_loss`` 32768: held to both plain variants (``_hold_tc``); then
    dO pushed by a power of two to the top of the fp16 range, where the
    f32 reference leaves it: every output element the kernel leaves
    finite must agree with the reference, and an overflow must show as
    inf/NaN that the engine's finite check (the global grad norm) sees."""
    from fleetx_tpu_torch.ops import flash_attention as FA
    from fleetx_tpu_torch.optims.optimizer import global_norm

    q, k, v, seed, scale, causal, rate = fwd_args
    check(q.dtype == torch.float16 and FA.tc_route(q.dtype, q.shape[-1]),
          f"layer 24's flash forward took {q.dtype}, not the fp16 "
          f"tensor-core route")
    out, lse = FA.fwd_call(*fwd_args)
    fwd_err, fwd_drift = _hold_tc(
        out, FA.fwd_plain(*fwd_args, round_operands=True)[0],
        FA.fwd_plain(*fwd_args)[0], "fp16 flash fwd, layer 24 inputs")
    bq, bk, bv, do, blse, delta = bwd_args[:6]
    rest = bwd_args[6:]
    got = FA.bwd_call(*bwd_args)
    rounded = FA.bwd_plain(*bwd_args, round_operands=True)
    unrounded = FA.bwd_plain(*bwd_args)
    bwd = {}
    for name, g, r, u in zip(("dq", "dk", "dv"), got, rounded, unrounded):
        bwd[f"{name}_vs_rounded"], bwd[f"{name}_drift"] = _hold_tc(
            g, r, u, f"fp16 fused bwd {name}, scaled layer 24 dO")
    del rounded, unrounded
    do_max = float(do.float().abs().max())
    # the largest power of two that keeps dO finite in fp16 (the products
    # inside the kernel, dS among them, may leave the range there), then
    # twice that, where dO's largest elements are inf (what an fp16
    # backward hands the layer when the scale is too high)
    top = 2.0 ** math.floor(math.log2(FP16_MAX / do_max))
    pushed = {}
    for push in (top, 2 * top):
        do_f = (do.float() * push).to(torch.float16)
        ref = FA.bwd_plain(bq.float(), bk.float(), bv.float(), do_f.float(),
                           blse, delta * push, *rest)
        hot = FA.bwd_call(bq, bk, bv, do_f, blse, delta * push, *rest)
        torch.cuda.synchronize()
        report = dict(factor=push, do_max_abs=do_max * push,
                      do_overflowed=not bool(torch.isfinite(do_f).all()))
        nonfinite = 0
        for name, g, r in zip(("dq", "dk", "dv"), hot, ref):
            fin, ref_fin = torch.isfinite(g), torch.isfinite(r)
            ref_max = float(r[ref_fin].abs().max()) if bool(ref_fin.any()) \
                else 0.0
            # compared where both are finite: with an overflowed dO the
            # f32 reference also runs 0 x inf through the masked entries
            # the kernel skips
            bad = fin & ref_fin & ((g.float() - r).abs() > TC_DRIFT * ref_max)
            # an fp16 output past the fp16 range must be inf (dq is f32)
            past = (r.abs() > FP16_MAX) & (g.dtype == torch.float16)
            check(not bool(bad.any()) and not bool((fin & past).any()),
                  f"dO x{push}: {int(bad.sum())} finite {name} elements "
                  f"disagree with the f32 reference, "
                  f"{int((fin & past).sum())} finite where it is past the "
                  f"fp16 range (a silent wrong value)")
            report[name] = dict(nonfinite=int((~fin).sum()),
                                ref_nonfinite=int((~ref_fin).sum()),
                                ref_max=ref_max,
                                ref_past_fp16_max=int(past.sum()))
            nonfinite += int((~fin).sum())
        norm = global_norm([t.float() for t in hot])
        report["grad_norm_finite"] = bool(torch.isfinite(norm))
        check(report["grad_norm_finite"] == (nonfinite == 0),
              f"dO x{push}: {nonfinite} non-finite outputs, grad norm "
              f"{float(norm)}")
        pushed["finite_dO" if push == top else "overflowed_dO"] = report
        del ref, hot
    check(pushed["overflowed_dO"]["do_overflowed"]
          and not pushed["overflowed_dO"]["grad_norm_finite"],
          f"an overflowed dO left the grad norm finite: {pushed}")
    torch.cuda.empty_cache()
    # how the scale places dO in the fp16 range: zeros, and values under
    # its smallest normal number (2**-14), which keep fewer bits
    mag = do.float().abs()
    return dict(shape=list(q.shape), fwd_vs_rounded=fwd_err,
                fwd_drift=fwd_drift, **bwd, do_max_abs=do_max,
                do_zero_share=float((mag == 0).float().mean()),
                do_subnormal_share=float(((mag > 0) & (mag < 2.0 ** -14))
                                         .float().mean()),
                lse_max_err=float((lse - blse).abs().max()),
                pushed=pushed)


def _fp16_train(dev: torch.device, card: str, root: str) -> dict:
    """The fp16 path: ``FP16_STEPS`` steps of the 345M recipe at
    ``scale_loss`` 32768 with the step watchdog on; launch counts zeroed
    just before and read just after. Then layer 24's flash call on a
    further batch held to its plain versions at the real scaled dO."""
    from fleetx_tpu_torch.utils.hardware import peak_flops

    cfg, engine, dl = _trainer_345m(dev, FP16 + [
        f"Engine.max_steps={FP16_STEPS}",
        f"Engine.mix_precision.scale_loss={FP16_SCALE}",
        "Resilience.enable=True", "Resilience.watchdog.enable=True",
        f"Engine.save_load.output_dir={os.path.join(root, 'fp16')}"])
    mc = engine.module.model_cfg
    check(mc.dtype == torch.float16 and engine.scaler is not None
          and engine.check_finite and mc.use_flash_attention
          and mc.fused_residual_norm and mc.hidden_dropout_prob == 0.1,
          "not the fp16 recipe under the loss scaler")
    stalls = _counter("watchdog_stalls")
    reset_peak(dev)
    zero_counts()                   # every count to 0 just before
    losses = engine.fit(dl)
    torch.cuda.synchronize()
    counts = read_counts()          # read just after
    hist = engine.history
    batches = len(hist)
    check(engine.step == FP16_STEPS, f"fp16 run ended at step {engine.step}")
    for name, per_step in FP16_PER_STEP.items():
        check(counts[name] == per_step * batches,
              f"fp16: {name} {counts[name]} launches, want {per_step} x "
              f"{batches} batches")
    check(all(np.isfinite(losses)), f"non-finite fp16 loss: {losses}")
    expect = float(np.log(mc.vocab_size)
                   + mc.hidden_size * mc.initializer_range ** 2 / 2)
    check(abs(losses[0] - expect) < 0.1,
          f"first fp16 loss {losses[0]} is not within 0.1 of {expect}")
    watchdog_stalls = _counter("watchdog_stalls") - stalls
    check(watchdog_stalls == 0, f"{watchdog_stalls} watchdog stalls")
    step_s = statistics.median(h["train_cost"] for h in hist[1:])
    tokens = cfg["Global"]["global_batch_size"] * cfg["Global"]["max_seq_len"]
    fpt = engine.module.flops_per_token()
    peak = peak_flops(torch.cuda.get_device_name(dev)) or PEAK_BF16_FLOPS
    out = dict(
        steps=FP16_STEPS, batches=batches, skipped_steps=batches - FP16_STEPS,
        losses=losses, loss_scale=[h["loss_scale"] for h in hist],
        grad_norms=[h["grad_norm"] for h in hist],
        first_loss=losses[0], expected_first_loss=expect,
        step_ms_median=step_s * 1e3,
        step_ms=[h["train_cost"] * 1e3 for h in hist],
        tokens_per_s=tokens / step_s, mfu=fpt * tokens / step_s / peak,
        peak_flops=peak,
        max_memory_allocated_gb=torch.cuda.max_memory_allocated(dev)
        / 2 ** 30, watchdog_stalls=watchdog_stalls, launches=counts,
        launches_per_batch={k: counts[k] / batches for k in FP16_PER_STEP})
    batch = engine.to_device(next(iter(dl)))
    fwd_args, bwd_args = _capture_flash_args(engine, batch)
    del engine, batch
    torch.cuda.empty_cache()
    out["scaled_cotangents"] = _flash_at_scaled_cotangents(fwd_args, bwd_args)
    del fwd_args, bwd_args
    torch.cuda.empty_cache()
    emit("fp16_train", **out, nvidia_smi=card)
    return out


def _fp16_kernels_off(dev: torch.device, card: str, root: str) -> dict:
    """``FP16_OFF_STEPS`` fp16 steps with the kernels on and then off
    (dropout 0: the flash kernels' hash masks are not the plain path's
    generator masks), on the same seeded weights and batches."""
    runs = {}
    for on in (True, False):
        _, engine, dl = _trainer_345m(dev, FP16 + [
            f"Engine.max_steps={FP16_OFF_STEPS}",
            "Model.hidden_dropout_prob=0.0",
            "Model.attention_probs_dropout_prob=0.0",
            f"Model.use_flash_attention={on}",
            f"Model.fused_residual_norm={on}",
            f"Engine.save_load.output_dir={os.path.join(root, 'off')}"])
        runs[on] = engine.fit(dl)
        del engine
        torch.cuda.empty_cache()
    diffs = [abs(a - b) for a, b in zip(runs[True], runs[False])]
    check(len(diffs) == FP16_OFF_STEPS and max(diffs) <= FP16_DRIFT,
          f"fp16 kernels on {runs[True]} vs off {runs[False]}")
    out = dict(steps=FP16_OFF_STEPS, losses_on=runs[True],
               losses_off=runs[False], max_abs_diff=max(diffs),
               bound=FP16_DRIFT)
    emit("fp16_kernels_vs_plain", **out, nvidia_smi=card)
    return out


def _overflow_drill(dev: torch.device, card: str, root: str) -> dict:
    """``scale_loss`` 2**125 over ``OVERFLOW_BATCHES`` one-shot batches:
    the step stays 0, the scale ends at 2**120, the params and moments
    are bit for bit the initial ones. Then a re-iterable run from
    ``REITER_SCALE`` reaches ``REITER_STEPS`` optimizer steps."""
    cfg, engine, _ = _trainer_345m(dev, FP16 + [
        f"Engine.max_steps={OVERFLOW_BATCHES}",
        f"Engine.mix_precision.scale_loss={OVERFLOW_SCALE}",
        f"Engine.save_load.output_dir={os.path.join(root, 'overflow')}"])
    batches = _host_batches(cfg, OVERFLOW_BATCHES)
    engine.prepare()
    before = _engine_state(engine)
    engine.fit(iter(batches))
    final_scale = float(engine.scaler["loss_scale"])
    check(engine.step == 0 and len(engine.history) == OVERFLOW_BATCHES,
          f"overflow drill: step {engine.step} after "
          f"{len(engine.history)} batches")
    check(final_scale == OVERFLOW_SCALE / 2 ** OVERFLOW_BATCHES,
          f"overflow drill: scale {final_scale}")
    check(_same_state(before, _engine_state(engine)),
          "overflow drill: the params or moments moved")
    del engine, before
    torch.cuda.empty_cache()
    _, engine, _ = _trainer_345m(dev, FP16 + [
        f"Engine.max_steps={REITER_STEPS}",
        f"Engine.mix_precision.scale_loss={REITER_SCALE}",
        f"Engine.save_load.output_dir={os.path.join(root, 'overflow')}"])
    engine.fit(batches)
    reiter = dict(steps=engine.step, batches=len(engine.history),
                  initial_scale=REITER_SCALE,
                  final_scale=float(engine.scaler["loss_scale"]),
                  losses=[h["loss"] for h in engine.history])
    check(engine.step == REITER_STEPS
          and reiter["final_scale"] < REITER_SCALE,
          f"re-iterable run: {reiter}")
    del engine
    torch.cuda.empty_cache()
    out = dict(initial_scale=OVERFLOW_SCALE, batches=OVERFLOW_BATCHES,
               final_step=0, final_scale=final_scale, state_bitwise=True,
               reiterable=reiter)
    emit("fp16_overflow_drill", **out, nvidia_smi=card)
    return out


def _guard_skip_and_cost(dev: torch.device, card: str, root: str) -> dict:
    """bf16, ``Resilience.enable``, ``nan_loss_at: [3]``: the poisoned
    batch leaves the params, moments and counters bit for bit as they
    were, ``nonfinite_skips`` counts 1, training reaches ``GUARD_STEPS``.
    Then the guard's per-step check timed on the same engine: blocks of
    ``GUARD_COST_STEPS`` steps with the check off and on, alternating."""
    _, engine, dl = _trainer_345m(dev, [
        f"Engine.max_steps={GUARD_STEPS}", "Resilience.enable=True",
        f"Resilience.faults.nan_loss_at=[{GUARD_NAN_AT}]",
        f"Engine.save_load.output_dir={os.path.join(root, 'guard')}"])
    check(engine.module.model_cfg.dtype == torch.bfloat16
          and engine.scaler is None and engine.check_finite,
          "the guard drill is not the bf16 recipe with the guard's check")
    around = []
    train_step = engine.train_step

    def spy(batch):
        poisoned = bool(torch.isnan(batch["loss_mask"]).any())
        pre = _engine_state(engine) if poisoned else None
        metrics = train_step(batch)
        if poisoned:
            around.append((_same_state(pre, _engine_state(engine)),
                           metrics["finite"], pre[-1]))
        return metrics

    engine.train_step = spy
    skips = _counter("nonfinite_skips")
    losses = engine.fit(dl)
    _unpatch(engine, "train_step")
    skipped = _counter("nonfinite_skips") - skips
    check(len(around) == 1 and around[0][0] and around[0][1] is False,
          f"guard skip: {around}")
    check(skipped == 1 and engine.step == GUARD_STEPS
          and len(losses) == GUARD_STEPS + 1
          and np.isnan(losses[GUARD_NAN_AT]),
          f"guard skip: {skipped} skips, step {engine.step}, {losses}")
    steps = [h["global_step"] for h in engine.history]

    # the check's cost: the same engine going on through fit (its loader,
    # its per-window loss sync), blocks of steps with the check off and
    # on, alternating; a block's first step carries fit's own start
    times = {False: [], True: []}
    for _ in range(GUARD_COST_ROUNDS):
        for check_on in (False, True, True, False):
            engine.check_finite = check_on
            engine.max_steps = engine.step + GUARD_COST_STEPS
            first = len(engine.history)
            engine.fit(dl)
            times[check_on] += [h["train_cost"] * 1e3
                                for h in engine.history[first + 1:]]
    engine.check_finite = True
    off, on = statistics.median(times[False]), statistics.median(times[True])
    del engine
    torch.cuda.empty_cache()
    out = dict(nan_at=GUARD_NAN_AT, state_bitwise=True,
               nonfinite_skips=skipped,
               steps_logged=steps, losses=losses,
               cost=dict(step_ms_check_off=off, step_ms_check_on=on,
                         ms_per_step=on - off,
                         step_ms={"check_off": times[False],
                                  "check_on": times[True]},
                         steps_per_block=GUARD_COST_STEPS))
    emit("guard_skip", **out, nvidia_smi=card)
    return out


def _rollback_drill(dev: torch.device, card: str, root: str) -> dict:
    """bf16 at ``DRILL_LAYERS`` layers, ``ROLLBACK_OVERRIDES``: the first
    streak restores step 4 (``rollbacks_total`` 1, the restore timed), the
    second raises ``TrainingAborted``."""
    from fleetx_tpu_torch.resilience import TrainingAborted

    out_dir = os.path.join(root, "rollback")
    _, engine, dl = _trainer_345m(dev, ROLLBACK_OVERRIDES + DRILL_DEPTH + [
        f"Engine.save_load.output_dir={out_dir}"], layers=DRILL_LAYERS)
    save_s, load_s, decisions = [], [], []
    _timed(engine, "save", save_s)
    _timed(engine, "load", load_s)
    observe = engine.resilience.guard.observe

    def recording(step, loss, finite=None):
        decision = observe(step, loss, finite=finite)
        decisions.append([int(step), decision])
        return decision

    engine.resilience.guard.observe = recording
    rollbacks = _counter("rollbacks_total")
    aborted = None
    try:
        engine.fit(dl)
    except TrainingAborted as e:
        aborted = str(e)
    rolled = _counter("rollbacks_total") - rollbacks
    check(aborted is not None, "the second streak did not abort")
    check(rolled == 1 and len(load_s) == 1 and len(save_s) == 1,
          f"rollbacks {rolled}, loads {load_s}, saves {save_s}")
    # steps 1-4, the save at 4, step 5, three poisoned windows at 5; the
    # restore of 4, step 5 again, the same three: the budget is spent
    want = [[s, None] for s in (1, 2, 3, 4, 5, 5, 5)] + [[5, "rollback"]] + \
        [[5, None]] * 3 + [[5, "abort"]]
    check(decisions == want, f"guard decisions {decisions}")
    step = engine.step
    _unpatch(engine, "save", "load")
    _unpatch(engine.resilience.guard, "observe")
    del engine
    torch.cuda.empty_cache()
    out = dict(restored_step=4, rollbacks_total=rolled, decisions=decisions,
               aborted=aborted, final_step=step, save_s=save_s[0],
               restore_s=load_s[0], layers=DRILL_LAYERS)
    emit("rollback_drill", **out, nvidia_smi=card)
    return out


def _logged_losses(stderr: str) -> dict:
    """``{step: loss}`` from the training CLI's ``[train]`` lines."""
    out = {}
    for line in stderr.splitlines():
        m = re.search(r"\[train\] global step (\d+),.* loss: ([0-9.eE+-]+)",
                      line)
        if m:
            out[int(m.group(1))] = float(m.group(2))
    return out


def _preempt_args(root: str) -> list:
    """The preemption drill's ``tools.train`` arguments."""
    return ["-c", TRAIN_YAML] + _overrides(_preempt_recipe() + [
        "Engine.logging_freq=1",
        f"Engine.save_load.output_dir={os.path.join(root, 'preempt')}"])


def _preempt_recipe() -> list:
    return DRILL_DEPTH + [
        f"Engine.max_steps={TRAIN_STEPS}", "Resilience.enable=True",
        f"Resilience.preemption.exit_code={PREEMPT_EXIT}"]


def _preempt_start(root: str, fault: bool) -> tuple:
    """One run of the preemption drill's CLI (``fault``: with
    ``sigterm_at: PREEMPT_AT``) as a process; ``(started, start time)``."""
    cmd = _preempt_args(root) + (_overrides([
        f"Resilience.faults.sigterm_at={PREEMPT_AT}"]) if fault else [])
    return _cli_start("tools.train", cmd), time.perf_counter()


def _preempt_wait(started: tuple, want: int) -> tuple:
    """``(its stderr, its wall)``; an exit code other than ``want``
    raises."""
    _, _, err = _cli_wait(started[0], timeout=900, want=want)
    return err, time.perf_counter() - started[1]


def _preempt_resume(root: str, preempted: tuple) -> tuple:
    """Wait for the preempted run (exit ``PREEMPT_EXIT``, a verified
    step-``PREEMPT_AT`` checkpoint) and start the resumed one; ``(the
    preempted run, the resumed process)``."""
    from fleetx_tpu_torch.core import checkpoint as C
    from fleetx_tpu_torch.tools import verify_ckpt

    out_dir = os.path.join(root, "preempt")
    run = _preempt_wait(preempted, PREEMPT_EXIT)
    check(C.completed_steps(out_dir) == [PREEMPT_AT],
          f"steps saved: {C.completed_steps(out_dir)}")
    audit = verify_ckpt.audit_directory(out_dir)
    check([s["status"] for s in audit["steps"]] == ["ok"],
          f"audit of the preemption checkpoint: {audit}")
    return run, _preempt_start(root, fault=False)


def _preempt_reference(dev: torch.device, root: str) -> list:
    """The preemption drill's recipe uninterrupted, in this process."""
    _, engine, dl = _trainer_345m(dev, _preempt_recipe() + [
        "Engine.save_load.output_dir="
        f"{os.path.join(root, 'preempt_reference')}"], layers=DRILL_LAYERS)
    uninterrupted = engine.fit(dl)
    del engine, dl
    torch.cuda.empty_cache()
    return uninterrupted


def _preemption_drill(card: str, first: tuple, resumed: tuple,
                      uninterrupted: list) -> dict:
    """``python -m fleetx_tpu_torch.tools.train`` at ``DRILL_LAYERS``
    layers with ``sigterm_at: PREEMPT_AT``: it exits with ``PREEMPT_EXIT``
    leaving a verified step-5 checkpoint (``_preempt_resume``); the same
    command without the fault auto-resumes and trains to step 10, with
    the losses of the same recipe's uninterrupted run in this process
    bit for bit (as f32: the log prints 9 decimals)."""
    runs = [first, _preempt_wait(resumed, 0)]
    first, second = (_logged_losses(err) for err, _ in runs)
    want = {s + 1: x for s, x in enumerate(uninterrupted[:TRAIN_STEPS])}
    check(sorted(first) == list(range(1, PREEMPT_AT + 1))
          and sorted(second) == list(range(PREEMPT_AT + 1, TRAIN_STEPS + 1)),
          f"logged steps {sorted(first)} then {sorted(second)}")
    same = all(np.float32(x) == np.float32(want[s])
               for s, x in {**first, **second}.items())
    check(same, f"preempted + resumed losses {first} {second} vs the "
                f"uninterrupted run's {want}")
    saved = re.search(r"preemption: saved step \d+ in ([0-9.]+) s",
                      runs[0][0])
    check(saved is not None and "auto-resume: restoring step "
          f"{PREEMPT_AT}" in runs[1][0], "preemption log lines")
    out = dict(sigterm_at=PREEMPT_AT, exit_code=PREEMPT_EXIT,
               checkpoint_steps=[PREEMPT_AT], audit="ok",
               losses_before=[first[s] for s in sorted(first)],
               losses_resumed=[second[s] for s in sorted(second)],
               bitwise_uninterrupted=same,
               save_on_exit_s=float(saved.group(1)),
               process_s=[t for _, t in runs], layers=DRILL_LAYERS)
    emit("preemption_drill", **out, nvidia_smi=card)
    return out


def phase_fp16_resilience(dev: torch.device, card: str) -> dict:
    """Phase 12: fp16 training under the loss scaler and the resilience
    drills, at 345M full width and depth (the rollback and preemption
    drills at ``DRILL_LAYERS`` layers). Each part prints one JSON line."""
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_fp16_")
    try:
        free = shutil.disk_usage(root).free
        check(free >= CKPT_MIN_FREE_BYTES,
              f"{root} has {free / 1e9:.1f} GB free; the 345M checkpoints "
              f"need {CKPT_MIN_FREE_BYTES / 1e9:.0f} GB")
        # the preemption drill's two processes run while this one trains
        # (the smoke's time limit: each process start is ~20 s): the
        # SIGTERM'd run from the start, the resumed one beside the
        # rollback drill
        preempted = _preempt_start(root, fault=True)
        try:
            result = dict(
                fp16_train=_fp16_train(dev, card, root),
                fp16_kernels_off=_fp16_kernels_off(dev, card, root),
                overflow=_overflow_drill(dev, card, root),
                guard=_guard_skip_and_cost(dev, card, root))
            uninterrupted = _preempt_reference(dev, root)
            first, resumed = _preempt_resume(root, preempted)
            preempted = resumed
            result["rollback"] = _rollback_drill(dev, card, root)
            result["preemption"] = _preemption_drill(card, first, resumed,
                                                     uninterrupted)
        finally:
            proc = preempted[0][1]
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    result["seconds"] = time.perf_counter() - t0
    emit("fp16_resilience", seconds=result["seconds"], nvidia_smi=card)
    return result


# -------------------------------------------------------------- phase 13
FT_YAML = os.path.join(REPO, "fleetx_tpu", "configs", "nlp", "gpt",
                       "finetune_gpt_345M_lora.yaml")
FT_STEPS = 20
#: the recipe's schedule warms up over 1 % of 360,000 steps (an LR under
#: 3e-7 for the first 20): the smoke holds it at 1e-3 from step 0
FT_LR = ["Optimizer.lr.max_lr=1e-3", "Optimizer.lr.min_lr=1e-3",
         "Optimizer.lr.warmup_rate=0.0"]
#: the adapter parameters of GPT-345M at rank 8, a layer: qkv (1024·8 +
#: 8·3072), out (1024·8 + 8·1024), wi (1024·8 + 8·4096), wo (4096·8 +
#: 8·1024); CUT_LAYERS layers (phase 8's checkpoint cut)
FT_ADAPTER_PARAMS = CUT_LAYERS * (
    (1024 * 8 + 8 * 3072) + (1024 * 8 + 8 * 1024)
    + (1024 * 8 + 8 * 4096) + (4096 * 8 + 8 * 1024))
#: requests of phase 13's ``tools.serve --bench`` process
SERVE_CLI_REQUESTS = 8
#: the JAX test's bound on the quantized decode's first-chunk logits,
#: relative to the largest logit (tests/test_zz_finetune.py)
QUANT_DRIFT = 0.05


def _digest_pairs(digests: dict) -> dict:
    return {k: (int(v["crc32"]), int(v["nbytes"]))
            for k, v in digests.items()}


def _finetune_overrides(root: str, ckpt_dir: str, tok_dir: str,
                        prefix: str) -> list:
    """Phase 13a's overrides of the LoRA recipe."""
    from fleetx_tpu_torch.data.tokenizers.gpt_tokenizer import GPTTokenizer

    tok = GPTTokenizer.from_pretrained(tok_dir)
    ad_dir = os.path.join(root, "finetune", "adapter")
    return [f"FineTune.base_ckpt={ckpt_dir}",
            f"FineTune.adapter_dir={ad_dir}",
            f"Engine.max_steps={FT_STEPS}", "Engine.logging_freq=1",
            f"Engine.save_load.save_steps={FT_STEPS}",
            "Engine.save_load.output_dir="
            f"{os.path.join(root, 'finetune', 'state')}",
            f"Data.Train.dataset.input_dir={prefix}",
            f"Data.Train.dataset.num_samples={FT_STEPS * 8}",
            f"Data.Train.dataset.eos_id={tok.eos_token_id}"] + FT_LR \
        + CUT_DEPTH


def _finetune_start(root: str, ckpt_dir: str, tok_dir: str,
                    prefix: str) -> tuple:
    """Phase 13a's ``tools.finetune`` process, started; ``(started, start
    time)``."""
    return (_cli_start("tools.finetune", ["-c", FT_YAML] + _overrides(
        _finetune_overrides(root, ckpt_dir, tok_dir, prefix))),
        time.perf_counter())


def phase_finetune(dev: torch.device, card: str, root: str, ckpt_dir: str,
                   tok_dir: str, prefix: str, trainer: dict,
                   started: Optional[tuple] = None) -> dict:
    """Phase 13a: ``python -m fleetx_tpu_torch.tools.finetune`` on
    ``finetune_gpt_345M_lora.yaml`` from phase 8's checkpoint cut to
    ``CUT_LAYERS`` layers (``ckpt_dir``) on phase 10's corpus, as its own
    process (``started`` by ``_finetune_start`` beside phase 11 in the
    whole run); its launch counts, loss, frozen base, moved adapters,
    trainable fraction and artifact."""
    from fleetx_tpu_torch.core import checkpoint as C
    from fleetx_tpu_torch.finetune import checkpoint as FT
    from fleetx_tpu_torch.finetune import lora
    from fleetx_tpu_torch.tools import verify_ckpt
    from fleetx_tpu_torch.tools.train import load_config

    ad_dir = os.path.join(root, "finetune", "adapter")
    state_dir = os.path.join(root, "finetune", "state")
    if started is None:
        started = _finetune_start(root, ckpt_dir, tok_dir, prefix)
    cfg = load_config(FT_YAML, _finetune_overrides(root, ckpt_dir, tok_dir,
                                                   prefix))
    mc, ft = cfg["Model"], cfg["FineTune"]
    check(mc["module"] == "LoRAGPTModule" and mc["num_layers"] == CUT_LAYERS
          and mc["hidden_size"] == 1024 and mc["num_attention_heads"] == 16
          and mc["dtype"] == "bfloat16" and ft["lora"]["rank"] == 8
          and float(ft["lora"]["alpha"]) == 16.0
          and cfg["Global"]["global_batch_size"] == 8,
          "not the full-width 345M LoRA recipe")
    lines, _, _ = _cli_wait(started[0])
    process_s = time.perf_counter() - started[1]
    rec = lines[-1]
    check(rec["device"].startswith("cuda") and rec["steps"] == FT_STEPS,
          f"finetune ran {rec['steps']} steps on {rec['device']}")
    for name, per_step in _per_step(CUT_LAYERS).items():
        check(rec["launches"][name] == per_step * FT_STEPS,
              f"finetune: {name} {rec['launches'][name]} launches, want "
              f"{per_step} x {FT_STEPS}")
    check(rec["launches"][ROWS_COUNT] == rec["launches"]["fused_norm_fwd"],
          f"finetune: norm forward launches off route \"rows\": "
          f"{rec['launches']}")
    losses, norms = rec["losses"], rec["grad_norms"]
    check(len(losses) == FT_STEPS and all(np.isfinite(losses))
          and all(np.isfinite(norms)), f"losses {losses}, norms {norms}")
    check(float(np.mean(losses[-5:])) < losses[0],
          f"the last 5 losses {losses[-5:]} are not below the first "
          f"{losses[0]}")
    check(rec["trainable_params"] == FT_ADAPTER_PARAMS
          and rec["trainable_params_frac"] == FT_ADAPTER_PARAMS
          / rec["total_params"], f"trainable {rec['trainable_params']} of "
                                 f"{rec['total_params']}")
    check(len(rec["adapters_moved"]) == 8
          and min(rec["adapters_moved"].values()) > 0,
          f"adapters moved {rec['adapters_moved']}")
    check(rec["adapter_path"] == os.path.join(ad_dir, f"step_{FT_STEPS}"),
          f"artifact at {rec['adapter_path']}")
    audits = {d: [s["status"] for s in verify_ckpt.audit_directory(d)[
        "steps"]] for d in (ad_dir, state_dir)}
    check(all(v == ["ok"] for v in audits.values()), f"audits {audits}")
    # the frozen base: the digests the run stamped after its fit, and the
    # base leaves of its saved step-20 state, are those of phase 8's
    # checkpoint, computed here; the artifact holds the state's adapters
    base = lora.base_leaf_digests(C.load_params(ckpt_dir))
    adapters, meta = FT.load_adapter(ad_dir)
    state = C.load_params(state_dir)
    check(_digest_pairs(meta["base_leaves"]) == _digest_pairs(base),
          "the stamped base digests differ from the checkpoint's")
    check(_digest_pairs(lora.base_leaf_digests(state))
          == _digest_pairs(base), "the fine-tuned state's base leaves "
                                  "differ from the checkpoint's")
    flat = C.flatten(state)
    check(sorted(adapters) == sorted(n for n in flat
                                     if lora.is_adapter_name(n))
          and all(torch.equal(v, flat[k]) for k, v in adapters.items()),
          "the artifact's adapters are not the saved state's")
    del state, flat, adapters
    out = dict(steps=FT_STEPS, losses=losses, grad_norms=norms,
               first_loss=losses[0],
               last5_mean_loss=float(np.mean(losses[-5:])),
               trainable_params=rec["trainable_params"],
               total_params=rec["total_params"],
               trainable_params_frac=rec["trainable_params_frac"],
               adapter_bytes=rec["adapter_bytes"],
               adapter_mb=rec["adapter_bytes"] / 1e6,
               adapters_moved=rec["adapters_moved"], audits=audits,
               base_frozen=True, base_leaves=len(base),
               step_ms=rec["step_ms"], step_ms_median=rec["step_ms_median"],
               phase4_step_ms_median=trainer["step_ms_median"],
               step_ratio_to_phase4=rec["step_ms_median"]
               / trainer["step_ms_median"],
               tokens_per_s=rec["tokens_per_s"],
               peak_memory_gb=rec.get("peak_memory_gb"),
               launches=rec["launches"],
               launches_per_step={k: rec["launches"][k] / FT_STEPS
                                  for k in PER_STEP}, layers=CUT_LAYERS,
               process_s=process_s, lora_alpha=float(meta["lora"]["alpha"]),
               adapter_dir=ad_dir, state_dir=state_dir, nvidia_smi=card)
    emit("finetune", **{k: v for k, v in out.items()
                        if k not in ("adapter_dir", "state_dir")})
    return out


def _first_chunk_logits(engine, prompt: list) -> np.ndarray:
    """The prefill step's f32 logits after the first chunk of ``prompt``
    on a drained engine (pages 1.. of a fresh table): the JAX test's drift
    probe."""
    chunk = engine.serving.prefill_chunk
    n = min(len(prompt), chunk)
    table = np.zeros((1, engine.pages_per_req), np.int32)
    pages = -(-n // engine.serving.page_size)
    table[0, :pages] = np.arange(1, pages + 1)
    tokens = np.zeros((1, chunk), np.int32)
    tokens[0, :n] = prompt[:n]
    out = engine._fns["prefill"](engine.params, engine.pool_k,
                                 engine.pool_v, tokens, table, np.int32(0),
                                 np.int32(n), None)
    return out[3].float().cpu().numpy()[0]


def _replica_tokens(engine, prompts: list, max_new: int) -> list:
    reqs = [engine.submit(p, max_new, request_id=f"f{i}")
            for i, p in enumerate(prompts)]
    engine.run_until_drained()
    check(all(r.state == "finished" and r.error is None for r in reqs),
          "a replica request did not finish")
    return [list(r.tokens) for r in reqs]


def phase_quant_serving(dev: torch.device, card: str, ckpt_dir: str,
                        ft: dict, tok_dir: str, main_path: dict) -> dict:
    """Phase 13b: the fine-tune recipe's replica (phase 8's checkpoint cut
    to ``CUT_LAYERS`` layers, with 13a's adapters merged, int8 fake-quant
    decode) over TCP beside phase 2; in f32 the quantization drift and the
    merged replica against generation from the fine-tuned state folded in
    memory."""
    from fleetx_tpu_torch.core import checkpoint as C
    from fleetx_tpu_torch.core.module import GPTGenerationModule
    from fleetx_tpu_torch.data.tokenizers.gpt_tokenizer import GPTTokenizer
    from fleetx_tpu_torch.finetune import lora
    from fleetx_tpu_torch.tasks.gpt import generation as task
    from fleetx_tpu_torch.tools.serve import build_engine
    from fleetx_tpu_torch.tools.serve import load_config as serve_config

    base = [f"Serving.ckpt_dir={ckpt_dir}",
            f"Serving.adapter_dir={ft['adapter_dir']}"] + CUT_DEPTH
    t0 = time.perf_counter()
    engine = build_engine(serve_config(FT_YAML, base), device=dev)
    build_s = time.perf_counter() - t0
    mc, sc = engine.cfg, engine.serving
    check(mc.num_layers == CUT_LAYERS and mc.hidden_size == 1024
          and mc.num_attention_heads == 16 and mc.dtype == torch.bfloat16
          and engine.serving.quantize_decode and engine.paged_kernel_active
          and sc.max_batch == 16 and sc.num_pages == 513,
          "not the recipe's full-width quantized replica")
    # the same merged weights unquantized, served in turns with the
    # quantized replica (q, fp, fp, q): the decode step is host-bound, and
    # the host's speed drifts over a call (phase 2 runs minutes earlier)
    engines = {True: engine, False: build_engine(serve_config(
        FT_YAML, base + ["Serving.quantize_decode=False"]), device=dev)}
    prompts = _prompts(2, SERVE_PROMPT_LENS)
    raw = {True: [], False: []}
    for quant in (True, False, False, True):
        raw[quant].append(_serve_tcp(engines[quant], prompts, SERVE_MAX_NEW))
    records = {quant: [_serving_record(run, prompts, SERVE_MAX_NEW,
                                       mc.num_layers) for run in runs]
               for quant, runs in raw.items()}
    first, served = raw[True][0], records[True][0]
    del engine, engines
    torch.cuda.empty_cache()
    # the recipe's replica through the real CLI (``tools.serve --bench``
    # on the same yaml), its own process while this one runs the f32
    # checks: it must run end to end; its numbers are not read as timings
    serve_cli = _cli_start("tools.serve", [
        "-c", FT_YAML, "--bench", "--requests", str(SERVE_CLI_REQUESTS),
        "--rate", "16"] + _overrides(base))

    # f32: quantize on against off on the same merged weights, and the
    # merged replica against the fine-tuned state's in-memory fold
    tok = GPTTokenizer.from_pretrained(tok_dir)
    ids = tok.encode(open(os.path.join(REPO, "README.md"),
                          encoding="utf-8").read())
    cross = [ids[o:o + n] for o, n in zip(np.cumsum(
        (0,) + CROSS_PROMPT_LENS), CROSS_PROMPT_LENS)]
    f32 = {}
    for quant in (True, False):
        replica = build_engine(serve_config(FT_YAML, base + [
            "Model.dtype=float32", f"Serving.quantize_decode={quant}"]),
            device=dev)
        check(replica.serving.quantize_decode == quant
              and replica.paged_kernel_active, "f32 replica")
        f32[quant] = dict(tokens=_replica_tokens(replica, cross, CROSS_NEW),
                          logits=_first_chunk_logits(replica, cross[0]))
        eos = replica.eos_token_id
        del replica
        torch.cuda.empty_cache()
    on, off = f32[True], f32[False]
    drift = float(np.abs(on["logits"] - off["logits"]).max()
                  / np.abs(off["logits"]).max())
    pairs = [(a, b) for ta, tb in zip(on["tokens"], off["tokens"])
             for a, b in zip(ta, tb)]
    agree = sum(a == b for a, b in pairs)
    check(drift < QUANT_DRIFT, f"int8 decode drift {drift} >= "
                               f"{QUANT_DRIFT}")
    check(agree >= len(pairs) // 2, f"{agree} of {len(pairs)} quantized "
                                    f"greedy tokens agree")

    module = GPTGenerationModule(task.load_config(GEN_YAML, [
        "Generation.decode_strategy=greedy_search", "Model.dtype=float32",
        f"Generation.max_dec_len={CROSS_NEW}"] + CUT_DEPTH))
    check(module.gen_cfg.eos_token_id == eos, "eos ids differ")
    folded = lora.merge_adapters(C.load_params(ft["state_dir"],
                                               device=dev),
                                 ft["lora_alpha"])
    rows = module.generate_ids(folded, cross)
    mismatches = []
    for i, (got, row) in enumerate(zip(off["tokens"], rows)):
        want = [int(t) for t in row]
        if eos in want:
            want = want[:want.index(eos) + 1]
        if got != want:
            pos = next((j for j, (a, b) in enumerate(zip(got, want))
                        if a != b), min(len(got), len(want)))
            gap = _top2_gap(module.model_cfg, folded, cross[i] + want[:pos])
            mismatches.append(dict(prompt=i, position=pos, top2_gap=gap))
            check(gap < 1e-3, f"prompt {i}: the merged replica and the "
                              f"in-memory fold differ at {pos} with a "
                              f"top-two logit gap of {gap}")
    del folded, module
    torch.cuda.empty_cache()
    lines, _, stderr = _cli_wait(serve_cli)
    cli = lines[-1]
    check(cli["device_kind"] == torch.cuda.get_device_name(dev)
          and cli["serving"]["completed"] == SERVE_CLI_REQUESTS
          and cli["serving"]["decode_path"] == "paged_kernel"
          and "quantize_decode=True" in stderr
          and "base verified" in stderr,
          f"tools.serve --bench on the LoRA yaml: {cli}")
    in_turns = {name: {k: [r[k] for r in records[quant]] for k in (
        "tokens_per_s", "ttft_p50_s", "ttft_p99_s", "itl_p50_s",
        "itl_p99_s")} for name, quant in (("quantized", True),
                                          ("unquantized", False))}
    mean = {name: {k: float(np.mean(v)) for k, v in runs.items()}
            for name, runs in in_turns.items()}
    out = dict(served, build_s=build_s,
               fused_norm_fwd_launches=first["counts"]["fused_norm_fwd"],
               in_turns=in_turns,
               tokens_per_s_ratio_in_turns=mean["quantized"]["tokens_per_s"]
               / mean["unquantized"]["tokens_per_s"],
               itl_p50_ratio_in_turns=mean["quantized"]["itl_p50_s"]
               / mean["unquantized"]["itl_p50_s"],
               phase2=dict((k, main_path[k]) for k in (
                   "tokens_per_s", "ttft_p50_s", "ttft_p99_s", "itl_p50_s",
                   "itl_p99_s", "decode_steps")),
               tokens_per_s_ratio_to_phase2=served["tokens_per_s"]
               / main_path["tokens_per_s"],
               itl_p50_ratio_to_phase2=served["itl_p50_s"]
               / main_path["itl_p50_s"],
               serve_cli=dict(requests=SERVE_CLI_REQUESTS,
                              **{k: cli["serving"][k] for k in (
                                  "tokens_total", "completed",
                                  "decode_path")}),
               f32_drift=drift, drift_bound=QUANT_DRIFT,
               f32_tokens_agree=agree, f32_tokens_compared=len(pairs),
               merged_vs_unmerged=dict(prompt_lens=list(CROSS_PROMPT_LENS),
                                       new_tokens=CROSS_NEW,
                                       identical=not mismatches,
                                       mismatches=mismatches),
               nvidia_smi=card)
    emit("quant_serving", **out)
    return out


def phase_finetune_serving(dev: torch.device, card: str, root: str,
                           ckpt_dir: str, tok_dir: str, prefix: str,
                           trainer: dict, main_path: dict,
                           started: Optional[tuple] = None) -> tuple:
    """Phase 13: the LoRA fine-tune from phase 8's checkpoint cut to
    ``CUT_LAYERS`` layers (``ckpt_dir``) on phase 10's corpus (its process
    ``started`` already, or started now), then its quantized replica;
    ``(finetune, quant)``."""
    finetune = timed("13 finetune", phase_finetune, dev, card, root,
                     ckpt_dir, tok_dir, prefix, trainer, started)
    quant = timed("13 quant_serving", phase_quant_serving, dev, card,
                  ckpt_dir, finetune, tok_dir, main_path)
    return finetune, quant


def _readme_tokenizer(root: str) -> str:
    """Phase 9's tokenizer (``train_bpe`` on README.md, vocab 2000) saved
    under ``root``; returns its directory."""
    from fleetx_tpu_torch.data.tokenizers.gpt_tokenizer import train_bpe

    tok_dir = os.path.join(root, "tokenizer")
    with open(os.path.join(REPO, "README.md"), encoding="utf-8") as f:
        train_bpe([f.read()], 2000).save_pretrained(tok_dir)
    return tok_dir


# -------------------------------------------------------------- phase 14
QAT_YAML = os.path.join(REPO, "fleetx_tpu", "configs", "nlp", "gpt",
                        "pretrain_gpt_345M_mp8_qat.yaml")
AUTO_YAML = os.path.join(REPO, "fleetx_tpu", "configs", "nlp", "gpt", "auto",
                         "pretrain_gpt_1.3B_single_card.yaml")
#: the QAT recipe on one card (the recipe's tensor parallel 8 is not
#: ported), no eval and no saves; its Data section is replaced by phase 4's
QAT_OVERRIDES = ["Distributed.mp_degree=1", f"Engine.max_steps={TRAIN_STEPS}",
                 "Engine.logging_freq=1", "Engine.eval_freq=0",
                 "Engine.save_load.save_steps=0"]
#: phase 4's recipe under the dots granularity
DOTS_OVERRIDES = ["Model.use_recompute=True",
                  "Model.recompute_granularity=dots"]
#: the auto recipe's run: synthetic data (its ./data/demo is not in the
#: repository), 3 steps, no eval and no saves
AUTO_STEPS = 3
AUTO_OVERRIDES = ["Data.Train.dataset.name=SyntheticGPTDataset",
                  "Data.Train.dataset.num_samples=65536",
                  "Data.Train.dataset.seq_length=1024",
                  "Data.Train.dataset.vocab_size=50304",
                  f"Engine.max_steps={AUTO_STEPS}", "Engine.logging_freq=1",
                  "Engine.eval_freq=0", "Engine.save_load.save_steps=0"]
#: per step under full recompute at 24 layers (345M, and the 1.3B auto
#: recipe): each layer's flash forward and its two norm forwards run twice
#: (forward, then recomputed), ln_f once
FULL_PER_STEP = {"flash_attention_fwd": 48, "flash_attention_bwd_fused": 24,
                 "fused_norm_fwd": 97, "fused_norm_bwd": 49}
#: GPT-1.3B's attention shape (batch 8, 16 heads, seq 1024, head_dim 128)
SHAPE_1_3B = (8, 16, 1024, 128)
#: QAT, f32, kernels on against off at 4 layers. Fake-quant is a step
#: function, and the kernels and the plain path differ by f32 ulps, so an
#: activation within an ulp of a rounding boundary moves by a whole 8-bit
#: step (1/127 of its tensor's largest value) on one side only; about one
#: element per site does, and it spreads through the layers above. The
#: loss, a mean over 8192 tokens, moves little (bound ten times phase 5's
#: 1e-4); a weight grad sums the flipped activation times its cotangents,
#: and a flip in a row with a large cotangent moves a few of its elements
#: by several steps' worth of the leaf's largest magnitude, so the grads
#: are held within 2**-4 of it. The same comparison without QAT is held
#: to phase 5's bounds beside it, which shows the kernels are not the
#: cause
QAT_ONOFF_LOSS_TOL, QAT_ONOFF_GRAD_TOL = 1e-3, 2.0 ** -4
#: dots against phase 4's uninterrupted losses: bitwise, since the forward
#: is the same ops and the recomputed ops are deterministic (tolerance 0)
DOTS_LOSS_TOL = 0.0


def _knob_run(dev: torch.device, cfg: dict, steps: int) -> tuple:
    """``(engine, losses, counts, peak GB, median step s of steps 2-)``:
    ``cfg``'s trainer fitted with the launch counts zeroed just before
    and read just after (``engine.history`` holds each step's time)."""
    from fleetx_tpu_torch.tools.train import build_trainer

    engine, train_dl, _ = build_trainer(cfg, device=dev)
    engine.max_steps = steps
    torch.cuda.empty_cache()
    reset_peak(dev)
    zero_counts()                   # every count to 0 just before
    losses = engine.fit(train_dl)
    torch.cuda.synchronize()
    counts = read_counts()          # read just after
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    hist = engine.history
    check(len(losses) == steps and all(np.isfinite(losses))
          and all(np.isfinite(h["grad_norm"]) for h in hist),
          f"losses {losses}")
    step_s = statistics.median(h["train_cost"] for h in hist[1:]) \
        if steps > 1 else hist[0]["train_cost"]
    return engine, losses, counts, peak_gb, step_s


def _check_per_step(what: str, counts: dict, per_step: dict,
                    steps: int) -> None:
    for name, n in per_step.items():
        check(counts[name] == n * steps,
              f"{what} {name}: {counts[name]} launches, want {n} x {steps}")


def _qat_train(dev: torch.device, card: str, trainer: dict) -> dict:
    """14a: the QAT recipe at full width, 10 steps, on phase 4's data; its
    step beside phase 4's, a short trace; then kernels on against off."""
    from fleetx_tpu_torch.models.gpt.model import config_from_dict, init_params
    from fleetx_tpu_torch.tools.train import load_config

    cfg = load_config(QAT_YAML, QAT_OVERRIDES)
    cfg["Data"] = load_config(TRAIN_YAML)["Data"]   # phase 4's data
    engine, losses, counts, peak_gb, step_s = _knob_run(dev, cfg,
                                                        TRAIN_STEPS)
    mc = engine.module.model_cfg
    check(mc.use_qat and mc.qat_bits == 8 and mc.qat_act_bits == 8
          and mc.num_layers == 24 and mc.hidden_size == 1024
          and mc.dtype == torch.bfloat16 and not mc.use_recompute
          and cfg["Global"]["global_batch_size"] == 8
          and cfg["Global"]["seed"] == 1024,
          "not the full-width 345M QAT recipe")
    _check_per_step("qat", counts, PER_STEP, TRAIN_STEPS)
    step_ms = [h["train_cost"] * 1e3 for h in engine.history]
    batch = engine.to_device(next(iter(_train_loader(cfg))))
    fields, share = _trace_window(lambda: engine.train_step(batch), 3,
                                  n_top=12)
    matmul_ms = share("nvjet", "gemm", "cutlass", "sm90_xmma")
    kernels_ms = share("flash_fwd_kernel", "flash_bwd_kernel",
                       "fused_norm_fwd", "fused_norm_bwd_kernel")
    del engine, batch
    torch.cuda.empty_cache()
    out = dict(steps=TRAIN_STEPS, losses=losses, launches=counts,
               launches_per_step={k: counts[k] / TRAIN_STEPS
                                  for k in PER_STEP},
               step_ms=step_ms, step_ms_median=step_s * 1e3,
               phase4_step_ms_median=trainer["step_ms_median"],
               step_ratio_to_phase4=step_s * 1e3 / trainer["step_ms_median"],
               max_memory_allocated_gb=peak_gb,
               phase4_max_memory_allocated_gb=trainer[
                   "max_memory_allocated_gb"],
               trace=dict(fields, matmul_ms_per_step=matmul_ms,
                          kernels_ms_per_step=kernels_ms,
                          other_ms_per_step=share() - matmul_ms - kernels_ms))
    emit("qat_train", **out, nvidia_smi=card)

    # kernels on against off, f32, 4 layers, dropout 0 (phase 5's check at
    # phase 7's depth)
    base = QAT_OVERRIDES + SHORT + ["Model.dtype=float32",
                                    "Model.hidden_dropout_prob=0.0",
                                    "Model.attention_probs_dropout_prob=0.0"]
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in next(iter(_train_loader(cfg))).items()}
    params = init_params(config_from_dict(dict(
        load_config(QAT_YAML, base)["Model"])), seed=0, device=dev)

    def on_off(yaml: str) -> tuple:
        runs = [_loss_and_grads(base + [f"Model.use_flash_attention={on}",
                                        f"Model.fused_residual_norm={on}"],
                                params, batch, yaml) for on in (True, False)]
        (loss_on, g_on), (loss_off, g_off) = runs
        rels = [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                for a, b in zip(g_on, g_off)]
        return loss_on, loss_off, rels

    loss_on, loss_off, rels = on_off(QAT_YAML)
    # the same without QAT (phase 5's check at this depth)
    p_on, p_off, p_rels = on_off(TRAIN_YAML)
    onoff = dict(layers=4, loss_on=loss_on, loss_off=loss_off,
                 loss_diff=abs(loss_on - loss_off),
                 max_grad_diff_over_leaf_max=max(rels),
                 grad_diff_over_leaf_max_per_leaf=rels,
                 loss_tol=QAT_ONOFF_LOSS_TOL, grad_tol=QAT_ONOFF_GRAD_TOL,
                 without_qat=dict(loss_diff=abs(p_on - p_off),
                                  max_grad_diff_over_leaf_max=max(p_rels)))
    emit("qat_kernels_vs_plain", **onoff, nvidia_smi=card)
    check(abs(loss_on - loss_off) <= QAT_ONOFF_LOSS_TOL,
          f"QAT f32 loss kernels on {loss_on} vs off {loss_off}")
    check(max(rels) <= QAT_ONOFF_GRAD_TOL,
          f"QAT f32 grads on vs off: {max(rels)}")
    check(abs(p_on - p_off) <= 1e-4 and max(p_rels) <= 1e-3,
          f"f32 kernels on vs off at 4 layers: {abs(p_on - p_off)}, "
          f"{max(p_rels)}")
    del params, batch
    torch.cuda.empty_cache()
    out["kernels_vs_plain"] = onoff
    return out


def _train_loader(cfg: dict):
    """``cfg``'s ``Data.Train`` loader at its batch and shapes."""
    from fleetx_tpu_torch.data import build_dataloader

    glb = cfg["Global"]
    return build_dataloader(cfg["Data"], "Train",
                            batch_size=glb["global_batch_size"],
                            seq_length=glb["max_seq_len"],
                            vocab_size=cfg["Model"]["vocab_size"])


def _dots_train(dev: torch.device, card: str, trainer: dict) -> dict:
    """14b: phase 4's recipe, seed and batches under ``dots`` for 10
    steps, its losses held to phase 4's, and a short trace; two steps of
    ``full`` for the launch counts beside it."""
    from fleetx_tpu_torch.tools.train import load_config

    cfg = load_config(TRAIN_YAML, [f"Engine.max_steps={TRAIN_STEPS}",
                                   "Engine.logging_freq=1"]
                      + DOTS_OVERRIDES)
    engine, losses, counts, peak_gb, step_s = _knob_run(dev, cfg,
                                                        TRAIN_STEPS)
    mc = engine.module.model_cfg
    check(mc.use_recompute and mc.recompute_granularity == "dots"
          and mc.remat_save_dtype is None and mc.remat_consumed_layout
          and mc.num_layers == 24 and mc.hidden_size == 1024
          and mc.dtype == torch.bfloat16, "not phase 4's recipe under dots")
    step_ms = [h["train_cost"] * 1e3 for h in engine.history]
    batch = engine.to_device(next(iter(_train_loader(cfg))))
    fields, share = _trace_window(lambda: engine.train_step(batch), 3,
                                  n_top=12)
    matmul_ms = share("nvjet", "gemm", "cutlass", "sm90_xmma")
    kernels_ms = share("flash_fwd_kernel", "flash_bwd_kernel",
                       "fused_norm_fwd", "fused_norm_bwd_kernel")
    del engine, batch
    _check_per_step("dots", counts, PER_STEP, TRAIN_STEPS)
    diffs = [abs(a - b) for a, b in zip(losses, trainer["losses"])]
    full_cfg = load_config(TRAIN_YAML, ["Engine.logging_freq=1",
                                        "Model.use_recompute=True",
                                        "Model.recompute_granularity=full"])
    engine, _, full_counts, full_peak, full_s = _knob_run(dev, full_cfg, 2)
    del engine
    torch.cuda.empty_cache()
    _check_per_step("full", full_counts, FULL_PER_STEP, 2)
    out = dict(steps=TRAIN_STEPS, losses=losses,
               phase4_losses=trainer["losses"], loss_diffs=diffs,
               bitwise=all(d == 0.0 for d in diffs), loss_tol=DOTS_LOSS_TOL,
               launches=counts,
               launches_per_step={k: counts[k] / TRAIN_STEPS
                                  for k in PER_STEP},
               full_launches_per_step={k: full_counts[k] / 2
                                       for k in FULL_PER_STEP},
               step_ms=step_ms, step_ms_median=step_s * 1e3,
               phase4_step_ms_median=trainer["step_ms_median"],
               full_step_ms=full_s * 1e3,
               max_memory_allocated_gb=peak_gb,
               phase4_max_memory_allocated_gb=trainer[
                   "max_memory_allocated_gb"],
               full_max_memory_allocated_gb=full_peak,
               trace=dict(fields, matmul_ms_per_step=matmul_ms,
                          kernels_ms_per_step=kernels_ms,
                          other_ms_per_step=share() - matmul_ms - kernels_ms))
    emit("dots_train", **out, nvidia_smi=card)
    check(max(diffs) <= DOTS_LOSS_TOL,
          f"dots losses {losses} against phase 4's {trainer['losses']}")
    check(peak_gb < trainer["max_memory_allocated_gb"],
          f"dots peak {peak_gb} GB is not below phase 4's "
          f"{trainer['max_memory_allocated_gb']} GB")
    return out


def auto_child(argv: list) -> int:
    """The process of phase 14c: ``tools.auto``'s ``main(argv)`` with the
    launch counts zeroed just before and read just after, then one JSON
    line of them and the peak memory."""
    from fleetx_tpu_torch.tools import auto

    reset_peak()
    zero_counts()
    rc = auto.main(argv)
    torch.cuda.synchronize()
    print(json.dumps({"rc": rc, "launches": read_counts(),
                      "max_memory_allocated_gb":
                          torch.cuda.max_memory_allocated() / 2 ** 30}),
          flush=True)
    return rc


_TRAIN_LINE = re.compile(
    r"global step (\d+),.* loss: ([0-9.]+), avg_batch_cost: ([0-9.]+) sec"
    r".* ips_total: ([0-9.]+) tokens/s(?:.*mfu: ([0-9.]+)%)?")


def _auto_start() -> tuple:
    """14c's process (``auto_child``) started, its output to unnamed
    temporary files; ``(started, start time)``."""
    logs = (tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+"))
    proc = subprocess.Popen(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "sys.exit(chip_smoke.auto_child(sys.argv[1:]))", "-c", AUTO_YAML]
        + _overrides(AUTO_OVERRIDES), cwd=REPO, stdout=logs[0],
        stderr=logs[1], text=True, env=dict(os.environ, PYTHONPATH=REPO))
    proc.logs = logs
    return ("tools.auto", proc), time.perf_counter()


def _auto_train(dev: torch.device, card: str, started: tuple) -> dict:
    """14c: ``python -m fleetx_tpu_torch.tools.auto`` on the 1.3B auto
    recipe, full width and depth, as its own process (through
    ``auto_child``, which reads its launch counts), ``started`` by
    ``_auto_start`` at the phase's start."""
    from fleetx_tpu_torch.tools.train import load_config
    from fleetx_tpu_torch.utils.hardware import peak_flops

    cfg = load_config(AUTO_YAML, AUTO_OVERRIDES, auto_layout=True,
                      device=dev)
    mc = cfg["Model"]
    check(mc["num_layers"] == 24 and mc["hidden_size"] == 2048
          and mc["num_attention_heads"] == 16 and mc["use_recompute"]
          and mc["recompute_granularity"] == "full"
          and cfg["Global"]["max_seq_len"] == 1024
          and cfg["Global"]["global_batch_size"] == 8,
          "not the full-width GPT-1.3B auto recipe")
    _, stdout, log = _cli_wait(started[0])
    process_s = time.perf_counter() - started[1]
    rec = json.loads(stdout.strip().splitlines()[-1])
    planned = re.search(r"auto layout for ([0-9.]+)B params on (\d+) "
                        r"devices: (\{.*\})", log)
    budget = re.search(r"auto_layout: 1 device, budget ([0-9.]+) GB "
                       r"\((.*)\)", log)
    check(planned is not None and budget is not None,
          f"tools.auto logged no plan: {log[-2000:]}")
    layout = ast.literal_eval(planned.group(3))
    card_gb = torch.cuda.get_device_properties(dev).total_memory / 2 ** 30
    check(all(v == 1 for v in layout.values()) and planned.group(2) == "1",
          f"planned {layout}")
    check(abs(float(budget.group(1)) - card_gb) < 0.01
          and "exceeds the" not in log,
          f"budget {budget.group(0)}; card {card_gb} GB")
    steps = [_TRAIN_LINE.search(line) for line in log.splitlines()
             if "[train] global step" in line]
    check(len(steps) == AUTO_STEPS and all(steps), "a step was not logged")
    losses = [float(m.group(2)) for m in steps]
    costs = [float(m.group(3)) for m in steps]
    hidden, vocab = mc["hidden_size"], mc["vocab_size"]
    expect = float(np.log(vocab) + hidden * mc["initializer_range"] ** 2 / 2)
    check(all(np.isfinite(losses)) and abs(losses[0] - expect) < 0.1,
          f"first loss {losses[0]} is not within 0.1 of {expect}")
    _check_per_step("auto_1.3B", rec["launches"], FULL_PER_STEP, AUTO_STEPS)
    for name, kernel in TC_COUNTS.items():
        check(rec["launches"][name] == rec["launches"][kernel],
              f"auto_1.3B {kernel} off the tensor cores")
    step_s = statistics.median(costs[1:])
    tokens = cfg["Global"]["global_batch_size"] * cfg["Global"]["max_seq_len"]
    from fleetx_tpu_torch.utils.hardware import gpt_flops_per_token

    fpt = gpt_flops_per_token(mc["num_layers"], hidden,
                              cfg["Global"]["max_seq_len"], vocab_size=vocab)
    peak = peak_flops(torch.cuda.get_device_name(dev)) or PEAK_BF16_FLOPS
    out = dict(steps=AUTO_STEPS, losses=losses, expected_first_loss=expect,
               planned_layout=layout, planned_params_b=float(
                   planned.group(1)), budget_gb=float(budget.group(1)),
               budget_source=budget.group(2), card_memory_gb=card_gb,
               step_ms=[c * 1e3 for c in costs],
               step_ms_median_of_steps_2_3=step_s * 1e3,
               tokens_per_s=tokens / step_s,
               mfu=fpt * tokens / step_s / peak,
               logged_mfu_pct=[m.group(5) and float(m.group(5))
                               for m in steps],
               max_memory_allocated_gb=rec["max_memory_allocated_gb"],
               launches=rec["launches"],
               launches_per_step={k: rec["launches"][k] / AUTO_STEPS
                                  for k in FULL_PER_STEP},
               process_s=process_s)
    emit("auto_1.3B_train", **out, nvidia_smi=card)
    return out


def phase_gpt_knobs(dev: torch.device, card: str, trainer: dict) -> dict:
    """Phase 14: QAT, the dots granularity and the auto-layout entry point
    at full width (each counted from 0 around its own run), and rows 1 and
    4 at the 1.3B attention shape, which 14c is the first path to run."""
    # 14c's process runs beside 14a-b (the smoke's time limit: it took
    # ~19 s alone, most of it its start; its 3 steps share the card with
    # theirs)
    started = _auto_start()
    try:
        out = {"qat": _qat_train(dev, card, trainer),
               "dots": _dots_train(dev, card, trainer),
               "auto": _auto_train(dev, card, started)}
    finally:
        proc = started[0][1]
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    rows = _flash_rows(torch.bfloat16, dev, flush, SHAPE_1_3B)
    del flush
    torch.cuda.empty_cache()
    for kernel, row in rows.items():
        emit("kernel", name=kernel, dtype="bfloat16", shape="1.3B", **row)
    out["shape_1.3B"] = rows
    return out


def gpt_knobs_alone(dev: torch.device, card: str) -> None:
    """``--gpt-knobs``: phase 4 (the losses, step and peak memory phase 14
    is held to), then phase 14."""
    trainer = timed("4", phase_trainer, dev, card)
    timed("14", phase_gpt_knobs, dev, card, trainer)
    reset_peak(dev)                     # the last phase's garbage too
    emit("gpt_knobs_alone", phase_walls=PHASE_WALLS,
         collect_freed_bytes=COLLECT_FREED,
         collect_holders=COLLECT_HOLDERS, nvidia_smi=card)


def finetune_serving_alone(dev: torch.device, card: str) -> None:
    """``--finetune-serving``: phase 2 (the unquantized replica phase 13
    is set beside), phase 4 (the step time phase 13 is set beside, and the
    losses phase 8 replays), phase 8, phase 9's tokenizer and phase 10's
    corpus, then phase 13."""
    main_path = timed("2", phase_main_path, dev, card)
    trainer = timed("4", phase_trainer, dev, card)
    root = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        timed("8", phase_checkpoint, dev, card, trainer["losses"], root)
        cut_dir = _cut_checkpoint(dev, root, os.path.join(root, "ckpt"))
        tok_dir = _readme_tokenizer(root)
        txt, _, _ = _eval_texts(root)
        phase_finetune_serving(dev, card, root, cut_dir,
                               tok_dir, _docs_corpus(root, txt, tok_dir),
                               trainer, main_path)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit("finetune_serving_alone", phase_walls=PHASE_WALLS,
         nvidia_smi=card)


def eval_and_export(dev: torch.device, card: str, root: str,
                    ckpt_dir: str, tok_dir: str,
                    finetune: bool = False) -> tuple:
    """Phases 10 and 11 on the checkpoint under ``ckpt_dir``, its params
    loaded once in this process for the in-process comparisons; with
    ``finetune``, phase 13's fine-tune process starts on phase 10's corpus
    and runs beside phase 11 (the smoke's time limit). ``(evaluation,
    export, the started fine-tune or None)``."""
    from fleetx_tpu_torch.core.checkpoint import load_params

    params = load_params(ckpt_dir, device=dev)
    evaluation = timed("10", phase_eval, dev, card, root, ckpt_dir, tok_dir,
                       params)
    started = _finetune_start(root, ckpt_dir, tok_dir,
                              evaluation["corpus_prefix"]) \
        if finetune else None
    try:
        export = timed("11", phase_export, dev, card, root, ckpt_dir,
                       tok_dir, params)
    except BaseException:
        if started is not None:
            started[0][1].kill()
        raise
    del params
    torch.cuda.empty_cache()
    return evaluation, export, started


def eval_export_alone(dev: torch.device, card: str) -> None:
    """``--eval-export``: phases 10-11 and row 1 at the eval shape on a
    checkpoint of the 345M recipe's seeded params (no training), with the
    tokenizer phase 9 trains."""
    from fleetx_tpu_torch.core import checkpoint as C
    from fleetx_tpu_torch.core.module import GPTModule
    from fleetx_tpu_torch.tools.train import load_config

    root = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        module = GPTModule(load_config(TRAIN_YAML))
        params = module.init_params(1234, dev)
        C.save_checkpoint(os.path.join(root, "ckpt"), 1, dict(
            step=1, **C.flatten(params, "params/")), meta={
                "consumed_samples": 0, "epoch": 0, "seed": 1234})
        del params
        eval_and_export(dev, card, root,
                        _cut_checkpoint(dev, root, os.path.join(root,
                                                                "ckpt")),
                        _readme_tokenizer(root))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    phase_row1_eval_shape(dev, card, float("nan"))


# -------------------------------------------------------------- phase 15
ERNIE_YAML = os.path.join(REPO, "fleetx_tpu", "configs", "nlp", "ernie",
                          "pretrain_ernie_345M.yaml")
VIT_YAML = os.path.join(REPO, "fleetx_tpu", "configs", "vis", "vit",
                        "ViT_base_patch16_224_pretrain.yaml")
ERNIE_STEPS = 10
#: the ERNIE 345M recipe on the card. Cuts: its corpus is not in the
#: repository (SyntheticErnieDataset, the recipe's own zero-data
#: stand-in); its LR warms up over 9900 steps, at whose step-10 rate of
#: 9e-8 ten steps barely move the weights, so the warmup is off (max_lr
#: 1e-4 from the first step) and the loss can be seen to fall
ERNIE_OVERRIDES = ["Data.Train.dataset.name=SyntheticErnieDataset",
                   "Optimizer.lr.warmup_rate=0.0",
                   f"Engine.max_steps={ERNIE_STEPS}", "Engine.logging_freq=1",
                   "Engine.eval_freq=0", "Engine.save_load.save_steps=0"]
VIT_STEPS = 5
VIT_EVAL_BATCHES = 2
#: sample seeds no training run here draws from: the synthetic sets seed
#: sample i with ``seed + i``, and train and eval would otherwise share
#: their first samples
UNSEEN_SEED = 1_000_000
#: the ViT-B/16 recipe on one card (cuts: global batch 4096 = 16 x 256 →
#: 256, dp 16 → 1; ImageNet is not in the repository, so
#: SyntheticVisionDataset for both loaders); eval_freq past the run, so
#: the trainer builds the eval loader and fit never evaluates
VIT_OVERRIDES = ["Global.global_batch_size=256",
                 "Data.Train.dataset.name=SyntheticVisionDataset",
                 f"Data.Train.dataset.num_samples={256 * VIT_STEPS}",
                 "Data.Eval.dataset.name=SyntheticVisionDataset",
                 f"Data.Eval.dataset.num_samples={256 * VIT_EVAL_BATCHES}",
                 f"Data.Eval.dataset.seed={UNSEEN_SEED}",
                 f"Engine.max_steps={VIT_STEPS}", "Engine.logging_freq=1",
                 "Engine.eval_freq=1000",
                 f"Engine.eval_iters={VIT_EVAL_BATCHES}",
                 "Engine.save_load.save_steps=0"]
#: 15c: the epoch run mode, ViT at 2 blocks, 2 epochs over 4 batches of
#: 64
EPOCH_BATCHES, EPOCHS, EPOCH_BATCH = 4, 2, 64
#: the kernel rows the encoder paths must not launch (their attention and
#: LayerNorms are plain in JAX too)
ENCODER_ROWS = ("flash_attention_fwd", "flash_attention_bwd_fused",
                "fused_norm_fwd", "fused_norm_bwd")


def _no_launches(what: str, counts: dict) -> None:
    check(all(n == 0 for n in counts.values()),
          f"{what}: a kernel launched on a plain path: {counts}")


def _ernie_train(dev: torch.device, card: str) -> dict:
    """15a: the ERNIE 345M recipe through ``build_trainer`` → ``fit`` for
    10 steps at full width, bf16, with every launch count zeroed just
    before and read just after; the losses, dropout off, of the first
    step's batch and of a batch no step trains on, before and after; then
    a 3-step trace."""
    from fleetx_tpu_torch.data.dataloader import default_collate
    from fleetx_tpu_torch.tools.train import build_trainer, load_config

    cfg = load_config(ERNIE_YAML, ERNIE_OVERRIDES)
    engine, train_dl, _ = build_trainer(cfg, device=dev)
    mc, glb = engine.module.model_cfg, cfg["Global"]
    check(type(engine.module).__name__ == "ErnieModule"
          and mc.num_layers == 24 and mc.hidden_size == 1024
          and mc.num_attention_heads == 16 and mc.vocab_size == 40000
          and mc.dtype == torch.bfloat16 and glb["max_seq_len"] == 512
          and glb["global_batch_size"] == 16 and engine.module.binary_head
          and mc.hidden_dropout_prob == 0.1
          and mc.attention_probs_dropout_prob == 0.1,
          "not the full-width ERNIE 345M recipe")
    parts: list = []
    step = engine.train_step

    def recorded(batch):
        metrics = step(batch)
        parts.append((metrics["mlm_loss"], metrics["nsp_loss"]))
        return metrics

    engine.train_step = recorded
    ds = train_dl.dataset
    probes = {"first": engine.to_device(next(iter(train_dl))),
              "unseen": engine.to_device(default_collate([
                  type(ds)(num_samples=16, seq_length=ds.seq_length,
                           vocab_size=ds.vocab_size, seed=UNSEEN_SEED)[i]
                  for i in range(glb["global_batch_size"])]))}
    engine.prepare()

    def probe_losses() -> dict:
        with torch.no_grad():
            return {k: float(engine.module.validation_loss(engine.params,
                                                           b)[0])
                    for k, b in probes.items()}

    before = probe_losses()
    torch.cuda.empty_cache()
    reset_peak(dev)
    zero_counts()                   # every count to 0 just before
    losses = engine.fit(train_dl)
    torch.cuda.synchronize()
    counts = read_counts()          # read just after
    _unpatch(engine, "train_step")
    _no_launches("ernie_train", counts)
    after = probe_losses()
    hist = engine.history
    check(len(losses) == ERNIE_STEPS and all(np.isfinite(losses))
          and all(np.isfinite(h["grad_norm"]) for h in hist),
          f"ernie losses {losses}")
    # the training losses carry batch and dropout noise (~0.02) and jump
    # in the first steps at the full LR; the first step's batch, dropout
    # off, is the same batch before and after: the trainer fits what it
    # trains on (it fell 0.22-0.29 over two seeds). Random tokens leave an
    # unseen batch little to learn, so its loss is printed, not held
    check(after["first"] < before["first"] - 0.05,
          f"ernie loss did not fall: {before['first']} -> "
          f"{after['first']} on the first step's batch")
    # MLM over random logits of variance hidden * r**2, plus NSP's ln 2
    expect = float(np.log(mc.vocab_size) + np.log(2.0) + mc.hidden_size
                   * mc.initializer_range ** 2 / 2)
    check(abs(losses[0] - expect) < 0.1,
          f"ernie first loss {losses[0]} is not within 0.1 of {expect}")
    step_s = statistics.median(h["train_cost"] for h in hist[1:])
    tokens = glb["global_batch_size"] * glb["max_seq_len"]
    out = dict(steps=ERNIE_STEPS, losses=losses,
               grad_norms=[h["grad_norm"] for h in hist],
               first_loss=losses[0], expected_first_loss=expect,
               last_loss=losses[-1],
               first_batch_loss_before=before["first"],
               first_batch_loss_after=after["first"],
               unseen_batch_loss_before=before["unseen"],
               unseen_batch_loss_after=after["unseen"],
               mlm_loss=[float(m) for m, _ in parts],
               nsp_loss=[float(n) for _, n in parts],
               step_ms_median=step_s * 1e3,
               step_ms=[h["train_cost"] * 1e3 for h in hist],
               tokens_per_s=tokens / step_s,
               max_memory_allocated_gb=torch.cuda.max_memory_allocated(dev)
               / 2 ** 30, launches=counts, nvidia_smi=card)
    emit("ernie_train", **out)
    batch = engine.to_device(next(iter(train_dl)))
    fields, share = _trace_window(lambda: engine.train_step(batch), 3,
                                  n_top=10)
    out["trace"] = dict(fields, matmul_ms_per_step=share(
        "nvjet", "gemm", "cutlass", "sm90_xmma"))
    emit("ernie_trace", **out["trace"], nvidia_smi=card)
    del engine, batch, probes
    torch.cuda.empty_cache()
    return out


def _vit_train(dev: torch.device, card: str) -> dict:
    """15b: the ViT-B/16 recipe through ``build_trainer`` → ``fit`` for 5
    steps at full width, bf16, batch 256 (counts zeroed just before and
    read just after), then ``evaluate`` over 2 eval batches and their
    top-1 / top-5 from ``validation_loss``, then a 3-step trace of the
    step alone (device time beside the host-bound wall)."""
    from fleetx_tpu_torch.tools.train import build_trainer, load_config

    cfg = load_config(VIT_YAML, VIT_OVERRIDES)
    engine, train_dl, valid_dl = build_trainer(cfg, device=dev)
    mc, glb = engine.module.vit_cfg, cfg["Global"]
    check(type(engine.module).__name__ == "GeneralClsModule"
          and mc.num_layers == 12 and mc.hidden_size == 768
          and mc.num_attention_heads == 12 and mc.patch_size == 16
          and mc.image_size == 224 and mc.num_classes == 1000
          and mc.dtype == torch.bfloat16 and mc.drop_path_rate == 0.1
          and glb["global_batch_size"] == 256 and engine.accumulate_steps == 1
          and valid_dl is not None, "not the ViT-B/16 recipe at batch 256")
    torch.cuda.empty_cache()
    reset_peak(dev)
    zero_counts()                   # every count to 0 just before
    losses = engine.fit(train_dl)
    torch.cuda.synchronize()
    counts = read_counts()          # read just after
    _no_launches("vit_train", counts)
    hist = engine.history
    check(len(losses) == VIT_STEPS and all(np.isfinite(losses))
          and all(np.isfinite(h["grad_norm"]) for h in hist),
          f"vit losses {losses}")
    # the zero head: every logit equal, so the smoothed loss is ln(1000);
    # the synthetic labels are random, so no step can bring the expected
    # loss below it, and at the recipe's warmup LR (3e-7 a step) the steps
    # after stay there
    expect = float(np.log(mc.num_classes))
    check(all(abs(loss - expect) < 1e-2 for loss in losses),
          f"vit losses {losses} are not within 1e-2 of {expect}")
    step_s = statistics.median(h["train_cost"] for h in hist[1:])
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    t0 = time.perf_counter()
    eval_loss = engine.evaluate(valid_dl)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    metrics = []
    with torch.no_grad():
        for i, batch in enumerate(valid_dl):
            if i >= VIT_EVAL_BATCHES:
                break
            _, m = engine.module.validation_loss(engine.params,
                                                 engine.to_device(batch))
            metrics.append({k: float(v) for k, v in m.items()})
    check(len(metrics) == VIT_EVAL_BATCHES and abs(
        np.mean([m["loss"] for m in metrics]) - eval_loss) < 1e-6
          and all(0.0 <= m["top1"] <= m["top5"] <= 1.0 for m in metrics),
          f"vit eval: {eval_loss} against {metrics}")
    out = dict(steps=VIT_STEPS, losses=losses,
               grad_norms=[h["grad_norm"] for h in hist],
               first_loss=losses[0], expected_first_loss=expect,
               step_ms_median=step_s * 1e3,
               step_ms=[h["train_cost"] * 1e3 for h in hist],
               images_per_s=glb["global_batch_size"] / step_s,
               max_memory_allocated_gb=peak_gb, eval_loss=eval_loss,
               eval_top1=float(np.mean([m["top1"] for m in metrics])),
               eval_top5=float(np.mean([m["top5"] for m in metrics])),
               eval_batches=VIT_EVAL_BATCHES, eval_s=eval_s,
               launches=counts, nvidia_smi=card)
    emit("vit_train", **out)
    batch = engine.to_device(next(iter(train_dl)))
    fields, share = _trace_window(lambda: engine.train_step(batch), 3,
                                  n_top=10)
    out["trace"] = dict(fields, matmul_ms_per_step=share(
        "nvjet", "gemm", "cutlass", "sm90_xmma"))
    emit("vit_trace", **out["trace"], nvidia_smi=card)
    del engine, batch
    torch.cuda.empty_cache()
    return out


def _epoch_mode(dev: torch.device, card: str) -> dict:
    """15c: ``run_mode: epoch`` through ``tools.train.run``: ViT at 2
    blocks, ``num_train_epochs`` 2 over a synthetic set of 4 batches of
    64: 8 steps,
    epoch 2 in the final checkpoint's meta; the run resumed from it takes
    no step."""
    from fleetx_tpu_torch.core.checkpoint import peek_meta
    from fleetx_tpu_torch.tools.train import build_trainer, load_config, run

    root = tempfile.mkdtemp(prefix="chip_smoke_epoch_")
    try:
        overrides = VIT_OVERRIDES + [
            "Model.num_layers=2", "Engine.run_mode=epoch",
            f"Engine.num_train_epochs={EPOCHS}", "Engine.max_steps=100",
            f"Global.global_batch_size={EPOCH_BATCH}",
            f"Global.local_batch_size={EPOCH_BATCH}",
            f"Global.micro_batch_size={EPOCH_BATCH}",
            f"Data.Train.dataset.num_samples={EPOCH_BATCH * EPOCH_BATCHES}",
            "Engine.save_load.save_steps=1000",
            f"Engine.save_load.output_dir={root}"]
        t0 = time.perf_counter()
        engine, losses = run(load_config(VIT_YAML, overrides), device=dev)
        wall = time.perf_counter() - t0
        meta = peek_meta(root)
        epochs = [h["epoch"] for h in engine.history]
        check(engine.step == EPOCHS * EPOCH_BATCHES
              and len(losses) == EPOCHS * EPOCH_BATCHES
              and epochs == [e for e in range(EPOCHS)
                             for _ in range(EPOCH_BATCHES)]
              and meta["epoch"] == EPOCHS
              and meta["step"] == EPOCHS * EPOCH_BATCHES,
              f"epoch mode: step {engine.step}, epochs {epochs}, meta {meta}")
        del engine
        resumed, train_dl, _ = build_trainer(load_config(
            VIT_YAML, overrides + [f"Engine.save_load.ckpt_dir={root}"]),
            device=dev)
        again = resumed.fit(train_dl, epoch_num=EPOCHS)
        check(again == [] and resumed.step == EPOCHS * EPOCH_BATCHES
              and resumed.epoch == EPOCHS,
              f"epoch resume took {len(again)} steps at epoch "
              f"{resumed.epoch}")
        del resumed
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    out = dict(steps=EPOCHS * EPOCH_BATCHES, epochs=epochs,
               meta_epoch=meta["epoch"], losses=losses, wall_s=wall,
               nvidia_smi=card)
    emit("epoch_mode", **out)
    return out


def phase_encoders(dev: torch.device, card: str) -> dict:
    """Phase 15: ERNIE 345M pretraining, ViT-B/16 classification with
    eval, and the epoch run mode through ``tools.train``; no kernel of
    the port is on these paths (zero launches)."""
    return {"ernie": _ernie_train(dev, card), "vit": _vit_train(dev, card),
            "epoch": _epoch_mode(dev, card)}


def encoders_while_building(build, dev: torch.device, card: str) -> tuple:
    """Phase 15 while every kernel compiles on a thread of its own (the
    ``nvcc`` processes, ~30 s); ``(phase 15's result, the build's
    seconds)``. Its zero launch counts still hold: a launch on its paths
    would build its library and count."""
    def timed_build() -> float:
        t0 = time.monotonic()
        build.build()
        return time.monotonic() - t0

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        built = pool.submit(timed_build)
        encoders = timed("15", phase_encoders, dev, card)
        return encoders, built.result()


# -------------------------------------------------------------- phase 16
MOE_YAML = os.path.join(REPO, "fleetx_tpu", "configs", "nlp", "gpt",
                        "pretrain_gpt_moe_8expert_mp4.yaml")
IMAGEN_BASE_YAML = os.path.join(REPO, "fleetx_tpu", "configs", "multimodal",
                                "imagen", "imagen_397M_text2im_64x64.yaml")
IMAGEN_SR_YAML = os.path.join(REPO, "fleetx_tpu", "configs", "multimodal",
                              "imagen", "imagen_super_resolution_256.yaml")
MOE_STEPS = 10
#: the MoE recipe on one card. Cuts: dp 2 and mp 4 → 1 (item 12), phase
#: 4's synthetic data (its ./data/demo is not in the repository), no eval
#: and no saves inside the fit
MOE_OVERRIDES = ["Distributed.dp_degree=1", "Distributed.mp_degree=1",
                 f"Engine.max_steps={MOE_STEPS}", "Engine.logging_freq=1",
                 "Engine.eval_freq=0", "Engine.save_load.save_steps=0"]
#: per micro-batch at 24 layers: phase 4's step (the MoE stack's
#: attention and LayerNorms are the dense GPT's); 2 micro-batches a step
MOE_MICRO_BATCHES = 2
MOE_EVAL_BATCHES = 4
#: greedy generation from the trained weights: phase 9's prompt lengths,
#: 32 new tokens
MOE_GEN_NEW = 32
#: MoE, f32, kernels on against off at 4 layers. The routing is a step
#: function of the router's input (the top-2 of 8 probabilities, and a
#: token's queue slot at its expert): where the kernels' f32 ulps flip no
#: token-choice, the two runs are the same function and phase 5's bounds
#: hold (loss 1e-4, grads 1e-3 of each leaf's largest magnitude); a
#: flipped choice moves one token's FFN output by a whole expert's worth,
#: so then the bounds are QAT's (14a: loss 1e-3, grads 2**-4), and the
#: flipped choices are counted and printed
MOE_ONOFF_TOL = {False: (1e-4, 1e-3), True: (1e-3, 2.0 ** -4)}
IMAGEN_STEPS = 10
#: the base recipe on one card: SyntheticImagenDataset at the YAML's T5
#: width 1024 (the TSV and T5 features are not in the repository; the
#: dataset's default width is 64); the final step saved for 16c
IMAGEN_OVERRIDES = ["Data.Train.dataset.name=SyntheticImagenDataset",
                    "Data.Train.dataset.text_embed_dim=1024",
                    f"Data.Train.dataset.num_samples={16 * IMAGEN_STEPS}",
                    f"Engine.max_steps={IMAGEN_STEPS}",
                    "Engine.logging_freq=1",
                    f"Engine.save_load.save_steps={IMAGEN_STEPS}"]
#: the SR-256 recipe: one step at the YAML's batch 8 on 64² low-res images
IMAGEN_SR_OVERRIDES = ["Data.Train.dataset.name=SyntheticImagenDataset",
                       "Data.Train.dataset.text_embed_dim=1024",
                       "Data.Train.dataset.num_samples=8",
                       "Engine.max_steps=1", "Engine.logging_freq=1",
                       "Engine.save_load.save_steps=0"]
#: 16c: the cascade's timesteps (cut from the YAMLs' 1000) and batch
CASCADE_TIMESTEPS = 50
CASCADE_BATCH = 2


class _Routes:
    """Record every MoE routing (``models/gpt/moe.route``) while open."""

    def __init__(self):
        from fleetx_tpu_torch.models.gpt import moe as MOE

        self.MOE, self.real, self.routes = MOE, MOE.route, []

    def __enter__(self):
        def recording(*a, **k):
            r = self.real(*a, **k)
            self.routes.append(r)
            return r

        self.MOE.route = recording
        return self

    def __exit__(self, *exc):
        self.MOE.route = self.real


def _moe_kernels_vs_plain(dev: torch.device, cfg: dict) -> dict:
    """16a: f32 loss and grads at 4 layers, dropout 0, kernels on against
    off on the same seeded weights and batch; the token-choices whose
    expert or kept/dropped state differ between the runs counted."""
    from fleetx_tpu_torch.models.gpt.model import config_from_dict, init_params
    from fleetx_tpu_torch.tools.train import load_config

    base = MOE_OVERRIDES + SHORT + ["Model.dtype=float32",
                                    "Model.hidden_dropout_prob=0.0",
                                    "Model.attention_probs_dropout_prob=0.0"]
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in next(iter(_train_loader(cfg))).items()}
    params = init_params(config_from_dict(dict(
        load_config(MOE_YAML, base)["Model"])), seed=0, device=dev)
    runs = []
    for on in (True, False):
        with _Routes() as routes:
            loss, grads = _loss_and_grads(
                base + [f"Model.use_flash_attention={on}",
                        f"Model.fused_residual_norm={on}"],
                params, batch, MOE_YAML)
        runs.append((loss, grads, routes.routes))
        torch.cuda.empty_cache()
    (loss_on, g_on, r_on), (loss_off, g_off, r_off) = runs
    flips = sum(int(((a.experts != b.experts) | (a.keep != b.keep)).sum())
                for a, b in zip(r_on, r_off))
    rels = [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
            for a, b in zip(g_on, g_off)]
    loss_tol, grad_tol = MOE_ONOFF_TOL[flips > 0]
    out = dict(layers=4, loss_on=loss_on, loss_off=loss_off,
               loss_diff=abs(loss_on - loss_off),
               max_grad_diff_over_leaf_max=max(rels),
               flipped_token_choices=flips,
               token_choices=sum(int(r.keep.numel()) for r in r_on),
               loss_tol=loss_tol, grad_tol=grad_tol)
    check(len(r_on) == len(r_off) == 4, "one routing per layer")
    check(abs(loss_on - loss_off) <= loss_tol,
          f"MoE f32 loss kernels on {loss_on} vs off {loss_off}")
    check(max(rels) <= grad_tol, f"MoE f32 grads on vs off: {max(rels)}")
    del params, batch, runs, g_on, g_off
    torch.cuda.empty_cache()
    return out


def _moe_train(dev: torch.device, card: str) -> dict:
    """16a: the 8-expert MoE GPT-345M recipe through ``build_trainer`` →
    ``fit`` for 10 steps at full width and depth (counts zeroed just
    before and read just after), an eval pass and greedy generation on
    the trained weights, then kernels on against off at 4 layers."""
    from fleetx_tpu_torch.core.module import GPTGenerationModule
    from fleetx_tpu_torch.data import build_dataloader
    from fleetx_tpu_torch.tools.train import build_trainer, load_config

    cfg = load_config(MOE_YAML, MOE_OVERRIDES)
    cfg["Data"] = load_config(TRAIN_YAML)["Data"]   # phase 4's data
    engine, train_dl, _ = build_trainer(cfg, device=dev)
    mc, glb = engine.module.model_cfg, cfg["Global"]
    check(mc.moe_num_experts == 8 and mc.moe_top_k == 2
          and mc.moe_capacity_factor == 1.25 and mc.moe_aux_weight == 0.01
          and mc.num_layers == 24 and mc.hidden_size == 1024
          and mc.num_attention_heads == 16 and mc.vocab_size == 50304
          and mc.dtype == torch.bfloat16 and not mc.use_recompute
          and mc.use_flash_attention and mc.fused_residual_norm
          and mc.hidden_dropout_prob == 0.1
          and glb["global_batch_size"] == 16 and glb["max_seq_len"] == 1024
          and engine.accumulate_steps == MOE_MICRO_BATCHES
          and engine.module.spec_family == "gpt_moe",
          "not the full-width 8-expert MoE GPT-345M recipe")
    aux: list = []
    step = engine.train_step

    def recorded(batch):
        metrics = step(batch)
        aux.append(metrics["moe_aux"])
        return metrics

    engine.train_step = recorded
    torch.cuda.empty_cache()
    reset_peak(dev)
    zero_counts()                   # every count to 0 just before
    losses = engine.fit(train_dl)
    torch.cuda.synchronize()
    counts = read_counts()          # read just after
    _unpatch(engine, "train_step")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    _check_per_step("moe_train", counts, PER_STEP,
                    MOE_STEPS * MOE_MICRO_BATCHES)
    hist = engine.history
    aux = [float(a) for a in aux]
    check(len(losses) == MOE_STEPS and all(np.isfinite(losses))
          and all(np.isfinite(h["grad_norm"]) for h in hist)
          and all(np.isfinite(aux)), f"moe losses {losses}, aux {aux}")
    expect = float(np.log(mc.vocab_size)
                   + mc.hidden_size * mc.initializer_range ** 2 / 2)
    check(abs(losses[0] - expect) < 0.1,
          f"moe first loss {losses[0]} is not within 0.1 of {expect}")
    # at a perfect balance each layer's aux is aux_weight (E · Σ f·P =
    # 1), so 24 layers sum to 0.24; imbalance only raises it
    check(0.9 * 0.24 < aux[0] < 0.5, f"moe aux at step 1: {aux[0]}")
    step_s = statistics.median(h["train_cost"] for h in hist[1:])
    tokens = glb["global_batch_size"] * glb["max_seq_len"]
    out = dict(steps=MOE_STEPS, losses=losses,
               grad_norms=[h["grad_norm"] for h in hist],
               first_loss=losses[0], expected_first_loss=expect,
               moe_aux=aux, moe_aux_step1=aux[0], moe_aux_step10=aux[-1],
               first_loss_plus_aux=losses[0] + aux[0],
               step_ms_median=step_s * 1e3,
               step_ms=[h["train_cost"] * 1e3 for h in hist],
               tokens_per_s=tokens / step_s,
               params=sum(p.numel() for p in engine._leaves),
               max_memory_allocated_gb=peak_gb, launches=counts,
               launches_per_step={k: counts[k] / MOE_STEPS
                                  for k in PER_STEP}, nvidia_smi=card)
    emit("moe_train", **out)
    # where a step's time goes: 2 unprofiled steps, 2 profiled
    batch = engine.to_device(next(iter(train_dl)))
    fields, share = _trace_window(lambda: engine.train_step(batch), 2,
                                  n_top=16)
    matmul_ms = share("nvjet", "gemm", "cutlass", "sm90_xmma")
    kernels_ms = share("flash_fwd_kernel", "flash_bwd_kernel",
                       "fused_norm_fwd", "fused_norm_bwd_kernel")
    out["trace"] = dict(fields, matmul_ms_per_step=matmul_ms,
                        kernels_ms_per_step=kernels_ms,
                        index_ms_per_step=share("index", "scatter",
                                                "gather", "sort", "scan"),
                        other_ms_per_step=share() - matmul_ms - kernels_ms)
    emit("moe_trace", **out["trace"], nvidia_smi=card)
    del batch

    # an eval pass on samples no step trains on; the routing of its
    # batches gives the dropped share a layer
    eval_data = {"Eval": {"dataset": {"name": "SyntheticGPTDataset",
                                      "num_samples": 16 * MOE_EVAL_BATCHES,
                                      "seed": UNSEEN_SEED}}}
    loader = build_dataloader(eval_data, "Eval",
                              batch_size=glb["global_batch_size"],
                              seq_length=glb["max_seq_len"],
                              vocab_size=mc.vocab_size)
    engine.eval_iters = MOE_EVAL_BATCHES
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _Routes() as routes:
        eval_loss = engine.evaluate(loader)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    layers = mc.num_layers
    check(len(routes.routes) == layers * MOE_EVAL_BATCHES
          and np.isfinite(eval_loss), f"moe eval {eval_loss}")
    dropped = [float(r.dropped_share) for r in routes.routes]
    per_layer = [float(np.mean(dropped[i::layers])) for i in range(layers)]
    out["eval"] = dict(loss=eval_loss, batches=MOE_EVAL_BATCHES,
                       ms_per_batch=eval_s * 1e3 / MOE_EVAL_BATCHES,
                       capacity=routes.routes[0].capacity,
                       dropped_share_layer0=per_layer[0],
                       dropped_share_per_layer=per_layer)
    emit("moe_eval", **out["eval"], nvidia_smi=card)

    # greedy generation of 8 prompts x 32 tokens from the trained weights
    gen_cfg = load_config(MOE_YAML, MOE_OVERRIDES + [
        "Generation.decode_strategy=greedy_search",
        f"Generation.max_dec_len={MOE_GEN_NEW}"])
    module = GPTGenerationModule(gen_cfg)
    prompts = _prompts(7, GEN_PROMPT_LENS, vocab=mc.vocab_size)
    params = engine.params
    del engine
    torch.cuda.empty_cache()
    zero_counts()                   # every count to 0 just before
    with _CountCalls() as calls, _Routes() as routes:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids = module.generate_ids(params, prompts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts_gen = read_counts()      # read just after
    per_call = 2 * layers + 1
    check(counts_gen["fused_norm_fwd"] == per_call * calls.calls,
          f"moe generation: {counts_gen['fused_norm_fwd']} norm launches "
          f"for {calls.calls} model calls")
    check(all(counts_gen[k] == 0 for k in counts_gen
              if k not in ("fused_norm_fwd", ROWS_COUNT)),
          f"moe generation: other kernels launched {counts_gen}")
    check(ids.shape == (len(prompts), MOE_GEN_NEW)
          and int(ids.min()) >= 0 and int(ids.max()) < mc.vocab_size,
          f"moe generation output {ids.shape}")
    decode = routes.routes[layers:]
    out["generation"] = dict(
        prompts=len(prompts), new_tokens=MOE_GEN_NEW,
        model_calls=calls.calls, prefill_ms=calls.prefill_s * 1e3,
        ms_per_decode_step=(wall - calls.prefill_s) * 1e3
        / max(calls.calls - 1, 1),
        decode_capacity=decode[0].capacity if decode else None,
        decode_dropped_share=float(np.mean([float(r.dropped_share)
                                            for r in decode]))
        if decode else None,
        distinct_tokens=int(len(np.unique(ids))),
        fused_norm_fwd_launches=counts_gen["fused_norm_fwd"],
        launches=counts_gen)
    emit("moe_generation", **out["generation"], nvidia_smi=card)
    del params
    torch.cuda.empty_cache()
    out["kernels_vs_plain"] = _moe_kernels_vs_plain(dev, cfg)
    emit("moe_kernels_vs_plain", **out["kernels_vs_plain"], nvidia_smi=card)
    return out


def _imagen_train(dev: torch.device, card: str, root: str) -> dict:
    """16b: Imagen ``base64`` through ``build_trainer`` → ``fit`` for 10
    steps at full width, batch 16, bf16 (counts zeroed just before and
    read just after; the final step saved under ``root``), a 3-step
    trace."""
    from fleetx_tpu_torch.core.checkpoint import latest_step
    from fleetx_tpu_torch.models.imagen import unet as U
    from fleetx_tpu_torch.tools.train import build_trainer, load_config

    ckpt = os.path.join(root, "imagen_base")
    cfg = load_config(IMAGEN_BASE_YAML, IMAGEN_OVERRIDES + [
        f"Engine.save_load.output_dir={ckpt}"])
    engine, train_dl, _ = build_trainer(cfg, device=dev)
    uc, dc, glb = engine.module.model_cfg, engine.module.stage.diff_cfg, \
        cfg["Global"]
    check(type(engine.module).__name__ == "ImagenModule"
          and uc.dim == 128 and uc.dim_mults == (1, 2, 3, 4)
          and uc.cond_dim == 512 and uc.text_embed_dim == 1024
          and uc.dtype == torch.bfloat16 and not uc.lowres_cond
          and dc.timesteps == 1000 and dc.pred_type == "eps"
          and glb["global_batch_size"] == 16
          and engine.accumulate_steps == 1,
          "not the full-width Imagen base64 recipe")
    engine.prepare()
    n_params = sum(p.numel() for p in engine._leaves)
    batch = engine.to_device(next(iter(train_dl)))
    with torch.no_grad():   # the untrained net's output variance
        t = torch.full((glb["global_batch_size"],), 500, device=dev)
        pred = U.efficient_unet(engine.params["unet"], uc, batch["images"],
                                t, batch["text_embeds"], batch["text_mask"])
        out_var = float(pred.float().var())
        del pred
    torch.cuda.empty_cache()
    reset_peak(dev)
    zero_counts()                   # every count to 0 just before
    losses = engine.fit(train_dl)
    torch.cuda.synchronize()
    counts = read_counts()          # read just after
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    _no_launches("imagen_train", counts)
    hist = engine.history
    check(len(losses) == IMAGEN_STEPS and all(np.isfinite(losses))
          and all(np.isfinite(h["grad_norm"]) for h in hist),
          f"imagen losses {losses}")
    # the eps-MSE of an untrained net: about 1 plus its output's variance
    check(0.5 * (1 + out_var) < losses[0] < 1.5 * (1 + out_var),
          f"imagen first loss {losses[0]}, output variance {out_var}")
    check(latest_step(ckpt) == IMAGEN_STEPS, f"no step-10 save in {ckpt}")
    step_s = statistics.median(h["train_cost"] for h in hist[1:])
    out = dict(steps=IMAGEN_STEPS, losses=losses,
               grad_norms=[h["grad_norm"] for h in hist],
               first_loss=losses[0], untrained_output_variance=out_var,
               step_ms_median=step_s * 1e3,
               step_ms=[h["train_cost"] * 1e3 for h in hist],
               images_per_s=glb["global_batch_size"] / step_s,
               params=n_params, max_memory_allocated_gb=peak_gb,
               launches=counts, checkpoint=ckpt, nvidia_smi=card)
    emit("imagen_train", **out)
    fields, share = _trace_window(lambda: engine.train_step(batch), 3,
                                  n_top=10)
    out["trace"] = dict(fields, conv_ms_per_step=share(
        "conv", "implicit", "cudnn", "xmma", "sm90", "nchw", "nhwc"),
        matmul_ms_per_step=share("nvjet", "gemm", "cutlass"))
    emit("imagen_trace", **out["trace"], nvidia_smi=card)
    del engine, batch
    torch.cuda.empty_cache()
    return out


def _imagen_sr256(dev: torch.device, card: str) -> dict:
    """16b's ``sr256`` step: one step at the YAML's batch 8 (counts
    zeroed just before and read just after)."""
    from fleetx_tpu_torch.tools.train import build_trainer, load_config

    sr_cfg = load_config(IMAGEN_SR_YAML, IMAGEN_SR_OVERRIDES)
    engine, train_dl, _ = build_trainer(sr_cfg, device=dev)
    uc, dc = engine.module.model_cfg, engine.module.stage.diff_cfg
    check(uc.lowres_cond and uc.dim_mults == (1, 2, 4, 8)
          and uc.text_embed_dim == 1024 and dc.lowres_noise_aug == 0.1
          and engine.module.stage.lowres_time
          and sr_cfg["Global"]["global_batch_size"] == 8
          and sr_cfg["Data"]["Train"]["dataset"]["lowres_size"] == 64
          and int(sr_cfg["Model"]["image_size"]) == 256,
          "not the full-width Imagen sr256 recipe")
    reset_peak(dev)
    zero_counts()                   # every count to 0 just before
    sr_losses = engine.fit(train_dl)
    torch.cuda.synchronize()
    sr_counts = read_counts()       # read just after
    _no_launches("imagen_sr_train", sr_counts)
    check(len(sr_losses) == 1 and np.isfinite(sr_losses[0])
          and np.isfinite(engine.history[0]["grad_norm"]),
          f"sr256 loss {sr_losses}")
    out = dict(loss=sr_losses[0],
               step_ms=engine.history[0]["train_cost"] * 1e3,
               params=sum(p.numel() for p in engine._leaves),
               max_memory_allocated_gb=torch.cuda.max_memory_allocated(dev)
               / 2 ** 30, launches=sr_counts)
    emit("imagen_sr256_step", **out, nvidia_smi=card)
    del engine
    torch.cuda.empty_cache()
    return out


def _imagen_cascade(dev: torch.device, card: str, ckpt: str) -> dict:
    """16c: ``tasks/imagen/generate.py``'s cascade, base 64² from 16b's
    checkpoint → a seeded SR-256 stage, batch 2, guidance 5.0, dynamic
    thresholding, ``CASCADE_TIMESTEPS`` steps a stage."""
    from fleetx_tpu_torch.tasks.imagen import generate as GEN

    cut = [f"Model.timesteps={CASCADE_TIMESTEPS}"]
    cfg = GEN.load_config(IMAGEN_BASE_YAML, cut + [
        f"Engine.save_load.ckpt_dir={ckpt}",
        f"Generation.batch_size={CASCADE_BATCH}"])
    with _Records() as records:
        stages = [GEN.load_stage(cfg, dev),
                  GEN.load_stage(GEN.load_config(IMAGEN_SR_YAML, cut), dev)]
    check(any("restored params from" in line for line in records.lines),
          "the base stage's params did not come from 16b's checkpoint")
    for module, _ in stages:
        dc = module.stage.diff_cfg
        check(dc.guidance_scale == 5.0 and dc.dynamic_threshold_pct == 0.95
              and dc.timesteps == CASCADE_TIMESTEPS, "not the recipes' CFG")
    rng = np.random.RandomState(int(cfg["Global"]["seed"]))
    width = stages[0][0].model_cfg.text_embed_dim
    size = int(stages[-1][0].model_dict["image_size"])
    check(width == 1024 and size == 256, "not the recipes' cascade")
    text = torch.from_numpy(rng.randn(CASCADE_BATCH, 8, width).astype(
        np.float32)).to(dev)
    mask = torch.ones((CASCADE_BATCH, 8), dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    marks = [time.perf_counter()]

    def on_stage(i, images):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    zero_counts()                   # every count to 0 just before
    torch.cuda.synchronize()
    marks[0] = time.perf_counter()
    images = GEN.sample_cascade(stages, CASCADE_BATCH, text, mask, gen,
                                on_stage=on_stage)
    counts = read_counts()          # read just after
    _no_launches("imagen_cascade", counts)
    check(tuple(images.shape) == (CASCADE_BATCH, size, size, 3)
          and bool(torch.isfinite(images).all())
          and float(images.abs().max()) <= 1.0,
          f"cascade output {tuple(images.shape)}")
    out = dict(timesteps=CASCADE_TIMESTEPS, batch=CASCADE_BATCH,
               guidance_scale=5.0, shape=list(images.shape),
               min=float(images.min()), max=float(images.max()),
               std=float(images.float().std()),
               base_ms_per_denoise_step=(marks[1] - marks[0]) * 1e3
               / CASCADE_TIMESTEPS,
               sr256_ms_per_denoise_step=(marks[2] - marks[1]) * 1e3
               / CASCADE_TIMESTEPS, launches=counts, nvidia_smi=card)
    emit("imagen_cascade", **out)
    del stages, images
    torch.cuda.empty_cache()
    return out


def imagen_child(argv: list) -> int:
    """The process of 16b's base run and 16c, under ``argv[0]``: their
    JSON lines as they run, then one line of both results."""
    torch.backends.cuda.matmul.allow_tf32 = False   # as phase 0 sets
    torch.backends.cudnn.allow_tf32 = False
    dev, card = torch.device("cuda", 0), smi_line()
    imagen = _imagen_train(dev, card, argv[0])
    cascade = _imagen_cascade(dev, card, imagen["checkpoint"])
    print(json.dumps({"imagen": imagen, "cascade": cascade}), flush=True)
    return 0


def phase_families(dev: torch.device, card: str) -> dict:
    """Phase 16: the 8-expert MoE GPT-345M (training, eval, generation),
    Imagen base 64² training, one SR-256 step, and the base → SR-256
    cascade; the base run and the cascade in ``imagen_child``'s process,
    beside the MoE's."""
    root = tempfile.mkdtemp(prefix="chip_smoke_families_")
    logs = (tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+"))
    proc = subprocess.Popen(
        [sys.executable, "-c", CHILD % (REPO, "imagen_child"), root],
        cwd=REPO, stdout=logs[0], stderr=logs[1], text=True,
        env=dict(os.environ, PYTHONPATH=REPO))
    proc.logs = logs
    try:
        moe = _moe_train(dev, card)
        sr256 = _imagen_sr256(dev, card)
        _, stdout, _ = _cli_wait(("imagen_child", proc))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    lines = stdout.strip().splitlines()
    for line in lines[:-1]:             # the child's phase lines
        if line.startswith('{"phase"'):
            print(line, flush=True)
    res = json.loads(lines[-1])
    return {"moe": moe, "imagen": dict(res["imagen"], sr256=sr256),
            "cascade": res["cascade"]}


# --------------------------------------------------------------- phase 17
TELEMETRY_STEPS = 10
#: the profiler window: opened before step index 3, closed after step 6
TELEMETRY_WINDOW = (3, 6)
TELEMETRY_LOGGING = 2
#: the step in turns with phase 4's (with and without the prefetcher):
#: blocks of this many steps a side, each side first in one turn
TELEMETRY_TURNS = 3
TELEMETRY_TURN_STEPS = 6
#: the training loop's spans the phase's trace.json must hold (the
#: prefetcher's producer copies under shard_batch_async, so shard_batch
#: must be absent); the checkpoint spans are the CPU tests'
TELEMETRY_SPANS = ("data_fetch", "shard_batch_async", "train_step",
                   "optimizer_update")
#: kernel name → (row, launches a step at GPT-345M)
TELEMETRY_KERNELS = {
    "flash_fwd_kernel_tc": ("flash_attention_fwd", 24),
    "flash_bwd_kernel_tc": ("flash_attention_bwd_fused", 24),
    "fused_norm_fwd_rows_kernel": ("fused_norm_fwd", 49),
    "fused_norm_bwd_kernel": ("fused_norm_bwd", 49)}
#: sizes of the roofline calibration: a bf16 matmul and a device copy
CALIB_N = 8192
CALIB_COPY_BYTES = 2 ** 30


def _telemetry_overrides(root: str) -> list:
    """The slice's command: ``pretrain_gpt_345M_synthetic.yaml`` with the
    telemetry of ``pretrain_gpt_debug_obs.yaml``, the profiler window, the
    recipe's own prefetch depth, and no save."""
    w0, w1 = TELEMETRY_WINDOW
    return [f"Engine.max_steps={TELEMETRY_STEPS}",
            f"Engine.logging_freq={TELEMETRY_LOGGING}",
            "Engine.prefetch_to_device=2", "Engine.save_load.save_steps=0",
            "Observability.enable=True",
            "Observability.sinks=['jsonl', 'csv', 'prometheus']",
            "Observability.trace.enable=True",
            "Observability.flight.enable=True",
            "Observability.perf.enable=True",
            f"Observability.output_dir={os.path.join(root, 'telemetry')}",
            "Profiler.enable=True", f"Profiler.scheduler=[{w0}, {w1}]",
            f"Profiler.profiler_log={os.path.join(root, 'profiler_log')}"]


def _calibrate(dev: torch.device) -> dict:
    """What this card sustains: a bf16 ``CALIB_N``³ matmul (FLOP/s) and a
    ``CALIB_COPY_BYTES`` device copy (bytes read + written a second),
    each the median of CUDA-event timings."""
    a = torch.randn(CALIB_N, CALIB_N, device=dev, dtype=torch.bfloat16)
    b = torch.randn(CALIB_N, CALIB_N, device=dev, dtype=torch.bfloat16)
    src = torch.empty(CALIB_COPY_BYTES, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    out = {}
    for name, fn, work in (
            ("matmul_flops", lambda: a @ b, 2.0 * CALIB_N ** 3),
            ("hbm_bytes_per_s", lambda: dst.copy_(src),
             2.0 * CALIB_COPY_BYTES)):
        for _ in range(3):
            fn()
        times = []
        for _ in range(10):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        out[name] = work / (statistics.median(times) / 1e3)
    del a, b, src, dst
    torch.cuda.empty_cache()
    return out


def _step_turns(dev: torch.device, tel_engine, tel_dl) -> dict:
    """Phase 4's step (its recipe, telemetry off, the batch through the
    device prefetcher), the same with ``prefetch_to_device: 0`` (the
    batch's pinned copy inside the step, on the compute stream, as before
    the prefetcher) and the telemetry step (the phase's engine, the
    profiler window done), in turns of ``TELEMETRY_TURN_STEPS`` steps, the
    order rotated each turn, all logging every step: the host wall of each
    step after the first of a turn (its fit's start)."""
    from fleetx_tpu_torch.tools.train import build_trainer, load_config

    plain, plain_dl, _ = build_trainer(load_config(TRAIN_YAML, [
        "Engine.max_steps=0", "Engine.logging_freq=1"]), device=dev)
    inline, inline_dl, _ = build_trainer(load_config(TRAIN_YAML, [
        "Engine.max_steps=0", "Engine.logging_freq=1",
        "Engine.prefetch_to_device=0"]), device=dev)
    check(plain.prefetch_to_device == 2 and inline.prefetch_to_device == 0,
          "the prefetch sides")
    tel_engine.profiler.enabled = False
    tel_engine.logging_freq = 1
    sides = [("phase4", plain, plain_dl),
             ("phase4_inline_copy", inline, inline_dl),
             ("telemetry", tel_engine, tel_dl)]
    walls = {name: [] for name, _, _ in sides}
    for turn in range(TELEMETRY_TURNS):
        k = turn % len(sides)
        for name, eng, dl in sides[k:] + sides[:k]:
            eng.max_steps = eng.step + TELEMETRY_TURN_STEPS
            n = len(eng.history)
            eng.fit(dl)
            walls[name].append([h["train_cost"] * 1e3
                                for h in eng.history[n + 1:]])
    del plain, plain_dl, inline, inline_dl, sides
    torch.cuda.empty_cache()
    return {name: dict(ms_per_turn=[statistics.median(t) for t in turns],
                       ms_median=statistics.median(
                           [x for t in turns for x in t]))
            for name, turns in walls.items()}


def _report_tools(root: str, metrics: str, trace_path: str, flight: str,
                  serving: Optional[dict]) -> dict:
    """The four report tools, each as its own process, on the phase's
    outputs: exit codes and the lines each printed."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = {}
    runs = {"metrics_report": [metrics],
            "trace_report": [trace_path, "--top-kernels", "10"],
            "postmortem": [flight]}
    if serving is not None:
        # phase 2's replica snapshot against serving_gpt_345M.yaml's SLO
        stream = os.path.join(root, "serving.jsonl")
        with open(stream, "w") as f:
            f.write(json.dumps(serving) + "\n")
        runs["slo_report"] = [stream, "-c", YAML]
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", f"fleetx_tpu_torch.tools.{name}"] + args,
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for name, args in runs.items()}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=300)
        out[name] = dict(rc=proc.returncode, lines=len(stdout.splitlines()))
        # slo_report: 1 is a verdict (a target breached), not a failure
        ok = proc.returncode == 0 or (name == "slo_report"
                                      and proc.returncode == 1)
        check(ok, f"{name} exited {proc.returncode}: {stderr[-2000:]}")
        if name == "slo_report":
            out[name]["verdict"] = "met" if proc.returncode == 0 \
                else "breach"
    return out


def phase_telemetry(dev: torch.device, card: str, losses4: list,
                    serving: Optional[dict] = None) -> dict:
    """Phase 17: GPT-345M through the trainer with the telemetry on, the
    profiler window over steps 3-6 and the device prefetcher; the files it
    writes, the window's decomposition against the smoke's own trace
    reader, the losses against phase 4's, the step in turns with phase
    4's, the report tools."""
    from fleetx_tpu_torch.observability import perf, schema
    from fleetx_tpu_torch.tools.train import build_trainer, load_config
    from fleetx_tpu_torch.utils.hardware import roofline

    root = tempfile.mkdtemp(prefix="chip_smoke_telemetry_")
    t_phase = time.perf_counter()
    stages = {}

    def stage(name: str) -> None:
        """The phase's wall so far at the end of ``name`` (printed, so a
        run cut by its time limit still shows how far it got)."""
        stages[name] = time.perf_counter() - t_phase
        emit("telemetry_stage", stage=name, seconds=stages[name])

    try:
        calib = _calibrate(dev)
        stage("calibration")
        cfg = load_config(TRAIN_YAML, _telemetry_overrides(root))
        engine, train_dl, valid_dl = build_trainer(cfg, device=dev)
        check(engine.obs.enabled and engine.profiler.enabled
              and engine.prefetch_to_device == 2, "telemetry not on")
        # every step's loss and a copy of its batch, taken on the compute
        # stream where the step reads it (a batch the allocator handed
        # back to the copy stream too early would differ from the host's)
        step_losses, seen = [], []
        train_step = engine.train_step

        def observed(batch):
            seen.append({k: v.clone() for k, v in batch.items()})
            metrics = train_step(batch)
            step_losses.append(metrics["loss"])
            return metrics
        engine.train_step = observed
        reset_peak(dev)
        zero_counts()                   # every count to 0 just before
        t0 = time.perf_counter()
        engine.fit(train_dl, valid_dl)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts = read_counts()          # read just after
        stage("fit")
        _unpatch(engine, "train_step")
        peak = torch.cuda.max_memory_allocated(dev)
        for name, per_step in PER_STEP.items():
            check(counts[name] == per_step * TELEMETRY_STEPS,
                  f"telemetry: {name}: {counts[name]} launches, want "
                  f"{per_step} x {TELEMETRY_STEPS}")
        losses = [float(v) for v in step_losses]
        check(losses == list(losses4),
              f"telemetry losses {losses} are not phase 4's {losses4}")
        host = [engine.module.pretreating_batch(h)
                for h in _host_batches(cfg, TELEMETRY_STEPS)]
        check(len(seen) == TELEMETRY_STEPS and all(
            np.array_equal(s[k].cpu().numpy(), h[k])
            for s, h in zip(seen, host) for k in h),
              "a batch the step read differs from the host batch")
        del seen

        tel = os.path.join(root, "telemetry")
        files = sorted(os.listdir(tel))
        check({"metrics.jsonl", "metrics.csv", "metrics.prom",
               "trace.json", "perf.jsonl"} <= set(files),
              f"telemetry files: {files}")
        n_rec, errors = schema.validate_jsonl(os.path.join(
            tel, "metrics.jsonl"))
        check(errors == [] and n_rec == TELEMETRY_STEPS // TELEMETRY_LOGGING,
              f"metrics.jsonl: {n_rec} records, {errors}")
        with open(os.path.join(tel, "metrics.jsonl")) as f:
            records = [json.loads(l) for l in f]
        for r in records:
            check(r["tokens_per_sec"] and r["mfu"]
                  and r["hbm_stats"] == "ok", f"record {r}")
        hbm_peak = records[-1]["hbm_peak_bytes"]
        check(abs(hbm_peak - peak) <= 0.01 * peak,
              f"hbm_peak_bytes {hbm_peak} vs max_memory_allocated {peak}")
        with open(os.path.join(tel, "trace.json")) as f:
            spans = json.load(f)
        check(schema.chrome_trace_errors(spans) == [], "trace.json invalid")
        names = {e["name"] for e in spans["traceEvents"]}
        check(set(TELEMETRY_SPANS) <= names and "shard_batch" not in names,
              f"trace.json spans {sorted(names)}")
        with open(os.path.join(tel, "perf.jsonl")) as f:
            reports = [json.loads(l) for l in f]
        check(len(reports) == 1, f"{len(reports)} perf.jsonl reports")
        report = reports[0]
        w0, w1 = TELEMETRY_WINDOW
        n_steps = report["n_steps"]
        check(n_steps == w1 - w0, f"the window holds {n_steps} steps")
        phases = report["phases"]
        check(phases["fwd_scan"]["layers"] == 24
              and phases["bwd_scan"]["layers"] == 24,
              f"layers {phases['fwd_scan'].get('layers')} / "
              f"{phases['bwd_scan'].get('layers')}")
        # the card's flash kernels name their direction, and the 345M
        # recipe recomputes nothing: no forward flash in the backward
        check(phases["bwd_scan"].get("flash_recompute_ms_per_step") == 0.0,
              f"bwd_scan {phases['bwd_scan']}")
        cats = report["categories_ms_per_step"]
        total = sum(cats.values()) + report["host_gap_ms_per_step"]
        check(abs(total - report["step_ms"]) <= 0.01 * report["step_ms"],
              f"categories + host gap {total} vs step {report['step_ms']}")
        stage("files")

        # every kernel of the window by name, from the same trace
        trace_path = engine.profiler.trace_path
        full = perf.decompose(trace_path, top_kernels=10 ** 6)
        stage("decompose")
        with open(trace_path) as f:
            kineto = json.load(f)["traceEvents"]
        window_launches = {}
        for kernel, (row, per_step) in TELEMETRY_KERNELS.items():
            hits = [k for k in full["top_kernels"] if kernel in k["name"]]
            n = sum(k["launches_per_step"] for k in hits)
            window_launches[row] = n
            if n != per_step:
                # where the others are: the trace's own count of the name,
                # and the steps' device spans
                in_trace = sum(1 for e in kineto if e.get("cat") == "kernel"
                               and kernel in e.get("name", ""))
                spans = perf._device_timeline(
                    {"traceEvents": kineto})["steps"]
                raise RuntimeError(
                    f"chip_smoke check failed: {kernel}: {n} launches a "
                    f"step in the window, want {per_step}; {in_trace} in "
                    f"the trace; steps {spans}")
            check(all(k["category"] == ("flash" if "flash" in kernel
                                        else "fused_norm") for k in hits),
                  f"{kernel} classified {[k['category'] for k in hits]}")
        # the report's kernel ms against the smoke's own reader
        rows = _trace_rows(engine.profiler.profile)
        stage("trace_rows")
        reader = {cat: sum(us for k, us in rows if marker in k) / 1e3
                  / n_steps for cat, marker in (("flash", "flash"),
                                                ("fused_norm", "fused_norm"))}
        for cat, ms in reader.items():
            check(abs(cats[cat] - ms) <= 0.01 * ms,
                  f"{cat}: report {cats[cat]} ms a step, _trace_rows {ms}")
        # the batch's host-to-device copies on the prefetcher's stream
        busy = {}
        for e in kineto:
            if e.get("cat") == "kernel":
                busy[e.get("tid")] = busy.get(e.get("tid"), 0.0) + \
                    e.get("dur", 0.0)
        compute = max(busy, key=lambda t: busy[t])
        h2d = [e for e in kineto if e.get("cat") == "gpu_memcpy"
               and "HtoD" in e.get("name", "")]
        side = [e for e in h2d if e.get("tid") != compute]
        check(len(side) >= 4, f"{len(side)} host-to-device copies off the "
                              f"compute stream (stream {compute})")
        del kineto

        engine.obs.flight_dump("telemetry_phase")
        engine.obs.flush()
        tools = _report_tools(root, os.path.join(tel, "metrics.jsonl"),
                              trace_path, os.path.join(tel, "flight"),
                              serving)
        stage("report_tools")
        turns = _step_turns(dev, engine, train_dl)
        stage("turns")
        gap = report["mfu_gap"]
        out = dict(
            steps=TELEMETRY_STEPS, window=list(TELEMETRY_WINDOW),
            fit_s=fit_s, losses=losses, losses_equal_phase4=True,
            launches=counts, window_launches_per_step=window_launches,
            records=len(records), files=files,
            tokens_per_sec=[r["tokens_per_sec"] for r in records],
            mfu=[r["mfu"] for r in records],
            step_time_ms=[r["step_time"] * 1e3 for r in records],
            data_stall_frac=[r["data_stall_frac"] for r in records],
            hbm_peak_bytes=hbm_peak, max_memory_allocated=peak,
            hbm_model_error=records[-1]["hbm_model_error"],
            step_ms=report["step_ms"],
            host_gap_ms_per_step=report["host_gap_ms_per_step"],
            categories_ms_per_step=cats,
            categories_launches_per_step=report[
                "categories_launches_per_step"],
            phases={k: {kk: v[kk] for kk in ("ms_per_step", "layers",
                                             "ms_per_layer",
                                             "flash_passes_per_layer",
                                             "flash_recompute_ms_per_step")
                        if kk in v} for k, v in phases.items()},
            reader_ms_per_step=reader, top_kernels=full["top_kernels"][:10],
            mfu_gap={k: gap[k] for k in ("ideal_step_ms", "gap_ms", "mfu",
                                         "accounted_ms")},
            contributors=[[c["name"], c["ms_per_step"]]
                          for c in gap["contributors"]],
            h2d_side_stream_copies=len(side), h2d_copies=len(h2d),
            roofline=roofline(torch.cuda.get_device_name(dev)),
            calibration=calib, turns=turns, tools=tools,
            trace_bytes=os.path.getsize(trace_path), stage_seconds=stages,
            nvidia_smi=card)
        emit("telemetry", **out)
        del engine, train_dl, valid_dl
        torch.cuda.empty_cache()
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


# -------------------------------------------------------------- phase 18
#: phase 4's recipe under the resilience runtime: the SDC sentinel every
#: 2nd step with action abort (a false positive on healthy hardware fails
#: the phase), one asynchronous save at step 5 whose write overlaps steps
#: 6-8, 8 steps
SDC_STEPS = 8
SDC_EVERY = 2
SDC_SAVE_AT = 5
SDC_OVERRIDES = ["Resilience.enable=True",
                 f"Resilience.integrity.sentinel_every={SDC_EVERY}",
                 "Resilience.integrity.sentinel_action=abort",
                 "Engine.save_load.async_save=True",
                 f"Engine.save_load.save_steps={SDC_SAVE_AT}",
                 f"Engine.max_steps={SDC_STEPS}", "Engine.logging_freq=1"]


def _preflight_children(root: str) -> dict:
    """The selftest on the card and the supervisor's preflight forced to
    fail, each its own process (``_cli_wait`` collects them)."""
    marker = os.path.join(root, "preflight_child_ran")
    env = dict(os.environ, PYTHONPATH=REPO, FLEETX_SELFTEST_FORCE_FAIL="*")
    return {"selftest": _cli_start("resilience.integrity", ["--selftest"]),
            "marker": marker,
            "preflight": subprocess.Popen(
                [sys.executable, "-m", "fleetx_tpu_torch.tools.supervise",
                 "--preflight", "--max-restart", "0", "--",
                 sys.executable, "-c", f"open({marker!r}, 'w').write('x')"],
                cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True, env=env)}


def phase_resilience_runtime(dev: torch.device, card: str, losses4: list,
                             sync_save_s: Optional[list]) -> dict:
    """Phase 18: phase 4's recipe with the SDC sentinel (every 2nd step,
    abort) and one asynchronous save (step 5); the losses against phase
    4's, the launches of 8 steps and 4 replays, the save's stall, overlap
    and finalize wait beside phase 8's synchronous save, the payload
    against the state at step 5, the fingerprint on the card against the
    CPU's and the bit-flip drill, the selftest on the card and the
    preflight's refusal."""
    from fleetx_tpu_torch.convert import jax_leaves
    from fleetx_tpu_torch.core import checkpoint as C
    from fleetx_tpu_torch.observability.metrics import get_registry
    from fleetx_tpu_torch.resilience import integrity
    from fleetx_tpu_torch.resilience.integrity import params_fingerprint
    from fleetx_tpu_torch.tools import verify_ckpt
    from fleetx_tpu_torch.tools.train import build_trainer, load_config

    root = tempfile.mkdtemp(prefix="chip_smoke_sdc_")
    try:
        free = shutil.disk_usage(root).free
        check(free >= CKPT_MIN_FREE_BYTES,
              f"{root} has {free / 1e9:.1f} GB free; the 345M checkpoint "
              f"needs {CKPT_MIN_FREE_BYTES / 1e9:.0f} GB")
        out = os.path.join(root, "ckpt")
        cfg = load_config(TRAIN_YAML, SDC_OVERRIDES
                          + [f"Engine.save_load.output_dir={out}"])
        engine, dl, _ = build_trainer(cfg, device=dev)
        mc = engine.module.model_cfg
        res = engine.resilience
        check(mc.num_layers == 24 and mc.hidden_size == 1024
              and mc.num_attention_heads == 16 and mc.vocab_size == 50304
              and mc.dtype == torch.bfloat16
              and cfg["Global"]["max_seq_len"] == 1024
              and cfg["Global"]["global_batch_size"] == 8
              and engine.async_save and res.sentinel_every == SDC_EVERY
              and res.sentinel_action == "abort",
              "not phase 4's recipe with the sentinel and async saves")
        # the host instrumentation: each step's start, each check's wall
        # (the card drained around it), the snapshot's wall and a clone on
        # the card of the live state as the save returns (step 6 has not
        # started: it is still step 5's; digested after the fit, apart
        # from the writer's copy), and each finalize's start and wait
        starts, check_s, snap, finals = [], [], {}, []
        step_fn, check_fn, save_fn = (engine.train_step, engine._sdc_check,
                                      engine.save)
        finalize = C.finalize_async_saves
        # the compute stream alone: a device-wide synchronize would also
        # wait for the writer's copy on its own stream
        drain = torch.cuda.current_stream(dev).synchronize

        def train_step(batch):
            starts.append(time.perf_counter())
            return step_fn(batch)

        def sdc_check(*a):
            drain()
            t0 = time.perf_counter()
            out_ = check_fn(*a)
            drain()
            check_s.append(time.perf_counter() - t0)
            return out_

        def save():
            drain()
            t0 = time.perf_counter()
            path = save_fn()
            drain()
            t1 = time.perf_counter()
            with torch.no_grad():
                snap["state"] = {k: v.detach().clone() if torch.is_tensor(v)
                                 else v for k, v in engine.state_dict().items()}
            drain()
            snap["bytes"] = _state_bytes(snap["state"])
            snap["snapshot_s"] = t1 - t0
            snap["clone_s"] = time.perf_counter() - t1
            return path

        def timed_finalize():
            t0 = time.perf_counter()
            pending = len(C._pending)
            finalize()
            finals.append((t0, time.perf_counter() - t0, pending))

        engine.train_step, engine._sdc_check, engine.save = (
            train_step, sdc_check, save)
        C.finalize_async_saves = timed_finalize
        reg = get_registry()
        before = {k: reg.counter(k).value for k in (
            "sdc_checks_total", "sdc_replay_mismatches", "ckpt_failed_total")}
        reset_peak(dev)
        zero_counts()                   # every count to 0 just before
        try:
            losses = engine.fit(dl)
        finally:
            C.finalize_async_saves = finalize
            _unpatch(engine, "train_step", "_sdc_check", "save")
        torch.cuda.synchronize()
        counts = read_counts()          # read just after
        moved = {k: reg.counter(k).value - v for k, v in before.items()}
        peak_gb = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        children = _preflight_children(root)
        runs = SDC_STEPS + SDC_STEPS // SDC_EVERY
        for name, per_step in PER_STEP.items():
            check(counts[name] == per_step * runs,
                  f"sentinel: {name} {counts[name]} launches, want "
                  f"{per_step} x ({SDC_STEPS} steps + "
                  f"{SDC_STEPS // SDC_EVERY} replays)")
        check(moved["sdc_checks_total"] == SDC_STEPS // SDC_EVERY
              and moved["sdc_replay_mismatches"] == 0
              and moved["ckpt_failed_total"] == 0,
              f"sentinel counters {moved}")
        check(losses == losses4[:SDC_STEPS],
              f"losses {losses} vs phase 4's {losses4[:SDC_STEPS]}")
        # the steps' host walls: step k from its start to the next's
        # (the last to fit's finalize), each ending in its loss sync;
        # steps 2, 4, 6, 8 carry a check, step 5 the save
        fit_end = [t for t, _, pending in finals if pending][-1]
        walls = [b - a for a, b in zip(starts, starts[1:] + [fit_end])]
        check(len(walls) == SDC_STEPS, f"{len(walls)} steps timed")
        plain = statistics.median([walls[2], walls[6]])  # steps 3 and 7
        stall = walls[SDC_SAVE_AT - 1] - snap["clone_s"] - plain
        finalize_wait = [w for t, w, pending in finals
                         if pending and t == fit_end][0]
        check(C.completed_steps(out) == [SDC_SAVE_AT],
              f"steps saved: {C.completed_steps(out)}")
        # the crc32 of the state at the save on a thread of its own (zlib
        # releases the lock) while the audit digests the payload
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            crc = pool.submit(lambda: [
                integrity.digest_array(C._to_host(v)[0])["crc32"]
                for v in snap["state"].values()])
            audit = verify_ckpt.audit_directory(out)
            snap["crc"] = crc.result()
        snap["names"] = list(snap.pop("state"))
        statuses = [r["status"] for r in audit["steps"]]
        check(statuses == ["ok"], f"audit {statuses}")
        # the payload is the state at step 5: the audit held every leaf's
        # bytes to the manifest's digests (the writer's, from its copy),
        # and those equal the crc32s of the phase's own copy
        path = C.step_dir(out, SDC_SAVE_AT)
        manifest = integrity.read_manifest(path)
        with open(os.path.join(path, C.META_NAME)) as f:
            meta = json.load(f)
        with np.load(os.path.join(path, C.STATE_NAME)) as data:
            names = [str(n) for n in data["__names__"]]
        check(names == snap["names"], "payload leaf names")
        bad = [n for n, d, c in zip(names, manifest["leaves"], snap["crc"])
               if int(d["crc32"]) != c]
        check(not bad and len(manifest["leaves"]) == len(names),
              f"payload leaves differ from the state at step "
              f"{SDC_SAVE_AT}: {bad}")
        check(meta["step"] == SDC_SAVE_AT
              and meta["consumed_samples"] == SDC_SAVE_AT * 8,
              f"meta {meta}")
        # the fingerprint of the final params on the card and on the CPU,
        # and the bit-flip drill (flip, then flip back)
        leaves = jax_leaves(engine.params)
        fp_card = params_fingerprint(leaves)
        t0 = time.perf_counter()
        fp_cpu = params_fingerprint([p.detach().cpu() for p in leaves])
        cpu_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params_fingerprint(leaves)
        card_s = time.perf_counter() - t0
        engine._apply_bitflip()
        fp_flipped = params_fingerprint(leaves)
        engine._apply_bitflip()
        fp_back = params_fingerprint(leaves)
        check(fp_card == fp_cpu, f"fingerprint card {fp_card} != CPU "
                                 f"{fp_cpu}")
        check(fp_flipped != fp_card and fp_back == fp_card,
              f"bit-flip: {fp_card} -> {fp_flipped} -> {fp_back}")
        # the preflight: the selftest ok on the card, and the forced
        # failure refused with 41 before the command ran
        selftest = _cli_wait(children["selftest"])[0][-1]
        check(selftest["ok"] and selftest["compute_ok"]
              and selftest["device"].startswith("cuda"),
              f"selftest {selftest}")
        proc = children["preflight"]
        try:
            _, err = proc.communicate(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        check(proc.returncode == 41
              and "preflight FAILED for gang member 0" in err
              and not os.path.exists(children["marker"]),
              f"preflight exit {proc.returncode}: {err[-2000:]}")
        del engine, leaves
        result = dict(
            steps=SDC_STEPS, losses=losses, bitwise_phase4=True,
            sdc_checks=moved["sdc_checks_total"],
            sdc_replay_mismatches=moved["sdc_replay_mismatches"],
            sentinel_check_ms=[t * 1e3 for t in check_s],
            sentinel_check_ms_median=statistics.median(check_s) * 1e3,
            step_ms=[w * 1e3 for w in walls],
            step_ms_plain_median=plain * 1e3,
            launches=counts, launches_runs=runs,
            async_save=dict(
                step=SDC_SAVE_AT, state_gb=snap["bytes"] / 1e9,
                snapshot_device_gb=snap["bytes"] / 1e9,
                snapshot_ms=snap["snapshot_s"] * 1e3,
                stall_s=stall, stall_step_ms=walls[SDC_SAVE_AT - 1] * 1e3,
                clone_s_excluded=snap["clone_s"],
                overlap_step_ms_median=statistics.median(walls[5:8]) * 1e3,
                before_step_ms_median=statistics.median(walls[1:4]) * 1e3,
                finalize_wait_s=finalize_wait,
                sync_save_s_phase8=sync_save_s,
                completed_steps=[SDC_SAVE_AT], audit=statuses,
                payload_equals_step_state=True, leaves=len(names)),
            fingerprint=dict(card=fp_card, cpu=fp_cpu, flipped=fp_flipped,
                             restored=fp_back, card_s=card_s, cpu_s=cpu_s),
            selftest=selftest, preflight_exit=proc.returncode,
            peak_memory_gb=peak_gb, nvidia_smi=card)
        emit("resilience_runtime", **result)
        return result
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


# -------------------------------------------------------------- phase 19
#: 19a: the router's hedge delay (``Serving.router.hedge_ms``) and the
#: extra ms a work step of the straggler (the fault plan's
#: ``slow_decode_ms_at``): phase 2's requests take the straggler over 6 s
#: (1 + 32 steps or more at 200 ms), so the router hedges them, and a
#: healthy 4-layer replica answers well inside the delay, so a request
#: torn by 19b's crash is re-dispatched, not won by a hedge
ROUTER_HEDGE_MS = 1500.0
STRAGGLER_MS = 200
#: the ``Serving.router`` block of 19a's router and the fleet's: the
#: recipe's knobs with its timeouts cut to the smoke's scale
ROUTER_BLOCK = dict(penalty_s=0.5, dispatch_deadline_s=120.0,
                    verb_timeout_s=1.0, request_timeout_s=60.0,
                    hedge_ms=ROUTER_HEDGE_MS, retry_budget=8,
                    probe_interval_s=0.2, breaker_threshold=1)
#: 19b: replicas under the elastic supervisor, the burst (phase 2's
#: prompts three times), the requests that run the restarted replica's
#: half-open trial, and every wait's bound
FLEET_SIZE = 3
FLEET_BURST = 3 * len(SERVE_PROMPT_LENS)
FLEET_NUDGE = 4
FLEET_TIMEOUT_S = 240
#: new tokens of a member's direct warm-up (9 work steps: 1.8 s on the
#: straggler)
WARM_NEW = 8
#: 19b's chaos by supervisor member, the shapes of the JAX acceptance
#: drill (``tests/test_zz_chaos_serving.py:409``): a straggler, a replica
#: that goes silent after 4 responses (the warm-up's and 3 routed), and
#: one that tears its 3rd response and exits (armed in its first run
#: only, so the supervisor's restart serves)
FLEET_FAULTS = {0: f"slow_decode_ms_at=0:{STRAGGLER_MS}",
                1: "blackhole_after=4", 2: "crash_mid_write=3"}
#: 19c: the docs corpus in shards, each preprocessed by its own process,
#: and the steps phase 4's recipe trains on their blend (at FT_LR: the
#: recipe's warmup would hold the LR under 3e-7 for 20 steps)
CORPUS_SHARDS = 2
CORPUS_STEPS = 20

#: the member launcher the supervisor runs: reads its member id, arms that
#: member's fault (the crash in its first run only) and execs the replica
#: on the fleet's stable base port (the replica adds its member id)
FLEET_MEMBER = '''import os, sys
rank = int(os.environ.get("FLEETX_PROCESS_ID", "0"))
spec = {faults!r}.get(rank, "")
marker = os.path.join({root!r}, "armed%d" % rank)
if "crash_mid_write" in spec:
    if os.path.exists(marker):
        spec = ""
    else:
        open(marker, "w").close()
os.environ["FLEETX_FAULTS"] = spec
os.execv(sys.executable, [sys.executable, "-m",
                          "fleetx_tpu_torch.tools.serve"] + {argv!r} + [
    "--ready-file", os.path.join({root!r}, "ready%d.json" % rank)])
'''


def _replica_overrides(ckpt_dir: str) -> list:
    """The serving recipe on phase 8's cut checkpoint, with 19's router
    block."""
    return [f"Serving.ckpt_dir={ckpt_dir}", *CUT_DEPTH] + [
        f"Serving.router.{k}={v}" for k, v in ROUTER_BLOCK.items()]


def _ask_all(port: int, prompts: list, prefix: str,
             timeout: float = FLEET_TIMEOUT_S) -> tuple:
    """Every prompt at once over TCP (``SERVE_MAX_NEW`` new tokens each):
    (responses, the exceptions of requests that got none, the wall)."""
    from fleetx_tpu_torch.serving.server import request

    responses = [None] * len(prompts)
    lost = []

    def ask(i):
        try:
            responses[i] = request(
                ("127.0.0.1", port), {"id": f"{prefix}{i}",
                                      "prompt": prompts[i],
                                      "max_new_tokens": SERVE_MAX_NEW},
                timeout=timeout)
        except (OSError, ValueError) as e:
            lost.append((i, repr(e)))

    threads = [threading.Thread(target=ask, args=(i,))
               for i in range(len(prompts))]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout + 30)
    check(not any(t.is_alive() for t in threads), f"{prefix}: a request "
                                                     f"thread hung")
    return responses, lost, time.monotonic() - t0


def _count_decode_steps(engine, counts: list, i: int) -> None:
    """Count ``engine``'s decode steps that ran into ``counts[i]`` (each
    engine's loop thread writes only its own entry; ``_unpatch`` after)."""
    inner = engine._decode_step

    def counted() -> bool:
        ran = inner()
        if ran:
            counts[i] += 1
        return ran

    engine._decode_step = counted


def _router_in_process(dev: torch.device, card: str, ckpt_dir: str) -> dict:
    """19a: the port's ``Router`` in front of two in-process replicas on
    the card (phase 8's cut checkpoint through ``tools.serve``'s config and
    ``build_engine``), the second a straggler; phase 2's requests through
    the router against the first replica asked directly, row 7's launches
    against both engines' decode steps."""
    from fleetx_tpu_torch.resilience.faults import FaultPlan
    from fleetx_tpu_torch.serving.router import Router, RouterConfig
    from fleetx_tpu_torch.serving.server import ReplicaServer
    from fleetx_tpu_torch.tools.serve import build_engine, load_config

    cfg = load_config(YAML, _replica_overrides(ckpt_dir))
    engines = [build_engine(cfg, device=dev) for _ in range(2)]
    mc = engines[0].cfg
    check(mc.num_layers == CUT_LAYERS and mc.hidden_size == 1024
          and mc.num_attention_heads == 16 and mc.vocab_size == 50304
          and mc.dtype == torch.bfloat16
          and all(e.paged_kernel_active for e in engines),
          "19a: not the full-width 345M replica on the paged kernel")
    prompts = _prompts(2, SERVE_PROMPT_LENS)
    steps = [0, 0]
    for i, eng in enumerate(engines):
        eng.submit(_prompts(1, [8])[0], 2, request_id="warmup")
        eng.run_until_drained()
        _count_decode_steps(eng, steps, i)
    servers = [ReplicaServer(engines[0]), ReplicaServer(
        engines[1], fault_plan=FaultPlan(slow_decode_ms_at=[0, STRAGGLER_MS]))]
    stops = [_Stop() for _ in servers]
    ports = [s.start() for s in servers]
    loops = [threading.Thread(target=s.run, kwargs=dict(preemption=st),
                              daemon=True, name="chip-smoke-replica")
             for s, st in zip(servers, stops)]
    for t in loops:
        t.start()
    router = Router([("127.0.0.1", p) for p in ports],
                    config=RouterConfig(**ROUTER_BLOCK))
    try:
        direct, lost, _ = _ask_all(ports[0], prompts, "d")
        check(not lost and all(r and r.get("tokens") for r in direct),
              f"19a: direct answers {direct} {lost}")
        rport = router.start()
        zero_counts()                 # every count to 0 just before
        steps[:] = [0, 0]
        routed, lost, wall = _ask_all(rport, prompts, "r")
        counters = router.router_counters()
        # the hedge losers' slots drain (their cancel lands at a step
        # boundary), then both loops stop
        deadline = time.monotonic() + 60
        while any(e.has_work() for e in engines):
            check(time.monotonic() < deadline, "19a: engines never idled")
            time.sleep(0.01)
    finally:
        router.close()
        for st in stops:
            st.set()
        for t in loops:
            t.join(timeout=60)
        for s in servers:
            s.close()
        for e in engines:
            _unpatch(e, "_decode_step")
    counts = read_counts()            # read just after
    check(not any(t.is_alive() for t in loops), "19a: a replica loop hung")
    check(not lost, f"19a: requests lost through the router: {lost}")
    for i, (got, want) in enumerate(zip(routed, direct)):
        check(got.get("tokens") == want["tokens"],
              f"19a: request {i} through the router {got} != the direct "
              f"answer {want['tokens']}")
    launches = counts["paged_attention_decode"]
    check(launches == CUT_LAYERS * sum(steps),
          f"19a: {launches} row 7 launches != {CUT_LAYERS} x {steps} "
          f"decode steps")
    check(counters["hedges_total"] >= 1
          and counters["hedge_cancels_total"] >= 1
          and counters["completed_total"] == len(prompts),
          f"19a: router counters {counters}")
    tokens = sum(len(r["tokens"]) for r in routed)
    out = dict(requests=len(prompts), max_new_tokens=SERVE_MAX_NEW,
               layers=CUT_LAYERS, tokens=tokens, wall_s=wall,
               tokens_per_s=tokens / wall, decode_steps=steps,
               kernel_launches=launches, router_counters=counters,
               straggler_ms_per_step=STRAGGLER_MS, hedge_ms=ROUTER_HEDGE_MS,
               identical_to_direct=True, nvidia_smi=card)
    emit("router_in_process", **out)
    del engines, servers
    torch.cuda.empty_cache()
    return dict(out, direct={tuple(p): r["tokens"]
                             for p, r in zip(prompts, direct)})


def _free_port_base(n: int) -> int:
    """A base port with ``n`` consecutive free ports (the supervisor's
    member offset needs a stable range; ``tests/test_zz_chaos_serving.py``
    ``_free_port_base``)."""
    import socket

    for _ in range(50):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            base = s.getsockname()[1]
        if base + n >= 65535:
            continue
        probes = []
        try:
            for i in range(n):
                p = socket.socket()
                p.bind(("127.0.0.1", base + i))
                probes.append(p)
            return base
        except OSError:
            continue
        finally:
            for p in probes:
                p.close()
    raise RuntimeError("no contiguous free port range")


def _fleet_start(root: str, ckpt_dir: str) -> dict:
    """19b's fleet: ``tools.supervise --elastic`` over ``FLEET_SIZE``
    replica processes on this card, started together; returns its
    handle (the supervisor's process, paths, base port)."""
    fleet_root = os.path.join(root, "fleet")
    os.makedirs(fleet_root, exist_ok=True)
    base = _free_port_base(FLEET_SIZE)
    argv = ["-c", YAML] + _overrides(_replica_overrides(ckpt_dir)) + [
        "--port", str(base), "--preemption-code", "75"]
    member = os.path.join(fleet_root, "member.py")
    with open(member, "w") as f:
        f.write(FLEET_MEMBER.format(faults=FLEET_FAULTS, root=fleet_root,
                                    argv=argv))
    events = os.path.join(fleet_root, "events.jsonl")
    sup = subprocess.Popen(
        [sys.executable, "-m", "fleetx_tpu_torch.tools.supervise",
         "--elastic", "--num-procs", str(FLEET_SIZE), "--min-healthy", "2",
         "--max-restart", "4", "--backoff", "0.2", "--grace", "15",
         "--gate-timeout", "300", "--preemption-code", "75",
         "--events-out", events,
         "--flight-dir", os.path.join(fleet_root, "flight"), "--",
         sys.executable, member],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    return dict(sup=sup, root=fleet_root, base=base, events=events,
                fleet_out=os.path.join(fleet_root, "fleet.jsonl"),
                router=None, t0=time.monotonic())


def _fleet_ready(fleet: dict, rank: int, not_pid: Optional[int] = None,
                 deadline: Optional[float] = None) -> dict:
    """Member ``rank``'s ready file (``{pid, port}``), waiting for one
    whose pid is not ``not_pid`` (a restart's)."""
    path = os.path.join(fleet["root"], f"ready{rank}.json")
    deadline = deadline or time.monotonic() + FLEET_TIMEOUT_S
    while True:
        check(fleet["sup"].poll() is None,
              f"19b: the supervisor exited {fleet['sup'].returncode}")
        check(time.monotonic() < deadline, f"19b: {path} never appeared")
        try:
            with open(path) as f:
                info = json.load(f)
            if info.get("pid") != not_pid:
                return info
        except (OSError, ValueError):
            pass                      # not there yet, or a torn write
        time.sleep(0.1)


def _fleet_events(fleet: dict) -> list:
    try:
        with open(fleet["events"]) as f:
            return [json.loads(x) for x in f.read().splitlines()
                    if x.strip()]
    except OSError:
        return []


def _fleet_records(fleet: dict) -> list:
    try:
        with open(fleet["fleet_out"]) as f:
            return [json.loads(x) for x in f.read().splitlines()
                    if x.strip()]
    except OSError:
        return []


def _fleet_stop(fleet: dict) -> None:
    """Stop the router and the supervisor (which drains its members);
    a supervisor that outlives its grace is killed, and then the members
    named in the ready files too."""
    procs = [p for p in (fleet.get("router"), fleet["sup"]) if p is not None]
    for proc in procs:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
    killed = False
    for proc in procs:
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
            killed = proc is fleet["sup"]
    for rank in range(FLEET_SIZE if killed else 0):
        try:
            with open(os.path.join(fleet["root"], f"ready{rank}.json")) as f:
                os.kill(int(json.load(f)["pid"]), signal.SIGKILL)
        except (OSError, ValueError, KeyError):
            pass                      # gone already: the usual case
    if fleet.get("router") is not None and fleet["router"].stdout:
        fleet["router"].stdout.close()


def _fleet_drive(card: str, fleet: dict, direct: dict) -> dict:
    """19b: warm each member directly, start ``tools.serve --router`` over
    them, send the burst, see the crashed member restarted, run its
    half-open trial, and read the fleet records, the supervisor's events
    and a re-dispatched request's merged trace."""
    from fleetx_tpu_torch.observability.schema import validate_fleet_record
    from fleetx_tpu_torch.serving.server import request

    prompts = _prompts(2, SERVE_PROMPT_LENS)
    warm_prompt = _prompts(1, [8])[0]
    deadline = time.monotonic() + FLEET_TIMEOUT_S
    infos = [_fleet_ready(fleet, r, deadline=deadline)
             for r in range(FLEET_SIZE)]
    boot_s = time.monotonic() - fleet["t0"]
    base = fleet["base"]
    check([i["port"] for i in infos] == [base + r for r in range(FLEET_SIZE)],
          f"19b: member ports {infos}")
    # each member warmed directly (its first request pays first-call
    # allocations), all at once: three identical greedy answers are the
    # members' own parity check
    warm = [None] * FLEET_SIZE

    def warm_one(r: int) -> None:
        warm[r] = request(("127.0.0.1", base + r),
                          {"id": f"warm{r}", "prompt": warm_prompt,
                           "max_new_tokens": WARM_NEW},
                          timeout=FLEET_TIMEOUT_S)

    threads = [threading.Thread(target=warm_one, args=(r,))
               for r in range(FLEET_SIZE)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=FLEET_TIMEOUT_S + 30)
    check(all(w is not None and w.get("tokens") == warm[0]["tokens"]
              for w in warm), f"19b: the members' warm answers: {warm}")
    router = subprocess.Popen(
        [sys.executable, "-m", "fleetx_tpu_torch.tools.serve", "--router",
         "-c", YAML] + _overrides([f"Serving.router.{k}={v}"
                                   for k, v in ROUTER_BLOCK.items()])
        + ["--port", "0", "--backends",
           ",".join(f"127.0.0.1:{base + r}" for r in range(FLEET_SIZE)),
           "--fleet-out", fleet["fleet_out"], "--poll-interval", "0.25"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fleet["router"] = router
    t_router = time.monotonic()
    line = router.stdout.readline()
    router_start_s = time.monotonic() - t_router
    check("listening on" in line, f"19b: the router said {line!r}")
    rport = int(line.split(":")[-1].split()[0])

    burst = [prompts[k % len(prompts)] for k in range(FLEET_BURST)]
    answers, lost, wall = _ask_all(rport, burst, "b")
    check(not lost, f"19b: requests lost (no answer at all): {lost}")
    completed, refused = 0, []
    for k, resp in enumerate(answers):
        if resp.get("tokens"):
            check(resp["tokens"] == direct[tuple(burst[k])],
                  f"19b: b{k}'s tokens differ from 19a's direct answer")
            completed += 1
        else:
            check(bool(resp.get("error")), f"19b: b{k} got {resp}")
            refused.append(resp["error"])
    check(completed >= FLEET_BURST // 2,
          f"19b: {completed} of {FLEET_BURST} completed: {refused}")
    tokens = sum(len(r["tokens"]) for r in answers if r.get("tokens"))

    # the crashed member: restarted by the supervisor alone, warmed, then
    # its breaker's half-open trial closes it
    restart_deadline = time.monotonic() + FLEET_TIMEOUT_S
    while not any(e["event"] == "restart" and e["member"] == 2
                  for e in _fleet_events(fleet)):
        check(time.monotonic() < restart_deadline,
              f"19b: member 2 never restarted: {_fleet_events(fleet)}")
        time.sleep(0.1)
    again = _fleet_ready(fleet, 2, not_pid=infos[2]["pid"],
                         deadline=restart_deadline)
    rewarm = request(("127.0.0.1", again["port"]),
                     {"id": "rewarm2", "prompt": warm_prompt,
                      "max_new_tokens": WARM_NEW},
                     timeout=FLEET_TIMEOUT_S)
    check(rewarm.get("tokens") == warm[0]["tokens"],
          f"19b: the restarted member answers {rewarm}")
    addr2 = f"127.0.0.1:{base + 2}"
    while True:                       # the probes see it answer again
        records = _fleet_records(fleet)
        if records and records[-1].get("breakers", {}).get(addr2) \
                not in (None, "open"):
            break
        check(time.monotonic() < restart_deadline,
              "19b: the router never saw member 2 answer again")
        time.sleep(0.1)
    nudged = []
    for k in range(FLEET_NUDGE):
        resp = request(("127.0.0.1", rport),
                       {"id": f"n{k}", "prompt": prompts[k],
                        "max_new_tokens": SERVE_MAX_NEW},
                       timeout=FLEET_TIMEOUT_S)
        check(resp.get("tokens") == direct[tuple(prompts[k])],
              f"19b: nudge n{k} got {resp}")
        nudged.append(k)
    rec_deadline = time.monotonic() + 60
    while True:
        records = _fleet_records(fleet)
        last = records[-1] if records else {}
        if last.get("breaker_closes_total", 0) >= 1 \
                and last.get("breakers", {}).get(addr2) == "closed":
            break
        check(time.monotonic() < rec_deadline,
              f"19b: no fleet record with member 2 closed again: {last}")
        time.sleep(0.1)
    problems = [p for r in records for p in validate_fleet_record(r)]
    check(not problems, f"19b: invalid fleet records: {problems[:5]}")
    check(last["breaker_opens_total"] >= 2 and last["hedges_total"] >= 1
          and last["redispatched_total"] >= 1
          and last["replicas_total"] == FLEET_SIZE,
          f"19b: the last fleet record {last}")

    # a re-dispatched request's story through the router's trace verb
    # (asked for every burst id at once: each trace waits out the silent
    # member's verb timeout)
    traces = [None] * FLEET_BURST

    def trace(k: int) -> None:
        traces[k] = request(("127.0.0.1", rport),
                            {"verb": "trace", "id": f"b{k}"}, timeout=60)

    threads = [threading.Thread(target=trace, args=(k,))
               for k in range(FLEET_BURST)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=90)
    story = None
    for k, tr in enumerate(traces):
        names = [e["name"] for e in (tr or {}).get("events", [])
                 if e.get("source") == "router"]
        if names.count("dispatch") >= 2:
            story = dict(id=f"b{k}", router_events=names,
                         sources=tr["sources"],
                         replica_events=len(tr["events"]) - len(names))
            break
    check(story is not None, "19b: no re-dispatched request in the burst")

    events = _fleet_events(fleet)
    crashes = [e for e in events if e["event"] == "crash"]
    restarts = [e for e in events if e["event"] == "restart"]
    check(crashes and all(e["member"] == 2 for e in crashes)
          and any(e["member"] == 2 for e in restarts),
          f"19b: supervisor events {events}")
    out = dict(members=FLEET_SIZE, faults=FLEET_FAULTS, layers=CUT_LAYERS,
               boot_s=boot_s, router_start_s=router_start_s,
               burst=FLEET_BURST, completed=completed, refused=refused,
               lost=len(lost), burst_tokens=tokens, burst_wall_s=wall,
               burst_tokens_per_s=tokens / wall, nudges=len(nudged),
               fleet_records=len(records),
               last_fleet_record={k: last[k] for k in (
                   "dispatched_total", "redispatched_total",
                   "penalties_total", "drain_refusals_total",
                   "no_backend_total", "completed_total",
                   "breaker_opens_total", "breaker_closes_total",
                   "hedges_total", "hedge_cancels_total", "breakers",
                   "replicas_reported", "requests_completed")},
               crashes=len(crashes), restarts=len(restarts),
               redispatched_trace=story, nvidia_smi=card)
    emit("router_fleet", **out)
    return out


def _shard_command(txt: str, tok_dir: str, prefix: str) -> str:
    """One shard's ``tools.preprocess_data`` as a shell command."""
    import shlex

    return (f"cd {shlex.quote(REPO)} && PYTHONPATH={shlex.quote(REPO)} "
            f"{shlex.quote(sys.executable)} -m "
            f"fleetx_tpu_torch.tools.preprocess_data --input "
            f"{shlex.quote(txt)} --tokenizer {shlex.quote(tok_dir)} "
            f"--output-prefix {shlex.quote(prefix)} --workers 2 --append-eos")


def _corpus_shards_start(root: str, tok_dir: str) -> dict:
    """19c's shards of ``docs/*.md`` (the sorted files split in
    ``CORPUS_SHARDS`` runs) preprocessed by ``run_commands``, one process
    each, on a thread; ``_corpus_train`` collects them."""
    import glob

    from fleetx_tpu_torch.tools.multiprocess_tool import run_commands

    corpus = os.path.join(root, "corpus")
    os.makedirs(corpus, exist_ok=True)
    docs = sorted(glob.glob(os.path.join(REPO, "docs", "*.md")))
    per = -(-len(docs) // CORPUS_SHARDS)
    prefixes, commands = [], []
    for s in range(CORPUS_SHARDS):
        # a directory each: a GPTDataset caches its index files beside its
        # data under a key of its sizes, which two shards may share
        shard = os.path.join(corpus, f"shard{s}")
        os.makedirs(shard, exist_ok=True)
        txt = os.path.join(shard, "docs.txt")
        with open(txt, "w", encoding="utf-8") as f:
            for path in docs[s * per:(s + 1) * per]:
                with open(path, encoding="utf-8") as src:
                    f.write(src.read())
        prefixes.append(os.path.join(shard, "docs"))
        commands.append(_shard_command(txt, tok_dir, prefixes[-1]))
    box: dict = {}

    def run() -> None:
        t0 = time.monotonic()
        try:
            box["rcs"] = run_commands(commands, num_workers=CORPUS_SHARDS,
                                      timeout=300)
        except Exception as e:  # noqa: BLE001 — raised in _corpus_train
            box["error"] = repr(e)
        box["wall_s"] = time.monotonic() - t0

    thread = threading.Thread(target=run, daemon=True,
                              name="chip-smoke-shards")
    thread.start()
    return dict(thread=thread, box=box, prefixes=prefixes,
                commands=commands)


def _corpus_train(dev: torch.device, card: str, tok_dir: str,
                  shards: dict) -> dict:
    """19c: the shards' ``GPTDataset``s blended, their indices from the
    native builder (held to the numpy builders byte for byte), and phase
    4's recipe trained ``CORPUS_STEPS`` steps on the blend."""
    from fleetx_tpu_torch.data.dataset import gpt_dataset as G
    from fleetx_tpu_torch.data.native import index_builder, library_path
    from fleetx_tpu_torch.data.tokenizers.gpt_tokenizer import GPTTokenizer
    from fleetx_tpu_torch.kernels.build import BUILD_DIR
    from fleetx_tpu_torch.tools.train import build_trainer, load_config

    shards["thread"].join(timeout=330)
    box = shards["box"]
    check(not shards["thread"].is_alive() and box.get("rcs") == [0] * len(
        shards["prefixes"]), f"19c: the shard processes: {box}")
    eos = GPTTokenizer.from_pretrained(tok_dir).eos_token_id
    batch = 8
    cfg = load_config(TRAIN_YAML, [f"Engine.max_steps={CORPUS_STEPS}",
                                   "Engine.logging_freq=1"] + FT_LR)
    cfg["Data"]["Train"]["dataset"] = dict(
        name="BlendedDataset", weights=[1.0] * len(shards["prefixes"]),
        num_samples=CORPUS_STEPS * batch,
        datasets=[dict(name="GPTDataset", input_dir=p, eos_id=eos,
                       num_samples=CORPUS_STEPS * batch, seed=1234)
                  for p in shards["prefixes"]])
    engine, train_dl, _ = build_trainer(cfg, device=dev)
    mc = engine.module.model_cfg
    check(mc.num_layers == 24 and mc.hidden_size == 1024
          and mc.num_attention_heads == 16 and mc.vocab_size == 50304
          and mc.dtype == torch.bfloat16
          and cfg["Global"]["global_batch_size"] == batch,
          "19c: not phase 4's full-width 345M recipe")
    blend = train_dl.dataset
    check(isinstance(blend, G.BlendedDataset), f"19c: {type(blend)}")
    so = index_builder.path
    check(so is not None and so == library_path()
          and os.path.dirname(so) == BUILD_DIR,
          f"19c: the native index builder was not loaded from "
          f"{BUILD_DIR}: {so}")
    # the native indices against the numpy builders, byte for byte
    w = np.ones(len(blend.datasets)) / len(blend.datasets)
    ds_idx, ds_sample = G.build_blending_indices(w, len(blend))
    same = (ds_idx.tobytes() == blend.dataset_index.tobytes()
            and ds_sample.tobytes() == blend.dataset_sample_index.tobytes())
    for ds in blend.datasets:
        ref = G.build_sample_idx(ds.doc_lens, np.asarray(ds.doc_idx),
                                 ds.seq_length, len(ds.sample_idx) - 1)
        same = same and ref.tobytes() == np.asarray(ds.sample_idx).tobytes()
    check(same, "19c: the native indices differ from the numpy builders'")
    emit("native_index", library=os.path.relpath(so, REPO), loaded=True,
         equals_numpy=True, shards=len(blend.datasets),
         shard_tokens=[int(ds.doc_lens.sum()) for ds in blend.datasets],
         shard_docs=[len(ds.doc_lens) for ds in blend.datasets],
         blend_samples=len(blend), preprocess_wall_s=box["wall_s"])
    reset_peak(dev)
    zero_counts()                     # every count to 0 just before
    losses = engine.fit(train_dl)
    torch.cuda.synchronize()
    counts = read_counts()            # read just after
    for name, per_step in PER_STEP.items():
        check(counts[name] == per_step * CORPUS_STEPS,
              f"19c: {name}: {counts[name]} launches, want {per_step} x "
              f"{CORPUS_STEPS} steps")
    hist = engine.history
    check(len(losses) == CORPUS_STEPS and all(np.isfinite(losses)),
          f"19c: losses {losses}")
    check(losses[-1] < losses[0],
          f"19c: the last loss {losses[-1]} is not below the first "
          f"{losses[0]}")
    step_s = statistics.median(h["train_cost"] for h in hist[1:])
    out = dict(steps=CORPUS_STEPS, losses=losses,
               grad_norms=[h["grad_norm"] for h in hist],
               step_ms_median=step_s * 1e3,
               tokens_per_s=batch * 1024 / step_s, launches=counts,
               launches_per_step={k: counts[k] / CORPUS_STEPS
                                  for k in PER_STEP},
               max_memory_allocated_gb=torch.cuda.max_memory_allocated(dev)
               / 2 ** 30, lr=FT_LR, nvidia_smi=card)
    emit("corpus_train", **out)
    del engine, train_dl, blend
    torch.cuda.empty_cache()
    return out


def phase_router_corpus(dev: torch.device, card: str, root: str,
                        ckpt_dir: str, tok_dir: str) -> dict:
    """Phase 19: the router in process (19a), the supervised fleet behind
    the router process (19b) and training on a blended real corpus (19c).
    The fleet boots and the shards preprocess while 19a runs."""
    fleet = _fleet_start(root, ckpt_dir)
    try:
        shards = _corpus_shards_start(root, tok_dir)
        router = timed("19a", _router_in_process, dev, card, ckpt_dir)
        fleet_out = timed("19b", _fleet_drive, card, fleet, router["direct"])
    finally:
        _fleet_stop(fleet)
    corpus = timed("19c", _corpus_train, dev, card, tok_dir, shards)
    return dict(router=router, fleet=fleet_out, corpus=corpus)


def router_corpus_alone(dev: torch.device, card: str) -> None:
    """``--router-corpus``: phase 19 on a checkpoint of the 345M recipe's
    seeded params cut to ``CUT_LAYERS`` layers, with the tokenizer phase 9
    trains."""
    from fleetx_tpu_torch.core import checkpoint as C
    from fleetx_tpu_torch.core.module import GPTModule
    from fleetx_tpu_torch.tools.train import load_config

    root = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        module = GPTModule(load_config(TRAIN_YAML))
        params = module.init_params(1234, dev)
        C.save_checkpoint(os.path.join(root, "ckpt"), 1, dict(
            step=1, **C.flatten(params, "params/")), meta={
                "consumed_samples": 0, "epoch": 0, "seed": 1234})
        del params
        ckpt = _cut_checkpoint(dev, root, os.path.join(root, "ckpt"))
        timed("19", phase_router_corpus, dev, card, root, ckpt,
              _readme_tokenizer(root))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit("router_corpus_alone", phase_walls=PHASE_WALLS, nvidia_smi=card)


# ---------------------------------------------------------------- phase 20

#: 20: the serving mesh (two fsdp shards by two tensor ranks, processes
#: sharing this card over gloo); 513 pages do not split over fsdp 2, so
#: the replica's pool is cut to 514
MESH_DEGREES = ["Distributed.fsdp_degree=2", "Distributed.mp_degree=2"]
MESH_PAGES = 514
MESH_RANKS = 4
MESH_TIMEOUT_S = 300
#: 20a holds rank 0's heads of the first decode step's layer-0 attention
#: output to the one-rank engine's within this (f32; the reorders of the
#: cross-shard combine and of the row-parallel sums are all)
MESH_ATTN_ATOL = 1e-5
#: 20b: the bf16 mesh's first decode step's logits drift bound, as a share
#: of the largest magnitude (phase 13's int8 bound)
MESH_DRIFT = 0.05
#: 20c: the inference recipe's data-parallel degree cut to 2 ranks, and
#: with it the global batch (1 a rank)
DP_RANKS = 2
#: 20c's distinct rows: prompts drawn from this seed over the GPT-2
#: tokenizer's ids, at most this many draws to find one a rank whose
#: generated ids differ
DP_ROWS_SEED = 20
DP_ROW_VOCAB = 50257
DP_ROW_DRAWS = 8
DP_YAML = os.path.join(REPO, "fleetx_tpu", "configs", "nlp", "gpt",
                       "inference_gpt_345M_dp8.yaml")


def _shard_case(dtype: torch.dtype, dev: torch.device, nh: int):
    """Row 7 at a shard's shape: the 345M geometry's pool of 514 pages
    over two fsdp shards, this shard (0) holding pages 0-256 of ``nh``
    heads; the tables draw from both shards, so the other shard's pages
    are ``-1`` entries scattered through them, and row 6's pages all
    belong to the other shard. Returns ``(case, foreign row)``."""
    from fleetx_tpu_torch.ops import paged_attention as PA

    local_pages = MESH_PAGES // 2
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    shape = (local_pages, PS, nh, HD)
    pk = torch.randn(shape, generator=gen, device=dev).to(dtype)
    pv = torch.randn(shape, generator=gen, device=dev).to(dtype)
    q = torch.randn((B, nh, HD), generator=gen, device=dev).to(dtype)
    rng = np.random.RandomState(1)
    order = [int(p) for p in rng.permutation(np.arange(1, MESH_PAGES))]
    tables = np.zeros((B, PPR), np.int32)
    foreign = 6
    for row, n in enumerate(LENS):
        used = -(-(n + 1) // PS) if n >= 0 else 0
        picks = [p for p in order
                 if row != foreign or p >= local_pages][:used]
        for p in picks:
            order.remove(p)
        tables[row, :used] = picks
    as_dev = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    glob = as_dev(tables)
    local = PA._localize_tables(glob, 0, local_pages).contiguous()
    check(bool((local[foreign] < 0).all()), "row 6 holds a local page")
    check(bool((local[:, :4] < 0).any()) and bool((local >= 0).any()),
          "the shard's tables have no scattered -1 entries")
    return (q, pk, pv, local, local,
            as_dev(np.asarray(LENS, np.int32))), foreign


def _hold_shard_shapes(PA, paged_smem, dev: torch.device) -> list:
    """Phase 1's shard-shape rows: 8 and 4 heads a shard, f32 and bf16,
    against the plain versions; the all-foreign row the empty triple."""
    out = []
    for nh in (NH // 2, NH // 4):
        for dtype in (torch.float32, torch.bfloat16):
            case, foreign = _shard_case(dtype, dev, nh)
            what = f"shard nh{nh} {dtype}"
            errs = _hold_paged(PA, case, LENS, what)
            _, hb, rb, ppc, slots, smem = errs["plan"]
            check(paged_smem(hb, rb, HD, case[1].element_size(), slots,
                             ppc) == smem,
                  f"paged {what}: plan_split's shared memory differs")
            q, pk, pv, _, local, lens = case
            acc, m, l = PA.paged_call(q, pk, pv, local, lens)
            torch.cuda.synchronize()
            check(bool((m[foreign] == -1e30).all())
                  and bool((l[foreign] == 0).all())
                  and bool((acc[foreign] == 0).all()),
                  f"paged {what}: the all-foreign row is not (-1e30, 0, 0)")
            row = dict(geometry="shard", dtype=str(dtype), B=B, nh=nh,
                       hd=HD, ps=PS, pages_per_req=PPR,
                       local_pages=MESH_PAGES // 2,
                       skipped_entries=int((local < 0).sum()),
                       foreign_row_empty=True, **errs)
            emit("paged_check", **row)
            out.append(row)
    return out


def _mesh_supervised(n: int, argv: list, log: str,
                     env: Optional[dict] = None) -> dict:
    """``tools.supervise --num-procs n -- <argv>`` on this card, its
    output to ``log``; the handle (process, log, start time). The ranks
    compute on the card: one intra-op thread each keeps ten processes'
    thread pools off the cores their collectives wait on. ``env`` adds
    variables."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "fleetx_tpu_torch.tools.supervise",
         "--num-procs", str(n), "--max-restart", "0", "--grace", "30",
         "--"] + argv,
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO,
                           OMP_NUM_THREADS="1", **(env or {})),
        stdout=open(log, "w"), stderr=subprocess.STDOUT,
        start_new_session=True)
    return dict(proc=proc, log=log, t0=time.monotonic())


def _stop_gang(gang: dict) -> None:
    """SIGTERM to the supervisor (which forwards it to the members, waits
    its grace and kills them), SIGKILL past a minute."""
    proc = gang["proc"]
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def _wait_exit(gang: dict, what: str, want: int = 0) -> None:
    proc = gang["proc"]
    try:
        proc.wait(timeout=MESH_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        _stop_gang(gang)
    if proc.returncode != want:
        with open(gang["log"]) as f:
            tail = f.read()[-4000:]
        check(False, f"{what} exited {proc.returncode}, not {want}: {tail}")


def _wait_file(path: str, gang: dict, what: str) -> None:
    deadline = time.monotonic() + MESH_TIMEOUT_S
    while not os.path.exists(path):
        if gang["proc"].poll() is not None or time.monotonic() > deadline:
            _wait_exit(gang, what)
            check(False, f"{what}: {path} never appeared")
        time.sleep(0.1)


def _rank_reports(path: str) -> list:
    with open(path) as f:
        records = [json.loads(line) for line in f if line.strip()]
    mesh = [r for r in records if r.get("scope") == "serving_mesh"]
    check(len(mesh) == 1, f"{path}: {len(mesh)} mesh records")
    return mesh[0]["ranks"]


def _check_ranks(ranks: list, layers: int, what: str) -> dict:
    """Every rank on gloo with the shard's pool, row 7 at ``layers`` per
    decode step, all ranks the same steps; summed launches."""
    check([r["rank"] for r in ranks] == list(range(MESH_RANKS)),
          f"{what}: ranks {[r['rank'] for r in ranks]}")
    for r in ranks:
        check(r["backend"] == "gloo", f"{what}: rank {r['rank']} on "
                                      f"{r['backend']}")
        check(r["pool_shape"] == [layers, MESH_PAGES // 2, PS, NH // 2, HD],
              f"{what}: rank {r['rank']} pool {r['pool_shape']}")
        check(r["steps"] == ranks[0]["steps"] and r["steps"]["decode"] > 0,
              f"{what}: rank steps {[x['steps'] for x in ranks]}")
        check(r["paged_launches"] == layers * r["steps"]["decode"],
              f"{what}: rank {r['rank']} launched row 7 "
              f"{r['paged_launches']} times in {r['steps']['decode']} "
              f"decode steps of {layers} layers")
    return dict(launches=sum(r["paged_launches"] for r in ranks),
                per_rank=[r["paged_launches"] for r in ranks],
                decode_steps=ranks[0]["steps"]["decode"],
                prefill_steps=ranks[0]["steps"]["prefill"])


def _ask_concurrently(port: int, prompts: list, max_new: int) -> list:
    from fleetx_tpu_torch.serving.server import request

    out = [None] * len(prompts)

    def ask(i):
        out[i] = request(("127.0.0.1", port),
                         {"id": f"mesh{i}", "prompt": prompts[i],
                          "max_new_tokens": max_new},
                         timeout=MESH_TIMEOUT_S)

    threads = [threading.Thread(target=ask, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=MESH_TIMEOUT_S)
    return out


#: 20a's replica overrides beside ``MESH_DEGREES`` (the checkpoint's
#: directory appended): the dtype phase 9's replica serves in, the pool
#: that splits over fsdp
MESH_F32 = ["Model.dtype=float32", f"Serving.num_pages={MESH_PAGES}"]
#: 20b's: the recipe's bf16 on seeded weights
MESH_BF16 = [f"Serving.num_pages={MESH_PAGES}"]
#: the interpreter line of a gang member that runs a function of this
#: script on its arguments
CHILD = ("import sys; sys.path.insert(0, %r); import chip_smoke; "
         "sys.exit(chip_smoke.%s(sys.argv[1:]))")


def _start_mesh(root: str, full_ckpt: str, gen_dir: str,
                dp_rows: np.ndarray) -> dict:
    """20a-c's gangs, started together: the host's cores are what their
    latency-bound collectives wait on, and the three overlapped finish
    sooner than one after another. ``dp_rows`` are 20c's distinct rows."""
    work = os.path.join(root, "mesh")
    os.makedirs(work, exist_ok=True)
    paths = {n: os.path.join(work, n) for n in (
        "ready.json", "metrics.jsonl", "attn0.npy", "bf16", "dp")}
    for d in (paths["bf16"], paths["dp"]):
        os.makedirs(d)
    np.save(os.path.join(paths["dp"], "rows.npy"), dp_rows)
    replica = dict(_mesh_supervised(
        MESH_RANKS,
        [sys.executable, "-m", "fleetx_tpu_torch.tools.serve", "-c", YAML]
        + _overrides(MESH_F32 + [f"Serving.ckpt_dir={full_ckpt}"]
                     + MESH_DEGREES)
        + ["--ready-file", paths["ready.json"], "--metrics-out",
           paths["metrics.jsonl"], "--attn-tap", paths["attn0.npy"],
           "--preemption-code", "75"],
        os.path.join(work, "replica.log")), paths=paths)
    return {"replica_f32": replica, "bf16": dict(_mesh_supervised(
        MESH_RANKS, [sys.executable, "-c", CHILD % (REPO, "mesh_child"),
                     paths["bf16"]] + MESH_BF16 + MESH_DEGREES,
        os.path.join(work, "bf16.log")), out=paths["bf16"]),
        "dp_inference": dict(_mesh_supervised(
            DP_RANKS,
            [sys.executable, "-c", CHILD % (REPO, "inference_child"),
             paths["dp"], "-c", DP_YAML] + _overrides(
                [f"Distributed.dp_degree={DP_RANKS}",
                 f"Global.global_batch_size={DP_RANKS}",
                 f"Inference.model_dir={gen_dir}"] + CUT_DEPTH),
            os.path.join(work, "dp.log")), out=paths["dp"])}


def _replica_reference(dev: torch.device, full_ckpt: str) -> dict:
    """20a's one-rank f32 engine on the checkpoint, in this process: the
    warm-up request alone (its first decode step is the tapped one), then
    phase 2's prompts."""
    from fleetx_tpu_torch.serving.decode import tap_next_decode
    from fleetx_tpu_torch.tools.serve import build_engine, load_config

    one = build_engine(load_config(YAML, MESH_F32 + [
        f"Serving.ckpt_dir={full_ckpt}"]), device=dev)
    check(one.cfg.num_layers == 24 and one.cfg.dtype == torch.float32,
          "20a: not the 24-layer f32 replica")
    taps = []
    tap_next_decode(lambda a: taps.append(a.float().cpu().numpy()))
    warm = _prompts(1, [8])[0]
    req = one.submit(warm, 2, request_id="warm")
    one.run_until_drained()
    prompts = _prompts(2, SERVE_PROMPT_LENS)
    reqs = [one.submit(p, SERVE_MAX_NEW, request_id=f"one{i}")
            for i, p in enumerate(prompts)]
    one.run_until_drained()
    out = dict(warm=warm, want_warm=list(req.tokens), prompts=prompts,
               want=[list(r.tokens) for r in reqs], tap=taps[0])
    del one, reqs
    torch.cuda.empty_cache()
    return out


def _mesh_replica(dev: torch.device, gang: dict, ref: dict) -> dict:
    """20a: the f32 replica over the 2 x 2 mesh (``tools.serve`` under
    ``tools.supervise --num-procs 4``) on phase 8's checkpoint at 24
    layers, against the one-rank engine (``ref``)."""
    from fleetx_tpu_torch.serving.server import request

    paths = gang["paths"]
    try:
        _wait_file(paths["ready.json"], gang, "20a replica")
        with open(paths["ready.json"]) as f:
            port = json.load(f)["port"]
        up_s = time.monotonic() - gang["t0"]
        got_warm = request(("127.0.0.1", port),
                           {"id": "warm", "prompt": ref["warm"],
                            "max_new_tokens": 2}, timeout=MESH_TIMEOUT_S)
        t1 = time.monotonic()
        answers = _ask_concurrently(port, ref["prompts"], SERVE_MAX_NEW)
        wall = time.monotonic() - t1
        stats = request(("127.0.0.1", port), {"verb": "stats"})
    finally:
        if gang["proc"].poll() is None:
            gang["proc"].send_signal(signal.SIGTERM)   # the drain
    _wait_exit(gang, "20a supervisor", want=75)
    check(got_warm.get("tokens") == ref["want_warm"],
          f"20a warm-up {got_warm} != {ref['want_warm']}")
    mismatched = [i for i, (a, w) in enumerate(zip(answers, ref["want"]))
                  if a is None or a.get("tokens") != w]
    check(not mismatched, f"20a: answers {mismatched} differ from the "
                          f"one-rank engine's")
    check(stats.get("chips") == MESH_RANKS
          and stats.get("decode_path") == "paged_kernel",
          f"20a stats {stats.get('chips')} {stats.get('decode_path')}")
    ranks = _check_ranks(_rank_reports(paths["metrics.jsonl"]), 24, "20a")
    mesh_attn = np.load(paths["attn0.npy"])
    heads = ref["tap"][:, :, :NH // 2]
    check(mesh_attn.shape == heads.shape,
          f"20a: tapped {mesh_attn.shape} vs {heads.shape}")
    attn_err = float(np.abs(mesh_attn - heads).max())
    check(attn_err <= MESH_ATTN_ATOL,
          f"20a: rank 0's layer-0 attention off by {attn_err}")
    tokens = sum(len(a["tokens"]) for a in answers)
    return dict(requests=len(answers), new_tokens=tokens, identical=True,
                attn_max_abs_err=attn_err, wall_s=wall,
                tokens_per_s=tokens / wall, up_s=up_s,
                ttft_p50_s=stats.get("ttft_p50_s"),
                itl_p50_s=stats.get("itl_p50_s"),
                itl_p99_s=stats.get("itl_p99_s"), **ranks)


def mesh_child(argv: list) -> int:
    """20b's gang member: ``build_engine`` on the serving config with
    ``argv``'s overrides (the mesh from its ``Distributed`` degrees);
    rank 0 submits phase 2's prompts to ``ServingEngine(mesh=...)``
    directly and writes the tokens, the first decode step's logits and
    every rank's report under ``argv[0]``; the others ``follow()``."""
    from fleetx_tpu_torch.tools.serve import build_engine, load_config
    from fleetx_tpu_torch.utils.env import close_dist_env

    out_dir, overrides = argv[0], argv[1:]
    engine = build_engine(load_config(YAML, overrides))
    collective_ms = _collective_ms(engine.mesh, engine.device)
    if not engine.mesh.is_leader:
        code = engine.follow()
        close_dist_env()
        return code
    tokens, logits = _direct_run(engine)
    reports = engine.close(0)
    close_dist_env()
    np.save(os.path.join(out_dir, "logits.npy"), logits)
    with open(os.path.join(out_dir, "mesh.json"), "w") as f:
        json.dump({"tokens": tokens, "ranks": reports,
                   "collective_ms": collective_ms}, f)
    return 0


def _collective_ms(mesh, dev: torch.device, calls: int = 50) -> dict:
    """Host ms of one collective a decode step makes, on every rank at
    once: the ``tensor`` psum of a ``[16, 1024]`` f32 activation and the
    ``fsdp`` pmax of ``[16, 8]`` partial maxima, on the card (after 5
    unmeasured calls each)."""
    from fleetx_tpu_torch.parallel import mesh as M

    out = {}
    for name, fn, axis, shape in (("psum_tensor", M.psum, "tensor",
                                   (B, 1024)),
                                  ("pmax_fsdp", M.pmax, "fsdp", (B, 8))):
        x = torch.ones(shape, device=dev)
        for _ in range(5):
            fn(x, axis, mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn(x, axis, mesh)
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) * 1e3 / calls
    return out


def _direct_run(engine) -> tuple:
    """Phase 2's prompts submitted to ``engine`` directly, run to the
    end: the tokens and the first decode step's f32 logits."""
    first = []
    decode = engine._fns["decode"]

    def tapped(*args):
        out = decode(*args)
        if not first:
            first.append(out[3].float().cpu().numpy())
        return out

    engine._fns["decode"] = tapped
    reqs = [engine.submit(p, SERVE_MAX_NEW, request_id=f"d{i}")
            for i, p in enumerate(_prompts(2, SERVE_PROMPT_LENS))]
    engine.run_until_drained()
    engine._fns["decode"] = decode
    return [list(r.tokens) for r in reqs], first[0]


def _bf16_reference(dev: torch.device) -> dict:
    """20b's one-rank bf16 engine on the seeded weights, in this
    process."""
    from fleetx_tpu_torch.tools.serve import build_engine, load_config

    one = build_engine(load_config(YAML, MESH_BF16), device=dev)
    check(one.cfg.dtype == torch.bfloat16, "20b: not bf16")
    want, logits = _direct_run(one)
    del one
    torch.cuda.empty_cache()
    return dict(want=want, logits=logits)


def _mesh_bf16(dev: torch.device, gang: dict, ref: dict) -> dict:
    """20b: the recipe's dtype (bf16, seeded weights) on the same mesh (a
    gang of ``mesh_child``), against the one-rank bf16 engine (``ref``)."""
    _wait_exit(gang, "20b gang")
    with open(os.path.join(gang["out"], "mesh.json")) as f:
        got = json.load(f)
    logits = np.load(os.path.join(gang["out"], "logits.npy"))
    want, want_logits = ref["want"], ref["logits"]
    check(logits.shape == want_logits.shape and np.isfinite(logits).all(),
          f"20b logits {logits.shape}")
    drift = float(np.abs(logits - want_logits).max()
                  / max(float(np.abs(want_logits).max()), 1e-9))
    check(drift < MESH_DRIFT, f"20b: bf16 logits drifted {drift}")
    pairs = [(a, b) for g, w in zip(got["tokens"], want)
             for a, b in zip(g, w)]
    agree = sum(a == b for a, b in pairs) / max(len(pairs), 1)
    ranks = _check_ranks(got["ranks"], 24, "20b")
    return dict(greedy_agreement=agree, tokens_compared=len(pairs),
                identical_requests=sum(g == w for g, w in
                                       zip(got["tokens"], want)),
                logits_drift=drift, drift_bound=MESH_DRIFT,
                collective_ms=got["collective_ms"],
                gang_s=time.monotonic() - gang["t0"], **ranks)


def inference_child(argv: list) -> int:
    """20c's gang member. First 20c's distinct rows (``argv[0]/rows.npy``,
    one a rank) through a data-parallel ``InferenceEngine`` of the same
    config, every rank keeping the whole gathered ids; then
    ``tools.inference``'s ``main(argv[1:])`` (its ``init_dist_env`` finds
    the group joined; it leaves the group at its end) with the launch
    counts zeroed just before and read just after. Writes the rows, its
    printed records and the counts to ``argv[0]/rank<r>.json``, ``r`` its
    rank in the mesh (the ranks share one log, whose lines may
    interleave)."""
    import contextlib
    import io

    from fleetx_tpu_torch.core.engine.inference_engine import (
        InferenceEngine, serving_mesh)
    from fleetx_tpu_torch.tools import inference
    from fleetx_tpu_torch.utils.config import get_config, parse_args
    from fleetx_tpu_torch.utils.env import get_world_size, init_dist_env

    args = parse_args("chip_smoke 20c", argv[1:])
    init_dist_env(device=args.device)
    cfg = get_config(args.config, args.override,
                     num_devices=get_world_size())
    eng = InferenceEngine(str(cfg["Inference"]["model_dir"]),
                          mesh=serving_mesh(cfg.get("Distributed")),
                          device=args.device)
    rank = eng.mesh.rank
    tokens = np.load(os.path.join(argv[0], "rows.npy"))
    rows = eng.predict([tokens, np.ones_like(tokens),
                        np.zeros((2,), np.uint32)])[0]
    del eng
    zero_counts()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = inference.main(argv[1:])
    torch.cuda.synchronize()
    records = [json.loads(x) for x in printed.getvalue().splitlines()
               if x.startswith("{")]
    with open(os.path.join(argv[0], f"rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "rc": rc, "launches": read_counts(),
                   "records": records, "rows": rows.tolist()}, f)
    return rc


def _dp_reference(eng) -> dict:
    """20c's references on a one-rank ``InferenceEngine`` of the
    generation export (its generation config as exported): one call on
    ``tools.inference``'s demo inputs, its launch counts zeroed just
    before and read just after; then 20c's distinct rows, one a rank,
    each through the engine alone: seeded prompts, drawn until the ranks'
    rows give different ids, so that a rank's row computed wrong or
    gathered into the wrong place shows."""
    from fleetx_tpu_torch.utils.config import parse_config

    width = int(parse_config(DP_YAML)["Inference"]["prompt_len"])
    tokens = np.zeros((1, width), np.int64)
    seed = np.zeros((2,), np.uint32)
    zero_counts()
    want = eng.predict([tokens, np.ones_like(tokens), seed])[0]
    counts = read_counts()
    rng = np.random.RandomState(DP_ROWS_SEED)
    rows, outs = [], []
    for draws in range(1, DP_ROW_DRAWS + 1):
        row = rng.randint(0, DP_ROW_VOCAB, (1, width)).astype(np.int64)
        ids = eng.predict([row, np.ones_like(row), seed])[0]
        if all(not np.array_equal(ids, o) for o in outs):
            rows.append(row)
            outs.append(ids)
        if len(rows) == DP_RANKS:
            break
    check(len(rows) == DP_RANKS,
          f"20c: {DP_ROW_DRAWS} drawn prompts gave {len(rows)} distinct "
          f"outputs, not one a rank")
    return dict(want=want, counts=counts, rows=np.concatenate(rows),
                want_rows=np.concatenate(outs), row_draws=draws)


def _dp_inference(dev: torch.device, gang: dict, ref: dict) -> dict:
    """20c: ``tools.inference`` on ``inference_gpt_345M_dp8.yaml`` with
    its ``dp_degree`` cut to 2 over phase 11's bf16 generation export,
    against one call of the one-rank engine on the same inputs; and the
    distinct rows' gathered ids, on every rank, against the one-rank
    engine's on each row."""
    _wait_exit(gang, "20c gang")
    want, one_counts = ref["want"], ref["counts"]
    want_rows = ref["want_rows"]
    ranks = []
    for r in range(DP_RANKS):
        with open(os.path.join(gang["out"], f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    rows = ("flash_attention_fwd", "fused_norm_fwd")
    for rank in ranks:
        outputs = [x for x in rank["records"] if "output" in x]
        check(rank["rc"] == 0 and len(outputs) == 1
              and outputs[0]["shape"] == [DP_RANKS * want.shape[0],
                                          want.shape[1]]
              and outputs[0]["first_row"] == [int(t) for t in want[0]],
              f"20c: rank {rank['rank']} printed {outputs} against "
              f"{want.tolist()}")
        check(np.array_equal(np.asarray(rank["rows"]), want_rows),
              f"20c: rank {rank['rank']} gathered {rank['rows']} for the "
              f"distinct rows against one rank's {want_rows.tolist()}")
        check({k: rank["launches"][k] for k in rows}
              == {k: one_counts[k] for k in rows},
              f"20c: rank {rank['rank']} launches {rank['launches']} vs "
              f"one call's {one_counts}")
    check(one_counts["fused_norm_fwd"] > 0, "20c: no norm launch")
    return dict(ranks=DP_RANKS, shape=[DP_RANKS * want.shape[0],
                                       want.shape[1]], identical=True,
                distinct_rows=list(want_rows.shape),
                row_draws=ref["row_draws"],
                one_call_launches={k: one_counts[k] for k in rows},
                launches={k: sum(r["launches"][k] for r in ranks)
                          for k in rows},
                gang_s=time.monotonic() - gang["t0"])


def phase_mesh(dev: torch.device, card: str, root: str, full_ckpt: str,
               gen_dir: str, dp_ref: dict) -> dict:
    """Phase 20: serving over a mesh of ranks on this card (20a, 20b) and
    data-parallel inference (20c), their gangs started together."""
    from fleetx_tpu_torch.utils.env import backend_for

    rule = backend_for("cuda", MESH_RANKS)
    check(rule == "gloo", f"four ranks on {torch.cuda.device_count()} "
                          f"card(s) take {rule}")
    out = dict(backend=rule, nvidia_smi=card)
    gangs = _start_mesh(root, full_ckpt, gen_dir, dp_ref["rows"])
    try:
        # the one-rank references while the gangs boot (20c's: phase 11's
        # engine, ``dp_ref``)
        t0 = time.monotonic()
        refs = {"replica_f32": _replica_reference(dev, full_ckpt),
                "bf16": _bf16_reference(dev), "dp_inference": dp_ref}
        out["references_s"] = time.monotonic() - t0
        for name, fn in (("replica_f32", _mesh_replica),
                         ("bf16", _mesh_bf16),
                         ("dp_inference", _dp_inference)):
            t0 = time.monotonic()
            out[name] = dict(fn(dev, gangs[name], refs[name]),
                             seconds=time.monotonic() - t0)
            emit(f"mesh_{name}", **out[name])
    finally:
        for gang in gangs.values():     # stops every gang a failure left
            _stop_gang(gang)
    emit("mesh", **out)
    return out


def mesh_alone(dev: torch.device, card: str) -> None:
    """``--mesh``: phase 20 on a checkpoint of the 345M recipe's seeded
    params (24 layers) and a bf16 generation export of them cut to
    ``CUT_LAYERS`` layers."""
    from fleetx_tpu_torch.core import checkpoint as C
    from fleetx_tpu_torch.core.module import GPTModule
    from fleetx_tpu_torch.tools.train import load_config

    from fleetx_tpu_torch.kernels import build
    from fleetx_tpu_torch.ops import paged_attention as PA

    paged_smem = build.load("paged_attention").fleetx_paged_smem_bytes
    paged_smem.argtypes = [ctypes.c_int] * 6
    paged_smem.restype = ctypes.c_int
    _hold_shard_shapes(PA, paged_smem, dev)
    root = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        module = GPTModule(load_config(TRAIN_YAML))
        params = module.init_params(1234, dev)
        ckpt = os.path.join(root, "ckpt")
        C.save_checkpoint(ckpt, 1, dict(
            step=1, **C.flatten(params, "params/")), meta={
                "consumed_samples": 0, "epoch": 0, "seed": 1234})
        del params
        cut = _cut_checkpoint(dev, root, ckpt)
        gen_dir = os.path.join(root, "exported_generation")
        _cli("tools.export", ["-c", INF_YAML] + _overrides(
            [f"Engine.save_load.ckpt_dir={cut}", f"Inference.model_dir="
             f"{gen_dir}", "Inference.target=generation"] + CUT_DEPTH))
        from fleetx_tpu_torch.core.engine.inference_engine import \
            InferenceEngine

        dp_ref = _dp_reference(InferenceEngine(gen_dir, device=dev))
        timed("20", phase_mesh, dev, card, root, ckpt, gen_dir, dp_ref)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit("mesh_alone", phase_walls=PHASE_WALLS, nvidia_smi=card)


# --------------------------------------------------------------- phase 21
TRAIN_MESH_RANKS = 4
#: 21a: phase 4's recipe (GPT-345M, full width and depth, its seed and
#: synthetic batches) on a dp 2 × mp 2 gang with sequence parallelism;
#: each data rank takes 4 rows of the global batch of 8
MESH_345M_STEPS = 4
MESH_345M = ["Distributed.dp_degree=2", "Distributed.mp_degree=2",
             "Distributed.sequence_parallel=True",
             "Global.local_batch_size=4", "Global.micro_batch_size=4",
             f"Engine.max_steps={MESH_345M_STEPS}", "Engine.logging_freq=1",
             "Engine.save_load.save_steps=0"]
#: 21a's losses against phase 4's first 4: the row-parallel products'
#: partial sums are psum'd in bf16 (one more bf16 rounding of each
#: activation the out projection and wo make, against one rank's single
#: rounding of the f32 accumulator), the dropout masks are one rank's
MESH_345M_LOSS_ATOL = 0.02
#: 21b: GPT-6.7B (``pretrain_gpt_6.7B_sharding16.yaml``: hidden 4096, 32
#: heads of 128, full recompute) at fsdp 4, ZeRO stage 2, cut to
#: ``SIXB_LAYERS`` layer (four ranks' f32 params, grads and moments: 12.2
#: GB a rank at 2 layers, 9.2 at 1; the cut below what fits is for the
#: smoke's time) and 2 rows a rank (the recipe's 8)
SIXB_YAML = os.path.join(REPO, "fleetx_tpu", "configs", "nlp", "gpt",
                         "pretrain_gpt_6.7B_sharding16.yaml")
SIXB_LAYERS = 1
SIXB_STEPS = 3
SIXB = ["Distributed.dp_degree=1", "Distributed.fsdp_degree=4",
        "Distributed.sharding.sharding_degree=4",
        "Global.local_batch_size=2", "Global.micro_batch_size=2",
        f"Model.num_layers={SIXB_LAYERS}",
        "Data.Train.dataset.name=SyntheticGPTDataset",
        "Data.Train.dataset.num_samples=1024",
        "Data.Train.dataset.seq_length=1024",
        "Data.Train.dataset.vocab_size=50304",
        f"Engine.max_steps={SIXB_STEPS}", "Engine.logging_freq=1",
        "Engine.eval_freq=0", f"Engine.save_load.save_steps={SIXB_STEPS}"]
MESH_TRAIN_TIMEOUT_S = 600
#: 21a runs with the gang resilience runtime on: the gang watchdog's
#: barrier after every step, the loop vote every step (preemption exits
#: with 75, every rank saving the same step through the two-phase commit,
#: asynchronously), the SDC sentinel every 2nd round (one check, with its
#: fingerprint census, in generation 1) and ``Observability.gang``.
#: Generation 1 gets a SIGTERM on rank 1 alone before step
#: ``MESH_PREEMPT_AT + 1``; generation 2 resumes every rank from that step
#: and trains to ``MESH_345M_STEPS``
MESH_PREEMPT_AT = 3
MESH_RESILIENCE = ["Resilience.enable=True",
                   "Resilience.watchdog.enable=True",
                   "Resilience.watchdog.gang_sync_steps=1",
                   "Resilience.preemption.sync_every=1",
                   f"Resilience.preemption.exit_code={PREEMPT_EXIT}",
                   "Resilience.preemption.save_on_exit=True",
                   "Resilience.integrity.sentinel_every=2",
                   "Engine.save_load.async_save=True",
                   "Observability.enable=True", "Observability.gang=True"]
MESH_FAULTS = f"sigterm_at={MESH_PREEMPT_AT},only_rank=1"
#: 21c: a per-rank pair, two processes each training their own 345M
#: replica (full width, ``DRILL_LAYERS`` deep) on a mesh of one with
#: ``per_rank_dirs``; rank 1 alone gets a bit flip after step
#: ``PAIR_FLIP_AT`` (the sentinel's census at round ``PAIR_SENTINEL``, the
#: only round it checks before the abort, must see it on both ranks) and
#: NaN losses at batches ``PAIR_NAN_AT`` (steps 6 and 7): both ranks roll
#: back once to the step-``PAIR_SENTINEL`` save, the replayed poison then
#: aborts both at step ``PAIR_ABORT_STEP`` (exit 3)
PAIR_RANKS = 2
PAIR_FLIP_AT = 2
PAIR_SENTINEL = 5
PAIR_NAN_AT = (5, 6)
PAIR_ABORT_STEP = 7
PAIR_ABORT_EXIT = 3
PAIR_OVERRIDES = DRILL_DEPTH + [
    f"Engine.max_steps={TRAIN_STEPS}", "Engine.logging_freq=1",
    f"Engine.save_load.save_steps={PAIR_SENTINEL}",
    "Engine.save_load.per_rank_dirs=True", "Resilience.enable=True",
    f"Resilience.integrity.sentinel_every={PAIR_SENTINEL}",
    "Resilience.integrity.sentinel_action=log",
    "Resilience.guard.nonfinite_action=rollback",
    "Resilience.guard.nonfinite_streak=2",
    "Resilience.guard.max_rollbacks=1",
    "Resilience.guard.skip_nonfinite_update=False"]
PAIR_FAULTS = (f"bitflip_param_at={PAIR_FLIP_AT},nan_loss_at="
               f"{PAIR_NAN_AT[0]}:{PAIR_NAN_AT[1]},only_rank=1")


def _runtime_report(engine) -> dict:
    """The gang resilience runtime's evidence on this rank: its counters,
    the gang watchdog's barriers and the commit votes (the agreements'
    wait histograms count them)."""
    from fleetx_tpu_torch.observability.metrics import get_registry

    reg = get_registry()
    out = {k: reg.counter(k).value for k in (
        "sdc_checks_total", "sdc_replay_mismatches",
        "sdc_fingerprint_mismatches", "ckpt_commit_aborts",
        "preemption_exits", "rollbacks_total", "watchdog_gang_stalls",
        "coord_timeouts_total", "coord_agreements_total")}
    for name in ("gang_watchdog", "ckpt_commit", "loop_flags"):
        out[f"{name}_agreements"] = reg.histogram(
            f"coord_wait_ms.{name}").summary().get("count", 0)
    out["barrier_wait_ms"] = reg.histogram("barrier_wait_ms").summary()
    out["step"] = int(engine.step)
    return out


def _replay_launches(engine, out: dict) -> None:
    """Count the launches of the SDC sentinel's replays apart (read
    before and after each ``_sdc_check``; the counts run on)."""
    check_fn = engine._sdc_check

    def counted(*a, **k):
        before = read_counts()
        try:
            return check_fn(*a, **k)
        finally:
            after = read_counts()
            for name in ENCODER_ROWS:
                out[name] = out.get(name, 0) + after[name] - before[name]

    engine._sdc_check = counted


def train_mesh_child(argv: list) -> int:
    """A member of phase 21's training gangs: ``tools.train``'s ``main``
    on ``argv[1:]``, its launch counts zeroed just before ``fit`` and read
    just after (the sentinel's replays also apart); the rank's losses,
    step walls, peak memory, the collectives' count and host wall, its
    mesh and blocks, the gathered parameters' fingerprint, how ``fit``
    ended, the runtime's counters and the fingerprints of a restore and
    of a preemption's save go to ``argv[0]/rank<r>.json``."""
    from fleetx_tpu_torch.convert import jax_leaves
    from fleetx_tpu_torch.core.engine.eager_engine import EagerEngine
    from fleetx_tpu_torch.resilience.integrity import params_fingerprint
    from fleetx_tpu_torch.tools import train
    from fleetx_tpu_torch.utils.env import get_backend

    import torch.distributed as dist

    out_dir, train_argv = argv[0], argv[1:]
    report: dict = {"exit": "completed"}
    coll = {"calls": 0, "seconds": 0.0, "on": False}

    def timed_collective(fn):
        def wrapper(*a, **k):
            if not coll["on"]:
                return fn(*a, **k)
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                coll["calls"] += 1
                coll["seconds"] += time.perf_counter() - t0
        return wrapper

    # the collectives that reach the backend (an axis of size 1 makes none)
    for name in ("all_reduce", "all_gather", "reduce_scatter_tensor"):
        setattr(dist, name, timed_collective(getattr(dist, name)))
    fit, load = EagerEngine.fit, EagerEngine.load

    def fingerprinted_load(self, *a, **k):
        restored = load(self, *a, **k)
        if restored:
            report["restored_step"] = int(self.step)
            report["restored_fingerprint"] = self.params_fingerprint()
        return restored

    EagerEngine.load = fingerprinted_load
    replay: dict = {}

    def measured_fit(self, *a, **k):
        # a generation started early waits here, built but before its
        # first read of the checkpoint, until the smoke opens its gate
        gate = os.environ.get("FLEETX_SMOKE_GATE")
        deadline = time.monotonic() + MESH_TRAIN_TIMEOUT_S
        while gate and not os.path.exists(gate) and \
                time.monotonic() < deadline:
            time.sleep(0.05)
        torch.cuda.synchronize()
        reset_peak(self.device)
        zero_counts()                   # every count to 0 just before
        _replay_launches(self, replay)
        coll.update(calls=0, seconds=0.0, on=True)
        t0 = time.perf_counter()
        try:
            losses = fit(self, *a, **k)
        except SystemExit:
            # the preemption exit, on every rank at the same step: the
            # saved step's parameters fingerprinted before the group goes
            report.update(exit="preempted",
                          saved_fingerprint=self.params_fingerprint())
            fill(self, [h["loss"] for h in self.history], t0)
            raise
        fill(self, losses, t0)
        return losses

    def fill(self, losses: list, t0: float) -> None:
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        coll["on"] = False
        counts = read_counts()          # read just after
        layers = self.params["gpt"]["layers"]
        report.update(
            rank=self.mesh.rank, backend=get_backend(),
            mesh=self.mesh.shape, device=str(self.device),
            sp=bool(self.module.model_cfg.shard.sp), losses=losses,
            grad_norms=[float(h["grad_norm"]) for h in self.history],
            step_ms=[h["train_cost"] * 1e3 for h in self.history],
            fit_s=wall, launches=counts,
            max_memory_allocated_gb=torch.cuda.max_memory_allocated(
                self.device) / 2 ** 30,
            max_memory_reserved_gb=torch.cuda.max_memory_reserved(
                self.device) / 2 ** 30,
            collectives=coll["calls"],
            collective_ms_per_step=coll["seconds"] * 1e3 / max(
                len(losses), 1),
            qkv_block=list(layers["attn"]["qkv_kernel"].shape),
            wte_block=list(self.params["gpt"]["embeddings"][
                "word_embeddings"].shape),
            moment_blocks=sorted({tuple(v.shape) for v in
                                  self.opt_state["mu"]}),
            fingerprint=params_fingerprint(jax_leaves(self.full_params())),
            replay_launches=replay, runtime=_runtime_report(self))

    EagerEngine.fit = measured_fit
    try:
        code = train.main(train_argv)
    except SystemExit as e:
        code = e.code
    with open(os.path.join(out_dir, f"rank{report['rank']}.json"),
              "w") as f:
        json.dump(report, f)
    return code


def per_rank_member(argv: list) -> int:
    """A member of 21c's per-rank pair: joins the gang, builds the
    trainer of ``argv[1]`` with the overrides ``argv[2:]`` on a mesh of
    one (its own replica, ``per_rank_dirs``), and fits with the launch
    counts zeroed just before and read just after; how it ended, its
    steps, losses, counters, the iterations whose census moved
    ``sdc_fingerprint_mismatches`` and its completed checkpoint steps go
    to ``argv[0]/rank<r>.json``; a ``TrainingAborted`` exits 3."""
    from fleetx_tpu_torch.core import checkpoint as C
    from fleetx_tpu_torch.parallel.mesh import build_mesh
    from fleetx_tpu_torch.resilience import TrainingAborted
    from fleetx_tpu_torch.tools.train import build_trainer, load_config
    from fleetx_tpu_torch.utils.env import (close_dist_env, get_backend,
                                            get_rank, init_dist_env)

    out_dir, yaml, overrides = argv[0], argv[1], argv[2:]
    init_dist_env()
    rank = get_rank()
    cfg = load_config(yaml, overrides, world_size=1)
    engine, dl, _ = build_trainer(cfg, device="cuda",
                                  mesh=build_mesh({}, world_size=1))
    census, replay = [], {}
    check_fn = engine._sdc_check

    def noted(prev, batch, metrics, step, gang=False):
        before = _counter("sdc_fingerprint_mismatches")
        check_fn(prev, batch, metrics, step, gang)
        census.append([int(step), _counter("sdc_fingerprint_mismatches")
                       - before])

    engine._sdc_check = noted
    torch.cuda.synchronize()
    zero_counts()                       # every count to 0 just before
    _replay_launches(engine, replay)
    report = dict(rank=rank, backend=get_backend(),
                  device=str(engine.device), mesh=engine.mesh is None,
                  per_rank=engine.per_rank_ckpt,
                  output_dir=engine.output_dir, exit="completed", code=0)
    try:
        report["losses"] = engine.fit(dl)
    except TrainingAborted as e:
        report.update(exit="aborted", code=PAIR_ABORT_EXIT, error=str(e))
    torch.cuda.synchronize()
    report.update(launches=read_counts(), replay_launches=replay,
                  census=census, runtime=_runtime_report(engine),
                  completed=C.completed_steps(engine.output_dir),
                  history_losses=[h["loss"] for h in engine.history])
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    close_dist_env()
    return report["code"]


def _train_gang(root: str, name: str, yaml: str, overrides: list,
                env: Optional[dict] = None, member: str = "train_mesh_child",
                ranks: int = TRAIN_MESH_RANKS) -> dict:
    """One of phase 21's gangs: ``tools.supervise --num-procs <ranks> --``
    ``tools.train`` (through ``train_mesh_child``, or ``member``) on this
    card, its flight dumps under ``<root>/flight_<name>``. Its ranks'
    allocators grow expandable segments: the ranks share the card, and
    the blocks a rank keeps reserved but unused would hold the others'
    memory. ``env`` adds variables (a generation's fault plan)."""
    out = os.path.join(root, name)
    os.makedirs(out, exist_ok=True)
    gang = _mesh_supervised(
        ranks, [sys.executable, "-c", CHILD % (REPO, member), out]
        + ([] if member == "per_rank_member" else ["-c"]) + [yaml]
        + (overrides if member == "per_rank_member"
           else _overrides(overrides)), os.path.join(root, f"{name}.log"),
        env=dict({"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True",
                  "FLEETX_FLIGHT_DIR": os.path.join(root, f"flight_{name}")},
                 **(env or {})))
    return dict(gang, out=out, ranks=ranks)


def _gang_exit(gang: dict, what: str, want: int = 0) -> list:
    """Wait for a phase-21 gang, hold its exit code to ``want`` and return
    its ranks' reports."""
    proc = gang["proc"]
    try:
        proc.wait(timeout=MESH_TRAIN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        _stop_gang(gang)
    with open(gang["log"]) as f:
        tail = f.read()[-6000:]
    check(proc.returncode == want,
          f"{what} exited {proc.returncode}, not {want}: {tail}")
    reports = []
    for r in range(gang["ranks"]):
        with open(os.path.join(gang["out"], f"rank{r}.json")) as f:
            reports.append(json.load(f))
    check([r["rank"] for r in reports] == list(range(gang["ranks"])),
          f"{what}: ranks {[r['rank'] for r in reports]}")
    return reports


def _train_reports(gang: dict, what: str, want: int = 0) -> list:
    reports = _gang_exit(gang, what, want)
    for r in reports:
        check(r["backend"] == "gloo" and r["device"] == "cuda:0",
              f"{what}: rank {r['rank']} on {r['backend']}, {r['device']}")
        check(r["losses"] == reports[0]["losses"],
              f"{what}: the ranks' losses differ: "
              f"{[x['losses'] for x in reports]}")
        check(r["fingerprint"] == reports[0]["fingerprint"],
              f"{what}: the ranks gathered different parameters")
    return reports


def _per_rank_launches(what: str, reports: list, per_step: dict,
                       steps: int) -> dict:
    """Rows 1, 4, 5 and 6 launched on every rank, ``per_step`` a step
    (all tensor-core, the norms all on route "rows")."""
    for r in reports:
        c = r["launches"]
        for name, n in per_step.items():
            check(c[name] == n * steps,
                  f"{what}: rank {r['rank']} launched {name} {c[name]} "
                  f"times, want {n} x {steps}")
        for tc, name in TC_COUNTS.items():
            check(c[tc] == c[name], f"{what}: rank {r['rank']}: "
                                    f"{c[name] - c[tc]} {name} off the "
                                    f"tensor cores")
        check(c["paged_attention_decode"] == 0, f"{what}: paged kernel")
    return {name: [r["launches"][name] for r in reports]
            for name in ENCODER_ROWS}


def _check_generation(what: str, reports: list, steps: int,
                      replays: int) -> dict:
    """21a's checks on one generation: every rank's launches of rows 1,
    4, 5 and 6 (``steps`` training steps and ``replays`` sentinel
    replays, the replays' own counted apart), a gang-watchdog barrier
    each step, no stall, no commit abort, no timeout."""
    per_step = {"flash_attention_fwd": 24, "flash_attention_bwd_fused": 24,
                "fused_norm_fwd": 49, "fused_norm_bwd": 49}
    launches = _per_rank_launches(what, reports, per_step, steps + replays)
    for r in reports:
        rt = r["runtime"]
        check(all(r["replay_launches"].get(k, 0) == replays * n
                  for k, n in per_step.items()),
              f"{what}: rank {r['rank']} replay launches "
              f"{r['replay_launches']}")
        check(rt["gang_watchdog_agreements"] == steps
              and rt["watchdog_gang_stalls"] == 0
              and rt["ckpt_commit_aborts"] == 0
              and rt["coord_timeouts_total"] == 0,
              f"{what}: rank {r['rank']} runtime {rt}")
    return launches


def _check_pair(reports: list) -> dict:
    """21c's checks: both ranks a replica of one rank in its own
    ``rank_<i>`` directory; the census of round ``PAIR_SENTINEL`` counted
    one fingerprint mismatch on both (the only check before the abort), no
    replay mismatch; one rollback each to the step-``PAIR_SENTINEL``
    save, both aborted at step ``PAIR_ABORT_STEP``; rows 1, 4, 5 and 6 a
    step and a replay at ``DRILL_LAYERS`` layers on both."""
    per_step = _per_step(DRILL_LAYERS)
    # steps 1-7, the rollback, steps 6-7 again, one replay
    runs = PAIR_ABORT_STEP + 2 + 1
    launches = _per_rank_launches("21c", reports, per_step, runs)
    for r in reports:
        rt = r["runtime"]
        check(r["mesh"] and r["per_rank"]
              and r["output_dir"].endswith(f"rank_{r['rank']}")
              and r["backend"] == "gloo" and r["device"] == "cuda:0",
              f"21c: rank {r['rank']} is not a per-rank replica: {r}")
        check(r["census"] == [[PAIR_SENTINEL, 1]]
              and rt["sdc_checks_total"] == 1
              and rt["sdc_fingerprint_mismatches"] == 1
              and rt["sdc_replay_mismatches"] == 0,
              f"21c: rank {r['rank']} census {r['census']}, {rt}")
        check(r["exit"] == "aborted" and rt["step"] == PAIR_ABORT_STEP
              and rt["rollbacks_total"] == 1
              and r["completed"] == [PAIR_SENTINEL],
              f"21c: rank {r['rank']} ended {r['exit']} at {rt['step']}, "
              f"rollbacks {rt['rollbacks_total']}, saved {r['completed']}")
        check(all(r["replay_launches"].get(k, 0) == per_step[k]
                  for k in ENCODER_ROWS),
              f"21c: rank {r['rank']} replay launches "
              f"{r['replay_launches']}")
    # the replicas diverge only through rank 1's faults
    r0, r1 = (r["history_losses"] for r in reports)
    check(r0[:PAIR_FLIP_AT] == r1[:PAIR_FLIP_AT]
          and all(np.isfinite(r0)) and not all(np.isfinite(r1)),
          f"21c: losses {r0} / {r1}")
    return dict(launches=launches, census=reports[0]["census"],
                losses=[r["history_losses"] for r in reports],
                aborted_at=PAIR_ABORT_STEP, exit_code=PAIR_ABORT_EXIT,
                checkpoint_steps=reports[0]["completed"],
                runtime=[r["runtime"] for r in reports])


def phase_train_mesh(dev: torch.device, card: str, losses4: list) -> dict:
    """Phase 21: sharded training over a gang of 4 ranks on this card,
    through ``tools.supervise --num-procs 4 -- tools.train`` (gloo: the
    ranks share the card). 21a: phase 4's GPT-345M at dp 2 × mp 2 with
    sequence parallelism and the gang resilience runtime, in two
    generations: a SIGTERM on rank 1 alone before step 4 makes every rank
    save step 3 through the two-phase commit and exit 75; the second
    generation resumes every rank from it and trains step 4; the four
    losses are held to phase 4's first 4. 21b: GPT-6.7B's width at fsdp
    4, ZeRO stage 2, 3 steps and a save that this process loads on one
    rank: its fingerprint must equal the gang's. 21c: a per-rank pair
    (``per_rank_member``), whose faults on rank 1 alone end in collective
    outcomes on both ranks. 21a's first generation and 21b run at once
    (their steps are host-bound: every collective a gloo round trip);
    21c and 21a's second generation start when 21b exits, the second
    generation held at a gate until its first has exited."""
    from fleetx_tpu_torch.convert import jax_leaves
    from fleetx_tpu_torch.core import checkpoint as C
    from fleetx_tpu_torch.core.engine import EagerEngine
    from fleetx_tpu_torch.core.module import GPTModule
    from fleetx_tpu_torch.resilience.integrity import params_fingerprint
    from fleetx_tpu_torch.tools.train import load_config
    from fleetx_tpu_torch.utils.env import backend_for

    rule = backend_for("cuda", TRAIN_MESH_RANKS)
    check(rule == "gloo", f"four ranks on {torch.cuda.device_count()} "
                          f"card(s) take {rule}")
    root = tempfile.mkdtemp(prefix="chip_smoke_mesh_train_")
    reset_peak(dev)                 # the card for the gangs: this
    torch.cuda.empty_cache()        # process keeps only what is live
    out = dict(backend=rule, nvidia_smi=card,
               this_process_reserved_gb=torch.cuda.memory_reserved(dev)
               / 2 ** 30)
    gangs: list = []                # every gang a failure leaves
    try:
        t0 = time.monotonic()
        ckpt = os.path.join(root, "ckpt_6.7B")
        ckpt_a = os.path.join(root, "ckpt_345M")
        tel_a = os.path.join(root, "telemetry_345M")
        resilient = MESH_345M + MESH_RESILIENCE + [
            f"Engine.save_load.output_dir={ckpt_a}",
            f"Observability.output_dir={tel_a}"]
        gangs.append(_train_gang(root, "345M", TRAIN_YAML, resilient,
                                 env={"FLEETX_FAULTS": MESH_FAULTS}))
        gangs.append(_train_gang(root, "6.7B", SIXB_YAML, SIXB + [
            f"Engine.save_load.output_dir={ckpt}"]))
        # when 21b exits, 21c starts and so does 21a's second generation,
        # held at a gate (built, before its first read of the checkpoint)
        # until the first generation has exited: never three gangs
        # training on the card (21b's and 21a's ranks together leave ~10
        # GB), and the second generation's start-up overlaps the first's
        # last steps
        gate = os.path.join(root, "resume_gate")
        a_done = b_done = False
        deadline = time.monotonic() + MESH_TRAIN_TIMEOUT_S
        while not (a_done and b_done):
            late = time.monotonic() > deadline
            if not a_done and (gangs[0]["proc"].poll() is not None or late):
                first = _train_reports(gangs[0], "21a (1)",
                                       want=PREEMPT_EXIT)
                out["a1_s"] = time.monotonic() - t0
                committed = C.completed_steps(ckpt_a)
                open(gate, "w").close()
                a_done = True
            elif not b_done and (gangs[1]["proc"].poll() is not None
                                 or late):
                b = _train_reports(gangs[1], "21b")
                out["b_s"] = time.monotonic() - t0
                pair_gang = _train_gang(
                    root, "pair", TRAIN_YAML, PAIR_OVERRIDES + [
                        "Engine.save_load.output_dir="
                        f"{os.path.join(root, 'pair')}"],
                    env={"FLEETX_FAULTS": PAIR_FAULTS},
                    member="per_rank_member", ranks=PAIR_RANKS)
                resume = _train_gang(root, "345M_resume", TRAIN_YAML,
                                     resilient,
                                     env={"FLEETX_SMOKE_GATE": gate})
                gangs += [pair_gang, resume]
                b_done = True
            else:
                time.sleep(0.2)
        second = _train_reports(resume, "21a (2)")
        out["a2_s"] = time.monotonic() - t0
        pair = _gang_exit(pair_gang, "21c", want=PAIR_ABORT_EXIT)
        out["c_s"] = time.monotonic() - t0
        # 21a: full width and depth, the shard's blocks, SP
        for r in first + second:
            check(r["mesh"] == {"pipe": 1, "data": 2, "fsdp": 1, "seq": 1,
                                "tensor": 2} and r["sp"]
                  and r["qkv_block"] == [24, 1024, 3, 8, 64]
                  and r["wte_block"] == [25152, 1024],
                  f"21a: rank {r['rank']} is not the 345M dp2 x mp2 "
                  f"shard: {r['mesh']} {r['qkv_block']} {r['wte_block']}")
        # generation 1: every rank preempted at the same step, that step
        # committed, the saved parameters' fingerprint the same on every
        # rank; one sentinel check with a clean census
        for r in first:
            rt = r["runtime"]
            check(r["exit"] == "preempted" and rt["step"] == MESH_PREEMPT_AT
                  and rt["preemption_exits"] == 1
                  and rt["ckpt_commit_agreements"] >= 1
                  and r["saved_fingerprint"] == first[0]["saved_fingerprint"]
                  and r["saved_fingerprint"] == r["fingerprint"],
                  f"21a (1): rank {r['rank']} {r['exit']} at {rt['step']}: "
                  f"{rt}")
            check(rt["sdc_checks_total"] == 1
                  and rt["sdc_replay_mismatches"] == 0
                  and rt["sdc_fingerprint_mismatches"] == 0,
                  f"21a (1): rank {r['rank']} sentinel {rt}")
        check(committed == [MESH_PREEMPT_AT],
              f"21a (1): committed steps {committed}")
        # generation 2: every rank restored that step, its fingerprint
        # the saved one, and trained to MESH_345M_STEPS
        for r in second:
            check(r["restored_step"] == MESH_PREEMPT_AT
                  and r["restored_fingerprint"]
                  == first[0]["saved_fingerprint"]
                  and r["runtime"]["step"] == MESH_345M_STEPS,
                  f"21a (2): rank {r['rank']} restored "
                  f"{r.get('restored_step')}, fingerprint "
                  f"{r.get('restored_fingerprint')} against "
                  f"{first[0]['saved_fingerprint']}")
        losses = first[0]["losses"] + second[0]["losses"]
        drift = [abs(x - y) for x, y in zip(losses,
                                            losses4[:MESH_345M_STEPS])]
        check(len(losses) == MESH_345M_STEPS
              and max(drift) <= MESH_345M_LOSS_ATOL,
              f"21a: losses {losses} against phase 4's "
              f"{losses4[:MESH_345M_STEPS]}: drift {drift} above "
              f"{MESH_345M_LOSS_ATOL}")
        launches_1 = _check_generation("21a (1)", first, MESH_PREEMPT_AT, 1)
        launches_2 = _check_generation(
            "21a (2)", second, MESH_345M_STEPS - MESH_PREEMPT_AT, 0)
        with open(os.path.join(tel_a, "metrics.gang.jsonl")) as f:
            merged = [json.loads(line) for line in f]
        check([m["step"] for m in merged] == list(range(
            1, MESH_345M_STEPS + 1)) and all(
            m["ranks_reported"] == TRAIN_MESH_RANKS for m in merged),
            f"21a: merged records {merged}")
        steps_ms = [x for r in (first[0], second[0]) for x in r["step_ms"]]
        a_out = dict(
            losses=losses, phase4_losses=losses4[:MESH_345M_STEPS],
            loss_drift=drift,
            grad_norms=first[0]["grad_norms"] + second[0]["grad_norms"],
            step_ms=[r["step_ms"] for r in first + second],
            step_ms_median=statistics.median(steps_ms[1:]),
            tokens_per_s=8 * 1024 / (statistics.median(steps_ms[1:])
                                     / 1e3),
            peak_gb=[r["max_memory_allocated_gb"] for r in first + second],
            reserved_gb=[r["max_memory_reserved_gb"]
                         for r in first + second],
            # each generation's collectives reaching gloo over its fit
            # (generation 1: its steps, the replay, the census and the
            # save's gathers; 2: the restore's census and one step)
            collectives=[first[0]["collectives"], second[0]["collectives"]],
            collective_ms_per_step=[r["collective_ms_per_step"]
                                    for r in first + second],
            fit_s=[[r["fit_s"] for r in first], [r["fit_s"] for r in second]],
            preempted_at=MESH_PREEMPT_AT, committed_steps=committed,
            fingerprint=first[0]["saved_fingerprint"],
            runtime=[[r["runtime"] for r in first],
                     [r["runtime"] for r in second]],
            merged_records=len(merged),
            # the training steps' launches (the replay's apart), and all
            # of both generations'
            launches={k: [x - r["replay_launches"].get(k, 0) + y
                          for x, y, r in zip(launches_1[k], launches_2[k],
                                             first)]
                      for k in launches_1},
            gang_resilience_launches={k: [x + y for x, y in zip(
                launches_1[k], launches_2[k])] for k in launches_1})
        emit("train_mesh_345M", **a_out, nvidia_smi=card)
        # 21b: the 6.7B width at fsdp 4, moments a quarter, the save
        for r in b:
            check(r["mesh"] == {"pipe": 1, "data": 1, "fsdp": 4, "seq": 1,
                                "tensor": 1}
                  and r["qkv_block"] == [SIXB_LAYERS, 4096, 3, 32, 128],
                  f"21b: rank {r['rank']}: {r['mesh']} {r['qkv_block']}")
            check(all(np.isfinite(r["losses"])), f"21b: {r['losses']}")
        # the tied head's init variance: ln V + hidden · 0.02² / 2
        expect = float(np.log(50304) + 4096 * 0.02 ** 2 / 2)
        check(abs(b[0]["losses"][0] - expect) < 0.1,
              f"21b: first loss {b[0]['losses'][0]}, want {expect} ± 0.1")
        cfg = load_config(SIXB_YAML, SIXB + [
            "Distributed.fsdp_degree=1",
            "Distributed.sharding.sharding_degree=1",
            f"Engine.save_load.ckpt_dir={ckpt}"], world_size=1)
        t0 = time.monotonic()
        one = EagerEngine(cfg, GPTModule(cfg), device=dev, mode="eval")
        params = one.prepare()
        fp = params_fingerprint(jax_leaves(params))
        load_s = time.monotonic() - t0
        check(fp == b[0]["fingerprint"],
              f"21b: one rank's load of the gang's save fingerprints {fp}, "
              f"the gang {b[0]['fingerprint']}")
        del one, params
        b_out = dict(
            layers=SIXB_LAYERS, losses=b[0]["losses"],
            grad_norms=b[0]["grad_norms"],
            step_ms=[r["step_ms"] for r in b],
            step_ms_median=statistics.median(b[0]["step_ms"][1:]),
            tokens_per_s=4 * 2 * 1024 / (statistics.median(
                b[0]["step_ms"][1:]) / 1e3),
            peak_gb=[r["max_memory_allocated_gb"] for r in b],
            reserved_gb=[r["max_memory_reserved_gb"] for r in b],
            moment_blocks=b[0]["moment_blocks"],
            collectives_per_step=b[0]["collectives"] / SIXB_STEPS,
            collective_ms_per_step=[r["collective_ms_per_step"]
                                    for r in b],
            fingerprint=fp, one_rank_load_s=load_s,
            launches=_per_rank_launches("21b", b, {
                "flash_attention_fwd": 2 * SIXB_LAYERS,
                "flash_attention_bwd_fused": SIXB_LAYERS,
                "fused_norm_fwd": 4 * SIXB_LAYERS + 1,
                "fused_norm_bwd": 2 * SIXB_LAYERS + 1}, SIXB_STEPS))
        emit("train_mesh_6.7B", **b_out, nvidia_smi=card)
        c_out = _check_pair(pair)
        emit("per_rank_pair", **c_out, nvidia_smi=card)
        out.update(a=a_out, b=b_out, c=c_out)
    finally:
        for gang in gangs:
            _stop_gang(gang)
        shutil.rmtree(root, ignore_errors=True)
    emit("train_mesh", **{k: v for k, v in out.items()
                          if k not in ("a", "b", "c")})
    torch.cuda.empty_cache()
    return out


def train_mesh_alone(dev: torch.device, card: str) -> None:
    """``--train-mesh``: phase 1b's head-offset checks, phase 4 (whose
    first losses 21a is held to) and phase 21."""
    timed("1 offsets", _offset_checks, dev)
    trainer = timed("4", phase_trainer, dev, card)
    timed("21", phase_train_mesh, dev, card, trainer["losses"])
    emit("train_mesh_alone", phase_walls=PHASE_WALLS, nvidia_smi=card)


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from fleetx_tpu_torch.kernels import build

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = phase_env(build)
    modes = {"--paged-shapes", "--serving", "--eval-export",
             "--fp16-resilience", "--train-paths", "--finetune-serving",
             "--gpt-knobs", "--encoders", "--families", "--norm-shapes",
             "--telemetry", "--resilience-runtime", "--router-corpus",
             "--mesh", "--train-mesh"}
    if argv:
        # a part of the run alone, on whatever tree this script sits in (an
        # earlier commit's included, to compare in one call); no result
        # line. --paged-shapes: row 7's three timings; --serving: phase 2
        # and its trace; --eval-export: phases 10-11 and row 1 at the eval
        # shape on a checkpoint of seeded weights (cut to CUT_LAYERS);
        # --fp16-resilience: phase 1b's fp16 rows, phase 4 and phase 12;
        # --train-paths: phases 4 and 6; --finetune-serving: phases 2, 4,
        # 8, the tokenizer and corpus of 9-10, and 13; --gpt-knobs: phases
        # 4 and 14; --encoders: phase 15; --families: phase 16;
        # --norm-shapes: phase 1d (row 5's routes: checks, timings in
        # turns, host µs; on an earlier tree its one route's timings);
        # --telemetry: phases 4 and 17 (no slo_report: phase 2 did not run);
        # --resilience-runtime: phases 4 and 18 (no synchronous save to
        # set beside the asynchronous one: phase 8 did not run);
        # --router-corpus: phase 19 on a checkpoint of seeded weights;
        # --mesh: phase 20 on a checkpoint of seeded weights;
        # --train-mesh: phase 1b's head-offset checks, phase 4 and phase 21
        if not set(argv) <= modes:
            print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
            return 2
        if "--telemetry" in argv:
            build.build(["flash_attention", "fused_norm"])
            trainer = phase_trainer(dev, card)
            timed("17", phase_telemetry, dev, card, trainer["losses"])
            reset_peak(dev)             # the last phase's garbage too
            emit("telemetry_alone", phase_walls=PHASE_WALLS,
                 collect_freed_bytes=COLLECT_FREED,
                 collect_holders=COLLECT_HOLDERS, nvidia_smi=card)
            print(smi_line(), flush=True)
            return 0
        if "--resilience-runtime" in argv:
            build.build(["flash_attention", "fused_norm"])
            trainer = phase_trainer(dev, card)
            timed("18", phase_resilience_runtime, dev, card,
                  trainer["losses"], None)
            reset_peak(dev)
            emit("resilience_runtime_alone", phase_walls=PHASE_WALLS,
                 collect_freed_bytes=COLLECT_FREED,
                 collect_holders=COLLECT_HOLDERS, nvidia_smi=card)
            print(smi_line(), flush=True)
            return 0
        if "--train-mesh" in argv:
            build.build(["flash_attention", "fused_norm"])
            train_mesh_alone(dev, card)
            print(smi_line(), flush=True)
            return 0
        if "--mesh" in argv:
            build.build(["paged_attention", "flash_attention", "fused_norm"])
            mesh_alone(dev, card)
            print(smi_line(), flush=True)
            return 0
        if "--router-corpus" in argv:
            build.build(["paged_attention", "flash_attention", "fused_norm"])
            router_corpus_alone(dev, card)
            print(smi_line(), flush=True)
            return 0
        if "--norm-shapes" in argv:
            timed("1d", phase_norm_fwd, build, dev, card)
            print(smi_line(), flush=True)
            return 0
        if "--encoders" in argv:
            encoders_while_building(build, dev, card)
            reset_peak(dev)
            emit("encoders_alone", phase_walls=PHASE_WALLS,
                 collect_freed_bytes=COLLECT_FREED,
                 collect_holders=COLLECT_HOLDERS, nvidia_smi=card)
            print(smi_line(), flush=True)
            return 0
        if "--families" in argv:
            build.build(["flash_attention", "fused_norm"])
            timed("16", phase_families, dev, card)
            reset_peak(dev)
            emit("families_alone", phase_walls=PHASE_WALLS,
                 collect_freed_bytes=COLLECT_FREED,
                 collect_holders=COLLECT_HOLDERS, nvidia_smi=card)
            print(smi_line(), flush=True)
            return 0
        if "--gpt-knobs" in argv:
            build.build(["flash_attention", "fused_norm"])
            gpt_knobs_alone(dev, card)
            print(smi_line(), flush=True)
            return 0
        if "--finetune-serving" in argv:
            build.build(["paged_attention", "flash_attention", "fused_norm"])
            finetune_serving_alone(dev, card)
            print(smi_line(), flush=True)
            return 0
        if "--eval-export" in argv:
            build.build(["flash_attention", "fused_norm"])
            eval_export_alone(dev, card)
            print(smi_line(), flush=True)
            return 0
        if "--fp16-resilience" in argv or "--train-paths" in argv:
            build.build(["flash_attention", "fused_norm"])
            if "--fp16-resilience" in argv:
                flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8,
                                    device=dev)
                _train_kernel_rows(dev, flush, TRAIN_DTYPES[2:])
                del flush
            trainer = phase_trainer(dev, card)
            if "--train-paths" in argv:
                phase_seq8k_trainer(dev, card)
            if "--fp16-resilience" in argv:
                phase_fp16_resilience(dev, card)
            print(smi_line(), flush=True)
            return 0
        build.build(["paged_attention"])
        if "--paged-shapes" in argv:
            from fleetx_tpu_torch.ops import paged_attention as PA

            flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
            time_paged(PA, dev, flush)
            del flush
        if "--serving" in argv:
            phase_main_path(dev, card)
            phase_trace(dev, card)
        print(smi_line(), flush=True)
        return 0
    encoders, build_s = encoders_while_building(build, dev, card)
    kernels = timed("1", phase_kernels, build, dev, build_s)
    train_kernels = timed("1b", phase_train_kernels, dev)
    seq8k_kernels = timed("1c", phase_split_kernels, dev)
    norm_fwd = timed("1d", phase_norm_fwd, build, dev, card)
    main_path = timed("2", phase_main_path, dev, card)
    timed("2 trace", phase_trace, dev, card)
    timed("3", phase_kernel_vs_gather, dev, card)
    trainer = timed("4", phase_trainer, dev, card)
    timed("5", phase_train_kernel_vs_plain, dev, card)
    seq8k = timed("6", phase_seq8k_trainer, dev, card)
    timed("7", phase_split_and_recompute_on_path, dev, card)
    knobs = timed("14", phase_gpt_knobs, dev, card, trainer)
    families = timed("16", phase_families, dev, card)
    telemetry = timed("17", phase_telemetry, dev, card, trainer["losses"],
                      main_path["serving_snapshot"])
    root = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        resume = timed("8", phase_checkpoint, dev, card, trainer["losses"],
                       root)
        ckpt_dir = timed("8 cut", _cut_checkpoint, dev, root,
                         os.path.join(root, "ckpt"))
        tok_dir = os.path.join(root, "tokenizer")
        generation = timed("9", phase_generation, dev, card, ckpt_dir, root)
        evaluation, export, started = eval_and_export(
            dev, card, root, ckpt_dir, tok_dir, finetune=True)
        finetune, quant = phase_finetune_serving(
            dev, card, root, ckpt_dir, tok_dir, evaluation["corpus_prefix"],
            trainer, main_path, started)
        router_corpus = timed("19", phase_router_corpus, dev, card, root,
                              ckpt_dir, tok_dir)
        mesh = timed("20", phase_mesh, dev, card, root,
                     os.path.join(root, "ckpt"),
                     os.path.join(root, "exported_generation"),
                     export["dp_reference"])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    fp16 = timed("12", phase_fp16_resilience, dev, card)
    sdc = timed("18", phase_resilience_runtime, dev, card, trainer["losses"],
                resume["save_s"])
    train_mesh = timed("21", phase_train_mesh, dev, card, trainer["losses"])
    row1_eval = timed(
        "row 1 eval shape", phase_row1_eval_shape, dev, card,
        train_kernels["bfloat16"]["flash_attention_fwd"]["ms"])
    gen_norm = sum(v["fused_norm_fwd_launches"]
                   for v in generation["strategies"].values())
    by_path = {
        name: {"train_345M": trainer["launches"][name],
               "seq8k": seq8k["launches"][name],
               "resume": resume["launches"][name]}
        for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                     "flash_attention_bwd_dkv", "flash_attention_bwd_fused",
                     "fused_norm_fwd", "fused_norm_bwd")}
    by_path["fused_norm_fwd"]["generation"] = gen_norm
    # phases 10-11: the eval passes (ppl and acc), the timed calls of the
    # exported forward, the measured generation calls through the exported
    # programs
    for name in ("flash_attention_fwd", "fused_norm_fwd"):
        by_path[name]["eval"] = sum(evaluation[k]["launches"][name]
                                    for k in ("ppl", "acc"))
        by_path[name]["export_forward"] = \
            export["forward"]["launches"][name]
    by_path["fused_norm_fwd"]["inference_generation"] = \
        export["inference_generation_launches"]
    # phase 20c: the two data-parallel ranks of tools.inference, one call
    # of the generation export each
    for name in ("flash_attention_fwd", "fused_norm_fwd"):
        by_path[name]["dp_inference"] = \
            mesh["dp_inference"]["launches"][name]
    # phase 12's fp16 path (20 steps): rows 1 and 4 on the tensor cores,
    # rows 5 and 6 on the __half instantiation
    fp16_counts = fp16["fp16_train"]["launches"]
    for name, route in (("flash_attention_fwd", "flash_attention_fwd_tc"),
                        ("flash_attention_bwd_fused",
                         "flash_attention_bwd_fused_tc"),
                        ("fused_norm_fwd", "fused_norm_fwd_fp16"),
                        ("fused_norm_bwd", "fused_norm_bwd_fp16")):
        by_path[name]["fp16_train"] = fp16_counts[name]
        by_path[name]["fp16_train_route"] = fp16_counts[route]
    # phase 13: the LoRA fine-tune (20 steps, its own process) and the
    # quantized replica; the replica's LayerNorms are plain PyTorch, as in
    # the JAX serving decode, so row 5 counts 0 there
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv", "flash_attention_bwd_fused",
                 "fused_norm_fwd", "fused_norm_bwd"):
        by_path[name]["lora_finetune"] = finetune["launches"][name]
    by_path["fused_norm_fwd"]["quant_serving"] = \
        quant["fused_norm_fwd_launches"]
    # phase 14: QAT and dots (10 steps each) and GPT-1.3B through
    # tools.auto (3 steps, full recompute, its own process)
    for name in ("flash_attention_fwd", "flash_attention_bwd_fused",
                 "fused_norm_fwd", "fused_norm_bwd"):
        by_path[name]["qat_train"] = knobs["qat"]["launches"][name]
        by_path[name]["dots_train"] = knobs["dots"]["launches"][name]
        by_path[name]["auto_1.3B"] = knobs["auto"]["launches"][name]
    # phase 15: ERNIE 345M (10 steps) and ViT-B/16 (5 steps) take none of
    # the kernels, as JAX's plain attention and LayerNorms take no Pallas
    for name in ENCODER_ROWS:
        by_path[name]["ernie_train"] = encoders["ernie"]["launches"][name]
        by_path[name]["vit_train"] = encoders["vit"]["launches"][name]
    # phase 16: the MoE GPT (10 steps of 2 micro-batches: 480 / 480 / 980
    # / 980) and its greedy generation (row 5 only); Imagen's base fit,
    # SR-256 step and cascade take none of the kernels, as JAX's plain
    # flax U-Net takes no Pallas
    imagen = families["imagen"]
    for name in ENCODER_ROWS:
        by_path[name]["moe_train"] = families["moe"]["launches"][name]
        by_path[name]["imagen_train"] = imagen["launches"][name]
        by_path[name]["imagen_sr256_train"] = \
            imagen["sr256"]["launches"][name]
        by_path[name]["imagen_cascade"] = \
            families["cascade"]["launches"][name]
    by_path["fused_norm_fwd"]["moe_generation"] = \
        families["moe"]["generation"]["fused_norm_fwd_launches"]
    # phase 17: the telemetry run (10 steps, prefetch on, the profiler
    # window over steps 3-6)
    for name in ENCODER_ROWS:
        by_path[name]["telemetry_train"] = telemetry["launches"][name]
    # phase 18: 8 steps and 4 sentinel replays (12 x 24 / 24 / 49 / 49)
    for name in ENCODER_ROWS:
        by_path[name]["sentinel_train"] = sdc["launches"][name]
    # phase 19c: 20 steps on the blended docs corpus (20 x 24 / 24 / 49 /
    # 49)
    for name in ENCODER_ROWS:
        by_path[name]["corpus_train"] = \
            router_corpus["corpus"]["launches"][name]
    # phase 21: the training gangs, the ranks' launches summed (21a: its 4
    # training steps of 24 / 24 / 49 / 49 a rank over both generations,
    # and gang_resilience: all of both generations', the sentinel's replay
    # included; 21b: 3 steps of 2 / 1 / 5 / 3 a rank, 1 layer under full
    # recompute; 21c per_rank_pair: two 4-layer replicas, 9 steps and a
    # replay each); per rank in the phase's lines
    for name in ENCODER_ROWS:
        by_path[name]["train_mesh_345M"] = sum(
            train_mesh["a"]["launches"][name])
        by_path[name]["gang_resilience"] = sum(
            train_mesh["a"]["gang_resilience_launches"][name])
        by_path[name]["train_mesh_6.7B"] = sum(
            train_mesh["b"]["launches"][name])
        by_path[name]["per_rank_pair"] = sum(
            train_mesh["c"]["launches"][name])
    # every path's norm forward launches by route: read_counts (and the
    # eval and fine-tune processes' own counts, checked where read) hold
    # each path's launches all on "rows", none on "row_block"
    norm_routes = {path: {"rows": n, "row_block": 0}
                   for path, n in by_path["fused_norm_fwd"].items()
                   if not path.endswith("_route")}
    bf16 = kernels["bfloat16"]
    rows = [{
        "name": "paged_attention_decode", "route": "cuda",
        "source": "fleetx_tpu_torch/csrc/paged_attention.cu",
        "replaces": "fleetx_tpu/ops/paged_attention.py:144",
        "launches": main_path["kernel_launches"],
        "max_abs_err": bf16["max_abs_err"], "ms": bf16["ms"],
        "plain_ms": bf16["plain_ms"], "bound_ms": bf16["bound_ms"],
        "bound_by": bf16["bound_by"], "library_ms": bf16["library_ms"],
        # "bulk_split": the split page walk with bulk copies (every
        # geometry the gate admits); the ragged shape above, all three
        # shapes below, launches per decode step of phase 2
        "variant": bf16["variant"], "shapes": bf16["shapes"],
        "launches_per_decode_step": main_path["launches_per_decode_step"],
        "launches_by_path": {
            "serving": main_path["kernel_launches"],
            "serving_from_ckpt": generation["cross_check"][
                "replica_paged_launches"],
            "quant_serving": quant["kernel_launches"],
            # phase 19a: the two in-process replicas behind the router
            "router_fleet": router_corpus["router"]["kernel_launches"],
            # phase 20: every rank of the 2 x 2 mesh replica, summed (20a
            # f32 through tools.serve, 20b bf16)
            "mesh_serving": mesh["replica_f32"]["launches"],
            "mesh_serving_bf16": mesh["bf16"]["launches"]},
        # phase 1: row 7 on a shard of the mesh's pool (8 and 4 heads,
        # foreign pages as scattered -1 entries)
        "shard_shapes": [{k: v for k, v in r.items() if k != "plan"}
                         for r in kernels["shard_shapes"]],
    }]
    # timings at the shapes of the path whose run gives the launches: the
    # seq-8192 trainer (phase 6) for the forward, the split pair and the
    # norms; the 345M trainer (phase 4) for the fused backward
    for name, source, replaces, timing, run in (
            ("flash_attention_fwd", "flash_attention.cu",
             "fleetx_tpu/ops/flash_attention.py:170", seq8k_kernels, seq8k),
            ("flash_attention_bwd_dq", "flash_attention.cu",
             "fleetx_tpu/ops/flash_attention.py:268", seq8k_kernels, seq8k),
            ("flash_attention_bwd_dkv", "flash_attention.cu",
             "fleetx_tpu/ops/flash_attention.py:313", seq8k_kernels, seq8k),
            ("flash_attention_bwd_fused", "flash_attention.cu",
             "fleetx_tpu/ops/flash_attention.py:431",
             train_kernels["bfloat16"], trainer),
            ("fused_norm_fwd", "fused_norm.cu",
             "fleetx_tpu/ops/fused_norm.py:110", seq8k_kernels, seq8k),
            ("fused_norm_bwd", "fused_norm.cu",
             "fleetx_tpu/ops/fused_norm.py:133", seq8k_kernels, seq8k)):
        row = timing[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"fleetx_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": run["launches"][name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            # the flash rows: which kernel of the route ran ("wgmma": the
            # tensor-core kernels; "simt": f32 products)
            **({"variant": row["variant"]} if "variant" in row else {}),
            # launches on every path that runs the kernel, each counted
            # from 0 around its own run
            "launches_by_path": by_path[name],
            # row 5's route on every path, its per-route launches, its
            # two routes and add + F.layer_norm in turns at the main paths'
            # shapes, the one-token decode rows (the generation path) with
            # the host µs a call, bf16 against fp16 in turns (phase 1d)
            **({"variant": "rows", "launches_by_route": norm_routes,
                "decode_shape": dict(norm_fwd["shapes"]["decode"],
                                     host=norm_fwd["host"]),
                "shapes": {k: v for k, v in norm_fwd["shapes"].items()
                           if k != "decode"},
                "fp16_turns": norm_fwd["fp16_turns"],
                "check": norm_fwd["check"]}
               if name == "fused_norm_fwd" else {}),
            # a rank's block of the 345M launch (phase 1b, head map
            # ``OFFSET_HEADS``): the largest error against the plain
            # version with the same map, f32 and bf16
            **({"head_offsets": {
                dt: train_kernels["offsets"][dt][
                    {"flash_attention_fwd": "fwd",
                     "flash_attention_bwd_fused": "fused",
                     "flash_attention_bwd_dq": "dq",
                     "flash_attention_bwd_dkv": "dkv"}[name]]
                for dt in ("float32", "bfloat16")}}
               if name.startswith("flash_") else {}),
            # the forward at the eval path's shape, no dropout
            **({"eval_shape": row1_eval}
               if name == "flash_attention_fwd" else {}),
            # the forward and the fused backward at GPT-1.3B's attention
            # shape (phase 14c's path), dropout 0.1
            **({"shape_1.3B": knobs["shape_1.3B"][name]}
               if name in knobs["shape_1.3B"] else {}),
            # fp16 at the 345M training shape (phase 1b); rows 1 and 4
            # also on layer 24's inputs at the loss-scaled dO (phase 12)
            **({"fp16": dict(
                train_kernels["float16"][name],
                **({"layer24_scaled_dO": fp16["fp16_train"][
                    "scaled_cotangents"]}
                   if name == "flash_attention_bwd_fused" else {}))}
               if name in train_kernels["float16"] else {})})
    reset_peak(dev)                     # the last phase's garbage too
    emit("smoke", seconds=time.perf_counter() - t_start,
         fp16_resilience_seconds=fp16["seconds"], phase_walls=PHASE_WALLS,
         collect_freed_bytes=COLLECT_FREED,
         collect_holders=COLLECT_HOLDERS, nvidia_smi=card)
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
