#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``unionml_tpu_torch``) on one NVIDIA H100.

Run from the repository root on a machine with one CUDA card::

    python3 chip_smoke.py

Phases (no phase catches a failure; any fault exits non-zero):

1. print the card's name and power limit; build every kernel from ``csrc/``;
2. hold each kernel against its plain PyTorch twin (float32 and bfloat16):
   paged decode at the served shapes (D = 128, and D = 64 for the
   speculative draft) and at the length limits (0, 1, page edges, ragged,
   the full table, past it) for D = 16, 32, 64 and 128, two calls bitwise
   equal; its int8-page mode (int8 pages, f32 scales per position and head)
   in float32 and bfloat16 q at D = 16, 24, 40, 64, 128 and 256 over the
   same lengths and at D = 128 on pools off a 16-byte boundary, two calls
   bitwise equal, each case printing the route it took (``mma``: tensor
   cores over staged pages, bf16 q at D % 16 == 0; ``direct``: CUDA cores,
   rows loaded directly, every other case; both routes must launch) and the
   ring's stages, timed beside its twin (the int8 gather
   route), SDPA on the gathered dequantized K/V, its bytes bound and the
   bf16-page kernel at the three paged shapes; the flash kernels at full width
   causal, non-causal, cross-length causal and custom blocks: in float32 the
   f32 forward and the fused f32 backward (3xTF32; also at D=50 and with
   tensors off a 16-byte boundary), in bfloat16 the tensor-core forward and
   the fused backward (also at D=64, ragged); each bitwise equal on a second
   call; the
   int8 matmul at every Llama-3-8B weight shape at M = 4, 256, 5,
   130, 1, 8, 9, 64 and 20 (the speculative verify of 4 slots x (gamma +
   1); 5 is one row's), and bitwise equal on a second call; then time
   kernel, twin, the library yardstick and the
   bytes/operations bound with CUDA events (paged decode at the served
   shape, B=8 ctx=2048 and B=1 ctx=8192; the bf16 forward and the fused
   backward at full width, the f32 forward and the fused f32 backward at the
   f32 parity shape S=256 and at S=2048, each beside SDPA's memory-efficient
   kernels in f32) (int8 also summed over one decode
   step's 225 matmuls, at M = 4, 64 and 256); each kernel's time includes its host launch work, and
   a second, device-only time (``device_ms``) is taken behind a measured spin
   of the card, sized to four times the host's enqueue of the timed call;
3. serve a Llama-3-8B-width model (32 layers, bf16, random weights from a
   seed) through ``ContinuousBatcher``: 4 concurrent streams x 32 tokens,
   counting paged kernel launches on this path; then serve the same weights
   through ``Generator(quantize="int8")`` (the model held in int8, under
   10 GiB), counting 225 int8 matmul launches per forward and the paged
   kernel's;
   3c. structured decoding at the same width (bf16, 32 layers, seed 0): four
   grammars compiled over a synthetic 128,256-token vocabulary, an engine
   warmed with ``warmup()``; grammar 0 (FREE) streams equal an unconstrained
   engine's, grammar 1-4 streams with ``logprobs=True`` emit only tokens
   their DFA allows, and a 2-layer f32 constrained engine on the card equals
   the port on the CPU (tokens, logprobs within 1e-4);
4. token parity at float32 with 2 layers of the same width: the engine's
   streams (kernel path) equal a solo ``Generator`` run on the gather path;
   with int8 weights, the engine, a solo run and a solo run with chunked
   prefill on the card (int8 kernel) equal the same weights' run on the CPU
   (the twins);
5. LoRA fine-tune a Llama-3-8B-width model (32 layers, bf16 compute, f32
   parameters, random weights from a seed) through ``fit`` for 6 steps of
   one 2048-token sequence, counting flash kernel launches on this path (the
   bf16 forward and the fused backward; no f32 kernel), and check finite
   losses, a frozen base and moved adapters;
6. training parity with 2 layers of the same width: 3 steps of ``fit`` on
   the kernel path and on the plain path agree, at float32 (through the
   f32 forward and the fused f32 backward, whose launches the kernels line
   reports) and at bf16 compute (through the bf16 forward and the fused
   backward).
7. the app protocol (``Dataset``/``Model``, with no pandas): (a) at
   Llama-3-8B width (LoRA rank 8, f32 parameters, bf16 compute)
   ``model.train`` runs 3 steps of ``fit`` through the bf16 flash forward and
   fused backward (32 launches of each a step), ``model.predict`` twice over
   4 prompts through a ``Generator`` (equal outputs), and the stream
   predictor over 4 concurrent prompts through a ``ContinuousBatcher`` (the
   paged decode kernel); (b) the same app at the text-generation template's
   width in float32: the losses through the f32 flash kernels equal the
   plain path's, the stream predictor's tokens equal ``model.predict``'s,
   ``save`` then ``load`` predicts the same on the card (tensors on the
   card) and, loaded with ``hyperparameters={"device": "cpu"}``, the same
   greedy tokens on the CPU; (c) the native records parser builds (``g++``)
   and parses a records payload. The kernels line gives each kernel's
   launches on this path as ``app_launches``.
8. the serving half: phase 3's weights behind ``Model.serve()`` on a loopback
   port (``http_launches``);
9. speculative decoding and beam search: (a) phase 3's bf16 target with a
   draft at the shapes of Llama-3.2-1B (dim 2048, 16 layers, untied head,
   random weights from seed 2), ``gamma=4``, 4 streams x 32 tokens through
   the engine: tok/s, TTFT, TBT, rounds and acceptance, the paged launches
   required to be 16 x (gamma + 1) x rounds (``spec_launches``), then the
   target as its own draft; (b) float32, 2 layers (phase 4's weights): the
   speculative engine, paged and dense, equals the solo plain ``Generator``
   with a 2-layer and a 1-layer 1B-shaped draft and with the target itself
   (which accepts every proposal), ``beam_search`` at width 1 equals greedy
   and at width 4 equals the CPU, and with int8 target and draft the
   streams equal the plain int8 ``Generator``'s, counting int8 launches at
   M = 20; (c) phase 3's weights served over int8 pages (the gather route),
   then the int8-page kernel against its twin on that engine's live pools
   of every layer (each launch by the tensor-core route), timed on one.
10. chunked admission and shared-prefix reuse: (a) phase 9's bf16 target
   behind a 100-token system prompt (numpy seed 3, ``cache_prefix``: 6 full
   pages and a 4-token tail) in ``ContinuousBatcher(slots=4,
   decode_chunk=8, block_size=16, admit_chunk=64, prefill_budget=128,
   max_admissions=2, prefix_cache=True)``, warmed with ``warmup()``: phase
   3's prompts cold, the same prompts again (radix hits, equal streams), and
   each prompt cut at an odd length and diverging (copy-on-write inside a
   shared block); per wave tok/s, TTFT, chunks, hits and tokens avoided; the
   chunks are required to be the chunk-aligned widths over 64 and the paged
   launches 32 x 8 a dispatch (``prefix_launches``); (b) float32, 2 layers
   (phase 4's weights, TF32 off): chunked admission without a prefix, with
   the static prefix, with the prefix and the radix cache (two waves), and
   the speculative engine (phase 9b's 2-layer draft) under ``admit_chunk``
   and the prefix, each equal to the solo ``Generator(...)(prompts,
   prefix=...)`` on the card.

11. the serve CLI in its own process (``python -m unionml_tpu_torch.cli``):
   (a) its ``init`` renders the text-generation template into a temporary
   directory, which phase 20a trains through the remote backend and serves;
   (b) an app module the
   phase writes around phase 3's model cut to ``CLI_LAYERS`` layers
   (Llama-3-8B width, bf16, seed 0, ``attention_impl="flash"``), its
   weights saved once as the artifact,
   served in this process through ``Model.serve()`` and by the CLI with
   ``--admit-chunk 64 --prefix-cache``: phase 3's prompts stream the same
   tokens from both; a second wave runs under the child's ``POST
   /debug/profile`` capture, whose Chrome trace gives the paged kernel's
   launches in the child (``cli_launches``, exactly CLI_LAYERS x the wave's
   dispatches x 8); (c) the analyzer: the CLI child ``lint unionml_tpu_torch
   --format json`` exits 0 with no finding over at least 80 files (its
   seconds, then a cold and a warm in-process run), and an ``AOTFunction``
   over a three-line function that calls ``.item()`` on a CUDA tensor fails
   its capture with the store's ``RuntimeError``, on the line the port's
   analyzer flags as TPU001;
12. the routed-experts decoder: (a) ``MoEConfig()`` (vocab 32,000, dim 4096,
   8 layers, every second routed over 8 experts of hidden 14,336, k = 2,
   capacity factor 1.25; bf16 parameters, seed 0) serves 4 prompts x 32
   tokens through a paged ``ContinuousBatcher``: tok/s, TTFT, TBT; no port
   kernel launches (``moe_launches`` on the kernels line, all 0, as in JAX,
   whose MoE attention takes the plain routes); (b) float32, TF32 off, 2
   layers (one dense, one routed) at capacity factor 4 (= experts / k: no
   token dropped): the engine's streams, paged and dense, a speculative
   engine's with a 1-layer draft, and under ``quantize="int8"`` the engine's
   against the plain int8 ``Generator``, each equal to the solo run;
13. the encoder models at their published widths (random weights, seed 0,
   f32 parameters, bf16 compute): (a) ``BertConfig.base()`` fine-tuned 8
   steps of ``fit`` with ``classification_loss`` on SST-2-shaped batches
   (numpy seed 0, B = 32, L = 128, ragged lengths 8-128 under the attention
   mask, 2 classes; the plain route, as a masked call takes in JAX):
   samples/s, losses, no kernel launch; (b) 12 encoder blocks at BERT-base
   width with ``attention_impl="flash"``, one forward and backward of
   unmasked bf16 ``[8, 512, 768]``: exactly 12 bf16 flash forwards and 12
   fused backwards (non-causal, D = 64; ``encoder_launches`` on the kernels
   line), output and input gradient held to the plain route
   (``ENC_FLASH_REL_RMS``) and both to an f32 run, each route's step timed
   in turns with its launch work, and its device time under the profiler;
   (c) ``ViTConfig.large()`` (ViT-L/16 at 224): inference images/s at
   B = 64, 6 steps of ``fit`` at B = 32 (the plain route: 197 positions are
   not tiled by the flash blocks); (d) ``MLPConfig()`` (``BASELINE.json``
   config 2) through ``Model.train`` on 60,000 MNIST-shaped rows and
   ``model.predict`` on 4; (e) float32, TF32 off: 2-layer BERT-base and ViT-L
   and the MLP on the card equal the port on the CPU (forwards and 2 steps of
   ``fit``), and the 13b stack in f32 through the f32 flash kernels equals
   the plain route. 13a, 13c and 13d launch no kernel
   (``encoder_model_launches``).
14. the in-process replica layer on phase 3's configuration and knobs at
   ``REPLICA_LAYERS`` of its 32 layers, run after phase 10a, against one
   engine's streams of phase 3's prompts on the same weights (the
   reference): (a) ``UNIONML_TPU_DP_REPLICAS=2`` makes
   ``ContinuousBatcher(gen, ...)`` a ``ReplicaSet`` of two mixed replicas
   on this card sharing the weights; 8 concurrent streams (phase 3's prompts
   twice) equal the reference's, both replicas serve, the paged launches
   are exactly layers x 8 x the dispatches summed over the replicas
   (``replica_launches``, with (b)'s), the memory grows by at most the two
   pools + 1 GiB; tok/s and TTFT beside one engine of 8 slots on the same
   streams; (b) ``roles={"prefill": 1, "decode": 1}``,
   ``prefill_threshold=64``: the 120- and 250-token prompts hand their KV
   pages off, the others do not, streams the reference's; the handoff's
   export and import timed; (c) (a)'s fleet with 8 streams in flight:
   ``scale_to(3)`` then ``scale_to(1)``, every stream whole and the
   reference's, then the autoscaler armed and joined by ``close``; (d)
   float32, 2 layers: (a)'s and (b)'s fleets on the card equal the same
   fleets on the CPU, and the handoff pages agree within 1e-5 of each leaf's scale.

15. the serving mesh (``unionml_tpu_torch/parallel``; the engine's mesh
   path in ``serving/mesh.py``), run last: (a) phase 3's model through
   ``Generator(mesh=MeshSpec(model=1).build(), partition_rules=
   llama_partition_rules())``, a world of one process over NCCL, and a
   ``ContinuousBatcher`` with phase 3's knobs: streams equal phase 3's, paged
   launches 32 x 8 a dispatch; tok/s and TTFT; (b) the int8 kernel at one
   rank's weight shapes at model=2 against its twin, timed (``tp_shards`` on
   the kernels line); then two processes on cuda:0 over gloo (NCCL refuses
   two ranks on one card; gloo's collectives move CUDA tensors through host
   memory, counted), each holding half the weights, rank 0 serving and rank
   1 following its step plans: Llama-3-8B width bf16 at model=2, 8 of its
   32 layers (``MESH_SERVE_LAYERS``; seed 0, phase 3's knobs and prompts;
   first-token logits within ``MESH_LOGITS_REL_RMS`` of the unsharded run
   at that depth; on each rank 16 query and 4 KV heads, paged launches
   exactly 8 x 8 x the dispatches, one launch on its live layer-0 pool
   equal to the twin; rank 0's host time a decode step; memory a rank;
   tok/s and TTFT), the same with ``quantize="int8"`` (57 int8 launches a
   forward on each rank), ``sp_prefill="ring"`` at sequence=2 on
   a 2048-token prompt, ``MoEConfig()`` at expert=2, speculative decoding
   at model=2 (phase 9a's 1B-shaped draft, ``MESH_DRAFT_LAYERS`` of its 16
   layers, gamma 4, placed under ``llama_partition_rules()``: tok/s, TTFT,
   rounds, acceptance rate, rank 0's host time and gloo transfers a round,
   memory a rank; on each rank the draft's 16 query and 4 KV heads of D =
   64, paged launches exactly draft layers x (gamma + 1) x rounds, one
   launch on its live draft pool equal to the twin); and the same five in
   f32 at 2 layers, TF32 off, each token for token equal to the unsharded
   card run, the speculative one (the target as its own draft, cut under
   ``llama_partition_rules()``, one stream at a time) also to the
   target-only run, and its rounds, accepted and proposed counts equal to
   the unsharded run's, at an acceptance of ``SPEC32_ACCEPTANCE`` or more
   (the mesh against the CPU is held by the CPU tests). The
   ranks run the f32 five first, while the parent computes those
   references, and the timed bf16 five once it is done: their times share
   the card and the host with nothing. Every kernel is counted on every
   rank in every case, and ``OFF_MESH_PATH``'s must count 0;
   ``tp_launches`` on the kernels line is rank 0's count over the ten
   served runs, ``spec_mesh_launches`` its count over the speculative one.
   Then, in the same world, the AOT store over the mesh
   (``MESH_AOT_CASES``): each program captured in segments between its
   collectives, which run eagerly between the graphs. f32 tp32, sp32 (ring
   admission) and moe32 on empty stores, and bf16 model=2 and its int8
   twin on an empty store (a miss) and then a fresh ``Generator`` and
   engine on the populated store with the kernel build cache at an empty
   directory (a hit), each built afresh from its eager case's seed: streams
   equal the eager case's, paged (and int8) launches a dispatch equal on
   each rank, a miss compiles on each rank, a hit loads with no capture and
   no ``nvcc``, a hand-driven dispatch moves as many gloo transfers as
   eager's; printed beside eager: tok/s, TBT and TTFT p50, rank 0's host
   and wall ms a decode step, the graphs and collectives of each program
   and the capture ms (``aot_mesh_launches`` on the kernels line: rank 0's
   count over the hits' served runs).

16. parallel training (``fit`` over a mesh), run after 15: (a) phase 5's
   configuration through ``fit(config=TrainerConfig(mesh=MeshSpec(data=1),
   partition_rules=llama_partition_rules()))``, a world of one over NCCL,
   on phase 5's first 3 batches: losses equal phase 5's, 32 + 32 flash
   launches a step; then the world of one's losses on (b)'s batches; the
   flash kernels against their twins at each rank's local shapes; then two
   processes on cuda:0 over gloo: (c) f32 at 2 layers, TF32 off: LoRA fits
   at data=2, fsdp=2, model=2 and sequence=2 (ring), and ``pipeline_apply``
   at pipe=2 with ``param_specs`` (a 2-layer ``PipelinedViT`` at ViT-L
   width), each against the unsharded card run and the CPU, which the
   parent computes meanwhile; (b) Llama-3-8B width, MESH_TRAIN_LAYERS deep, built on the
   meta device and drawn leaf by leaf on the card (each rank holds its
   shard of the f32 model only), LoRA rank 8, ``make_train_step(remat=
   True)``, 2 steps of a 2 x 1024 global batch at fsdp=2 and at model=2:
   losses within ``MESH_TRAIN_LOSS_REL`` of the world of one, and each
   rank's shards of the last step's LoRA gradients and of the adapters'
   moves within ``MESH_TRAIN_GRAD_REL`` and ``MESH_TRAIN_MOVE_REL`` of the
   world of one's; samples/s, ms a step, memory a rank, gloo host transfers
   a step, flash launches a rank at its local heads (32/8 and 16/4), a
   base shard kept and an adapter shard moved; (d) ``PipelinedViT`` at
   ViT-L/16 width at pipe=2, 4 microbatches of a 32-image batch, 2 Adam
   steps, losses within ``VIT_MESH_LOSS_REL`` of the unpipelined ``ViT`` on
   the same weights, images/s. Every kernel is counted on every rank in
   every case, and all but the four flash kernels must count 0.
   ``train_mesh_launches`` on the kernels line is 16a's and rank 0's 16b
   count, ``train_mesh_f32_launches`` rank 0's over 16c.

17. the cold start (``unionml_tpu_torch/serving/aot.py``, ``compile_cache.py``,
   ``serving/serverless.py``): (a) run after 3c on phase 3's configuration,
   knobs and prompts at ``AOT_LAYERS`` of its 32 layers: an eager engine,
   ``aot=DIR`` on an empty store (a miss: each program run once and
   captured as a CUDA graph, its entry written) and a fresh ``Generator``
   and engine on the populated store with the kernel build cache pointed at
   an empty directory (a hit: the libraries installed from the store, no
   ``nvcc``, no fresh capture); greedy streams of the miss and the hit equal
   the eager engine's; each kernel's launches in the profiler's trace of a
   served run equal on the graph route and the eager one (and the eager
   route's trace equals its wrappers' counts; the counts a graph adds per
   replay are a cross-check); a seeded ``temperature=0.8`` pair
   equal token for token, a program that reads a value back on the host
   refuses its capture with an error; the same weights under
   ``quantize="int8"``, eager against graph (the int8 matmul inside the
   graphs); printed: both routes' TBT p50, tok/s, TTFT p50, the device's
   idle share of a served run (profiled) and ``warmup()``'s seconds on a
   miss and on a hit (``aot_launches`` on the kernels line: the traced
   launches of the graph route's runs, bf16 hit and int8); (b) after phase
   11b (whose child serves on the eager route), a child boots with
   ``--aot-preload DIR --compile-cache DIR2`` on empty directories (it
   builds its kernels and writes the store), then a second child on the
   same directories, loading every program and building nothing, its wave
   under its own profiler (the graph route's paged launches from its
   trace); both stream 11b's in-process answers; seconds to ready of both;
   (c) ``lambda_handler`` over that app in this process on
   the populated store: two invocations, one startup, nothing compiled.
18. the multi-host fleet (``serving/cluster.py``): (a) a worker host beside
   a ``LocalHost`` at 32 layers, mixed then prefill/decode, then a
   SIGKILL; (b) two CLI children, ``serve --num-hosts 2``, over 11b's app;
   (c) a gloo world of 4 ranks on cuda:0, 2 hosts x tp=2, f32.
19. workload replay (``unionml_tpu_torch/workloads``): (a) inside phase 8,
   on its 32-layer app and loopback port, ``chat_multiturn``,
   ``burst_tenants`` and ``deadline_heavy`` (seed 0) replay through the
   app's HTTP dispatch and ``rag_long_prompt`` over the socket
   (``target=``): every request answered or shed, every completed greedy
   stream equal to ``engine.submit`` on its final prompt (session history
   included), the paged kernel launched (``replay_launches``), each report's
   per-tenant TTFT/TBT p50/p95, schedule adherence and verdicts printed;
   (b) ``python -m unionml_tpu_torch.cli replay scenario:chaos_fleet
   --target`` against 18b's fleet while it is up, and ``replay
   scenario:chat_multiturn --self-host llama_app:model`` over 11b's app and
   artifact, each report parsed, its exit code and verdicts printed.
20. the remote backend (``remote.py``, ``job_runner.py``): (a) 11a's
   template through the CLI: ``deploy --allow-uncommitted``, ``train`` (a
   ``job_runner`` child trains it on the card with its own schedule),
   ``list-model-versions``, ``predict --features`` in a second child,
   ``fetch-model``; ``serve`` boots the fetched artifact and ``serve
   --remote`` the registry's, each streaming a ``@word``; (b) phase 7's
   LoRA app as a module at Llama-3-8B width, ``REMOTE_LAYERS`` of 32
   layers, bf16: ``remote_train`` through ``LocalProcessLauncher`` (2 steps
   of 1 x 2048, numpy seed 0), ``remote_predict`` of 4 prompts in a second
   child; the children's flash and paged launches read back from their
   logs (``remote_launches``), their seconds and peak memory printed, and
   the artifact, fetched and loaded here, predicts the remote job's tokens.

Phase 10a also holds bf16 chunked admission to monolithic admission behind
the same prefix on the first token's logits (``CHUNKED_LOGITS_REL_RMS``).

``--profile`` adds one more served run (bf16 and int8), one more training
step, one BERT-base fine-tune step and one wave of phase 14a's fleet and of
its 8-slot engine under ``torch.profiler`` and prints each device-time
breakdown (kernel time by name, the device's idle share).

Prints one ``{"kernels": [...]}`` line and ends with
``{"ok": true, "device": {...}}``. Exits non-zero without a result when no
CUDA device is present or the package is missing.
"""

import collections
import contextlib
import dataclasses
import functools
import gc
import importlib
import json
import math
import statistics
import subprocess
import sys
import threading
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
SPIN_CYCLES = 2_000_000  # the unit of the card's spin before a device-only time; its length is measured in the run
PEAK_OPS_PER_S = {"torch.bfloat16": 989e12, "torch.float32": 67e12}  # dense bf16 tensor / f32 non-tensor
#: the least time of f32 flash work: an f32-accurate product in three TF32 tensor-core passes (3xTF32) at
#: NVIDIA's H100 SXM dense TF32 rate, 494.7 TFLOP/s, beats the 67 TFLOP/s of f32 FMAs on the CUDA cores
F32_FLASH_OPS_PER_S = 494.7e12 / 3
TOLERANCE = {"torch.float32": (1e-5, 0.0), "torch.bfloat16": (2e-2, 2e-2)}  # (atol, rtol)
#: flash kernels against their twins: in float32 both compute in f32 (the
#: backward's products in 3xTF32, about 2**-22 of each product off), and the
#: dk/dv sums of 2048 x 4 terms at full width run in another order; in
#: bfloat16 both round P (forward and backward) and dS to bf16 before their
#: products (a last-bit difference in exp can flip one rounding), sum in f32
#: in other orders, and the outputs round to 8 bits of mantissa
FLASH_TOLERANCE = {"torch.float32": (1e-4, 1e-5), "torch.bfloat16": (2e-2, 2e-2)}
#: (label, Lq, Lk, causal, blocks) at H=32, Hkv=8, D=128, B=1
FLASH_CASES = (
    ("full width causal L=2048", 2048, 2048, True, None),
    ("non-causal L=512", 512, 512, False, None),
    ("cross-length causal Lq=256 Lk=512", 256, 512, True, None),
    ("blocks=(64,64) causal L=192", 192, 192, True, (64, 64)),
)
#: (label, Lq, Lk, causal, D, misaligned, (B, H, Hkv)) held beside FLASH_CASES: in bfloat16 a ragged D=64 case for
#: the bf16 kernels; in float32 a head dim that is not a multiple of 4 (4-byte copies) and tensors that start 4 bytes
#: past a 16-byte boundary; in both, the encoder's shape (phase 13b: BERT-base heads, non-causal, no GQA)
FLASH_HEADS = (1, 32, 8)
ENCODER_FLASH_CASE = ("encoder non-causal L=512", 512, 512, False, 64, False, (8, 12, 12))
FUSED_EXTRA_CASES = (("ragged D=64 causal L=1000", 1000, 1000, True, 64, False, FLASH_HEADS), ENCODER_FLASH_CASE)
F32_EXTRA_CASES = (("ragged D=50 causal L=1000", 1000, 1000, True, 50, False, FLASH_HEADS),
                   ("misaligned causal L=1000", 1000, 1000, True, 128, True, FLASH_HEADS), ENCODER_FLASH_CASE)
#: products of 2 * Lq * Lk * D multiply-adds (per head, visible pairs only) each kernel computes
FLASH_PRODUCTS = {"flash_forward": 2, "flash_backward": 5, "flash_forward_f32": 2, "flash_backward_f32": 5}
FLASH_REPLACES = {
    "flash_forward": "unionml_tpu/ops/flash_attention.py:160",
    "flash_forward_f32": "unionml_tpu/ops/flash_attention.py:160",
    "flash_backward": "unionml_tpu/ops/flash_attention.py:318 and :343",
    "flash_backward_f32": "unionml_tpu/ops/flash_attention.py:318 and :343",
}
FLASH_SOURCES = {
    "flash_forward": "unionml_tpu_torch/csrc/flash_forward.cu",
    "flash_backward": "unionml_tpu_torch/csrc/flash_backward.cu",
    "flash_forward_f32": "unionml_tpu_torch/csrc/flash_forward_f32.cu",
    "flash_backward_f32": "unionml_tpu_torch/csrc/flash_backward_f32.cu",
}
#: bf16 training parity: relative loss difference between the kernel and plain paths. Both run in bf16
#: (8 significant bits) but round at other places (the plain path rounds its scores to bf16; the kernels
#: keep them in f32), so the losses may differ by about one bf16 epsilon, 2**-7 = 7.8e-3
BF16_PARITY_LOSS_REL = 1e-2
#: (weights, K, F, matmuls of one decode step) of Llama-3-8B: 32 layers of
#: q/o, k/v, wg/wi and wo, and the head; 225 in all
INT8_WEIGHTS = (
    ("q/o", 4096, 4096, 64),
    ("k/v", 4096, 1024, 64),
    ("wg/wi", 4096, 14336, 64),
    ("wo", 14336, 4096, 32),
    ("lm_head", 4096, 128256, 1),
)
INT8_PER_FORWARD = sum(n for *_, n in INT8_WEIGHTS)
#: decode, admission prefill, ragged M and the edges of the N tiles; 20 is the speculative verify of 4 slots x
#: (gamma + 1), 5 one row's verify
INT8_M = (4, 256, 5, 130, 1, 8, 9, 64, 20)
INT8_TIMED_M = (4, 64, 256)  # decode, a chunked-prefill chunk, admission prefill
#: int8 kernel against its twin in f32: both sum exact products in f32, in
#: another order, so |kernel - twin| <= 1e-5 * max|twin|; bf16 is TOLERANCE's
INT8_F32_REL = 1e-5
INT8_MODEL_LIMIT = 10 * 2**30  # bytes the int8 model may hold: the bf16 kernels must be gone
TRAIN_STEPS, TRAIN_SEQ, TRAIN_REMAT = 6, 2048, False
PARITY_STEPS, PARITY_SEQ = 3, 256
LR = 1e-4  # lora_optimizer's default rate
PROMPT_LENS = (5, 40, 120, 250)
INT8_PARITY_NEW = 8
INT8_PARITY_CHUNK = 64  # the 256-token bucket prefills in 4 chunks
MAX_NEW = 32
BLOCK = 16
#: phase 3c: a synthetic vocabulary of the model's width from this seed. Id 0
#: is EOS (empty text, as in the text-generation template), ids 1-95 are the
#: printable ASCII characters, the rest 1-8 characters of this alphabet
STRUCTURED_SEED, STRUCTURED_EOS = 0, 0
STRUCTURED_ALPHABET = "abcdefghijklmnopqrstuvwxyz ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789.,!?:;'\"{}-_"
STRUCTURED_NEW = 16  # tokens a stream of the f32 card-against-CPU parity
STRUCTURED_LP_ATOL = 1e-4  # f32 logprobs, card against CPU: sums in other orders
#: phase 9: the draft for Llama-3-8B at the shapes of Llama-3.2-1B's published config (its LM head untied: the
#: port's Llama has no tied head), random weights from seed 2; gamma draft tokens a round
DRAFT_1B = dict(vocab_size=128256, dim=2048, n_layers=16, n_heads=32, n_kv_heads=8, hidden_dim=8192,
                rope_theta=500000.0)
DRAFT_SEED, GAMMA = 2, 4
BEAM_NEW, BEAM_BUCKET = 8, 64  # the card-against-CPU beam search: 2 prompts, 8 new tokens, a 64-token bucket
#: int8 speculative parity: the int8 kernel rounds its input to bf16 (2**-9 relative), so an f32 difference of one
#: ulp between the verify (M = 20, the gather path) and plain decode (M = 1, dense attention) can move a rounding
#: and the logits by ~1e-3 (their std is ~1 at this width); streams must be equal until the first divergence, and a
#: divergence must be a near-tie: the two tokens the top two of a third path's logits (the plain Generator's
#: prefill of the common prefix), this far apart at most
INT8_TIE_GAP = 0.01
#: phase 10: a system prompt of SYSTEM_LEN tokens from numpy seed SYSTEM_SEED (6 full 16-position pages and a
#: 4-token tail) and the engine's chunked admission: ADMIT_CHUNK columns a chunk, PREFILL_BUDGET a dispatch
SYSTEM_LEN, SYSTEM_SEED = 100, 3
ADMIT_CHUNK, PREFILL_BUDGET, MAX_ADMISSIONS = 64, 128, 2
#: phase 10a: bf16 first-token logits of chunked (GEMM M = 64) against monolithic (M = 256) admission behind the
#: same prefix. A forward rounds 225 matmul outputs to bf16 (7 a layer x 32 layers, and the head), each to 8
#: significant bits; summed in other orders for the two M, any of them may land one bf16 ulp (2**-8 relative)
#: apart. Taken as independent, those differences add in quadrature: the relative RMS difference of the logits
#: (|a - b| / |b| over the vocabulary) stays within sqrt(225) * 2**-8 = 0.0586
BF16_ROUNDINGS = 7 * 32 + 1
CHUNKED_LOGITS_REL_RMS = math.sqrt(BF16_ROUNDINGS) * 2.0 ** -8
#: phase 15: the mesh on the card. (b)'s ranks share cuda:0 over gloo, which moves each CUDA tensor of a
#: collective through host memory (parallel/collectives.py)
MESH_RANKS = 2
#: (b)'s bf16 Llama cases run Llama-3-8B width at MESH_SERVE_LAYERS of its 32 layers (seed 0), cut so that the
#: whole script stays inside its budget once phase 18 joined it (1018.3 s with them at 32 layers, H100 80GB HBM3,
#: 700 W); every layer's shapes and shards are the same, and (a) serves the 32-layer model
MESH_SERVE_LAYERS = 8
#: int8 matmuls of one forward at that depth: 7 a layer and the head
MESH_INT8_PER_FORWARD = 7 * MESH_SERVE_LAYERS + 1
#: (b): bf16 first-token logits of the model=2 run against the unsharded run at the same depth. On top of the
#: 7 x layers + 1 roundings of a forward (as CHUNKED_LOGITS_REL_RMS counts them), each row-parallel product
#: (o_proj and wo: 2 a layer) is summed from two bf16 partial products, each rounded, and their bf16 sum is
#: rounded again: two more roundings each. The column-parallel and head products keep one rounding each (their
#: cuBLAS kernels may differ, as chunking's do). Taken as independent at 8 layers: sqrt(57 + 2 x 16) x 2**-8 =
#: 0.0369 (sqrt(225 + 2 x 64) x 2**-8 = 0.0734 at 32)
ROW_PARALLEL_ROUNDINGS = 2 * 2 * MESH_SERVE_LAYERS
MESH_LOGITS_REL_RMS = math.sqrt(MESH_INT8_PER_FORWARD + ROW_PARALLEL_ROUNDINGS) * 2.0 ** -8
SP_PROMPT_LEN = 2048  # (b): the sequence-parallel prefill's prompt, numpy seed 4
#: (b)'s speculative case: phase 9a's draft (DRAFT_1B, seed DRAFT_SEED) at MESH_DRAFT_LAYERS of its 16 layers
#: beside the bf16 target, both under llama_partition_rules(): the draft's paged steps run at 16 query and 4 KV
#: heads of D = 64 on each rank; 4 of the 16 since the script passed 1000 s with the whole draft (1105.4 s on
#: an NVIDIA H100 80GB HBM3, 700.00 W)
MESH_DRAFT_LAYERS = 4
#: (b)'s graph-route cases (the AOT store over the mesh), run in the same world after the ten: each takes its eager
#: case's model (built afresh from its seed), knobs and prompts, and its streams as the reference; "miss" is an engine
#: on an empty store, "hit" a fresh Generator and engine on the populated store with the kernel build cache at an
#: empty directory
MESH_AOT_CASES = (("tp32", ("miss",)), ("sp32", ("miss",)), ("moe32", ("miss",)), ("tp", ("miss", "hit")),
                  ("int8", ("miss", "hit")))
#: (b)'s f32 speculative case drafts with the target itself, which accepts every proposal unsharded (phase 9b):
#: on the mesh the share of proposals that had budget room and were accepted must reach this, and its counters
#: the unsharded run's exactly (rounds x gamma also counts the proposals past a stream's end, so its rate is lower)
SPEC32_ACCEPTANCE = 0.9
#: kernels that no served run of the mesh path reaches, counted on every rank and required 0: the flash kernels
#: (sp prefill attends by ring, cached prefill takes the plain path) and int8 pages (int8 pools take the gather path)
OFF_MESH_PATH = frozenset({"flash_forward", "flash_backward", "flash_forward_f32", "flash_backward_f32",
                           "paged_decode_attention_int8"})
#: the int8 matmul's weight shapes on one rank at model=2 (Llama-3-8B): column-parallel q, k/v, wi/wg and the
#: vocab-parallel head split F; row-parallel o and wo split K
INT8_SHARDS = (
    ("q", 4096, 2048), ("k/v", 4096, 512), ("o", 2048, 4096), ("wg/wi", 4096, 7168), ("wo", 7168, 4096),
    ("lm_head", 4096, 64128),
)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def require(condition: bool, what: str) -> None:
    if not condition:
        raise AssertionError(what)


def time_ms(fn, runs: int = 50) -> float:
    """Median CUDA-event time of ``fn`` over ``runs`` launches, each after a
    64 MiB write that evicts the 50 MB L2 (in decode, the other layers'
    weights pass through L2 between two reads of one layer's pool)."""
    import torch

    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        flush.zero_()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


@functools.lru_cache(maxsize=None)
def spin_ms(cycles: int = SPIN_CYCLES) -> float:
    """Median length of the card's spin of ``cycles`` cycles, timed with CUDA events."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(10):
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, runs: int = 50) -> tuple:
    """``(ms, host_ms)``: as :func:`time_ms`, but the card spins before the
    start event, so the host enqueues ``fn`` while the card is busy and the
    events time the device's work alone. The spin is a whole number of
    ``SPIN_CYCLES`` spins, at least four times the median host enqueue of
    ``fn`` on five probe runs (an autograd backward takes over a
    millisecond to enqueue), and its length is measured. ``host_ms`` is the
    median host time of enqueuing the start event, ``fn`` and the end event;
    a run whose enqueue outlasted the spin is dropped (its time would
    include host work), and at least half must remain."""
    import torch

    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    probes = []
    for _ in range(5):
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        probes.append((time.perf_counter() - t0) * 1e3)
        end.synchronize()
    cycles = SPIN_CYCLES * max(1, math.ceil(4 * statistics.median(probes) / spin_ms()))
    spin = spin_ms(cycles)
    times, hosts = [], []
    for _ in range(runs):
        flush.zero_()
        torch.cuda._sleep(cycles)
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        host = (time.perf_counter() - t0) * 1e3
        end.synchronize()
        hosts.append(host)
        if host < spin:
            times.append(start.elapsed_time(end))
    require(2 * len(times) >= runs, f"the host's enqueue outlasted the {spin:.3f} ms spin in "
                                    f"{runs - len(times)} of {runs} runs (median {statistics.median(hosts):.3f} ms)")
    return statistics.median(times), statistics.median(hosts)


def paged_inputs(batch, lengths, n_pages, pages_per_seq, dtype, seed, head_dim=128, page=BLOCK):
    """Random q and pools of ``page``-position pages, and a table whose rows
    own disjoint real pages (the last pool page is the engine's scratch
    page)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(batch, 32, head_dim, device="cuda", generator=g).to(dtype)
    k = torch.randn(8, n_pages, page, head_dim, device="cuda", generator=g).to(dtype)
    v = torch.randn(8, n_pages, page, head_dim, device="cuda", generator=g).to(dtype)
    perm = torch.randperm(n_pages - 1, device="cuda", generator=g)
    table = perm[: batch * pages_per_seq].reshape(batch, pages_per_seq).to(torch.int32).contiguous()
    return q, k, v, torch.tensor(lengths, dtype=torch.int32, device="cuda"), table


def bound_ms(q, k_pages, lengths, pages_per_seq, scale_item: int = 0) -> tuple:
    """Least time for one call: every visible K/V row (and, for int8 pages,
    its ``scale_item``-byte scale), q, the output and the table entries in
    use moved once, against 4 * H * D operations per visible position (q.k
    and p.v) at the peak rate of q's type."""
    n_kv, _, page, head_dim = k_pages.shape
    visible = int(lengths.clamp(0, pages_per_seq * page).sum())
    pages_used = int(((lengths.clamp(0, pages_per_seq * page) + page - 1) // page).sum())
    item = k_pages.element_size()
    moved = (2 * visible * n_kv * (head_dim * item + scale_item) + 2 * q.numel() * q.element_size()
             + 4 * (lengths.numel() + pages_used))
    ops = 4 * visible * q.shape[1] * head_dim
    by_bytes, by_ops = moved / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[str(q.dtype)]
    return max(by_bytes, by_ops) * 1e3, ("bytes" if by_bytes >= by_ops else "operations")


def paged_shapes(pool_pages: int, pages_per_seq: int) -> tuple:
    """(label, batch, lengths, pool pages, table width) of the timed shapes:
    the served one (decode lengths at the end of the 32-token streams) and
    two long-context ones (the second leaves only 8 (row, KV head) pairs,
    so the split carries all the parallelism)."""
    return (
        ("served", 4, [n + MAX_NEW for n in PROMPT_LENS], pool_pages, pages_per_seq),
        ("B=8 ctx=2048", 8, [2048] * 8, 8 * 128 + 1, 128),
        ("B=1 ctx=8192", 1, [8192], 512 + 1, 512),
    )


def sdpa_on_gathered(q, k, v, lens, table):
    """The library yardstick: SDPA over K/V gathered beforehand (not part of
    the port), as a closure over the gathered tensors."""
    import torch
    import torch.nn.functional as F

    n_kv, _, _, head_dim = k.shape
    batch = q.shape[0]
    kg = k[:, table.long()].reshape(n_kv, batch, -1, head_dim).permute(1, 0, 2, 3).contiguous()
    vg = v[:, table.long()].reshape(n_kv, batch, -1, head_dim).permute(1, 0, 2, 3).contiguous()
    mask = (torch.arange(kg.shape[2], device="cuda")[None] < lens[:, None])[:, None, None]
    q4 = q[:, :, None]
    return lambda: F.scaled_dot_product_attention(q4, kg, vg, attn_mask=mask, enable_gqa=True)


def float_pages(batch, lengths, n_pages, pages_per_seq, dtype, seed, head_dim=128, page=BLOCK):
    """:func:`paged_inputs` and the wrapper's keyword arguments for float pages (none)."""
    return (*paged_inputs(batch, lengths, n_pages, pages_per_seq, dtype, seed, head_dim, page), {})


def int8_pages(batch, lengths, n_pages, pages_per_seq, dtype, seed, head_dim=128, page=BLOCK):
    """:func:`paged_inputs` with the pools stored as the engine stores int8
    pages (int8 values, f32 scales per position and KV head), the scales as
    the wrapper's keyword arguments."""
    import torch

    from unionml_tpu_torch.models.layers import quantize_kv_rows

    q, k, v, lens, table = paged_inputs(batch, lengths, n_pages, pages_per_seq, torch.float32, seed, head_dim, page)
    (kq, ks), (vq, vs) = quantize_kv_rows(k), quantize_kv_rows(v)
    return q.to(dtype), kq, vq, lens, table, dict(k_scales=ks, v_scales=vs)


def hold_paged(label: str, cases, make, pool_pages: int, pages_per_seq: int) -> float:
    """The paged wrapper against its twin over ``cases`` ((head_dim,
    lengths) pairs) in float32 and bfloat16 q, on the pages ``make`` gives:
    within :data:`TOLERANCE`, rows of length 0 exact zeros, two calls
    bitwise equal. Over int8 pages each case also prints the route its two
    launches took and the ring's stages. Returns the largest bf16 error."""
    import torch

    from unionml_tpu_torch.ops.paged_attention import paged_decode_attention, paged_decode_attention_reference

    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        atol, rtol = TOLERANCE[str(dtype)]
        for seed, (head_dim, lengths) in enumerate(cases):
            q, k, v, lens, table, kw = make(len(lengths), lengths, pool_pages * 2, pages_per_seq, dtype, seed,
                                            head_dim)
            routes = dict(paged_decode_attention.int8_route_launches)
            out = paged_decode_attention(q, k, v, lens, table, **kw)
            again = paged_decode_attention(q, k, v, lens, table, **kw)
            torch.cuda.synchronize()
            ref = paged_decode_attention_reference(q, k, v, lens, table, **kw)
            err = (out.float() - ref.float()).abs()
            ok = bool((err <= atol + rtol * ref.float().abs()).all()) and not bool(out.isnan().any())
            zeros = all(int(torch.count_nonzero(out[i])) == 0 for i, n in enumerate(lengths) if n == 0)
            same = torch.equal(out, again)
            how = f" ({int8_route(q, k, v, table, kw, routes, 2)})" if kw else ""
            print(f"{label} {dtype} q, B={len(lengths)} D={head_dim} lengths={lengths}{how}: max_abs_err="
                  f"{err.max().item()} (tolerance atol={atol} rtol={rtol}) {'ok' if ok else 'FAIL'}; rows of "
                  f"length 0 exact zeros: {zeros}; two calls bitwise equal: {same}", flush=True)
            require(ok and zeros, f"{label} disagrees with its plain twin")
            require(same, f"{label} gave other bits on a second call")
            if dtype == torch.bfloat16:
                worst = max(worst, err.max().item())
    return worst


def int8_route(q, k_pages, v_pages, table, scales: dict, before: dict, calls: int) -> str:
    """The int8-page kernel's route and plan for these inputs, as the
    wrapper chooses them, after a check that the last ``calls`` launches
    (the wrapper's counts by route, against ``before``) all took that
    route."""
    from unionml_tpu_torch.ops import paged_attention as pa

    route, plan = pa._int8_launch(q, k_pages, v_pages, scales["k_scales"], scales["v_scales"], table,
                                  pa._sm_count(q.device.index))
    after = pa.paged_decode_attention.int8_route_launches
    taken = {r: after[r] - before[r] for r in after}
    require(taken == {r: calls * (r == route) for r in after},
            f"int8-page launches by route {taken}, expected {calls} by the {route} route")
    return f"route {route}, {plan.stages} stages, {plan.splits} splits of {plan.pages_per_split} pages"


def paged_times(q, k, v, lens, table, pages_per_seq, **scales) -> dict:
    """The paged kernel of either mode, its twin, SDPA on K/V gathered (and
    dequantized) beforehand (the library yardstick) and the bound, on the
    same inputs; two calls bitwise equal."""
    import torch

    from unionml_tpu_torch.ops.paged_attention import paged_decode_attention, paged_decode_attention_reference

    def call():
        return paged_decode_attention(q, k, v, lens, table, **scales)

    routes = dict(paged_decode_attention.int8_route_launches)
    require(torch.equal(call(), call()), "the paged kernel gave other bits on a second call")
    how = {"int8_route": int8_route(q, k, v, table, scales, routes, 2)} if scales else {}
    ms = time_ms(call)
    dev_ms, host_ms = device_ms(call)
    plain_ms = time_ms(lambda: paged_decode_attention_reference(q, k, v, lens, table, **scales))
    bms, bound_by = bound_ms(q, k, lens, pages_per_seq, scale_item=4 if scales else 0)
    if scales:
        k, v = (k.float() * scales["k_scales"]).to(q.dtype), (v.float() * scales["v_scales"]).to(q.dtype)
    library = sdpa_on_gathered(q, k, v, lens, table)
    library_ms = time_ms(library)
    library_dev_ms, _ = device_ms(library)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=bound_by, library_ms=library_ms, device_ms=dev_ms,
                library_device_ms=library_dev_ms, host_ms=host_ms, **how)


#: the key prefix of each timed paged shape in the kernels line (the served shape's keys have none)
PAGED_PREFIX = {"served": "", "B=8 ctx=2048": "b8_ctx2048_", "B=1 ctx=8192": "b1_ctx8192_"}


def time_paged(label: str, make, pool_pages: int, pages_per_seq: int, beside: dict = None) -> dict:
    """:func:`paged_times` at the three :func:`paged_shapes` (bf16 q): the
    served shape's numbers, then the long-context ones under a prefix.
    ``beside``, another kernel's row of the same shapes (the bf16-page
    kernel's, beside the int8-page kernel), is printed with them."""
    import torch

    row = {}
    for shape, batch, lengths, n_pages, pps in paged_shapes(pool_pages, pages_per_seq):
        q, k, v, lens, table, kw = make(batch, lengths, n_pages, pps, torch.bfloat16, 7)
        n = paged_times(q, k, v, lens, table, pps, **kw)
        row.update({PAGED_PREFIX[shape] + key: value for key, value in n.items()})
        other = f", bf16-page kernel {beside[PAGED_PREFIX[shape] + 'device_ms']:.4f} ms" if beside else ""
        print(f"{label} bf16 q, {shape} lengths={lengths[:4]}{'...' if batch > 4 else ''}"
              f"{' (' + n['int8_route'] + ')' if 'int8_route' in n else ''}: kernel {n['ms']:.4f} ms, "
              f"plain {n['plain_ms']:.4f} ms, library (SDPA on gathered K/V) {n['library_ms']:.4f} ms, bound "
              f"{n['bound_ms']:.6f} ms ({n['bound_by']}), {n['bound_ms'] / n['ms']:.1%} of bound; device only: "
              f"kernel {n['device_ms']:.4f} ms ({n['bound_ms'] / n['device_ms']:.1%} of bound), library "
              f"{n['library_device_ms']:.4f} ms{other}; host enqueue a call {n['host_ms']:.4f} ms", flush=True)
        del q, k, v, lens, table, kw
        torch.cuda.empty_cache()
    return row


def kernel_phase(pool_pages: int, pages_per_seq: int) -> dict:
    """The paged kernel against its twin: the served geometry at D=128 (the
    target's head) and D=64 (the speculative draft's), the length limits
    (0, 1, page edges, ragged, the full table, past it) at every head size
    the package uses; then times at the three :func:`paged_shapes` (bf16)."""
    import torch

    table_end = pages_per_seq * BLOCK
    limits = (0, 1, BLOCK, 2 * BLOCK + 5, table_end, table_end + 40, 3, 2 * BLOCK)
    cases = [(128, (1, 17, 64, 300)), (128, (table_end, 48, 16, 255)), (64, (1, 17, 64, 300))]
    cases += [(d, limits) for d in (16, 32, 64, 128)]
    worst = hold_paged("paged_decode_attention", cases, float_pages, pool_pages, pages_per_seq)
    # the device-only timer's floor: a one-element kernel under the same spin, flush and events
    one = torch.empty(1, device="cuda")
    floor_ms, _ = device_ms(lambda: one.zero_())
    print(f"device-only timer floor (a one-element x.zero_()): {floor_ms:.4f} ms", flush=True)
    row = time_paged("paged_decode_attention", float_pages, pool_pages, pages_per_seq)
    return dict(max_abs_err=worst, **row, timer_floor_ms=floor_ms)


def off16(t):
    """A contiguous copy of ``t`` that starts 8 bytes past a 16-byte boundary."""
    import torch

    size = t.numel() * t.element_size()
    flat = torch.empty(size + 24, dtype=torch.uint8, device=t.device)
    start = (8 - flat.data_ptr() % 16) % 16
    view = flat[start: start + size].view(t.dtype).view(t.shape)
    view.copy_(t)
    return view


def int8_pages_off16(*args):
    """:func:`int8_pages` with both int8 pools 8 bytes past a 16-byte
    boundary (the kernel takes 8; a bulk copy needs 16)."""
    q, k, v, lens, table, kw = int8_pages(*args)
    return q, off16(k), off16(v), lens, table, kw


def int8_page_phase(pool_pages: int, pages_per_seq: int, bf16_pages: dict) -> dict:
    """The int8-page mode against its twin at D = 16, 24, 40, 64, 128 and
    256 over the float mode's length cases, and at D = 128 on pools off a
    16-byte boundary, printing the route and the ring of each and requiring
    every route's launches (bf16 q at D % 16 == 0 on aligned pools: ``mma``;
    f32 q, D = 24 and 40, and the pools off a boundary: ``direct``); then
    times at the three :func:`paged_shapes` (the tensor-core route) beside
    ``bf16_pages``, the bf16-page kernel's row."""
    from unionml_tpu_torch.ops.paged_attention import paged_decode_attention

    table_end = pages_per_seq * BLOCK
    limits = (0, 1, BLOCK, 2 * BLOCK + 5, table_end, table_end + 40, 3, 2 * BLOCK)
    cases = [(d, lengths) for d in (16, 24, 40, 64, 128, 256) for lengths in ((1, 17, 64, 300), limits)]
    off16_cases = [(128, limits)]
    paged_decode_attention.int8_launches = 0
    before = dict(paged_decode_attention.int8_route_launches)
    worst = hold_paged("paged_decode_attention int8 pages", cases, int8_pages, pool_pages, pages_per_seq)
    worst = max(worst, hold_paged("paged_decode_attention int8 pages off a 16-byte boundary", off16_cases,
                                  int8_pages_off16, pool_pages, pages_per_seq))
    checked = paged_decode_attention.int8_launches
    after = paged_decode_attention.int8_route_launches
    by_route = {r: after[r] - before[r] for r in after}
    mma = 2 * sum(d % 16 == 0 for d, _ in cases)  # two calls a case, bf16 q only
    expected = {"direct": 4 * (len(cases) + len(off16_cases)) - mma, "mma": mma}
    print(f"paged_decode_attention int8 pages: {checked} launches by route {by_route}", flush=True)
    require(by_route == expected, f"int8-page launches by route {by_route}, expected {expected}")
    row = time_paged("paged_decode_attention int8 pages", int8_pages, pool_pages, pages_per_seq, beside=bf16_pages)
    require(all(row[prefix + "int8_route"].startswith("route mma") for prefix in PAGED_PREFIX.values()),
            "the int8-page kernel's timed shapes (bf16 q, D=128, 16-position pages) must take the tensor-core route")
    return dict(max_abs_err=worst, phase2_launches=checked, phase2_route_launches=by_route, **row)


def serve(batcher, prompts, grammars=None, logprobs=None) -> tuple:
    """Submit every prompt from its own thread, with its grammar id when
    ``grammars`` is given, and with ``logprobs=True`` when a ``logprobs``
    list is given (each stream's logprobs land there); return (streams,
    seconds)."""
    results = [None] * len(prompts)

    def worker(i):
        kw = {} if grammars is None else {"constraint": grammars[i]}
        stream = batcher.submit(prompts[i], logprobs=logprobs is not None, **kw)
        results[i] = [int(t) for chunk in stream for t in chunk]
        if logprobs is not None:
            logprobs[i] = stream.logprobs

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(prompts))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
        if t.is_alive():
            raise TimeoutError("a stream did not finish within 600 s")
    return results, time.perf_counter() - t0


def serve_one_by_one(batcher, prompts) -> tuple:
    """Submit the prompts one at a time, each stream drained before the
    next (each stream's rounds then depend on its prompt alone); return
    (streams, seconds)."""
    t0 = time.perf_counter()
    streams = [[int(t) for chunk in batcher.submit(p) for t in chunk] for p in prompts]
    return streams, time.perf_counter() - t0


def profiled(fn) -> tuple:
    """Run ``fn`` once under ``torch.profiler``: (wall seconds, {device op
    name: (summed device ms, calls)}). Every device busy time of this script
    is the sum of these."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    by_name: dict = {}
    for event in prof.events():
        if str(event.device_type).endswith("CUDA") and event.device_time > 0:
            total, count = by_name.get(event.name, (0.0, 0))
            by_name[event.name] = (total + event.device_time / 1e3, count + 1)  # us -> ms
    return seconds, by_name


def profile_run(label: str, fn) -> None:
    """Run ``fn`` once more under ``torch.profiler`` and print where the
    device time goes: kernel time by name (the 12 largest, and every kernel
    of the port's), and the device's busy share of the wall time (the rest is
    the host launching eager PyTorch ops)."""
    seconds, by_name = profiled(fn)
    busy_ms = sum(total for total, _ in by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])

    def rows(items):
        return [{"name": name[:120], "ms": total, "calls": count, "share_of_busy": total / busy_ms}
                for name, (total, count) in items]

    print(json.dumps({"profile": {
        "run": label, "wall_ms": seconds * 1e3, "device_busy_ms": busy_ms,
        "device_idle_share": 1 - busy_ms / (seconds * 1e3),
        "top_kernels": rows(ranked[:12]),
        # the port's own kernels (each in an anonymous namespace of csrc/), wherever they rank
        "port_kernels": rows(kv for kv in ranked if kv[0].removeprefix("void ").startswith("(anonymous namespace)::")),
    }}), flush=True)


def visible_pairs(q_len: int, k_len: int, causal: bool) -> int:
    """(query, key) pairs the causal mask (diagonal shifted by Lk - Lq) leaves visible."""
    if not causal:
        return q_len * k_len
    offset = k_len - q_len
    return sum(min(k_len, max(0, i + offset + 1)) for i in range(q_len))


def flash_bound_ms(name: str, q, k, causal: bool) -> tuple:
    """Least time of one call: its inputs read and outputs written once
    (q/k/v, plus dO, lse and delta for the backward; out and lse, or dq, dk
    and dv), against its products over the visible pairs at the input type's
    peak rate (f32: ``F32_FLASH_OPS_PER_S``)."""
    batch, q_len, n_heads, head_dim = q.shape
    k_len = k.shape[1]
    item = q.element_size()
    qkv = (q.numel() + 2 * k.numel()) * item
    stats = 4 * batch * n_heads * q_len
    moved = {
        "flash_forward": qkv + q.numel() * item + stats,
        "flash_forward_f32": qkv + q.numel() * item + stats,
        "flash_backward": qkv + 2 * q.numel() * item + 2 * stats + 2 * k.numel() * item,
        "flash_backward_f32": qkv + 2 * q.numel() * item + 2 * stats + 2 * k.numel() * item,
    }[name]
    ops = FLASH_PRODUCTS[name] * 2 * visible_pairs(q_len, k_len, causal) * head_dim * batch * n_heads
    rate = F32_FLASH_OPS_PER_S if str(q.dtype) == "torch.float32" else PEAK_OPS_PER_S[str(q.dtype)]
    by_bytes, by_ops = moved / HBM_BYTES_PER_S, ops / rate
    return max(by_bytes, by_ops) * 1e3, ("bytes" if by_bytes >= by_ops else "operations")


def sdpa_times(q, k, v, dout, causal: bool, backend) -> dict:
    """The library yardstick (not part of the port): SDPA on [B, H, L, D],
    K/V expanded to the query heads beforehand. Its backward is timed as
    (forward + backward) - forward, with the host's launch work and device-only."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import sdpa_kernel

    group = q.shape[2] // k.shape[2]
    qh = q.transpose(1, 2).contiguous().requires_grad_()
    kh = k.repeat_interleave(group, dim=2).transpose(1, 2).contiguous().requires_grad_()
    vh = v.repeat_interleave(group, dim=2).transpose(1, 2).contiguous().requires_grad_()
    doh = dout.transpose(1, 2).contiguous()

    def forward():
        with torch.no_grad():
            F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal)

    def both():
        torch.autograd.grad(F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal), (qh, kh, vh), doh)

    with sdpa_kernel(backend):
        fwd_ms, both_ms = time_ms(forward), time_ms(both)
        fwd_dev, _ = device_ms(forward)
        both_dev, _ = device_ms(both)
    return dict(fwd_ms=fwd_ms, fwd_device_ms=fwd_dev, bwd_ms=both_ms - fwd_ms, bwd_device_ms=both_dev - fwd_dev)


def flash_kernel_phase() -> dict:
    """Each flash kernel against its twin on the same inputs: float32 through
    the f32 forward and the fused f32 backward, bfloat16 through the
    tensor-core forward and the fused backward (each two calls bitwise
    equal). Then times: the bf16 forward and the fused backward at the
    full-width training shape (causal), the f32 forward and backward at the
    f32 parity shape (S=256) and at the training shape (S=2048, numbers under
    an ``s2048_`` prefix)."""
    import torch
    from torch.nn.attention import SDPBackend

    from unionml_tpu_torch.ops.flash_attention import (
        flash_backward, flash_backward_f32, flash_backward_reference, flash_forward, flash_forward_f32,
        flash_forward_reference,
    )

    def inputs(q_len, k_len, dtype, seed, head_dim=128, misaligned=False, heads=FLASH_HEADS):
        batch, n_heads, n_kv_heads = heads
        g = torch.Generator(device="cuda").manual_seed(seed)
        def make(length, heads):
            x = torch.randn(batch, length, heads, head_dim, device="cuda", generator=g).to(dtype)
            if not misaligned:
                return x
            flat = torch.empty(x.numel() + 1, dtype=dtype, device="cuda")[1:]  # 4 bytes past the allocation
            return flat.copy_(x.flatten()).view(x.shape)

        return make(q_len, n_heads), make(k_len, n_kv_heads), make(k_len, n_kv_heads), make(q_len, n_heads)

    worst = {name: 0.0 for name in FLASH_PRODUCTS}
    cases = [(label, q_len, k_len, causal, 128, False, FLASH_HEADS) for label, q_len, k_len, causal, _ in FLASH_CASES]
    for dtype in (torch.float32, torch.bfloat16):
        atol, rtol = FLASH_TOLERANCE[str(dtype)]
        bf16 = dtype == torch.bfloat16
        extra = list(FUSED_EXTRA_CASES if bf16 else F32_EXTRA_CASES)
        forward, backward = ("flash_forward", "flash_backward") if bf16 else ("flash_forward_f32", "flash_backward_f32")
        for seed, (label, q_len, k_len, causal, head_dim, misaligned, heads) in enumerate(cases + extra):
            q, k, v, dout = inputs(q_len, k_len, dtype, seed, head_dim, misaligned, heads)
            require(not misaligned or q.data_ptr() % 16, f"{label}: the tensors are 16-byte aligned")
            out, lse = flash_forward(q, k, v, causal)
            out_again, lse_again = flash_forward(q, k, v, causal)
            ref_out, ref_lse = flash_forward_reference(q, k, v, causal)
            # the backward takes the twin's lse and delta, so that it is held alone
            delta = torch.einsum("blhd,blhd->bhl", dout.float(), ref_out.float())
            dq, dk, dv = flash_backward(q, k, v, dout, ref_lse, delta, causal)
            again = flash_backward(q, k, v, dout, ref_lse, delta, causal)
            torch.cuda.synchronize()
            ref_dq, ref_dk, ref_dv = flash_backward_reference(q, k, v, dout, ref_lse, delta, causal)
            errors = []
            for what, name, got, ref in (
                ("out", forward, out, ref_out), ("lse", forward, lse, ref_lse),
                ("dq", backward, dq, ref_dq), ("dk", backward, dk, ref_dk), ("dv", backward, dv, ref_dv),
            ):
                err = (got.float() - ref.float()).abs()
                ok = bool((err <= atol + rtol * ref.float().abs()).all()) and got.dtype == ref.dtype
                worst[name] = max(worst[name], err.max().item())
                errors.append(f"{what} {err.max().item():.3g}{'' if ok else ' FAIL'}")
                require(ok, f"{name} disagrees with its plain twin ({what}, {dtype}, {label})")
            same = torch.equal(out, out_again) and torch.equal(lse, lse_again)
            errors.append(f"forward bitwise equal on a second call: {same}")
            require(same, f"{forward} gave other bits on a second call ({label})")
            same = all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again))
            errors.append(f"backward bitwise equal on a second call: {same}")
            require(same, f"{backward} gave other bits on a second call ({label})")
            print(f"flash kernels {dtype} {label} B, H, Hkv={heads} D={head_dim}: max_abs_err {', '.join(errors)} "
                  f"(tolerance atol={atol} rtol={rtol}) ok", flush=True)

    def timed(name, kernel, plain, q, k, causal, library_ms, library_device_ms, library_label):
        ms, plain_ms = time_ms(kernel), time_ms(plain)
        dev_ms, _ = device_ms(kernel)
        bms, bound_by = flash_bound_ms(name, q, k, causal)
        print(f"{name} {str(q.dtype)[6:]} B=1 Lq={q.shape[1]} H=32 Hkv=8 D=128 causal: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, library {library_ms:.4f} ms ({library_label}), bound {bms:.4f} ms "
              f"({bound_by}, {FLASH_PRODUCTS[name]} products), {bms / ms:.1%} of bound; device only: kernel "
              f"{dev_ms:.4f} ms ({bms / dev_ms:.1%} of bound), library {library_device_ms:.4f} ms", flush=True)
        return dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=bound_by, library_ms=library_ms,
                    device_ms=dev_ms, library_device_ms=library_device_ms)

    numbers = {}
    q, k, v, dout = inputs(TRAIN_SEQ, TRAIN_SEQ, torch.bfloat16, 99)
    out, lse = flash_forward(q, k, v, True)
    delta = torch.einsum("blhd,blhd->bhl", dout.float(), out.float())
    sdpa = sdpa_times(q, k, v, dout, True, SDPBackend.FLASH_ATTENTION)
    numbers["flash_forward"] = timed(
        "flash_forward", lambda: flash_forward(q, k, v, True), lambda: flash_forward_reference(q, k, v, True), q, k,
        True, sdpa["fwd_ms"], sdpa["fwd_device_ms"], "SDPA flash forward")
    numbers["flash_backward"] = timed(
        "flash_backward", lambda: flash_backward(q, k, v, dout, lse, delta, True),
        lambda: flash_backward_reference(q, k, v, dout, lse, delta, True), q, k, True, sdpa["bwd_ms"],
        sdpa["bwd_device_ms"], "SDPA flash backward: dq, dk and dv together")
    del q, k, v, dout, out, lse, delta
    torch.cuda.empty_cache()

    # the f32 route at the f32 training-parity shape, where the main paths launch it, and at the training shape
    for seq, prefix in ((PARITY_SEQ, ""), (TRAIN_SEQ, f"s{TRAIN_SEQ}_")):
        q, k, v, dout = inputs(seq, seq, torch.float32, 98)
        out, lse = flash_forward(q, k, v, True)
        delta = torch.einsum("blhd,blhd->bhl", dout.float(), out.float())
        sdpa = sdpa_times(q, k, v, dout, True, SDPBackend.EFFICIENT_ATTENTION)
        forward = timed("flash_forward_f32", lambda: flash_forward_f32(q, k, v, True),
                        lambda: flash_forward_reference(q, k, v, True), q, k, True, sdpa["fwd_ms"],
                        sdpa["fwd_device_ms"], "SDPA memory-efficient forward in f32")
        backward = timed("flash_backward_f32", lambda: flash_backward_f32(q, k, v, dout, lse, delta, True),
                         lambda: flash_backward_reference(q, k, v, dout, lse, delta, True), q, k, True,
                         sdpa["bwd_ms"], sdpa["bwd_device_ms"],
                         "SDPA memory-efficient backward in f32: dq, dk and dv together")
        for name, measured in (("flash_forward_f32", forward), ("flash_backward_f32", backward)):
            numbers.setdefault(name, {}).update({prefix + key: value for key, value in measured.items()})
        del q, k, v, dout, out, lse, delta
        torch.cuda.empty_cache()
    for name, measured in numbers.items():
        measured["max_abs_err"] = worst[name]
    return numbers


def int8_bound_ms(m: int, k_dim: int, f_dim: int, x_item: int, out_item: int) -> tuple:
    """Least time of one int8 matmul: x, the int8 weight, its scales and the
    output moved once, against 2 * M * K * F operations at the bf16
    tensor-core rate."""
    moved = m * k_dim * x_item + k_dim * f_dim + 4 * f_dim + m * f_dim * out_item
    by_bytes, by_ops = moved / HBM_BYTES_PER_S, 2 * m * k_dim * f_dim / PEAK_OPS_PER_S["torch.bfloat16"]
    return max(by_bytes, by_ops) * 1e3, ("bytes" if by_bytes >= by_ops else "operations")


def int8_kernel_phase() -> dict:
    """The int8 matmul against its twin at every Llama-3-8B weight shape, then
    times at decode and admission M (bf16 in and out, the served types)."""
    import torch

    from unionml_tpu_torch.ops.int8_matmul import int8_matmul, int8_matmul_reference
    from unionml_tpu_torch.ops.quant import dequantize, quantize_array

    g = torch.Generator(device="cuda").manual_seed(11)
    worst, timed = 0.0, {}
    for label, k_dim, f_dim, _ in INT8_WEIGHTS:
        qt = quantize_array(torch.randn(k_dim, f_dim, device="cuda", generator=g) * k_dim ** -0.5)
        errors = []
        for m in INT8_M:
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.randn(m, k_dim, device="cuda", generator=g).to(dtype)
                out = int8_matmul(x, qt.q, qt.scale)
                torch.cuda.synchronize()
                ref = int8_matmul_reference(x, qt.q, qt.scale)
                err = (out.float() - ref.float()).abs()
                if dtype == torch.float32:
                    ok = err.max().item() <= INT8_F32_REL * ref.abs().max().item()
                else:
                    atol, rtol = TOLERANCE[str(dtype)]
                    ok = bool((err <= atol + rtol * ref.float().abs()).all())
                worst = max(worst, err.max().item())
                errors.append(f"M={m} {str(dtype)[6:]} {err.max().item():.3g}{'' if ok else ' FAIL'}")
                require(ok and out.dtype == dtype, f"int8_matmul disagrees with its plain twin ([{k_dim}, {f_dim}], "
                                                   f"M={m}, {dtype})")
        print(f"int8_matmul [{k_dim}, {f_dim}] ({label}): max_abs_err {', '.join(errors)} (tolerance f32 "
              f"{INT8_F32_REL} x max|twin|, bf16 atol={TOLERANCE['torch.bfloat16'][0]} "
              f"rtol={TOLERANCE['torch.bfloat16'][1]}) ok", flush=True)
        x = torch.randn(4, k_dim, device="cuda", generator=g).to(torch.bfloat16)
        once, again = (int8_matmul(x, qt.q, qt.scale, out_dtype=torch.float32) for _ in range(2))
        require(torch.equal(once, again), f"int8_matmul [{k_dim}, {f_dim}] gave other bits on a second call")
        print(f"int8_matmul [{k_dim}, {f_dim}] ({label}): M=4, f32 out, two calls bitwise equal", flush=True)
        w_bf16 = dequantize(qt, torch.bfloat16)  # the library yardstick's weight, made once
        for m in INT8_TIMED_M:
            x = torch.randn(m, k_dim, device="cuda", generator=g).to(torch.bfloat16)
            ms = time_ms(lambda: int8_matmul(x, qt.q, qt.scale))
            plain_ms = time_ms(lambda: int8_matmul_reference(x, qt.q, qt.scale))
            library_ms = time_ms(lambda: x @ w_bf16)
            dev_ms, host_ms = device_ms(lambda: int8_matmul(x, qt.q, qt.scale))
            library_dev_ms, _ = device_ms(lambda: x @ w_bf16)
            bms, bound_by = int8_bound_ms(m, k_dim, f_dim, 2, 2)
            timed[(label, m)] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=bound_by, library_ms=library_ms,
                                     device_ms=dev_ms, library_device_ms=library_dev_ms, host_ms=host_ms)
            print(f"int8_matmul bf16 M={m} [{k_dim}, {f_dim}] ({label}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"library (cuBLAS bf16 x @ w on the weight dequantized beforehand) {library_ms:.4f} ms, "
                  f"bound {bms:.4f} ms ({bound_by}), {bms / ms:.1%} of bound; device only: kernel {dev_ms:.4f} ms "
                  f"({bms / dev_ms:.1%} of bound), host enqueue a call {host_ms:.4f} ms, "
                  f"library {library_dev_ms:.4f} ms", flush=True)
        del qt, w_bf16
        torch.cuda.empty_cache()
    for m in INT8_TIMED_M:
        step = {key: sum(n * timed[(label, m)][key] for label, _, _, n in INT8_WEIGHTS)
                for key in ("ms", "plain_ms", "library_ms", "bound_ms", "device_ms", "library_device_ms", "host_ms")}
        print(f"int8_matmul bf16 M={m}, the {INT8_PER_FORWARD} matmuls of one forward: kernel {step['ms']:.4f} ms, "
              f"plain {step['plain_ms']:.4f} ms, library (bf16 weights) {step['library_ms']:.4f} ms, "
              f"bound {step['bound_ms']:.4f} ms, {step['bound_ms'] / step['ms']:.1%} of bound; device only: kernel "
              f"{step['device_ms']:.4f} ms, library {step['library_device_ms']:.4f} ms; host enqueue "
              f"{step['host_ms']:.4f} ms", flush=True)
    row = dict(timed[("wg/wi", 4)])
    # the admission-prefill times of the same weight ride along under an "m256_" prefix
    prefill = timed[("wg/wi", 256)]
    row.update({f"m256_{key}": prefill[key] for key in ("ms", "device_ms", "plain_ms", "bound_ms", "library_ms",
                                                         "library_device_ms")})
    return dict(max_abs_err=worst, **row)


def int8_serving_phase(cfg, gcfg, prompts, slots, decode_chunk, bf16: dict, card: str, profile: bool) -> int:
    """Serve the full-width model's weights in int8 through the engine:
    returns the int8 matmul launches of the run."""
    import torch

    from unionml_tpu_torch import ContinuousBatcher, Generator, Llama
    from unionml_tpu_torch.ops.int8_matmul import int8_matmul
    from unionml_tpu_torch.ops.paged_attention import paged_decode_attention
    from unionml_tpu_torch.ops.quant import QuantizedKernel

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Llama(cfg, seed=0)
    gen = Generator(model, gcfg, quantize="int8")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = sum(t.numel() * t.element_size() for t in [*model.parameters(), *model.buffers()])
    slots_int8 = sum(isinstance(m, QuantizedKernel) for m in model.modules())
    print(f"int8 model: built and quantized in place in {time.perf_counter() - t0:.1f} s; {slots_int8} int8 kernels; "
          f"holds {held / 2**30:.2f} GiB (limit {INT8_MODEL_LIMIT / 2**30:.0f} GiB); "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated", flush=True)
    require(slots_int8 == INT8_PER_FORWARD and held < INT8_MODEL_LIMIT,
            f"{slots_int8} int8 kernels, model holds {held} bytes")
    warm = ContinuousBatcher(gen, slots=slots, decode_chunk=decode_chunk, block_size=BLOCK)
    serve(warm, [prompts[0][:3]])  # set-up: first launches and allocator calls
    warm.close()
    batcher = ContinuousBatcher(gen, slots=slots, decode_chunk=decode_chunk, block_size=BLOCK)
    int8_matmul.launches = paged_decode_attention.launches = 0
    streams, seconds = serve(batcher, prompts)
    launches, paged = int8_matmul.launches, paged_decode_attention.launches
    stats = batcher.stats()
    batcher.close()
    peak = torch.cuda.max_memory_allocated()
    require(all(len(s) == MAX_NEW for s in streams), f"stream lengths {[len(s) for s in streams]}")
    require(all(0 <= t < cfg.vocab_size for s in streams for t in s), "a token id outside the vocabulary")
    # one forward per admission (no preemption: each prompt is prefilled once) and per decode step
    require(stats["kv_blocks"]["preemptions"] == 0, "a stream was preempted")
    forwards = len(prompts) + stats["decode_dispatches"] * decode_chunk
    expected = INT8_PER_FORWARD * forwards
    tok_s = len(prompts) * MAX_NEW / seconds
    print(f"served int8 4 streams x {MAX_NEW} tokens: {tok_s:.1f} tok/s aggregate (bf16 in this call: "
          f"{bf16['tok_s']:.1f}), TTFT p50 {stats['ttft_ms']['p50_ms']} ms max {stats['ttft_ms']['max_ms']} ms "
          f"(bf16: p50 {bf16['ttft_p50']} ms), decode dispatch {stats['tbt_ms']['p50_ms']} ms (p50 gap between "
          f"emissions, {decode_chunk} steps; bf16: {bf16['tbt_p50']} ms); int8 launches {launches} (expected "
          f"{INT8_PER_FORWARD} x {forwards} forwards = {expected}), paged launches {paged}; peak memory "
          f"{peak / 2**30:.2f} GiB (max_memory_allocated, quantization included); card {card}", flush=True)
    require(launches == expected > 0, f"{launches} int8 launches on the main path, expected {expected}")
    require(paged > 0, "the int8 path did not reach the paged decode kernel")
    if profile:
        profiled = ContinuousBatcher(gen, slots=slots, decode_chunk=decode_chunk, block_size=BLOCK)
        profile_run("serve 4 streams, int8 weights", lambda: serve(profiled, prompts))
        profiled.close()
    return launches


def int8_parity_phase(gcfg, prompts, slots, decode_chunk) -> None:
    """float32, 2 layers at full width, int8 weights: the engine, a solo
    ``Generator`` and a solo ``Generator`` with chunked prefill
    (``prefill_chunk``, M = batch x chunk rows an int8 matmul) on the card
    (int8 kernel) give the tokens of the same weights on the CPU (the
    kernels' twins)."""
    import torch

    from unionml_tpu_torch import ContinuousBatcher, Generator, Llama, LlamaConfig
    from unionml_tpu_torch.models import llama_from_jax, llama_params_to_numpy
    from unionml_tpu_torch.ops.int8_matmul import int8_matmul

    cfg32 = LlamaConfig.llama3_8b(n_layers=2, attention_impl="flash", dtype=torch.float32, param_dtype=torch.float32)
    pcfg = dataclasses.replace(gcfg, max_new_tokens=INT8_PARITY_NEW)
    pair = prompts[:2]
    t0 = time.perf_counter()
    card_gen = Generator(Llama(cfg32, seed=3), pcfg, quantize="int8")
    before = int8_matmul.launches
    engine = ContinuousBatcher(card_gen, slots=slots, decode_chunk=decode_chunk, block_size=BLOCK)
    engine_streams, _ = serve(engine, pair)
    engine.close()
    solo_streams = [card_gen([p])[0].tolist() for p in pair]
    launched = int8_matmul.launches - before
    chunked_gen = Generator(card_gen.model, dataclasses.replace(pcfg, prefill_chunk=INT8_PARITY_CHUNK), quantize="int8")
    before = int8_matmul.launches
    chunked_streams = chunked_gen(pair).tolist()
    chunk_launches = int8_matmul.launches - before
    cpu_model = llama_from_jax(llama_params_to_numpy(card_gen.model), cfg32, device="cpu")  # the same int8 bits
    cpu_streams = Generator(cpu_model, pcfg, device="cpu")(pair).tolist()
    parity = engine_streams == solo_streams == chunked_streams == cpu_streams
    print(f"float32 int8 token parity, 2 layers, {len(pair)} prompts x {INT8_PARITY_NEW} tokens: engine (int8 and "
          f"paged kernels, {launched} int8 launches with the solo runs), solo Generator and solo Generator with "
          f"prefill_chunk={INT8_PARITY_CHUNK} ({chunk_launches} int8 launches) on the card vs the CPU twins: "
          f"{'identical' if parity else 'DIFFERENT'} ({time.perf_counter() - t0:.1f} s)", flush=True)
    require(launched > 0 and chunk_launches > 0 and parity,
            f"{engine_streams} / {solo_streams} / {chunked_streams} / {cpu_streams}")


def synthetic_vocab(size: int, seed: int) -> list:
    """Token id -> text, made with numpy from ``seed`` (see ``STRUCTURED_SEED``)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    texts = [""] + [chr(c) for c in range(32, 127)]
    lengths = rng.randint(1, 9, size=size - len(texts))
    letters = np.array(list(STRUCTURED_ALPHABET))[rng.randint(0, len(STRUCTURED_ALPHABET), size=int(lengths.sum()))]
    ends = np.cumsum(lengths)
    texts += ["".join(letters[end - n:end]) for n, end in zip(lengths, ends)]
    return texts


def structured_grammars(vocab) -> tuple:
    """The template's two grammars, an enum and a two-field JSON object over
    ``vocab``: ``(ConstraintSet, {name: compile seconds})``."""
    from unionml_tpu_torch.models import ConstraintSet, compile_regex, json_object, literal_choice

    compilers = {
        "word [a-z]+": lambda: compile_regex(r"[a-z]+", vocab, STRUCTURED_EOS),
        "sentence [a-z][a-z ]*[.!]": lambda: compile_regex(r"[a-z][a-z ]*[.!]", vocab, STRUCTURED_EOS),
        "literal_choice yes/no/maybe": lambda: literal_choice(["yes", "no", "maybe"], vocab, STRUCTURED_EOS),
        "json_object name/age": lambda: json_object({"name": "string", "age": "integer"}, vocab, STRUCTURED_EOS),
    }
    grammars, seconds = [], {}
    for name, build in compilers.items():
        t0 = time.perf_counter()
        grammars.append(build())
        seconds[name] = time.perf_counter() - t0
    return ConstraintSet(grammars), seconds


def dfa_walk(cs, grammar: int, tokens) -> tuple:
    """Walk ``tokens`` through the set's DFA on the host: ``(every token up to
    the first EOS allowed in its state, ended with EOS)``. A grammar allows
    EOS only in an accepting state, so an allowed EOS ends a sentence of it."""
    state = int(cs.starts[grammar])
    for i, t in enumerate(tokens):
        if not cs.allowed[state, t]:
            return False, False
        if t == STRUCTURED_EOS:
            return i == len(tokens) - 1, True  # the stream ends at its EOS
        state = int(cs.trans[state, t])
    return True, False


def structured_phase(cfg, gcfg, prompts, slots, decode_chunk, card: str, profile: bool) -> None:
    """Grammar-constrained serving at full width (phase 3c): grammar 0 equals
    an unconstrained engine, grammars 1-4 emit only allowed tokens with
    finite logprobs, then the f32 parity of :func:`structured_parity`."""
    import math

    import torch

    from unionml_tpu_torch import ContinuousBatcher, Generator, Llama
    from unionml_tpu_torch.ops.paged_attention import paged_decode_attention

    t0 = time.perf_counter()
    vocab = synthetic_vocab(cfg.vocab_size, STRUCTURED_SEED)
    made_s = time.perf_counter() - t0
    cs, compile_s = structured_grammars(vocab)
    print(f"structured: vocabulary of {len(vocab)} tokens made in {made_s:.2f} s; grammars compiled in "
          f"{sum(compile_s.values()):.2f} s on the host ({', '.join(f'{k} {v:.2f} s' for k, v in compile_s.items())}); "
          f"union table [{cs.trans.shape[0]}, {cs.trans.shape[1]}] int32 + bool; card {card}", flush=True)
    require(cs.vocab_size == cfg.vocab_size and cs.n_grammars == 5, "the grammar set does not fit the model")
    model = Llama(cfg, seed=0)
    ucfg = dataclasses.replace(gcfg, eos_id=STRUCTURED_EOS)
    plain = ContinuousBatcher(Generator(model, ucfg), slots=slots, decode_chunk=decode_chunk, block_size=BLOCK)
    plain.warmup()
    reference, plain_s = serve(plain, prompts)
    plain.close()

    gen = Generator(model, dataclasses.replace(ucfg, constraints=cs))
    engine = ContinuousBatcher(gen, slots=slots, decode_chunk=decode_chunk, block_size=BLOCK)
    t0 = time.perf_counter()
    engine.warmup()
    warm_s = time.perf_counter() - t0
    stats = engine.stats()
    require(stats["decode_dispatches"] == 0 and stats["rows_per_dispatch"] is None
            and stats["ttft_ms"] == {"window": 0}, f"warmup left counters behind: {stats}")
    _, first_s = serve(engine, prompts[:1], grammars=[1])
    first_ttft = engine.stats()["ttft_ms"]["max_ms"]
    paged_decode_attention.launches = 0
    free, free_s = serve(engine, prompts, grammars=[0] * len(prompts))
    free_launches = paged_decode_attention.launches
    require(free == reference, f"grammar 0 streams differ from the unconstrained engine's: {free} / {reference}")
    grammars = list(range(1, cs.n_grammars))
    lps = [None] * len(prompts)
    paged_decode_attention.launches = 0
    streams, cons_s = serve(engine, prompts, grammars=grammars, logprobs=lps)
    cons_launches = paged_decode_attention.launches
    stats = engine.stats()
    if profile:
        profile_run("serve 4 streams, grammars 1-4 (bf16)", lambda: serve(engine, prompts, grammars=grammars))
    engine.close()
    require(free_launches > 0 and cons_launches > 0, "the structured path did not reach the paged decode kernel")
    ends = []
    for grammar, tokens, lp in zip(grammars, streams, lps):
        ok, eos = dfa_walk(cs, grammar, tokens)
        require(ok, f"grammar {grammar}: a token its DFA disallows, or tokens after EOS, in {tokens}")
        require(len(lp) >= len(tokens) and all(math.isfinite(v) and v <= 0 for v in lp),
                f"grammar {grammar}: logprobs {lp} for {len(tokens)} tokens")
        ends.append(f"{len(tokens)} tokens{', EOS in an accepting state' if eos else ''}")
    print(f"structured streams, grammars 1-4 (logprobs=True): {'; '.join(ends)}; texts "
          f"{[''.join(vocab[t] for t in tokens) for tokens in streams]}", flush=True)

    # one decode step's mask and state advance at the served batch, on the card
    with torch.no_grad():
        logits = torch.randn(slots, cfg.vocab_size, device=gen.device)
        state = torch.as_tensor(cs.start_states(grammars), device=gen.device)
        nxt = torch.zeros(slots, dtype=torch.int32, device=gen.device)
        def step():
            return gen._constrain(logits, state), gen._cs_trans[state.long(), nxt.long()]

        mask_ms = time_ms(step)
        mask_dev_ms, mask_host_ms = device_ms(step)
        lp_ms = time_ms(lambda: torch.log_softmax(logits, dim=-1).gather(1, nxt[:, None].long()))
    n_tokens = sum(map(len, reference))
    print(f"structured serving, 4 streams at Llama-3-8B width (bf16): unconstrained engine {n_tokens / plain_s:.1f} "
          f"tok/s; constrained engine under grammar 0 {n_tokens / free_s:.1f} tok/s (the same tokens); grammars 1-4 "
          f"{sum(map(len, streams)) / cons_s:.1f} tok/s ({sum(map(len, streams))} tokens, TTFT p50 "
          f"{stats['ttft_ms']['p50_ms']} ms, decode dispatch {stats['tbt_ms']['p50_ms']} ms p50); warmup() "
          f"{warm_s:.2f} s, then the first stream's TTFT {first_ttft} ms ({first_s:.2f} s for the stream); mask + "
          f"state step {mask_ms:.4f} ms with launch work ({mask_dev_ms:.4f} ms device only, {mask_host_ms:.4f} ms "
          f"host enqueue), logprob {lp_ms:.4f} ms with launch work, a decode step ([{slots}, {cfg.vocab_size}] f32); "
          f"paged launches {free_launches} and {cons_launches}; card {card}", flush=True)
    del model, gen, engine, plain
    torch.cuda.empty_cache()
    structured_parity(cs, gcfg, prompts, slots, decode_chunk, grammars)


def structured_parity(cs, gcfg, prompts, slots, decode_chunk, grammars) -> None:
    """float32, 2 layers at full width: the constrained engine on the card
    (paged kernel) serves the tokens and logprobs of the same weights on the
    CPU (the kernel's twin)."""
    import torch

    from unionml_tpu_torch import ContinuousBatcher, Generator, Llama, LlamaConfig
    from unionml_tpu_torch.ops.paged_attention import paged_decode_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = LlamaConfig.llama3_8b(n_layers=2, attention_impl="flash", dtype=torch.float32, param_dtype=torch.float32)
    pcfg = dataclasses.replace(gcfg, max_new_tokens=STRUCTURED_NEW, eos_id=STRUCTURED_EOS, constraints=cs)
    t0 = time.perf_counter()
    card_model = Llama(cfg32, seed=4)
    cpu_model = Llama(cfg32, device="cpu")
    cpu_model.load_state_dict(card_model.state_dict())
    runs = []
    before = paged_decode_attention.launches
    for model, device in ((card_model, None), (cpu_model, "cpu")):
        engine = ContinuousBatcher(Generator(model, pcfg, device=device), slots=slots, decode_chunk=decode_chunk,
                                   block_size=BLOCK)
        lps = [None] * len(prompts)
        streams, _ = serve(engine, prompts, grammars=grammars, logprobs=lps)
        engine.close()
        runs.append((streams, lps))
    launched = paged_decode_attention.launches - before
    (card_streams, card_lps), (cpu_streams, cpu_lps) = runs
    same = card_streams == cpu_streams and all(len(x) == len(y) for x, y in zip(card_lps, cpu_lps))
    err = max(abs(a - b) for x, y in zip(card_lps, cpu_lps) for a, b in zip(x, y))
    print(f"float32 structured parity, 2 layers, grammars 1-4 x up to {STRUCTURED_NEW} tokens: engine on the card "
          f"({launched} paged launches) vs the CPU: tokens {'identical' if same else 'DIFFERENT'}, logprobs max abs "
          f"err {err:.3g} (tolerance {STRUCTURED_LP_ATOL}) ({time.perf_counter() - t0:.1f} s)", flush=True)
    require(launched > 0 and same and err <= STRUCTURED_LP_ATOL, f"{card_streams} / {cpu_streams}")
    require(all(dfa_walk(cs, g, tokens)[0] for g, tokens in zip(grammars, card_streams)), "a disallowed token")


def lora_llama(cfg, seed):
    from unionml_tpu_torch import Llama, TrainState
    from unionml_tpu_torch.models import lora_optimizer

    model = Llama(cfg, seed=seed)
    return TrainState(model, lora_optimizer(model, LR))


def training_phase(card: str, profile: bool) -> tuple:
    """LoRA fine-tune at Llama-3-8B width through ``fit``: returns the flash
    kernels' launch counts on this run and its losses (phase 16a's
    reference)."""
    import math

    import numpy as np
    import torch

    from unionml_tpu_torch import LlamaConfig, TrainerConfig, fit, make_train_step
    from unionml_tpu_torch.models import chunked_causal_lm_loss
    from unionml_tpu_torch.ops.flash_attention import (
        flash_backward, flash_backward_f32, flash_forward, flash_forward_f32,
    )

    cfg = LlamaConfig.llama3_8b(lora_rank=8, attention_impl="flash", remat=TRAIN_REMAT)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = lora_llama(cfg, seed=0)
    torch.cuda.synchronize()
    print(f"Llama-3-8B width LoRA rank 8, {cfg.n_layers} layers, bf16 compute, f32 parameters: built in "
          f"{time.perf_counter() - t0:.1f} s, {torch.cuda.memory_allocated() / 2**30:.1f} GiB", flush=True)
    probe = state.model.layer_0.attn.q_proj.kernel.detach().clone()  # one base kernel
    adapters_b = {n: p.detach().clone() for n, p in state.model.named_parameters() if n.endswith("lora_b")}
    tokens = phase5_tokens(cfg.vocab_size)
    step = make_train_step(lambda model, batch: chunked_causal_lm_loss(model, batch))
    config = TrainerConfig(epochs=1, batch_size=1, shuffle=True, log_every_steps=1)

    counted = (flash_forward, flash_backward, flash_forward_f32, flash_backward_f32)
    for fn in counted:
        fn.launches = 0
    t0 = time.perf_counter()
    result = fit(state, step, tokens, config)
    seconds = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counted}
    peak = torch.cuda.max_memory_allocated()

    losses = [h["loss"] for h in result.history]
    per_step = cfg.n_layers * TRAIN_STEPS
    # bf16 compute: the bf16 forward and the fused backward, never the f32 kernels
    expected = {"flash_forward": per_step * (2 if cfg.remat else 1), "flash_backward": per_step,
                "flash_forward_f32": 0, "flash_backward_f32": 0}
    frozen = torch.equal(state.model.layer_0.attn.q_proj.kernel, probe)
    moved = [n for n, p in state.model.named_parameters() if n in adapters_b and not torch.equal(p, adapters_b[n])]
    sps = result.samples_per_sec
    # model FLOPs of one step: 4 * N * T for the frozen matmuls (forward and input
    # gradient; no weight gradient) plus 7 attention products (2 forward + 5 backward)
    matmul_params = sum(p.numel() for n, p in state.model.named_parameters()
                        if n.endswith(".kernel"))
    attention = 7 * 2 * visible_pairs(TRAIN_SEQ, TRAIN_SEQ, True) * cfg.n_heads * (cfg.dim // cfg.n_heads) * cfg.n_layers
    flops = 4 * matmul_params * TRAIN_SEQ + attention
    print(f"trained {result.steps} steps of B=1 x S={TRAIN_SEQ} in {seconds:.1f} s (first step {result.compile_time_s:.2f} s): "
          f"{sps:.4f} samples/s, {sps * TRAIN_SEQ:.1f} tokens/s, {1e3 / sps if sps else float('nan'):.1f} ms/step; "
          f"{flops * sps / 1e12:.1f} TFLOP/s achieved = (4 x {matmul_params} frozen matmul params x {TRAIN_SEQ} tokens "
          f"+ {attention} attention ops) per step; peak memory {peak / 2**30:.2f} GiB "
          f"(max_memory_allocated); losses {losses}; flash launches {launches} (expected {expected}); "
          f"card {card}", flush=True)
    require(len(losses) == TRAIN_STEPS and all(math.isfinite(x) for x in losses), f"losses {losses}")
    require(frozen, "a frozen base kernel changed")
    require(len(moved) == len(adapters_b) > 0, f"{len(adapters_b) - len(moved)} lora_b adapters did not move")
    require(launches == expected, f"flash launches {launches}, expected {expected}")
    if profile:
        batch = torch.from_numpy(tokens[:1]).cuda()
        profile_run("one training step", lambda: step(state, batch))
    return launches, losses


def parity_runs(cfg, seed: int) -> dict:
    """3 steps of ``fit`` through the flash kernels and through the plain
    path, from the same weights and data: ``{impl: (losses, adapters,
    launches)}``, launches of the flash wrappers on the kernel path."""
    import dataclasses as dc

    import numpy as np
    import torch

    from unionml_tpu_torch import TrainerConfig, fit, make_train_step
    from unionml_tpu_torch.models import chunked_causal_lm_loss
    from unionml_tpu_torch.ops.flash_attention import (
        flash_backward, flash_backward_f32, flash_forward, flash_forward_f32,
    )

    tokens = np.random.RandomState(seed).randint(0, cfg.vocab_size, size=(PARITY_STEPS, PARITY_SEQ)).astype(np.int64)
    step = make_train_step(lambda model, batch: chunked_causal_lm_loss(model, batch))
    counted = (flash_forward, flash_backward, flash_forward_f32, flash_backward_f32)
    runs = {}
    for impl in ("flash", "auto"):
        state = lora_llama(dc.replace(cfg, attention_impl=impl), seed=seed - 1)
        for fn in counted:
            fn.launches = 0
        result = fit(state, step, tokens, TrainerConfig(epochs=1, batch_size=1, shuffle=True, log_every_steps=1))
        runs[impl] = ([h["loss"] for h in result.history],
                      {n: p.detach().clone() for n, p in state.model.named_parameters() if "lora" in n},
                      {fn.__name__: fn.launches for fn in counted})
        del state
        torch.cuda.empty_cache()
    return runs


def training_parity_phase() -> dict:
    """3 steps of ``fit`` at float32 through the flash kernels (the f32
    forward and the fused f32 backward) and through the plain path, from the same weights
    and data: the loss histories and the trained adapters agree. Returns the
    kernel path's flash launches."""
    import torch

    from unionml_tpu_torch import LlamaConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = LlamaConfig.llama3_8b(n_layers=2, lora_rank=8, attention_impl="flash", dtype=torch.float32,
                                param_dtype=torch.float32)
    runs = parity_runs(cfg, seed=3)
    (kernel_losses, kernel_lora, launches), (plain_losses, plain_lora, _) = runs["flash"], runs["auto"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(kernel_losses, plain_losses))
    diffs = torch.cat([(kernel_lora[n] - plain_lora[n]).abs().flatten() for n in plain_lora])
    # Adam's step is near lr * sign(g) where a gradient is tiny, so a near-zero
    # gradient whose sign differs between the paths moves an entry by up to
    # 2 * lr per step; the mean bounds how many entries may do so
    max_tol, mean_tol = 2 * LR * PARITY_STEPS, 1e-3 * LR
    per_run = cfg.n_layers * PARITY_STEPS
    expected = {"flash_forward": 0, "flash_backward": 0, "flash_forward_f32": per_run, "flash_backward_f32": per_run}
    print(f"float32 training parity, 2 layers, S={PARITY_SEQ}, {PARITY_STEPS} steps: losses kernel {kernel_losses} "
          f"plain {plain_losses} (max rel err {loss_err:.3g}, tolerance 1e-5); adapters max abs diff "
          f"{diffs.max().item():.3g} (tolerance {max_tol}), mean {diffs.mean().item():.3g} (tolerance {mean_tol}); "
          f"flash launches {launches} (expected {expected})", flush=True)
    require(len(kernel_losses) == PARITY_STEPS and loss_err <= 1e-5, "loss histories differ")
    require(diffs.max().item() <= max_tol and diffs.mean().item() <= mean_tol, "trained adapters differ")
    require(launches == expected, f"flash launches {launches}, expected {expected}")
    return launches


def bf16_training_parity_phase() -> None:
    """3 steps of ``fit`` at bf16 compute (f32 parameters, the training
    phase's types) through the flash kernels (the bf16 forward and the fused
    backward) and
    through the plain path: the loss histories agree within
    ``BF16_PARITY_LOSS_REL``."""
    from unionml_tpu_torch import LlamaConfig

    cfg = LlamaConfig.llama3_8b(n_layers=2, lora_rank=8, attention_impl="flash")
    runs = parity_runs(cfg, seed=5)
    (kernel_losses, _, launches), (plain_losses, _, _) = runs["flash"], runs["auto"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(kernel_losses, plain_losses))
    per_run = cfg.n_layers * PARITY_STEPS
    expected = {"flash_forward": per_run, "flash_backward": per_run, "flash_forward_f32": 0, "flash_backward_f32": 0}
    print(f"bf16 training parity, 2 layers, S={PARITY_SEQ}, {PARITY_STEPS} steps: losses kernel {kernel_losses} "
          f"plain {plain_losses} (max rel err {loss_err:.3g}, tolerance {BF16_PARITY_LOSS_REL}); flash launches "
          f"{launches} (expected {expected})", flush=True)
    require(len(kernel_losses) == PARITY_STEPS and loss_err <= BF16_PARITY_LOSS_REL, "bf16 loss histories differ")
    require(launches == expected, f"flash launches {launches}, expected {expected}")


#: phase 7, the app protocol: (a) at Llama-3-8B width, APP_ROWS sequences of APP_SEQ tokens (one step each),
#: four prompts of APP_PROMPT tokens, APP_NEW new tokens; (b) at the text-generation template's width
APP_ROWS, APP_SEQ, APP_PROMPT, APP_NEW = 3, 2048, 64, 16
TINY_ROWS, TINY_SEQ, TINY_BATCH, TINY_VOCAB, TINY_PROMPT, TINY_NEW = 16, 32, 4, 64, 16, 24
TINY_LR = 3e-3  # the template's rate
APP_LOSS_REL = 1e-5  # f32 losses through the flash kernels against the plain path (training parity's tolerance)


def protocol_app(cfg, batch_size: int, new_tokens: int, prompt_len: int):
    """A pandas-free app over the port's ``Dataset``/``Model``: a reader of
    seeded token rows, ``init`` building the Llama of ``cfg`` (the
    hyperparameters may set ``attention_impl``, ``device`` and ``seed``;
    LoRA adapters train under ``lora_optimizer``, otherwise every parameter
    under AdamW), a step trainer over ``chunked_causal_lm_loss``, a
    ``Generator`` predictor and a stream predictor over one shared
    ``ContinuousBatcher`` a state (``model.generation_batcher``)."""
    import numpy as np
    import torch

    from unionml_tpu_torch import (
        ContinuousBatcher, Dataset, GenerationConfig, Generator, Llama, Model, TrainerConfig, TrainState,
        make_train_step,
    )
    from unionml_tpu_torch.models import chunked_causal_lm_loss, lora_optimizer

    dataset = Dataset(name="tokens")
    model = Model(name="app_protocol", dataset=dataset)
    engines: dict = {}
    engines_lock = threading.Lock()  # concurrent streams must share one engine, not each make their own

    @dataset.reader
    def reader(n: int, seq: int, seed: int = 1) -> np.ndarray:
        return np.random.RandomState(seed).randint(1, cfg.vocab_size, size=(n, seq)).astype(np.int64)

    @model.init
    def init(hyperparameters: dict) -> TrainState:
        config = dataclasses.replace(cfg, attention_impl=hyperparameters.get("attention_impl", cfg.attention_impl))
        module = Llama(config, device=hyperparameters.get("device"), seed=hyperparameters.get("seed", 0))
        if config.lora_rank:
            return TrainState(module, lora_optimizer(module, LR))
        return TrainState(module, torch.optim.AdamW(module.parameters(), lr=TINY_LR, weight_decay=1e-4))

    step = make_train_step(chunked_causal_lm_loss)

    @model.trainer(config=TrainerConfig(epochs=1, batch_size=batch_size, shuffle=True, log_every_steps=1))
    def trainer(state: TrainState, batch) -> tuple:
        return step(state, batch)

    def engines_for(state: TrainState) -> tuple:
        with engines_lock:
            entry = engines.get(id(state))
            if entry is None or entry[0] is not state:
                for _, _, stale in engines.values():
                    stale.close()
                engines.clear()
                gen = Generator(
                    state.model,
                    GenerationConfig(max_new_tokens=new_tokens, temperature=0.0, prompt_buckets=(prompt_len,)),
                    device=next(state.model.parameters()).device,
                )
                batcher = ContinuousBatcher(gen, slots=4, decode_chunk=8, block_size=BLOCK)
                entry = engines[id(state)] = (state, gen, batcher)
                model.generation_batcher = batcher
            return entry[1], entry[2]

    @model.predictor
    def predictor(state: TrainState, features: np.ndarray) -> np.ndarray:
        return engines_for(state)[0](features.tolist())

    @model.stream_predictor
    def stream_predictor(state: TrainState, features: np.ndarray):
        """One prompt through the shared engine; yields its token chunks."""
        yield from engines_for(state)[1].submit(features[0].tolist())

    def close() -> None:
        for _, _, batcher in engines.values():
            batcher.close()
        engines.clear()

    model.close_engines = close
    return model


def stream_all(model, prompts) -> tuple:
    """Each prompt through the app's stream predictor from its own thread:
    (token rows, seconds)."""
    state = model.artifact.model_object
    rows = [None] * len(prompts)

    def worker(i):
        rows[i] = [int(t) for chunk in model._stream_predictor(state, prompts[i:i + 1]) for t in chunk]

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(prompts))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
        if t.is_alive():
            raise TimeoutError("a stream did not finish within 600 s")
    return rows, time.perf_counter() - t0


def app_counted():
    from unionml_tpu_torch.ops.flash_attention import (
        flash_backward, flash_backward_f32, flash_forward, flash_forward_f32,
    )
    from unionml_tpu_torch.ops.int8_matmul import int8_matmul
    from unionml_tpu_torch.ops.paged_attention import paged_decode_attention

    return (flash_forward, flash_backward, flash_forward_f32, flash_backward_f32, int8_matmul, paged_decode_attention)


def all_launches() -> dict:
    """Every port kernel's launch count, the int8-page mode's apart."""
    from unionml_tpu_torch.ops.paged_attention import paged_decode_attention

    counts = {fn.__name__: fn.launches for fn in app_counted()}
    counts["paged_decode_attention_int8"] = paged_decode_attention.int8_launches
    return counts


def reset_counts() -> None:
    """Set every count of :func:`all_launches` to 0."""
    from unionml_tpu_torch.ops.paged_attention import paged_decode_attention

    for fn in app_counted():
        fn.launches = 0
    paged_decode_attention.int8_launches = 0


def app_protocol_phase(card: str) -> dict:
    """Phase 7, the app protocol: (a) ``Model.train``/``predict`` and the
    stream predictor at Llama-3-8B width, (b) the same app at the template's
    width in float32 (kernel against plain losses, stream against predict,
    save and load on the card and on the CPU), (c) the native records
    parser. Returns the kernels' launches on this path."""
    import tempfile

    import numpy as np
    import torch

    from unionml_tpu_torch import LlamaConfig

    counted = app_counted()
    totals = {fn.__name__: 0 for fn in counted}

    # ---- (a) full width: LoRA rank 8, f32 parameters, bf16 compute
    cfg = LlamaConfig.llama3_8b(lora_rank=8, attention_impl="flash")
    model = protocol_app(cfg, batch_size=1, new_tokens=APP_NEW, prompt_len=APP_PROMPT)
    for fn in counted:
        fn.launches = 0
    t0 = time.perf_counter()
    state, _ = model.train(hyperparameters={"seed": 0}, n=APP_ROWS, seq=APP_SEQ)
    train_s = time.perf_counter() - t0
    fit = model.last_fit_result
    losses = [h["loss"] for h in fit.history]
    train_launches = {fn.__name__: fn.launches for fn in counted}
    per_run = cfg.n_layers * APP_ROWS
    expected = {"flash_forward": per_run, "flash_backward": per_run, "flash_forward_f32": 0,
                "flash_backward_f32": 0, "int8_matmul": 0, "paged_decode_attention": 0}
    prompts = np.random.RandomState(2).randint(1, cfg.vocab_size, size=(4, APP_PROMPT))
    model.predict(features=prompts[:1])  # set-up: the Generator's first calls
    t0 = time.perf_counter()
    first = model.predict(features=prompts)
    predict_s = time.perf_counter() - t0
    second = model.predict(features=prompts)
    model.close_engines()  # a fresh engine for the timed streams
    paged_before = counted[-1].launches
    streams, stream_s = stream_all(model, prompts)
    stats = model.generation_batcher.stats()
    paged = counted[-1].launches - paged_before
    launches = {fn.__name__: fn.launches for fn in counted}
    model.close_engines()
    print(f"app protocol (a), Llama-3-8B width LoRA rank 8 ({cfg.n_layers} layers, f32 parameters, bf16 compute): "
          f"model.train {fit.steps} steps of B=1 x S={APP_SEQ} in {train_s:.1f} s (init and data included; "
          f"first step {fit.compile_time_s:.2f} s), losses {losses}; model.predict 4 prompts x {APP_PROMPT} "
          f"tokens -> {APP_NEW} new: {4 * APP_NEW / predict_s:.1f} tok/s, repeated call equal: "
          f"{np.array_equal(first, second)}; stream predictor 4 concurrent prompts: "
          f"{sum(map(len, streams)) / stream_s:.1f} tok/s ({stats['decode_dispatches']} decode dispatches); "
          f"launches in train {train_launches} (expected {expected}), whole app {launches}; card {card}",
          flush=True)
    require(fit.steps == APP_ROWS and all(math.isfinite(x) for x in losses), f"losses {losses}")
    require(train_launches == expected, f"train launches {train_launches}, expected {expected}")
    require(np.array_equal(first, second) and first.shape == (4, APP_NEW), "repeated model.predict differs")
    require(all(len(s) == APP_NEW and all(0 <= t < cfg.vocab_size for t in s) for s in streams), "stream tokens")
    require(paged == cfg.n_layers * stats["decode_dispatches"] * 8 > 0, f"{paged} paged launches")
    require(launches["int8_matmul"] == 0, f"the app does not quantize, yet int8_matmul launched: {launches}")
    for name, n in launches.items():
        totals[name] += n
    del model, state
    torch.cuda.empty_cache()

    # ---- (b) the template's width, float32, flash against plain; save and load
    tiny = LlamaConfig.tiny(vocab_size=TINY_VOCAB, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=128,
                            max_seq_len=TINY_SEQ + TINY_NEW, dtype=torch.float32, param_dtype=torch.float32,
                            attention_impl="flash")
    model = protocol_app(tiny, batch_size=TINY_BATCH, new_tokens=TINY_NEW, prompt_len=TINY_PROMPT)
    for fn in counted:
        fn.launches = 0
    model.train(hyperparameters={"attention_impl": "auto"}, n=TINY_ROWS, seq=TINY_SEQ)
    plain_losses = [h["loss"] for h in model.last_fit_result.history]
    for fn in counted:
        totals[fn.__name__] += fn.launches
        fn.launches = 0
    model.train(hyperparameters={"attention_impl": "flash"}, n=TINY_ROWS, seq=TINY_SEQ)
    kernel_losses = [h["loss"] for h in model.last_fit_result.history]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(kernel_losses, plain_losses))
    prompts = np.random.RandomState(3).randint(1, TINY_VOCAB, size=(4, TINY_PROMPT))
    predicted = model.predict(features=prompts)
    streams, _ = stream_all(model, prompts)
    launches = {fn.__name__: fn.launches for fn in counted}
    model.close_engines()
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/model_object.pt"
        model.save(path)
        trained = model.artifact.model_object
        model.artifact = None
        model.load(path)
        reloaded = model.artifact.model_object
        on_card = all(p.device.type == "cuda" for p in reloaded.model.parameters())
        card_again = model.predict(features=prompts)
        model.close_engines()
        model.load(path, hyperparameters={"device": "cpu"})
        on_cpu = all(p.device.type == "cpu" for p in model.artifact.model_object.model.parameters())
        cpu_predicted = model.predict(features=prompts)
    steps = len(kernel_losses)
    per_run = tiny.n_layers * steps
    print(f"app protocol (b), template width (dim 64, 2 layers, f32), {steps} steps of B={TINY_BATCH} x "
          f"S={TINY_SEQ}: losses kernel {kernel_losses} plain {plain_losses} (max rel err {loss_err:.3g}, "
          f"tolerance {APP_LOSS_REL}); stream text equals predict: {streams == predicted.tolist()}; save -> load on "
          f"the card: tensors on the card {on_card}, predictions identical {np.array_equal(card_again, predicted)}; "
          f"loaded with device=cpu: on the CPU {on_cpu}, greedy tokens equal {np.array_equal(cpu_predicted, predicted)}; "
          f"launches {launches} (f32 kernels expected {per_run} each)", flush=True)
    require(steps == TINY_ROWS // TINY_BATCH and loss_err <= APP_LOSS_REL, "app loss histories differ")
    require(launches["flash_forward_f32"] == per_run and launches["flash_backward_f32"] == per_run,
            f"f32 flash launches {launches}")
    require(launches["paged_decode_attention"] > 0, "no paged launch in (b)")
    require(streams == predicted.tolist(), f"stream {streams} != predict {predicted.tolist()}")
    require(on_card and np.array_equal(card_again, predicted), "the reloaded state on the card differs")
    require(on_cpu and np.array_equal(cpu_predicted, predicted), "the state loaded on the CPU predicts otherwise")
    require(trained is not reloaded, "load returned the trained object")
    for fn in counted:  # the reloaded state's predictions included
        totals[fn.__name__] += fn.launches
    require(totals["int8_matmul"] == 0, f"the app does not quantize, yet int8_matmul launched: {totals}")
    model.close_engines()
    del model, trained, reloaded
    torch.cuda.empty_cache()

    # ---- (c) the native records parser builds and parses
    from unionml_tpu_torch.native import parse_records

    records = [{"x": float(i), "y": -0.5 * i, "flag": bool(i % 2)} for i in range(4)]
    parsed = parse_records(json.dumps(records).encode())
    require(parsed is not None, "the native records parser did not build or refused a records payload")
    matrix, columns, _ = parsed
    require(columns == ["x", "y", "flag"] and np.array_equal(
        matrix, np.array([[r["x"], r["y"], float(r["flag"])] for r in records])), f"parsed {parsed}")
    print(f"app protocol (c), native records parser: {matrix.shape} float64 matrix, columns {columns}", flush=True)
    return totals


#: phase 8, the serving half: the bf16 serving model behind ``Model.serve()`` over a loopback socket
HTTP_TIMEOUT_S = 600  # one request's socket timeout
HTTP_DEADLINE_MS = 1  # the deadline header that must shed with 503


def serving_app_model(module, gcfg, slots: int, decode_chunk: int):
    """A pandas-free ``Dataset``/``Model`` app around a built ``Llama``: token-id
    features (no tokenizer), ``model.artifact`` set directly. The predictor runs
    its batch through the shared engine's ``Generator`` on the paged pool
    (``ContinuousBatcher(slots, decode_chunk, block_size=16)``); the stream
    predictor yields one prompt's token chunks from the same engine. Both are
    registered through ``generation_batcher``/``generation_warmup``, as the
    text-generation template does; ``model.warmed`` is set once the warm-up
    finished."""
    from typing import List

    from unionml_tpu_torch import ContinuousBatcher, Dataset, Generator, Llama, Model
    from unionml_tpu_torch.artifact import ModelArtifact
    from unionml_tpu_torch.serving import current_deadline

    dataset = Dataset(name="http_tokens")
    model = Model(name="http_serving", dataset=dataset)

    @dataset.reader
    def reader(n: int = 4) -> List[List[int]]:
        return [[1 + i] for i in range(n)]

    @dataset.feature_loader
    def feature_loader(raw) -> List[List[int]]:
        return [[int(t) for t in row] for row in raw]

    @model.init
    def init(hyperparameters: dict) -> Llama:
        return module

    engines: dict = {}

    def engine() -> "ContinuousBatcher":
        if "batcher" not in engines:
            gen = Generator(module, gcfg, device=next(module.parameters()).device)
            engines["batcher"] = ContinuousBatcher(gen, slots=slots, decode_chunk=decode_chunk, block_size=BLOCK)
            model.generation_batcher = engines["batcher"]
        return engines["batcher"]

    @model.predictor
    def predictor(llama: Llama, features: List[List[int]]) -> List[List[int]]:
        streams = [engine().submit(prompt) for prompt in features]  # all resident at once
        return [[int(t) for chunk in stream for t in chunk] for stream in streams]

    @model.stream_predictor
    def stream_predictor(llama: Llama, features: List[List[int]]):
        for chunk in engine().submit(features[0], deadline=current_deadline()):
            yield [int(t) for t in chunk]

    def warmup() -> None:
        engine().warmup()
        model.warmed = True

    model.warmed = False
    model.generation_warmup = warmup
    model.artifact = ModelArtifact(module)
    return model


def http_request(port: int, method: str, path: str, body=None, headers=None, *, first_chunk: list = None):
    """One request over a fresh loopback connection: (status, headers, body
    bytes). ``first_chunk``, when given, receives the seconds from sending to
    the first body bytes (a stream's time to first token on the wire)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=HTTP_TIMEOUT_S)
    try:
        data = None if body is None else json.dumps(body).encode()
        t0 = time.perf_counter()
        conn.request(method, path, body=data, headers={"Content-Type": "application/json", **(headers or {})})
        response = conn.getresponse()
        first = response.read1() if first_chunk is not None else b""
        if first_chunk is not None:
            first_chunk.append(time.perf_counter() - t0)
        return response.status, dict(response.getheaders()), first + response.read()
    finally:
        conn.close()


def concurrent(fns) -> tuple:
    """Run each zero-argument callable on its own thread: (results, seconds)."""
    results = [None] * len(fns)
    errors = []

    def worker(i):
        try:
            results[i] = fns[i]()
        except BaseException as exc:  # re-raised on the main thread below
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(fns))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=HTTP_TIMEOUT_S)
        if t.is_alive():
            raise TimeoutError(f"a request did not finish within {HTTP_TIMEOUT_S} s")
    if errors:
        raise errors[0]
    return results, time.perf_counter() - t0


def parse_prometheus(text: str) -> int:
    """Samples in a Prometheus text exposition; raises on a malformed line."""
    import re

    sample = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-zA-Z_][a-zA-Z0-9_]*="(\\.|[^"\\])*"'
                        r'(,[a-zA-Z_][a-zA-Z0-9_]*="(\\.|[^"\\])*")*\})? -?([0-9.e+-]+|NaN|[+-]Inf)$')
    count = 0
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        require(sample.match(line) is not None, f"malformed Prometheus line {line!r}")
        float(line.rsplit(" ", 1)[1])
        count += 1
    return count


@contextlib.contextmanager
def served_in_thread(app):
    """``app.server.serve`` on an ephemeral loopback port, its event loop on a
    daemon thread; yields the port. On leaving, the SIGTERM path: ``shutdown``
    drains the server (and closes its engine), the micro-batcher's leftover
    collector is cancelled and the loop closed."""
    import asyncio

    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_until_complete, args=(app.server.serve("127.0.0.1", 0),), daemon=True)
    thread.start()
    for _ in range(500):
        if app.server._server is not None and app.server._server.sockets:
            break
        time.sleep(0.01)
    yield app.server._server.sockets[0].getsockname()[1]
    asyncio.run_coroutine_threadsafe(app.server.shutdown(drain_timeout_s=60), loop).result(timeout=120)
    thread.join(timeout=60)
    leftover = asyncio.all_tasks(loop)  # the micro-batcher's collector waits on its queue forever
    for task in leftover:
        task.cancel()
    if leftover:
        loop.run_until_complete(asyncio.gather(*leftover, return_exceptions=True))
    loop.close()
    require(not thread.is_alive(), "the server did not drain")


def http_phase(card: str, cfg, gcfg, prompts, slots: int, decode_chunk: int, bf16: dict, profile: bool) -> dict:
    """Phase 8, the serving half: ``Model.serve()`` on the bf16 serving model,
    ``HTTPServer.serve`` on an ephemeral loopback port, driven by
    ``http.client`` from threads through ``/predict``, ``/predict-stream``,
    ``/v1/completions``, ``/metrics``, ``/healthz`` and ``/debug/requests``;
    then the SIGTERM-path drain. Returns each kernel's launches across the
    HTTP requests, and phase 19a's replays on the same app and port (run
    after phase 8's checks, inside the served block)."""
    import torch

    from unionml_tpu_torch import Llama

    counted = app_counted()
    t0 = time.perf_counter()
    module = Llama(cfg, seed=0)  # phase 3's weights
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    model = serving_app_model(module, gcfg, slots, decode_chunk)
    app = model.serve()
    app.configure_observability(trace=True)
    t0 = time.perf_counter()
    app.startup()
    startup_s = time.perf_counter() - t0
    batcher = model.generation_batcher
    require(batcher is not None and model.warmed, "the engine was not built and warmed before the first request")
    require(batcher.decode_dispatches == 0, "warmup left its dispatches in the counters")

    # the same engine, direct: each prompt from its own thread (the reference tokens)
    ttft_direct = []

    def direct(prompt):
        start = time.perf_counter()
        stream = batcher.submit(prompt)
        out = [int(t) for t in next(stream)]
        ttft_direct.append(time.perf_counter() - start)
        return out + [int(t) for chunk in stream for t in chunk]

    before = batcher.decode_dispatches
    reference, direct_s = concurrent([functools.partial(direct, p) for p in prompts])
    direct_dispatches = batcher.decode_dispatches - before
    require(all(len(r) == MAX_NEW for r in reference), f"direct stream lengths {[len(r) for r in reference]}")

    # ---- the server on an ephemeral loopback port; leaving the block drains it by the SIGTERM path
    # (shutdown), which closes the engine
    with served_in_thread(app) as port:
        for fn in counted:
            fn.launches = 0
        dispatches_before = batcher.decode_dispatches

        # POST /predict with the 4 prompts (one batch through the engine)
        status, _, body = http_request(port, "POST", "/predict", {"features": prompts})
        require(status == 200, f"/predict answered {status}: {body[:300]!r}")
        predicted = json.loads(body)
        require([len(r) for r in predicted] == [MAX_NEW] * len(prompts) and predicted == reference,
                "/predict tokens differ from the engine's direct tokens")

        # 4 concurrent single-prompt ND-JSON streams
        ttft_http: list = []

        def stream_one(prompt):
            status, headers, body = http_request(port, "POST", "/predict-stream", {"features": [prompt]},
                                                 first_chunk=ttft_http)
            require(status == 200 and headers.get("Content-Type") == "application/x-ndjson", f"stream {status}")
            return [t for line in body.decode().splitlines() if line for t in json.loads(line)]

        before = batcher.decode_dispatches
        streamed, http_s = concurrent([functools.partial(stream_one, p) for p in prompts])
        stream_dispatches = batcher.decode_dispatches - before
        require(streamed == reference, "an ND-JSON stream differs from the engine's direct tokens")

        # /v1/completions, stream=true, logprobs=1, on a token-id prompt
        status, headers, body = http_request(
            port, "POST", "/v1/completions",
            {"prompt": prompts[0], "max_tokens": MAX_NEW, "stream": True, "logprobs": 1},
        )
        require(status == 200 and headers.get("Content-Type", "").startswith("text/event-stream"), f"/v1 {status}")
        events = [line[len("data: "):] for line in body.decode().split("\n\n") if line.startswith("data: ")]
        require(events and events[-1] == "[DONE]", "the SSE stream does not end with [DONE]")
        payloads = [json.loads(e) for e in events[:-1]]
        sse_tokens, sse_logprobs = [], []
        for payload in payloads:
            block = payload["choices"][0].get("logprobs")
            if block:
                sse_tokens += [int(t) for t in block["tokens"]]
                sse_logprobs += block["token_logprobs"]
        usage = payloads[-1].get("usage", {})
        require(sse_tokens == streamed[0], "the SSE tokens differ from the ND-JSON stream's")
        require(len(sse_logprobs) == MAX_NEW and all(math.isfinite(v) and v <= 0 for v in sse_logprobs),
                "SSE logprobs not finite")
        require(usage == {"prompt_tokens": len(prompts[0]), "completion_tokens": MAX_NEW,
                          "total_tokens": len(prompts[0]) + MAX_NEW}, f"usage {usage}")

        # the deadline header sheds with 503
        status, headers, _ = http_request(port, "POST", "/predict-stream", {"features": [prompts[1]]},
                                          headers={"X-Request-Deadline-Ms": str(HTTP_DEADLINE_MS)})
        require(status == 503, f"a {HTTP_DEADLINE_MS} ms deadline answered {status}")

        for _ in range(6000):  # the shed request's session, if it was admitted, ends within a dispatch
            if batcher.occupancy() == (0, 0):
                break
            time.sleep(0.01)
        dispatches = batcher.decode_dispatches - dispatches_before
        http_launches = {fn.__name__: fn.launches for fn in counted}

        # /metrics (json and prometheus), /healthz, /debug/requests
        status, _, body = http_request(port, "GET", "/metrics")
        metrics = json.loads(body)
        generation = metrics["generation"]
        require(status == 200 and generation["slots"] == slots and generation["decode_dispatches"] > 0
                and generation["speculative"] is False and generation["kv_blocks"]["used"] == 0,
                f"/metrics generation {generation}")
        route = next(v for k, v in metrics["routes"].items() if k.endswith("/predict-stream"))
        status, headers, body = http_request(port, "GET", "/metrics?format=prometheus")
        samples = parse_prometheus(body.decode())
        require(status == 200 and samples > 0, "the Prometheus exposition is empty")
        status, _, body = http_request(port, "GET", "/healthz")
        require(status == 200 and json.loads(body)["ready"] is True, f"/healthz {status}")
        status, _, body = http_request(port, "GET", "/debug/requests")
        timelines = json.loads(body)["completed"]
        engine_events = {e["event"] for t in timelines for e in t["events"] if e["event"].startswith("engine.")}
        require(status == 200 and {"engine.submit", "engine.first_token", "engine.finish"} <= engine_events,
                f"/debug/requests engine events {sorted(engine_events)}")

        # ---- phase 19a: workload replay on the same app and port
        replayed = replay_phase(card, app, port, batcher, cfg)

        if profile:
            profile_run("HTTP /predict-stream 4 streams",
                        lambda: concurrent([functools.partial(stream_one, p) for p in prompts]))
    if batcher._thread is not None:
        batcher._thread.join(timeout=60)
    require(batcher._closed and not (batcher._thread and batcher._thread.is_alive()),
            "the server did not drain and close the engine")

    expected = cfg.n_layers * dispatches * decode_chunk
    ttft_http_p50, ttft_direct_p50 = statistics.median(ttft_http), statistics.median(ttft_direct)
    print(f"HTTP serving (Model.serve, loopback socket), Llama-3-8B width bf16 ({cfg.n_layers} layers, built in "
          f"{build_s:.1f} s, startup with warmup {startup_s:.1f} s): 4 concurrent /predict-stream streams x "
          f"{MAX_NEW} tokens {len(prompts) * MAX_NEW / http_s:.1f} tok/s aggregate in {stream_dispatches} decode "
          f"dispatches (the same engine direct {len(prompts) * MAX_NEW / direct_s:.1f} tok/s in {direct_dispatches}; "
          f"phase 3 {bf16['tok_s']:.1f} tok/s); time to first chunk "
          f"p50 over HTTP {ttft_http_p50 * 1e3:.1f} ms against {ttft_direct_p50 * 1e3:.1f} ms direct (HTTP adds "
          f"{(ttft_http_p50 - ttft_direct_p50) * 1e3:.1f} ms a request); /metrics TTFT p50 "
          f"{generation['ttft_ms'].get('p50_ms')} ms, /predict-stream route p50 {route.get('p50_ms')} ms; "
          f"/predict, 4 streams, /v1/completions (SSE, logprobs, usage {usage}) and the 503 shed took "
          f"{dispatches} decode dispatches and {http_launches['paged_decode_attention']} paged launches "
          f"(expected {cfg.n_layers} layers x {dispatches} x {decode_chunk} = {expected}); {samples} Prometheus "
          f"samples; {len(timelines)} traced requests; card {card}", flush=True)
    require(http_launches["paged_decode_attention"] == expected > 0,
            f"{http_launches['paged_decode_attention']} paged launches over HTTP, expected {expected}")
    others = {name: n for name, n in http_launches.items() if name != "paged_decode_attention"}
    require(not any(others.values()), f"kernels off the HTTP path launched: {others}")
    del model, app, batcher, module
    torch.cuda.empty_cache()
    return http_launches, replayed


#: phase 9: speculative decoding and beam search, and the int8-page mode on a live pool


def first_divergence(a, b) -> int:
    """The first position where two token lists differ (their common length if none)."""
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))


@contextlib.contextmanager
def int8_rows():
    """Count the int8 kernel's launches by M (the rows of x) inside the block."""
    int8_module = importlib.import_module("unionml_tpu_torch.ops.int8_matmul")
    counts = collections.Counter()
    launch = int8_module._launch

    def counted(x, *args, **kwargs):
        out = launch(x, *args, **kwargs)
        counts[int(x.shape[0])] += 1
        return out

    int8_module._launch = counted
    try:
        yield counts
    finally:
        int8_module._launch = launch


def draft_config(dtype, **overrides):
    import torch

    from unionml_tpu_torch import LlamaConfig

    return LlamaConfig(**{**DRAFT_1B, **overrides}, attention_impl="flash", dtype=dtype,
                       param_dtype=dtype if dtype == torch.bfloat16 else torch.float32)


def spec_serving_phase(card: str, target, gcfg, prompts, slots: int, decode_chunk: int, bf16: dict,
                       bf16_streams) -> dict:
    """Phase 9a: speculative serving at full width. The bf16 target (phase
    3's weights) with the 1B-shaped draft, then with itself as its own draft
    (the same tensors), each through ``ContinuousBatcher(slots, decode_chunk,
    block_size=16)`` over phase 3's prompts. Every draft step and the
    completeness feed (gamma + 1 single-token forwards a round) launch the
    paged kernel in each draft layer; the verify and the admissions take the
    gather path. Returns the 1B-shaped run's numbers."""
    import torch

    from unionml_tpu_torch import ContinuousBatcher, DraftSpec, Generator, Llama
    from unionml_tpu_torch.ops.paged_attention import paged_decode_attention

    t0 = time.perf_counter()
    draft = Llama(draft_config(torch.bfloat16), seed=DRAFT_SEED)
    torch.cuda.synchronize()
    held = sum(t.numel() * t.element_size() for t in draft.parameters())
    print(f"phase 9a: the 1B-shaped draft (dim {DRAFT_1B['dim']}, {DRAFT_1B['n_layers']} layers, untied head, bf16, "
          f"seed {DRAFT_SEED}) built in {time.perf_counter() - t0:.1f} s, {held / 2**30:.2f} GiB; "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated", flush=True)
    result = {}
    for label, draft_module in (("1B-shaped draft", draft), ("target as its own draft", target)):
        gen = Generator(target, dataclasses.replace(gcfg, draft=DraftSpec(module=draft_module, gamma=GAMMA)))
        spec = gen._speculative()
        warm = ContinuousBatcher(gen, slots=slots, decode_chunk=decode_chunk, block_size=BLOCK)
        serve(warm, [prompts[0][:3]])  # set-up: first launches and allocator calls
        warm.close()
        batcher = ContinuousBatcher(gen, slots=slots, decode_chunk=decode_chunk, block_size=BLOCK)
        spec.rounds = spec.accepted_tokens = spec.proposed_tokens = 0
        for counted in app_counted():
            counted.launches = 0
        streams, seconds = serve(batcher, prompts)
        launches = paged_decode_attention.launches
        others = {c.__name__: c.launches for c in app_counted() if c is not paged_decode_attention}
        stats = batcher.stats()
        batcher.close()
        require(all(len(s) == MAX_NEW for s in streams), f"stream lengths {[len(s) for s in streams]}")
        require(all(0 <= t < target.config.vocab_size for s in streams for t in s), "a token id outside the vocabulary")
        layers = draft_module.config.n_layers
        expected = layers * (GAMMA + 1) * spec.rounds
        diverge = [first_divergence(a, b) for a, b in zip(streams, bf16_streams)]
        tok_s = len(prompts) * MAX_NEW / seconds
        print(f"phase 9a, {label}, gamma {GAMMA}: {tok_s:.1f} tok/s aggregate (phase 3 in this call: "
              f"{bf16['tok_s']:.1f}), TTFT p50 {stats['ttft_ms']['p50_ms']} ms, TBT p50 {stats['tbt_ms']['p50_ms']} ms "
              f"(a dispatch of >= {decode_chunk} tokens a row), {stats['decode_dispatches']} dispatches, "
              f"{spec.rounds} rounds, acceptance_rate {stats.get('acceptance_rate')} (the engine's: accepts summed "
              f"over rows / (rounds x gamma)), accepted {spec.accepted_tokens} of {spec.proposed_tokens} proposals "
              f"({spec.accepted_tokens / max(spec.proposed_tokens, 1):.3f}); streams against phase 3's bf16 streams: "
              f"first divergence at {diverge} of {MAX_NEW}; paged launches {launches} (expected {layers} draft layers "
              f"x (gamma + 1) x {spec.rounds} rounds = {expected}), other kernels {others}; card {card}", flush=True)
        require(launches == expected > 0, f"{launches} paged launches on the speculative path, expected {expected}")
        require(stats["speculative"] is True and all(n == 0 for n in others.values()),
                f"speculative stats {stats['speculative']}, other kernels {others}")
        if draft_module is draft:
            result = dict(spec_launches=launches, tok_s=tok_s, rounds=spec.rounds,
                          acceptance=spec.accepted_tokens / max(spec.proposed_tokens, 1))
    del draft, gen, spec
    torch.cuda.empty_cache()
    return result


def spec_parity_phase(gcfg, prompts, slots: int, decode_chunk: int) -> int:
    """Phase 9b: float32, 2 layers at Llama-3-8B width (phase 4's weights).
    The speculative engine, paged and dense, equals a solo plain Generator
    with three drafts (the 1B-shaped draft cut to 2 layers, the target
    itself, a 1-layer draft); the target as its own draft accepts every
    proposal; ``beam_search`` at width 1 equals greedy and at width 4 equals
    the same weights' search on the CPU; under ``quantize="int8"`` for target
    and draft the speculative streams equal the plain int8 Generator's.
    Returns the int8 kernel's launches on the int8 speculative run."""
    import torch

    from unionml_tpu_torch import ContinuousBatcher, DraftSpec, Generator, Llama, LlamaConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = LlamaConfig.llama3_8b(n_layers=2, attention_impl="flash", dtype=torch.float32, param_dtype=torch.float32)
    t0 = time.perf_counter()
    target = Llama(cfg32, seed=1)
    plain = Llama(dataclasses.replace(cfg32, attention_impl="auto"))
    plain.load_state_dict(target.state_dict())
    solo = Generator(plain, gcfg)
    expected = [solo([p])[0].tolist() for p in prompts]
    drafts = {
        "1B-shaped draft, 2 layers": Llama(draft_config(torch.float32, n_layers=2), seed=DRAFT_SEED),
        "the target itself": target,
        "1B-shaped draft, 1 layer": Llama(draft_config(torch.float32, n_layers=1), seed=DRAFT_SEED + 1),
    }
    for name, draft in drafts.items():
        gen = Generator(target, dataclasses.replace(gcfg, draft=DraftSpec(module=draft, gamma=GAMMA)))
        spec = gen._speculative()
        same = {}
        for block in (BLOCK, None):
            engine = ContinuousBatcher(gen, slots=slots, decode_chunk=decode_chunk, block_size=block)
            streams, _ = serve(engine, prompts)
            engine.close()
            same["paged" if block else "dense"] = streams == expected
        acceptance = spec.accepted_tokens / max(spec.proposed_tokens, 1)
        print(f"phase 9b, float32 speculative parity, {name}: engine streams equal the solo plain Generator's: "
              f"{same}; {spec.rounds} rounds, accepted {spec.accepted_tokens} of {spec.proposed_tokens} proposals "
              f"({acceptance:.3f})", flush=True)
        require(all(same.values()), f"{name}: speculative streams differ from the plain run's")
        if draft is target:
            require(spec.accepted_tokens == spec.proposed_tokens > 0, "the target as its own draft rejected a proposal")
    bcfg = dataclasses.replace(gcfg, max_new_tokens=BEAM_NEW, prompt_buckets=(BEAM_BUCKET,))
    pair = prompts[:2]
    beam_gen = Generator(target, bcfg)
    width_one = beam_gen.beam_search(pair, num_beams=1)
    greedy = beam_gen(pair)
    card_beams = beam_gen.beam_search(pair, num_beams=4)
    cpu_model = Llama(cfg32, device="cpu")
    cpu_model.load_state_dict(target.state_dict())
    cpu_beams = Generator(cpu_model, bcfg, device="cpu").beam_search(pair, num_beams=4)
    print(f"phase 9b, beam search ({len(pair)} prompts x {BEAM_NEW} tokens): width 1 equals greedy: "
          f"{bool((width_one == greedy).all())}; width 4 on the card equals the CPU: "
          f"{bool((card_beams == cpu_beams).all())} ({card_beams.tolist()})", flush=True)
    require((width_one == greedy).all() and (card_beams == cpu_beams).all(), "beam search parity failed")
    del drafts, target, plain, solo, gen, spec, beam_gen, cpu_model
    torch.cuda.empty_cache()

    # int8 weights for target and draft (fresh models: quantize="int8" works in place)
    target8 = Llama(cfg32, seed=1)
    draft8 = Llama(draft_config(torch.float32, n_layers=2), seed=DRAFT_SEED)
    plain8 = Generator(target8, gcfg, quantize="int8")
    expected8 = [plain8([p])[0].tolist() for p in prompts]
    gen8 = Generator(target8, dataclasses.replace(gcfg, draft=DraftSpec(module=draft8, gamma=GAMMA, quantize="int8")),
                     quantize="int8")
    spec8 = gen8._speculative()
    engine = ContinuousBatcher(gen8, slots=slots, decode_chunk=decode_chunk, block_size=BLOCK)
    int8_mm = importlib.import_module("unionml_tpu_torch.ops.int8_matmul").int8_matmul
    int8_mm.launches = 0
    with int8_rows() as rows:
        streams8, _ = serve(engine, prompts)
    engine.close()
    launches = int8_mm.launches
    verify_rows = slots * (GAMMA + 1)
    ties = []
    for prompt, got, want in zip(prompts, streams8, expected8):
        at = first_divergence(got, want)
        if at == len(want):
            continue
        with torch.no_grad():  # the plain int8 Generator's prefill of the common prefix: its next-token logits
            _, _, last, _ = plain8._start([prompt + want[:at]], 0)
            logits = plain8._head(last.to(cfg32.dtype))[0]
        top2 = logits.topk(2).indices.tolist()
        ties.append(dict(position=at, tokens=(want[at], got[at]), gap=abs(float(logits[want[at]] - logits[got[at]])),
                         top2=sorted({want[at], got[at]}) == sorted(top2), logit_std=float(logits.std())))
    print(f"phase 9b, float32 int8 speculative parity (target and draft int8): engine streams equal the plain int8 "
          f"Generator's: {streams8 == expected8}; divergences (each must be a near-tie: the two tokens the top two of "
          f"the plain prefill's logits, at most {INT8_TIE_GAP} apart): {ties}; {spec8.rounds} rounds; int8 "
          f"launches {launches}, by M {dict(sorted(rows.items()))} (M = {verify_rows}: the verify of {slots} slots x "
          f"(gamma + 1)) ({time.perf_counter() - t0:.1f} s for phase 9b)", flush=True)
    require(all(t["top2"] and t["gap"] <= INT8_TIE_GAP for t in ties), f"{streams8} / {expected8}")
    require(rows[verify_rows] > 0 and launches == sum(rows.values()), f"int8 launches by M {dict(rows)}")
    del target8, draft8, plain8, gen8, spec8, engine
    torch.cuda.empty_cache()
    return launches


def int8_pool_phase(card: str, target, gcfg, prompts, slots: int, decode_chunk: int) -> dict:
    """Phase 9c: the bf16 target served over int8 pages (``kv_cache_dtype
    ="int8"``, the gather route, as in JAX), then the int8-page kernel and its
    twin on that engine's live pools: every layer's int8 K/V pages and
    scales with the block table and lengths of the dispatch that had the most
    resident rows, a random bf16 q."""
    import torch

    from unionml_tpu_torch import ContinuousBatcher, Generator
    from unionml_tpu_torch.ops.paged_attention import paged_decode_attention, paged_decode_attention_reference

    gen = Generator(target, dataclasses.replace(gcfg, kv_cache_dtype="int8"))
    engine = ContinuousBatcher(gen, slots=slots, decode_chunk=decode_chunk, block_size=BLOCK)
    seen = {"live": 0}
    decode = gen._decode

    def capture(*carry, steps):
        live = int((~carry[3]).sum())
        if live > seen["live"]:
            seen.update(live=live, lengths=torch.where(carry[3], 0, carry[2]), table=carry[0][0]["table"].clone())
        return decode(*carry, steps=steps)

    gen._decode = capture
    paged_decode_attention.launches = 0
    streams, seconds = serve(engine, prompts)
    gather_launches = paged_decode_attention.launches
    engine.close()
    require(all(len(s) == MAX_NEW for s in streams), f"stream lengths {[len(s) for s in streams]}")
    require(gather_launches == 0 and seen["live"] > 0, f"{gather_launches} paged launches over int8 pages")
    pools, lens, table = engine._carried("cache"), seen["lengths"], seen["table"]
    g = torch.Generator(device="cuda").manual_seed(13)
    mcfg = target.config
    q = torch.randn(slots, mcfg.n_heads, mcfg.dim // mcfg.n_heads, device="cuda", generator=g).to(torch.bfloat16)
    atol, rtol = TOLERANCE[str(q.dtype)]
    paged_decode_attention.int8_launches = 0
    routes = dict(paged_decode_attention.int8_route_launches)
    worst = 0.0
    for i, layer in enumerate(pools):
        args = (q, layer["k"], layer["v"], lens, table)
        out = paged_decode_attention(*args, k_scales=layer["k_scale"], v_scales=layer["v_scale"])
        torch.cuda.synchronize()
        ref = paged_decode_attention_reference(*args, k_scales=layer["k_scale"], v_scales=layer["v_scale"])
        err = (out.float() - ref.float()).abs()
        require(bool((err <= atol + rtol * ref.float().abs()).all()) and not bool(out.isnan().any()),
                f"layer {i}: the int8-page kernel disagrees with its twin on the live pool")
        worst = max(worst, err.max().item())
    launches = paged_decode_attention.int8_launches
    layer = pools[0]
    scales = dict(k_scales=layer["k_scale"], v_scales=layer["v_scale"])
    how = int8_route(q, layer["k"], layer["v"], table, scales, routes, launches)
    require(how.startswith("route mma"), f"the live pools (bf16 q, D=128, {BLOCK}-position pages) took {how}")
    times = paged_times(q, layer["k"], layer["v"], lens, table, table.shape[1], **scales)
    print(f"phase 9c: served 4 streams x {MAX_NEW} over int8 pages (gather route, {gather_launches} paged launches) "
          f"at {len(prompts) * MAX_NEW / seconds:.1f} tok/s; the int8-page kernel on the live pools of all "
          f"{len(pools)} layers ({launches} launches, {how}; {seen['live']} resident rows, lengths "
          f"{lens.tolist()}): max_abs_err {worst} (tolerance atol={atol} rtol={rtol}); layer 0: kernel {times['ms']:.4f} ms "
          f"({times['device_ms']:.4f} device only), twin (int8 gather route) {times['plain_ms']:.4f} ms, library "
          f"{times['library_ms']:.4f} ms ({times['library_device_ms']:.4f}), bound {times['bound_ms']:.6f} ms "
          f"({times['bound_by']}); card {card}", flush=True)
    del gen, engine, pools
    torch.cuda.empty_cache()
    return dict(launches=launches, launch_int8_route=how, live_max_abs_err=worst,
                **{f"live_{k}": v for k, v in times.items()})


#: phase 10: chunked admission and shared-prefix reuse


def serve_timed(batcher, prompts) -> tuple:
    """Submit every prompt from its own thread; return (streams, seconds,
    each stream's time to its first chunk in ms, and from its first chunk to
    its second in ms or None). Through a replica handoff the first chunk is
    the prefill replica's token and the second the decode replica's first
    after the import."""
    results, ttft, gap = [None] * len(prompts), [None] * len(prompts), [None] * len(prompts)

    def worker(i):
        t0 = time.perf_counter()
        tokens, stamps = [], []
        for chunk in batcher.submit(prompts[i]):
            stamps.append(time.perf_counter())
            tokens.extend(int(t) for t in chunk)
        results[i] = tokens
        ttft[i] = (stamps[0] - t0) * 1e3
        gap[i] = (stamps[1] - stamps[0]) * 1e3 if len(stamps) > 1 else None

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(prompts))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
        if t.is_alive():
            raise TimeoutError("a stream did not finish within 600 s")
    return results, time.perf_counter() - t0, ttft, gap


def system_prompt(vocab: int) -> list:
    import numpy as np

    return np.random.RandomState(SYSTEM_SEED).randint(1, vocab, size=SYSTEM_LEN).tolist()


def diverging(prompts, vocab: int) -> list:
    """Each prompt cut at an odd length and continued with other tokens to
    its own length: a radix hit that ends inside a shared block."""
    import numpy as np

    rng = np.random.RandomState(SYSTEM_SEED + 1)
    out = []
    for p in prompts:
        cut = (len(p) // 2) | 1
        tail = rng.randint(1, vocab, size=len(p) - cut).tolist()
        tail[0] = p[cut] % (vocab - 1) + 1  # differs from the cut prompt's next token
        out.append(p[:cut] + tail)
    return out


def first_token_logits(gen, prefix, prompt, chunk: int, cache_len: int):
    """The f32 first-token logits ``[V]`` of one engine admission behind
    ``prefix``, computed as the engine computes them: a dense row cache of
    ``cache_len`` with the prefix's rows pasted, the prompt's bucket (padded
    to whole chunks) through ``Generator._chunked_prefill_loop`` in
    ``chunk``-column slices (a monolithic admission's chunk is the whole
    bucket), and the head on the last prompt row."""
    import numpy as np
    import torch

    from unionml_tpu_torch.models import chunk_aligned, init_cache
    from unionml_tpu_torch.models.generate import _paste_prefix_rows

    bucket = gen._bucket(len(prompt))
    width = chunk_aligned(bucket, chunk)
    tokens = np.full((1, width), gen.config.pad_id, np.int32)
    tokens[0, : len(prompt)] = np.asarray(prompt, np.int32)
    lengths = torch.tensor([prefix.length + len(prompt)], dtype=torch.int32, device=gen.device)
    row = _paste_prefix_rows(init_cache(gen.model.config, 1, cache_len, device=gen.device), prefix.layers)
    row_valid = torch.ones((1,), dtype=torch.bool, device=gen.device)
    with torch.no_grad():
        last, _ = gen._chunked_prefill_loop(tokens, lengths, row, row_valid, chunk, start=prefix.length)
        return gen._head(last.to(gen.model.config.dtype))[0]


def chunked_logits_check(gen, prefix, prompts, mono_cache_len: int, chunked_cache_len: int, card: str) -> None:
    """Phase 10a's bf16 check of chunked against monolithic admission: each
    prompt's first-token logits both ways, within ``CHUNKED_LOGITS_REL_RMS``
    (the reasoning is beside the constant)."""
    rows = []
    for prompt in prompts:
        mono = first_token_logits(gen, prefix, prompt, max(gen.config.prompt_buckets), mono_cache_len)
        chunked = first_token_logits(gen, prefix, prompt, ADMIT_CHUNK, chunked_cache_len)
        diff = (chunked - mono).float()
        rows.append(dict(rel_rms=float(diff.norm() / mono.float().norm()), max_abs=float(diff.abs().max()),
                         logit_rms=float(mono.float().pow(2).mean().sqrt()),
                         same_argmax=bool(chunked.argmax() == mono.argmax())))
    print(f"phase 10a: bf16 first-token logits, chunked (M = {ADMIT_CHUNK}) against monolithic (M = "
          f"{max(gen.config.prompt_buckets)}) admission behind the same prefix, per prompt: relative RMS "
          f"{[round(r['rel_rms'], 6) for r in rows]} (tolerance {CHUNKED_LOGITS_REL_RMS:.4f} = sqrt({BF16_ROUNDINGS}) "
          f"x 2**-8), max |difference| {[round(r['max_abs'], 4) for r in rows]} (logit RMS "
          f"{[round(r['logit_rms'], 3) for r in rows]}), same argmax {[r['same_argmax'] for r in rows]}; "
          f"card {card}", flush=True)
    require(all(r["rel_rms"] <= CHUNKED_LOGITS_REL_RMS for r in rows),
            f"chunked admission's bf16 first-token logits part from monolithic admission's: {rows}")


def prefix_phase(card: str, target, gcfg, prompts, slots: int, decode_chunk: int) -> int:
    """Phase 10a: chunked admission, the static prefix and the radix cache
    at full width, bf16, on phase 9's target. Three waves of phase 3's
    prompts: cold, again (hits), cut and diverging (copy-on-write). Returns
    the paged kernel's launches in the three waves."""
    import torch

    from unionml_tpu_torch import ContinuousBatcher, Generator
    from unionml_tpu_torch.models import chunk_aligned
    from unionml_tpu_torch.ops.paged_attention import paged_decode_attention

    t0 = time.perf_counter()
    gen = Generator(target, gcfg)
    system = gen.cache_prefix(system_prompt(target.config.vocab_size))
    # the same prompts behind the same prefix, admitted monolithically (M = the 256 bucket, not 64): in bf16 the
    # chunked streams may part from these, and the phase reports where
    mono = ContinuousBatcher(gen, slots=slots, decode_chunk=decode_chunk, block_size=BLOCK, prefix=system)
    mono_streams = serve(mono, prompts)[0]
    mono.close()
    engine = ContinuousBatcher(gen, slots=slots, decode_chunk=decode_chunk, block_size=BLOCK, prefix=system,
                               admit_chunk=ADMIT_CHUNK, prefill_budget=PREFILL_BUDGET, max_admissions=MAX_ADMISSIONS,
                               prefix_cache=True)
    chunked_logits_check(gen, system, prompts, mono.cache_len, engine.cache_len, card)
    engine.warmup()
    print(f"phase 10a: system prompt of {SYSTEM_LEN} tokens ({len(engine._shared_prefix_blocks)} shared pages, "
          f"{engine.stats()['kv_blocks']['shared_prefix_tail_tokens']}-token tail), cache_len {engine.cache_len}, "
          f"{engine.max_blocks} table entries, {engine.pool_blocks} pool pages; built and warmed in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    bucket = max(gcfg.prompt_buckets)
    waves = (("cold", prompts), ("again (hits)", prompts),
             ("cut and diverging (copy-on-write)", diverging(prompts, target.config.vocab_size)))
    for counted in app_counted():
        counted.launches = 0
    before = {"prefill": dict(engine.stats()["prefill"]), "prefix_cache": dict(engine.stats()["prefix_cache"])}
    streams_by_wave, expected_chunks = [], 0
    for label, wave in waves:
        cached = [engine.cached_prefix_tokens(p) for p in wave]
        chunks = sum(chunk_aligned(len(p) - c, ADMIT_CHUNK) if c else chunk_aligned(bucket, ADMIT_CHUNK)
                     for p, c in zip(wave, cached)) // ADMIT_CHUNK
        expected_chunks += chunks
        streams, seconds, ttft, _ = serve_timed(engine, wave)
        stats = engine.stats()
        pc, pf = stats["prefix_cache"], stats["prefill"]
        require(all(len(s) == MAX_NEW for s in streams), f"stream lengths {[len(s) for s in streams]}")
        require(all(0 <= t < target.config.vocab_size for s in streams for t in s), "a token id outside the vocabulary")
        print(f"phase 10a, wave {label}: {len(wave) * MAX_NEW / seconds:.1f} tok/s aggregate, TTFT p50 "
              f"{statistics.median(ttft):.1f} ms max {max(ttft):.1f} ms, chunks {pf['chunks'] - before['prefill']['chunks']} "
              f"(expected {chunks} from the cached runs {cached}), hits {pc['hits'] - before['prefix_cache']['hits']}, "
              f"tokens avoided {pc['tokens_avoided'] - before['prefix_cache']['tokens_avoided']}, copy-on-write "
              f"{pc['cow_copies'] - before['prefix_cache']['cow_copies']}, cached blocks {pc['cached_blocks']}, "
              f"evictions {pc['evictions']}; card {card}", flush=True)
        before = {"prefill": dict(pf), "prefix_cache": dict(pc)}
        streams_by_wave.append(streams)
    stats = engine.stats()
    launches = paged_decode_attention.launches
    others = {c.__name__: c.launches for c in app_counted() if c is not paged_decode_attention}
    engine.close()
    pc, pf = stats["prefix_cache"], stats["prefill"]
    expected = target.config.n_layers * stats["decode_dispatches"] * decode_chunk
    same = streams_by_wave[1] == streams_by_wave[0]
    print(f"phase 10a: wave 2 streams equal wave 1's: {same} (first divergence "
          f"{[first_divergence(a, b) for a, b in zip(*streams_by_wave[:2])]}); chunked (wave 1) against monolithic "
          f"admission behind the same prefix, first divergence "
          f"{[first_divergence(a, b) for a, b in zip(streams_by_wave[0], mono_streams)]} of {MAX_NEW}; "
          f"{pc['hits']} hits, {pc['misses']} "
          f"misses, {pc['tokens_avoided']} tokens avoided, {pc['cow_copies']} copies on write, {pf['chunks']} chunks "
          f"(expected {expected_chunks}), {pf['monolithic_admissions']} monolithic; paged launches {launches} "
          f"(expected {target.config.n_layers} layers x {stats['decode_dispatches']} dispatches x {decode_chunk} = "
          f"{expected}), other kernels {others}; card {card}", flush=True)
    require(same, "the cache-hit streams differ from the cold streams")
    require(pc["hits"] >= 3 and pc["tokens_avoided"] > 0 and pc["cow_copies"] >= 1, f"prefix cache {pc}")
    require(pf["chunks"] == expected_chunks and pf["monolithic_admissions"] == 0, f"prefill {pf}")
    require(launches == expected > 0, f"{launches} paged launches on the prefix path, expected {expected}")
    require(all(n == 0 for n in others.values()), f"other kernels launched {others}")
    del gen, system, engine, mono
    torch.cuda.empty_cache()
    return launches


def prefix_parity_phase(gcfg, prompts, slots: int, decode_chunk: int) -> None:
    """Phase 10b: float32, 2 layers (phase 4's weights), TF32 off. Chunked
    admission alone, with the static prefix, with the prefix and the radix
    cache (two waves), and the speculative engine (phase 9b's 2-layer
    draft) under chunked admission and the prefix: each engine's streams
    equal the solo ``Generator`` on the card, with the prefix where the
    engine has one."""
    import torch

    from unionml_tpu_torch import ContinuousBatcher, DraftSpec, Generator, Llama, LlamaConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    cfg32 = LlamaConfig.llama3_8b(n_layers=2, attention_impl="flash", dtype=torch.float32, param_dtype=torch.float32)
    target = Llama(cfg32, seed=1)
    solo = Generator(target, gcfg)
    system = solo.cache_prefix(system_prompt(cfg32.vocab_size))
    plain = [solo([p])[0].tolist() for p in prompts]
    with_prefix = [solo([p], prefix=system)[0].tolist() for p in prompts]
    knobs = dict(slots=slots, decode_chunk=decode_chunk, block_size=BLOCK, admit_chunk=ADMIT_CHUNK,
                 prefill_budget=PREFILL_BUDGET, max_admissions=MAX_ADMISSIONS)
    results = {}
    for name, kwargs, waves, want in (
        ("chunked admission", {}, 1, plain),
        ("chunked + static prefix", dict(prefix=system), 1, with_prefix),
        ("chunked + static prefix + radix cache", dict(prefix=system, prefix_cache=True), 2, with_prefix),
    ):
        engine = ContinuousBatcher(solo, **knobs, **kwargs)
        results[name] = [serve(engine, prompts)[0] == want for _ in range(waves)]
        stats = engine.stats()
        engine.close()
        if "radix" in name:
            require(stats["prefix_cache"]["hits"] >= 3, f"radix waves {stats['prefix_cache']}")
    draft = Llama(draft_config(torch.float32, n_layers=2), seed=DRAFT_SEED)
    spec_gen = Generator(target, dataclasses.replace(gcfg, draft=DraftSpec(module=draft, gamma=GAMMA)))
    engine = ContinuousBatcher(spec_gen, **knobs, prefix=system)
    results["speculative + chunked + static prefix"] = [serve(engine, prompts)[0] == with_prefix]
    chunks = engine.stats()["prefill"]["chunks"]
    engine.close()
    print(f"phase 10b, float32 (TF32 off), 2 layers: engine streams equal the solo Generator's (with the prefix "
          f"where the engine has one): {results}; speculative chunks {chunks} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    require(all(all(v) for v in results.values()) and chunks > 0, f"phase 10b parity {results}")
    del target, solo, system, draft, spec_gen, engine
    torch.cuda.empty_cache()


#: phase 14: the in-process replica layer on phase 9's target. (b) splits the fleet prefill=1,decode=1 at this
#: threshold: the 120- and 250-token prompts hand off, the 5- and 40-token ones admit on the decode replica
REPLICA_THRESHOLD = 64
#: (a)-(c)'s depth: phase 3's configuration at 8 of its 32 layers, cut to make room for phases 19-20 (each layer's
#: shapes, the handoff's per-layer pages and the scheduler are the same)
REPLICA_LAYERS = 8
#: (d) the f32 parity at 2 layers: each card fleet against the same fleet on the CPU, 8 new tokens, the short
#: prompts in a 64-token bucket (the CPU's prefill dominates the phase)
REPLICA_PARITY_NEW, REPLICA_PARITY_BUCKETS = 8, (64, 256)
#: (d) the handoff pages card against CPU, per leaf: |card - cpu| <= HANDOFF_PAGE_REL x max|cpu leaf|. K carries
#: RoPE at positions up to 250: its angle, an f32 product of up to 250 rad through pow, sin and cos that may differ
#: by an ulp between the card and the CPU, is uncertain by up to an ulp at 250 (2**-16 = 1.5e-5 rad), which moves K
#: by up to that share of its scale; V differs by the order of its 4096-term f32 dot products, about sqrt(4096) x
#: 2**-24 = 3.8e-6 of its scale. TOLERANCE's f32 entry (1e-5 absolute) holds one kernel against its twin on outputs
#: of magnitude ~1, not values of magnitude ~5 made on two devices
HANDOFF_PAGE_REL = 1e-5


def handoff_times(cfg, engine, n_pages: int) -> dict:
    """The handoff's two halves at the served geometry, on seeded bf16 rows:
    the export's copy of ``n_pages`` pages out of a ``[1, cache_len]`` row and
    the import's whole-page write into a pool of ``engine``'s shape, each
    timed with launch work (CUDA events) and on the device (the profiler's
    op times of 5 calls summed, a call), beside the bytes bound (each half
    reads and writes the pages once)."""
    import torch

    from unionml_tpu_torch import ContinuousBatcher
    from unionml_tpu_torch.models import init_cache, init_paged_cache

    g = torch.Generator(device="cuda").manual_seed(17)
    row = init_cache(cfg, 1, engine.cache_len, device="cuda")
    for layer in row:
        for buf in layer.values():
            buf.copy_(torch.randn(buf.shape, device="cuda", generator=g).to(buf.dtype))
    pool = init_paged_cache(cfg, engine.slots, engine.pool_blocks + 1, BLOCK, engine.max_blocks,
                            fill_block=engine.pool_blocks, device="cuda")
    tok, lengths = torch.zeros(engine.slots, dtype=torch.int32, device="cuda"), torch.ones(engine.slots, dtype=torch.int32, device="cuda")
    done = torch.ones(engine.slots, dtype=torch.bool, device="cuda")
    # the table row already on the card: a host copy would wait on the card and void the device-only time
    blocks_row = torch.full((engine.max_blocks,), engine.pool_blocks, dtype=torch.int32, device="cuda")
    blocks_row[:n_pages] = torch.arange(n_pages, dtype=torch.int32, device="cuda")
    tok0 = torch.zeros(1, dtype=torch.int32, device="cuda")
    row_len = torch.full((1,), n_pages * BLOCK, dtype=torch.int32, device="cuda")
    pages = ContinuousBatcher._export_pages_impl(row, n_pages, BLOCK)

    def export():
        ContinuousBatcher._export_pages_impl(row, n_pages, BLOCK)

    def import_():
        ContinuousBatcher._paged_page_admit_impl(pool, pages, tok, lengths, done, 0, tok0, row_len, blocks_row)

    calls = 5
    with torch.no_grad():
        export_ms, import_ms = time_ms(export, runs=20), time_ms(import_, runs=20)
        # device time: the profiler's kernel and copy times of `calls` calls of each half, summed, a call
        ops = {label: profiled(lambda: [fn() for _ in range(calls)])[1]
               for label, fn in (("export", export), ("import", import_))}
    moved = sum(t.numel() * t.element_size() for layer in pages for t in layer.values())
    out = dict(bytes=moved, export_ms=export_ms, import_ms=import_ms,
               export_device_ms=sum(ms for ms, _ in ops["export"].values()) / calls,
               import_device_ms=sum(ms for ms, _ in ops["import"].values()) / calls,
               device_ops={label: {name[:60]: n / calls for name, (_, n) in by.items()} for label, by in ops.items()},
               bound_ms=4 * moved / HBM_BYTES_PER_S * 1e3)
    del row, pool, pages
    torch.cuda.empty_cache()
    return out


def replica_phase(card: str, target, gcfg, prompts, slots: int, decode_chunk: int, bf16_streams,
                  profile: bool = False) -> dict:
    """Phase 14a-c: the in-process replica layer at full width, bf16, on
    ``target`` (phase 3's configuration and knobs, ``REPLICA_LAYERS`` deep)
    against ``bf16_streams``, one engine's streams of phase 3's prompts on
    it. (a) ``UNIONML_TPU_DP_REPLICAS=2`` through ``ContinuousBatcher(gen,
    ...)``: two mixed replicas on this card sharing the weights serve phase
    3's prompts twice, concurrently, token for token the reference's, both
    replicas serving, the paged launches exactly layers x 8 x the dispatches
    summed over the replicas,
    the memory grown by at most the two pools + 1 GiB; then one engine of
    ``2 * slots`` slots on the same 8 streams. (b) ``roles={"prefill": 1,
    "decode": 1}``, ``prefill_threshold=REPLICA_THRESHOLD``: the long prompts
    hand off, the short ones do not, streams the reference's; the handoff's bytes
    and its two halves timed. (c) (a)'s fleet with 8 streams in flight:
    ``scale_to(3)``, then ``scale_to(1)``, every stream whole and the reference's;
    then the autoscaler armed and the set closed (its thread joined).
    ``profile`` adds a torch.profiler breakdown of the fleet's wave and of
    the 8-slot engine's."""
    import os

    import torch

    from unionml_tpu_torch import ContinuousBatcher, Generator
    from unionml_tpu_torch.ops.paged_attention import paged_decode_attention
    from unionml_tpu_torch.serving import ReplicaSet

    mcfg = target.config
    gen = Generator(target, gcfg)
    wave, expected = list(prompts) * 2, list(bf16_streams) * 2

    def warm(engine):  # set-up of an engine's pool and first dispatch (not counted)
        for _ in engine.submit(prompts[0][:3], max_new_tokens=2):
            pass

    # ---- (a) two mixed replicas through the engine's constructor (the --dp-replicas export)
    mem0 = torch.cuda.memory_allocated()
    os.environ["UNIONML_TPU_DP_REPLICAS"] = "2"  # the serve CLI's --dp-replicas export
    try:
        fleet = ContinuousBatcher(gen, slots=slots, decode_chunk=decode_chunk, block_size=BLOCK)
    finally:
        del os.environ["UNIONML_TPU_DP_REPLICAS"]
    require(isinstance(fleet, ReplicaSet) and fleet.replicas == 2, f"the export built {type(fleet).__name__}")
    require(all(b.gen.model is target for b in fleet.batchers), "a replica on the card holds its own weights")
    for b in fleet.batchers:
        warm(b)
    before = [b.decode_dispatches for b in fleet.batchers]
    for counted in app_counted():
        counted.launches = 0
    streams, seconds, ttft, _ = serve_timed(fleet, wave)
    launches = paged_decode_attention.launches
    others = {c.__name__: c.launches for c in app_counted() if c is not paged_decode_attention}
    dispatches = [b.decode_dispatches - d for b, d in zip(fleet.batchers, before)]
    grown = torch.cuda.memory_allocated() - mem0
    pools = sum((b.pool_blocks + 1) * b._block_bytes for b in fleet.batchers)  # blocks and scratch
    want = mcfg.n_layers * sum(dispatches) * decode_chunk
    fleet_tok_s, fleet_ttft = len(wave) * MAX_NEW / seconds, statistics.median(ttft)
    one = ContinuousBatcher(gen, slots=2 * slots, decode_chunk=decode_chunk, block_size=BLOCK)
    warm(one)
    one_streams, one_seconds, one_ttft, _ = serve_timed(one, wave)
    if profile:
        profile_run("2 replicas on one card, 8 streams", lambda: serve(fleet, wave))
        profile_run(f"one engine of {2 * slots} slots, 8 streams", lambda: serve(one, wave))
    one.close()
    one_tok_s = len(wave) * MAX_NEW / one_seconds
    print(f"phase 14a: 2 mixed replicas on one card (UNIONML_TPU_DP_REPLICAS=2, weights shared), 8 streams x "
          f"{MAX_NEW}: {fleet_tok_s:.1f} tok/s aggregate, TTFT p50 {fleet_ttft:.1f} ms; one engine of "
          f"{2 * slots} slots on the same streams: {one_tok_s:.1f} tok/s, TTFT p50 {statistics.median(one_ttft):.1f} "
          f"ms (fleet / one engine {fleet_tok_s / one_tok_s:.3f}x); dispatches per replica {dispatches}, submitted "
          f"{fleet.stats()['scheduler']['submitted']}; paged launches {launches} (expected {mcfg.n_layers} x "
          f"{sum(dispatches)} x {decode_chunk} = {want}), other kernels {others}; memory grown "
          f"{grown / 2**30:.3f} GiB (limit: the two pools {pools / 2**30:.3f} GiB + 1 GiB); streams equal the reference's: "
          f"{streams == expected} (the 8-slot engine's, whose decode GEMMs have M = 8, first part from them at "
          f"{[first_divergence(a, b) for a, b in zip(one_streams, expected)]} of {MAX_NEW}); card {card}", flush=True)
    require(streams == expected, f"the fleet's streams differ from the reference's: first divergence "
                                 f"{[first_divergence(a, b) for a, b in zip(streams, expected)]}")
    require(all(len(s) == MAX_NEW for s in one_streams), f"8-slot stream lengths {[len(s) for s in one_streams]}")
    require(all(d > 0 for d in dispatches), f"a replica served no work: dispatches {dispatches}")
    require(launches == want > 0 and not any(others.values()), f"{launches} paged launches, expected {want}; {others}")
    require(grown <= pools + 2**30, f"the fleet grew memory by {grown} bytes, over {pools} + 1 GiB")
    replica_launches = launches

    # ---- (b) prefill=1,decode=1 with KV handoff
    handoffs = sum(len(p) >= REPLICA_THRESHOLD for p in prompts)
    split = ContinuousBatcher(gen, slots=slots, decode_chunk=decode_chunk, block_size=BLOCK,
                              roles={"prefill": 1, "decode": 1}, prefill_threshold=REPLICA_THRESHOLD)
    require(isinstance(split, ReplicaSet) and split.roles == ["prefill", "decode"], f"roles {split.roles}")
    for b in split.batchers:
        warm(b)
    before = [b.decode_dispatches for b in split.batchers]
    paged_decode_attention.launches = 0
    split_streams, split_seconds, split_first, gap = serve_timed(split, prompts)
    launches = paged_decode_attention.launches
    stats = split.stats()
    split.close()
    dispatches = [e["decode_dispatches"] - d for e, d in zip(stats["per_replica"], before)]
    want = mcfg.n_layers * sum(dispatches) * decode_chunk
    head_dim = mcfg.dim // mcfg.n_heads
    page_bytes = mcfg.n_layers * 2 * mcfg.n_kv_heads * BLOCK * head_dim * torch.empty((), dtype=mcfg.dtype).element_size()
    sizes = {len(p): -(-len(p) // BLOCK) * page_bytes for p in prompts if len(p) >= REPLICA_THRESHOLD}
    times = handoff_times(mcfg, split.batchers[1], -(-max(len(p) for p in prompts) // BLOCK))
    transfer = stats["per_replica"][1]["handoff"]["transfer_ms"]
    print(f"phase 14b: prefill=1,decode=1, prefill_threshold {REPLICA_THRESHOLD}: handoffs routed "
          f"{stats['handoffs']['routed']}, exported {stats['handoffs']['exported']}, imported "
          f"{stats['handoffs']['imported']} (expected {handoffs}: prompts of {[len(p) for p in prompts]} tokens); "
          f"handoff bytes by prompt length {({n: f'{b / 2**20:.1f} MiB' for n, b in sizes.items()})}; first item "
          f"{[round(x, 1) for x in split_first]} ms, first item to the next (through the import where handed off) "
          f"{[round(x, 1) if x is not None else None for x in gap]} ms; export to import p50 "
          f"{transfer.get('p50_ms')} ms; the 250-token handoff ({times['bytes'] / 2**20:.1f} MiB): export "
          f"{times['export_ms']:.4f} ms ({times['export_device_ms']:.4f} device only), import {times['import_ms']:.4f} "
          f"ms ({times['import_device_ms']:.4f}), bound {times['bound_ms']:.4f} ms (bytes), device ops "
          f"{times['device_ops']}; {len(prompts) * MAX_NEW / split_seconds:.1f} "
          f"tok/s; decode dispatches {dispatches}, paged launches {launches} (expected {want}); streams equal the "
          f"3's: {split_streams == list(bf16_streams)}; card {card}", flush=True)
    require(split_streams == list(bf16_streams), f"the role-split streams differ from the reference's: first divergence "
                                                 f"{[first_divergence(a, b) for a, b in zip(split_streams, bf16_streams)]}")
    require(stats["handoffs"]["routed"] == stats["handoffs"]["exported"] == stats["handoffs"]["imported"] == handoffs,
            f"handoffs {stats['handoffs']}, expected {handoffs}")
    require(stats["per_replica"][0]["handoff"]["exported"] == handoffs and dispatches[0] == 0,
            f"the prefill replica decoded or exported other than {handoffs}: {stats['per_replica'][0]['handoff']}")
    require(launches == want > 0, f"{launches} paged launches on the role-split fleet, expected {want}")
    replica_launches += launches

    # ---- (c) elasticity on (a)'s fleet with 8 streams in flight, then the autoscaler
    results = [None] * len(wave)

    def worker(i):
        results[i] = [int(t) for chunk in fleet.submit(wave[i]) for t in chunk]

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(wave))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    while sum(b.occupancy()[0] for b in fleet.batchers) == 0:
        require(time.perf_counter() - t0 < 120, "no stream of (c) became resident within 120 s")
        time.sleep(0.001)
    up = fleet.scale_to(3)
    t_up = time.perf_counter() - t0
    in_flight = sum(sum(b.occupancy()) for b in fleet.batchers)
    down = fleet.scale_to(1)
    t_down = time.perf_counter() - t0
    for t in threads:
        t.join(timeout=600)
    resize = fleet.stats()["resize"]
    fleet.configure_autoscaler(high=4.0, low=0.0, interval_s=0.05)
    time.sleep(0.25)  # a few evaluations of an idle fleet: no resize
    thread = fleet._autoscale_thread
    replicas_after = fleet.replicas
    fleet.close()
    print(f"phase 14c: 8 streams in flight on (a)'s fleet: scale_to(3) returned {up} at {t_up:.2f} s (the new replica "
          f"warmed before it joined; {in_flight} streams resident or waiting after), scale_to(1) returned {down} at "
          f"{t_down:.2f} s; stream lengths {[len(r) if r else 0 for r in results]}, equal the reference's: "
          f"{results == expected}; resize {resize}; autoscaler armed on the idle fleet: {replicas_after} replica, "
          f"its thread joined by close: {not thread.is_alive()}; card {card}", flush=True)
    require(up == 3 and down == 1 and results == expected, "a stream was lost or changed across the resize")
    # scale_to(1) from 3 removes two replicas: each removal counts
    require(resize["scaled_up"] == 1 and resize["scaled_down"] == 2, f"resize counters {resize}")
    require(replicas_after == 1 and not thread.is_alive(), "the autoscaler resized an idle fleet or outlived close")
    del gen, fleet, split, one
    torch.cuda.empty_cache()
    return dict(replica_launches=replica_launches, tok_s=fleet_tok_s, one_tok_s=one_tok_s, handoff=times)


def replica_parity_phase(gcfg, prompts, slots: int, decode_chunk: int) -> None:
    """Phase 14d: float32, TF32 off, 2 layers at Llama-3-8B width (phase 4's
    weights): (a)'s two mixed replicas and (b)'s prefill/decode split on the
    card serve the streams of the same fleets on the CPU, and the 250-token
    prompt's handoff pages agree card against CPU within ``HANDOFF_PAGE_REL`` of
    each leaf's largest value."""
    import torch

    from unionml_tpu_torch import ContinuousBatcher, Generator, Llama, LlamaConfig
    from unionml_tpu_torch.serving import ReplicaSet

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    cfg32 = LlamaConfig.llama3_8b(n_layers=2, attention_impl="flash", dtype=torch.float32, param_dtype=torch.float32)
    pcfg = dataclasses.replace(gcfg, max_new_tokens=REPLICA_PARITY_NEW, prompt_buckets=REPLICA_PARITY_BUCKETS)
    card_model = Llama(cfg32, seed=1)  # phase 4's weights
    cpu_model = Llama(cfg32, device="meta").to_empty(device="cpu")
    cpu_model.load_state_dict(card_model.state_dict())
    kw = dict(slots=slots, decode_chunk=decode_chunk, block_size=BLOCK)
    fleets = {"2 mixed replicas": {"replicas": 2}, "prefill=1,decode=1": {"roles": {"prefill": 1, "decode": 1},
                                                                          "prefill_threshold": REPLICA_THRESHOLD}}
    runs, pages = {}, []
    for model, device in ((card_model, None), (cpu_model, "cpu")):
        gen = Generator(model, pcfg, device=device)
        for label, extra in fleets.items():
            fleet = ReplicaSet.from_generator(gen, autoscale=False, **kw, **extra)
            runs.setdefault(label, []).append(serve(fleet, prompts)[0])
            stats = fleet.stats()
            fleet.close()
            if "roles" in extra:
                require(stats["handoffs"]["imported"] == sum(len(p) >= REPLICA_THRESHOLD for p in prompts),
                        f"{label} on {device or 'the card'}: handoffs {stats['handoffs']}")
        prefill = ContinuousBatcher._single(gen, role="prefill", **kw)
        stream = prefill.submit(max(prompts, key=len), export_handoff=True)
        first = [int(t) for chunk in stream for t in chunk]
        prefill.close()
        pages.append((first, stream.handoff))
    (card_first, card_payload), (cpu_first, cpu_payload) = pages
    leaves = []  # (layer, name, max |card - cpu|, max |cpu|)
    for i, (card_layer, cpu_layer) in enumerate(zip(card_payload["pages"], cpu_payload["pages"])):
        for name in card_layer:
            got, want = card_layer[name].cpu(), cpu_layer[name]
            leaves.append((i, name, (got - want).abs().max().item(), want.abs().max().item()))
    errs = [err for *_, err, _ in leaves]
    within = all(err <= HANDOFF_PAGE_REL * scale for *_, err, scale in leaves)
    same = {label: card == cpu for label, (card, cpu) in runs.items()}
    print(f"phase 14d, float32 (TF32 off), 2 layers, {len(prompts)} prompts x {REPLICA_PARITY_NEW} tokens: fleets on "
          f"the card equal the same fleets on the CPU: {same}; the {max(len(p) for p in prompts)}-token prompt's "
          f"handoff ({len(card_payload['pages'])} layers of {tuple(card_payload['pages'][0]['k'].shape)} pages): first "
          f"token card {card_first} CPU {cpu_first}, pages max_abs_err {max(errs):.3g} (TOLERANCE's f32 atol "
          f"{TOLERANCE['torch.float32'][0]}); per leaf (layer, name, max abs err, max |value|, err / max |value|) "
          f"{[(i, n, f'{e:.3g}', f'{m:.3g}', f'{e / m:.2e}') for i, n, e, m in leaves]} (limit {HANDOFF_PAGE_REL} "
          f"of max |value|) ({time.perf_counter() - t0:.1f} s)", flush=True)
    require(all(same.values()), f"a card fleet's streams differ from the CPU's: {runs}")
    require(card_first == cpu_first and card_payload["lengths"] == cpu_payload["lengths"] and within,
            f"the handoff payloads differ: first {card_first}/{cpu_first}, leaves {leaves}")
    del card_model, cpu_model
    torch.cuda.empty_cache()


#: phase 11: the serve CLI in its own process on the card
CLI_STARTUP_S = 600  # seconds a served app may take to load its artifact and warm up
#: (b)'s depth: Llama-3-8B width at 4 of its 32 layers, cut so that the whole script stays well inside its time
#: limit (the 32-layer artifact's save, load and eager decode waves took about 150 s of it; 8 layers until the
#: replay and remote phases joined, which phases 17b-c, 18b and 19b share)
CLI_LAYERS = 4
#: the child's POST /debug/profile capture lasts the first wave's time and this margin, so that it spans the
#: second wave (the 1 s head start included) after the profiler's start in the child, which has taken about 10 s
#: on the H100 machine (a 5 s margin once ended the capture 0.2 s before a wave that began 10.7 s after the
#: request); the phase requires that the wave ended inside it. The request carries a deadline past the capture
CLI_PROFILE_MARGIN_MS = 20000.0
#: the template's grammar prompt and what its stream must match (the template's GRAMMARS["word"])
TEMPLATE_PROMPT, TEMPLATE_REGEX = "@word the quick brown ", r"[a-z]+"
#: the app module phase 11b writes: phase 3's serving model (CLI_LAYERS deep) and engine behind a pandas-free
#: Dataset/Model; the artifact is the Llama's state dict, loaded into an uninitialized Llama (init without a seed)
CLI_APP_SOURCE = '''
from typing import List

import torch

from unionml_tpu_torch import ContinuousBatcher, Dataset, GenerationConfig, Generator, Llama, LlamaConfig, Model
from unionml_tpu_torch.serving import current_deadline

CONFIG = LlamaConfig.llama3_8b(n_layers={layers}, attention_impl="flash", dtype=torch.bfloat16,
                               param_dtype=torch.bfloat16)
GENERATION = GenerationConfig(prompt_buckets=(256,), max_new_tokens={max_new}, temperature=0.0)

dataset = Dataset(name="token_ids")
model = Model(name="llama3_8b_width", dataset=dataset)
model.__app_module__ = "llama_app:model"
engines = {{}}


@dataset.reader
def reader(n: int = 4) -> List[List[int]]:
    return [[1 + i] for i in range(n)]


@dataset.feature_loader
def feature_loader(raw) -> List[List[int]]:
    return [[int(t) for t in row] for row in raw]


@model.init
def init(hyperparameters: dict) -> Llama:
    return Llama(CONFIG, seed=hyperparameters.get("seed"))


def engine(module: Llama) -> ContinuousBatcher:
    """One engine an artifact; the serve CLI's --admit-chunk/--prefix-cache exports reach it."""
    if engines.get("module") is not module:
        engines["module"] = module
        engines["batcher"] = ContinuousBatcher(Generator(module, GENERATION), slots=4, decode_chunk=8,
                                               block_size=16)
        model.generation_batcher = engines["batcher"]
    return engines["batcher"]


def served(module: Llama):
    """The engine, or what the serve CLI put in its place (a multi-host fleet's coordinator)."""
    engine(module)
    return model.generation_batcher


@model.predictor
def predictor(module: Llama, features: List[List[int]]) -> List[List[int]]:
    streams = [served(module).submit(prompt) for prompt in features]
    return [[int(t) for chunk in stream for t in chunk] for stream in streams]


@model.stream_predictor
def stream_predictor(module: Llama, features: List[List[int]]):
    for chunk in served(module).submit(features[0], deadline=current_deadline()):
        yield [int(t) for t in chunk]


def warmup() -> None:
    engine(model.artifact.model_object).warmup()


model.generation_warmup = warmup
'''
#: phase 12: MoEConfig()'s widths; (b) cut to 2 layers (one dense, one routed) at capacity_factor = n_experts / k
MOE_PROMPT_SEED = 12
MOE_PARITY_LAYERS, MOE_NO_DROP_CAPACITY = 2, 4.0


def repo_root() -> str:
    import os

    return os.path.dirname(os.path.abspath(__file__))


def cli_env(**extra) -> dict:
    """The environment of a CLI child: this checkout on ``PYTHONPATH`` (the
    project directory is the child's working directory), nothing inherited
    that would point the app at another artifact."""
    import os

    env = {k: v for k, v in os.environ.items() if not k.startswith("UNIONML_")}
    env["PYTHONPATH"] = repo_root()
    env.update(extra)
    return env


def run_cli(args, cwd, timeout: float, **env) -> "subprocess.CompletedProcess":
    return subprocess.run([sys.executable, "-m", "unionml_tpu_torch.cli", *args], cwd=cwd, env=cli_env(**env),
                          capture_output=True, text=True, timeout=timeout)


def free_port() -> int:
    import socket

    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        return probe.getsockname()[1]


@contextlib.contextmanager
def cli_server(args, cwd, log_path: str, **env):
    """``python -m unionml_tpu_torch.cli serve ARGS`` on a free loopback
    port (``env`` added to the child's environment): polls ``/health`` until
    the app has loaded and warmed, yields (port, seconds to ready), then
    stops the child (SIGTERM, then kill)."""
    port = free_port()
    with open(log_path, "wb") as log:
        t0 = time.perf_counter()
        child = subprocess.Popen([sys.executable, "-m", "unionml_tpu_torch.cli", "serve", *args, "--port", str(port)],
                                 cwd=cwd, env=cli_env(**env), stdout=log, stderr=subprocess.STDOUT)
        try:
            while True:
                if child.poll() is not None:
                    raise AssertionError(f"the CLI server exited with {child.returncode}: " + tail(log_path))
                try:
                    status, _, _ = http_request(port, "GET", "/health")
                    if status == 200:
                        break
                except OSError:
                    pass
                if time.perf_counter() - t0 > CLI_STARTUP_S:
                    raise AssertionError(f"the CLI server was not up in {CLI_STARTUP_S} s: " + tail(log_path))
                time.sleep(0.5)
            yield port, time.perf_counter() - t0
        finally:
            child.terminate()
            try:
                child.wait(timeout=60)
            except subprocess.TimeoutExpired:
                child.kill()
                child.wait()


def tail(path: str, size: int = 3000) -> str:
    with open(path, "rb") as handle:
        return handle.read()[-size:].decode(errors="replace")


def stream_http(port: int, features, ttft: list = None) -> list:
    """One ``/predict-stream`` request: the ND-JSON lines' items, in order."""
    status, headers, body = http_request(port, "POST", "/predict-stream", {"features": features}, first_chunk=ttft)
    require(status == 200, f"/predict-stream answered {status}: {body[:300]!r}")
    return [item for line in body.decode().splitlines() if line for item in json.loads(line)]


def paged_kernel_events(trace_dir: str) -> tuple:
    """(launches of the paged decode kernel, device ms of every kernel, the
    capture's wall ms) in the Chrome traces a ``POST /debug/profile`` wrote."""
    import glob

    launches, kernel_us, span = 0, 0.0, 0.0
    for path in glob.glob(f"{trace_dir}/*.trace.json"):
        with open(path) as handle:
            events = json.load(handle).get("traceEvents", [])
        stamps = [e["ts"] for e in events if "ts" in e and e.get("ph") == "X"]
        span += (max(stamps) - min(stamps)) if stamps else 0.0
        for event in events:
            if event.get("cat") == "kernel":
                kernel_us += float(event.get("dur", 0.0))
                launches += "paged_decode_kernel" in event.get("name", "")
    return launches, kernel_us / 1e3, span / 1e3


def llama_cli_phase(card: str, prompts, workdir: str) -> dict:
    """Phase 11b: the CLI's main path at Llama-3-8B width, CLI_LAYERS deep.
    The phase writes an app module (``CLI_APP_SOURCE``), saves the seeded
    bf16 weights once as its artifact, and serves that artifact twice with chunked
    admission (``ADMIT_CHUNK``) and the radix prefix cache: in this process
    through ``Model.serve()`` (the env exports the CLI would make) and through
    ``python -m unionml_tpu_torch.cli serve ... --admit-chunk 64
    --prefix-cache --profile-dir`` (the eager route). Phase 3's prompts stream concurrently
    over ``/predict-stream`` to both, and the answers must be equal. The
    child's paged kernel launches are read from a ``POST /debug/profile``
    capture spanning its streams."""
    import os
    import shutil

    import torch

    from unionml_tpu_torch import Llama, LlamaConfig
    from unionml_tpu_torch.artifact import ModelArtifact
    from unionml_tpu_torch.ops.paged_attention import paged_decode_attention

    with open(os.path.join(workdir, "llama_app.py"), "w") as handle:
        handle.write(CLI_APP_SOURCE.format(max_new=MAX_NEW, layers=CLI_LAYERS))
    sys.path.insert(0, workdir)
    import llama_app

    artifact = os.path.join(workdir, "llama3_8b_width.pt")
    t0 = time.perf_counter()
    module = Llama(LlamaConfig.llama3_8b(n_layers=CLI_LAYERS, attention_impl="flash", dtype=torch.bfloat16,
                                         param_dtype=torch.bfloat16), seed=0)
    llama_app.model.artifact = ModelArtifact(module, {})
    llama_app.model.save(artifact)
    del module
    llama_app.model.artifact = None
    torch.cuda.empty_cache()
    save_s = time.perf_counter() - t0
    size = os.path.getsize(artifact)

    # ---- in process: Model.serve() on the same artifact, the same admission and prefix-cache settings
    exports = {"UNIONML_TPU_ADMIT_CHUNK": str(ADMIT_CHUNK), "UNIONML_TPU_PREFIX_CACHE": "1"}
    os.environ.update(exports)
    try:
        t0 = time.perf_counter()
        llama_app.model.load(artifact)
        app = llama_app.model.serve()
        app.startup()
        ready_s = time.perf_counter() - t0
        engine = llama_app.model.generation_batcher
        require(engine.admit_chunk == ADMIT_CHUNK and engine._radix is not None,
                "the in-process engine did not take the admission and prefix-cache exports")
        with served_in_thread(app) as port:
            paged_decode_attention.launches = 0
            ttft_in: list = []
            inproc, inproc_s = concurrent([functools.partial(stream_http, port, [p], ttft_in) for p in prompts])
            in_launches = paged_decode_attention.launches
    finally:
        for name in exports:
            os.environ.pop(name, None)
    del app, engine
    llama_app.engines.clear()
    llama_app.model.artifact = None
    llama_app.model.generation_batcher = None
    torch.cuda.empty_cache()
    require(all(len(s) == MAX_NEW for s in inproc), f"in-process stream lengths {[len(s) for s in inproc]}")

    # ---- the CLI's own process: a timed wave, then a wave under the child's own profiler (radix hits now)
    profile_dir = os.path.join(workdir, "cli_profile")
    args = ["llama_app:model", "--model-path", artifact, "--admit-chunk", str(ADMIT_CHUNK), "--prefix-cache"]
    with cli_server(args + ["--profile-dir", profile_dir], workdir, os.path.join(workdir, "llama_server.log")) as (
            port, cli_ready_s):
        ttft_cli: list = []
        served, cli_s = concurrent([functools.partial(stream_http, port, [p], ttft_cli) for p in prompts])
        generation = json.loads(http_request(port, "GET", "/metrics")[2])["generation"]
        captured: dict = {}
        capture_ms = cli_s * 1e3 + CLI_PROFILE_MARGIN_MS

        def capture():  # a request that lasts the capture: its deadline (the server's default is 30 s) outlasts it
            captured["response"] = http_request(port, "POST", "/debug/profile", {"duration_ms": capture_ms},
                                                {"X-Request-Deadline-Ms": str(capture_ms + 60_000)})

        profiler = threading.Thread(target=capture)
        sent = time.perf_counter()
        profiler.start()
        time.sleep(1.0)  # the capture starts before the second wave
        # the server's loop answers a second capture request only after the first one's profiler.start() returned,
        # and then with 409: so a 409 here means the capture is on before the wave is sent
        probe = http_request(port, "POST", "/debug/profile", {"duration_ms": 1.0})
        require(probe[0] == 409, f"the capture had not started before the profiled wave: {probe[0]} {probe[2][:200]!r}")
        profiled_wave, profiled_s = concurrent([functools.partial(stream_http, port, [p]) for p in prompts])
        wave_end_s = time.perf_counter() - sent
        profiler.join(timeout=capture_ms / 1e3 + 120)
        after = json.loads(http_request(port, "GET", "/metrics")[2])["generation"]
    status = captured.get("response", (None, None, b""))
    require(status[0] == 200, f"POST /debug/profile answered {status[0]}: {status[2][:300]!r}")
    cli_launches, kernel_ms, window_ms = paged_kernel_events(profile_dir)
    shutil.rmtree(profile_dir, ignore_errors=True)
    profiled_dispatches = after["decode_dispatches"] - generation["decode_dispatches"]
    expected = CLI_LAYERS * profiled_dispatches * 8
    prefill = after.get("prefill", {})
    require(profiled_wave == served, "the profiled wave's streams (radix hits) differ from the first wave's")
    print(f"phase 11b: Llama-3-8B width bf16 artifact at {CLI_LAYERS} layers saved once ({size / 2**30:.1f} GiB in "
          f"{save_s:.1f} s); "
          f"in-process Model.serve() ready in {ready_s:.1f} s, 4 /predict-stream streams x {MAX_NEW} tokens "
          f"{len(prompts) * MAX_NEW / inproc_s:.1f} tok/s, time to first chunk p50 "
          f"{statistics.median(ttft_in) * 1e3:.1f} ms, {in_launches} paged launches; `python -m "
          f"unionml_tpu_torch.cli serve llama_app:model --admit-chunk {ADMIT_CHUNK} --prefix-cache` ready in "
          f"{cli_ready_s:.1f} s, {len(prompts) * MAX_NEW / cli_s:.1f} tok/s, time to first chunk p50 "
          f"{statistics.median(ttft_cli) * 1e3:.1f} ms; /metrics after it: {generation['decode_dispatches']} decode "
          f"dispatches, TTFT p50 {generation['ttft_ms'].get('p50_ms')} ms, TBT p50 "
          f"{generation['tbt_ms'].get('p50_ms')} ms; streams equal the in-process answers: {served == inproc} "
          f"(first divergence {[first_divergence(a, b) for a, b in zip(served, inproc)]}); a second wave under the "
          f"child's profiler {len(prompts) * MAX_NEW / profiled_s:.1f} tok/s, prefill after both {prefill}, its "
          f"profile ({window_ms:.0f} ms traced, kernels busy {kernel_ms:.1f} ms, the device's idle share "
          f"{1 - kernel_ms / (profiled_s * 1e3):.3f} over the wave's {profiled_s:.1f} s): {cli_launches} paged "
          f"launches (the wave's {profiled_dispatches} dispatches give {CLI_LAYERS} x {profiled_dispatches} x 8 = {expected}); "
          f"card {card}", flush=True)
    require(served == inproc, "the CLI's streams differ from the in-process Model.serve() answers")
    require(wave_end_s * 1e3 < capture_ms and status[2] and json.loads(status[2])["duration_ms"] == capture_ms,
            f"the profiled wave ended {wave_end_s:.1f} s after the capture was asked for, past its "
            f"{capture_ms / 1e3:.1f} s")
    require(cli_launches == expected > 0, f"{cli_launches} paged launches in the CLI child's profile, "
            f"expected {expected}")
    require(prefill.get("chunks", 0) > 0, f"the CLI's engine admitted no chunk: {prefill}")
    sys.path.remove(workdir)
    # the artifact stays for phase 17b-c (the caller's workdir goes with it)
    return dict(cli_launches=cli_launches, in_process_launches=in_launches,
                cli_tok_s=len(prompts) * MAX_NEW / cli_s, in_process_tok_s=len(prompts) * MAX_NEW / inproc_s,
                artifact=artifact, inproc_streams=inproc, args=args, ready_s=cli_ready_s, wave_s=cli_s)


#: the premise of TPU001's captured-program reading: a host read inside a program an AOTFunction captures
LINT_PREMISE_SOURCE = """import torch

from unionml_tpu_torch.serving.aot import AOTFunction, ProgramStore


def scaled(x):
    total = x.sum().item()
    return x * total


def wrapped(root):
    return AOTFunction(scaled, "scaled", ProgramStore(root), {})
"""
LINT_PREMISE_LINE = 7


def lint_phase(card: str, workdir: str) -> dict:
    """Phase 11c: the static analyzer. The CLI child ``python -m
    unionml_tpu_torch.cli lint unionml_tpu_torch --format json``, from this
    checkout's root (no ``.git``, so no ``--changed-only``), must exit 0
    with no finding over at least 80 files; a child starts cold, so the warm
    run is an in-process pair (``run_lint`` after ``clear_index_cache``,
    then again: nothing re-parsed), run while the child runs (each on a
    core of its own). Then TPU001's premise on the card: an
    ``AOTFunction`` over a three-line function that calls ``.item()`` on a
    CUDA tensor fails its capture with the store's ``RuntimeError``, and the
    analyzer flags that line."""
    import importlib.util
    import os
    import tempfile

    import torch

    from unionml_tpu_torch.analysis import clear_index_cache, run_lint

    started = time.perf_counter()
    child: dict = {}

    def lint_child() -> None:
        child["run"] = run_cli(["lint", "unionml_tpu_torch", "--format", "json"], repo_root(), 300)
        child["s"] = time.perf_counter() - started

    runner = threading.Thread(target=lint_child)
    runner.start()
    here = os.getcwd()
    os.chdir(repo_root())
    try:
        clear_index_cache()
        t0 = time.perf_counter()
        cold = run_lint(["unionml_tpu_torch"])
        cold_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        warm = run_lint(["unionml_tpu_torch"])
        warm_s = time.perf_counter() - t0
    finally:
        os.chdir(here)
    runner.join()
    run, child_s = child["run"], child["s"]
    report = json.loads(run.stdout) if run.stdout.strip().startswith("{") else {}
    print(f"phase 11c: `python -m unionml_tpu_torch.cli lint unionml_tpu_torch --format json` exited "
          f"{run.returncode} in {child_s:.2f} s (a cold process): {len(report.get('findings', []))} findings, "
          f"{len(report.get('suppressed', []))} suppressed, {report.get('files')} files", flush=True)
    print(f"phase 11c: run_lint in process, beside the child: cold {cold_s:.2f} s ({cold.index_stats}), warm "
          f"{warm_s:.2f} s ({warm.index_stats}), {cold.files} files, clean {cold.clean and warm.clean}", flush=True)
    require(run.returncode == 0 and report.get("findings") == [] and report.get("files", 0) >= 80,
            f"the lint child: exit {run.returncode}, {run.stdout[-500:]!r} {run.stderr[-500:]!r}")
    require(cold.clean and warm.clean and warm.index_stats["misses"] == 0, "the in-process lint runs")
    lint_s = time.perf_counter() - started

    premise = os.path.join(workdir, "lint_premise.py")
    with open(premise, "w") as handle:
        handle.write(LINT_PREMISE_SOURCE)
    spec = importlib.util.spec_from_file_location("lint_premise", premise)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    t0 = time.perf_counter()
    refused = None
    try:
        module.wrapped(tempfile.mkdtemp(dir=workdir))(torch.ones(4, device="cuda"))
    except RuntimeError as exc:
        refused = exc
    torch.cuda.synchronize()
    premise_s = time.perf_counter() - t0
    flagged = [f for f in run_lint([premise]).findings if f.rule == "TPU001"]
    cause = getattr(refused, "__cause__", None)
    print(f"phase 11c: AOTFunction over lint_premise.py's scaled() (.item() at line {LINT_PREMISE_LINE}) on the "
          f"card: {type(refused).__name__}: {str(refused)[:120]!r} (from {type(cause).__name__}: "
          f"{str(cause)[:160]!r}) in {premise_s:.2f} s; the analyzer: {[f.render() for f in flagged]}", flush=True)
    require(refused is not None and "CUDA graph capture of AOT program 'scaled' failed" in str(refused),
            f"the capture of a host read did not fail with the store's error: {refused!r}")
    require([f.line for f in flagged] == [LINT_PREMISE_LINE], f"TPU001 flagged {[f.render() for f in flagged]}")
    seconds = lint_s + premise_s
    print(f"phase 11c took {seconds:.1f} s; card {card}", flush=True)
    return dict(child_s=child_s, cold_s=cold_s, warm_s=warm_s, files=report.get("files"), seconds=seconds)


def moe_prompts(vocab: int) -> list:
    import numpy as np

    rng = np.random.RandomState(MOE_PROMPT_SEED)
    return [rng.randint(1, vocab, size=n).tolist() for n in PROMPT_LENS]


def moe_serving_phase(card: str, gcfg, slots: int, decode_chunk: int) -> dict:
    """Phase 12a: ``MoEConfig()`` as the JAX package defines it (8 layers,
    every second routed over 8 experts, k = 2, capacity_factor 1.25) in
    bf16 parameters, seeded on the card, serving 4 prompts x 32 tokens
    through a paged ``ContinuousBatcher``. MoE reaches no port kernel (its
    attention takes the plain routes, as in JAX): every kernel's launches
    in the run are counted and must be 0."""
    import torch

    from unionml_tpu_torch import ContinuousBatcher, Generator
    from unionml_tpu_torch.models import MoEConfig, MoETransformer

    t0 = time.perf_counter()
    cfg = MoEConfig(param_dtype=torch.bfloat16)
    model = MoETransformer(cfg, seed=0)
    torch.cuda.synchronize()
    held = sum(t.numel() * t.element_size() for t in model.parameters())
    print(f"phase 12a: MoEConfig() (vocab {cfg.vocab_size}, dim {cfg.dim}, {cfg.n_layers} layers, every "
          f"{cfg.moe_every}nd routed over {cfg.n_experts} experts of hidden {cfg.hidden_dim}, k {cfg.k}, capacity "
          f"factor {cfg.capacity_factor}), bf16 parameters, seed 0: built in {time.perf_counter() - t0:.1f} s, "
          f"{held / 2**30:.1f} GiB", flush=True)
    prompts = moe_prompts(cfg.vocab_size)
    gen = Generator(model, gcfg)
    warm = ContinuousBatcher(gen, slots=slots, decode_chunk=decode_chunk, block_size=BLOCK)
    serve(warm, [prompts[0][:3]])  # set-up: first cuBLAS/allocator calls
    warm.close()
    batcher = ContinuousBatcher(gen, slots=slots, decode_chunk=decode_chunk, block_size=BLOCK)
    reset_counts()
    streams, seconds = serve(batcher, prompts)
    launches = all_launches()
    stats = batcher.stats()
    batcher.close()
    aux = [round(float(m.aux_loss), 4) for m in model.modules() if hasattr(m, "aux_loss") and m.aux_loss is not None]
    tok_s = len(prompts) * MAX_NEW / seconds
    print(f"phase 12a: served 4 streams x {MAX_NEW} tokens: {tok_s:.1f} tok/s aggregate, TTFT p50 "
          f"{stats['ttft_ms']['p50_ms']} ms max {stats['ttft_ms']['max_ms']} ms, TBT p50 {stats['tbt_ms']['p50_ms']} ms "
          f"(a dispatch of {decode_chunk} steps), {stats['decode_dispatches']} dispatches; routed layers' last aux "
          f"losses {aux}; port kernel launches {launches} (MoE reaches none, as in JAX); card {card}", flush=True)
    require(all(len(s) == MAX_NEW for s in streams), f"stream lengths {[len(s) for s in streams]}")
    require(all(0 <= t < cfg.vocab_size for s in streams for t in s), "a token id outside the vocabulary")
    require(not any(launches.values()), f"a port kernel launched on the MoE path: {launches}")
    del model, gen, warm, batcher
    torch.cuda.empty_cache()
    return dict(moe_launches=launches, tok_s=tok_s, ttft_p50=stats["ttft_ms"]["p50_ms"],
                tbt_p50=stats["tbt_ms"]["p50_ms"])


def moe_parity_phase(gcfg, slots: int, decode_chunk: int) -> None:
    """Phase 12b: float32, TF32 off, ``MoEConfig()``'s widths cut to 2
    layers (one dense, one routed) at ``capacity_factor = n_experts / k``,
    where no token is dropped, so routing is per token: the engine's
    streams, paged and dense, equal the solo ``Generator``'s; a speculative
    engine with a 1-layer draft (the 1B-shaped draft's widths over the MoE
    vocabulary) equals the solo target; and under ``quantize="int8"`` (the
    expert stacks in int8, dequantized as in JAX) the engine equals the
    plain int8 ``Generator``."""
    import torch

    from unionml_tpu_torch import ContinuousBatcher, DraftSpec, Generator, Llama
    from unionml_tpu_torch.models import MoEConfig, MoETransformer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    cfg = MoEConfig(n_layers=MOE_PARITY_LAYERS, capacity_factor=MOE_NO_DROP_CAPACITY, dtype=torch.float32,
                    param_dtype=torch.float32)
    model = MoETransformer(cfg, seed=1)
    prompts = moe_prompts(cfg.vocab_size)
    solo = Generator(model, gcfg)
    want = [solo([p])[0].tolist() for p in prompts]
    results = {}
    for name, kw in (("paged", dict(block_size=BLOCK)), ("dense", {})):
        engine = ContinuousBatcher(solo, slots=slots, decode_chunk=decode_chunk, **kw)
        results[name] = serve(engine, prompts)[0] == want
        engine.close()
    draft = Llama(draft_config(torch.float32, n_layers=1, vocab_size=cfg.vocab_size), seed=DRAFT_SEED)
    spec = Generator(model, dataclasses.replace(gcfg, draft=DraftSpec(module=draft, gamma=GAMMA)))
    engine = ContinuousBatcher(spec, slots=slots, decode_chunk=decode_chunk, block_size=BLOCK)
    results["speculative, 1-layer draft"] = serve(engine, prompts)[0] == want
    engine.close()
    del draft, spec, engine
    int8 = Generator(model, gcfg, quantize="int8")  # quantizes the model in place: the last use of it
    slot = model.layer_1.moe.experts.wi.kernel
    want8 = [int8([p])[0].tolist() for p in prompts]
    engine = ContinuousBatcher(int8, slots=slots, decode_chunk=decode_chunk, block_size=BLOCK)
    results["int8, paged"] = serve(engine, prompts)[0] == want8
    engine.close()
    print(f"phase 12b, float32 (TF32 off), {MOE_PARITY_LAYERS} layers (one dense, one routed), capacity factor "
          f"{MOE_NO_DROP_CAPACITY}: engine streams equal the solo Generator's: {results}; int8 expert stack "
          f"{tuple(slot.q.shape)} with scales {tuple(slot.scale.shape)}, router "
          f"{type(model.layer_1.moe.router.kernel).__name__} {model.layer_1.moe.router.kernel.dtype}; int8 streams "
          f"against the float ones: first divergence {[first_divergence(a, b) for a, b in zip(want8, want)]} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    require(all(results.values()), f"phase 12b parity {results}")
    require(slot.q.dtype == torch.int8 and tuple(slot.scale.shape) == (cfg.n_experts, 1, cfg.hidden_dim)
            and model.layer_1.moe.router.kernel.dtype == torch.float32, "the int8 expert slots")
    del model, solo, int8, engine
    torch.cuda.empty_cache()


#: phase 13: the encoder models at their published widths, random weights from a seed, bf16 compute, f32 params.
#: (a) BERT-base fine-tuned on SST-2-shaped batches: numpy seed 0, lengths 8-128 (mask 1 = a real token, pad id 0)
BERT_BATCH, BERT_SEQ, BERT_STEPS, BERT_MIN_LEN, BERT_LR = 32, 128, 8, 8, 2e-5
#: (b) a stack of BertConfig.base()'s 12 encoder blocks through the flash kernels, unmasked, B x L; each route's
#: step timed in turns, ENC_TIMED_STEPS runs a turn
ENC_FLASH_BATCH, ENC_FLASH_SEQ, ENC_TIMED_STEPS = 8, 512, 5
#: phase 2 holds both kernels alone at this shape (ENCODER_FLASH_CASE), every output element for element; the
#: 12-layer bf16 stack cannot be held element for element to that single-kernel tolerance (FLASH_TOLERANCE):
#: both routes round every matmul, norm and activation output to 8 significant bits over 12 layers, in other
#: orders, and the residual stream's elements reach ~14 while many lie near 0 (a CPU run of the twins at L = 256:
#: 8-14 % of the elements beyond it, each route's relative RMS error against an f32 run 0.009-0.012, equal to
#: 3 digits). So the two routes are held on the tensor's relative RMS difference, within phase 2's bf16 relative
#: tolerance, and the kernel route's error against an f32-compute run of the same weights may be at most
#: ENC_FLASH_ERR_RATIO times the plain route's (the kernels are no less accurate than the plain route)
ENC_FLASH_REL_RMS = FLASH_TOLERANCE["torch.bfloat16"][1]
ENC_FLASH_ERR_RATIO = 1.25
#: (c) ViT-L/16 at 224: inference at B = 64, then 6 steps of fit at B = 32 on numpy seed 1 images
VIT_INFER_BATCH, VIT_INFER_RUNS, VIT_BATCH, VIT_STEPS, VIT_LR = 64, 5, 32, 6, 1e-4
#: (d) MLPConfig() (BASELINE.json config 2) through Model.train on MNIST-shaped rows: 60,000 train, 10,000 test,
#: 784 inputs, labels of a fixed random linear teacher (numpy seed 4), one epoch at B = 128
MLP_TRAIN_ROWS, MLP_TEST_ROWS, MLP_INPUTS, MLP_BATCH, MLP_SEED = 60_000, 10_000, 784, 128, 4
#: (e) float32, TF32 off, card against the port on the CPU: 2-layer BERT-base and ViT-L, the MLP. Forwards within
#: ENC_CPU_TOL (atol and rtol: both sides sum f32 products in other orders over widths of 768-4096); 2 steps of
#: fit (Adam, ENC_CPU_LR): losses within ENC_CPU_LOSS_REL, parameters within 1e-6 on the mean difference, at most
#: 1e-4 of the entries beyond 1e-5, none beyond 2 * lr * steps (Adam's step is lr * m / (sqrt(v) + 1e-8), so a
#: gradient near 1e-8 carries both sides' rounding into a sizable part of a step: the rule of the CPU tests)
ENC_PARITY_LAYERS, ENC_CPU_TOL, ENC_CPU_LOSS_REL, ENC_CPU_LR, ENC_CPU_STEPS = 2, 1e-4, 1e-5, 1e-3, 2


def sst2_batches(vocab: int, rows: int, seed: int = 0) -> list:
    """SST-2-shaped fine-tuning data: ``[tokens, attention_mask, labels]``,
    lengths uniform in BERT_MIN_LEN..BERT_SEQ, a [CLS]-like id first, pad id
    0 after each row's length, 2 classes."""
    import numpy as np

    rng = np.random.RandomState(seed)
    lengths = rng.randint(BERT_MIN_LEN, BERT_SEQ + 1, size=rows)
    mask = (np.arange(BERT_SEQ)[None, :] < lengths[:, None]).astype(np.int64)
    tokens = rng.randint(1000, vocab, size=(rows, BERT_SEQ)).astype(np.int64) * mask
    tokens[:, 0] = 101
    labels = rng.randint(0, 2, size=rows).astype(np.int64)
    return [tokens, mask, labels]


def encoder_matmul_params(model) -> int:
    return sum(p.numel() for n, p in model.named_parameters() if n.endswith(".kernel"))


def bert_phase(card: str, profile: bool) -> dict:
    """Phase 13a: ``BertConfig.base()`` fine-tuned for BERT_STEPS steps of
    ``fit`` with ``classification_loss`` on masked SST-2-shaped batches (the
    plain attention route: a masked call never takes the kernels, as in
    JAX). Every port kernel's launches are counted and must be 0."""
    import numpy as np
    import torch

    from unionml_tpu_torch import TrainerConfig, TrainState, fit, make_train_step
    from unionml_tpu_torch.models import BertConfig, BertEncoder, classification_loss

    cfg = BertConfig.base()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # what earlier phases still hold
    t0 = time.perf_counter()
    model = BertEncoder(cfg, seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    data = sst2_batches(cfg.vocab_size, BERT_BATCH * BERT_STEPS)
    state = TrainState(model, torch.optim.Adam(model.parameters(), lr=BERT_LR))
    step = make_train_step(classification_loss, has_aux=True)
    reset_counts()
    t0 = time.perf_counter()
    result = fit(state, step, data, TrainerConfig(epochs=1, batch_size=BERT_BATCH, shuffle=True, log_every_steps=1))
    seconds = time.perf_counter() - t0
    launches = all_launches()
    losses = [h["loss"] for h in result.history]
    accuracy = [h["accuracy"] for h in result.history]
    sps = result.samples_per_sec
    n_params = sum(p.numel() for p in model.parameters())
    matmul = encoder_matmul_params(model)
    # 6 * N * T for the dense layers (forward, input and weight gradients) plus the 6 attention products
    # (2 forward, 4 backward) of 2 * B * L^2 * dim multiply-adds per layer, over the whole (padded) length
    tokens = BERT_BATCH * BERT_SEQ
    flops = 6 * matmul * tokens + 6 * 2 * BERT_BATCH * BERT_SEQ ** 2 * cfg.dim * cfg.n_layers
    print(f"phase 13a: BERT-base (vocab {cfg.vocab_size}, {cfg.n_layers} x {cfg.dim}, {cfg.n_heads} heads, FFN "
          f"{cfg.hidden_dim}; {n_params} parameters, f32, bf16 compute, seed 0, built in {build_s:.1f} s) fine-tuned "
          f"{result.steps} steps of B={BERT_BATCH} x L={BERT_SEQ} (masked, lengths {BERT_MIN_LEN}-{BERT_SEQ}, Adam lr "
          f"{BERT_LR}) in {seconds:.1f} s (first step {result.compile_time_s:.2f} s): {sps:.1f} samples/s over steps "
          f"2-{BERT_STEPS}, {sps * BERT_SEQ:.0f} tokens/s, "
          f"{1e3 * BERT_BATCH / sps if sps else float('nan'):.1f} ms/step, "
          f"{flops * sps / BERT_BATCH / 1e12:.1f} TFLOP/s achieved ({flops / 1e12:.3f} TFLOP a step); peak memory "
          f"{(torch.cuda.max_memory_allocated() - held) / 2**30:.2f} GiB above the {held / 2**30:.2f} GiB held before; "
          f"losses {losses}; accuracy {accuracy}; port kernel "
          f"launches {launches} (the plain route, as in JAX: all 0); card {card}", flush=True)
    require(result.steps == BERT_STEPS and all(math.isfinite(x) for x in losses), f"BERT losses {losses}")
    require(not any(launches.values()), f"a port kernel launched on the masked BERT path: {launches}")
    if profile:
        batch = tuple(torch.from_numpy(a[:BERT_BATCH]).cuda() for a in data)
        profile_run("one BERT-base fine-tune step", lambda: step(state, batch))
    del model, state, result
    torch.cuda.empty_cache()
    return dict(launches=launches, samples_per_s=sps)


def encoder_stack(impl: str, dtype, seed: int = None, layers: int = None):
    """``BertConfig.base()``'s encoder blocks as a ``Sequential`` on the card."""
    import torch

    from unionml_tpu_torch.models import BertConfig
    from unionml_tpu_torch.models.layers import TransformerBlock, init_weights

    cfg = BertConfig.base()
    stack = torch.nn.Sequential(*[
        TransformerBlock(cfg.dim, cfg.n_heads, cfg.hidden_dim, decoder=False, attention_impl=impl, dtype=dtype,
                         device="cuda")
        for _ in range(layers or cfg.n_layers)])
    if seed is not None:
        init_weights(stack, torch.Generator(device="cuda").manual_seed(seed))
    return stack


def device_busy_ms(fn) -> float:
    """The device time of one call of ``fn`` (after one unprofiled call), as
    ``profiled`` sums it."""
    import torch

    fn()
    torch.cuda.synchronize()
    busy_ms = sum(total for total, _ in profiled(fn)[1].values())
    require(busy_ms > 0, "the profiler recorded no device time")
    return busy_ms


def stack_step(stack, x, dy) -> tuple:
    """One forward and backward of ``stack`` on ``x``: (output, input gradient)."""
    inp = x.detach().clone().requires_grad_()
    out = stack(inp)
    out.backward(dy)
    return out.detach(), inp.grad


def rel_rms(a, b) -> float:
    return ((a.float() - b.float()).pow(2).mean().sqrt() / b.float().pow(2).mean().sqrt()).item()


def encoder_flash_phase(card: str) -> dict:
    """Phase 13b: the kernels on the encoder path. 12 encoder blocks at
    BERT-base width with ``attention_impl="flash"`` run a forward and a
    backward on unmasked bf16 ``[8, 512, 768]`` inputs: each step launches
    the bf16 forward and the fused backward once a layer (non-causal, D =
    64). The output and the input gradient are held to the same weights on
    the plain route, and both routes to an f32-compute run; each route's
    step is timed in turns."""
    import torch

    from unionml_tpu_torch.models import BertConfig

    cfg = BertConfig.base()
    flash = encoder_stack("flash", torch.bfloat16, seed=3)
    plain = encoder_stack("xla", torch.bfloat16)
    plain.load_state_dict(flash.state_dict())
    g = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn(ENC_FLASH_BATCH, ENC_FLASH_SEQ, cfg.dim, device="cuda", generator=g).to(torch.bfloat16)
    dy = torch.randn(ENC_FLASH_BATCH, ENC_FLASH_SEQ, cfg.dim, device="cuda", generator=g).to(torch.bfloat16)
    reset_counts()
    got = stack_step(flash, x, dy)
    torch.cuda.synchronize()
    launches = all_launches()
    want = stack_step(plain, x, dy)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    exact = encoder_stack("xla", torch.float32)
    exact.load_state_dict(flash.state_dict())
    ref = stack_step(exact, x.float(), dy.float())
    del exact
    torch.backends.cuda.matmul.allow_tf32 = tf32
    atol, rtol = FLASH_TOLERANCE["torch.bfloat16"]
    report, ok = [], True
    for what, a, b, r in (("out", got[0], want[0], ref[0]), ("dx", got[1], want[1], ref[1])):
        err = (a.float() - b.float()).abs()
        beyond = (err > atol + rtol * b.float().abs()).float().mean().item()
        between, kernel_err, plain_err = rel_rms(a, b), rel_rms(a, r), rel_rms(b, r)
        ok &= between <= ENC_FLASH_REL_RMS and kernel_err <= ENC_FLASH_ERR_RATIO * plain_err
        report.append(f"{what}: max_abs_err {err.max().item():.4g} (max |plain| {b.float().abs().max().item():.4g}; "
                      f"{beyond:.2%} of elements beyond phase 2's atol={atol} rtol={rtol}), relative RMS difference "
                      f"{between:.4g} (limit {ENC_FLASH_REL_RMS}), against f32 compute: kernel {kernel_err:.4g}, "
                      f"plain {plain_err:.4g} (limit {ENC_FLASH_ERR_RATIO}x plain)")
    worst = max((got[i].float() - want[i].float()).abs().max().item() for i in range(2))

    # each route's step timed twice, in turns (kernel, plain, plain, kernel), with the host's launch work; then
    # its device time: the kernels, copies and fills of one step under torch.profiler (device_ms's spin does not
    # fit a step of more launches than the card's launch queue holds)
    turns = {"flash": [], "plain": []}
    for route in ("flash", "plain", "plain", "flash"):
        turns[route].append(time_ms(functools.partial(stack_step, flash if route == "flash" else plain, x, dy),
                                    ENC_TIMED_STEPS))
    flash_ms, plain_ms = statistics.mean(turns["flash"]), statistics.mean(turns["plain"])
    flash_dev, plain_dev = (device_busy_ms(functools.partial(stack_step, stack, x, dy)) for stack in (flash, plain))
    print(f"phase 13b: {cfg.n_layers} encoder blocks at BERT-base width (D = {cfg.dim // cfg.n_heads}, non-causal, "
          f"unmasked, bf16 compute), one forward + backward of B={ENC_FLASH_BATCH} x L={ENC_FLASH_SEQ}: launches "
          f"{launches} (expected {cfg.n_layers} bf16 forwards and {cfg.n_layers} fused backwards, every other kernel "
          f"0); kernel route against the plain route: {'; '.join(report)}; a step {flash_ms:.3f} ms through the "
          f"kernels, {plain_ms:.3f} ms on the plain route ({plain_ms / flash_ms:.2f}x; CUDA events with the host's "
          f"launch work, medians of {ENC_TIMED_STEPS} runs in two turns each: kernel "
          f"{[round(t, 3) for t in turns['flash']]}, plain {[round(t, 3) for t in turns['plain']]}); device busy a "
          f"step {flash_dev:.3f} ms and {plain_dev:.3f} ms "
          f"({plain_dev / flash_dev:.2f}x; torch.profiler, one step each); card {card}", flush=True)
    expected = {name: 0 for name in launches}
    expected.update(flash_forward=cfg.n_layers, flash_backward=cfg.n_layers)
    require(launches == expected, f"encoder flash launches {launches}, expected {expected}")
    require(ok, "the encoder stack's kernel route disagrees with the plain route")
    del flash, plain
    torch.cuda.empty_cache()
    return dict(launches=launches, max_abs_err=worst, flash_ms=flash_ms, plain_ms=plain_ms, flash_device_ms=flash_dev,
                plain_device_ms=plain_dev)


def vit_phase(card: str) -> dict:
    """Phase 13c: ``ViTConfig.large()`` (ViT-L/16 at 224: 24 x 1024, 16
    heads, FFN 4096, 197 positions): inference images/s at B =
    VIT_INFER_BATCH, then VIT_STEPS steps of ``fit`` with cross-entropy at B
    = VIT_BATCH on seeded images. The plain route (197 positions are not
    tiled by the flash blocks, in JAX as here); every port kernel's
    launches must be 0."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from unionml_tpu_torch import TrainerConfig, TrainState, fit, make_train_step
    from unionml_tpu_torch.models import ViT, ViTConfig

    cfg = ViTConfig.large()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # what earlier phases still hold
    t0 = time.perf_counter()
    model = ViT(cfg, seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    rng = np.random.RandomState(1)
    reset_counts()
    images = torch.from_numpy(rng.rand(VIT_INFER_BATCH, cfg.image_size, cfg.image_size, cfg.channels)
                              .astype(np.float32)).cuda()
    with torch.no_grad():
        logits = model(images)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(VIT_INFER_RUNS):
            logits = model(images)
        torch.cuda.synchronize()
        infer_s = (time.perf_counter() - t0) / VIT_INFER_RUNS
    require(logits.shape == (VIT_INFER_BATCH, cfg.num_classes) and bool(torch.isfinite(logits).all()), "ViT logits")
    del images
    data = [rng.rand(VIT_BATCH * VIT_STEPS, cfg.image_size, cfg.image_size, cfg.channels).astype(np.float32),
            rng.randint(0, cfg.num_classes, size=VIT_BATCH * VIT_STEPS).astype(np.int64)]

    def loss_fn(module, batch):
        return F.cross_entropy(module(batch[0]).float(), batch[1].long())

    state = TrainState(model, torch.optim.Adam(model.parameters(), lr=VIT_LR))
    t0 = time.perf_counter()
    result = fit(state, make_train_step(loss_fn), data,
                 TrainerConfig(epochs=1, batch_size=VIT_BATCH, shuffle=True, log_every_steps=1))
    seconds = time.perf_counter() - t0
    launches = all_launches()
    losses = [h["loss"] for h in result.history]
    sps = result.samples_per_sec
    matmul = encoder_matmul_params(model)
    seq = 1 + cfg.n_patches
    # dense layers and the patch convolution (6 * N * T) and the attention products
    train_flops = 6 * matmul * VIT_BATCH * seq + 6 * 2 * VIT_BATCH * seq ** 2 * cfg.dim * cfg.n_layers
    print(f"phase 13c: ViT-L/16 at {cfg.image_size} ({cfg.n_layers} x {cfg.dim}, {cfg.n_heads} heads, FFN "
          f"{cfg.hidden_dim}, {seq} positions; {sum(p.numel() for p in model.parameters())} parameters, f32, bf16 "
          f"compute, seed 0, built in {build_s:.1f} s): inference {VIT_INFER_BATCH / infer_s:.1f} images/s at "
          f"B={VIT_INFER_BATCH} ({1e3 * infer_s:.1f} ms a batch, mean of {VIT_INFER_RUNS}); trained {result.steps} "
          f"steps of B={VIT_BATCH} in {seconds:.1f} s (first step {result.compile_time_s:.2f} s): {sps:.1f} samples/s "
          f"over steps 2-{VIT_STEPS}, {train_flops * sps / VIT_BATCH / 1e12:.1f} TFLOP/s achieved; peak memory "
          f"{(torch.cuda.max_memory_allocated() - held) / 2**30:.2f} GiB above the {held / 2**30:.2f} GiB held "
          f"before; losses {losses}; port kernel launches {launches} "
          f"(the plain route: all 0); card {card}", flush=True)
    require(result.steps == VIT_STEPS and all(math.isfinite(x) for x in losses), f"ViT losses {losses}")
    require(not any(launches.values()), f"a port kernel launched on the ViT path: {launches}")
    del model, state, result, data
    torch.cuda.empty_cache()
    return dict(launches=launches, images_per_s=VIT_INFER_BATCH / infer_s, samples_per_s=sps)


def mlp_app(rows: dict):
    """``MLPConfig()`` behind a pandas-free ``Dataset``/``Model``: a reader
    of the seeded MNIST-shaped rows, a splitter of the train and test rows, a
    step trainer at B = MLP_BATCH, an accuracy evaluator and a predictor."""
    from typing import List, Optional, Tuple

    import numpy as np
    import torch
    import torch.nn.functional as F

    from unionml_tpu_torch import Dataset, Model, TrainerConfig, TrainState, make_train_step
    from unionml_tpu_torch.models import MLPConfig, make_train_state

    dataset = Dataset(name="mnist_shaped")
    model = Model(name="mlp_classifier", dataset=dataset)

    @dataset.reader
    def reader() -> dict:
        return rows

    @dataset.splitter
    def splitter(data: dict, test_size: float, shuffle: bool, random_state: int) -> Tuple[dict, dict]:
        return ({k: v[:MLP_TRAIN_ROWS] for k, v in data.items()}, {k: v[MLP_TRAIN_ROWS:] for k, v in data.items()})

    @dataset.parser
    def parser(data: dict, features: Optional[List[str]], targets: List[str]) -> Tuple[np.ndarray, np.ndarray]:
        return data["x"], data["y"]

    @dataset.feature_loader
    def feature_loader(raw) -> np.ndarray:
        return np.asarray(raw, dtype=np.float32)

    @model.init
    def init(hyperparameters: dict) -> TrainState:
        return make_train_state(MLPConfig(), MLP_INPUTS, learning_rate=1e-3, seed=0)

    step = make_train_step(lambda module, batch: F.cross_entropy(module(batch[0]).float(), batch[1].long()))

    @model.trainer(config=TrainerConfig(epochs=1, batch_size=MLP_BATCH, shuffle=True))
    def trainer(state: TrainState, batch) -> tuple:
        return step(state, batch)

    def logits(state: TrainState, features) -> torch.Tensor:
        with torch.no_grad():
            return state.model(torch.as_tensor(np.asarray(features, np.float32), device="cuda"))

    @model.evaluator
    def evaluator(state: TrainState, features: np.ndarray, target: np.ndarray) -> float:
        return float((logits(state, features).argmax(-1).cpu().numpy() == target).mean())

    @model.predictor
    def predictor(state: TrainState, features: np.ndarray) -> List[int]:
        return [int(i) for i in logits(state, features).argmax(-1)]

    return model


def mlp_phase(card: str) -> dict:
    """Phase 13d: ``BASELINE.json`` config 2, ``MLPConfig()`` on MNIST shapes
    through ``Model.train`` (one epoch of the 60,000 train rows at B = 128)
    and ``model.predict`` on 4 rows. No port kernel launches."""
    import numpy as np

    rng = np.random.RandomState(MLP_SEED)
    teacher = rng.randn(MLP_INPUTS, 10).astype(np.float32)  # drawn before the rows: one labelling for any size
    x = rng.rand(MLP_TRAIN_ROWS + MLP_TEST_ROWS, MLP_INPUTS).astype(np.float32)
    rows = {"x": x, "y": ((x - 0.5) @ teacher).argmax(-1).astype(np.int64)}
    model = mlp_app(rows)
    reset_counts()
    t0 = time.perf_counter()
    _, metrics = model.train()
    seconds = time.perf_counter() - t0
    fit = model.last_fit_result
    predictions = model.predict(features=x[-4:])
    launches = all_launches()
    losses = [h["loss"] for h in fit.history]
    print(f"phase 13d: MLPConfig() (784 -> 512 -> 256 -> 10, bf16 compute, f32 parameters) through Model.train: "
          f"{fit.steps} steps of B={MLP_BATCH} in {seconds:.1f} s (data, init and evaluation included; first step "
          f"{fit.compile_time_s:.3f} s): {fit.samples_per_sec:.0f} samples/s; accuracy train {metrics['train']:.4f} "
          f"test {metrics['test']:.4f}; last loss {losses[-1]:.4f}; model.predict on 4 rows {predictions} "
          f"(labels {rows['y'][-4:].tolist()}); port kernel launches {launches} (all 0); card {card}", flush=True)
    require(fit.steps == MLP_TRAIN_ROWS // MLP_BATCH and math.isfinite(losses[-1]), f"MLP fit {fit.steps} {losses}")
    require(len(predictions) == 4 and all(0 <= p < 10 for p in predictions), f"predictions {predictions}")
    require(not any(launches.values()), f"a port kernel launched on the MLP path: {launches}")
    return dict(launches=launches, samples_per_s=fit.samples_per_sec)


def cpu_card_fit(make, data, loss_fn) -> tuple:
    """The same seeded model on the CPU and on the card, ENC_CPU_STEPS steps
    of ``fit`` each: ((cpu losses, cpu params), (card losses, card params),
    forward check inputs)."""
    import torch

    from unionml_tpu_torch import TrainerConfig, TrainState, fit, make_train_step

    runs = []
    for device in ("cpu", "cuda"):
        model = make(device)
        state = TrainState(model, torch.optim.Adam(model.parameters(), lr=ENC_CPU_LR))
        result = fit(state, make_train_step(loss_fn), data,
                     TrainerConfig(epochs=1, batch_size=len(data[-1]) // ENC_CPU_STEPS, shuffle=True,
                                   log_every_steps=1), device=device)
        runs.append(([h["loss"] for h in result.history],
                     {n: p.detach().cpu() for n, p in model.named_parameters()}))
        del model, state, result
    return runs


def hold_fit(label: str, runs) -> str:
    import torch

    (cpu_losses, cpu_params), (card_losses, card_params) = runs
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(card_losses, cpu_losses))
    diffs = torch.cat([(card_params[n] - cpu_params[n]).abs().flatten() for n in cpu_params])
    beyond = (diffs > 1e-5).float().mean().item()
    ok = (len(card_losses) == ENC_CPU_STEPS and loss_err <= ENC_CPU_LOSS_REL and diffs.mean().item() <= 1e-6
          and beyond <= 1e-4 and diffs.max().item() <= 2 * ENC_CPU_LR * ENC_CPU_STEPS)
    require(ok, f"{label}: fit on the card differs from the CPU (losses {card_losses} vs {cpu_losses}, parameter "
                f"differences max {diffs.max().item():.3g} mean {diffs.mean().item():.3g} share beyond 1e-5 {beyond})")
    return (f"{label}: {ENC_CPU_STEPS} steps of fit, losses card {card_losses} CPU {cpu_losses} (max rel err "
            f"{loss_err:.3g}), parameters max diff {diffs.max().item():.3g} mean {diffs.mean().item():.3g}, "
            f"{beyond:.2e} of {diffs.numel()} entries beyond 1e-5")


def encoder_parity_phase() -> dict:
    """Phase 13e, float32 with TF32 off: 2-layer BERT-base and ViT-L and the
    MLP on the card against the port on the CPU (forwards, and
    ENC_CPU_STEPS steps of ``fit``: losses and parameters), then the 12-layer
    encoder stack of 13b in f32 through the f32 flash kernels against the
    plain route (FLASH_TOLERANCE's f32 entry, element for element). Returns
    the f32 stack's launches."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from unionml_tpu_torch.models import (
        BertConfig, BertEncoder, MLPClassifier, MLPConfig, ViT, ViTConfig, classification_loss,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    f32 = dict(dtype=torch.float32, param_dtype=torch.float32)
    bert_cfg = BertConfig.base(n_layers=ENC_PARITY_LAYERS, **f32)
    vit_cfg = ViTConfig.large(n_layers=ENC_PARITY_LAYERS, **f32)
    mlp_cfg = MLPConfig(**f32)
    rng = np.random.RandomState(5)
    bert_data = sst2_batches(bert_cfg.vocab_size, 4 * ENC_CPU_STEPS, seed=5)
    vit_data = [rng.rand(2 * ENC_CPU_STEPS, vit_cfg.image_size, vit_cfg.image_size, 3).astype(np.float32),
                rng.randint(0, vit_cfg.num_classes, size=2 * ENC_CPU_STEPS).astype(np.int64)]
    mlp_data = [rng.rand(128 * ENC_CPU_STEPS, 28, 28).astype(np.float32),
                rng.randint(0, 10, size=128 * ENC_CPU_STEPS).astype(np.int64)]
    # each model is seeded on the CPU and moved: the CPU's and the card's generators draw other numbers
    cases = (
        ("BERT-base, 2 layers", lambda d: BertEncoder(bert_cfg, device="cpu", seed=1).to(d), bert_data,
         lambda m, b: classification_loss(m, b)[0], lambda m, b: m(b[0], b[1])),
        ("ViT-L/16, 2 layers", lambda d: ViT(vit_cfg, device="cpu", seed=2).to(d), vit_data,
         lambda m, b: F.cross_entropy(m(b[0]), b[1]), lambda m, b: m(b[0])),
        ("MLPConfig()", lambda d: MLPClassifier(mlp_cfg, 784, device="cpu", seed=3).to(d), mlp_data,
         lambda m, b: F.cross_entropy(m(b[0]), b[1]), lambda m, b: m(b[0])),
    )
    lines = []
    for label, make, data, loss_fn, forward in cases:
        outs = []
        for device in ("cpu", "cuda"):
            model = make(device)
            batch = [torch.from_numpy(a[: len(a) // ENC_CPU_STEPS]).to(device) for a in data]
            with torch.no_grad():
                outs.append(forward(model, batch).cpu())
            del model
        err = (outs[1] - outs[0]).abs().max().item()
        same = torch.allclose(outs[1], outs[0], atol=ENC_CPU_TOL, rtol=ENC_CPU_TOL)
        require(same, f"{label}: the card's forward differs from the CPU's by {err:.3g}")
        lines.append(f"{label}: forward {tuple(outs[0].shape)} max abs diff {err:.3g} (tolerance {ENC_CPU_TOL}); "
                     + hold_fit(label, cpu_card_fit(make, data, loss_fn)))
        torch.cuda.empty_cache()
    print(f"phase 13e, float32 (TF32 off), card against the port on the CPU: {'; '.join(lines)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    # the 13b stack in f32: the f32 forward and the fused f32 backward against the plain route
    cfg = BertConfig.base()
    flash = encoder_stack("flash", torch.float32, seed=6)
    plain = encoder_stack("xla", torch.float32)
    plain.load_state_dict(flash.state_dict())
    g = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(ENC_FLASH_BATCH, ENC_FLASH_SEQ, cfg.dim, device="cuda", generator=g)
    dy = torch.randn(ENC_FLASH_BATCH, ENC_FLASH_SEQ, cfg.dim, device="cuda", generator=g)
    reset_counts()
    got = stack_step(flash, x, dy)
    torch.cuda.synchronize()
    launches = all_launches()
    want = stack_step(plain, x, dy)
    atol, rtol = FLASH_TOLERANCE["torch.float32"]
    errs = [(got[i] - want[i]).abs().max().item() for i in range(2)]
    ok = all(torch.allclose(got[i], want[i], atol=atol, rtol=rtol) for i in range(2))
    expected = {name: 0 for name in launches}
    expected.update(flash_forward_f32=cfg.n_layers, flash_backward_f32=cfg.n_layers)
    print(f"phase 13e, float32: {cfg.n_layers} encoder blocks at BERT-base width through the f32 flash kernels "
          f"(B={ENC_FLASH_BATCH} x L={ENC_FLASH_SEQ}, non-causal) against the plain route: output max_abs_err "
          f"{errs[0]:.3g}, input gradient {errs[1]:.3g} (tolerance atol={atol} rtol={rtol}); launches {launches} "
          f"(expected {expected})", flush=True)
    require(ok, "the f32 encoder stack's kernel route disagrees with the plain route")
    require(launches == expected, f"f32 encoder launches {launches}, expected {expected}")
    del flash, plain
    torch.cuda.empty_cache()
    return dict(launches=launches, max_abs_err=max(errs))


# ---------------------------------------------------------------------------- phase 15: the mesh


def first_logits(gen, prompt):
    """The f32 logits of ``prompt``'s first generated token (batch 1, the
    Generator's own prefill; a collective on a mesh: every rank calls it)."""
    import torch

    with torch.no_grad():
        _, _, last, _ = gen._start([prompt], 0)
        return gen._head(last.to(gen.model.config.dtype))[0].float()


def mesh_world1_phase(card: str, gcfg, prompts, slots: int, decode_chunk: int, bf16_streams) -> dict:
    """Phase 15a: phase 3's model (Llama-3-8B width, bf16, seed 0) through
    ``Generator(mesh=MeshSpec(model=1).build(), partition_rules=llama_partition_rules())``
    (a world of one process over NCCL) and a ``ContinuousBatcher`` with phase 3's
    knobs and prompts: its streams must equal phase 3's, and its paged launches
    be 32 x 8 a dispatch. Returns the first-token logits of the unsharded run
    at (b)'s depth (MESH_SERVE_LAYERS of the 32 layers, seed 0), which (b)
    holds its model=2 run to."""
    import torch
    import torch.distributed as dist

    from unionml_tpu_torch import ContinuousBatcher, Generator, Llama, LlamaConfig
    from unionml_tpu_torch.models import llama_partition_rules
    from unionml_tpu_torch.parallel import MeshSpec

    mesh = MeshSpec(model=1).build()
    require(dist.get_backend() == "nccl" and mesh.devices == 1, f"world-1 mesh over {dist.get_backend()}")
    cfg = LlamaConfig.llama3_8b(attention_impl="flash", dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    gen = Generator(Llama(cfg, seed=0), gcfg, mesh=mesh, partition_rules=llama_partition_rules())
    warm = ContinuousBatcher(gen, slots=slots, decode_chunk=decode_chunk, block_size=BLOCK)
    serve(warm, [prompts[0][:3]])  # set-up: first cuBLAS/allocator calls
    warm.close()
    batcher = ContinuousBatcher(gen, slots=slots, decode_chunk=decode_chunk, block_size=BLOCK)
    reset_counts()
    streams, seconds = serve(batcher, prompts)
    counts = all_launches()
    launches = counts["paged_decode_attention"]
    stats = batcher.stats()
    batcher.close()
    expected = cfg.n_layers * stats["decode_dispatches"] * decode_chunk
    del gen, warm, batcher
    gc.collect()
    torch.cuda.empty_cache()
    # (b)'s depth, unsharded: the first-token logits its model=2 run is held to
    gen = Generator(Llama(dataclasses.replace(cfg, n_layers=MESH_SERVE_LAYERS), seed=0), gcfg, mesh=mesh,
                    partition_rules=llama_partition_rules())
    logits = [first_logits(gen, p) for p in prompts]
    result = dict(tok_s=len(prompts) * MAX_NEW / seconds, ttft_p50=stats["ttft_ms"]["p50_ms"], launches=launches,
                  logits=logits)
    print(f"phase 15a: world of 1 over NCCL ({mesh}), Llama-3-8B width bf16 through Generator(mesh=, "
          f"partition_rules=): {result['tok_s']:.1f} tok/s, TTFT p50 {result['ttft_p50']} ms, paged launches "
          f"{launches} (expected {expected}), every count {counts}; streams "
          f"{'equal' if streams == bf16_streams else 'NOT EQUAL'} to phase 3's; card {card}", flush=True)
    require(streams == bf16_streams, f"world-1 mesh streams {streams} != phase 3's {bf16_streams}")
    require(launches == expected > 0, f"{launches} paged launches on the world-1 mesh, expected {expected}")
    others = {name: n for name, n in counts.items() if name != "paged_decode_attention"}
    require(not any(others.values()), f"kernels off the world-1 mesh path launched: {others}")
    del gen
    dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 15a: {torch.cuda.memory_allocated() / 2**30:.2f} GiB still allocated in this process before the "
          f"ranks start", flush=True)
    return result


def mesh_cases(prompts, gcfg) -> list:
    """Phase 15b's cases: (model, dtype, layers, seed, mesh axes, rules, engine knobs, prompts, draft), the five
    in f32 at 2 layers first (untimed: they run beside the parent's references), then bf16 at full width."""
    import numpy as np

    sp_prompt = np.random.RandomState(4).randint(1, 128256, size=SP_PROMPT_LEN).tolist()
    base = dict(max_new_tokens=gcfg.max_new_tokens, temperature=0.0, prompt_buckets=tuple(gcfg.prompt_buckets))
    moe = moe_prompts(32000)
    return [
        dict(name="tp32", model="llama", f32=True, seed=1, spec=dict(model=2), rules="llama", gen=base, slots=4,
             prompts=prompts),
        dict(name="int832", model="llama", f32=True, seed=3, spec=dict(model=2), rules="llama",
             gen={**base, "max_new_tokens": INT8_PARITY_NEW}, slots=4, prompts=prompts[:2], quantize="int8"),
        dict(name="sp32", model="llama", f32=True, seed=1, spec=dict(sequence=2), rules=None, slots=4,
             gen={**base, "sp_prefill": "ring"}, prompts=prompts),
        dict(name="moe32", model="moe", f32=True, seed=1, spec=dict(expert=2), rules="moe", gen=base, slots=4,
             prompts=moe),
        # tp32's target as its own draft (a second module from the same seed), one stream at a time: its streams
        # are tp32's reference too, and its rounds and acceptances the unsharded run's
        dict(name="spec32", model="llama", f32=True, seed=1, spec=dict(model=2), rules="llama", gen=base, slots=4,
             prompts=prompts, draft=dict(target=True), one_by_one=True),
        dict(name="tp", model="llama", f32=False, seed=0, spec=dict(model=2), rules="llama", gen=base, slots=4,
             prompts=prompts, logits=True, pool_check=True, host_time=True),
        dict(name="int8", model="llama", f32=False, seed=0, spec=dict(model=2), rules="llama", gen=base, slots=4,
             prompts=prompts, quantize="int8", host_time=True),
        dict(name="sp", model="llama", f32=False, seed=0, spec=dict(sequence=2), rules=None, slots=1,
             gen={**base, "prompt_buckets": (SP_PROMPT_LEN,), "sp_prefill": "ring"}, prompts=[sp_prompt]),
        dict(name="moe", model="moe", f32=False, seed=0, spec=dict(expert=2), rules="moe", gen=base, slots=4,
             prompts=moe),
        dict(name="spec", model="llama", f32=False, seed=0, spec=dict(model=2), rules="llama", gen=base, slots=4,
             prompts=prompts, draft=dict(n_layers=MESH_DRAFT_LAYERS, seed=DRAFT_SEED), pool_check=True),
    ]


def mesh_model(case):
    """A case's model on the card, built from its seed (every process that
    builds it on cuda:0 gets the same weights)."""
    import torch

    from unionml_tpu_torch import Llama, LlamaConfig
    from unionml_tpu_torch.models import MoEConfig, MoETransformer

    dtype = torch.float32 if case["f32"] else torch.bfloat16
    if case["model"] == "moe":
        layers = dict(n_layers=MOE_PARITY_LAYERS, capacity_factor=MOE_NO_DROP_CAPACITY) if case["f32"] else {}
        return MoETransformer(MoEConfig(dtype=dtype, param_dtype=dtype, **layers), seed=case["seed"])
    cfg = LlamaConfig.llama3_8b(attention_impl="flash", dtype=dtype, param_dtype=dtype,
                                n_layers=2 if case["f32"] else MESH_SERVE_LAYERS)
    return Llama(cfg, seed=case["seed"])


def mesh_config(case, rules):
    """A case's ``GenerationConfig``: its draft (built on the card from its
    seed, placed under ``rules``) attached when it has one."""
    import torch

    from unionml_tpu_torch import GenerationConfig, Llama
    from unionml_tpu_torch.models import DraftSpec

    if not case.get("draft"):
        return GenerationConfig(**case["gen"])
    dtype = torch.float32 if case["f32"] else torch.bfloat16
    if case["draft"].get("target"):
        draft = mesh_model(case)  # the target's weights in a module of its own, cut apart from the target's
    else:
        draft = Llama(draft_config(dtype, n_layers=case["draft"]["n_layers"]), seed=case["draft"]["seed"])
    return GenerationConfig(**case["gen"], draft=DraftSpec(module=draft, gamma=GAMMA, partition_rules=rules))


def timed_rounds(engine) -> dict:
    """Wrap ``engine``'s speculative dispatch to sum, over the calls, the
    calling thread's CPU time, the wall time, the rounds and the gloo host
    transfers inside them (on rank 0: the controller's cost a round)."""
    from unionml_tpu_torch.parallel.collectives import host_route

    real, spent = engine._op_spec_rounds, dict(cpu_s=0.0, wall_s=0.0, timed_rounds=0, round_transfers=0)

    def timed(adm, budget):
        rounds, transfers = engine._carried("rounds"), host_route.count
        cpu0, wall0 = time.thread_time(), time.perf_counter()
        state = real(adm, budget)
        spent["cpu_s"] += time.thread_time() - cpu0
        spent["wall_s"] += time.perf_counter() - wall0
        spent["timed_rounds"] += engine._carried("rounds", state) - rounds
        spent["round_transfers"] += host_route.count - transfers
        return state

    engine._op_spec_rounds = timed
    return spent


def mesh_case(rank: int, case: dict, decode_chunk: int, logits, sync) -> dict:
    """Run one case of phase 15b on this rank: build, place, serve from rank
    0 (the other rank follows its step plans), then the checks each rank
    makes on its own shards."""
    import torch
    import torch.distributed as dist

    from unionml_tpu_torch import ContinuousBatcher, Generator
    from unionml_tpu_torch.models import llama_partition_rules, moe_partition_rules
    from unionml_tpu_torch.ops.paged_attention import paged_decode_attention, paged_decode_attention_reference
    from unionml_tpu_torch.parallel import MeshSpec
    from unionml_tpu_torch.parallel.collectives import host_route

    torch.backends.cuda.matmul.allow_tf32 = not case["f32"]
    torch.backends.cudnn.allow_tf32 = not case["f32"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mesh = MeshSpec(**case["spec"]).build()
    rules = {"llama": llama_partition_rules(), "moe": moe_partition_rules()}.get(case["rules"])
    gen = Generator(mesh_model(case), mesh_config(case, rules), mesh=mesh, partition_rules=rules,
                    quantize=case.get("quantize"))
    engine = ContinuousBatcher(gen, slots=case["slots"], decode_chunk=decode_chunk, block_size=BLOCK)
    # the pool the case's paged steps read: the draft's under a draft (the target verifies through the gather path)
    paged_gen = engine._spec._draft if case.get("draft") else gen
    res = dict(build_s=time.perf_counter() - t0,
               heads=(paged_gen.cache_config.n_heads, paged_gen.cache_config.n_kv_heads))
    prompts = case["prompts"]
    if rank == 0 and not case["f32"]:
        # set-up: the rank pair's first cuBLAS and allocator calls (a draft's: one round)
        if case.get("draft"):
            list(engine.submit(prompts[0][:3], max_new_tokens=2))
        else:
            serve(engine, [prompts[0][:3]])
    spent = timed_rounds(engine) if case.get("draft") and rank == 0 else None
    dist.barrier(group=sync)
    reset_counts()
    host_route.count = 0
    dist.barrier(group=sync)
    if rank == 0:
        before = engine.decode_dispatches  # the set-up stream's dispatches are not this run's
        spec0 = (engine._spec.rounds, engine._spec.accepted_tokens, engine._spec.proposed_tokens) \
            if case.get("draft") else None
        streams, seconds = (serve_one_by_one if case.get("one_by_one") else serve)(engine, prompts)
        stats = engine.stats()
        res.update(streams=streams, seconds=seconds, ttft_p50=stats["ttft_ms"]["p50_ms"],
                   tbt_p50=stats["tbt_ms"]["p50_ms"], dispatches=engine.decode_dispatches - before,
                   admissions=len(prompts))
        if spent is not None:
            spec = engine._spec
            rounds, accepted, proposed = (spec.rounds - spec0[0], spec.accepted_tokens - spec0[1],
                                          spec.proposed_tokens - spec0[2])
            res.update(rounds=rounds, accepted=accepted, proposed=proposed,
                       acceptance=accepted / (rounds * GAMMA) if rounds else None, **spent)
    dist.barrier(group=sync)
    launches = all_launches()
    res.update(launches=launches, paged=launches["paged_decode_attention"], int8=launches["int8_matmul"],
               transfers=host_route.count)
    if case.get("logits"):  # every rank runs the prefill (a collective); rank 0 compares
        mine = [first_logits(gen, p) for p in prompts]
        if rank == 0:
            res["logits_rel_rms"] = [rel_rms(a, b.to(a.device)) for a, b in zip(mine, logits)]
            res["argmax_equal"] = sum(int(a.argmax() == b.argmax()) for a, b in zip(mine, logits))
    if case.get("pool_check"):  # one launch on this rank's live pool of layer 0, against the twin
        layer = engine._carried("d_cache" if case.get("draft") else "cache")[0]
        cfg = paged_gen.cache_config
        dev = layer["k"].device
        g = torch.Generator(device=dev).manual_seed(17 + rank)
        q = torch.randn(case["slots"], cfg.n_heads, cfg.dim // cfg.n_heads, device=dev, generator=g)
        q = q.to(layer["k"].dtype)
        lengths = engine._carried("lengths").clamp(min=1).to(torch.int32)
        before = paged_decode_attention.launches
        out = paged_decode_attention(q, layer["k"], layer["v"], lengths, layer["table"])
        torch.cuda.synchronize()
        ref = paged_decode_attention_reference(q, layer["k"], layer["v"], lengths, layer["table"])
        atol, rtol = TOLERANCE[str(q.dtype)]
        err = (out.float() - ref.float()).abs()
        res.update(pool_err=err.max().item(), pool_ok=bool((err <= atol + rtol * ref.float().abs()).all()),
                   pool_launches=paged_decode_attention.launches - before, pool_shape=tuple(layer["k"].shape))
    if case.get("host_time") and rank == 0:
        res.update(hand_dispatch(engine, decode_chunk))
    res["memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    dist.barrier(group=sync)
    engine.close()
    del gen, engine
    gc.collect()  # the next case's peak must not hold this one's model (reference cycles)
    torch.cuda.empty_cache()
    return res


def hand_dispatch(engine, decode_chunk: int) -> dict:
    """One decode dispatch driven from rank 0 while the engine idles (the
    other rank follows its plan): the controller thread's CPU time and the
    wall time a step, and the gloo transfers and paged launches of the
    dispatch on this rank."""
    import torch

    from unionml_tpu_torch.ops.paged_attention import paged_decode_attention
    from unionml_tpu_torch.parallel.collectives import host_route

    torch.cuda.synchronize()
    transfers, paged = host_route.count, paged_decode_attention.launches
    cpu0, wall0 = time.thread_time(), time.perf_counter()
    engine._dev("decode", None, decode_chunk)
    torch.cuda.synchronize()
    return dict(host_ms_per_step=(time.thread_time() - cpu0) * 1e3 / decode_chunk,
                wall_ms_per_step=(time.perf_counter() - wall0) * 1e3 / decode_chunk,
                dispatch_transfers=host_route.count - transfers, dispatch_paged=paged_decode_attention.launches - paged)


def settled(engine, rank: int, sync) -> None:
    """Return once rank 1's engine thread has run every operation rank 0's
    engine sent (a graph's replay adds its launches after its last graph):
    rank 0 sends an empty plan, which that thread takes only when done with
    the last one, and both ranks then meet at a barrier."""
    import torch.distributed as dist

    if rank == 0:
        engine._plan.record("noop", None, (), True)
    dist.barrier(group=sync)


def mesh_aot_case(rank: int, case: dict, route: str, decode_chunk: int, sync, store: str, kernels: str) -> dict:
    """One graph-route engine of phase 15b on this rank: ``case``'s model
    built afresh from its seed behind a fresh ``Generator`` and
    ``ContinuousBatcher(aot=store)``; ``warmup()`` (rank 0 warms, rank 1
    runs its plans: each program captured in segments between its
    collectives, or loaded), rank 0 serves the case's prompts, then drives
    one decode dispatch by hand. ``route="hit"`` first points the kernel
    build cache at the empty directory ``kernels``; the ``nvcc`` runs are
    counted either way."""
    import os

    import torch

    from unionml_tpu_torch import ContinuousBatcher, Generator, _build
    from unionml_tpu_torch.compile_cache import enable_compile_cache
    from unionml_tpu_torch.models import llama_partition_rules, moe_partition_rules
    from unionml_tpu_torch.parallel import MeshSpec
    from unionml_tpu_torch.parallel.collectives import host_route
    from unionml_tpu_torch.serving.aot import ProgramStore

    torch.backends.cuda.matmul.allow_tf32 = not case["f32"]
    torch.backends.cudnn.allow_tf32 = not case["f32"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    build_dir, nvcc0 = _build.build_dir(), _build.nvcc_runs
    if route == "hit":
        enable_compile_cache(kernels)
    try:
        mesh = MeshSpec(**case["spec"]).build()
        rules = {"llama": llama_partition_rules(), "moe": moe_partition_rules()}.get(case["rules"])
        gen = Generator(mesh_model(case), mesh_config(case, rules), mesh=mesh, partition_rules=rules,
                        quantize=case.get("quantize"))
        engine = ContinuousBatcher(gen, slots=case["slots"], decode_chunk=decode_chunk, block_size=BLOCK, aot=store)
        t0 = time.perf_counter()
        engine.warmup()
        res = dict(warmup_s=time.perf_counter() - t0)
        settled(engine, rank, sync)
        reset_counts()
        host_route.count = 0
        if rank == 0:
            before = engine.decode_dispatches
            streams, seconds = serve(engine, case["prompts"])
            stats = engine.stats()
            res.update(streams=streams, seconds=seconds, ttft_p50=stats["ttft_ms"]["p50_ms"],
                       tbt_p50=stats["tbt_ms"]["p50_ms"], dispatches=engine.decode_dispatches - before)
        settled(engine, rank, sync)
        launches = all_launches()
        res.update(launches=launches, paged=launches["paged_decode_attention"], int8=launches["int8_matmul"],
                   transfers=host_route.count)
        if rank == 0:
            res.update(hand_dispatch(engine, decode_chunk))
            if route == "miss":
                res["entries"] = sorted((e["program"], e["segments"], len(e["collectives"]), e["capture_ms"])
                                        for e in ProgramStore(store).entries())
        settled(engine, rank, sync)
        res["memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
        engine.close()
        # read once closed: rank 1's thread has then run every plan
        res["aot"] = {k: v for k, v in engine.stats()["aot"].items() if isinstance(v, int)}
        res["traces"] = (gen.prefill_traces, gen.decode_traces)
        res["programs"] = {attr.strip("_"): sorted((g.segments, len(g.collectives))
                                                   for g in getattr(gen, attr)._programs.values())
                           for attr in ("_prefill", "_sp_prefill", "_prefill_chunk", "_first_token", "_decode")
                           if getattr(gen, attr)._programs}
    finally:
        _build.set_build_dir(build_dir)
    res["nvcc_runs"] = _build.nvcc_runs - nvcc0
    res["installed"] = sorted(os.listdir(kernels)) if route == "hit" else None
    del gen, engine
    gc.collect()
    torch.cuda.empty_cache()
    return res


def mesh_rank(rank: int, store: str, cases: list, decode_chunk: int, logits, out, refs_done, aot_dir: str) -> None:
    """One of phase 15b's two processes, both on cuda:0 over gloo (NCCL
    refuses two ranks on one card). The timed bf16 cases start once the
    parent sets ``refs_done``; the graph-route cases (``MESH_AOT_CASES``, AOT
    stores under ``aot_dir``) run after the ten. Puts ``(rank, ok, results
    or traceback)`` on ``out``."""
    try:
        import faulthandler
        import os

        import torch
        import torch.distributed as dist

        faulthandler.enable(all_threads=True)  # a rank that dies of a signal prints its threads' stacks first
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", store=dist.FileStore(store, MESH_RANKS), rank=rank, world_size=MESH_RANKS)
        sync = dist.new_group(list(range(MESH_RANKS)))  # the phase's own barriers, beside the mesh's groups
        results = {}
        for case in cases:
            if not case["f32"]:
                refs_done.wait()
            results[case["name"]] = mesh_case(rank, case, decode_chunk, logits, sync)
        by_name = {case["name"]: case for case in cases}
        for name, routes in MESH_AOT_CASES:
            programs = os.path.join(aot_dir, name)  # the ranks share one card, so one store
            for route in routes:
                results[f"{name}_aot_{route}"] = mesh_aot_case(rank, by_name[name], route, decode_chunk, sync,
                                                               programs, os.path.join(aot_dir, f"kernels-{name}-{rank}"))
        dist.destroy_process_group()
        out.put((rank, True, results))
    except BaseException:
        import traceback

        out.put((rank, False, traceback.format_exc()))


def mesh_expected(case, decode_chunk: int) -> dict:
    """An f32 case's unsharded run on the card (the engine with the case's
    knobs and draft): its streams, and under a draft the speculative
    counters ``(rounds, accepted, proposed)`` over them."""
    import torch

    from unionml_tpu_torch import ContinuousBatcher, Generator

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = mesh_model(case)
    plain = dict(case, gen={k: v for k, v in case["gen"].items() if k != "sp_prefill"})
    gen = Generator(model, mesh_config(plain, None), quantize=case.get("quantize"))
    engine = ContinuousBatcher(gen, slots=case["slots"], decode_chunk=decode_chunk, block_size=BLOCK)
    card_streams, _ = (serve_one_by_one if case.get("one_by_one") else serve)(engine, case["prompts"])
    spec = engine._spec
    counters = (spec.rounds, spec.accepted_tokens, spec.proposed_tokens) if spec is not None else None
    engine.close()
    del engine, gen, model, spec
    gc.collect()
    torch.cuda.empty_cache()
    return dict(streams=card_streams, spec=counters)


def int8_shard_phase() -> dict:
    """Phase 15b's int8 weight shapes (one rank's at model=2) through the
    kernel, against its twin, timed beside the twin and cuBLAS on the
    dequantized bf16 weight, at M = 4 (decode) and 256 (admission)."""
    import torch

    from unionml_tpu_torch.ops.int8_matmul import int8_matmul, int8_matmul_reference
    from unionml_tpu_torch.ops.quant import dequantize, quantize_array

    g = torch.Generator(device="cuda").manual_seed(19)
    rows, worst = {}, 0.0
    for label, k_dim, f_dim in INT8_SHARDS:
        qt = quantize_array(torch.randn(k_dim, f_dim, device="cuda", generator=g) * k_dim ** -0.5)
        w_bf16 = dequantize(qt, torch.bfloat16)
        for m in (4, 256):
            x = torch.randn(m, k_dim, device="cuda", generator=g).to(torch.bfloat16)
            out = int8_matmul(x, qt.q, qt.scale)
            torch.cuda.synchronize()
            ref = int8_matmul_reference(x, qt.q, qt.scale)
            atol, rtol = TOLERANCE["torch.bfloat16"]
            err = (out.float() - ref.float()).abs()
            require(bool((err <= atol + rtol * ref.float().abs()).all()),
                    f"int8_matmul disagrees with its twin at the shard shape [{k_dim}, {f_dim}], M={m}")
            worst = max(worst, err.max().item())
            ms = time_ms(lambda: int8_matmul(x, qt.q, qt.scale))
            plain_ms = time_ms(lambda: int8_matmul_reference(x, qt.q, qt.scale))
            library_ms = time_ms(lambda: x @ w_bf16)
            bms, bound_by = int8_bound_ms(m, k_dim, f_dim, 2, 2)
            rows[f"{label} [{k_dim}, {f_dim}] M={m}"] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                                                             bound_ms=bms, bound_by=bound_by,
                                                             max_abs_err=err.max().item())
            print(f"phase 15: int8_matmul shard {label} [{k_dim}, {f_dim}] M={m}: max_abs_err "
                  f"{err.max().item():.3g} ok; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, cuBLAS bf16 "
                  f"{library_ms:.4f} ms, bound {bms:.4f} ms ({bound_by}), {bms / ms:.1%} of bound", flush=True)
        del qt, w_bf16
        torch.cuda.empty_cache()
    return dict(max_abs_err=worst, shards=rows)


def mesh_phase(card: str, gcfg, prompts, slots: int, decode_chunk: int, bf16_streams) -> dict:
    """Phase 15: the serving mesh. (a) a world of one over NCCL at full
    width; (b) two ranks on cuda:0 over gloo, each holding half the weights,
    at MESH_SERVE_LAYERS of the 32 layers: bf16 model=2 streams (first-token
    logits within MESH_LOGITS_REL_RMS of the unsharded run at that depth,
    paged launches 8 x 8 a dispatch on each rank with 16 query and 4 KV
    heads a rank, one launch on each rank's live pool equal to the twin, the
    controller's host time a decode step), int8 at model=2 (57 int8
    launches a forward on each rank), sp_prefill="ring" at sequence=2 on a
    2048-token prompt, MoEConfig() at expert=2, a speculative engine with
    the 1B-shaped draft at model=2 (the draft's paged launches exact on each
    rank at 16/4 heads, D = 64); and the same five in f32 at 2 layers, TF32
    off, each equal token for token to the unsharded card run (the
    speculative one to the target-only run too; the ranks run these first,
    beside the parent's references, and the timed bf16 cases after them).
    The int8 kernel runs
    at each rank's weight shapes against its twin, timed."""
    import multiprocessing
    import shutil
    import tempfile

    from unionml_tpu_torch import _build

    t_phase = time.perf_counter()
    _build.build_all()  # built once here, before any rank starts: ranks load the libraries, never race nvcc
    gc.collect()
    world1 = mesh_world1_phase(card, gcfg, prompts, slots, decode_chunk, bf16_streams)
    shards = int8_shard_phase()
    cases = mesh_cases(prompts, gcfg)
    logits = [t.cpu() for t in world1["logits"]]
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    store = tempfile.mktemp(prefix="chip_smoke_mesh_")
    aot_dir = tempfile.mkdtemp(prefix="chip_smoke_mesh_aot_")
    refs_done = ctx.Event()
    procs = [ctx.Process(target=mesh_rank, args=(r, store, cases, decode_chunk, logits, out, refs_done, aot_dir))
             for r in range(MESH_RANKS)]
    for p in procs:
        p.start()
    results, errors = {}, []
    try:
        # the f32 cases' unsharded runs (card and CPU) while the ranks run their f32 cases; the ranks start the
        # timed bf16 cases only once these are done, so those times share the card and the host with nothing
        t_ref = time.perf_counter()
        expected = {}
        try:
            for case in cases:
                if case["f32"] and case["name"] != "sp32":
                    expected[case["name"]] = mesh_expected(case, decode_chunk)
        finally:
            refs_done.set()
        expected["sp32"] = expected["tp32"]  # the same weights, knobs and prompts, prefilled plainly
        print(f"phase 15b: the f32 references took {time.perf_counter() - t_ref:.1f} s beside the ranks' f32 "
              f"cases; the bf16 cases started after them", flush=True)
        deadline = time.monotonic() + 900
        while len(results) + len(errors) < MESH_RANKS and time.monotonic() < deadline:
            try:
                rank, ok, value = out.get(timeout=5)
            except Exception:  # queue.Empty: look for a rank that died without a word
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    errors.append(f"a rank exited with {dead} before reporting")
                continue
            (results.__setitem__(rank, value) if ok else errors.append(f"rank {rank}:\n{value}"))
    finally:
        for p in procs:
            p.join(timeout=60 if not errors else 5)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        shutil.rmtree(aot_dir, ignore_errors=True)
    require(not errors and len(results) == MESH_RANKS, "phase 15b failed:\n" + "\n".join(errors))
    r0 = results[0]
    tp = r0["tp"]
    print(f"phase 15b: {MESH_RANKS} ranks on cuda:0 over gloo, Llama-3-8B width bf16 at {MESH_SERVE_LAYERS} of its "
          f"32 layers, model=2: {len(prompts) * MAX_NEW / tp['seconds']:.1f} tok/s aggregate (world of 1 at 32 layers: "
          f"{world1['tok_s']:.1f}), TTFT p50 {tp['ttft_p50']} ms (world of 1 at 32 layers: {world1['ttft_p50']} ms), "
          f"decode dispatch p50 "
          f"{tp['tbt_p50']} ms; rank 0's controller: {tp['host_ms_per_step']:.3f} ms host (thread CPU) and "
          f"{tp['wall_ms_per_step']:.3f} ms wall a decode step; gloo host transfers "
          f"{[results[r]['tp']['transfers'] for r in range(MESH_RANKS)]} a rank over the served run; memory "
          f"{[round(results[r]['tp']['memory_gib'], 2) for r in range(MESH_RANKS)]} GiB a rank; card {card}",
          flush=True)
    print(f"phase 15b: bf16 first-token logits, model=2 against the world of 1: relative RMS "
          f"{[round(x, 5) for x in tp['logits_rel_rms']]} (bound {MESH_LOGITS_REL_RMS:.4f}), argmax equal "
          f"{tp['argmax_equal']} of {len(prompts)}", flush=True)
    failed = []  # every line prints before the phase fails on any of them

    def check(condition: bool, what: str) -> None:
        if not condition:
            failed.append(what)

    check(all(x <= MESH_LOGITS_REL_RMS for x in tp["logits_rel_rms"]), "model=2 bf16 logits outside the bound")
    for r in range(MESH_RANKS):
        res = results[r]["tp"]
        expected_launches = MESH_SERVE_LAYERS * decode_chunk * tp["dispatches"]
        print(f"phase 15b rank {r}: local heads {res['heads']} (query, KV), paged launches {res['paged']} "
              f"(expected {MESH_SERVE_LAYERS} x {decode_chunk} x {tp['dispatches']} dispatches = {expected_launches}); "
              f"one launch on "
              f"its live layer-0 pool {res['pool_shape']}: max_abs_err {res['pool_err']:.3g} "
              f"{'ok' if res['pool_ok'] else 'FAIL'}", flush=True)
        check(res["heads"] == (16, 4), f"rank {r} holds heads {res['heads']}, expected (16, 4)")
        check(res["paged"] == expected_launches > 0, f"rank {r}: {res['paged']} paged launches")
        check(res["pool_ok"] and res["pool_launches"] == 1, f"rank {r}: the paged kernel on its pool failed")
        int8 = results[r]["int8"]
        forwards = r0["int8"]["admissions"] + r0["int8"]["dispatches"] * decode_chunk
        print(f"phase 15b rank {r}: int8 launches {int8['int8']} (expected {MESH_INT8_PER_FORWARD} x {forwards} "
              f"forwards = {MESH_INT8_PER_FORWARD * forwards})", flush=True)
        check(int8["int8"] == MESH_INT8_PER_FORWARD * forwards, f"rank {r}: {int8['int8']} int8 launches")
    for name in ("int8", "sp", "moe"):
        res = r0[name]
        toks = [t for s in res["streams"] for t in s]
        print(f"phase 15b {name} ({cases[[c['name'] for c in cases].index(name)]['spec']}): "
              f"{len(toks) / res['seconds']:.1f} tok/s, TTFT p50 {res['ttft_p50']} ms, memory "
              f"{[round(results[r][name]['memory_gib'], 2) for r in range(MESH_RANKS)]} GiB a rank, gloo host "
              f"transfers {[results[r][name]['transfers'] for r in range(MESH_RANKS)]}, int8 launches "
              f"{[results[r][name]['int8'] for r in range(MESH_RANKS)]}", flush=True)
        check(toks and all(0 <= t < 128256 for t in toks), f"phase 15b {name}: tokens out of range")
    spec = r0["spec"]
    toks = [t for s in spec["streams"] for t in s]
    print(f"phase 15b spec (model=2, the 1B-shaped draft at {MESH_DRAFT_LAYERS} of its 16 layers, seed {DRAFT_SEED}, "
          f"gamma {GAMMA}, beside the bf16 target at {MESH_SERVE_LAYERS} layers): {len(toks) / spec['seconds']:.1f} "
          f"tok/s, TTFT p50 {spec['ttft_p50']} ms, {spec['rounds']} rounds, acceptance rate "
          f"{spec['acceptance']} ({spec['accepted']} of {spec['proposed']} proposals that had room); rank 0's "
          f"controller {spec['cpu_s'] * 1e3 / spec['timed_rounds']:.3f} ms host (thread CPU) and "
          f"{spec['wall_s'] * 1e3 / spec['timed_rounds']:.3f} ms wall a round, "
          f"{spec['round_transfers'] / spec['timed_rounds']:.1f} gloo host transfers a round; memory {[round(results[r]['spec']['memory_gib'], 2) for r in range(MESH_RANKS)]} "
          f"GiB a rank; card {card}", flush=True)
    check(toks and all(0 <= t < 128256 for t in toks), "phase 15b spec: tokens out of range")
    for r in range(MESH_RANKS):
        res = results[r]["spec"]
        expected_launches = MESH_DRAFT_LAYERS * (GAMMA + 1) * spec["rounds"]
        print(f"phase 15b spec rank {r}: the draft's local heads {res['heads']} (query, KV), paged launches "
              f"{res['paged']} (expected {MESH_DRAFT_LAYERS} draft layers x {GAMMA + 1} x {spec['rounds']} rounds = "
              f"{expected_launches}); one launch on its live draft layer-0 pool {res['pool_shape']}: max_abs_err "
              f"{res['pool_err']:.3g} {'ok' if res['pool_ok'] else 'FAIL'}", flush=True)
        check(res["heads"] == (16, 4), f"rank {r}'s draft holds heads {res['heads']}, expected (16, 4)")
        check(res["paged"] == expected_launches > 0, f"rank {r}: {res['paged']} paged launches under the draft")
        check(res["pool_ok"] and res["pool_launches"] == 1, f"rank {r}: the paged kernel on the draft pool failed")
    for name, res in ((c["name"], results[r][c["name"]]) for c in cases for r in range(MESH_RANKS)):
        off = {k: n for k, n in res["launches"].items() if k in OFF_MESH_PATH}
        check(not any(off.values()), f"phase 15b {name}: kernels off the mesh path launched: {off}")
    tp_launches = {k: sum(r0[c["name"]]["launches"][k] for c in cases) for k in r0["tp"]["launches"]}
    print(f"phase 15b: rank 0's launches over the {len(cases)} served runs {tp_launches}; on every rank and case "
          f"{sorted(OFF_MESH_PATH)} counted 0 {'(ok)' if not failed else ''}", flush=True)
    # spec32 against the unsharded speculative run, and against the target-only engine (tp32's reference)
    for name, reference, label in (*((n, n, "the unsharded card run") for n in ("tp32", "int832", "sp32", "moe32",
                                                                             "spec32")),
                                   ("spec32", "tp32", "the unsharded target-only card run")):
        card_streams = expected[reference]["streams"]
        got = r0[name]["streams"]
        equal = got == card_streams
        print(f"phase 15b {name}: f32 streams on the mesh {'equal' if equal else 'DIFFERENT'} to {label}", flush=True)
        check(equal, f"phase 15b {name} against {label}: {got} / {card_streams}")
    # a greedy stream is the target's whatever the draft proposes; the counters show a wrongly cut draft
    spec32 = r0["spec32"]
    got, want = (spec32["rounds"], spec32["accepted"], spec32["proposed"]), expected["spec32"]["spec"]
    had_room = spec32["accepted"] / max(spec32["proposed"], 1)
    print(f"phase 15b spec32: the target as its own draft at model=2, one stream at a time: (rounds, accepted, "
          f"proposed) {got} on the mesh, {want} unsharded; {had_room:.3f} of the proposals that had room accepted "
          f"(at least {SPEC32_ACCEPTANCE}; acceptance rate {spec32['acceptance']:.3f} of rounds x gamma)", flush=True)
    check(got == want, f"phase 15b spec32: speculative counters {got} on the mesh, {want} unsharded")
    check(had_room >= SPEC32_ACCEPTANCE, f"phase 15b spec32: {had_room} of the proposals that had room accepted")
    aot_mesh_launches = mesh_aot_checks(card, results, {c["name"]: c for c in cases}, decode_chunk, check)
    require(not failed, "phase 15b: " + "; ".join(failed))
    seconds = time.perf_counter() - t_phase
    print(f"phase 15 took {seconds:.1f} s", flush=True)
    return dict(tp_launches=tp_launches, shards=shards, spec_mesh_launches=spec["paged"],
                aot_mesh_launches=aot_mesh_launches)


def mesh_aot_checks(card: str, results: dict, cases: dict, decode_chunk: int, check) -> dict:
    """Phase 15b's graph-route cases against their eager cases: print each
    route's numbers beside the eager engine's, ``check`` every requirement,
    and return rank 0's launches over the served runs of the hits (bf16 and
    int8): ``aot_mesh_launches`` on the kernels line."""
    r0 = results[0]
    for name, routes in MESH_AOT_CASES:
        eager, case = r0[name], cases[name]
        for route in routes:
            key = f"{name}_aot_{route}"
            run = r0[key]
            toks = sum(len(s) for s in run["streams"])
            line = (f"phase 15b aot {name} ({case['spec']}, {'f32' if case['f32'] else 'bf16'}) {route}: warmup() "
                    f"{run['warmup_s']:.2f} s; {toks / run['seconds']:.1f} tok/s (eager "
                    f"{sum(len(s) for s in eager['streams']) / eager['seconds']:.1f}), TBT p50 {run['tbt_p50']} ms "
                    f"(eager {eager['tbt_p50']}), TTFT p50 {run['ttft_p50']} ms (eager {eager['ttft_p50']}); rank 0's "
                    f"controller {run['host_ms_per_step']:.3f} ms host and {run['wall_ms_per_step']:.3f} ms wall a "
                    f"decode step")
            if "host_ms_per_step" in eager:
                line += (f" (eager {eager['host_ms_per_step']:.3f} / {eager['wall_ms_per_step']:.3f}), gloo transfers "
                         f"a dispatch {run['dispatch_transfers']} (eager {eager['dispatch_transfers']})")
            line += (f"; programs {[results[r][key]['aot'] for r in range(MESH_RANKS)]}; graphs (segments, "
                     f"collectives) a program {run['programs']}")
            if route == "miss":
                line += f"; entries (program, segments, collectives, capture ms) {run['entries']}"
            else:
                line += (f"; fresh captures {[results[r][key]['traces'] for r in range(MESH_RANKS)]}, nvcc runs "
                         f"{[results[r][key]['nvcc_runs'] for r in range(MESH_RANKS)]}, libraries installed into "
                         f"the empty build cache {run['installed']}")
            print(line + f"; memory {[round(results[r][key]['memory_gib'], 2) for r in range(MESH_RANKS)]} GiB a "
                  f"rank; card {card}", flush=True)
            check(run["streams"] == eager["streams"], f"phase 15b aot {name} {route}: streams differ from eager")
            for r in range(MESH_RANKS):
                mine, theirs = results[r][key], results[r][name]
                aot = mine["aot"]
                # each kernel's launches per dispatch on the graph route equal the eager engine's on each rank
                check(mine["paged"] * eager["dispatches"] == theirs["paged"] * run["dispatches"],
                      f"phase 15b aot {name} {route} rank {r}: {mine['paged']} paged launches over "
                      f"{run['dispatches']} dispatches, eager {theirs['paged']} over {eager['dispatches']}")
                if case.get("quantize") == "int8":
                    forwards = len(case["prompts"]) + run["dispatches"] * decode_chunk
                    check(mine["int8"] == MESH_INT8_PER_FORWARD * forwards,
                          f"phase 15b aot {name} {route} rank {r}: {mine['int8']} int8 launches")
                off = {k: n for k, n in mine["launches"].items() if k in OFF_MESH_PATH}
                check(not any(off.values()), f"phase 15b aot {name} {route} rank {r}: off-path launches {off}")
                if route == "miss":
                    check(aot["programs_compiled"] > 0 and aot["programs_loaded"] == 0,
                          f"phase 15b aot {name} miss rank {r}: {aot}")
                else:
                    check(aot["programs_compiled"] == 0 and aot["programs_loaded"] > 0 and mine["traces"] == (0, 0)
                          and mine["nvcc_runs"] == 0, f"phase 15b aot {name} hit rank {r}: {aot}, captures "
                          f"{mine['traces']}, nvcc {mine['nvcc_runs']}")
                    check(any(n.startswith("libpaged_decode_attention-") for n in mine["installed"]),
                          f"phase 15b aot {name} hit rank {r}: installed {mine['installed']}")
                # every program is its graphs and the collectives between them; some program of each case is cut
                graphs = [g for per in mine["programs"].values() for g in per]
                check(graphs and all(segments == collectives + 1 for segments, collectives in graphs)
                      and any(collectives for _, collectives in graphs),
                      f"phase 15b aot {name} {route} rank {r}: programs {mine['programs']}")
            if "dispatch_transfers" in eager:
                check(run["dispatch_transfers"] == eager["dispatch_transfers"] > 0
                      and run["dispatch_paged"] == eager["dispatch_paged"] > 0,
                      f"phase 15b aot {name} {route}: a hand-driven dispatch's transfers / paged launches "
                      f"{run['dispatch_transfers']} / {run['dispatch_paged']}, eager {eager['dispatch_transfers']} / "
                      f"{eager['dispatch_paged']}")
    hits = [f"{name}_aot_hit" for name, routes in MESH_AOT_CASES if "hit" in routes]
    launches = {k: sum(r0[key]["launches"][k] for key in hits) for k in r0[hits[0]]["launches"]}
    print(f"phase 15b aot: rank 0's launches over the hits' served runs {launches} (aot_mesh_launches)", flush=True)
    return launches


#: phase 16: parallel training on the card. (a) phase 5's configuration through fit over a world of one
#: (MeshSpec(data=1), NCCL) for WORLD1_STEPS of its batches; (b) two ranks on cuda:0 over gloo at Llama-3-8B
#: width, MESH_TRAIN_LAYERS deep, MESH_TRAIN_STEPS steps of a global batch of MESH_TRAIN_ROWS x MESH_TRAIN_SEQ
#: under each layout (make_train_step(remat=True)); (c) f32 parity at 2 layers; (d) PipelinedViT at ViT-L/16 width
#: at pipe=2. (b) is cut from 32 layers to 8, then to 4 to make room for phases 19-20: fsdp=2 gathers every
#: layer's f32 weights through gloo's host route, which took 56 s a step at 32 layers (H100 80GB HBM3, 700 W);
#: each layer's shapes and shards are the same
WORLD1_STEPS = 3
MESH_TRAIN_STEPS, MESH_TRAIN_ROWS, MESH_TRAIN_SEQ, MESH_TRAIN_LAYERS = 2, 2, 1024, 4
MESH_TRAIN_LAYOUTS = (("fsdp2", dict(fsdp=2)), ("model2", dict(model=2)))
#: (b): bf16 losses of a mesh run against the world of one, relative. The layouts round to bf16 at other places
#: (model=2 sums two bf16 partials of each row-parallel product; fsdp=2 runs another cuBLAS kernel for a local
#: batch of one row): each place differs by at most one rounding, 2^-9 = 1.95e-3 relative, independently at each
#: of the 2 x 1024 positions the loss averages, so by about 2^-9 / sqrt(2048) = 4.3e-5 a place; ten such places
#: give 4.3e-4. Read on an H100 80GB HBM3 at 700 W: 8.3e-6 to 2.1e-5 (fsdp=2) and 3.8e-5 (model=2)
MESH_TRAIN_LOSS_REL = 5e-4
#: (b): each rank's LoRA gradient shards of the last step (reduced: what the optimizer took) and its adapters'
#: moves over the run, against the world of one's cut to the rank's shard, as the relative L2 error over all
#: MESH_TRAIN_LAYERS x 7 adapter pairs. Gradients: a layout that rounds to bf16 at other places moves each backward activation
#: by about one rounding (2^-9), and a leaf's gradient sums those over the batch's positions: 1-3e-2 read on the
#: H100 (2 and 32 layers); a gradient scaled by 2 errs by 0.5, one not summed over a batch axis or taken from
#: another shard by more. Moves: Adam's first steps are about lr x sign(g), so a share f of elements whose sign
#: differs errs by about 2 sqrt(f): the bound is f = 6 %; bf16 flips the signs of the near-zero gradients (1.4 %
#: at model=2 on the H100), a gradient not summed over fsdp=2 about a quarter of them, another shard's half
MESH_TRAIN_GRAD_REL, MESH_TRAIN_MOVE_REL = 0.1, 0.5
#: (d): bf16 losses of the pipelined ViT against the unpipelined one, relative (the training parity's bound)
VIT_MESH_LOSS_REL = BF16_PARITY_LOSS_REL
MESH_TRAIN_MEMORY_GIB = 30  # (b): predicted peak memory a rank (half the f32 weights, 5.2 GiB, and its activations)
#: (c): f32, 2 layers, TF32 off: global batch MESH_PARITY_ROWS x PARITY_SEQ for MESH_PARITY_STEPS steps
MESH_PARITY_ROWS, MESH_PARITY_STEPS = 2, 2
MESH_PARITY_CASES = (("data2", dict(data=2), "flash"), ("fsdp2", dict(fsdp=2), "flash"),
                     ("model2", dict(model=2), "flash"), ("sp2", dict(sequence=2), "ring"))
#: (c) pipeline: PipelinedViT at ViT-L width, 2 layers, f32, a batch of 4 images in 2 microbatches; gradients
#: against the sequential runs, relative (the L2 norm of the difference over the leaf's): f32 sums in other orders
PIPE_PARITY_IMAGES, PIPE_PARITY_GRAD_REL = 4, 1e-5
#: (d): ViT-L/16 at pipe=2, n_microbatches=4, a global batch of 32 images (numpy seed 0), 2 Adam steps
VIT_MESH_IMAGES, VIT_MESH_MICRO, VIT_MESH_STEPS, VIT_MESH_LR = 32, 4, 2, 1e-4


def phase5_tokens(vocab: int):
    import numpy as np

    return np.random.RandomState(1).randint(0, vocab, size=(TRAIN_STEPS, TRAIN_SEQ)).astype(np.int64)


def mesh_train_tokens(vocab: int, rows: int, seq: int, seed: int):
    import numpy as np

    return np.random.RandomState(seed).randint(0, vocab, size=(rows, seq)).astype(np.int64)


def lora_leaves(model, grads: bool = False) -> dict:
    """``{name: numpy}`` of ``model``'s LoRA adapters (this rank's shards),
    or of their gradients."""
    return {n: (p.grad if grads else p).detach().float().cpu().numpy() for n, p in model.named_parameters()
            if "lora" in n}


def shard_rel_err(got: dict, want: dict, specs: dict, sizes: dict, coordinate: dict) -> float:
    """The relative L2 error of a rank's shards ``got`` over all leaves,
    against the whole leaves ``want`` cut to the rank's shard."""
    import numpy as np

    from unionml_tpu_torch.parallel.sharding import shard_slices

    err = norm = 0.0
    for name, value in got.items():
        ref = want[name][shard_slices(want[name].shape, specs[name], sizes, coordinate)]
        err += float(np.sum((value.astype(np.float64) - ref) ** 2))
        norm += float(np.sum(ref.astype(np.float64) ** 2))
    return (err / max(norm, 1e-300)) ** 0.5


def train_world1_phase(card: str, phase5_losses: list) -> dict:
    """Phase 16a: phase 5's configuration (Llama-3-8B width, LoRA rank 8,
    bf16 compute, f32 params, seed 0, 1 x 2048, no remat) through
    ``fit(config=TrainerConfig(mesh=MeshSpec(data=1), partition_rules=
    llama_partition_rules()))``, a world of one over NCCL, on phase 5's
    first WORLD1_STEPS batches: its losses must equal phase 5's, and the
    flash kernels launch 32 forward and 32 backward a step. Then, from the
    same initial weights, the world of one's losses on (b)'s global batches,
    which (b)'s ranks are held to."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from unionml_tpu_torch import LlamaConfig, TrainerConfig, fit, make_train_step
    from unionml_tpu_torch.models import chunked_causal_lm_loss, llama_partition_rules
    from unionml_tpu_torch.parallel import MeshSpec

    cfg = LlamaConfig.llama3_8b(lora_rank=8, attention_impl="flash", remat=TRAIN_REMAT)
    order = np.random.default_rng(0).permutation(TRAIN_STEPS)[:WORLD1_STEPS]  # fit's seeded schedule in phase 5
    tokens = phase5_tokens(cfg.vocab_size)[order]
    torch.cuda.reset_peak_memory_stats()
    state = lora_llama(cfg, seed=0)
    initial = {n: p.detach().clone() for n, p in state.model.named_parameters() if "lora" in n}
    step = make_train_step(lambda model, batch: chunked_causal_lm_loss(model, batch))
    config = TrainerConfig(mesh=MeshSpec(data=1), partition_rules=llama_partition_rules(), batch_size=1,
                           shuffle=False, log_every_steps=1)
    reset_counts()
    result = fit(state, step, tokens, config)
    launches = all_launches()
    require(dist.get_backend() == "nccl" and dist.get_world_size() == 1, f"16a ran over {dist.get_backend()}")
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in result.history]
    want = phase5_losses[:WORLD1_STEPS]
    expected = {**{k: 0 for k in launches}, "flash_forward": cfg.n_layers * WORLD1_STEPS,
                "flash_backward": cfg.n_layers * WORLD1_STEPS}
    sps = result.samples_per_sec
    print(f"phase 16a: fit over MeshSpec(data=1), a world of one over NCCL, phase 5's configuration: losses {losses} "
          f"(phase 5's first {WORLD1_STEPS}: {want}; {'equal' if losses == want else 'DIFFERENT'}); {sps:.4f} "
          f"samples/s, {1e3 / sps if sps else float('nan'):.1f} ms/step; peak memory {peak / 2**30:.2f} GiB "
          f"(max_memory_allocated); flash launches {launches} (expected {expected}: 32 x 32 / 8 heads a step); "
          f"card {card}", flush=True)
    require(losses == want, f"16a losses {losses} != phase 5's {want}")
    require(launches == expected, f"16a flash launches {launches}, expected {expected}")

    # (b)'s reference: (b)'s depth and initial weights on (b)'s global batches
    del state, initial
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(cfg, n_layers=MESH_TRAIN_LAYERS)
    state = lora_llama(cfg, seed=0)
    initial = {n: p.detach().clone() for n, p in state.model.named_parameters() if "lora" in n}
    rows = MESH_TRAIN_STEPS * MESH_TRAIN_ROWS
    batches = mesh_train_tokens(cfg.vocab_size, rows, MESH_TRAIN_SEQ, 7)
    remat = make_train_step(lambda model, batch: chunked_causal_lm_loss(model, batch), remat=True)
    torch.cuda.reset_peak_memory_stats()
    ref = fit(state, remat, batches, TrainerConfig(mesh=MeshSpec(data=1), partition_rules=llama_partition_rules(),
                                                   batch_size=MESH_TRAIN_ROWS, shuffle=False, log_every_steps=1))
    ref_losses = [h["loss"] for h in ref.history]
    ref_sps = ref.samples_per_sec
    # what (b)'s ranks are held to: the last step's LoRA gradients (what the optimizer took) and the moves
    ref_grads = lora_leaves(state.model, grads=True)
    ref_moves = {n: v - initial[n].float().cpu().numpy() for n, v in lora_leaves(state.model).items()}
    print(f"phase 16a: the world of one on (b)'s {MESH_TRAIN_STEPS} global batches of {MESH_TRAIN_ROWS} x "
          f"{MESH_TRAIN_SEQ} (remat): losses {ref_losses}, {ref_sps:.4f} samples/s, "
          f"{1e3 * MESH_TRAIN_ROWS / ref_sps if ref_sps else float('nan'):.1f} ms/step, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    del state, result, ref, initial
    dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    return dict(losses=losses, sps=sps, peak_gib=peak / 2**30, launches=launches, ref_losses=ref_losses,
                ref_ms=1e3 * MESH_TRAIN_ROWS / ref_sps if ref_sps else float("nan"), tokens=batches,
                ref_grads=ref_grads, ref_moves=ref_moves)


def hold_flash_local(shapes) -> float:
    """Each flash kernel against its twin at the local shapes the mesh path
    gives it (``(label, B, L, H, Hkv, dtype)``, causal, D = 128): out, lse,
    dq, dk, dv within FLASH_TOLERANCE. Returns the worst error."""
    import torch

    from unionml_tpu_torch.ops.flash_attention import (
        flash_backward, flash_backward_f32, flash_backward_reference, flash_forward, flash_forward_f32,
        flash_forward_reference,
    )

    worst = 0.0
    for label, batch, length, heads, kv, dtype in shapes:
        g = torch.Generator(device="cuda").manual_seed(heads * 7 + batch)
        q, dout = (torch.randn(batch, length, heads, 128, device="cuda", generator=g).to(dtype) for _ in range(2))
        k, v = (torch.randn(batch, length, kv, 128, device="cuda", generator=g).to(dtype) for _ in range(2))
        f32 = dtype == torch.float32
        forward, backward = (flash_forward_f32, flash_backward_f32) if f32 else (flash_forward, flash_backward)
        out, lse = forward(q, k, v, True)
        ref_out, ref_lse = flash_forward_reference(q, k, v, True)
        delta = torch.einsum("blhd,blhd->bhl", dout.float(), ref_out.float())
        grads = backward(q, k, v, dout, ref_lse, delta, True)
        refs = flash_backward_reference(q, k, v, dout, ref_lse, delta, True)
        atol, rtol = FLASH_TOLERANCE[str(dtype)]
        errs = []
        for what, got, ref in zip(("out", "lse", "dq", "dk", "dv"), (out, lse, *grads), (ref_out, ref_lse, *refs)):
            err = (got.float() - ref.float()).abs()
            require(bool((err <= atol + rtol * ref.float().abs()).all()), f"flash {label}: {what} disagrees")
            errs.append(err.max().item())
            worst = max(worst, err.max().item())
        print(f"phase 16: flash kernels at {label} (B={batch}, L={length}, H={heads}, Hkv={kv}, D=128, {dtype}, "
              f"causal) against their twins: max_abs_err out/lse/dq/dk/dv {[f'{e:.3g}' for e in errs]} ok",
              flush=True)
    return worst


def vit_from_pipelined_state(tree, layers_per_stage: int) -> dict:
    """The unpipelined ViT's state dict from a PipelinedViT params tree: the
    stacked stage ``s``'s ``layer_i`` is layer ``s * layers_per_stage + i``."""
    state = {}

    def walk(node, prefix, out):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.", out)
            else:
                out[f"{prefix}{k}"] = v

    walk(tree["embed"], "embed.", state)
    walk(tree["head"], "head.", state)
    stages = {}
    walk(tree["stages"], "", stages)
    for name, stacked in stages.items():
        layer, rest = name.split(".", 1)
        for s in range(stacked.shape[0]):
            state[f"layer_{s * layers_per_stage + int(layer.split('_')[1])}.{rest}"] = stacked[s]
    return state


def vit_images(n: int, seed: int, image_size: int = 224, classes: int = 1000):
    import numpy as np

    rng = np.random.RandomState(seed)
    return (rng.randn(n, image_size, image_size, 3).astype(np.float32),
            rng.randint(0, classes, size=n).astype(np.int64))


def vit_mesh_reference() -> dict:
    """Phase 16d's reference: the unpipelined ``ViT`` at ``ViTConfig.large()``
    on the PipelinedViT's weights (from a cuda generator, seed 0), the same
    32 images and Adam steps."""
    import torch
    import torch.nn.functional as F

    from unionml_tpu_torch.models import PipelinedViT, ViT, ViTConfig

    cfg = ViTConfig.large()
    pipelined = PipelinedViT(cfg, n_stages=MESH_RANKS, n_microbatches=VIT_MESH_MICRO)
    tree = pipelined.init(torch.Generator(device="cuda").manual_seed(0))
    vit = ViT(cfg)
    vit.load_state_dict(vit_from_pipelined_state(tree, pipelined.layers_per_stage))
    del tree
    images, labels = (torch.from_numpy(a).cuda() for a in vit_images(VIT_MESH_IMAGES, 0))
    opt = torch.optim.Adam(vit.parameters(), lr=VIT_MESH_LR)
    losses, seconds = [], []
    for _ in range(VIT_MESH_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = F.cross_entropy(vit(images).float(), labels)
        loss.backward()
        opt.step()
        losses.append(loss.item())
        seconds.append(time.perf_counter() - t0)
    del vit, opt
    gc.collect()
    torch.cuda.empty_cache()
    return dict(losses=losses, images_s=VIT_MESH_IMAGES / seconds[-1])


def parity_llama_config(impl: str):
    import torch

    from unionml_tpu_torch import LlamaConfig

    return LlamaConfig.llama3_8b(n_layers=2, lora_rank=8, attention_impl=impl, dtype=torch.float32,
                                 param_dtype=torch.float32)


def mesh_parity_reference(device: str) -> dict:
    """Phase 16c's unsharded runs: the 2-layer f32 LoRA Llama (weights from a
    cuda generator, seed 2, copied to ``device``) through ``fit`` on the
    global batches, and the 2-layer f32 PipelinedViT's loss and gradients
    through the sequential stages (seed 3)."""
    import torch
    import torch.nn.functional as F

    from unionml_tpu_torch import Llama, TrainerConfig, TrainState, fit, make_train_step
    from unionml_tpu_torch.models import PipelinedViT, ViTConfig, chunked_causal_lm_loss, lora_optimizer
    from unionml_tpu_torch.parallel.pipeline import _flat, tree_map

    cfg = parity_llama_config("flash")
    model = Llama(cfg, seed=2)
    if device == "cpu":
        cpu = Llama(cfg, device="cpu")
        cpu.load_state_dict(model.state_dict())
        model = cpu
    state = TrainState(model, lora_optimizer(model, LR))
    tokens = mesh_train_tokens(cfg.vocab_size, MESH_PARITY_ROWS * MESH_PARITY_STEPS, PARITY_SEQ, 8)
    result = fit(state, make_train_step(lambda m, b: chunked_causal_lm_loss(m, b)), tokens,
                 TrainerConfig(batch_size=MESH_PARITY_ROWS, shuffle=False, log_every_steps=1), device=device)
    adapters = {n: p.detach().cpu().numpy() for n, p in model.named_parameters() if "lora" in n}
    losses = [h["loss"] for h in result.history]
    del state, model, result

    vcfg = ViTConfig.large(n_layers=2, dtype=torch.float32)
    pipelined = PipelinedViT(vcfg, n_stages=MESH_RANKS, n_microbatches=2)
    tree = tree_map(lambda t: t.to(device).requires_grad_(True),
                    pipelined.init(torch.Generator(device="cuda").manual_seed(3)))
    images, labels = (torch.from_numpy(a).to(device) for a in vit_images(PIPE_PARITY_IMAGES, 5))
    loss = F.cross_entropy(pipelined.apply(tree, images).float(), labels)
    loss.backward()
    grads = {path: t.grad.detach().cpu().numpy() for path, t in _flat(tree, sep="/").items()}
    del tree
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    return dict(losses=losses, adapters=adapters, pipe_loss=loss.item(), pipe_grads=grads)


def mesh_parity_case(name: str, spec: dict, impl: str) -> dict:
    """One rank's f32 LoRA fit of phase 16c over ``spec``."""
    import torch

    from unionml_tpu_torch import Llama, TrainerConfig, TrainState, fit, make_train_step
    from unionml_tpu_torch.models import chunked_causal_lm_loss, llama_partition_rules, lora_optimizer
    from unionml_tpu_torch.parallel import MeshSpec
    from unionml_tpu_torch.parallel.sharding import leaf_specs

    cfg = parity_llama_config(impl)
    model = Llama(cfg, seed=2)
    state = TrainState(model, lora_optimizer(model, LR))
    tokens = mesh_train_tokens(cfg.vocab_size, MESH_PARITY_ROWS * MESH_PARITY_STEPS, PARITY_SEQ, 8)
    reset_counts()
    result = fit(state, make_train_step(lambda m, b: chunked_causal_lm_loss(m, b)), tokens,
                 TrainerConfig(mesh=MeshSpec(**spec), partition_rules=llama_partition_rules(),
                               batch_size=MESH_PARITY_ROWS, shuffle=False, log_every_steps=1))
    mesh = model.embed._mesh
    out = dict(losses=[h["loss"] for h in result.history], launches=all_launches(),
               heads=(model.layer_0.attn.q_proj.kernel.shape[1] // 128,
                      model.layer_0.attn.k_proj.kernel.shape[1] // 128),
               adapters={n: p.detach().cpu().numpy() for n, p in model.named_parameters() if "lora" in n},
               specs={k: tuple(v) for k, v in leaf_specs(model).items()}, sizes=dict(mesh.shape),
               coordinate=dict(mesh.coordinate))
    del state, model, result
    gc.collect()
    torch.cuda.empty_cache()
    return out


def pipeline_parity_case() -> dict:
    """One rank's PipelinedViT (2 layers, f32) loss and gradient shards at
    pipe=2 under ``pipelined_vit_partition_rules()`` (``param_specs``)."""
    import torch
    import torch.nn.functional as F

    from unionml_tpu_torch.models import PipelinedViT, ViTConfig, pipelined_vit_partition_rules
    from unionml_tpu_torch.parallel import MeshSpec, shard_pytree
    from unionml_tpu_torch.parallel.pipeline import _flat, tree_map
    from unionml_tpu_torch.parallel.sharding import reduce_scope
    from unionml_tpu_torch.train import reduce_gradients

    vcfg = ViTConfig.large(n_layers=2, dtype=torch.float32)
    pipelined = PipelinedViT(vcfg, n_stages=MESH_RANKS, n_microbatches=2)
    mesh = MeshSpec(pipe=MESH_RANKS).build()
    rules = pipelined_vit_partition_rules()
    tree = pipelined.init(torch.Generator(device="cuda").manual_seed(3))
    shardings = rules.shardings(tree, mesh)
    params = tree_map(lambda t: t.detach().clone().requires_grad_(True), shard_pytree(tree, shardings))
    del tree
    specs = {k: s.spec for k, s in shardings.items()}
    images, labels = (torch.from_numpy(a).cuda() for a in vit_images(PIPE_PARITY_IMAGES, 5))
    with reduce_scope(mesh):
        loss = F.cross_entropy(pipelined.apply(params, images, mesh, rules).float(), labels)
        loss.backward()
        reduce_gradients(params, specs)
    return dict(loss=loss.item(), grads={p: t.grad.cpu().numpy() for p, t in _flat(params, sep="/").items()},
                specs={k: tuple(v) for k, v in specs.items()}, sizes=dict(mesh.shape),
                coordinate=dict(mesh.coordinate))


def mesh_train_case(name: str, spec: dict, tokens) -> dict:
    """One rank's phase 16b layout: Llama-3-8B width, MESH_TRAIN_LAYERS deep, built on the
    meta device and drawn leaf by leaf on the card (each leaf cut to this
    rank's shard as it is drawn: the world of one's draws, and never more
    than one whole f32 leaf beside the shards), LoRA rank 8, bf16 compute,
    ``fit`` over ``spec`` with ``make_train_step(remat=True)``."""
    import torch

    from unionml_tpu_torch import Llama, LlamaConfig, TrainerConfig, TrainState, fit, make_train_step
    from unionml_tpu_torch.models import chunked_causal_lm_loss, llama_partition_rules, lora_optimizer
    from unionml_tpu_torch.models.layers import init_weights
    from unionml_tpu_torch.parallel import MeshSpec
    from unionml_tpu_torch.parallel.collectives import host_route
    from unionml_tpu_torch.parallel.sharding import combine_fsdp_tp, leaf_specs

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mesh = MeshSpec(**spec).build()
    cfg = LlamaConfig.llama3_8b(n_layers=MESH_TRAIN_LAYERS, lora_rank=8, attention_impl="flash")
    model = Llama(cfg, device="meta")
    rules = llama_partition_rules()
    init_weights(model, torch.Generator(device=mesh.device).manual_seed(0),
                 shardings=combine_fsdp_tp(model, mesh, rules), device=mesh.device)
    state = TrainState(model, lora_optimizer(model, LR))
    built = time.perf_counter() - t0
    frozen = model.layer_0.attn.q_proj.kernel.detach().clone()
    adapter = model.layer_0.attn.q_proj.lora_b.detach().clone()
    initial = lora_leaves(model)
    step = make_train_step(lambda m, b: chunked_causal_lm_loss(m, b), remat=True)
    reset_counts()
    host_route.count = 0
    t0 = time.perf_counter()
    result = fit(state, step, tokens, TrainerConfig(mesh=MeshSpec(**spec), partition_rules=rules,
                                                    batch_size=MESH_TRAIN_ROWS, shuffle=False, log_every_steps=1))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    sps = result.samples_per_sec
    mesh = model.embed._mesh
    out = dict(losses=[h["loss"] for h in result.history], launches=all_launches(), built_s=built, seconds=seconds,
               sps=sps, sps_per_chip=result.samples_per_sec_per_chip,
               ms_step=1e3 * MESH_TRAIN_ROWS / sps if sps else float("nan"),
               first_step_s=result.compile_time_s, transfers=host_route.count / MESH_TRAIN_STEPS,
               memory_gib=torch.cuda.max_memory_allocated() / 2**30,
               heads=(model.layer_0.attn.q_proj.kernel.shape[1] // 128,
                      model.layer_0.attn.k_proj.kernel.shape[1] // 128),
               shard=tuple(model.layer_0.attn.q_proj.kernel.shape),
               frozen_kept=torch.equal(frozen, model.layer_0.attn.q_proj.kernel),
               adapter_moved=not torch.equal(adapter, model.layer_0.attn.q_proj.lora_b),
               adapter_shard=tuple(adapter.shape), grads=lora_leaves(model, grads=True),
               moves={n: v - initial[n] for n, v in lora_leaves(model).items()},
               specs={k: tuple(v) for k, v in leaf_specs(model).items()}, sizes=dict(mesh.shape),
               coordinate=dict(mesh.coordinate))
    del state, model, result, frozen, adapter, initial
    gc.collect()
    torch.cuda.empty_cache()
    return out


def vit_mesh_case() -> dict:
    """One rank's phase 16d: PipelinedViT at ViT-L/16 width at pipe=2, the
    whole batch on each rank in VIT_MESH_MICRO microbatches, Adam."""
    import torch
    import torch.nn.functional as F

    from unionml_tpu_torch.models import PipelinedViT, ViTConfig, pipelined_vit_partition_rules
    from unionml_tpu_torch.parallel import MeshSpec, shard_pytree
    from unionml_tpu_torch.parallel.collectives import host_route
    from unionml_tpu_torch.parallel.pipeline import _flat, tree_map
    from unionml_tpu_torch.parallel.sharding import reduce_scope
    from unionml_tpu_torch.train import reduce_gradients

    torch.cuda.reset_peak_memory_stats()
    cfg = ViTConfig.large()
    pipelined = PipelinedViT(cfg, n_stages=MESH_RANKS, n_microbatches=VIT_MESH_MICRO)
    mesh = MeshSpec(pipe=MESH_RANKS).build()
    rules = pipelined_vit_partition_rules()
    tree = pipelined.init(torch.Generator(device="cuda").manual_seed(0))
    shardings = rules.shardings(tree, mesh)
    params = tree_map(lambda t: t.detach().clone().requires_grad_(True), shard_pytree(tree, shardings))
    del tree
    specs = {k: s.spec for k, s in shardings.items()}
    leaves = list(_flat(params).values())
    opt = torch.optim.Adam(leaves, lr=VIT_MESH_LR)
    images, labels = (torch.from_numpy(a).cuda() for a in vit_images(VIT_MESH_IMAGES, 0))
    reset_counts()
    host_route.count = 0
    losses, seconds = [], []
    for _ in range(VIT_MESH_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        with reduce_scope(mesh):
            loss = F.cross_entropy(pipelined.apply(params, images, mesh, rules).float(), labels)
            loss.backward()
            reduce_gradients(params, specs)
        opt.step()
        losses.append(loss.item())
        seconds.append(time.perf_counter() - t0)
    stage_leaf = params["stages"]["layer_0"]["attn"]["q_proj"]["kernel"]
    out = dict(losses=losses, images_s=VIT_MESH_IMAGES / seconds[-1], step_s=seconds,
               transfers=host_route.count / VIT_MESH_STEPS, memory_gib=torch.cuda.max_memory_allocated() / 2**30,
               stage_shape=tuple(stage_leaf.shape), launches=all_launches())
    del params, opt, leaves
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_mesh_rank(rank: int, store: str, tokens, out, refs_done) -> None:
    """One of phase 16's two processes, both on cuda:0 over gloo: (c)'s f32
    cases first (beside the parent's references), then, once the parent sets
    ``refs_done``, (b)'s layouts and (d). Puts ``(rank, ok, results or
    traceback)`` on ``out``."""
    try:
        import torch
        import torch.distributed as dist

        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False  # the parent's setting since phase 4
        torch.backends.cudnn.allow_tf32 = False
        dist.init_process_group("gloo", store=dist.FileStore(store, MESH_RANKS), rank=rank, world_size=MESH_RANKS)
        results = {}
        for name, spec, impl in MESH_PARITY_CASES:
            results[name] = mesh_parity_case(name, spec, impl)
        results["pipe2"] = pipeline_parity_case()
        refs_done.wait()
        for name, spec in MESH_TRAIN_LAYOUTS:
            results[name + "_bf16"] = mesh_train_case(name, spec, tokens)
        results["vit"] = vit_mesh_case()
        dist.destroy_process_group()
        foreign = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "unionml_tpu"))
        require(not foreign, f"rank {rank} imported {foreign[:5]}: the port imports neither JAX nor unionml_tpu")
        out.put((rank, True, results))
    except BaseException:
        import traceback

        out.put((rank, False, traceback.format_exc()))


def train_mesh_phase(card: str, phase5_losses: list) -> dict:
    """Phase 16: parallel training on the card. (a) a world of one over NCCL
    (``train_world1_phase``); the flash kernels against their twins at the
    local shapes of (b) and (c); then two ranks on cuda:0 over gloo: (c) f32
    parity at 2 layers (data=2, fsdp=2, model=2, sequence=2 ring LoRA fits,
    and ``pipeline_apply`` at pipe=2 with ``param_specs``) against the
    unsharded card run and the CPU, which this process computes meanwhile;
    (b) Llama-3-8B width, MESH_TRAIN_LAYERS deep, at fsdp=2 and at model=2, 2 steps of a
    2 x 1024 global batch, held to (a)'s world of one; (d) PipelinedViT at
    ViT-L/16 width at pipe=2 held to the unpipelined ViT. Returns the flash
    launches of the path (16a, and rank 0 in (b) and (c))."""
    import multiprocessing
    import tempfile

    import numpy as np
    import torch

    from unionml_tpu_torch import _build

    t_phase = time.perf_counter()
    _build.build_all()
    world1 = train_world1_phase(card, phase5_losses)
    vit_ref = vit_mesh_reference()
    print(f"phase 16d reference: the unpipelined ViT-L/16 on the same weights, {VIT_MESH_IMAGES} images, Adam: "
          f"losses {vit_ref['losses']}, {vit_ref['images_s']:.1f} images/s", flush=True)
    worst = hold_flash_local((
        ("16b fsdp=2, a rank's rows", 1, MESH_TRAIN_SEQ, 32, 8, torch.bfloat16),
        ("16b model=2, a rank's heads", MESH_TRAIN_ROWS, MESH_TRAIN_SEQ, 16, 4, torch.bfloat16),
        ("16c data=2 / fsdp=2, a rank's rows", 1, PARITY_SEQ, 32, 8, torch.float32),
        ("16c model=2, a rank's heads", MESH_PARITY_ROWS, PARITY_SEQ, 16, 4, torch.float32),
    ))
    gc.collect()
    torch.cuda.empty_cache()
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    store = tempfile.mktemp(prefix="chip_smoke_train_mesh_")
    refs_done = ctx.Event()
    procs = [ctx.Process(target=train_mesh_rank, args=(r, store, world1["tokens"], out, refs_done))
             for r in range(MESH_RANKS)]
    for p in procs:
        p.start()
    results, errors = {}, []
    try:
        t_ref = time.perf_counter()
        try:
            refs = {device: mesh_parity_reference(device) for device in ("cuda", "cpu")}
        finally:
            refs_done.set()
        print(f"phase 16c: the unsharded references (card and CPU) took {time.perf_counter() - t_ref:.1f} s beside "
              f"the ranks' f32 cases; (b) and (d) started after them", flush=True)
        deadline = time.monotonic() + 900
        while len(results) + len(errors) < MESH_RANKS and time.monotonic() < deadline:
            try:
                rank, ok, value = out.get(timeout=5)
            except Exception:  # queue.Empty: look for a rank that died without a word
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    errors.append(f"a rank exited with {dead} before reporting")
                continue
            (results.__setitem__(rank, value) if ok else errors.append(f"rank {rank}:\n{value}"))
        if len(results) + len(errors) < MESH_RANKS:
            errors.append("the ranks did not finish within 900 s")
    finally:
        for p in procs:
            p.join(timeout=60 if not errors else 5)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    require(not errors and len(results) == MESH_RANKS, "phase 16 failed:\n" + "\n".join(errors))
    failed = []  # every line prints before the phase fails on any of them

    def check(condition: bool, what: str) -> None:
        if not condition:
            failed.append(what)

    # (c) f32 parity
    from unionml_tpu_torch.parallel.sharding import shard_slices

    max_tol, mean_tol = 2 * LR * MESH_PARITY_STEPS, 1e-3 * LR
    for name, spec, impl in MESH_PARITY_CASES:
        for r in range(MESH_RANKS):
            res = results[r][name]
            line = []
            for device, ref in refs.items():
                loss_err = max(abs(a - b) / abs(b) for a, b in zip(res["losses"], ref["losses"]))
                diffs = np.concatenate([np.abs(v - ref["adapters"][k][shard_slices(
                    ref["adapters"][k].shape, res["specs"][k], res["sizes"], res["coordinate"])]).ravel()
                    for k, v in res["adapters"].items()])
                ok = len(res["losses"]) == MESH_PARITY_STEPS and loss_err <= 1e-5 and diffs.max() <= max_tol \
                    and diffs.mean() <= mean_tol
                line.append(f"{device}: loss rel err {loss_err:.3g}, adapters max {diffs.max():.3g} mean "
                            f"{diffs.mean():.3g} {'ok' if ok else 'FAIL'}")
                check(ok, f"16c {name} rank {r} against the {device} run")
            f32_expected = MESH_PARITY_STEPS * 2 if impl == "flash" else 0
            launches = res["launches"]
            print(f"phase 16c {name} ({spec}, {impl}) rank {r}: losses {res['losses']}; {'; '.join(line)}; local "
                  f"heads {res['heads']}; f32 flash launches {launches['flash_forward_f32']} forward, "
                  f"{launches['flash_backward_f32']} backward (expected {f32_expected} each)", flush=True)
            check(launches["flash_forward_f32"] == launches["flash_backward_f32"] == f32_expected,
                  f"16c {name}: f32 flash launches {launches}")
            check(launches["flash_forward"] == launches["flash_backward"] == 0, f"16c {name}: bf16 flash launched")
            off = {k: n for k, n in launches.items() if k not in FLASH_PRODUCTS and n}
            check(not off, f"16c {name} rank {r}: kernels off the training path launched: {off}")
    print(f"phase 16c: tolerances loss 1e-5 relative, adapters max {max_tol} mean {mean_tol} (phase 6's: Adam's "
          f"step near lr x sign(g) for a tiny gradient)", flush=True)
    for r in range(MESH_RANKS):
        res = results[r]["pipe2"]
        worst_rel = {}
        for device, ref in refs.items():
            loss_err = abs(res["loss"] - ref["pipe_loss"]) / abs(ref["pipe_loss"])
            rel = 0.0
            for path, grad in res["grads"].items():
                want = ref["pipe_grads"][path][shard_slices(ref["pipe_grads"][path].shape, res["specs"][path],
                                                            res["sizes"], res["coordinate"])]
                rel = max(rel, float(np.linalg.norm(grad - want) / max(np.linalg.norm(want), 1e-30)))
            worst_rel[device] = (loss_err, rel)
            check(loss_err <= 1e-5 and rel <= PIPE_PARITY_GRAD_REL, f"16c pipe2 rank {r} against {device}")
        print(f"phase 16c pipe2 rank {r}: PipelinedViT (ViT-L width, 2 layers, f32) through pipeline_apply with "
              f"param_specs: loss {res['loss']:.7g}; (loss rel err, worst gradient rel L2 err) against the card "
              f"{worst_rel['cuda']} and the CPU {worst_rel['cpu']} (bounds 1e-5, {PIPE_PARITY_GRAD_REL})", flush=True)

    # (b) Llama-3-8B width, MESH_TRAIN_LAYERS deep, at fsdp=2 and model=2
    expected_heads = {"fsdp2": (32, 8), "model2": (16, 4)}
    per_step = MESH_TRAIN_LAYERS * MESH_TRAIN_STEPS
    for name, spec in MESH_TRAIN_LAYOUTS:
        for r in range(MESH_RANKS):
            res = results[r][name + "_bf16"]
            rel = max(abs(a - b) / abs(b) for a, b in zip(res["losses"], world1["ref_losses"]))
            expected = {**{k: 0 for k in res["launches"]}, "flash_forward": 2 * per_step, "flash_backward": per_step}
            where = (res["specs"], res["sizes"], res["coordinate"])
            grad_rel = shard_rel_err(res["grads"], world1["ref_grads"], *where)
            move_rel = shard_rel_err(res["moves"], world1["ref_moves"], *where)
            print(f"phase 16b {name} ({spec}) rank {r}: losses {res['losses']} against the world of one "
                  f"{world1['ref_losses']} (max rel err {rel:.3g}, bound {MESH_TRAIN_LOSS_REL}); built on meta and "
                  f"drawn on the card in {res['built_s']:.1f} s; {res['sps']:.4f} samples/s global "
                  f"({res['sps_per_chip']:.4f} a rank), {res['ms_step']:.1f} ms/step (world of one "
                  f"{world1['ref_ms']:.1f}), first step {res['first_step_s']:.1f} s; peak memory "
                  f"{res['memory_gib']:.2f} GiB (predicted under {MESH_TRAIN_MEMORY_GIB}); gloo host transfers "
                  f"{res['transfers']:.0f} a step; local heads {res['heads']} (query, KV); flash launches "
                  f"{res['launches']} (expected {expected}: remat runs each forward twice); layer 0 q_proj kernel "
                  f"shard {res['shard']} {'unchanged' if res['frozen_kept'] else 'CHANGED'}, its lora_b shard "
                  f"{res['adapter_shard']} {'moved' if res['adapter_moved'] else 'DID NOT MOVE'}; against the world "
                  f"of one cut to this rank's shards (relative L2 over every adapter): the last step's LoRA "
                  f"gradients {grad_rel:.3g} (bound {MESH_TRAIN_GRAD_REL}), the adapters' moves {move_rel:.3g} "
                  f"(bound {MESH_TRAIN_MOVE_REL}); card {card}", flush=True)
            check(rel <= MESH_TRAIN_LOSS_REL, f"16b {name} rank {r}: losses off the world of one")
            check(grad_rel <= MESH_TRAIN_GRAD_REL, f"16b {name} rank {r}: LoRA gradients off the world of one")
            check(move_rel <= MESH_TRAIN_MOVE_REL, f"16b {name} rank {r}: adapters off the world of one")
            check(res["heads"] == expected_heads[name], f"16b {name} rank {r}: heads {res['heads']}")
            check(res["launches"] == expected, f"16b {name} rank {r}: flash launches {res['launches']}")
            check(res["frozen_kept"] and res["adapter_moved"], f"16b {name} rank {r}: frozen/adapter check")

    # (d) PipelinedViT at ViT-L/16 width
    for r in range(MESH_RANKS):
        res = results[r]["vit"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(res["losses"], vit_ref["losses"]))
        print(f"phase 16d rank {r}: PipelinedViT ViT-L/16 at pipe=2, {VIT_MESH_MICRO} microbatches of "
              f"{VIT_MESH_IMAGES // VIT_MESH_MICRO}: losses {res['losses']} against the unpipelined ViT "
              f"{vit_ref['losses']} (max rel err {rel:.3g}, bound {VIT_MESH_LOSS_REL}); {res['images_s']:.1f} "
              f"images/s (unpipelined {vit_ref['images_s']:.1f}); step times {[round(s, 3) for s in res['step_s']]} "
              f"s; gloo host transfers {res['transfers']:.0f} a step; peak memory {res['memory_gib']:.2f} GiB; its "
              f"stage's q_proj kernel {res['stage_shape']}; kernel launches {res['launches']} (the plain route: "
              f"197 positions)", flush=True)
        check(rel <= VIT_MESH_LOSS_REL, f"16d rank {r}: losses off the unpipelined ViT")
        check(not any(res["launches"].values()), f"16d rank {r}: a kernel launched on the plain route")

    require(not failed, "phase 16: " + "; ".join(failed))
    r0 = results[0]
    launches = {k: world1["launches"][k] + sum(r0[n + "_bf16"]["launches"][k] for n, _ in MESH_TRAIN_LAYOUTS)
                for k in world1["launches"]}
    f32_launches = {k: sum(r0[n]["launches"][k] for n, _, _ in MESH_PARITY_CASES) for k in world1["launches"]}
    print(f"phase 16: flash launches on the mesh training path (16a + rank 0 of 16b) {launches}; rank 0 of 16c "
          f"{f32_launches}; worst flash error at the local shapes {worst:.3g}", flush=True)
    print(f"phase 16 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return dict(launches=launches, f32_launches=f32_launches, max_abs_err=worst)


#: phase 17 (the cold start): the seeded sampled pair's temperature, and its prompts (phase 3's first two, one
#: after another, so that both engines seed their admissions alike)
AOT_TEMPERATURE, AOT_SAMPLED_PROMPTS = 0.8, 2
#: 17a's depth: phase 3's configuration at 4 of its 32 layers, cut from 32 to 8 to make room for phases 19-20 and
#: to 4 for phase 15b's graph-route cases, which run the graph route at 8 layers over the mesh (a program's capture,
#: replay and the int8 quantization scale with the layers; each layer's programs are the same)
AOT_LAYERS = 4


#: each wrapper's CUDA kernel, by the name a profiler trace gives it (the int8-page mode has two)
KERNEL_SYMBOLS = {"flash_forward": ("flash_forward_kernel",), "flash_backward": ("flash_backward_kernel",),
                  "flash_forward_f32": ("flash_forward_f32_kernel",),
                  "flash_backward_f32": ("flash_backward_f32_kernel",), "int8_matmul": ("int8_matmul_kernel",),
                  "paged_decode_attention": ("paged_decode_kernel",),
                  "paged_decode_attention_int8": ("paged_decode_int8_direct", "paged_decode_int8_mma")}


def traced_launches(by_name: dict) -> dict:
    """Each port kernel's launches in a ``profiled()`` run, counted from the
    trace's kernel events by name: what ran on the device, inside a CUDA
    graph's replay too."""
    import re

    owner = {symbol: name for name, symbols in KERNEL_SYMBOLS.items() for symbol in symbols}
    counts = {name: 0 for name in KERNEL_SYMBOLS}
    for event, (_, calls) in by_name.items():
        # "void (anonymous namespace)::paged_decode_kernel<...>(...)": the function's own name
        head = event.replace("(anonymous namespace)::", "").removeprefix("void ")
        symbol = re.split(r"[<(]", head, maxsplit=1)[0].rsplit("::", 1)[-1].strip()
        if symbol in owner:
            counts[owner[symbol]] += calls
    return counts


def aot_engine_run(gen, prompts, slots: int, decode_chunk: int, aot, threads: bool = True,
                   trace: bool = False) -> dict:
    """One engine over ``gen`` with the AOT store ``aot`` (False: the eager
    route): ``warmup()`` timed, then ``prompts`` served (concurrently, or one
    after another) with every kernel counted from 0; with ``trace``, the same
    prompts served once more under the profiler (its kernel launches by name
    and the device's idle share); the engine is closed."""
    from unionml_tpu_torch import ContinuousBatcher

    engine = ContinuousBatcher(gen, slots=slots, decode_chunk=decode_chunk, block_size=BLOCK, aot=aot)
    traced = idle = None
    try:
        t0 = time.perf_counter()
        engine.warmup()
        warmup_s = time.perf_counter() - t0
        reset_counts()
        if threads:
            streams, seconds = serve(engine, prompts)
        else:
            t0 = time.perf_counter()
            streams = [[int(t) for chunk in engine.submit(p) for t in chunk] for p in prompts]
            seconds = time.perf_counter() - t0
        launches = all_launches()
        stats = engine.stats()
        if trace:
            traced_s, by_name = profiled(lambda: serve(engine, prompts))
            busy_ms = sum(total for total, _ in by_name.values())
            require(busy_ms > 0, "the profiler saw no device time in a served run")
            traced, idle = traced_launches(by_name), 1 - busy_ms / (traced_s * 1e3)
    finally:
        engine.close()
        # an engine sits in reference cycles: collect it now, with the generator, its graphs and its pool
        del engine
        gc.collect()
    return dict(streams=streams, seconds=seconds, launches=launches, stats=stats, warmup_s=warmup_s,
                tok_s=sum(len(s) for s in streams) / seconds, traced=traced, idle=idle)


def aot_route_line(label: str, run: dict) -> str:
    stats = run["stats"]
    return (f"{label}: warmup() {run['warmup_s']:.2f} s, {run['tok_s']:.1f} tok/s, TBT p50 "
            f"{stats['tbt_ms'].get('p50_ms')} ms, TTFT p50 {stats['ttft_ms'].get('p50_ms')} ms")


def aot_phase(card: str, cfg, gcfg, prompts, slots: int, decode_chunk: int) -> dict:
    """Phase 17a: the AOT program store in process, at phase 3's width,
    knobs and prompts, ``AOT_LAYERS`` deep. Three engines over one model, in turn: the
    eager route, ``aot=DIR`` on an empty store (a miss: every program run
    once, captured as a CUDA graph, its entry written) and a fresh
    ``Generator`` and engine on the populated store with the kernel build
    cache pointed at an empty directory (a hit: the libraries installed from
    the store, no ``nvcc``, no fresh capture). Greedy streams on the graph
    route equal the eager route's, and each kernel's launches on it equal the
    eager engine's; a seeded ``temperature=0.8`` pair equal token for token; a
    program that reads a value back on the host fails its capture and
    raises; then the same weights quantized in place serve the eager and
    graph pair under ``quantize="int8"`` (the int8 matmul inside the graphs).
    Prints both routes' TBT, tok/s, TTFT of the first request after
    ``warmup()``, the device's idle share of one served run and the seconds
    of ``warmup()`` on a miss and on a hit."""
    import os
    import shutil
    import tempfile

    import torch

    from unionml_tpu_torch import Generator, Llama, _build
    from unionml_tpu_torch.compile_cache import enable_compile_cache
    from unionml_tpu_torch.serving.aot import AOTFunction, ProgramStore

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    reserved_before = torch.cuda.memory_reserved()
    store = tempfile.mkdtemp(prefix="chip_smoke_aot_")
    cache = tempfile.mkdtemp(prefix="chip_smoke_kernels_")
    build_dir = _build.build_dir()
    try:
        model = Llama(cfg, seed=0)  # phase 3's weights' first AOT_LAYERS layers
        eager = aot_engine_run(Generator(model, gcfg), prompts, slots, decode_chunk, False, trace=True)
        miss_gen = Generator(model, gcfg)
        miss = aot_engine_run(miss_gen, prompts, slots, decode_chunk, store)
        entries = ProgramStore(store).entries()
        enable_compile_cache(cache)
        nvcc_before = _build.nvcc_runs
        hit_gen = Generator(model, gcfg)
        hit = aot_engine_run(hit_gen, prompts, slots, decode_chunk, store, trace=True)
        nvcc_runs = _build.nvcc_runs - nvcc_before
        installed = sorted(os.listdir(cache))
        _build.set_build_dir(build_dir)

        sampled = dataclasses.replace(gcfg, temperature=AOT_TEMPERATURE)
        few = prompts[:AOT_SAMPLED_PROMPTS]
        sampled_eager = aot_engine_run(Generator(model, sampled), few, slots, decode_chunk, False, threads=False)
        sampled_graph = aot_engine_run(Generator(model, sampled), few, slots, decode_chunk,
                                       tempfile.mkdtemp(dir=store), threads=False)

        def reads_back(x):  # a host read inside a program: its capture fails
            return x * float(x.sum())

        refused = None
        try:
            AOTFunction(reads_back, "reads_back", ProgramStore(tempfile.mkdtemp(dir=store)), {})(
                torch.ones(4, device="cuda"))
        except RuntimeError as exc:
            refused = exc
        traces = dict(miss=(miss_gen.prefill_traces, miss_gen.decode_traces),
                      hit=(hit_gen.prefill_traces, hit_gen.decode_traces))
        del model, miss_gen, hit_gen
        gc.collect()
        torch.cuda.empty_cache()

        int8_model = Llama(cfg, seed=0)  # the same weights, quantized in place by the first Generator
        int8_eager = aot_engine_run(Generator(int8_model, gcfg, quantize="int8"), prompts, slots, decode_chunk, False)
        int8_graph = aot_engine_run(Generator(int8_model, gcfg, quantize="int8"), prompts, slots, decode_chunk,
                                    tempfile.mkdtemp(dir=store), trace=True)
        del int8_model
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        _build.set_build_dir(build_dir)
        shutil.rmtree(store, ignore_errors=True)
        shutil.rmtree(cache, ignore_errors=True)
    refused = None if refused is None else repr(refused)  # not the exception: its traceback holds this frame
    gc.collect()
    torch.cuda.empty_cache()
    reserved_after = torch.cuda.memory_reserved()
    graphs = sorted({(e["program"], e["graph"]) for e in entries})
    decode = [e for e in entries if e["program"] == "decode"]
    print(f"phase 17a: {aot_route_line('eager route', eager)}; device idle {eager['idle']:.3f} of a served run "
          f"(profiled)", flush=True)
    print(f"  {aot_route_line('AOT store, miss', miss)}; {miss['stats']['aot']}; entries {graphs}; the decode "
          f"graph's launches a replay {[e['launches'] for e in decode]}, captured in "
          f"{[e['capture_ms'] for e in decode]} ms", flush=True)
    print(f"  {aot_route_line('AOT store, hit', hit)}; device idle {hit['idle']:.3f} of a served run (profiled); "
          f"{hit['stats']['aot']}; fresh captures {traces['hit']} (miss: {traces['miss']}); nvcc runs {nvcc_runs}; "
          f"libraries installed into the empty build cache {installed}", flush=True)
    print(f"  launches in the profiler's trace of a served run: eager {eager['traced']}, graph route (hit) "
          f"{hit['traced']}; counted by the wrappers (the graph route's per replay, a cross-check): eager "
          f"{eager['launches']}, miss {miss['launches']}, hit {hit['launches']}; greedy streams "
          f"equal the eager route's ({cfg.n_layers} layers): miss {miss['streams'] == eager['streams']}, hit "
          f"{hit['streams'] == eager['streams']}; sampled (temperature {AOT_TEMPERATURE}, seeded) graph == eager: "
          f"{sampled_graph['streams'] == sampled_eager['streams']} (launches {sampled_eager['launches']} / "
          f"{sampled_graph['launches']}); a host read refused its capture: {refused!s:.200}", flush=True)
    print(f"  int8: {aot_route_line('eager', int8_eager)}; {aot_route_line('graph', int8_graph)}, device idle "
          f"{int8_graph['idle']:.3f}; launches: the eager engine's wrappers {int8_eager['launches']}, the graph "
          f"route's trace {int8_graph['traced']} (per replay {int8_graph['launches']}); streams equal "
          f"{int8_graph['streams'] == int8_eager['streams']}; memory reserved {reserved_before / 2**30:.2f} GiB before the "
          f"phase, {reserved_after / 2**30:.2f} GiB after it (collected, cache emptied); phase 17a took "
          f"{time.perf_counter() - t_phase:.1f} s; card {card}", flush=True)
    require(all(len(s) == MAX_NEW for s in eager["streams"]), f"phase 17a: eager stream lengths {eager['streams']}")
    for name, run in (("miss", miss), ("hit", hit)):
        require(run["streams"] == eager["streams"], f"phase 17a: the {name} route's greedy streams differ from the "
                                                    "eager route's")
    # the trace counts each kernel as the wrappers do on the eager route, and the graph route launches as it does
    require(eager["traced"] == eager["launches"],
            "phase 17a: the profiler's kernel count differs from the wrappers' on the eager route")
    require(hit["traced"] == eager["launches"] and int8_graph["traced"] == int8_eager["launches"],
            "phase 17a: the graph route's traced launches differ from the eager engine's")
    require(eager["launches"] == miss["launches"] == hit["launches"],
            "phase 17a: the graph route's launches counted per replay differ from the eager engine's")
    require(hit["traced"]["paged_decode_attention"] > 0, "phase 17a: no paged launch on the graph route")
    require(miss["stats"]["aot"]["programs_compiled"] > 0 and miss["stats"]["aot"]["programs_loaded"] == 0
            and miss["stats"]["aot"]["entries"] > 0, f"phase 17a: the empty store's engine {miss['stats']['aot']}")
    require(("decode", True) in graphs and ("prefill", True) in graphs, f"phase 17a: entries {graphs}")
    require(hit["stats"]["aot"]["programs_loaded"] > 0 and hit["stats"]["aot"]["programs_compiled"] == 0,
            f"phase 17a: the populated store's engine {hit['stats']['aot']}")
    require(traces["hit"] == (0, 0) and nvcc_runs == 0,
            "phase 17a: the hit captured afresh or ran nvcc")
    require(any(name.startswith("libpaged_decode_attention-") for name in installed),
            f"phase 17a: the store did not install the paged kernel's library: {installed}")
    require(sampled_graph["streams"] == sampled_eager["streams"]
            and sampled_graph["launches"] == sampled_eager["launches"],
            "phase 17a: the seeded sampled streams differ between the graph and eager routes")
    require(refused is not None and "capture" in refused, "phase 17a: a failed capture did not raise")
    require(reserved_after <= reserved_before + 2**30, "phase 17a: the graphs' memory was not given back")
    require(int8_graph["streams"] == int8_eager["streams"] and int8_graph["launches"] == int8_eager["launches"]
            and int8_graph["traced"]["int8_matmul"] > 0, "phase 17a: the int8 graph route differs from eager")
    # the kernels line's aot_launches: what the profiler saw run on the graph route (bf16 hit and int8)
    launches = {name: hit["traced"][name] + int8_graph["traced"][name] for name in hit["traced"]}
    return dict(launches=launches, eager_tok_s=eager["tok_s"], graph_tok_s=hit["tok_s"])


def aot_cli_phase(card: str, prompts, workdir: str, cli: dict) -> None:
    """Phases 17b and 17c on phase 11b's app module and saved weights. (b): a
    child boots ``serve llama_app:model --admit-chunk 64 --prefix-cache
    --aot-preload DIR --compile-cache DIR2`` on empty directories (a miss: it
    builds its kernels with ``nvcc``, captures its programs and writes the
    store) and streams phase 3's prompts; a second child boots on the same
    directories and must load every program (``/metrics``: loaded > 0,
    compiled 0) and build nothing (no ``nvcc`` line in its log), and its
    wave runs under its own profiler: the graph route's paged launches,
    read from the trace, are CLI_LAYERS x its dispatches x 8, as phase 11b's
    eager child's are. Both stream phase 11b's in-process answers. (c):
    ``lambda_handler`` over the same app's ``ServingApp`` in this process,
    with ``UNIONML_TPU_AOT_PRELOAD`` at the populated store: two
    invocations, one startup, and its engine compiled nothing."""
    import os
    import shutil

    import torch

    from unionml_tpu_torch.serving.serverless import lambda_handler

    import llama_app

    artifact, inproc_streams = cli["artifact"], cli["inproc_streams"]
    store, kernels = os.path.join(workdir, "aot_store"), os.path.join(workdir, "kernel_cache")
    profile_dir = os.path.join(workdir, "aot_profile")
    args = cli["args"] + ["--aot-preload", store, "--compile-cache", kernels]
    boots = []
    for label in ("first", "second"):
        log = os.path.join(workdir, f"aot_{label}.log")
        extra = ["--profile-dir", profile_dir] if label == "second" else []
        with cli_server(args + extra, workdir, log) as (port, ready_s):
            before = json.loads(http_request(port, "GET", "/metrics")[2])["generation"]
            if label == "first":
                streams, seconds = concurrent([functools.partial(stream_http, port, [p]) for p in prompts])
                capture_ms = seconds * 1e3 + CLI_PROFILE_MARGIN_MS
            else:  # the wave under the child's own profiler, started before the wave is sent (11b's protocol)
                captured: dict = {}

                def capture():
                    captured["response"] = http_request(port, "POST", "/debug/profile", {"duration_ms": capture_ms},
                                                        {"X-Request-Deadline-Ms": str(capture_ms + 60_000)})

                profiler = threading.Thread(target=capture)
                profiler.start()
                time.sleep(1.0)
                probe = http_request(port, "POST", "/debug/profile", {"duration_ms": 1.0})
                require(probe[0] == 409, f"phase 17b: the capture had not started before the wave: {probe[0]}")
                streams, seconds = concurrent([functools.partial(stream_http, port, [p]) for p in prompts])
                profiler.join(timeout=capture_ms / 1e3 + 120)
                require(captured.get("response", (None,))[0] == 200, f"phase 17b: POST /debug/profile answered "
                        f"{captured.get('response', (None,))[0]}")
            generation = json.loads(http_request(port, "GET", "/metrics")[2])["generation"]
        with open(log, errors="replace") as handle:
            nvcc = sum("nvcc: building" in line for line in handle)
        boots.append(dict(ready_s=ready_s, streams=streams, tok_s=len(prompts) * MAX_NEW / seconds,
                          aot=generation.get("aot"), nvcc=nvcc, tbt=generation["tbt_ms"].get("p50_ms"),
                          dispatches=generation["decode_dispatches"] - before["decode_dispatches"]))
    first, second = boots
    traced, kernel_ms, _ = paged_kernel_events(profile_dir)
    shutil.rmtree(profile_dir, ignore_errors=True)
    expected = CLI_LAYERS * second["dispatches"] * 8
    print(f"phase 17b: `serve llama_app:model --admit-chunk {ADMIT_CHUNK} --prefix-cache --aot-preload DIR "
          f"--compile-cache DIR2` on empty directories: ready in {first['ready_s']:.1f} s ({first['nvcc']} nvcc "
          f"builds), {first['tok_s']:.1f} tok/s, TBT p50 {first['tbt']} ms, aot {first['aot']}; a second boot on the "
          f"same directories: ready in {second['ready_s']:.1f} s ({second['nvcc']} nvcc builds), "
          f"{second['tok_s']:.1f} tok/s under its profiler, aot {second['aot']}, {traced} paged launches in its trace "
          f"(its {second['dispatches']} dispatches give {CLI_LAYERS} x {second['dispatches']} x 8 = {expected}; "
          f"phase 11b's eager child: {cli['cli_launches']}); eager child (11b) ready in {cli['ready_s']:.1f} s; "
          f"streams equal phase 11b's in-process answers: {first['streams'] == inproc_streams}, "
          f"{second['streams'] == inproc_streams}; card {card}", flush=True)
    require(first["streams"] == inproc_streams and second["streams"] == inproc_streams,
            "phase 17b: a CLI child's streams differ from phase 11b's in-process answers")
    require(first["aot"] is not None and first["aot"]["programs_compiled"] > 0 and first["nvcc"] > 0,
            f"phase 17b: the first child did not compile: {first['aot']}, {first['nvcc']} nvcc builds")
    require(second["aot"]["programs_loaded"] > 0 and second["aot"]["programs_compiled"] == 0
            and second["nvcc"] == 0, f"phase 17b: the second child was no store hit: {second['aot']}, "
            f"{second['nvcc']} nvcc builds")
    require(traced == expected > 0, f"phase 17b: {traced} paged launches in the graph-route child's trace, "
            f"expected {expected}")

    # ---- 17c: serverless over the same app in this process, on the populated store
    exports = {"UNIONML_TPU_ADMIT_CHUNK": str(ADMIT_CHUNK), "UNIONML_TPU_PREFIX_CACHE": "1",
               "UNIONML_TPU_AOT_PRELOAD": store}
    os.environ.update(exports)
    try:
        llama_app.model.load(artifact)
        handler = lambda_handler(llama_app.model.serve())
        # two of the prompts the children served: the same prompt again would be a radix hit, which runs programs
        # (a gather, a chunk from another start) the children never ran
        responses = [handler({"httpMethod": "POST", "path": "/predict", "body": json.dumps({"features": [p]})}, None)
                     for p in prompts[:2]]
        aot = llama_app.model.generation_batcher.stats()["aot"]
        llama_app.model.generation_batcher.close()
    finally:
        for name in exports:
            os.environ.pop(name, None)
        llama_app.engines.clear()
        llama_app.model.artifact = None
        llama_app.model.generation_batcher = None
        torch.cuda.empty_cache()
    equal = [json.loads(r["body"]) == [want] for r, want in zip(responses, inproc_streams)]
    print(f"phase 17c: lambda_handler over the app, UNIONML_TPU_AOT_PRELOAD at the populated store: statuses "
          f"{[r['statusCode'] for r in responses]}, stats {handler.stats}, engine aot {aot}, answers equal phase "
          f"11b's streams: {equal}; card {card}", flush=True)
    require([r["statusCode"] for r in responses] == [200, 200] and all(equal),
            "phase 17c: the handler's answers differ from phase 11b's")
    require(handler.stats["invocations"] == 2 and handler.stats["startups"] == 1,
            f"phase 17c: {handler.stats}")
    require(aot["programs_compiled"] == 0 and aot["programs_loaded"] > 0, f"phase 17c: the engine's store {aot}")


# ---------------------------------------------------------------------------
# phase 18: the multi-host fleet (serving/cluster.py)

#: seconds a fleet's worker processes may take to build and announce (a 32-layer bf16 model drawn on the card)
FLEET_BOOT_S = 300
#: (c): the mesh fleet's ranks, two hosts of two
FLEET_MESH_RANKS = 4


class CountedEngine:
    """A fleet worker's engine whose ``stats()`` also carries this process's
    kernel launch counts (:func:`all_launches`): the worker counts its own
    launches, and the coordinator reads them over the control plane."""

    def __init__(self, engine):
        self._engine = engine

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def stats(self) -> dict:
        out = self._engine.stats()
        out["kernel_launches"] = all_launches()
        return out


def fleet_host_engine() -> CountedEngine:
    """Phase 18a's worker host: phase 3's configuration, weights (seed 0) and
    engine knobs on cuda:0, warmed by one short stream, its counts then set to
    0 (the worker's builder, ``python -m unionml_tpu_torch.serving.cluster``)."""
    import torch

    from unionml_tpu_torch import ContinuousBatcher, GenerationConfig, Generator, Llama, LlamaConfig

    cfg = LlamaConfig.llama3_8b(attention_impl="flash", dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    gcfg = GenerationConfig(prompt_buckets=(256,), max_new_tokens=MAX_NEW, temperature=0.0)
    engine = ContinuousBatcher(Generator(Llama(cfg, seed=0), gcfg), slots=4, decode_chunk=8, block_size=BLOCK)
    serve(engine, [[1, 2, 3]])  # set-up: first cuBLAS/allocator calls
    reset_counts()
    return CountedEngine(engine)


def fleet_mesh_config():
    """Phase 18c's model: phase 4's width at 2 layers, f32."""
    import torch

    from unionml_tpu_torch import GenerationConfig, LlamaConfig

    cfg = LlamaConfig.llama3_8b(n_layers=2, attention_impl="flash", dtype=torch.float32, param_dtype=torch.float32)
    return cfg, GenerationConfig(prompt_buckets=(256,), max_new_tokens=MAX_NEW, temperature=0.0)


def fleet_mesh_engine():
    """Phase 18c's worker rank: ``MeshSpec(dcn_data=hosts, model=2).build_hybrid()``
    over the world (gloo, every rank on cuda:0, TF32 off) and the
    process-aware ``ReplicaSet.build`` over it: this rank builds the tp=2
    replica of its host."""
    import torch

    from unionml_tpu_torch import Llama, distributed
    from unionml_tpu_torch.models import llama_partition_rules
    from unionml_tpu_torch.parallel import MeshSpec
    from unionml_tpu_torch.serving import ReplicaSet

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, gcfg = fleet_mesh_config()
    mesh = MeshSpec(dcn_data=distributed.process_count() // 2, model=2).build_hybrid()
    return ReplicaSet.build(Llama(cfg, seed=1), gcfg, mesh=mesh, partition_rules=llama_partition_rules(), slots=4,
                            decode_chunk=8, block_size=BLOCK, autoscale=False)


def fleet_workers(workdir: str, builder: str, world: int, tag: str, **env) -> list:
    """``world`` processes of ``python -m unionml_tpu_torch.serving.cluster
    SPEC`` building ``builder`` (a world of their own over gloo when above
    1), announcing into ``workdir``/fleet; returns [(process, log path)]."""
    import os

    spec = os.path.join(workdir, f"{tag}.json")
    with open(spec, "w") as handle:
        json.dump({"builder": builder, "kwargs": {}, "fleet_dir": os.path.join(workdir, "fleet")}, handle)
    port = free_port()
    procs = []
    for rank in range(world):
        extra = dict(env)
        if world > 1:
            extra.update(UNIONML_TPU_COORDINATOR=f"127.0.0.1:{port}", UNIONML_TPU_NUM_PROCESSES=str(world),
                         UNIONML_TPU_PROCESS_ID=str(rank))
        log = os.path.join(workdir, f"{tag}{rank}.log")
        with open(log, "wb") as handle:
            procs.append((subprocess.Popen([sys.executable, "-m", "unionml_tpu_torch.serving.cluster", spec],
                                           cwd=workdir, env=cli_env(**extra), stdout=handle,
                                           stderr=subprocess.STDOUT), log))
    return procs


def wait_announced(workdir: str, hosts, procs) -> None:
    import os

    deadline = time.monotonic() + FLEET_BOOT_S
    while not all(os.path.exists(os.path.join(workdir, "fleet", f"host-{h}.json")) for h in hosts):
        for proc, log in procs:
            require(proc.poll() is None, f"a fleet worker exited with {proc.returncode}: " + tail(log))
        require(time.monotonic() < deadline, f"the fleet did not announce within {FLEET_BOOT_S} s: "
                + " | ".join(tail(log, 800) for _, log in procs))
        time.sleep(0.2)


def stop_workers(procs) -> None:
    for proc, _ in procs:
        if proc.poll() is None:
            proc.terminate()
    for proc, _ in procs:
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def drain_all(streams) -> list:
    """Each stream's tokens, or the exception that ended it, each drained on
    its own thread (a stream that hangs fails the phase)."""
    import numpy as np

    def drain(stream):
        def run():
            try:
                return [int(t) for chunk in stream for t in np.asarray(chunk).ravel()]
            except Exception as exc:  # the caller inspects it (StreamInterrupted)
                return exc
        return run

    return concurrent([drain(s) for s in streams])[0]


def fleet_phase(card: str, cfg, gcfg, prompts, slots: int, decode_chunk: int, bf16_streams) -> dict:
    """Phase 18a: the two-host fleet at full width. Host 0 is a ``LocalHost``
    over an engine in this process, host 1 a worker process building the
    same weights on cuda:0; ``connect_fleet`` joins them. Phase 3's prompts
    stream token for token as phase 3's through the mixed fleet (both hosts
    taking submissions, each host's paged launches 32 x 8 a dispatch, host
    1's counted in its process), then through the pair re-roled
    prefill/decode (every stream crossing hosts, its bf16 pages as raw bits
    on the wire); then the worker is SIGKILLed mid-wave: no stream hangs, a
    stream that had emitted nothing completes on host 0, an emitted one ends
    in ``StreamInterrupted``, and the census shows host 1 suspect or dead."""
    import os
    import shutil
    import tempfile

    import torch

    from unionml_tpu_torch import ContinuousBatcher, Generator, Llama
    from unionml_tpu_torch.ops.paged_attention import paged_decode_attention
    from unionml_tpu_torch.serving.cluster import (
        FleetCoordinator, LocalHost, RemoteHost, StreamInterrupted, connect_fleet, serialize_handoff,
    )

    t_phase = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    procs = fleet_workers(workdir, "chip_smoke:fleet_host_engine", 1, "host", UNIONML_TPU_PROCESS_ID="1")
    coordinator = None
    try:
        model = Llama(cfg, seed=0)  # phase 3's weights, beside the worker's copy
        engine = ContinuousBatcher(Generator(model, gcfg), slots=slots, decode_chunk=decode_chunk, block_size=BLOCK)
        serve(engine, [prompts[0][:3]])  # set-up: first cuBLAS/allocator calls
        wait_announced(workdir, [1], procs)
        coordinator = connect_fleet(os.path.join(workdir, "fleet"), num_hosts=2, local_engine=engine,
                                    local_process_id=0)
        boot_s = time.perf_counter() - t_phase
        remote = coordinator.hosts[1]
        per_layer = cfg.n_layers * decode_chunk

        def counts():
            stats = remote.stats()
            return (engine.stats()["decode_dispatches"], paged_decode_attention.launches,
                    stats["decode_dispatches"], stats["kernel_launches"]["paged_decode_attention"])

        # ---- the mixed fleet
        reset_counts()
        before = counts()
        t0 = time.perf_counter()
        mixed = drain_all([coordinator.submit(p) for p in prompts])
        mixed_s = time.perf_counter() - t0
        after = counts()
        submitted = coordinator._scheduler.stats()["submitted"]
        d0, l0, d1, l1 = (a - b for a, b in zip(after, before))
        require(mixed == list(bf16_streams), f"the fleet's streams differ from phase 3's: {mixed}")
        require(all(n > 0 for n in submitted), f"a host took no submission: {submitted}")
        require(l0 == per_layer * d0 and l1 == per_layer * d1 > 0,
                f"paged launches host 0 {l0} ({d0} dispatches), host 1 {l1} ({d1} dispatches)")
        fleet_launches = l0 + l1

        # ---- the same pair re-roled prefill/decode: every stream crosses hosts
        decode_host = RemoteHost(remote.address, host_id=1)
        sizes, wire_ms = [], []
        send = decode_host.import_handoff

        def timed_import(payload):  # each payload as it crosses: the device-to-host copy and the npz
            t0 = time.perf_counter()
            blob = serialize_handoff(payload)
            wire_ms.append((time.perf_counter() - t0) * 1e3)
            sizes.append(len(blob))
            return send(blob)

        decode_host.import_handoff = timed_import
        # a second coordinator over the same hosts: it starts no reconciler, so it holds no thread; its close()
        # would close host 0's engine, which the SIGKILL wave below still serves on
        split = FleetCoordinator([LocalHost(engine, host_id=0), decode_host],
                                 host_roles=["prefill", "decode"], prefill_threshold=1)
        before = counts()
        t0 = time.perf_counter()
        crossed = drain_all([split.submit(p) for p in prompts])
        split_s = time.perf_counter() - t0
        after = counts()
        d0, l0, d1, l1 = (a - b for a, b in zip(after, before))
        stats = split.stats()
        require(crossed == list(bf16_streams), f"the prefill/decode streams differ from phase 3's: {crossed}")
        require(stats["handoffs_cross_host"] == len(prompts), f"{stats['handoffs_cross_host']} handoffs crossed")
        require(l0 == 0 and d0 == 0 and l1 == per_layer * d1 > 0,
                f"prefill host: {l0} launches, {d0} dispatches; decode host: {l1} launches, {d1} dispatches")
        require(len(sizes) == len(prompts), f"{len(sizes)} payloads were serialized for the decode host")
        fleet_launches += l1
        transfer = stats["handoff_transfer_ms"]

        # ---- SIGKILL the worker mid-wave. Host 0 is held out of routing while host 1 fills its slots with
        # phase 3's prompts (the first one's first chunk read: it has emitted), then takes one prompt more,
        # queued behind them (nothing emitted); host 0 comes back and the worker dies
        t0 = time.perf_counter()
        coordinator.hosts[0].alive = False
        held = [coordinator.submit(p) for p in prompts]
        first = next(held[0])
        late = coordinator.submit(prompts[1])
        coordinator.hosts[0].alive = True
        procs[0][0].kill()
        procs[0][0].wait(timeout=60)
        ended = drain_all(held + [late])
        kill_s = time.perf_counter() - t0
        census = coordinator.host_census()
        interrupted = [isinstance(e, StreamInterrupted) for e in ended]
        require(interrupted[0], f"the emitted stream did not end in StreamInterrupted: {ended[0]!r}")
        require(ended[-1] == list(bf16_streams[1]), f"the stream that had emitted nothing: {ended[-1]!r}")
        require(all(isinstance(e, StreamInterrupted) or e == list(want) for e, want in zip(ended, bf16_streams)),
                f"a stream ended otherwise: {ended}")
        require(census[1]["state"] in ("suspect", "dead"), f"host 1's census after the kill: {census[1]}")
        fleet_stats = coordinator.stats()["fleet"]
        require(fleet_stats["stream_retries"] >= 1, f"no stream was retried on host 0: {fleet_stats}")
    finally:
        if coordinator is not None:
            coordinator.close()
        stop_workers(procs)
        shutil.rmtree(workdir, ignore_errors=True)
    seconds = time.perf_counter() - t_phase
    print(f"phase 18a: two hosts (host 0 in this process, host 1 a worker on the same card, each phase 3's "
          f"32-layer bf16 weights) joined in {boot_s:.1f} s; mixed: 4 streams x {MAX_NEW} equal phase 3's, "
          f"submitted {submitted}, {len(prompts) * MAX_NEW / mixed_s:.1f} tok/s; prefill/decode: 4 streams equal "
          f"phase 3's, {stats['handoffs_cross_host']} handoffs across hosts, transfer ms {transfer}, payloads "
          f"{sizes} bytes (device to host and npz {[round(ms, 1) for ms in wire_ms]} ms), "
          f"{len(prompts) * MAX_NEW / split_s:.1f} tok/s; paged launches {fleet_launches} (each host 32 x 8 a "
          f"dispatch, host 1's counted in its process); SIGKILL mid-wave: the emitted stream "
          f"{type(ended[0]).__name__} after {first.size} tokens, the queued one completed on host 0 "
          f"(stream_retries {fleet_stats['stream_retries']}, streams_interrupted "
          f"{fleet_stats['streams_interrupted']}), {sum(interrupted)} of {len(ended)} interrupted, census host 1 "
          f"{census[1]['state']}, in {kill_s:.1f} s; phase 18a took {seconds:.1f} s; card {card}", flush=True)
    del model, engine
    gc.collect()
    torch.cuda.empty_cache()
    return dict(fleet_launches=fleet_launches, seconds=seconds, payload_bytes=sizes,
                transfer_ms=transfer, mixed_tok_s=len(prompts) * MAX_NEW / mixed_s)


def fleet_mesh_reference(prompts) -> dict:
    """Phase 18c's references: the world of one on the card and on the CPU
    (each prompt alone through ``Generator``, TF32 off)."""
    import torch

    from unionml_tpu_torch import Generator, Llama

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, gcfg = fleet_mesh_config()
    model = Llama(cfg, seed=1)
    card = Generator(model, gcfg)
    out = {"card": [card([p])[0].tolist() for p in prompts]}
    state = {k: v.cpu() for k, v in model.state_dict().items()}
    del card, model
    torch.cuda.empty_cache()
    cpu = Llama(cfg, device="cpu")
    cpu.load_state_dict(state)
    gen = Generator(cpu, gcfg, device="cpu")
    out["cpu"] = [gen([p])[0].tolist() for p in prompts]
    return out


def fleet_mesh_phase(card: str, prompts) -> dict:
    """Phase 18c: the mesh path. A gloo world of 4 ranks on cuda:0 (2
    layers, f32, TF32 off) builds ``MeshSpec(dcn_data=2, model=2).build_hybrid()``
    and the process-aware ``ReplicaSet.build(mesh=, partition_rules=
    llama_partition_rules())`` on every rank: two hosts of two ranks, each
    host's first rank leading its tp=2 engine and announcing. This process
    is the coordinator; the streams equal the world of one on the card and
    on the CPU, computed here while the ranks boot, and again with the
    hosts re-roled prefill/decode (each payload's KV heads gathered over
    the prefill host's ranks and scattered over the decode host's)."""
    import os
    import shutil
    import tempfile

    from unionml_tpu_torch.serving.cluster import FleetCoordinator, RemoteHost, connect_fleet

    t_phase = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_fleet_mesh_")
    procs = fleet_workers(workdir, "chip_smoke:fleet_mesh_engine", FLEET_MESH_RANKS, "rank")
    coordinator = None
    try:
        refs = fleet_mesh_reference(prompts)
        ref_s = time.perf_counter() - t_phase
        wait_announced(workdir, [0, 1], procs)
        coordinator = connect_fleet(os.path.join(workdir, "fleet"), num_hosts=2)
        boot_s = time.perf_counter() - t_phase
        t0 = time.perf_counter()
        streams = drain_all([coordinator.submit(p) for p in prompts])
        serve_s = time.perf_counter() - t0
        stats = coordinator.stats()
        submitted = coordinator._scheduler.stats()["submitted"]
        logs = " ".join(tail(log, 20000) for _, log in procs)
        owns = [f"this host owns replica submeshes [{h}] of 2" in logs for h in (0, 1)]
        require(all(owns), f"the ranks did not each build their host's replica: {owns}")
        require(streams == refs["card"] == refs["cpu"], f"fleet {streams}, world of one on the card "
                f"{refs['card']}, on the CPU {refs['cpu']}")
        require(stats["live_hosts"] == 2 and stats["replicas"] == 2 and all(n > 0 for n in submitted),
                f"live hosts {stats['live_hosts']}, replicas {stats['replicas']}, submitted {submitted}")
        # the same hosts re-roled prefill/decode: host 0's ranks gather their KV heads into one payload, host 1's
        # leader sends each rank its heads. A second coordinator over the same hosts starts no reconciler and holds
        # no thread: the first one's close below stops the workers
        split = FleetCoordinator([RemoteHost(h.address, host_id=h.host_id) for h in coordinator.hosts],
                                 host_roles=["prefill", "decode"], prefill_threshold=1)
        t0 = time.perf_counter()
        crossed = drain_all([split.submit(p) for p in prompts])
        split_s = time.perf_counter() - t0
        handoffs = split.stats()["handoffs_cross_host"]
        require(crossed == refs["card"], f"the tp=2 prefill/decode streams {crossed} differ from {refs['card']}")
        require(handoffs == len(prompts), f"{handoffs} handoffs crossed between the tp=2 hosts")
    finally:
        if coordinator is not None:
            coordinator.close(shutdown_workers=True)
        stop_workers(procs)
        shutil.rmtree(workdir, ignore_errors=True)
    seconds = time.perf_counter() - t_phase
    print(f"phase 18c: a gloo world of {FLEET_MESH_RANKS} ranks on cuda:0, MeshSpec(dcn_data=2, model=2)."
          f"build_hybrid(), the process-aware ReplicaSet: 2 hosts x tp=2 (2 layers, f32, TF32 off) announced in "
          f"{boot_s:.1f} s (the references took {ref_s:.1f} s beside them); 4 streams x {MAX_NEW} equal the world "
          f"of one on the card and on the CPU: True; submitted {submitted}; {len(prompts) * MAX_NEW / serve_s:.1f} "
          f"tok/s; re-roled prefill/decode: {handoffs} handoffs between the tp=2 hosts, streams equal, "
          f"{len(prompts) * MAX_NEW / split_s:.1f} tok/s; phase 18c took {seconds:.1f} s; card {card}", flush=True)
    return dict(seconds=seconds)


def fleet_cli_phase(card: str, prompts, workdir: str, cli: dict) -> dict:
    """Phase 18b: the CLI front door. Two children of ``serve llama_app:model
    --num-hosts 2 --coordinator 127.0.0.1:PORT --process-id {0,1}`` over
    phase 11b's app and artifact, both on cuda:0: process 0 serves HTTP over
    a ``FleetCoordinator`` (itself and process 1), process 1 its control
    server only. Phase 3's prompts stream over ``/predict-stream`` equal to
    11b's in-process answers; ``/debug/fleet`` shows 2 live hosts, each
    having taken a stream."""
    import os

    t_phase = time.perf_counter()
    rendezvous = f"127.0.0.1:{free_port()}"
    fleet = ["--num-hosts", "2", "--coordinator", rendezvous]
    log1 = os.path.join(workdir, "fleet_host1.log")
    with open(log1, "wb") as handle:
        host1 = subprocess.Popen([sys.executable, "-m", "unionml_tpu_torch.cli", "serve", *cli["args"], *fleet,
                                  "--process-id", "1", "--port", str(free_port())],
                                 cwd=workdir, env=cli_env(), stdout=handle, stderr=subprocess.STDOUT)
    try:
        with cli_server(cli["args"] + fleet + ["--process-id", "0"], workdir,
                        os.path.join(workdir, "fleet_host0.log")) as (port, ready_s):
            require(host1.poll() is None, f"process 1 exited with {host1.returncode}: " + tail(log1))
            served, wave_s = concurrent([functools.partial(stream_http, port, [p]) for p in prompts])
            debug = json.loads(http_request(port, "GET", "/debug/fleet")[2])
            # ---- phase 19b: the replay CLI against this fleet while it is up
            chaos = replay_cli_report("phase 19b, over the socket", [
                "scenario:chaos_fleet", "--target", f"http://127.0.0.1:{port}", "--seed", str(REPLAY_SEED)],
                workdir, os.path.join(workdir, "chaos_report.json"), card)
    finally:
        host1.terminate()
        try:
            host1.wait(timeout=60)
        except subprocess.TimeoutExpired:
            host1.kill()
            host1.wait()
    hosts, submitted = debug.get("hosts", []), debug.get("scheduler", {}).get("submitted", [])
    seconds = time.perf_counter() - t_phase
    print(f"phase 18b: `serve llama_app:model {' '.join(fleet)} --process-id 0|1` ({CLI_LAYERS} layers, both on "
          f"this card): ready in {ready_s:.1f} s; 4 /predict-stream streams x {MAX_NEW} "
          f"{len(prompts) * MAX_NEW / wave_s:.1f} tok/s, equal 11b's in-process answers: {served == cli['inproc_streams']}; "
          f"/debug/fleet hosts {[(h['host'], h['state']) for h in hosts]}, submitted {submitted}; phase 18b took "
          f"{seconds:.1f} s; card {card}", flush=True)
    require(served == cli["inproc_streams"], "the fleet CLI's streams differ from 11b's in-process answers")
    require(len(hosts) == 2 and all(h["alive"] and h["state"] == "live" for h in hosts),
            f"/debug/fleet hosts: {hosts}")
    require(len(submitted) == 2 and all(n >= 1 for n in submitted), f"a host took no stream: {submitted}")
    from unionml_tpu_torch.workloads import synthesize

    replay_answered("chaos_fleet", chaos["report"], len(synthesize("chaos_fleet", REPLAY_SEED)))
    return dict(seconds=seconds - chaos["seconds"], replay=chaos)


# phase 19: workload replay (unionml_tpu_torch/workloads)
#: (a): the scenarios replayed through phase 8's app in process, the one replayed over its socket, and their seed;
#: the scenario vocabularies draw ids below 90, valid tokens of the 128,256-token vocabulary
REPLAY_SELF_HOSTED, REPLAY_OVER_SOCKET, REPLAY_SEED = ("chat_multiturn", "burst_tenants", "deadline_heavy"), \
    "rag_long_prompt", 0
#: a replay CLI child's time limit (19b's self-hosted child loads 11b's 5.2 GiB artifact and warms up first)
REPLAY_CLI_S = 600


def replay_summary(name: str, report: dict) -> str:
    """One report as a line: its counts, per-tenant TTFT/TBT p50/p95 (ms),
    schedule adherence and verdict states."""
    tenants = "; ".join(
        f"{tenant} {entry['ok']}/{entry['requests']} ok, {entry['shed']} shed, TTFT p50/p95 "
        f"{entry['ttft_ms'].get('p50_ms')}/{entry['ttft_ms'].get('p95_ms')}, TBT p50/p95 "
        f"{entry['tbt_ms'].get('p50_ms')}/{entry['tbt_ms'].get('p95_ms')}"
        for tenant, entry in report["per_tenant"].items())
    verdicts = {tenant: v["state"] for tenant, v in report.get("verdicts", {}).items()}
    schedule = report["schedule"]
    return (f"{name}: {report['requests']} requests ({report['ok']} ok, {report['shed']} shed, {report['errors']} "
            f"errors) in {report['duration_s']} s, {report['tokens_per_s']} tok/s; schedule adherence "
            f"{schedule['adherence']} (lag p95 {schedule['lag_p95_ms']} ms); {tenants}; verdicts {verdicts} -> "
            f"{report.get('verdict_state')}")


def replay_answered(name: str, report: dict, requests: int) -> None:
    require(report["requests"] == requests and report["ok"] + report["shed"] == requests and report["errors"] == 0,
            f"replay {name}: a request was neither answered nor shed: {report['requests']} requests, "
            f"{report['ok']} ok, {report['shed']} shed, {report['errors']} errors")


def replay_phase(card: str, app, port: int, batcher, cfg) -> dict:
    """Phase 19a, inside phase 8 on its app and port: ``REPLAY_SELF_HOSTED``
    through the app's HTTP dispatch and ``REPLAY_OVER_SOCKET`` over the
    loopback socket, each with its scenario's targets. Every request is
    answered or shed; every completed greedy stream equals
    ``engine.submit`` on the final prompt it was sent (session history
    included), all queued at once; the paged kernel launched
    during the replays. Returns the launches and the reports."""
    import unionml_tpu_torch.workloads.replayer as replayer
    from unionml_tpu_torch.ops.paged_attention import paged_decode_attention
    from unionml_tpu_torch.workloads import replay, scenario_meta, scenario_targets, synthesize

    t_phase = time.perf_counter()
    sent: list = []  # (scenario, final prompt, completion, status) of every request
    drive_app, drive_socket = replayer._drive_self_hosted, replayer._drive_target_sync
    current = [None]

    async def through_app(app_, request, prompt, record):
        completion = await drive_app(app_, request, prompt, record)
        sent.append((current[0], list(prompt), list(completion), record.status))
        return completion

    def over_socket(target, request, prompt, record):
        completion = drive_socket(target, request, prompt, record)
        sent.append((current[0], list(prompt), list(completion), record.status))
        return completion

    replayer._drive_self_hosted, replayer._drive_target_sync = through_app, over_socket
    reports, seconds = {}, {}
    before = paged_decode_attention.launches
    try:
        for name in (*REPLAY_SELF_HOSTED, REPLAY_OVER_SOCKET):
            current[0] = name
            where = {"target": f"http://127.0.0.1:{port}"} if name == REPLAY_OVER_SOCKET else {"app": app}
            t0 = time.perf_counter()
            reports[name] = replay(synthesize(name, REPLAY_SEED), targets=scenario_targets(name),
                                   meta=scenario_meta(name, REPLAY_SEED), **where)
            seconds[name] = time.perf_counter() - t0
    finally:
        replayer._drive_self_hosted, replayer._drive_target_sync = drive_app, drive_socket
    launches = paged_decode_attention.launches - before
    for name, report in reports.items():
        replay_answered(name, report, len(synthesize(name, REPLAY_SEED)))
        print(f"phase 19a, {'over the socket' if name == REPLAY_OVER_SOCKET else 'self-hosted'} "
              f"({seconds[name]:.1f} s), {replay_summary(name, report)}; card {card}", flush=True)

    # every completed greedy stream against engine.submit on its final prompt, all queued at once
    completed = [(name, prompt, completion) for name, prompt, completion, status in sent if status == 200]
    t0 = time.perf_counter()
    streams = [batcher.submit(prompt, max_new_tokens=len(completion)) for _, prompt, completion in completed]
    direct = [[int(t) for chunk in stream for t in chunk] for stream in streams]
    mismatched = [(name, first_divergence(got, want)) for (name, _, want), got in zip(completed, direct)
                  if got != want]
    seconds_direct = time.perf_counter() - t0
    print(f"phase 19a: {len(completed)} completed streams of {len(sent)} requests resubmitted through "
          f"engine.submit in {seconds_direct:.1f} s (queued at once, {batcher.slots} slots): "
          f"{len(completed) - len(mismatched)} equal, "
          f"mismatches (scenario, first divergence) {mismatched}; paged launches during the replays {launches}; "
          f"phase 19a took {time.perf_counter() - t_phase:.1f} s; card {card}", flush=True)
    require(not mismatched, f"replayed streams differ from engine.submit: {mismatched}")
    require(launches > 0 and launches % cfg.n_layers == 0, f"{launches} paged launches during the replays")
    return dict(launches=launches, reports=reports, seconds=time.perf_counter() - t_phase)


def replay_cli_report(label: str, args, cwd: str, out: str, card: str) -> dict:
    """``python -m unionml_tpu_torch.cli replay ARGS --out OUT`` in a child:
    its report parsed, exit code and verdicts printed; exit 1 exactly when
    the verdict is a breach."""
    import os

    t0 = time.perf_counter()
    done = run_cli(["replay", *args, "--out", out], cwd, REPLAY_CLI_S)
    seconds = time.perf_counter() - t0
    require(os.path.exists(out), f"`replay {' '.join(args)}` wrote no report (exit {done.returncode}): "
            f"{done.stderr[-2000:]}")
    with open(out) as handle:
        report = json.load(handle)
    require(json.loads(done.stdout) == report, "the replay CLI's stdout differs from its --out report")
    print(f"{label}: `replay {' '.join(args)}` exited {done.returncode} in {seconds:.1f} s; "
          f"{replay_summary(args[0], report)}; card {card}", flush=True)
    require(done.returncode == (1 if report.get("verdict_state") == "breach" else 0),
            f"replay exit code {done.returncode} against verdict {report.get('verdict_state')}")
    return dict(report=report, returncode=done.returncode, seconds=seconds)


def replay_cli_phase(card: str, workdir: str, cli: dict) -> dict:
    """Phase 19b (second half), inside phase 11's workdir after 18b: ``replay
    scenario:chat_multiturn --self-host llama_app:model --model-path`` over
    11b's app and artifact, the app served in the CLI child itself."""
    import os

    from unionml_tpu_torch.workloads import synthesize

    done = replay_cli_report("phase 19b, self-hosted", [
        "scenario:chat_multiturn", "--self-host", "llama_app:model", "--model-path", cli["artifact"],
        "--seed", str(REPLAY_SEED)], workdir, os.path.join(workdir, "chat_report.json"), card)
    replay_answered("chat_multiturn", done["report"], len(synthesize("chat_multiturn", REPLAY_SEED)))
    return done


# phase 20: the remote backend (remote.py, job_runner.py)
#: (b): phase 7's LoRA app at Llama-3-8B width, REMOTE_LAYERS of 32 layers in bf16 (the artifact at most
#: REMOTE_ARTIFACT_GIB: 2 x 525M embedding and head parameters and 218M a layer, 2 bytes each, is 3.6 GiB at 4
#: layers; f32 would be 7.2), REMOTE_ROWS steps of 1 x REMOTE_SEQ, then 4 prompts of APP_PROMPT -> APP_NEW tokens
REMOTE_LAYERS, REMOTE_ROWS, REMOTE_SEQ, REMOTE_ARTIFACT_GIB = 4, 2, 2048, 5.0
#: one remote job's time limit (the child starts, loads or draws the weights, runs and writes its outputs)
REMOTE_JOB_S = 900
REMOTE_APP_SOURCE = '''
from typing import List

import numpy as np
import torch

from unionml_tpu_torch import (
    ContinuousBatcher, Dataset, GenerationConfig, Generator, Llama, LlamaConfig, Model, TrainerConfig, TrainState,
    make_train_step,
)
from unionml_tpu_torch.models import chunked_causal_lm_loss, lora_optimizer

CONFIG = LlamaConfig.llama3_8b(n_layers={layers}, lora_rank=8, attention_impl="flash", dtype=torch.bfloat16,
                               param_dtype=torch.bfloat16)
GENERATION = GenerationConfig(prompt_buckets=({prompt},), max_new_tokens={new}, temperature=0.0)

dataset = Dataset(name="tokens")
model = Model(name="remote_lora", dataset=dataset)
model.__app_module__ = "remote_lora_app:model"
engines = {{}}


@dataset.reader
def reader(n: int, seq: int, seed: int = 0) -> np.ndarray:
    return np.random.RandomState(seed).randint(1, CONFIG.vocab_size, size=(n, seq)).astype(np.int64)


@model.init
def init(hyperparameters: dict) -> TrainState:
    module = Llama(CONFIG, device=hyperparameters.get("device"), seed=hyperparameters.get("seed", 0))
    return TrainState(module, lora_optimizer(module, {lr}))


_step = make_train_step(chunked_causal_lm_loss)


@model.trainer(config=TrainerConfig(epochs=1, batch_size=1, shuffle=False, log_every_steps=1))
def trainer(state: TrainState, batch) -> tuple:
    return _step(state, batch)


def engine(state: TrainState) -> ContinuousBatcher:
    """One paged engine a state: the predictor's prompts share its slots."""
    if engines.get("state") is not state:
        if "batcher" in engines:
            engines["batcher"].close()
        engines["state"] = state
        engines["batcher"] = ContinuousBatcher(
            Generator(state.model, GENERATION, device=next(state.model.parameters()).device), slots=4,
            decode_chunk=8, block_size=16)
        model.generation_batcher = engines["batcher"]
    return engines["batcher"]


@model.predictor
def predictor(state: TrainState, features: np.ndarray) -> List[List[int]]:
    streams = [engine(state).submit([int(t) for t in row]) for row in features]  # all resident at once
    return [[int(t) for chunk in stream for t in chunk] for stream in streams]
'''


def job_report(execution_path: str, worker: int = 0) -> dict:
    """The ``job_runner: report {...}`` line a worker ends its log with."""
    import os

    log = os.path.join(execution_path, "logs.txt" if worker == 0 else f"logs.{worker}.txt")
    with open(log) as handle:
        text = handle.read()
    require("job_runner: report " in text, f"{log} has no report line: {text[-2000:]}")
    return json.loads(text.rsplit("job_runner: report ", 1)[1].splitlines()[0])


def job_line(report: dict) -> str:
    return (f"startup {report['startup_s']} s, kernel load {report['kernel_load_s']} s, job {report['job_s']} s, "
            f"save {report['save_s']} s, peak memory {report['peak_memory_gib']} GiB, launches "
            f"{ {k: v for k, v in report['launches'].items() if v} }")


def latest_execution(store: str, model_name: str, kind: str) -> str:
    """The newest execution directory of a kind (``train``/``predict``) in a backend store."""
    import glob
    import os

    found = glob.glob(os.path.join(store, "unionml-tpu", "development", "executions", model_name, f"{kind}*"))
    require(bool(found), f"no {kind} execution of {model_name} in {store}")
    return max(found, key=os.path.getmtime)


def template_remote_phase(card: str, workdir: str) -> dict:
    """Phases 11a and 20a: the port's ``init`` renders the text-generation
    template, and the CLI runs it through the remote backend (a store in the
    workdir): ``deploy --allow-uncommitted`` (``--app-version`` where the
    machine has no git), ``train`` (a ``job_runner`` child trains it on the
    card with its own schedule), ``list-model-versions``, ``predict
    --features`` in a second child, ``fetch-model``. ``serve`` boots the
    fetched artifact, and ``serve --remote`` the registry's; each streams a
    ``@word`` matching the grammar, and the predict job's continuation does
    too. Everything that reads the trained version runs at once (the
    fetched artifact's server after its fetch)."""
    import ast
    import os
    import re
    import shutil

    t_phase = time.perf_counter()
    store = os.path.join(workdir, "store")
    env = {"UNIONML_TPU_STORE": store}
    done = run_cli(["init", "genapp", "--template", "text-generation"], workdir, 120)
    require(done.returncode == 0, f"init failed: {done.stderr[-2000:]}")
    project = os.path.join(workdir, "genapp")
    committed = shutil.which("git") is not None and os.path.isdir(os.path.join(project, ".git"))
    version = ["--allow-uncommitted"] if committed else ["--app-version", "template-v1"]
    steps = {}

    def cli(*args, timeout=REMOTE_JOB_S):
        t0 = time.perf_counter()
        done = run_cli(list(args), project, timeout, **env)
        steps[args[0]] = time.perf_counter() - t0
        require(done.returncode == 0, f"`{' '.join(args)}` exited {done.returncode}: {done.stderr[-3000:]}")
        return done.stdout

    deployed = cli("deploy", "app:model", *version)
    trained = cli("train", "app:model", "-i", json.dumps({"hyperparameters": {"learning_rate": 3e-3}}))
    train_report = job_report(latest_execution(store, "genapp", "train"))
    with open(os.path.join(project, "features.json"), "w") as handle:
        json.dump([TEMPLATE_PROMPT], handle)
    fetched = os.path.join(project, "fetched.ckpt")

    def served(args, log: str, **extra) -> tuple:
        """Boot ``serve ARGS``, stream the grammar prompt: (text, seconds to ready, /metrics generation)."""
        with cli_server(args, project, os.path.join(workdir, log), **extra) as (port, ready_s):
            text = "".join(stream_http(port, [TEMPLATE_PROMPT]))
            status, _, body = http_request(port, "GET", "/metrics")
            require(status == 200, f"/metrics answered {status}")
            return text, ready_s, json.loads(body).get("generation")

    def fetch_and_serve() -> tuple:
        cli("fetch-model", "app:model", "-o", fetched)
        return served(["app:model", "--model-path", fetched], "template_server.log")

    # everything that reads the trained version at once, each a process of its own
    (versions, predicted, (text, ready_s, generation), (remote_text, remote_ready_s, _)), _ = concurrent([
        functools.partial(cli, "list-model-versions", "app:model"),
        functools.partial(cli, "predict", "app:model", "--features", os.path.join(project, "features.json")),
        fetch_and_serve,
        functools.partial(served, ["app:model", "--remote"], "template_remote.log", **env)])
    predict_report = job_report(latest_execution(store, "genapp", "predict"))
    prediction = ast.literal_eval(predicted.split("Predictions: ", 1)[1].strip())[0]
    prompt_text = TEMPLATE_PROMPT.split(" ", 1)[1]
    seconds = time.perf_counter() - t_phase
    print(f"phase 20a: the text-generation template rendered by the CLI's init, through the remote backend: "
          f"{deployed.strip()!r} ({'git HEAD' if committed else 'no git on this machine: an explicit version'}); "
          f"`train` {steps['train']:.1f} s ({trained.strip().splitlines()[-1]!r}; the job_runner child: "
          f"{job_line(train_report)}); versions {versions.split()[-1]!r}; `predict` {steps['predict']:.1f} s "
          f"({prediction!r}; its child: {job_line(predict_report)}); `fetch-model` {steps['fetch-model']:.1f} s; "
          f"`serve --model-path <fetched>` ready in {ready_s:.1f} s streamed {text!r} (/metrics decode dispatches "
          f"{generation and generation.get('decode_dispatches')}); `serve --remote` ready in {remote_ready_s:.1f} s "
          f"streamed {remote_text!r}; phase 20a took {seconds:.1f} s; card {card}", flush=True)
    require(train_report["peak_memory_gib"] is not None, "the template's job_runner child did not train on the card")
    require("- train-" in versions, f"no trained version listed: {versions!r}")
    require(prediction.startswith(prompt_text) and re.fullmatch(TEMPLATE_REGEX, prediction[len(prompt_text):]),
            f"the predict job's @word continuation {prediction!r} is not [a-z]+")
    for streamed in (text, remote_text):
        require(streamed and re.fullmatch(TEMPLATE_REGEX, streamed) is not None,
                f"the @word stream {streamed!r} is not [a-z]+")
    require(generation is not None and generation["decode_dispatches"] > 0, f"/metrics generation {generation}")
    return dict(seconds=seconds)


def lora_remote_phase(card: str) -> dict:
    """Phase 20b: phase 7's LoRA app as a module (``REMOTE_APP_SOURCE``) at
    Llama-3-8B width, ``REMOTE_LAYERS`` deep, through the backend's
    ``LocalProcessLauncher``: ``remote_train`` (``REMOTE_ROWS`` steps of 1 x
    ``REMOTE_SEQ``, numpy seed 0) and ``remote_predict`` of 4 prompts, each
    in a ``job_runner`` child on this card. The children's launches come
    back from their logs: flash forward and fused backward in training, the
    paged kernel in prediction. The artifact (at most ``REMOTE_ARTIFACT_GIB``),
    fetched and loaded here while the predict job runs, predicts the remote
    job's tokens."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from unionml_tpu_torch.ops.paged_attention import paged_decode_attention

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_remote_")
    source = os.path.join(root, "app")
    os.makedirs(source)
    with open(os.path.join(source, "remote_lora_app.py"), "w") as handle:
        handle.write(REMOTE_APP_SOURCE.format(layers=REMOTE_LAYERS, prompt=APP_PROMPT, new=APP_NEW, lr=LR))
    sys.path.insert(0, source)
    cwd = os.getcwd()
    try:
        import remote_lora_app

        model = remote_lora_app.model
        model.remote(backend_store=os.path.join(root, "store"))
        os.chdir(source)  # the bundle is the working directory: the app module alone
        version = model.remote_deploy(app_version="lora-v1")
        os.chdir(cwd)
        t0 = time.perf_counter()
        trained = model.remote_train(wait=False, hyperparameters={"seed": 0}, n=REMOTE_ROWS, seq=REMOTE_SEQ, seed=0)
        model.remote_wait(trained, timeout=REMOTE_JOB_S)
        train_s = time.perf_counter() - t0
        train_report = job_report(trained.path)
        size = os.path.getsize(os.path.join(trained.path, "outputs", "model_object.bin"))
        prompts = np.random.RandomState(2).randint(1, remote_lora_app.CONFIG.vocab_size, size=(4, APP_PROMPT))
        t0 = time.perf_counter()
        predicting = model.remote_predict(wait=False, features=prompts)
        model.remote_load(trained)  # fetched and loaded here while the predict job runs
        before = paged_decode_attention.launches
        local_tokens = model.predict(features=prompts)
        local_launches = paged_decode_attention.launches - before
        remote_tokens = model.remote_fetch_predictions(predicting)
        predict_s = time.perf_counter() - t0
        predict_report = job_report(predicting.path)
        on_card = all(p.device.type == "cuda" for p in model.artifact.model_object.model.parameters())
    finally:
        os.chdir(cwd)
        sys.path.remove(source)
        batcher = getattr(sys.modules.get("remote_lora_app"), "engines", {}).get("batcher")
        if batcher is not None:
            batcher.close()
        sys.modules.pop("remote_lora_app", None)
        shutil.rmtree(root, ignore_errors=True)
    seconds = time.perf_counter() - t_phase
    train_launches, predict_launches = train_report["launches"], predict_report["launches"]
    per_run = REMOTE_LAYERS * REMOTE_ROWS
    print(f"phase 20b: phase 7's LoRA app at Llama-3-8B width, {REMOTE_LAYERS} of 32 layers, bf16, deployed as "
          f"{version}; remote_train ({REMOTE_ROWS} steps of 1 x {REMOTE_SEQ}) {train_s:.1f} s, the child: "
          f"{job_line(train_report)}; artifact {size / 2**30:.2f} GiB (limit {REMOTE_ARTIFACT_GIB}); "
          f"remote_predict (4 prompts x {APP_PROMPT} -> {APP_NEW}; the load and predict here beside it) "
          f"{predict_s:.1f} s, the child: "
          f"{job_line(predict_report)}; loaded here (on the card: {on_card}) the artifact predicts the remote "
          f"job's tokens: {np.array_equal(np.asarray(local_tokens), np.asarray(remote_tokens))} ({local_launches} "
          f"paged launches here); phase 20b took {seconds:.1f} s; card {card}", flush=True)
    require(train_launches["flash_forward"] == per_run and train_launches["flash_backward"] == per_run,
            f"the training child's flash launches {train_launches}, expected {per_run} of each")
    require(predict_launches["paged_decode_attention"] > 0, f"the predict child's launches {predict_launches}")
    require(size <= REMOTE_ARTIFACT_GIB * 2**30, f"the artifact is {size / 2**30:.2f} GiB")
    require(on_card and np.array_equal(np.asarray(local_tokens), np.asarray(remote_tokens))
            and np.asarray(remote_tokens).shape == (4, APP_NEW), "the fetched artifact predicts other tokens")
    require(all(v == 0 for k, v in {**train_launches, **predict_launches}.items()
                if k not in ("flash_forward", "flash_backward", "paged_decode_attention")),
            f"kernels off the remote paths launched: {train_launches}, {predict_launches}")
    torch.cuda.empty_cache()
    return dict(launches={"flash_forward": train_launches["flash_forward"],
                          "flash_backward": train_launches["flash_backward"],
                          "paged_decode_attention": predict_launches["paged_decode_attention"]},
                seconds=seconds)


def main() -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="also serve once under torch.profiler and print the device-time breakdown")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test needs one card", file=sys.stderr)
        return 2
    import numpy as np

    from unionml_tpu_torch import ContinuousBatcher, GenerationConfig, Generator, Llama, LlamaConfig
    from unionml_tpu_torch import _build
    from unionml_tpu_torch.ops.paged_attention import paged_decode_attention

    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # ---- phase 1: build
    t0 = time.perf_counter()
    _build.build_all()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s", flush=True)
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    # ---- engine geometry (the served shape the kernel phase measures)
    gcfg = GenerationConfig(prompt_buckets=(256,), max_new_tokens=MAX_NEW, temperature=0.0)
    slots, decode_chunk = 4, 8
    cache_len = max(gcfg.prompt_buckets) + MAX_NEW + decode_chunk
    pages_per_seq = -(-cache_len // BLOCK)
    pool_pages = slots * pages_per_seq + 1  # + the scratch page

    # ---- phase 2: kernels against their plain twins, and times
    numbers = kernel_phase(pool_pages, pages_per_seq)
    flash_numbers = flash_kernel_phase()
    int8_numbers = int8_kernel_phase()
    int8_page_numbers = int8_page_phase(pool_pages, pages_per_seq, numbers)

    rng = np.random.RandomState(0)

    # ---- phase 3: serve at full width
    cfg = LlamaConfig.llama3_8b(attention_impl="flash", dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    prompts = [rng.randint(1, cfg.vocab_size, size=n).tolist() for n in PROMPT_LENS]
    t0 = time.perf_counter()
    model = Llama(cfg, seed=0)
    torch.cuda.synchronize()
    print(f"Llama-3-8B width, {cfg.n_layers} layers, bf16, random weights: built in "
          f"{time.perf_counter() - t0:.1f} s, {torch.cuda.memory_allocated() / 2**30:.1f} GiB", flush=True)
    gen = Generator(model, gcfg)
    warm = ContinuousBatcher(gen, slots=slots, decode_chunk=decode_chunk, block_size=BLOCK)
    serve(warm, [prompts[0][:3]])  # set-up: first cuBLAS/allocator calls
    warm.close()
    batcher = ContinuousBatcher(gen, slots=slots, decode_chunk=decode_chunk, block_size=BLOCK)
    require(batcher.max_blocks == pages_per_seq and batcher.pool_blocks + 1 == pool_pages,
            "the kernel phase measured another pool geometry than the engine serves")
    paged_decode_attention.launches = 0
    streams, seconds = serve(batcher, prompts)
    launches = paged_decode_attention.launches
    stats = batcher.stats()
    batcher.close()
    require(all(len(s) == MAX_NEW for s in streams), f"stream lengths {[len(s) for s in streams]}")
    require(all(0 <= t < cfg.vocab_size for s in streams for t in s), "a token id outside the vocabulary")
    expected = cfg.n_layers * stats["decode_dispatches"] * decode_chunk
    print(f"served 4 streams x {MAX_NEW} tokens: {4 * MAX_NEW / seconds:.1f} tok/s aggregate, "
          f"TTFT p50 {stats['ttft_ms']['p50_ms']} ms max {stats['ttft_ms']['max_ms']} ms, "
          f"decode dispatch {stats['tbt_ms']['p50_ms']} ms (p50 gap between emissions, {decode_chunk} steps), "
          f"{stats['decode_dispatches']} dispatches, kernel launches {launches} "
          f"(expected {cfg.n_layers} layers x {stats['decode_dispatches'] * decode_chunk} steps = {expected}); "
          f"card {card}", flush=True)
    require(launches == expected > 0, f"{launches} kernel launches on the main path, expected {expected}")
    bf16 = dict(tok_s=4 * MAX_NEW / seconds, ttft_p50=stats["ttft_ms"]["p50_ms"], tbt_p50=stats["tbt_ms"]["p50_ms"])
    bf16_streams = streams
    if args.profile:
        profiled = ContinuousBatcher(gen, slots=slots, decode_chunk=decode_chunk, block_size=BLOCK)
        profile_run("serve 4 streams", lambda: serve(profiled, prompts))
        profiled.close()
        del profiled
    del model, gen, warm, batcher
    torch.cuda.empty_cache()

    # ---- phase 3b: the same weights served in int8
    int8_launches = int8_serving_phase(cfg, gcfg, prompts, slots, decode_chunk, bf16, card, args.profile)
    torch.cuda.empty_cache()

    # ---- phase 3c: structured decoding and logprobs, the same width and weights
    structured_phase(cfg, gcfg, prompts, slots, decode_chunk, card, args.profile)
    torch.cuda.empty_cache()

    # ---- phase 17a: the cold start in process (the AOT store's graph route against the eager one)
    aot = aot_phase(card, dataclasses.replace(cfg, n_layers=AOT_LAYERS), gcfg, prompts, slots, decode_chunk)
    torch.cuda.empty_cache()

    # ---- phase 4: token parity at float32, 2 layers of the same width
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = LlamaConfig.llama3_8b(n_layers=2, attention_impl="flash", dtype=torch.float32, param_dtype=torch.float32)
    flash_model = Llama(cfg32, seed=1)
    plain_model = Llama(dataclasses.replace(cfg32, attention_impl="auto"))
    plain_model.load_state_dict(flash_model.state_dict())
    engine = ContinuousBatcher(Generator(flash_model, gcfg), slots=slots, decode_chunk=decode_chunk, block_size=BLOCK)
    before = paged_decode_attention.launches
    engine_streams, _ = serve(engine, prompts)
    engine.close()
    solo = Generator(plain_model, gcfg)
    solo_streams = [solo([p])[0].tolist() for p in prompts]
    parity = engine_streams == solo_streams
    print(f"float32 token parity, engine (kernel, {paged_decode_attention.launches - before} launches) vs "
          f"solo Generator (gather path): {'identical' if parity else 'DIFFERENT'}", flush=True)
    require(paged_decode_attention.launches > before and parity, f"{engine_streams} != {solo_streams}")

    del flash_model, plain_model, engine, solo
    torch.cuda.empty_cache()
    int8_parity_phase(gcfg, prompts, slots, decode_chunk)
    torch.cuda.empty_cache()

    # ---- phase 5: LoRA fine-tune at full width, then f32 training parity
    flash_launches, phase5_losses = training_phase(card, args.profile)
    torch.cuda.empty_cache()
    bf16_training_parity_phase()
    f32_launches = training_parity_phase()
    # the f32 forward and backward run on the f32 path only
    flash_launches.update({name: f32_launches[name] for name in ("flash_forward_f32", "flash_backward_f32")})
    torch.cuda.empty_cache()

    # ---- phase 7: the app protocol (Dataset/Model) through the same kernels
    app_launches = app_protocol_phase(card)
    require(all(n > 0 for name, n in app_launches.items() if name != "int8_matmul") and
            app_launches["int8_matmul"] == 0, f"app path launches {app_launches}")

    # ---- phase 8: the serving half (Model.serve, HTTP over a loopback socket) on phase 3's weights
    http_launches, replayed = http_phase(card, cfg, gcfg, prompts, slots, decode_chunk, bf16, args.profile)
    torch.cuda.empty_cache()

    # ---- phase 9: speculative decoding and beam search; the int8-page mode on a live pool
    t0 = time.perf_counter()
    target = Llama(cfg, seed=0)  # phase 3's weights
    torch.cuda.synchronize()
    print(f"phase 9: the bf16 target (phase 3's weights) rebuilt in {time.perf_counter() - t0:.1f} s", flush=True)
    spec = spec_serving_phase(card, target, gcfg, prompts, slots, decode_chunk, bf16, bf16_streams)
    pool = int8_pool_phase(card, target, gcfg, prompts, slots, decode_chunk)
    t10 = time.perf_counter()
    # ---- phase 10a: chunked admission and shared-prefix reuse on the same target
    prefix_launches = prefix_phase(card, target, gcfg, prompts, slots, decode_chunk)
    t10 = time.perf_counter() - t10
    del target
    torch.cuda.empty_cache()
    # ---- phase 14a-c: the in-process replica layer, REPLICA_LAYERS deep (d: f32 parity, below)
    t14 = time.perf_counter()
    replica_model = Llama(dataclasses.replace(cfg, n_layers=REPLICA_LAYERS), seed=0)
    reference = ContinuousBatcher(Generator(replica_model, gcfg), slots=slots, decode_chunk=decode_chunk,
                                  block_size=BLOCK)
    replica_streams, _ = serve(reference, prompts)
    reference.close()
    replica = replica_phase(card, replica_model, gcfg, prompts, slots, decode_chunk, replica_streams, args.profile)
    del replica_model, reference
    torch.cuda.empty_cache()
    replica_parity_phase(gcfg, prompts, slots, decode_chunk)
    t14 = time.perf_counter() - t14
    print(f"phase 14 took {t14:.1f} s", flush=True)
    spec_int8_launches = spec_parity_phase(gcfg, prompts, slots, decode_chunk)
    print(f"phase 9 took {time.perf_counter() - t0 - t10 - t14:.1f} s", flush=True)
    # ---- phase 10b: f32 parity of chunked admission and the prefix caches with the solo Generator
    t0 = time.perf_counter()
    prefix_parity_phase(gcfg, prompts, slots, decode_chunk)
    print(f"phase 10 took {t10 + time.perf_counter() - t0:.1f} s", flush=True)

    # ---- phase 11: the serve CLI in its own process (the template, then Llama-3-8B width)
    import shutil
    import tempfile

    workdir = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        t0 = time.perf_counter()
        # ---- phases 11a and 20a: the template through the remote backend's CLI, then served
        template = template_remote_phase(card, workdir)
        cli = llama_cli_phase(card, prompts, workdir)
        # ---- phase 11c: the static analyzer through the CLI, and its TPU001 premise on the card
        lint_phase(card, workdir)
        print(f"phase 11 took {time.perf_counter() - t0 - template['seconds']:.1f} s (20a apart)", flush=True)
        # ---- phase 17b-c: the AOT store and the kernel build cache in CLI children; serverless in process
        t0 = time.perf_counter()
        aot_cli_phase(card, prompts, workdir, cli)
        print(f"phase 17b-c took {time.perf_counter() - t0:.1f} s", flush=True)
        # ---- phase 18b: the multi-host fleet through the serve CLI's front door, on 11b's app and artifact
        fleet_cli = fleet_cli_phase(card, prompts, workdir, cli)
        # ---- phase 19b: the replay CLI self-hosting 11b's app and artifact
        replay_cli = replay_cli_phase(card, workdir, cli)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"phase 19 took {replayed['seconds'] + fleet_cli['replay']['seconds'] + replay_cli['seconds']:.1f} s "
          f"(19a {replayed['seconds']:.1f}, 19b {fleet_cli['replay']['seconds'] + replay_cli['seconds']:.1f})",
          flush=True)

    # ---- phase 20b: the remote backend's train and predict jobs at Llama-3-8B width
    remote = lora_remote_phase(card)
    print(f"phase 20 took {template['seconds'] + remote['seconds']:.1f} s (20a {template['seconds']:.1f}, 20b "
          f"{remote['seconds']:.1f})", flush=True)

    # ---- phase 12: the routed-experts decoder (MoE): MoEConfig() served, then f32 parity at 2 layers
    t0 = time.perf_counter()
    moe = moe_serving_phase(card, gcfg, slots, decode_chunk)
    moe_parity_phase(gcfg, slots, decode_chunk)
    print(f"phase 12 took {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- phase 13: the encoder models (BERT-base, the flash encoder stack, ViT-L, the MLP), then f32 parity
    t0 = time.perf_counter()
    bert = bert_phase(card, args.profile)
    encoder = encoder_flash_phase(card)
    vit = vit_phase(card)
    mlp = mlp_phase(card)
    encoder_f32 = encoder_parity_phase()
    model_launches = {name: bert["launches"][name] + vit["launches"][name] + mlp["launches"][name]
                      for name in bert["launches"]}
    print(f"phase 13 took {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- phase 18a, 18c: the multi-host fleet (a worker process beside this one; 2 hosts x tp=2 over gloo)
    fleet = fleet_phase(card, cfg, gcfg, prompts, slots, decode_chunk, bf16_streams)
    fleet_mesh = fleet_mesh_phase(card, prompts)
    print(f"phase 18 took {fleet['seconds'] + fleet_cli['seconds'] + fleet_mesh['seconds']:.1f} s (18a "
          f"{fleet['seconds']:.1f}, 18b {fleet_cli['seconds']:.1f}, 18c {fleet_mesh['seconds']:.1f})", flush=True)

    # ---- phase 15: the serving mesh (a world of one over NCCL; two ranks on this card over gloo)
    mesh = mesh_phase(card, gcfg, prompts, slots, decode_chunk, bf16_streams)

    # ---- phase 16: parallel training (a world of one over NCCL; two ranks on this card over gloo)
    train_mesh = train_mesh_phase(card, phase5_losses)

    kernels = [{
        "name": "paged_decode_attention",
        "route": "cuda",
        "source": "unionml_tpu_torch/csrc/paged_decode_attention.cu",
        "replaces": "unionml_tpu/ops/paged_attention.py:84",
        "launches": launches,
        "app_launches": app_launches["paged_decode_attention"],
        "http_launches": http_launches["paged_decode_attention"],
        "spec_launches": spec["spec_launches"],
        # phase 15b: rank 0's count over the speculative case at model=2 (the draft's 16/4 heads, D = 64)
        "spec_mesh_launches": mesh["spec_mesh_launches"],
        "prefix_launches": prefix_launches,
        "cli_launches": cli["cli_launches"],
        "replica_launches": replica["replica_launches"],
        # phase 18a: the fleet's waves, host 0's launches in this process and host 1's in its worker
        "fleet_launches": fleet["fleet_launches"],
        # phase 19a: the replays through phase 8's app; phase 20b: the remote predict job's child
        "replay_launches": replayed["launches"],
        "remote_launches": remote["launches"]["paged_decode_attention"],
        **numbers,
    }]
    for name, measured in flash_numbers.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": FLASH_SOURCES[name],
            "replaces": FLASH_REPLACES[name], "launches": flash_launches[name], "app_launches": app_launches[name],
            "http_launches": http_launches[name],
            # phase 20b: the remote training job's child (the bf16 pair only)
            **({"remote_launches": remote["launches"][name]} if name in remote["launches"] else {}),
            **measured,
        })
    kernels.append({
        "name": "int8_matmul", "route": "cuda", "source": "unionml_tpu_torch/csrc/int8_matmul.cu",
        "replaces": "unionml_tpu/ops/int8_matmul.py:102", "launches": int8_launches,
        "app_launches": app_launches["int8_matmul"],
        "http_launches": http_launches["int8_matmul"],
        "spec_launches": spec_int8_launches,
        "tp_shards": mesh["shards"]["shards"],
        "tp_shards_max_abs_err": mesh["shards"]["max_abs_err"],
        **int8_numbers,
    })
    kernels.append({
        "name": "paged_decode_attention_int8", "route": "cuda",
        "source": "unionml_tpu_torch/csrc/paged_decode_attention_int8.cu",
        "replaces": "unionml_tpu/ops/paged_attention.py:75-84",
        # the engine serves int8 pages through the gather path, as the JAX package does: the mode's launches are
        # phase 9c's calls on the live int8 pools of that run
        **pool,
        **int8_page_numbers,
    })
    for kernel in kernels:  # MoE reaches no port kernel (phase 12a counted every one, and required 0)
        kernel["moe_launches"] = moe["moe_launches"][kernel["name"]]
        # phase 15b: rank 0's counts over its ten served runs (the flash kernels and int8 pages counted 0)
        kernel["tp_launches"] = mesh["tp_launches"][kernel["name"]]
        # phase 13: 13b's step through the encoder stack, the f32 stack of 13e, and 13a + 13c + 13d (all 0)
        kernel["encoder_launches"] = encoder["launches"][kernel["name"]]
        kernel["encoder_f32_launches"] = encoder_f32["launches"][kernel["name"]]
        kernel["encoder_model_launches"] = model_launches[kernel["name"]]
        # phase 16: the mesh training path (16a and rank 0 of 16b, bf16; rank 0 of 16c, f32), at each rank's heads
        kernel["train_mesh_launches"] = train_mesh["launches"][kernel["name"]]
        kernel["train_mesh_f32_launches"] = train_mesh["f32_launches"][kernel["name"]]
        # phase 17a: the graph route's profiled served runs (bf16 hit, int8), counted from the traces by kernel name
        kernel["aot_launches"] = aot["launches"][kernel["name"]]
        # phase 15b: the AOT store over the mesh, rank 0's counts over the hits' served runs (bf16 and int8, model=2)
        kernel["aot_mesh_launches"] = mesh["aot_mesh_launches"][kernel["name"]]
        if kernel["name"] in FLASH_PRODUCTS:
            kernel["train_mesh_max_abs_err"] = train_mesh["max_abs_err"]
    for kernel in kernels:
        if kernel["name"] == "flash_forward":  # the encoder stack's worst output/gradient difference (13b)
            kernel["encoder_max_abs_err"] = encoder["max_abs_err"]
            kernel["encoder_step_ms"], kernel["encoder_plain_step_ms"] = encoder["flash_ms"], encoder["plain_ms"]
            kernel["encoder_step_device_ms"] = encoder["flash_device_ms"]
            kernel["encoder_plain_step_device_ms"] = encoder["plain_device_ms"]
    require(all(k["launches"] > 0 for k in kernels), "a kernel of the main paths never launched")
    require(kernels[0]["prefix_launches"] > 0, "the paged kernel never launched on the prefix path")
    require(kernels[0]["replica_launches"] > 0, "the paged kernel never launched on the replica path")
    require(kernels[0]["fleet_launches"] > 0, "the paged kernel never launched on the fleet path")
    require(kernels[0]["replay_launches"] > 0, "the paged kernel never launched in the replays")
    require(all(k["remote_launches"] > 0 for k in kernels if "remote_launches" in k)
            and sum("remote_launches" in k for k in kernels) == 3, "a kernel never launched on the remote paths")
    require(all(k["aot_launches"] > 0 for k in kernels if k["name"] in ("paged_decode_attention", "int8_matmul")),
            "a kernel of the graph route never launched in phase 17a")
    require(all(k["aot_mesh_launches"] > 0 for k in kernels if k["name"] in ("paged_decode_attention", "int8_matmul")),
            "a kernel of the graph route over the mesh never launched in phase 15b")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
