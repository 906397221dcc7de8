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

``--profile`` adds one more served run (bf16 and int8) and one more training
step under ``torch.profiler`` and prints each device-time breakdown (kernel time by
name, the device's idle share).

Prints one ``{"kernels": [...]}`` line and ends with
``{"ok": true, "device": {...}}``. Exits non-zero without a result when no
CUDA device is present or the package is missing.
"""

import collections
import contextlib
import dataclasses
import functools
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
#: (label, Lq, Lk, causal, D, misaligned) held beside FLASH_CASES: in bfloat16 a ragged D=64 case for the bf16
#: kernels; in float32 a head dim that is not a multiple of 4 (4-byte copies) and tensors that start 4 bytes past
#: a 16-byte boundary
FUSED_EXTRA_CASES = (("ragged D=64 causal L=1000", 1000, 1000, True, 64, False),)
F32_EXTRA_CASES = (("ragged D=50 causal L=1000", 1000, 1000, True, 50, False),
                   ("misaligned causal L=1000", 1000, 1000, True, 128, True))
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


def profile_run(label: str, fn) -> None:
    """Run ``fn`` once more under ``torch.profiler`` and print where the
    device time goes: kernel time by name (the 12 largest, and every kernel
    of the port's), and the device's busy share of the wall time (the rest is
    the host launching eager PyTorch ops)."""
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

    def inputs(q_len, k_len, dtype, seed, head_dim=128, misaligned=False):
        g = torch.Generator(device="cuda").manual_seed(seed)
        def make(length, heads):
            x = torch.randn(1, length, heads, head_dim, device="cuda", generator=g).to(dtype)
            if not misaligned:
                return x
            flat = torch.empty(x.numel() + 1, dtype=dtype, device="cuda")[1:]  # 4 bytes past the allocation
            return flat.copy_(x.flatten()).view(x.shape)

        return make(q_len, 32), make(k_len, 8), make(k_len, 8), make(q_len, 32)

    worst = {name: 0.0 for name in FLASH_PRODUCTS}
    cases = [(label, q_len, k_len, causal, 128, False) for label, q_len, k_len, causal, _ in FLASH_CASES]
    for dtype in (torch.float32, torch.bfloat16):
        atol, rtol = FLASH_TOLERANCE[str(dtype)]
        bf16 = dtype == torch.bfloat16
        extra = list(FUSED_EXTRA_CASES if bf16 else F32_EXTRA_CASES)
        forward, backward = ("flash_forward", "flash_backward") if bf16 else ("flash_forward_f32", "flash_backward_f32")
        for seed, (label, q_len, k_len, causal, head_dim, misaligned) in enumerate(cases + extra):
            q, k, v, dout = inputs(q_len, k_len, dtype, seed, head_dim, misaligned)
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
            print(f"flash kernels {dtype} {label} D={head_dim}: max_abs_err {', '.join(errors)} "
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


def training_phase(card: str, profile: bool) -> dict:
    """LoRA fine-tune at Llama-3-8B width through ``fit``: returns the flash
    kernels' launch counts on this run."""
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
    tokens = np.random.RandomState(1).randint(0, cfg.vocab_size, size=(TRAIN_STEPS, TRAIN_SEQ)).astype(np.int64)
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
    return launches


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


def http_phase(card: str, cfg, gcfg, prompts, slots: int, decode_chunk: int, bf16: dict, profile: bool) -> dict:
    """Phase 8, the serving half: ``Model.serve()`` on the bf16 serving model,
    ``HTTPServer.serve`` on an ephemeral loopback port, driven by
    ``http.client`` from threads through ``/predict``, ``/predict-stream``,
    ``/v1/completions``, ``/metrics``, ``/healthz`` and ``/debug/requests``;
    then the SIGTERM-path drain. Returns each kernel's launches across the
    HTTP requests."""
    import asyncio

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

    # ---- the server on an ephemeral loopback port, its loop on its own thread
    loop = asyncio.new_event_loop()
    server_thread = threading.Thread(
        target=loop.run_until_complete, args=(app.server.serve("127.0.0.1", 0),), daemon=True
    )
    server_thread.start()
    for _ in range(500):
        if app.server._server is not None and app.server._server.sockets:
            break
        time.sleep(0.01)
    port = app.server._server.sockets[0].getsockname()[1]

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

    if profile:
        profile_run("HTTP /predict-stream 4 streams",
                    lambda: concurrent([functools.partial(stream_one, p) for p in prompts]))

    # ---- drain: the SIGTERM path (shutdown), which closes the engine
    asyncio.run_coroutine_threadsafe(app.server.shutdown(drain_timeout_s=60), loop).result(timeout=120)
    server_thread.join(timeout=60)
    leftover = asyncio.all_tasks(loop)  # the micro-batcher's collector waits on its queue forever
    for task in leftover:
        task.cancel()
    loop.run_until_complete(asyncio.gather(*leftover, return_exceptions=True))
    loop.close()
    if batcher._thread is not None:
        batcher._thread.join(timeout=60)
    require(not server_thread.is_alive() and batcher._closed and not (batcher._thread and batcher._thread.is_alive()),
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
    return http_launches


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
    pools, lens, table = engine._carry[0], seen["lengths"], seen["table"]
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
    flash_launches = training_phase(card, args.profile)
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
    http_launches = http_phase(card, cfg, gcfg, prompts, slots, decode_chunk, bf16, args.profile)
    torch.cuda.empty_cache()

    # ---- phase 9: speculative decoding and beam search; the int8-page mode on a live pool
    t0 = time.perf_counter()
    target = Llama(cfg, seed=0)  # phase 3's weights
    torch.cuda.synchronize()
    print(f"phase 9: the bf16 target (phase 3's weights) rebuilt in {time.perf_counter() - t0:.1f} s", flush=True)
    spec = spec_serving_phase(card, target, gcfg, prompts, slots, decode_chunk, bf16, bf16_streams)
    pool = int8_pool_phase(card, target, gcfg, prompts, slots, decode_chunk)
    del target
    torch.cuda.empty_cache()
    spec_int8_launches = spec_parity_phase(gcfg, prompts, slots, decode_chunk)
    print(f"phase 9 took {time.perf_counter() - t0:.1f} s", flush=True)

    kernels = [{
        "name": "paged_decode_attention",
        "route": "cuda",
        "source": "unionml_tpu_torch/csrc/paged_decode_attention.cu",
        "replaces": "unionml_tpu/ops/paged_attention.py:84",
        "launches": launches,
        "app_launches": app_launches["paged_decode_attention"],
        "http_launches": http_launches["paged_decode_attention"],
        "spec_launches": spec["spec_launches"],
        **numbers,
    }]
    for name, measured in flash_numbers.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": FLASH_SOURCES[name],
            "replaces": FLASH_REPLACES[name], "launches": flash_launches[name], "app_launches": app_launches[name],
            "http_launches": http_launches[name],
            **measured,
        })
    kernels.append({
        "name": "int8_matmul", "route": "cuda", "source": "unionml_tpu_torch/csrc/int8_matmul.cu",
        "replaces": "unionml_tpu/ops/int8_matmul.py:102", "launches": int8_launches,
        "app_launches": app_launches["int8_matmul"],
        "http_launches": http_launches["int8_matmul"],
        "spec_launches": spec_int8_launches,
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
    require(all(k["launches"] > 0 for k in kernels), "a kernel of the main paths never launched")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
