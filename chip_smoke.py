#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``unionml_tpu_torch``) on one NVIDIA H100.

Run from the repository root on a machine with one CUDA card::

    python3 chip_smoke.py

Phases (no phase catches a failure; any fault exits non-zero):

1. print the card's name and power limit; build every kernel from ``csrc/``;
2. hold each kernel against its plain PyTorch twin at full-width shapes
   (float32 and bfloat16) and time kernel, twin, the library yardstick and
   the bytes/operations bound with CUDA events;
3. serve a Llama-3-8B-width model (32 layers, bf16, random weights from a
   seed) through ``ContinuousBatcher``: 4 concurrent streams x 32 tokens,
   counting kernel launches on the main path;
4. token parity at float32 with 2 layers of the same width: the engine's
   streams (kernel path) equal a solo ``Generator`` run on the gather path.

``--profile`` adds one more served run under ``torch.profiler`` and prints
the device-time breakdown (kernel time by name, the device's idle share).

Prints one ``{"kernels": [...]}`` line and ends with
``{"ok": true, "device": {...}}``. Exits non-zero without a result when no
CUDA device is present or the package is missing.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import threading
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
PEAK_OPS_PER_S = {"torch.bfloat16": 989e12, "torch.float32": 67e12}  # dense bf16 tensor / f32 non-tensor
TOLERANCE = {"torch.float32": (1e-5, 0.0), "torch.bfloat16": (2e-2, 2e-2)}  # (atol, rtol)
PROMPT_LENS = (5, 40, 120, 250)
MAX_NEW = 32
BLOCK = 16


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


def paged_inputs(batch, lengths, n_pages, pages_per_seq, dtype, seed):
    """Random q and pools, and a table whose rows own disjoint real pages
    (the last pool page is the engine's scratch page)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(batch, 32, 128, device="cuda", generator=g).to(dtype)
    k = torch.randn(8, n_pages, BLOCK, 128, device="cuda", generator=g).to(dtype)
    v = torch.randn(8, n_pages, BLOCK, 128, device="cuda", generator=g).to(dtype)
    perm = torch.randperm(n_pages - 1, device="cuda", generator=g)
    table = perm[: batch * pages_per_seq].reshape(batch, pages_per_seq).to(torch.int32).contiguous()
    return q, k, v, torch.tensor(lengths, dtype=torch.int32, device="cuda"), table


def bound_ms(q, k_pages, lengths, pages_per_seq) -> tuple:
    """Least time for one call: every visible K/V row, q, the output and the
    table entries in use moved once, against 4 * H * D operations per visible
    position (q.k and p.v) at the peak rate of the input type."""
    n_kv, _, page, head_dim = k_pages.shape
    visible = int(lengths.sum())
    pages_used = int(((lengths + page - 1) // page).sum())
    item = k_pages.element_size()
    moved = 2 * visible * n_kv * head_dim * item + 2 * q.numel() * item + 4 * (lengths.numel() + pages_used)
    ops = 4 * visible * q.shape[1] * head_dim
    by_bytes, by_ops = moved / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[str(q.dtype)]
    return max(by_bytes, by_ops) * 1e3, ("bytes" if by_bytes >= by_ops else "operations")


def kernel_phase(pool_pages: int, pages_per_seq: int) -> dict:
    import torch
    import torch.nn.functional as F

    from unionml_tpu_torch.ops.paged_attention import paged_decode_attention, paged_decode_attention_reference

    table_end = pages_per_seq * BLOCK
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        atol, rtol = TOLERANCE[str(dtype)]
        for seed, lengths in enumerate(((1, 17, 64, 300), (table_end, 48, 16, 255))):
            q, k, v, lens, table = paged_inputs(4, lengths, pool_pages, pages_per_seq, dtype, seed)
            out = paged_decode_attention(q, k, v, lens, table)
            torch.cuda.synchronize()
            ref = paged_decode_attention_reference(q, k, v, lens, table)
            err = (out.float() - ref.float()).abs()
            ok = bool((err <= atol + rtol * ref.float().abs()).all())
            print(f"paged_decode_attention {dtype} B=4 lengths={lengths}: max_abs_err={err.max().item()} "
                  f"(tolerance atol={atol} rtol={rtol}) {'ok' if ok else 'FAIL'}", flush=True)
            require(ok, "paged_decode_attention disagrees with its plain twin")
            if dtype == torch.bfloat16:
                worst = max(worst, err.max().item())

    served = None
    # the served shape (decode lengths at the end of the 32-token streams) and a long-context one
    shapes = (
        ("served", 4, [n + MAX_NEW for n in PROMPT_LENS], pool_pages, pages_per_seq),
        ("B=8 ctx=2048", 8, [2048] * 8, 8 * 128 + 1, 128),
    )
    for label, batch, lengths, n_pages, pps in shapes:
        q, k, v, lens, table = paged_inputs(batch, lengths, n_pages, pps, torch.bfloat16, 7)
        ms = time_ms(lambda: paged_decode_attention(q, k, v, lens, table))
        plain_ms = time_ms(lambda: paged_decode_attention_reference(q, k, v, lens, table))
        # library yardstick: SDPA over K/V gathered beforehand (not part of the port)
        kg = k[:, table.long()].reshape(8, batch, -1, 128).permute(1, 0, 2, 3).contiguous()
        vg = v[:, table.long()].reshape(8, batch, -1, 128).permute(1, 0, 2, 3).contiguous()
        mask = (torch.arange(kg.shape[2], device="cuda")[None] < lens[:, None])[:, None, None]
        q4 = q[:, :, None]
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(q4, kg, vg, attn_mask=mask, enable_gqa=True))
        bms, bound_by = bound_ms(q, k, lens, pps)
        print(f"paged_decode_attention bf16 {label} lengths={lengths[:4]}{'...' if batch > 4 else ''}: "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library (SDPA on gathered K/V) {library_ms:.4f} ms, "
              f"bound {bms:.4f} ms ({bound_by}), {bms / ms:.1%} of bound", flush=True)
        if served is None:
            served = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=bound_by, library_ms=library_ms)
    return dict(max_abs_err=worst, **served)


def serve(batcher, prompts) -> tuple:
    """Submit every prompt from its own thread; return (streams, seconds)."""
    results = [None] * len(prompts)

    def worker(i):
        results[i] = [int(t) for chunk in batcher.submit(prompts[i]) for t in chunk]

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(prompts))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
        if t.is_alive():
            raise TimeoutError("a stream did not finish within 600 s")
    return results, time.perf_counter() - t0


def profile_serving(batcher, prompts) -> None:
    """Serve ``prompts`` once more under ``torch.profiler`` and print where the
    device time goes: kernel time by name, and the device's busy share of the
    wall time (the rest is the host launching eager PyTorch ops)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, seconds = serve(batcher, prompts)
        torch.cuda.synchronize()
    by_name: dict = {}
    for event in prof.events():
        if str(event.device_type).endswith("CUDA") and event.device_time > 0:
            total, count = by_name.get(event.name, (0.0, 0))
            by_name[event.name] = (total + event.device_time / 1e3, count + 1)  # us -> ms
    busy_ms = sum(total for total, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    print(json.dumps({"profile": {
        "wall_ms": seconds * 1e3, "device_busy_ms": busy_ms, "device_idle_share": 1 - busy_ms / (seconds * 1e3),
        "top_kernels": [{"name": name[:120], "ms": total, "calls": count, "share_of_busy": total / busy_ms}
                        for name, (total, count) in top],
    }}), flush=True)


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

    # ---- phase 2: kernel against its plain twin, and times
    numbers = kernel_phase(pool_pages, pages_per_seq)

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
    if args.profile:
        profiled = ContinuousBatcher(gen, slots=slots, decode_chunk=decode_chunk, block_size=BLOCK)
        profile_serving(profiled, prompts)
        profiled.close()
        del profiled
    del model, gen, warm, batcher
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

    print(json.dumps({"kernels": [{
        "name": "paged_decode_attention",
        "route": "cuda",
        "source": "unionml_tpu_torch/csrc/paged_decode_attention.cu",
        "replaces": "unionml_tpu/ops/paged_attention.py:84",
        "launches": launches,
        **numbers,
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
