#!/usr/bin/env python3
"""Time this tree's paged decode kernel against another tree's on one CUDA card.

Run from the repository root, with a checkout of the other tree (for
example the parent commit, unpacked with ``git archive``)::

    python3 scripts/paged_decode_ab.py --other chip_checkout/parent
    python3 scripts/paged_decode_ab.py --other chip_checkout/parent --int8
    python3 scripts/paged_decode_ab.py --other chip_checkout/parent --int8 --dtype float32
    python3 scripts/paged_decode_ab.py --other chip_checkout/parent --page-size 32

Both trees' ``csrc/paged_decode_attention.cu`` (with ``--int8``:
``csrc/paged_decode_attention_int8.cu``, over int8 pages with f32 scales per
position and KV head as the engine stores them) are built with their own
``_build.py``. Each kernel is then timed through its own wrapper at
``chip_smoke.py``'s three paged shapes (the served one, B=8 ctx=2048 and
B=1 ctx=8192; H=32, H_kv=8, D=128; q in ``--dtype``, bf16 by default, and
pages of ``--page-size`` positions, 16 by default, the tables rescaled to the
same context), in turns (other, this, this, other), with ``chip_smoke.py``'s
device-only timer (``device_ms``) and its host enqueue a call
(``host_ms``). The outputs of the two kernels are held against each other
first, within ``chip_smoke.py``'s tolerance for q's dtype. With ``--serve``
it also
serves ``chip_smoke.py``'s full-width model (32 layers, bf16, random weights)
through ``ContinuousBatcher`` in turns, once with each tree's wrapper in place
of this package's (other, this, this, other), and reports tok/s, TTFT and
the decode dispatch gap of each run. Prints the card, one line a shape (and
a run), and a last JSON line with every number.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def load_module(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def other_wrapper(tree: Path, kernel: str):
    """The other tree's ``ops/paged_attention.py``, launching the other
    tree's kernel (its ``kernel`` loader, ``_kernel`` or ``_int8_kernel``,
    is resolved once against the other ``_build``)."""
    build = load_module("other_paged_build", tree / "unionml_tpu_torch" / "_build.py")
    wrapper = load_module("other_paged_attention", tree / "unionml_tpu_torch" / "ops" / "paged_attention.py")
    this_build = sys.modules["unionml_tpu_torch._build"]
    sys.modules["unionml_tpu_torch._build"] = build
    try:
        fn = getattr(wrapper, kernel)()
    finally:
        sys.modules["unionml_tpu_torch._build"] = this_build
    setattr(wrapper, kernel, lambda: fn)
    return wrapper


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--other", type=Path, required=True, help="root of the other tree's checkout")
    parser.add_argument("--serve", action="store_true", help="also serve the full-width model with each kernel in turns")
    parser.add_argument("--int8", action="store_true", help="time the int8-page mode's kernel (over int8 pages)")
    parser.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16", help="q's dtype (and the "
                        "float pages')")
    parser.add_argument("--page-size", type=int, default=16, help="positions a page")
    args = parser.parse_args()
    if args.int8 and args.serve:
        parser.error("--serve times the float-page kernel on the served path; int8 pages are served by the gather route")

    import torch

    if not torch.cuda.is_available():
        print("paged_decode_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from unionml_tpu_torch import _build
    from unionml_tpu_torch.ops import paged_attention as this

    card = chip_smoke.card_line()
    print(card, flush=True)
    kernel = "paged_decode_attention_int8" if args.int8 else "paged_decode_attention"
    _build.build_all([kernel])
    other = other_wrapper(args.other.resolve(), "_int8_kernel" if args.int8 else "_kernel")
    trees = {"other": other.paged_decode_attention, "this": this.paged_decode_attention}
    make = chip_smoke.int8_pages if args.int8 else chip_smoke.float_pages
    dtype, page = getattr(torch, args.dtype), args.page_size
    atol, rtol = chip_smoke.TOLERANCE[str(dtype)]

    # the engine geometry chip_smoke.py serves: 4 slots, a 256-token bucket, 32 new tokens, decode chunk 8
    pages_per_seq = -(-(256 + chip_smoke.MAX_NEW + 8) // chip_smoke.BLOCK)
    results = {}
    for label, batch, lengths, n_pages, pps in chip_smoke.paged_shapes(4 * pages_per_seq + 1, pages_per_seq):
        pps, used = -(-pps * chip_smoke.BLOCK // page), -(-(n_pages - 1) * chip_smoke.BLOCK // page)
        n_pages = max(used, batch * pps) + 1  # the same context in pages of `page` positions
        q, k, v, lens, table, kw = make(batch, lengths, n_pages, pps, dtype, 7, 128, page)
        a = trees["other"](q, k, v, lens, table, **kw).float()
        b = trees["this"](q, k, v, lens, table, **kw).float()
        diff = (a - b).abs().max().item()
        chip_smoke.require(bool(((a - b).abs() <= atol + rtol * a.abs()).all()),
                           f"the two kernels disagree at {label}: {diff}")
        runs = {"other": [], "this": []}
        for name in ("other", "this", "this", "other"):
            fn = trees[name]
            runs[name].append(chip_smoke.device_ms(lambda: fn(q, k, v, lens, table, **kw)))
        row = {name: {"device_ms": statistics.mean(r[0] for r in rs), "host_ms": statistics.mean(r[1] for r in rs),
                      "device_ms_runs": [r[0] for r in rs], "host_ms_runs": [r[1] for r in rs]}
               for name, rs in runs.items()}
        bms, bound_by = chip_smoke.bound_ms(q, k, lens, pps, scale_item=4 if kw else 0)
        results[label] = dict(row, batch=batch, lengths=lengths, bound_ms=bms, bound_by=bound_by, max_abs_diff=diff)
        print(f"{label} ({args.dtype} q, {page}-position pages): device-only other {row['other']['device_ms']:.4f} ms {row['other']['device_ms_runs']}, "
              f"this {row['this']['device_ms']:.4f} ms {row['this']['device_ms_runs']} "
              f"({row['other']['device_ms'] / row['this']['device_ms']:.2f}x; bound {bms:.6f} ms, {bound_by}); "
              f"host enqueue other {row['other']['host_ms']:.4f} ms, this {row['this']['host_ms']:.4f} ms; "
              f"outputs within {diff:.2e}", flush=True)
        del q, k, v, lens, table, kw
        torch.cuda.empty_cache()
    served = serve_in_turns(trees) if args.serve else None
    print(card, flush=True)
    print(json.dumps({"paged_ab": {"card": card, "kernel": kernel, "dtype": args.dtype, "page_size": page,
                                   "shapes": results, "served": served}}), flush=True)
    return 0


def serve_in_turns(trees) -> dict:
    """``chip_smoke.py``'s served run (4 streams x 32 tokens) with each
    tree's wrapper in turns; the model reaches the wrapper through the
    module attribute, so swapping it swaps the kernel."""
    import numpy as np
    import torch

    import chip_smoke
    from unionml_tpu_torch import ContinuousBatcher, GenerationConfig, Generator, Llama, LlamaConfig
    from unionml_tpu_torch.ops import paged_attention as module

    cfg = LlamaConfig.llama3_8b(attention_impl="flash", dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, cfg.vocab_size, size=n).tolist() for n in chip_smoke.PROMPT_LENS]
    gcfg = GenerationConfig(prompt_buckets=(256,), max_new_tokens=chip_smoke.MAX_NEW, temperature=0.0)
    gen = Generator(Llama(cfg, seed=0), gcfg)
    own = module.paged_decode_attention
    runs = {"other": [], "this": []}
    try:
        warm = ContinuousBatcher(gen, slots=4, decode_chunk=8, block_size=chip_smoke.BLOCK)
        chip_smoke.serve(warm, [prompts[0][:3]])  # set-up: first cuBLAS/allocator calls
        warm.close()
        for name in ("other", "this", "this", "other"):
            module.paged_decode_attention = trees[name]
            batcher = ContinuousBatcher(gen, slots=4, decode_chunk=8, block_size=chip_smoke.BLOCK)
            streams, seconds = chip_smoke.serve(batcher, prompts)
            stats = batcher.stats()
            batcher.close()
            run = dict(tok_s=4 * chip_smoke.MAX_NEW / seconds, ttft_p50_ms=stats["ttft_ms"]["p50_ms"],
                       tbt_p50_ms=stats["tbt_ms"]["p50_ms"], streams=streams)
            runs[name].append(run)
            print(f"served with the {name} kernel: {run['tok_s']:.1f} tok/s, TTFT p50 {run['ttft_p50_ms']} ms, "
                  f"decode dispatch p50 {run['tbt_p50_ms']} ms", flush=True)
    finally:
        module.paged_decode_attention = own
    same = {name: rs[0]["streams"] == rs[1]["streams"] for name, rs in runs.items()}
    same["across trees"] = runs["this"][0]["streams"] == runs["other"][0]["streams"]
    print(f"greedy streams identical: within each tree {same['other']}, {same['this']}; across the trees "
          f"{same['across trees']} (bf16 kernels that round differently may flip a near tie)", flush=True)
    return {name: [{k: v for k, v in r.items() if k != "streams"} for r in rs] for name, rs in runs.items()} | {
        "streams_identical": same}


if __name__ == "__main__":
    sys.exit(main())
