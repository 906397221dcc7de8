#!/usr/bin/env python3
"""Time this tree's flash forward against another tree's on one CUDA card.

Run from the repository root, with a checkout of the other tree (for
example the parent commit, unpacked with ``git archive``)::

    python3 scripts/flash_forward_ab.py --other chip_checkout/parent [--dtype float32]

Each tree's kernels are built with its own ``_build.py``. The forward of one
attention call (B=1, H=32, Hkv=8, D=128, causal) is then timed through each
tree's ``flash_forward`` (with its output allocations), which routes by
dtype: in bfloat16 (the default) at the training shape L=2048, in float32 at
the f32 parity shape L=256 and at L=2048, beside SDPA's memory-efficient
kernel in f32 (the library yardstick, not part of the port). Times are
device-only, with ``chip_smoke.py``'s timer (the card spins while the host
enqueues), in turns (other, this, this, other). The two trees' outputs are
held against each other first. Prints the card, one line of times a shape,
and a last JSON line with every number.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

BATCH, HEADS, KV_HEADS, HEAD_DIM = 1, 32, 8, 128
#: the timed lengths of each dtype
SEQS = {"bfloat16": (2048,), "float32": (256, 2048)}
#: (atol, rtol) between the two trees' outputs: bf16 kernels round P to bf16 before P.V (or one keeps it in
#: f32) and the output to 8 bits; f32 sums in other orders (and 3xTF32 or f32 products), the card tests' f32
#: tolerance
TOLERANCE = {"bfloat16": (2e-2, 2e-2), "float32": (1e-4, 1e-5)}


def load_module(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def other_forward(tree: Path):
    """The other tree's ``flash_forward``, launching the other tree's kernels
    (each forward C function it names is resolved once against the other
    tree's ``_build``)."""
    build = load_module("other_flash_build", tree / "unionml_tpu_torch" / "_build.py")
    wrapper = load_module("other_flash_attention", tree / "unionml_tpu_torch" / "ops" / "flash_attention.py")
    names = [name for name in wrapper._ENTRIES if name.startswith("flash_attention_forward")]
    build.build_all(sorted({wrapper._ENTRIES[name][0] for name in names}))
    this_build = sys.modules["unionml_tpu_torch._build"]
    sys.modules["unionml_tpu_torch._build"] = build
    try:
        fns = {name: wrapper._kernel(name) for name in names}
    finally:
        sys.modules["unionml_tpu_torch._build"] = this_build
    wrapper._kernel = lambda name: fns[name]
    return lambda q, k, v: wrapper.flash_forward(q, k, v, True)


def compare(seq: int, dtype, trees: dict, g) -> dict:
    """The two trees' outputs held against each other at length ``seq``, then
    their device-only times in turns."""
    import torch
    from torch.nn.attention import SDPBackend

    import chip_smoke

    def make(heads):
        return torch.randn(BATCH, seq, heads, HEAD_DIM, device="cuda", generator=g).to(dtype)

    name = str(dtype)[6:]
    q, k, v = make(HEADS), make(KV_HEADS), make(KV_HEADS)
    atol, rtol = TOLERANCE[name]
    diffs = {}
    for what, x, y in zip(("out", "lse"), trees["other"](q, k, v), trees["this"](q, k, v)):
        err = (x.float() - y.float()).abs()
        diffs[what] = err.max().item()
        chip_smoke.require(bool((err <= atol + rtol * x.float().abs()).all()),
                           f"the two trees' {what} disagree at L={seq}: max abs {diffs[what]}")
    runs = {"other": [], "this": []}
    for tree in ("other", "this", "this", "other"):
        fn = trees[tree]
        runs[tree].append(chip_smoke.device_ms(lambda: fn(q, k, v)))
    row = {tree: {"device_ms": statistics.mean(r[0] for r in rs), "host_ms": statistics.mean(r[1] for r in rs),
                  "device_ms_runs": [r[0] for r in rs]} for tree, rs in runs.items()}
    library = None
    if dtype == torch.float32:
        library = chip_smoke.sdpa_times(q, k, v, q, True, SDPBackend.EFFICIENT_ATTENTION)["fwd_device_ms"]
    this_name = "flash_forward_f32" if name == "float32" else "flash_forward"
    bound, bound_by = chip_smoke.flash_bound_ms(this_name, q, k, True)
    print(f"{name} forward B={BATCH} L={seq} H={HEADS} Hkv={KV_HEADS} D={HEAD_DIM} causal, device-only: other "
          f"{row['other']['device_ms']:.4f} ms {row['other']['device_ms_runs']}, this "
          f"{row['this']['device_ms']:.4f} ms {row['this']['device_ms_runs']} "
          f"({row['other']['device_ms'] / row['this']['device_ms']:.2f}x); host enqueue other "
          f"{row['other']['host_ms']:.4f} ms, this {row['this']['host_ms']:.4f} ms; bound {bound:.4f} ms ({bound_by}, "
          f"2 products), this at {bound / row['this']['device_ms']:.1%} of it"
          f"{'' if library is None else f'; SDPA memory-efficient f32 {library:.4f} ms'}; outputs within {diffs}",
          flush=True)
    return {"seq": seq, "bound_ms": bound, "max_abs_diff": diffs, "sdpa_efficient_device_ms": library, **row}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--other", type=Path, required=True, help="root of the other tree's checkout")
    parser.add_argument("--dtype", choices=sorted(SEQS), default="bfloat16", help="the inputs' type")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("flash_forward_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from unionml_tpu_torch import _build

    this = importlib.import_module("unionml_tpu_torch.ops.flash_attention")  # the package re-exports the function
    card = chip_smoke.card_line()
    print(card, flush=True)
    _build.build_all(sorted({this._ENTRIES[name][0] for name in this._ENTRIES if "forward" in name}))
    trees = {"other": other_forward(args.other.resolve()), "this": lambda q, k, v: this.flash_forward(q, k, v, True)}
    g = torch.Generator(device="cuda").manual_seed(7)
    rows = [compare(seq, getattr(torch, args.dtype), trees, g) for seq in SEQS[args.dtype]]
    print(card, flush=True)
    print(json.dumps({"flash_forward_ab": {"card": card, "dtype": args.dtype, "shapes": rows}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
