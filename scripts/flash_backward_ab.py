#!/usr/bin/env python3
"""Time this tree's flash backward against another tree's on one CUDA card.

Run from the repository root, with a checkout of the other tree (for
example the parent commit, unpacked with ``git archive``)::

    python3 scripts/flash_backward_ab.py --other chip_checkout/parent [--dtype float32]

Each tree's kernels are built with its own ``_build.py``. The backward of one
attention call (B=1, H=32, Hkv=8, D=128, causal) is then timed through each
tree's ``flash_backward``, which routes by dtype: in bfloat16 (the default) at
the training shape L=2048, in float32 at the f32 parity shape L=256 and at
L=2048. A tree without ``flash_backward`` is timed through its
``flash_backward_dq`` followed by its ``flash_backward_dkv`` (the separate dq
and dk/dv kernels). Times are device-only, with ``chip_smoke.py``'s timer
(the card spins while the host enqueues), in turns (other, this, this,
other). The two trees' outputs are held against each other first. Prints the
card, one line of times a shape, and a last JSON line with every number.
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
#: (atol, rtol) between the two trees' outputs: bf16 outputs round to 8 bits from f32 sums taken in other
#: orders; f32 sums in other orders (and 3xTF32 or f32 products), the card tests' f32 tolerance
TOLERANCE = {"bfloat16": (2e-2, 2e-2), "float32": (1e-4, 1e-5)}
#: the C entry of a tree's fused backward for each dtype, and what to call it; a tree without one runs the pair
FUSED = {"bfloat16": ("flash_attention_backward_fused", "fused"),
         "float32": ("flash_attention_backward_f32", "fused f32 (3xTF32)")}
PAIR = ("flash_attention_backward_dq", "flash_attention_backward_dkv")


def load_module(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def other_backward(tree: Path, dtype: str):
    """The other tree's backward of one call, ``(q, k, v, dout, lse, delta) ->
    (dq, dk, dv)``, launching the other tree's kernels (its libraries are
    built together, and each C function is resolved once against the other
    tree's ``_build``), and what it runs."""
    build = load_module("other_flash_build", tree / "unionml_tpu_torch" / "_build.py")
    wrapper = load_module("other_flash_attention", tree / "unionml_tpu_torch" / "ops" / "flash_attention.py")
    entries = wrapper._ENTRIES
    fused, label = FUSED[dtype]
    kind, names = (label, [fused]) if fused in entries else ("dq + dk/dv", [name for name in PAIR if name in entries])
    build.build_all(sorted({entries[name][0] for name in names}))
    this_build = sys.modules["unionml_tpu_torch._build"]
    sys.modules["unionml_tpu_torch._build"] = build
    try:
        fns = {name: wrapper._kernel(name) for name in names}
    finally:
        sys.modules["unionml_tpu_torch._build"] = this_build
    wrapper._kernel = lambda name: fns[name]
    if hasattr(wrapper, "flash_backward"):
        return kind, lambda *a: wrapper.flash_backward(*a, True)

    def pair(*a):
        return (wrapper.flash_backward_dq(*a, True), *wrapper.flash_backward_dkv(*a, True))

    return kind, pair


def compare(seq: int, dtype, trees: dict, this, other_kind: str, g) -> dict:
    """The two trees' outputs held against each other at length ``seq``, then
    their device-only times in turns."""
    import torch

    import chip_smoke

    def make(heads):
        return torch.randn(BATCH, seq, heads, HEAD_DIM, device="cuda", generator=g).to(dtype)

    name = str(dtype)[6:]
    q, k, v, dout = make(HEADS), make(KV_HEADS), make(KV_HEADS), make(HEADS)
    out, lse = this.flash_forward(q, k, v, True)
    delta = torch.einsum("blhd,blhd->bhl", dout.float(), out.float())
    operands = (q, k, v, dout, lse, delta)
    a, b = trees["other"](*operands), trees["this"](*operands)
    atol, rtol = TOLERANCE[name]
    diffs = {}
    for what, x, y in zip(("dq", "dk", "dv"), a, b):
        err = (x.float() - y.float()).abs()
        diffs[what] = err.max().item()
        chip_smoke.require(bool((err <= atol + rtol * x.float().abs()).all()),
                           f"the two trees' {what} disagree at L={seq}: max abs {diffs[what]}")
    runs = {"other": [], "this": []}
    for tree in ("other", "this", "this", "other"):
        fn = trees[tree]
        runs[tree].append(chip_smoke.device_ms(lambda: fn(*operands)))
    row = {tree: {"device_ms": statistics.mean(r[0] for r in rs), "host_ms": statistics.mean(r[1] for r in rs),
                  "device_ms_runs": [r[0] for r in rs]} for tree, rs in runs.items()}
    this_name = "flash_backward_f32" if name == "float32" else "flash_backward"
    bound, bound_by = chip_smoke.flash_bound_ms(this_name, q, k, True)
    print(f"{name} backward B={BATCH} L={seq} H={HEADS} Hkv={KV_HEADS} D={HEAD_DIM} causal, device-only: other "
          f"({other_kind}) {row['other']['device_ms']:.4f} ms {row['other']['device_ms_runs']}, this "
          f"{row['this']['device_ms']:.4f} ms {row['this']['device_ms_runs']} "
          f"({row['other']['device_ms'] / row['this']['device_ms']:.2f}x); host enqueue other "
          f"{row['other']['host_ms']:.4f} ms, this {row['this']['host_ms']:.4f} ms; bound {bound:.4f} ms ({bound_by}, "
          f"5 products), this at {bound / row['this']['device_ms']:.1%} of it; outputs within {diffs}", flush=True)
    return {"seq": seq, "bound_ms": bound, "max_abs_diff": diffs, **row}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--other", type=Path, required=True, help="root of the other tree's checkout")
    parser.add_argument("--dtype", choices=sorted(SEQS), default="bfloat16", help="the inputs' type")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("flash_backward_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from unionml_tpu_torch import _build

    this = importlib.import_module("unionml_tpu_torch.ops.flash_attention")  # the package re-exports the function
    card = chip_smoke.card_line()
    print(card, flush=True)
    _build.build_all(sorted({library for library, _, _ in this._ENTRIES.values()}))
    other_kind, other = other_backward(args.other.resolve(), args.dtype)
    trees = {"other": other, "this": lambda *a: this.flash_backward(*a, True)}
    g = torch.Generator(device="cuda").manual_seed(7)
    rows = [compare(seq, getattr(torch, args.dtype), trees, this, other_kind, g) for seq in SEQS[args.dtype]]
    print(card, flush=True)
    print(json.dumps({"flash_backward_ab": {"card": card, "dtype": args.dtype, "other_kind": other_kind,
                                            "shapes": rows}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
