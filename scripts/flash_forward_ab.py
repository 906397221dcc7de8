#!/usr/bin/env python3
"""Time this tree's bf16 flash forward against another tree's on one CUDA card.

Run from the repository root, with a checkout of the other tree (for
example the parent commit, unpacked with ``git archive``)::

    python3 scripts/flash_forward_ab.py --other chip_checkout/parent

Each tree's kernels are built with its own ``_build.py``. The forward of one
bf16 attention call at the training shape (B=1, L=2048, H=32, Hkv=8, D=128,
causal) is then timed through each tree's ``flash_forward`` (with its output
allocations): this tree's tensor-core kernel, and whatever kernel the other
tree's wrapper launches for bf16 (a tree before the tensor-core forward takes
the scalar kernel of ``csrc/flash_attention.cu``). Times are device-only,
with ``chip_smoke.py``'s timer (the card spins while the host enqueues), in
turns (other, this, this, other). The two trees' outputs are held against
each other first. Prints the card, one line of times, and a last JSON line
with every number.
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

BATCH, SEQ, HEADS, KV_HEADS, HEAD_DIM = 1, 2048, 32, 8, 128


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
    this_build = sys.modules["unionml_tpu_torch._build"]
    sys.modules["unionml_tpu_torch._build"] = build
    try:
        fns = {name: wrapper._kernel(name) for name in names}
    finally:
        sys.modules["unionml_tpu_torch._build"] = this_build
    wrapper._kernel = lambda name: fns[name]
    return lambda q, k, v: wrapper.flash_forward(q, k, v, True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--other", type=Path, required=True, help="root of the other tree's checkout")
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
    _build.build_all(["flash_attention", "flash_forward"])
    trees = {"other": other_forward(args.other.resolve()), "this": lambda q, k, v: this.flash_forward(q, k, v, True)}

    g = torch.Generator(device="cuda").manual_seed(7)

    def make(heads):
        return torch.randn(BATCH, SEQ, heads, HEAD_DIM, device="cuda", generator=g).to(torch.bfloat16)

    q, k, v = make(HEADS), make(KV_HEADS), make(KV_HEADS)
    diffs = {}
    for name, x, y in zip(("out", "lse"), trees["other"](q, k, v), trees["this"](q, k, v)):
        err = (x.float() - y.float()).abs()
        diffs[name] = err.max().item()
        # both round P to bf16 before P.V (or one keeps it in f32) and the output to 8 bits
        chip_smoke.require(bool((err <= 2e-2 + 2e-2 * x.float().abs()).all()),
                           f"the two trees' {name} disagree: max abs {diffs[name]}")
    runs = {"other": [], "this": []}
    for name in ("other", "this", "this", "other"):
        fn = trees[name]
        runs[name].append(chip_smoke.device_ms(lambda: fn(q, k, v)))
    row = {name: {"device_ms": statistics.mean(r[0] for r in rs), "host_ms": statistics.mean(r[1] for r in rs),
                  "device_ms_runs": [r[0] for r in rs]} for name, rs in runs.items()}
    bound, bound_by = chip_smoke.flash_bound_ms("flash_forward", q, k, True)
    print(f"bf16 forward B={BATCH} L={SEQ} H={HEADS} Hkv={KV_HEADS} D={HEAD_DIM} causal, device-only: other "
          f"{row['other']['device_ms']:.4f} ms {row['other']['device_ms_runs']}, this "
          f"{row['this']['device_ms']:.4f} ms {row['this']['device_ms_runs']} "
          f"({row['other']['device_ms'] / row['this']['device_ms']:.2f}x); host enqueue other "
          f"{row['other']['host_ms']:.4f} ms, this {row['this']['host_ms']:.4f} ms; bound {bound:.4f} ms ({bound_by}, "
          f"2 products); outputs within {diffs}", flush=True)
    print(card, flush=True)
    print(json.dumps({"flash_forward_ab": {"card": card, "bound_ms": bound, "max_abs_diff": diffs, **row}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
