#!/usr/bin/env python3
"""Time this tree's int8 matmul kernel against another tree's on one CUDA card.

Run from the repository root, with a checkout of the other tree (for
example the parent commit, unpacked with ``git archive``)::

    python3 scripts/int8_matmul_ab.py --other chip_checkout/parent

Both trees' ``csrc/int8_matmul.cu`` are built with their own ``_build.py``.
Each kernel is then timed through its own wrapper at every Llama-3-8B weight
shape at M = 4, 64 and 256 (bf16 in and out), in turns (other, this, this,
other), with ``chip_smoke.py``'s device-only timer (the card spins while the
host enqueues; ``device_ms``) and its host enqueue a call (``host_ms``). The
outputs of the two kernels are held against each other first. Prints the
card, one line a shape and M, the sums over one forward's 225 matmuls, and a
last JSON line with every number.
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

M_VALUES = (4, 64, 256)


def load_module(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def other_wrapper(tree: Path):
    """The other tree's ``ops/int8_matmul.py``, launching the other tree's
    kernel (its ``_kernel`` is resolved once against the other ``_build``)."""
    build = load_module("other_int8_build", tree / "unionml_tpu_torch" / "_build.py")
    wrapper = load_module("other_int8_matmul", tree / "unionml_tpu_torch" / "ops" / "int8_matmul.py")
    this_build = sys.modules["unionml_tpu_torch._build"]
    sys.modules["unionml_tpu_torch._build"] = build
    try:
        fn = wrapper._kernel()
    finally:
        sys.modules["unionml_tpu_torch._build"] = this_build
    wrapper._kernel = lambda: fn
    return wrapper


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--other", type=Path, required=True, help="root of the other tree's checkout")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("int8_matmul_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from unionml_tpu_torch import _build
    from unionml_tpu_torch.ops.quant import quantize_array

    this = importlib.import_module("unionml_tpu_torch.ops.int8_matmul")  # the package re-exports the function
    card = chip_smoke.card_line()
    print(card, flush=True)
    _build.build_all(["int8_matmul"])
    other = other_wrapper(args.other.resolve())
    trees = {"other": other.int8_matmul, "this": this.int8_matmul}

    g = torch.Generator(device="cuda").manual_seed(5)
    results = {}
    for label, k_dim, f_dim, per_forward in chip_smoke.INT8_WEIGHTS:
        qt = quantize_array(torch.randn(k_dim, f_dim, device="cuda", generator=g) * k_dim ** -0.5)
        for m in M_VALUES:
            x = torch.randn(m, k_dim, device="cuda", generator=g).to(torch.bfloat16)
            a = trees["other"](x, qt.q, qt.scale, out_dtype=torch.float32)
            b = trees["this"](x, qt.q, qt.scale, out_dtype=torch.float32)
            diff = (a - b).abs().max().item() / a.abs().max().item()
            chip_smoke.require(diff <= 1e-5, f"the two kernels disagree at [{k_dim}, {f_dim}] M={m}: {diff}")
            runs = {"other": [], "this": []}
            for name in ("other", "this", "this", "other"):
                fn = trees[name]
                runs[name].append(chip_smoke.device_ms(lambda: fn(x, qt.q, qt.scale)))
            row = {name: {"device_ms": statistics.mean(r[0] for r in rs), "host_ms": statistics.mean(r[1] for r in rs),
                          "device_ms_runs": [r[0] for r in rs]} for name, rs in runs.items()}
            results[f"{label} M={m}"] = dict(row, k=k_dim, f=f_dim, m=m, per_forward=per_forward, rel_diff=diff)
            print(f"[{k_dim}, {f_dim}] ({label}) M={m}: device-only other {row['other']['device_ms']:.4f} ms "
                  f"{row['other']['device_ms_runs']}, this {row['this']['device_ms']:.4f} ms "
                  f"{row['this']['device_ms_runs']} ({row['other']['device_ms'] / row['this']['device_ms']:.2f}x); "
                  f"host enqueue other {row['other']['host_ms']:.4f} ms, this {row['this']['host_ms']:.4f} ms; "
                  f"outputs within {diff:.2e} x max", flush=True)
        del qt
        torch.cuda.empty_cache()
    sums = {}
    for m in M_VALUES:
        rows = [r for r in results.values() if r["m"] == m]
        sums[m] = {name: sum(r["per_forward"] * r[name]["device_ms"] for r in rows) for name in trees}
        print(f"M={m}, the {chip_smoke.INT8_PER_FORWARD} int8 matmuls of one forward, device-only: other "
              f"{sums[m]['other']:.4f} ms, this {sums[m]['this']:.4f} ms "
              f"({sums[m]['other'] / sums[m]['this']:.2f}x)", flush=True)
    print(card, flush=True)
    print(json.dumps({"int8_ab": {"card": card, "shapes": results, "forward_device_ms": sums}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
