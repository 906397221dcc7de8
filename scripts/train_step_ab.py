#!/usr/bin/env python3
"""Time a LoRA training step of this tree against another tree's on one CUDA card.

Run from the repository root, with a checkout of the other tree (for
example the parent commit, unpacked with ``git archive``)::

    python3 scripts/train_step_ab.py --other chip_checkout/parent

Each run is one process that imports its tree's ``chip_smoke.py`` and calls
its ``training_phase`` with the profiler on: the full-width LoRA fine-tune
(Llama-3-8B width, 32 layers, bf16 compute, 6 steps of ``fit`` at B=1 x
2048 tokens), then one more step under ``torch.profiler``. The runs go in
turns (other, this, this, other), so that both trees meet the same card and
host. From each run the script reads the step time and samples/s that
``fit`` reports, the peak memory, and the profiled step's wall time, device
busy time, idle share and the flash forward's device time. Prints the card,
one line a run, and a last JSON line with every number.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
RUN = "import sys; sys.path.insert(0, '.'); import chip_smoke; chip_smoke.training_phase(chip_smoke.card_line(), True)"
FORWARD_KERNELS = ("flash_fwd_kernel", "flash_forward_kernel")  # PR 2's scalar forward, the tensor-core forward


def one_run(tree: Path) -> dict:
    proc = subprocess.run([sys.executable, "-c", RUN], cwd=tree, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"training run in {tree} failed:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    trained = next(line for line in proc.stdout.splitlines() if line.startswith("trained "))
    profile = next(json.loads(line)["profile"] for line in proc.stdout.splitlines() if line.startswith('{"profile"'))
    kernels = profile.get("port_kernels", []) + profile["top_kernels"]
    forward = next((k for k in kernels if any(name in k["name"] for name in FORWARD_KERNELS)), None)
    return {
        "ms_per_step": float(re.search(r"([\d.]+) ms/step", trained).group(1)),
        "samples_per_s": float(re.search(r"([\d.]+) samples/s", trained).group(1)),
        "peak_gib": float(re.search(r"peak memory ([\d.]+) GiB", trained).group(1)),
        "profiled_wall_ms": profile["wall_ms"],
        "device_busy_ms": profile["device_busy_ms"],
        "device_idle_share": profile["device_idle_share"],
        "forward_ms": forward["ms"] if forward else None,  # None: not among the kernels the run printed
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--other", type=Path, required=True, help="root of the other tree's checkout")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("train_step_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    card = chip_smoke.card_line()
    print(card, flush=True)
    trees = {"other": args.other.resolve(), "this": ROOT}
    runs = {"other": [], "this": []}
    for name in ("other", "this", "this", "other"):
        row = one_run(trees[name])
        runs[name].append(row)
        print(f"{name}: {json.dumps(row)}", flush=True)
    summary = {name: {key: statistics.mean(r[key] for r in rs) if all(r[key] is not None for r in rs) else None
                      for key in rs[0]} for name, rs in runs.items()}
    other, this = summary["other"], summary["this"]
    print(f"training step, Llama-3-8B width LoRA, B=1 x 2048: other {other['ms_per_step']:.1f} ms (device busy "
          f"{other['device_busy_ms']:.1f} ms, idle {other['device_idle_share']:.3f}), this "
          f"{this['ms_per_step']:.1f} ms (device busy {this['device_busy_ms']:.1f} ms, idle "
          f"{this['device_idle_share']:.3f})", flush=True)
    print(card, flush=True)
    print(json.dumps({"train_step_ab": {"card": card, "mean": summary, "runs": runs}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
