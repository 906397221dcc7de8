#!/usr/bin/env python3
"""Where the f32 flash backward's time goes, on one CUDA card.

Run from the repository root::

    python3 scripts/flash_backward_f32_phases.py [--cvt] [--no-split]

Builds an instrumented copy of ``csrc/flash_backward_f32.cu`` (the source
stays as it is): thread 0 of every block reads ``clock64`` between the phases
of each query tile (the wait at the tile's first barrier, the counter's
release, the next tile's copy issue, S/dP, P/dS, dV/dK, the dS barrier, dQ,
the wait for the earlier key tile's sum, the dq add), and the per-phase cycles
a tile are summed over all blocks. Thread 0's clock also counts the cycles its
warp waits for issue slots behind the other warp of its scheduler. The copy's
result is held bitwise against the kernel's. It runs at B=1, H=32, Hkv=8,
D=128, causal, S=256 and S=2048, with the kernel's own device-only time
(``chip_smoke.py``'s timer) beside it.

It also measures the card's ``mma.sync.m16n8k8`` TF32 rate: 132 blocks of 8
warps, each issuing rounds of 8 independent products with no loads.
``--cvt`` adds a second instrumented copy whose operands are rounded by
``cvt.rna.tf32.f32`` in place of the bit arithmetic of ``tf32_rna``, with the
SASS instruction counts of both copies' kernels. ``--no-split`` adds a copy
whose operand split does no arithmetic (its results are wrong; its times
show what the split costs).
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import importlib
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SEQS = (256, 2048)
PHASES = ("first barrier", "release", "copy issue", "S/dP", "P/dS", "dV/dK", "dS barrier", "dQ",
          "wait for key tile n - 1", "dq add")
#: (anchor in the kernel source, the phase that ends there); a stamp is put before each anchor
STAMPS = (
    ("    if (tid == 0 && release != nullptr) store_release(release, n + 1);", 0),
    ("    if (i + 1 < steps) load_tile(i + 1);", 1),
    ("    const float* q_t = q_s + s * kTile", 2),
    ("    // P^T and dS^T in place.", 3),
    ("    // dV += P^T dO and dK += dS^T Q:", 4),
    ("    // dS into shared memory, [64 queries, 64 keys]", 5),
    ("    // dQ partial = dS K:", 6),
    ("    // the partial dQ tile into stage s's Q rows", 7),
    ("    const int rows = min(kQueries, q_len - q0);\n    float* dq_tile", 8),
)
NO_SPLIT = """
#define split_tf32(x, hi, lo) ((hi) = __float_as_uint(x), (lo) = (hi))
"""
CVT_SPLIT = """
__device__ __forceinline__ void split_cvt(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}
"""
PEAK = """
#include <cuda_runtime.h>
#include <stdint.h>
#include "hopper.cuh"
__global__ void __launch_bounds__(256, 1) peak(float* out, long long* cycles, int rounds) {
  float acc[8][4] = {};
  const uint32_t a[4] = {threadIdx.x, 2u, 3u, 4u};
  const uint32_t b0 = threadIdx.x * 3u, b1 = 7u;
  __syncthreads();
  const long long t0 = clock64();
  for (int i = 0; i < rounds; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) mma_1688_tf32(acc[j], a, b0, b1);
  }
  __syncthreads();
  const long long t1 = clock64();
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) sum += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
  if (threadIdx.x == 0 && blockIdx.x == 0) *cycles = t1 - t0;
}
extern "C" int run_peak(void* out, void* cycles, int blocks, int rounds) {
  peak<<<blocks, 256>>>(static_cast<float*>(out), static_cast<long long*>(cycles), rounds);
  return static_cast<int>(cudaGetLastError());
}
"""


def instrumented(source: str) -> str:
    """The kernel with per-phase clocks: an extra ``long long* timing``
    argument receives ``[blocks][len(PHASES) + 2]`` (cycles a phase, all of
    the block's cycles, its tile count)."""
    def rep(text, old, new):
        if text.count(old) != 1:
            raise RuntimeError(f"the kernel source no longer has one {old!r}: update the anchors")
        return text.replace(old, new)

    n = len(PHASES)
    s = rep(source, "int k_len, int head_dim, int causal, float scale, int aligned) {",
            "int k_len, int head_dim, int causal, float scale, int aligned, long long* timing) {\n"
            f"  long long phase[{n}] = {{}}; long long last = clock64(); const long long start = last;\n"
            "#define STAMP(k) if (threadIdx.x == 0) { const long long now = clock64(); phase[k] += now - last; "
            "last = now; }")
    for anchor, k in STAMPS:
        s = rep(s, anchor, f"    STAMP({k})\n{anchor}")
    s = rep(s, "    release = n < n_last ? count : nullptr;  // published in the next tile (or after the walk)\n  }\n",
            f"    release = n < n_last ? count : nullptr;\n    STAMP({n - 1})\n  }}\n"
            f"  if (threadIdx.x == 0) {{\n"
            f"    for (int j = 0; j < {n}; ++j) timing[blockIdx.x * {n + 2} + j] = phase[j];\n"
            f"    timing[blockIdx.x * {n + 2} + {n}] = clock64() - start;\n"
            f"    timing[blockIdx.x * {n + 2} + {n + 1}] = steps;\n  }}\n")
    s = rep(s, "int head_dim, int causal, float scale, void* stream) {",
            "int head_dim, int causal, float scale, void* stream, void* timing) {")
    return rep(s, "n_heads, n_kv, q_len, k_len, head_dim, causal, scale, aligned ? 1 : 0);",
               "n_heads, n_kv, q_len, k_len, head_dim, causal, scale, aligned ? 1 : 0, "
               "static_cast<long long*>(timing));")


def build(name: str, text: str, out_dir: Path) -> Path:
    from unionml_tpu_torch import _build

    source, library = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
    source.write_text(text)
    done = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(library),
                           str(source)], capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{done.stdout}{done.stderr}")
    spills = [line.strip() for line in done.stdout.splitlines() if "spill" in line or "registers" in line]
    print(f"{name}: {spills}", flush=True)
    return library


def sass_counts(library: Path) -> dict:
    from unionml_tpu_torch import _build

    dump = subprocess.run([os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump"), "-sass", str(library)],
                          capture_output=True, text=True).stdout
    counts = collections.Counter()
    for line in dump.splitlines():
        parts = line.split("*/")
        if line.strip().startswith("/*") and len(parts) >= 2:
            text = re.sub(r"^@!?U?P[0-9T]\s*", "", parts[1].strip())
            if text and not text.startswith("/*"):
                counts[text.split()[0]] += 1
    return dict(counts.most_common(8))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cvt", action="store_true", help="also a copy that rounds by cvt.rna.tf32.f32")
    parser.add_argument("--no-split", action="store_true", help="also a copy whose split does no arithmetic")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("flash_backward_f32_phases: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from unionml_tpu_torch import _build

    fa = importlib.import_module("unionml_tpu_torch.ops.flash_attention")  # the package re-exports the function
    card = chip_smoke.card_line()
    print(card, flush=True)
    _build.build_all(["flash_backward_f32", "flash_forward_f32"])
    out_dir = _build.BUILD_DIR / "phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    source = (_build.CSRC / "flash_backward_f32.cu").read_text()
    copies = {"bits": instrumented(source)}
    if args.cvt:
        at = copies["bits"].index("// grid: x = key tiles")
        copies["cvt"] = (copies["bits"][:at] + CVT_SPLIT + copies["bits"][at:].replace("split_tf32(", "split_cvt("))
    if args.no_split:
        at = copies["bits"].index("// grid: x = key tiles")
        copies["no-split"] = copies["bits"][:at] + NO_SPLIT + copies["bits"][at:]
    libraries = {name: build(f"flash_backward_f32_{name}", text, out_dir) for name, text in copies.items()}
    if args.cvt:
        for name, library in libraries.items():
            print(f"SASS of the {name} copy, most frequent: {sass_counts(library)}", flush=True)

    peak_lib = ctypes.CDLL(str(build("hmma_tf32_peak", PEAK, out_dir))).run_peak
    peak_lib.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    out, cycles, rounds = torch.empty(132 * 256, device="cuda"), torch.zeros(1, dtype=torch.int64, device="cuda"), 4096
    for _ in range(2):  # the first launch warms up
        chip_smoke.require(peak_lib(out.data_ptr(), cycles.data_ptr(), 132, rounds) == 0, "the peak kernel failed")
        torch.cuda.synchronize()
    per_smsp = cycles.item() / (rounds * 8 * 8 / 4)
    print(f"mma.sync m16n8k8 TF32, 132 blocks x 8 warps, 8 independent products a round: {per_smsp:.2f} cycles a "
          f"product a scheduler (SM sub-partition); {card}", flush=True)

    def launcher(library: Path):
        fn = ctypes.CDLL(str(library)).flash_attention_backward_f32
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def call(q, k, v, dout, lse, delta, timing):
            batch, q_len, heads, head_dim = q.shape
            dq_count, dq, dk_heads, dv_heads = fa._fused_outputs(q, k, True, counters_per_tile=1)
            pointers = (q, k, v, dout, lse, delta, dq_count, dq, dk_heads, dv_heads)
            err = fn(*(x.data_ptr() for x in pointers), batch, heads, k.shape[2], q_len, k.shape[1], head_dim, 1,
                     head_dim**-0.5, torch.cuda.current_stream().cuda_stream, timing.data_ptr())
            chip_smoke.require(err == 0, f"launch failed: cudaError {err}")
            return dq, dk_heads, dv_heads

        return call

    for seq in SEQS:
        g = torch.Generator(device="cuda").manual_seed(2)
        q, k, v, dout = (torch.randn(1, seq, heads, 128, device="cuda", generator=g) for heads in (32, 8, 8, 32))
        out_, lse = fa.flash_forward(q, k, v, True)
        delta = torch.einsum("blhd,blhd->bhl", dout, out_)
        kernel_ms, _ = chip_smoke.device_ms(lambda: fa.flash_backward_f32(q, k, v, dout, lse, delta, True))
        reference = fa.flash_backward_f32(q, k, v, dout, lse, delta, True)[0]
        blocks = seq // 64 * 32
        width = len(PHASES) + 2
        for name, library in libraries.items():
            call = launcher(library)
            timing = torch.zeros(blocks * width, dtype=torch.int64, device="cuda")
            copy_ms, _ = chip_smoke.device_ms(lambda: call(q, k, v, dout, lse, delta, timing))
            timing.zero_()
            dq = call(q, k, v, dout, lse, delta, timing)[0]
            torch.cuda.synchronize()
            rows = timing.view(blocks, width).double().cpu()
            tiles, total = rows[:, -1].sum().item(), rows[:, -2].sum().item()
            shares = ", ".join(f"{label} {c / tiles:.0f} ({c / total:.1%})"
                               for label, c in zip(PHASES, rows[:, :len(PHASES)].sum(0).tolist()))
            print(f"S={seq} {name}: kernel {kernel_ms:.4f} ms, instrumented copy {copy_ms:.4f} ms device-only; dq "
                  f"bitwise the kernel's: {torch.equal(dq, reference)}; {total / tiles:.0f} cycles a query tile of "
                  f"a block: {shares}", flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
