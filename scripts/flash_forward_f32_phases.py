#!/usr/bin/env python3
"""Where the f32 flash forward's time goes, on one CUDA card.

Run from the repository root::

    python3 scripts/flash_forward_f32_phases.py [--shape wide producers]

Builds instrumented copies of ``csrc/flash_forward_f32.cu`` (the source
stays as it is): lane 0 of warps 3 and 7 of every block reads ``clock64``
around each phase of a key tile (the K/V copy's issue, the split of K and V
into fragments, S = Q K^T, the mask and the online softmax, O += P V; the
rest is waiting at barriers and for copies) and once at the first tile (the
prologue: Q's split, the first copies), and the cycles are summed over all
blocks. Warp 3 owns query rows in both block shapes; warp 7 does too in the
wide blocks, and is a producer (copies and splits only) in the producers'
blocks. A lane's clock also counts the cycles its warp waits for issue slots
behind other warps. The copies' results are held bitwise against the
kernel's. They run at B=1, H=32, Hkv=8, D=128, causal, S=256 and S=2048, with
the kernel's own device-only time (``chip_smoke.py``'s timer) beside them.

``--shape`` builds one copy per block shape (``wide``: 8 warps own 128 query
rows and all split; ``producers``: 4 warps own 64 rows and 4 producer warps
split the next tile) in place of the kernel's own choice, which takes the
wide blocks where their grid fills the card's SMs.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SEQS = (256, 2048)
PHASES = ("waits", "copy issue", "split", "S", "softmax", "P V")
WIDTH = len(PHASES) + 3  # the phases, the prologue, the warp's total, the block's tiles
STAMPED = (3, 7)  # the warps whose lane 0 keeps the clocks
#: (anchor in the kernel source, the phase that ends there); a stamp is put before each anchor
STAMPS = (
    ("    const int k0 = i * kKeys;\n    if (aligned) {", 0),
    ("    cp_async_commit();\n  };", 1),
    ("    uint4* k_frag = smem + Sh::kOffStages + stage * 2 * kKVFrag;", 0),
    ("  };\n\n  // Q's rows qw + g", 2),
    ("    const int k0 = i * kKeys;\n    if (qw >= q_len", 0),
    ("    // the mask, only where", 3),
    ("    // O += P V:", 4),
    ("  };\n\n  if constexpr (kProducers) {", 5),
)


def instrumented(source: str, shape: str | None) -> str:
    """The kernel with per-phase clocks: an extra ``long long* timing``
    argument receives ``[blocks][2][WIDTH]`` (warps 3 and 7)."""
    def rep(text, old, new, count=1):
        if text.count(old) != count:
            raise RuntimeError(f"the kernel source no longer has {count} {old!r}: update the anchors")
        return text.replace(old, new)

    n = len(PHASES)
    s = rep(source, "    float scale, int aligned) {",
            "    float scale, int aligned, long long* timing) {\n"
            f"  long long phase[{n}] = {{}}, prologue = 0; long long last = clock64(); const long long start = last;\n"
            f"  const bool stamps = threadIdx.x == 32 * {STAMPED[0]} || threadIdx.x == 32 * {STAMPED[1]};\n"
            "#define STAMP(k) if (stamps) { const long long now = clock64(); phase[k] += now - last; last = now; }")
    for anchor, k in STAMPS:
        s = rep(s, anchor, f"    STAMP({k})\n{anchor}")
    s = rep(s, "    for (int i = 0; i < tiles; ++i) {\n",
            "    if (stamps) { prologue = clock64() - start; last = clock64(); }\n"
            "    for (int i = 0; i < tiles; ++i) {\n", count=2)
    write = ("    if (stamps) {\n"
             f"      long long* row = timing + (blockIdx.x * 2 + (threadIdx.x == 32 * {STAMPED[0]} ? 0 : 1))"
             f" * {WIDTH};\n"
             f"      for (int j = 0; j < {n}; ++j) row[j] = phase[j];\n"
             f"      row[{n}] = prologue;\n      row[{n + 1}] = clock64() - start;\n      row[{n + 2}] = tiles;\n"
             "    }\n")
    s = rep(s, "    if (producer) return;\n", write + "    if (producer) return;\n")
    s = rep(s, "      consume(i, 0);\n    }\n", "      consume(i, 0);\n    }\n" + write)
    s = rep(s, "float scale, int dtype, void* stream) {", "float scale, int dtype, void* stream, void* timing) {")
    s = rep(s, "int aligned,\n                   cudaStream_t stream) {",
            "int aligned,\n                   cudaStream_t stream, long long* timing) {")
    s = rep(s, "head_dim, causal, scale, aligned);", "head_dim, causal, scale, aligned, timing);")
    s = rep(s, "                              aligned, s));", "                              aligned, s, "
            "static_cast<long long*>(timing)));")
    if shape is not None:
        at = s.index("  const bool wide = ")
        s = s[:at] + f"  const bool wide = {'true' if shape == 'wide' else 'false'}" + s[s.index(";\n", at):]
    return s


def build(name: str, text: str, out_dir: Path) -> Path:
    from unionml_tpu_torch import _build

    source, library = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
    source.write_text(text)
    done = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(library),
                           str(source)], capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{done.stdout}{done.stderr}")
    return library


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--shape", nargs="*", choices=("wide", "producers"), default=[],
                        help="block shapes to build copies for, in place of the kernel's own choice")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("flash_forward_f32_phases: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from unionml_tpu_torch import _build

    fa = importlib.import_module("unionml_tpu_torch.ops.flash_attention")  # the package re-exports the function
    card = chip_smoke.card_line()
    print(card, flush=True)
    _build.build_all(["flash_forward_f32"])
    out_dir = _build.BUILD_DIR / "phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    source = (_build.CSRC / "flash_forward_f32.cu").read_text()
    copies = {"own choice": instrumented(source, None)}
    copies.update({shape: instrumented(source, shape) for shape in args.shape})
    libraries = {name: build(f"flash_forward_f32_{name.replace(' ', '_')}", text, out_dir)
                 for name, text in copies.items()}
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def launcher(library: Path):
        fn = ctypes.CDLL(str(library)).flash_attention_forward
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
                                                                     ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def call(q, k, v, timing):
            batch, q_len, heads, head_dim = q.shape
            out = torch.empty_like(q)
            lse = torch.empty(batch, heads, q_len, device="cuda")
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), batch, heads,
                     k.shape[2], q_len, k.shape[1], head_dim, 1, head_dim**-0.5, 0,
                     torch.cuda.current_stream().cuda_stream, timing.data_ptr())
            chip_smoke.require(err == 0, f"launch failed: cudaError {err}")
            return out, lse

        return call

    n = len(PHASES)
    for seq in SEQS:
        g = torch.Generator(device="cuda").manual_seed(2)
        q, k, v = (torch.randn(1, seq, heads, 128, device="cuda", generator=g) for heads in (32, 8, 8))
        kernel_ms, _ = chip_smoke.device_ms(lambda: fa.flash_forward_f32(q, k, v, True))
        reference = fa.flash_forward_f32(q, k, v, True)
        for name, library in libraries.items():
            shape = name if name in ("wide", "producers") else ("wide" if -(-seq // 128) * 32 >= sms else "producers")
            blocks = -(-seq // (128 if shape == "wide" else 64)) * 32
            call = launcher(library)
            timing = torch.zeros(blocks * 2 * WIDTH, dtype=torch.int64, device="cuda")
            copy_ms, _ = chip_smoke.device_ms(lambda: call(q, k, v, timing))
            timing.zero_()
            out, lse = call(q, k, v, timing)
            torch.cuda.synchronize()
            same = torch.equal(out, reference[0]) and torch.equal(lse, reference[1])
            rows = timing.view(blocks, 2, WIDTH).double().cpu()
            tiles = rows[:, 0, -1].sum().item()
            warps = []
            for w, warp in enumerate(STAMPED):
                total = rows[:, w, n + 1].sum().item()
                sums = rows[:, w, :n].sum(0).tolist()
                phases = ", ".join(f"{label} {c / tiles:.0f}" for label, c in zip(PHASES, sums))
                warps.append(f"warp {warp}: {phases}; prologue {rows[:, w, n].sum().item() / blocks:.0f} a block "
                             f"({rows[:, w, n].sum().item() / total:.1%})")
            print(f"S={seq} {name} ({shape}, {blocks} blocks): kernel {kernel_ms:.4f} ms, instrumented copy "
                  f"{copy_ms:.4f} ms device-only; output bitwise the kernel's: {same}; cycles a key tile of a block: "
                  f"{'; '.join(warps)}; the longest block {rows[:, 0, n + 1].max().item():.0f} cycles", flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
