#!/usr/bin/env python3
"""Where the int8-page paged decode kernel's time goes, on one CUDA card.

Run from the repository root::

    python3 scripts/paged_decode_int8_phases.py

Builds an instrumented copy of ``csrc/paged_decode_attention_int8.cu`` under
``unionml_tpu_torch/_build/phases/`` (the source stays as it is). Each copy
reads ``%globaltimer`` (nanoseconds, one clock for the whole card) on the
tensor-core route: for each page of a split, when a producer lane issues its
copies, when its reading warp sees them land, after ``S = K q^T``, after the
V tile is written and the stage released, and after ``O += V^T P^T``; for each
block, at its start and before and after the cluster's combine. At
``chip_smoke.py``'s two long-context shapes (bf16 q, H=32, H_kv=8, D=128,
16-position pages) it prints the medians over all pages and blocks: the
table's staging, the first page's latency, the interval between two pages'
landings in one block (and the bytes a second that makes), each reading
step, the readers' tail after the last landing, the combine and the span of
the launch, beside the device-only time (``chip_smoke.py``'s timer) of the
kernel and of the copy. The copy's outputs are held against the kernel's.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

MAX_BLOCKS, MAX_PAGES, SLOTS = 4096, 64, 8  # stamps: [block][page][slot]; page MAX_PAGES - 1 keeps the block's own
GLOBALS = f"""namespace cg = cooperative_groups;
__device__ unsigned long long g_stamps[{MAX_BLOCKS} * {MAX_PAGES} * {SLOTS}];
__device__ __forceinline__ unsigned long long now_ns() {{
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t)::"memory");
  return t;
}}
#define STAMP(page, slot)                                                                                 \\
  if ((page) < {MAX_PAGES - 1})                                                                           \\
  g_stamps[((blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z)) * {MAX_PAGES} + (page)) * {SLOTS} + (slot)] = now_ns()
#define BLOCK_STAMP(slot)                                                                                 \\
  g_stamps[((blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z)) * {MAX_PAGES} + {MAX_PAGES - 1}) * {SLOTS} + (slot)] = now_ns()
extern "C" int read_stamps(void* dst) {{ return (int)cudaMemcpyFromSymbol(dst, g_stamps, sizeof(g_stamps)); }}
extern "C" int clear_stamps() {{
  void* p = nullptr;
  const cudaError_t err = cudaGetSymbolAddress(&p, g_stamps);
  return (int)(err != cudaSuccess ? err : cudaMemset(p, 0, sizeof(g_stamps)));
}}
"""
READER_WAIT = "    mbar_wait(&full[s], (i / stages) & 1);\n"
END = "                             splits, tid);\n}\n\n// the arguments every launch passes on"
#: (anchor in the kernel source, the text put after it (or before, for a leading "^"), occurrence)
STAMPS = (
    ("namespace cg = cooperative_groups;", None, 1),  # replaced by GLOBALS
    ("  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n", "  if (tid == 0) BLOCK_STAMP(0);\n", 2),
    ("^        mbar_arrive_expect_tx(&full[s], stage);\n", "        STAMP(i, 0);\n", 1),
    (READER_WAIT, "    if (lane == 0) STAMP(i, 1);\n", 1),
    ("^      // V rows k0 .. k0 + rows into the tile as bf16",
     '      if (lane == 0) {\n        asm volatile("" ::"f"(sc[0]), "f"(sc[1]), "f"(sc[2]), "f"(sc[3]) : "memory");\n'
     "        STAMP(i, 2);\n      }\n", 1),
    ("      if (k0 + 16 >= valid && lane == 0) mbar_arrive(&empty[s]);  // the page's last group has read the stage\n",
     "      if (lane == 0) STAMP(i, 3);\n", 1),
    ("        ldmatrix_x4_trans(a, v_row + 32 * t);\n        mma_16816(o[t], a, b0, b1);\n      }\n",
     '      if (lane == 0) {\n        asm volatile("" ::"f"(o[0][0]), "f"(o[DT - 1][3]) : "memory");\n'
     "        STAMP(i, 4);\n      }\n", 1),
    ("^  combine<T, G, kMmaThreads>(", "  if (tid == 0) BLOCK_STAMP(1);\n", 1),
    (END, None, 1),  # the end stamp
)


def instrumented(source: str) -> str:
    """The kernel with the stamps."""
    def rep(text, old, new, nth=1):
        i = -1
        for _ in range(nth):
            i = text.find(old, i + 1)
            if i < 0:
                raise SystemExit(f"the kernel source changed: anchor not found ({old.strip()[:60]!r})")
        return text[:i] + new + text[i + len(old):]

    out = source
    for anchor, text, nth in STAMPS:
        if text is None and anchor.startswith("namespace"):
            out = rep(out, anchor, GLOBALS, nth)
        elif text is None:
            out = rep(out, anchor, END.replace("\n}", "\n  if (tid == 0) BLOCK_STAMP(2);\n}", 1), nth)
        elif anchor.startswith("^"):
            out = rep(out, anchor[1:], text + anchor[1:], nth)
        else:
            out = rep(out, anchor, anchor + text, nth)
    return out


def build(sources: dict) -> dict:
    """Each ``{name: source}`` compiled as ``_build.py`` compiles a kernel
    (all ``nvcc`` runs started together) and loaded: ``{name: (library,
    entry point)}``."""
    from unionml_tpu_torch import _build

    out_dir = _build.BUILD_DIR / "phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    running = {}
    for name, source in sources.items():
        path = out_dir / f"{name}.cu"
        path.write_text(source)
        running[name] = (out_dir / f"lib{name}.so", subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(out_dir / f"lib{name}.so"), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (lib_path, proc) in running.items():
        output, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{output[-4000:]}")
        lib = ctypes.CDLL(str(lib_path))
        lib.read_stamps.argtypes = [ctypes.c_void_p]
        fn = lib.paged_decode_attention_int8
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 12 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        built[name] = (lib, fn)
    return built


def median(xs) -> float:
    xs = list(xs)
    return statistics.median(xs) if xs else float("nan")


def summarize(stamps, n_blocks: int, per_split: int, stage_bytes: int) -> dict:
    """Medians (us) over the blocks and pages of one launch's stamps."""
    import numpy as np

    st = stamps[: n_blocks * MAX_PAGES * SLOTS].reshape(n_blocks, MAX_PAGES, SLOTS).astype(np.int64)
    blocks = st[:, MAX_PAGES - 1]
    t0 = blocks[:, 0].min()
    us = lambda a, b: (a - b) / 1000.0  # noqa: E731
    rows = {"table": [], "first landing": [], "between landings": [], "S": [], "V tile": [], "P V": [], "tail": [],
            "combine": []}
    for blk in range(n_blocks):
        pages = [st[blk, i] for i in range(min(per_split, MAX_PAGES - 1)) if st[blk, i, 1]]
        if not pages:
            continue
        issued = [p[0] for p in pages if p[0]]
        landed = sorted(p[1] for p in pages)
        rows["table"].append(us(min(issued), blocks[blk, 0]))
        rows["first landing"].append(us(pages[0][1], pages[0][0]))
        if len(landed) > 1:
            rows["between landings"].append(us(landed[-1], landed[0]) / (len(landed) - 1))
        for p in pages:
            if p[2] and p[3] and p[4]:
                rows["S"].append(us(p[2], p[1]))
                rows["V tile"].append(us(p[3], p[2]))
                rows["P V"].append(us(p[4], p[3]))
        done = max(p[4] for p in pages)
        if done:
            rows["tail"].append(us(done, landed[-1]))
        rows["combine"].append(us(blocks[blk, 2], blocks[blk, 1]))
    out = {name: median(v) for name, v in rows.items()}
    out["GB/s a block"] = stage_bytes / (out["between landings"] * 1e3) if out["between landings"] else float("nan")
    out["span"] = us(blocks[:, 2].max(), t0)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("paged_decode_int8_phases: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from unionml_tpu_torch import _build
    from unionml_tpu_torch.ops import paged_attention as pa

    card = chip_smoke.card_line()
    print(card, flush=True)
    source = (_build.CSRC / "paged_decode_attention_int8.cu").read_text()
    copies = build({"stamped": instrumented(source)})
    own = pa._int8_kernel
    own()  # the kernel itself, built by _build
    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    pps = -(-(max(chip_smoke.PROMPT_LENS) + chip_smoke.MAX_NEW + 8) // chip_smoke.BLOCK)
    for label, batch, lengths, n_pages, p in chip_smoke.paged_shapes(4 * pps + 1, pps)[1:]:
        q, k, v, lens, table, kw = chip_smoke.int8_pages(batch, lengths, n_pages, p, torch.bfloat16, 7)
        route, plan = pa._int8_launch(q, k, v, kw["k_scales"], kw["v_scales"], table, pa._sm_count(0))
        call = lambda: pa.paged_decode_attention(q, k, v, lens, table, **kw)  # noqa: E731
        pa._int8_kernel = own
        expected = call()
        kernel_ms, _ = chip_smoke.device_ms(call)
        print(f"{label} ({route}, {plan}): the kernel {kernel_ms:.4f} ms device-only", flush=True)
        n_blocks = plan.splits * k.shape[0] * batch  # one head tile a KV head (a group of at most 8)
        for name, (lib, fn) in copies.items():
            pa._int8_kernel = lambda fn=fn: fn
            got = call()
            if not torch.equal(got, expected):
                raise SystemExit(f"the {name} copy's output differs from the kernel's at {label}")
            copy_ms, _ = chip_smoke.device_ms(call)
            runs = []
            for _ in range(5):
                lib.clear_stamps()
                flush.zero_()
                torch.cuda._sleep(chip_smoke.SPIN_CYCLES)
                call()
                torch.cuda.synchronize()
                buf = np.zeros(MAX_BLOCKS * MAX_PAGES * SLOTS, dtype=np.uint64)
                if lib.read_stamps(buf.ctypes.data) != 0:
                    raise SystemExit("could not read the stamps")
                runs.append(summarize(buf, n_blocks, plan.pages_per_split, 2 * pa._int8_page_bytes(k.shape[2], k.shape[3])))
            agg = {key: median(r[key] for r in runs) for key in runs[0]}
            print(f"  {name}: {copy_ms:.4f} ms device-only; medians of 5 launches (us): "
                  + ", ".join(f"{key} {value:.3f}" if key != "GB/s a block" else f"{key} {value:.1f}"
                              for key, value in agg.items()), flush=True)
        pa._int8_kernel = own
        del q, k, v, lens, table, kw
        torch.cuda.empty_cache()
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
