#!/usr/bin/env python3
"""Where a call of the bf16 paged-attention kernel spends its time, on one
NVIDIA GPU: the device's global nanosecond timer read by each CTA at the
ends of its phases.

    python3 benchmarks/paged_phases.py

It copies ``csrc/paged_attention.cu`` into ``build/phases/`` with stamps
added at fixed lines of the bf16 kernel (thread 0 of each CTA writes
``%globaltimer`` into a device array), builds that copy with the port's
``nvcc`` flags, and launches it through ctypes on
``chip_smoke.paged_phase_inputs`` at granite-8b's and zamba2-2.7b's
shapes for each lane mix, once with L2 flushed and once warm.  Per call
it prints, in microseconds from the first CTA's start: when the last CTA
started and when the last one ended, and over the CTAs that hold
positions the median and largest time of each phase: kv_len read (the
CTA's loads issued), first page landed, the pages' products and softmax
(warp 0), the warps' merge with the chunk's state written (or the output,
for a one-chunk lane), the chunk counted, and the last CTA's merge of the
chunks.  The kernel in ``csrc/`` is not changed.  Without a card it exits
non-zero.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

PHASES = ("kv_len read", "first page", "pages", "warp merge and state "
          "written", "chunk counted", "chunk merge")
# (anchor line of the source, stamp inserted before it)
STAMPS = (
    ("  // Loads that need nothing else, issued together: kv_len, the table",
     "PH(0);"),
    ("  extern __shared__ __align__(16) unsigned char smem_raw[];\n"
     "  __nv_bfloat16* pages", "PH(1);"),
    ("    const __nv_bfloat16* ks = pages + i * 2 * L::kPageElems;",
     "if (i == 0) PH(2);"),
    ("  // Merge the warps: l over this thread's rows", "PH(3);"),
    ("  if (nch > 1)\n    count_and_merge(st, n, D, group, nch, out_row",
     "PH(4); if (nch == 1) { PH(5); PH(6); }"),
    ("  __syncthreads();\n  if (!last) return;", "PH(5);"),
    ("  if (tid == 0) *counter = 0;  // ready for the next call", "PH(6);"),
)
PRELUDE = r'''
#define PH_MAX_CTAS 65536
__device__ unsigned long long g_ph[PH_MAX_CTAS][8];
__device__ __forceinline__ unsigned long long ph_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define PH(k)                                                           \
  do {                                                                  \
    if (threadIdx.x == 0)                                               \
      g_ph[(blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +          \
           blockIdx.x][k] = ph_now();                                   \
  } while (0)
extern "C" int paged_phases_read(void* dst, int ctas) {
  return (int)cudaMemcpyFromSymbol(dst, g_ph, (size_t)ctas * 64);
}
extern "C" int paged_phases_clear() {
  void* p = nullptr;
  cudaGetSymbolAddress(&p, g_ph);
  return (int)cudaMemset(p, 0, sizeof(g_ph));
}
'''


def build_probe():
    from repro_torch.kernels import build
    src = (build.CSRC / "paged_attention.cu").read_text()
    for anchor, stamp in STAMPS:
        assert src.count(anchor) == 1, anchor
        src = src.replace(anchor, f"  {stamp}\n{anchor}")
    src = src.replace("namespace {", PRELUDE + "\nnamespace {", 1)
    out_dir = ROOT / "build" / "phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, so = out_dir / "paged_phases.cu", out_dir / "paged_phases.so"
    cu.write_text(src)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                    str(cu)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    lib.paged_attention_launch.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
        + [ctypes.c_float, ctypes.c_void_p])
    lib.paged_attention_workspace.argtypes = [ctypes.c_int] * 6
    lib.paged_attention_workspace.restype = ctypes.c_longlong
    lib.paged_phases_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return lib


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("paged_phases: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import chip_smoke as cs
    print(cs.gpu_line(), flush=True)
    lib = build_probe()
    dev = torch.device("cuda")
    flush_buf = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    counters = torch.zeros(4096, dtype=torch.int32, device=dev)
    for model, H, KV, D in (("granite-8b", 32, 8, 128),
                            ("zamba2-2.7b", 32, 32, 80)):
        for mix, lens in cs.PAGED_MIXES.items():
            q, k, v, bt, kl = cs.paged_phase_inputs(dev, H, KV, D, lens)
            B, bs, mb = q.shape[0], k.shape[1], bt.shape[1]
            n_ws = lib.paged_attention_workspace(B, H, KV, D, bs, mb)
            ws = torch.empty(max(n_ws, 1), dtype=torch.float32, device=dev)
            out = torch.empty_like(q)
            chunks = -(-mb * bs // 128)
            ctas = KV * B * chunks

            def call():
                rc = lib.paged_attention_launch(
                    1, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    bt.data_ptr(), kl.data_ptr(), out.data_ptr(),
                    ws.data_ptr(), counters.data_ptr(), B, H, KV, D,
                    k.shape[0], bs, mb, D ** -0.5,
                    torch.cuda.current_stream().cuda_stream)
                assert rc == 0, rc
            for temp in ("cold", "warm"):
                call()
                torch.cuda.synchronize()
                assert lib.paged_phases_clear() == 0
                if temp == "cold":
                    flush_buf.zero_()
                torch.cuda.synchronize()
                call()
                torch.cuda.synchronize()
                raw = (ctypes.c_ulonglong * (ctas * 8))()
                assert lib.paged_phases_read(raw, ctas) == 0
                rows = [raw[i * 8:i * 8 + 8] for i in range(ctas)]
                t0 = min(r[0] for r in rows if r[0])
                active = [r for r in rows if r[1]]
                parts = []
                for p in range(6):
                    d = [(r[p + 1] - r[p]) / 1e3 for r in active
                         if r[p + 1] and r[p]]
                    if d:
                        parts.append(f"{PHASES[p]} {statistics.median(d):.2f}"
                                     f"/{max(d):.2f}")
                print(f"{model} {mix} {temp}: {len(active)} of {ctas} CTAs "
                      f"hold positions; last start "
                      f"{(max(r[0] for r in rows if r[0]) - t0) / 1e3:.2f}"
                      f" us, last end "
                      f"{(max(r[6] for r in active) - t0) / 1e3:.2f} us; "
                      f"median/max us: " + ", ".join(parts), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
