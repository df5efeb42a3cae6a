"""The card's rate for mma.sync m16n8k8 TF32 products, the instruction the
3xTF32 attention kernels (``csrc/flash_fwd_tf32x3.cu``,
``csrc/flash_bwd_dkv_tf32x3.cu``) run on.

    python3 -m ray_tpu_torch.tools.mma_peak

Builds a kernel that does nothing but independent mma.sync products (4,
8 or 16 accumulators a warp; 4, 8 or 16 warps a block, 4 blocks an SM)
with ``nvcc`` into ``ray_tpu_torch/_build/``, times each launch by CUDA
events and prints one JSON line: the card's name and power limit and the
TF32 TFLOP/s of every configuration. A third of the best is the ceiling
of fp32 work done in 3xTF32 through mma.sync (``wgmma`` reaches the
data sheet's 495). Needs one card; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import subprocess

from ray_tpu_torch.ops import _build

_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
template <int NA>
__global__ void bench(float* out, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = 0x3f800000u;  // 1.0
  for (int i = 0; i < 2; ++i) b[i] = 0x3f800000u;
  float acc[NA][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < NA; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]),
            "+f"(acc[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
            "r"(b[1]));
  }
  float s = 0.f;
  for (int j = 0; j < NA; ++j) s += acc[j][0] + acc[j][3];
  if (s == -1.f) out[threadIdx.x] = s;  // keeps the products live
}
extern "C" float run_ms(int blocks, int threads, int iters, int na) {
  float* out;
  cudaMalloc(&out, 4096);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  float ms = -1.f;
  for (int rep = 0; rep < 2; ++rep) {  // the first launch warms up
    cudaEventRecord(e0);
    if (na == 4) bench<4><<<blocks, threads>>>(out, iters);
    if (na == 8) bench<8><<<blocks, threads>>>(out, iters);
    if (na == 16) bench<16><<<blocks, threads>>>(out, iters);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    cudaEventElapsedTime(&ms, e0, e1);
  }
  cudaFree(out);
  return cudaGetLastError() == cudaSuccess ? ms : -1.f;
}
"""


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("mma_peak: no CUDA device")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / "mma_peak.cu"
    lib_path = _build.BUILD_DIR / "mma_peak.so"
    src.write_text(_SOURCE)
    subprocess.run([_build.find_nvcc(), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", str(lib_path), str(src)],
                   check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.run_ms.restype = ctypes.c_float
    lib.run_ms.argtypes = [ctypes.c_int] * 4
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    iters, rates = 20000, {}
    for warps in (4, 8, 16):
        for na in (4, 8, 16):
            blocks = 4 * sms
            ms = lib.run_ms(blocks, 32 * warps, iters, na)
            if ms <= 0:
                raise SystemExit(f"mma_peak: launch failed ({warps}, {na})")
            flops = blocks * warps * iters * na * 2.0 * 16 * 8 * 8
            rates[f"warps{warps}_chains{na}"] = flops / ms / 1e9
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30).stdout.strip()
    print(json.dumps({"card": smi, "tf32_tflops": rates,
                      "best": max(rates.values())}), flush=True)


if __name__ == "__main__":
    main()
