#!/usr/bin/env python3
"""Does a cooperative launch in thread block clusters work on this GPU?

    python3 scripts/torch_cluster_probe.py

The fused train kernel (``shallowspeed_tpu_torch/csrc/fused_train.cu``)
runs each head group on one thread block cluster and meets the whole grid
at ``grid.sync()``. That needs one ``cudaLaunchKernelEx`` with both
``cudaLaunchAttributeCooperative`` and ``cudaLaunchAttributeClusterDimension``.
This script builds a small kernel with the port's ``nvcc`` flags and, for
clusters of 8 and 16 blocks (16 needs the non-portable size), with and
without 160 KB of dynamic shared memory a block:

- asks ``cudaOccupancyMaxActiveClusters`` how many clusters fit at once;
- launches that many clusters cooperatively and checks that every block
  read a peer's shared memory through the cluster (distributed shared
  memory) and that ``grid.sync()`` held across clusters (an integer
  counter every block adds to before the barrier reads the grid size after
  it, in every block);
- times 1000 ``grid.sync()`` and 1000 ``cluster.sync()`` on the device's
  ``%globaltimer``, and the same grid barrier of a plain cooperative launch
  (one block per SM, no cluster) beside it.

Prints one line per configuration and, as its last line, one JSON object.
Exits non-zero when a launch is refused or a check fails.
"""

import json
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

SOURCE = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cstdio>
namespace cg = cooperative_groups;

__device__ unsigned long long now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void probe(int* count, int* bad, unsigned long long* ns, int iters) {
  extern __shared__ int dyn[];
  __shared__ int mine;
  cg::grid_group grid = cg::this_grid();
  cg::cluster_group cl = cg::this_cluster();
  if (threadIdx.x == 0) { mine = blockIdx.x; dyn[0] = 0; }
  cl.sync();
  const unsigned peer = (cl.block_rank() + 1) % cl.num_blocks();
  const int want = blockIdx.x - cl.block_rank() + peer;
  if (threadIdx.x == 0 && *cl.map_shared_rank(&mine, peer) != want) atomicAdd(bad, 1);
  cl.sync();  // no block leaves while a peer may still read its memory
  if (threadIdx.x == 0) atomicAdd(count, 1);
  grid.sync();
  if (threadIdx.x == 0 && atomicAdd(count, 0) != (int)gridDim.x) atomicAdd(bad, 1);
  unsigned long long t0 = now();
  for (int i = 0; i < iters; ++i) grid.sync();
  unsigned long long t1 = now();
  for (int i = 0; i < iters; ++i) cl.sync();
  unsigned long long t2 = now();
  if (blockIdx.x == 0 && threadIdx.x == 0) { ns[0] = t1 - t0; ns[1] = t2 - t1; }
}

__global__ void plain(unsigned long long* ns, int iters) {
  cg::grid_group grid = cg::this_grid();
  grid.sync();
  unsigned long long t0 = now();
  for (int i = 0; i < iters; ++i) grid.sync();
  if (blockIdx.x == 0 && threadIdx.x == 0) ns[0] = now() - t0;
}

int main() {
  const int iters = 1000, threads = 256;
  int *count, *bad;
  unsigned long long* ns;
  cudaMalloc(&count, 4); cudaMalloc(&bad, 4); cudaMalloc(&ns, 16);
  int sms = 0, failures = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  cudaFuncSetAttribute(probe, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaFuncSetAttribute(probe, cudaFuncAttributeMaxDynamicSharedMemorySize, 160 * 1024);
  const int sizes[2] = {8, 16}, smems[2] = {0, 160 * 1024};
  for (int si = 0; si < 2; ++si)
    for (int mi = 0; mi < 2; ++mi) {
      cudaLaunchConfig_t cfg = {};
      cudaLaunchAttribute attr[2];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = sizes[si];
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      attr[1].id = cudaLaunchAttributeCooperative;
      attr[1].val.cooperative = 1;
      cfg.blockDim = dim3(threads);
      cfg.dynamicSmemBytes = smems[mi];
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      cfg.gridDim = dim3(sizes[si]);
      int clusters = 0;
      cudaError_t err = cudaOccupancyMaxActiveClusters(&clusters, (void*)probe, &cfg);
      if (err != cudaSuccess || clusters < 1) {
        printf("{\"cluster\": %d, \"smem\": %d, \"error\": \"occupancy: %s\"}\n", sizes[si],
               smems[mi], cudaGetErrorString(err));
        cudaGetLastError();
        ++failures;
        continue;
      }
      cfg.numAttrs = 2;
      cfg.gridDim = dim3(clusters * sizes[si]);
      cudaMemset(count, 0, 4); cudaMemset(bad, 0, 4);
      err = cudaLaunchKernelEx(&cfg, probe, count, bad, ns, iters);
      if (err == cudaSuccess) err = cudaDeviceSynchronize();
      int h_bad = -1;
      unsigned long long h_ns[2] = {0, 0};
      if (err == cudaSuccess) {
        cudaMemcpy(&h_bad, bad, 4, cudaMemcpyDeviceToHost);
        cudaMemcpy(h_ns, ns, 16, cudaMemcpyDeviceToHost);
      }
      printf("{\"cluster\": %d, \"smem\": %d, \"max_active_clusters\": %d, \"blocks\": %d, "
             "\"launch\": \"%s\", \"bad\": %d, \"grid_sync_us\": %.4f, \"cluster_sync_us\": %.4f}\n",
             sizes[si], smems[mi], clusters, clusters * sizes[si], cudaGetErrorString(err), h_bad,
             h_ns[0] / 1e3 / iters, h_ns[1] / 1e3 / iters);
      if (err != cudaSuccess || h_bad != 0) ++failures;
      cudaGetLastError();
    }
  void* args[] = {(void*)&ns, (void*)&iters};
  cudaError_t err = cudaLaunchCooperativeKernel((void*)plain, dim3(sms), dim3(threads), args, 0, 0);
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  unsigned long long h = 0;
  cudaMemcpy(&h, ns, 8, cudaMemcpyDeviceToHost);
  printf("{\"cluster\": 1, \"blocks\": %d, \"launch\": \"%s\", \"grid_sync_us\": %.4f}\n", sms,
         cudaGetErrorString(err), h / 1e3 / iters);
  if (err != cudaSuccess) ++failures;
  return failures ? 1 : 0;
}
"""


def main():
    from shallowspeed_tpu_torch import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(card)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    with tempfile.TemporaryDirectory() as tmp:
        src, exe = Path(tmp) / "probe.cu", Path(tmp) / "probe"
        src.write_text(SOURCE)
        subprocess.run([_build.nvcc(), *flags, "-o", str(exe), str(src)], check=True, timeout=300)
        run = subprocess.run([str(exe)], capture_output=True, text=True, timeout=120)
    rows = [json.loads(line) for line in run.stdout.splitlines() if line.startswith("{")]
    for row in rows:
        print(row)
    print(json.dumps({"card": card, "ok": run.returncode == 0, "configs": rows}))
    return run.returncode


if __name__ == "__main__":
    sys.exit(main())
