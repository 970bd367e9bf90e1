// staging.cuh: what linear_act_fwd.cu and linear_act_bwd.cu share — the
// block shape, the cp.async ring that stages operand tiles into shared
// memory, and the launch of a grid in thread block clusters.
//
// Every tile is staged with cp.async: 16-byte copies (cp.async.cg, L2 only)
// where a row's length is a multiple of 4 floats and the base is 16-byte
// aligned, else 4-byte copies (cp.async.ca), since the flagship's rows of
// 127, 126, 125 and 123 floats are not 16-byte aligned. Out-of-range
// elements are zero-filled by the copy itself (src-size 0), so the kernels
// mask every dimension with no padding copy in the wrapper.
//
// The ring: STAGES slots; the block keeps STAGES - 1 stages in flight and
// crosses one __syncthreads per stage (stage s has landed for every thread,
// and every thread is done reading stage s - 1, whose slot is refilled next).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace staging {

constexpr int THREADS = 128;     // threads per block, every tile shape
constexpr int BK = 16;           // reduction depth of one stage
constexpr int STAGES = 4;        // slots of the cp.async ring
constexpr int LD = BK + 4;       // row stride (floats) of a reduction-contiguous
                                 // tile: 80 bytes keeps rows 16-byte aligned and
                                 // a quarter warp's float4 reads of 8 rows on
                                 // 8 distinct bank groups
constexpr int PANEL = 64;        // width of a stage-major panel (see stage_panel)
constexpr int MAX_CLUSTER = 8;   // the portable thread block cluster size
constexpr int MAX_DEVICES = 64;  // devices a launcher's per-device set-up table holds

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 4 bytes global -> shared; `bytes` < 4 zero-fills the rest (0: no read).
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// 16 bytes global -> shared, through L2 only; `bytes` 0 zero-fills.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Stage rows [row0, row0 + ROWS) x columns [c0, c0 + BK) of the row-major
// (rows x cols) matrix `src` into dst[r * LD + c]: a reduction-contiguous
// tile (the reduction runs along the source's rows). Zeros outside src.
// `vec`: cols % 4 == 0 and src 16-byte aligned (c0 is a multiple of BK).
template <int ROWS>
__device__ __forceinline__ void stage_tile(float* dst, const float* __restrict__ src,
                                           int row0, int rows, int cols, int c0, int vec,
                                           int tid) {
  if (vec) {
    constexpr int PIECES = ROWS * (BK / 4);
#pragma unroll
    for (int i = 0; i < (PIECES + THREADS - 1) / THREADS; ++i) {
      const int e = tid + i * THREADS;
      if (PIECES % THREADS && e >= PIECES) break;
      const int r = e / (BK / 4);
      const int c = (e % (BK / 4)) * 4;
      const bool ok = row0 + r < rows && c0 + c < cols;
      const float* p = ok ? src + (size_t)(row0 + r) * cols + c0 + c : src;
      cp_async16(dst + r * LD + c, p, ok ? 16 : 0);
    }
  } else {
    constexpr int PIECES = ROWS * BK;
#pragma unroll
    for (int i = 0; i < (PIECES + THREADS - 1) / THREADS; ++i) {
      const int e = tid + i * THREADS;
      if (PIECES % THREADS && e >= PIECES) break;
      const int r = e / BK;
      const int c = e % BK;
      const bool ok = row0 + r < rows && c0 + c < cols;
      const float* p = ok ? src + (size_t)(row0 + r) * cols + c0 + c : src;
      cp_async4(dst + r * LD + c, p, ok ? 4 : 0);
    }
  }
}

// Stage rows [row0, row0 + BK) x columns [c0, c0 + PANEL) of the row-major
// (rows x cols) matrix `src` into dst[r * PANEL + c]: a stage-major panel
// (the reduction runs down the source's columns). Zeros outside src.
// `vec`: cols % 4 == 0 and src 16-byte aligned (c0 is a multiple of PANEL).
__device__ __forceinline__ void stage_panel(float* dst, const float* __restrict__ src,
                                            int row0, int rows, int cols, int c0, int vec,
                                            int tid) {
  static_assert(BK * PANEL % (4 * THREADS) == 0, "whole copies per thread");
  if (vec) {
#pragma unroll
    for (int i = 0; i < BK * PANEL / (4 * THREADS); ++i) {
      const int e = tid + i * THREADS;
      const int r = e / (PANEL / 4);
      const int c = (e % (PANEL / 4)) * 4;
      const bool ok = row0 + r < rows && c0 + c < cols;
      const float* p = ok ? src + (size_t)(row0 + r) * cols + c0 + c : src;
      cp_async16(dst + r * PANEL + c, p, ok ? 16 : 0);
    }
  } else {
#pragma unroll
    for (int i = 0; i < BK * PANEL / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / PANEL;
      const int c = e % PANEL;
      const bool ok = row0 + r < rows && c0 + c < cols;
      const float* p = ok ? src + (size_t)(row0 + r) * cols + c0 + c : src;
      cp_async4(dst + r * PANEL + c, p, ok ? 4 : 0);
    }
  }
}

// part[o] of every rank of the cluster, added in rank order:
// ((p_0 + p_1) + p_2) + ... All the loads are issued before the first add.
__device__ __forceinline__ float ordered_sum(cooperative_groups::cluster_group cluster,
                                             float* part, int o, int chunks) {
  float p[MAX_CLUSTER];
#pragma unroll
  for (int q = 0; q < MAX_CLUSTER; ++q)
    p[q] = q < chunks ? cluster.map_shared_rank(part, q)[o] : 0.0f;
  float z = p[0];
#pragma unroll
  for (int q = 1; q < MAX_CLUSTER; ++q)
    if (q < chunks) z = __fadd_rn(z, p[q]);
  return z;
}

// True when `chunks` consecutive chunks of `chunk_len` terms cover a
// reduction of `length` terms exactly, none of them empty, with chunk edges
// on stage edges and at most one chunk per rank of a portable cluster.
// (cuda_ops.reduction_chunks makes the plan; the kernels only check it.)
inline bool chunks_cover(int length, int chunks, int chunk_len) {
  if (chunks < 1 || chunks > MAX_CLUSTER || chunk_len < 0 || chunk_len % BK) return false;
  if (length <= 0) return chunks == 1;
  return chunk_len > 0 && (long long)(chunks - 1) * chunk_len < length &&
         (long long)chunks * chunk_len >= length;
}

// Launch `kernel` over `grid` in clusters of `cluster` blocks along x
// (grid.x a multiple of it), `threads` threads and `smem` bytes of dynamic
// shared memory a block, on `stream`; a cluster of one is a plain
// launch (on sm_90 every block of one is its own cluster). Returns the launch's error, then
// cudaGetLastError(): a refused launch (cluster size, resources) never runs.
template <typename... Params, typename... Args>
cudaError_t launch_clustered_with(void (*kernel)(Params...), dim3 grid, int threads,
                                  int cluster, size_t smem, cudaStream_t stream,
                                  Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3((unsigned)threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;  // every block is a cluster of one without it
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The same with THREADS threads a block and static shared memory only.
template <typename... Params, typename... Args>
cudaError_t launch_clustered(void (*kernel)(Params...), dim3 grid, int cluster,
                             cudaStream_t stream, Args... args) {
  return launch_clustered_with(kernel, grid, THREADS, cluster, 0, stream, args...);
}

}  // namespace staging
