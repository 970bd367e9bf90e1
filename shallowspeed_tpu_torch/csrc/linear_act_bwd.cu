// linear_act_bwd: the backward of linear_act_fwd in fp32.
//
//   ge = g * mask   (apply_relu; ge = g otherwise)
//   dx = ge @ W      (M x K)
//   dW = ge.T @ x    (N x K)
//   db = sum_rows ge (N)
//
// Replaces the TPU kernels of shallowspeed_tpu/pallas_ops.py:146-191
// (linear_relu_bwd: the single-block _bwd_kernel and the grid-tiled
// linear_relu_bwd_tiled, whose two pallas_calls are linear_flag_bwd_tiled
// at :396). `apply_relu` is a run-time argument, not a template parameter,
// so the executor's flag kernels (linear_flag_bwd, :322 and :396) can reuse
// it. On the TPU the split between one VMEM-resident block and two tiled
// kernels was forced by VMEM; here one launch covers every shape.
//
// The mask is applied as a multiply by (float)mask, exactly as the
// reference writes it (ops.relu_grad is `g * bitmask`, the Pallas kernel
// `g * mask_f32`), never as a select: a NaN or Inf in g at a masked
// position gives NaN, so a poisoned gradient stays visible.
//
// What bounds it on an H100: the flagship runs it at 32 rows (a scanned
// microbatch) and 128 rows (fused microbatches) over widths of 123-784,
// where it reads and writes W-sized arrays a few hundred KB large and does
// a few MFLOP: bound by bytes and, below that, by launch latency. At 128
// rows of mlp-deep's 2048x2048 it is bound by fp32 FFMA (67 TFLOP/s, no
// tensor cores: the reference contract is IEEE fp32, and TF32 keeps only
// 10 mantissa bits). What the design does about it: one launch per layer
// whose grid has two roles, dx tiles and dW tiles, so both products share
// the launch; the forward kernel's 64x64 output tile, 16-deep shared-memory
// stages and 4x4 register micro-tile; ge is formed while g and the mask are
// staged into shared memory and never goes to device memory. Making it
// fast (wgmma with 3xTF32, TMA, balancing the dx tiles' long N loop against
// the many short dW tiles) is later work.
//
// Determinism: each output element sums its reduction in one fixed order
// inside one thread (dx over n = 0..N-1, dW and db over m = 0..M-1), with
// no split-K and no atomics, so two launches give the same bits. db is
// written only by the dW tiles of the first K-tile, so it is never counted
// twice (the Pallas rule "db only on the first in-col tile", :387-393).
//
// Ragged edges: every dimension is masked in the kernel (the TPU wrapper
// zero-padded with _pad_to instead). Loads are scalar, because rows of
// width 127 are not 16-byte aligned.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BT = 64;  // output tile edge (rows and columns)
constexpr int BK = 16;  // depth of one shared-memory stage
constexpr int TM = 4;   // rows per thread
constexpr int TN = 4;   // columns per thread
constexpr int THREADS = (BT / TM) * (BT / TN);  // 256
constexpr int PAD = 4;  // breaks the stride-64 bank pattern of the strided stores

// One element of ge: the multiply keeps NaN * 0 = NaN (see the header).
__device__ __forceinline__ float grad_elem(const float* __restrict__ g,
                                           const uint8_t* __restrict__ mask,
                                           size_t i, int apply_relu) {
  const float v = g[i];
  if (!apply_relu) return v;
  return v * (mask[i] ? 1.0f : 0.0f);
}

// acc[i][j] += sum_k as[k][ty + 16 i] * bs[k][tx + 16 j], k = 0..BK-1 in order.
__device__ __forceinline__ void mac_stage(float (*as)[BT + PAD],
                                          float (*bs)[BT + PAD],
                                          float (&acc)[TM][TN], int tx, int ty) {
#pragma unroll
  for (int k = 0; k < BK; ++k) {
    float a[TM], b[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = as[k][ty + i * (BT / TM)];
#pragma unroll
    for (int j = 0; j < TN; ++j) b[j] = bs[k][tx + j * (BT / TN)];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// out[r0 + ty + 16 i][c0 + tx + 16 j] = acc[i][j] inside (rows x cols).
__device__ __forceinline__ void store_tile(float* __restrict__ out, int rows,
                                           int cols, int r0, int c0,
                                           const float (&acc)[TM][TN], int tx,
                                           int ty) {
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = r0 + ty + i * (BT / TM);
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = c0 + tx + j * (BT / TN);
      if (c < cols) out[(size_t)r * cols + c] = acc[i][j];
    }
  }
}

// Blocks [0, dx_blocks) each own a 64x64 tile of dx (rows m, columns k) and
// reduce over n; the blocks after them each own a 64x64 tile of dW (rows n,
// columns k) and reduce over m, and those of the first K-tile also write db.
__global__ void __launch_bounds__(THREADS)
linear_act_bwd_kernel(const float* __restrict__ g,
                      const uint8_t* __restrict__ mask,
                      const float* __restrict__ x, const float* __restrict__ w,
                      float* __restrict__ dx, float* __restrict__ dw,
                      float* __restrict__ db, int M, int N, int K,
                      int apply_relu, int k_tiles, int dx_blocks) {
  // stage-major tiles: as[s][r], bs[s][c] for reduction index s of the stage
  __shared__ float as[BK][BT + PAD];
  __shared__ float bs[BK][BT + PAD];

  const int tid = threadIdx.x;
  const int tx = tid % (BT / TN);  // 0..15: output columns tx + 16*j
  const int ty = tid / (BT / TN);  // 0..15: output rows ty + 16*i

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  if ((int)blockIdx.x < dx_blocks) {
    // dx[m][k] = sum_n ge[m][n] * w[n][k]
    const int m0 = ((int)blockIdx.x / k_tiles) * BT;
    const int k0 = ((int)blockIdx.x % k_tiles) * BT;
    for (int n0 = 0; n0 < N; n0 += BK) {
      // as[s][r] = ge[m0 + r][n0 + s]: neighbouring threads read
      // neighbouring n of one row of g (16 floats = 64 contiguous bytes)
      for (int e = tid; e < BT * BK; e += THREADS) {
        const int r = e / BK;
        const int s = e % BK;
        const int gm = m0 + r;
        const int gn = n0 + s;
        as[s][r] = (gm < M && gn < N)
                       ? grad_elem(g, mask, (size_t)gm * N + gn, apply_relu)
                       : 0.0f;
      }
      // bs[s][c] = w[n0 + s][k0 + c]: neighbouring threads, neighbouring k
      for (int e = tid; e < BK * BT; e += THREADS) {
        const int s = e / BT;
        const int c = e % BT;
        const int gn = n0 + s;
        const int gk = k0 + c;
        bs[s][c] = (gn < N && gk < K) ? w[(size_t)gn * K + gk] : 0.0f;
      }
      __syncthreads();
      // past N both tiles hold zeros, so the tail of the last stage adds
      // 0 * 0 and the per-element order stays n = 0..N-1
      mac_stage(as, bs, acc, tx, ty);
      __syncthreads();
    }
    store_tile(dx, M, K, m0, k0, acc, tx, ty);
    return;
  }

  // dW[n][k] = sum_m ge[m][n] * x[m][k];  db[n] = sum_m ge[m][n]
  const int bid = (int)blockIdx.x - dx_blocks;
  const int n0 = (bid / k_tiles) * BT;
  const int kt = bid % k_tiles;
  const int k0 = kt * BT;
  const bool with_db = kt == 0;
  float db_acc = 0.0f;
  for (int ms = 0; ms < M; ms += BK) {
    // as[s][r] = ge[ms + s][n0 + r], bs[s][c] = x[ms + s][k0 + c]: both
    // read along one row, neighbouring threads on neighbouring addresses
    for (int e = tid; e < BK * BT; e += THREADS) {
      const int s = e / BT;
      const int r = e % BT;
      const int gm = ms + s;
      const int gn = n0 + r;
      const int gk = k0 + r;
      as[s][r] = (gm < M && gn < N)
                     ? grad_elem(g, mask, (size_t)gm * N + gn, apply_relu)
                     : 0.0f;
      bs[s][r] = (gm < M && gk < K) ? x[(size_t)gm * K + gk] : 0.0f;
    }
    __syncthreads();
    if (with_db && tid < BT) {
      // thread tid owns db[n0 + tid]; rows past M hold zeros
#pragma unroll
      for (int s = 0; s < BK; ++s) db_acc += as[s][tid];
    }
    mac_stage(as, bs, acc, tx, ty);
    __syncthreads();
  }
  store_tile(dw, N, K, n0, k0, acc, tx, ty);
  if (with_db && tid < BT && n0 + tid < N) db[n0 + tid] = db_acc;
}

}  // namespace

// Plain C entry point, bound with ctypes. Pointers are device pointers of
// contiguous fp32 tensors (mask: one byte per element, torch.bool, read
// only when apply_relu; it may be null otherwise); `stream` is the caller's
// cudaStream_t. One launch computes dx, dW and db. Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int linear_act_bwd(const float* g, const uint8_t* mask,
                              const float* x, const float* w, float* dx,
                              float* dw, float* db, int M, int N, int K,
                              int apply_relu, void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  // at least one K-tile, so the dW role still writes db when K == 0
  const int k_tiles = K > 0 ? (K + BT - 1) / BT : 1;
  const int dx_blocks = ((M + BT - 1) / BT) * k_tiles;
  const int dw_blocks = ((N + BT - 1) / BT) * k_tiles;
  linear_act_bwd_kernel<<<dx_blocks + dw_blocks, THREADS, 0,
                          (cudaStream_t)stream>>>(
      g, mask, x, w, dx, dw, db, M, N, K, apply_relu, k_tiles, dx_blocks);
  return (int)cudaGetLastError();
}
