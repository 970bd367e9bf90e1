// linear_act_fwd: y = act(x @ W.T + b), mask = (x @ W.T + b) > 0, in fp32.
//
// Replaces the TPU kernels of shallowspeed_tpu/pallas_ops.py:88-143
// (linear_relu_fwd: the single-block _fwd_kernel and the grid-tiled
// linear_relu_fwd_tiled) and is written so that it can also stand in for
// the flag kernels of :199-306 (linear_flag_fwd / linear_flag_fwd_tiled):
// `apply_relu` is a run-time argument, not a template parameter. On the
// TPU the split between one VMEM-resident block and a 512-edge grid was a
// choice forced by VMEM; here one tiled kernel covers every shape.
//
// What bounds it on an H100: the serving path runs it at 8 rows per slot,
// where reading W dominates (784x128 floats against 8x784 of x) and the
// card is bound by bytes and, below that, by launch latency; at 128+ rows
// of 2048x2048 it is bound by fp32 FFMA (67 TFLOP/s, no tensor cores: the
// reference contract is IEEE fp32, and TF32 keeps only 10 mantissa bits).
// What the design does about it: a 64x64 output tile per block, staged
// through shared memory 16 deep along K, with a 4x4 register micro-tile
// per thread, so each loaded element feeds 64 FFMAs from shared memory;
// bias, mask and relu are applied on the accumulators, so the
// pre-activation z never goes to device memory. Making it fast (wgmma
// with 3xTF32, TMA, a smaller row tile for 8-row slots) is later work.
//
// Determinism: each output element sums K in one fixed order (k = 0, 1,
// ..., K-1, one fmaf each) inside one thread, with no split-K and no
// atomics. A row's result therefore does not depend on the other rows of
// the launch, and two launches give the same bits: the serving engine's
// "response == direct predict()" contract rides on that.
//
// Ragged edges: every dimension is masked in the kernel (the TPU wrapper
// zero-padded with _pad_to instead). Loads are scalar, because rows of
// width 127 are not 16-byte aligned.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;  // rows of x per block
constexpr int BN = 64;  // rows of W (output columns) per block
constexpr int BK = 16;  // depth of one shared-memory stage
constexpr int TM = 4;   // rows per thread
constexpr int TN = 4;   // columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int PAD = 4;  // breaks the stride-64 bank pattern of the K-major stores

__global__ void __launch_bounds__(THREADS)
linear_act_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ b, float* __restrict__ y,
                      uint8_t* __restrict__ mask, int M, int N, int K,
                      int apply_relu) {
  // K-major tiles: xs[k][m] = x[m0 + m][k0 + k], ws[k][n] = w[n0 + n][k0 + k]
  __shared__ float xs[BK][BM + PAD];
  __shared__ float ws[BK][BN + PAD];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);  // 0..15: output columns tx + 16*j
  const int ty = tid / (BN / TN);  // 0..15: output rows ty + 16*i
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // each thread stages 4 elements of each tile; neighbouring threads
    // read neighbouring k of one row (16 floats = 64 contiguous bytes)
#pragma unroll
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK;
      const int c = e % BK;
      const int gk = k0 + c;
      const int gm = m0 + r;
      const int gn = n0 + r;
      xs[c][r] = (gm < M && gk < K) ? x[(size_t)gm * K + gk] : 0.0f;
      ws[c][r] = (gn < N && gk < K) ? w[(size_t)gn * K + gk] : 0.0f;
    }
    __syncthreads();
    // past K both tiles hold zeros, so the tail of the last stage adds
    // 0 * 0 to every sum and the per-element order stays k = 0..K-1
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[k][ty + i * (BM / TM)];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = ws[k][tx + j * (BN / TN)];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // fused epilogue on the accumulators: bias, mask, activation. relu keeps
  // a NaN (as torch.relu and jnp.maximum do), so a poisoned weight stays
  // visible to the serving engine's finiteness gate.
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + i * (BM / TM);
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + j * (BN / TN);
      if (gn >= N) continue;
      const float z = acc[i][j] + b[gn];
      const bool pos = z > 0.0f;
      const size_t o = (size_t)gm * N + gn;
      mask[o] = pos ? 1 : 0;
      y[o] = (!apply_relu || pos || z != z) ? z : 0.0f;
    }
  }
}

}  // namespace

// Plain C entry point, bound with ctypes. Pointers are device pointers of
// contiguous fp32 tensors (mask: one byte per element, torch.bool);
// `stream` is the caller's cudaStream_t. Returns cudaGetLastError() after
// the launch (0 = launched).
extern "C" int linear_act_fwd(const float* x, const float* w, const float* b,
                              float* y, uint8_t* mask, int M, int N, int K,
                              int apply_relu, void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  linear_act_fwd_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      x, w, b, y, mask, M, N, K, apply_relu);
  return (int)cudaGetLastError();
}
