// linear_act_fwd: y = act(x @ W.T + b), mask = (x @ W.T + b) > 0, in fp32.
//
// Replaces the TPU kernels of shallowspeed_tpu/pallas_ops.py:88-143
// (linear_relu_fwd: the single-block _fwd_kernel and the grid-tiled
// linear_relu_fwd_tiled) and the flag kernels of :199-306 (linear_flag_fwd /
// linear_flag_fwd_tiled): `apply_relu` is a run-time argument, so one
// compiled kernel serves every executor slot. On the TPU the split between
// one VMEM-resident block and a 512-edge grid was forced by VMEM; here one
// kernel covers every shape, with a launch plan sized to the shape.
//
// What bounds it on an H100: the main path runs it at 4-32 rows (a serving
// slot of 8, the executor's slots, a microbatch of 32) against W of 0.06-16
// MB warm in L2. There the work is a few MFLOP and the time is latency: of
// the launch, and of each block's walk down K, where every 16-deep stage
// costs a barrier, a round of copies and a dependent fmaf chain with one
// warp per scheduler to hide nothing. A 64x64 output tile per block gave
// 784 -> 128 at 8 rows 2 blocks on 132 SMs, each walking all 49 stages. At
// 128+ rows of mlp-deep's 2048 x 2048 it is bound by fp32 FFMA (67 TFLOP/s;
// no tensor cores: the reference contract is IEEE fp32, and TF32 keeps 10
// mantissa bits). What the design does about it:
// - a row tile sized to M (8, 16, 32 up to 64 rows, 64 above) and a column
//   tile of 32 (64 for 64-row tiles), so few rows still give the card tens
//   to hundreds of blocks (cuda_ops.fwd_plan makes the plan, this file
//   checks it);
// - K split over the blocks of a thread block cluster of up to 8, in chunks
//   of about 32 terms (2 stages) where K allows: each rank reduces one chunk,
//   then the ranks add the partial tiles in rank order through distributed
//   shared memory, each rank finishing 1/chunks of the tile (bias, mask and
//   relu on the sum; a plan of one chunk finishes in registers). No global
//   workspace, no atomics, no second launch;
// - a 4-slot cp.async ring, 16 deep along K (staging.cuh), one
//   __syncthreads per stage; float4 reads from shared memory along K.
// The pre-activation z never goes to device memory.
//
// The order rule (determinism and row independence): the chunking of K is
// a function of K alone (cuda_ops.reduction_chunks: at most
// min(8, ceil(K / 32)) chunks, each a multiple of 16 terms). Output element (m, n) is
//   z = (((p_0 + p_1) + p_2) + ... + p_{chunks-1}) + b[n],
//   p_r = fmaf chain over k = k_r, k_r + 1, ... from 0.0f, one thread,
// where chunk r's last stage runs past K on zeros (0 * 0 in every plan
// alike). Nothing in it depends on M, on the row tile or on the other rows
// of the launch: a row's bits are a function of that row of x, W, b and K,
// which the serving engine's "response == direct predict()" contract
// rides on; two launches give the same bits.
//
// NaN: relu keeps a NaN (as torch.relu and jnp.maximum do), so a poisoned
// weight stays visible to the serving engine's finiteness gate.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "staging.cuh"

namespace cg = cooperative_groups;
using namespace staging;

namespace {

// BM x BN output tile per block, TM x TN per thread; rows ty + i * (BM / TM),
// columns tx + j * (BN / TN), so a quarter warp reads 8 consecutive W rows
// (distinct bank groups at stride LD) and one x row (a broadcast).
template <int BM, int BN, int TM, int TN>
struct FwdTile {
  static constexpr int TX = BN / TN;  // threads along n
  static constexpr int RG = BM / TM;  // threads along m
  static_assert(TX * RG == THREADS, "one thread per micro-tile");
  static constexpr int STAGE = (BM + BN) * LD;  // floats of one ring slot
  static constexpr int PN = BN + TX;            // partial tile row stride
  static constexpr int RING = STAGES * STAGE;
  static constexpr int SMEM = RING > BM * PN ? RING : BM * PN;
};

// The epilogue of one element from its pre-activation z: the mask, and y.
// relu keeps a NaN (z != z).
__device__ __forceinline__ void finish(float* __restrict__ y, uint8_t* __restrict__ mask,
                                       int gm, int gn, int N, float z, int apply_relu) {
  const bool pos = z > 0.0f;
  const size_t out = (size_t)gm * N + gn;
  mask[out] = pos ? 1 : 0;
  y[out] = (!apply_relu || pos || z != z) ? z : 0.0f;
}

// The 64-row tile keeps to 170 registers so that 3 blocks share an SM: the
// 128-row mlp-deep shapes run hundreds of them.
template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(THREADS, BM == 64 ? 3 : 1)
linear_act_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ b, float* __restrict__ y,
                      uint8_t* __restrict__ mask, int M, int N, int K, int apply_relu,
                      int chunks, int chunk_len, int vec) {
  using T = FwdTile<BM, BN, TM, TN>;
  __shared__ __align__(16) float smem[T::SMEM];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();  // this block's chunk of K
  const int tid = threadIdx.x;
  const int tx = tid % T::TX;
  const int ty = tid / T::TX;
  const int n0 = ((int)blockIdx.x / chunks) * BN;
  const int m0 = (int)blockIdx.y * BM;
  const int k_lo = rank * chunk_len;
  const int k_hi = min(K, k_lo + chunk_len);
  const int n_stages = k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0;

  auto issue = [&](int s) {
    if (s < n_stages) {
      float* xs = smem + (s % STAGES) * T::STAGE;
      stage_tile<BM>(xs, x, m0, M, K, k_lo + s * BK, vec, tid);
      stage_tile<BN>(xs + BM * LD, w, n0, N, K, k_lo + s * BK, vec, tid);
    }
    cp_async_commit();  // empty groups too: the wait count stays uniform
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    issue(s + STAGES - 1);
    const float* xs = smem + (s % STAGES) * T::STAGE;
    const float* ws = xs + BM * LD;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float4 a[TM], v[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(xs + (ty + i * T::RG) * LD + kk);
#pragma unroll
      for (int j = 0; j < TN; ++j)
        v[j] = *reinterpret_cast<const float4*>(ws + (tx + j * T::TX) * LD + kk);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc[i][j] = fmaf(a[i].x, v[j].x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, v[j].y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, v[j].z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, v[j].w, acc[i][j]);
        }
    }
  }
  cp_async_wait<0>();
  if (chunks == 1) {  // the sum is this block's partial: finish it in registers
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int gm = m0 + ty + i * T::RG;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int gn = n0 + tx + j * T::TX;
        if (gm < M && gn < N) finish(y, mask, gm, gn, N, __fadd_rn(acc[i][j], b[gn]), apply_relu);
      }
    }
    return;
  }
  __syncthreads();  // the ring becomes the partial tile

  float* part = smem;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) part[(ty + i * T::RG) * T::PN + tx + j * T::TX] = acc[i][j];
  cluster.sync();  // every rank's partial tile is written and visible

  // this rank finishes every chunks-th group of THREADS elements of the
  // tile: the partials in rank order, then bias, mask and activation. BN
  // divides THREADS, so a thread keeps one column (and one bias) throughout.
  const int e0 = rank * THREADS + tid;
  const int gn = n0 + e0 % BN;
  const float bias = gn < N ? b[gn] : 0.0f;
#pragma unroll 4
  for (int r = e0 / BN; r < BM && gn < N; r += chunks * (THREADS / BN)) {
    const int gm = m0 + r;
    if (gm >= M) break;
    finish(y, mask, gm, gn, N,
           __fadd_rn(ordered_sum(cluster, part, r * T::PN + e0 % BN, chunks), bias), apply_relu);
  }
  cluster.sync();  // no block leaves while another still reads its tile
}

template <int BM, int BN, int TM, int TN>
cudaError_t launch(const float* x, const float* w, const float* b, float* y, uint8_t* mask,
                   int M, int N, int K, int apply_relu, int chunks, int chunk_len,
                   cudaStream_t stream) {
  const int m_tiles = (M + BM - 1) / BM;
  if (m_tiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid(((N + BN - 1) / BN) * chunks, m_tiles, 1);
  const int vec = K % 4 == 0 && aligned16(x) && aligned16(w);
  return launch_clustered(linear_act_fwd_kernel<BM, BN, TM, TN>, grid, chunks, stream, x, w, b,
                          y, mask, M, N, K, apply_relu, chunks, chunk_len, vec);
}

}  // namespace

// Plain C entry point, bound with ctypes. Pointers are device pointers of
// contiguous fp32 tensors (mask: one byte per element, torch.bool);
// `stream` is the caller's cudaStream_t. The launch plan (row_tile,
// col_tile, chunks, chunk_len) is cuda_ops.fwd_plan's: the row x column
// tiles below, and `chunks` chunks of `chunk_len` terms covering K, one per
// rank of a cluster of `chunks` blocks. One launch. Returns its error
// (0 = launched); cudaErrorInvalidValue for a plan outside that set.
extern "C" int linear_act_fwd(const float* x, const float* w, const float* b, float* y,
                              uint8_t* mask, int M, int N, int K, int apply_relu,
                              int row_tile, int col_tile, int chunks, int chunk_len,
                              void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  if (!chunks_cover(K, chunks, chunk_len)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (row_tile == 8 && col_tile == 32)
    return (int)launch<8, 32, 1, 2>(x, w, b, y, mask, M, N, K, apply_relu, chunks, chunk_len, s);
  if (row_tile == 16 && col_tile == 32)
    return (int)launch<16, 32, 2, 2>(x, w, b, y, mask, M, N, K, apply_relu, chunks, chunk_len, s);
  if (row_tile == 32 && col_tile == 32)
    return (int)launch<32, 32, 2, 4>(x, w, b, y, mask, M, N, K, apply_relu, chunks, chunk_len, s);
  if (row_tile == 64 && col_tile == 64)
    return (int)launch<64, 64, 4, 8>(x, w, b, y, mask, M, N, K, apply_relu, chunks, chunk_len, s);
  return (int)cudaErrorInvalidValue;
}
