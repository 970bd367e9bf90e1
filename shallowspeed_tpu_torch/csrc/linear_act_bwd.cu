// linear_act_bwd: the backward of linear_act_fwd in fp32.
//
//   ge = g * mask   (apply_relu; ge = g otherwise)
//   dx = ge @ W      (M x K)
//   dW = ge.T @ x    (N x K)
//   db = sum_rows ge (N)
//
// Replaces the TPU kernels of shallowspeed_tpu/pallas_ops.py:146-191
// (linear_relu_bwd: the single-block _bwd_kernel and the grid-tiled
// linear_relu_bwd_tiled) and the flag kernels of :309-440 (linear_flag_bwd
// and linear_flag_bwd_tiled, whose two pallas_calls at :408 and :423 are the
// dx and dW roles below). `apply_relu` is a run-time argument, so one
// compiled kernel serves every executor slot. On the TPU the split between
// one VMEM-resident block and two tiled kernels was forced by VMEM; here
// one launch covers every shape.
//
// The mask is applied as a multiply by (float)mask, exactly as the
// reference writes it (ops.relu_grad is `g * bitmask`, the Pallas kernel
// `g * mask_f32`), never as a select: a NaN or Inf in g at a masked
// position gives NaN, so a poisoned gradient stays visible.
//
// What bounds it on an H100: the main path runs it at 8-32 rows (executor
// slots, a microbatch) and 128 (fused microbatches) over widths of 10-2048,
// reading and writing W-sized arrays of 0.06-16 MB and doing at most a few
// hundred MFLOP: bound by latency, as the forward is (each block's walk down
// its reduction, 16 deep a stage); at 128 rows of mlp-deep's 2048 x 2048, by
// fp32 FFMA (67 TFLOP/s, no tensor cores: IEEE fp32 is the reference
// contract). Its two products are unbalanced: dx reduces over N (up to 2048
// terms) with M x K outputs, dW over M (8-128) with N x K. A 64x64 tile per
// block gave dx at 32 x 784 -> 2048 13 blocks, each walking all 128 stages
// of N, beside 416 dW blocks of 2 stages. What the design does about it:
// - one launch whose grid holds both roles, in thread block clusters of
//   `chunks` blocks (cuda_ops.bwd_plan makes the plan, this file checks it);
// - the dx role: a row tile sized to M (8, 16, 32 up to 64 rows, 64 above)
//   x 64 columns of K; N split over the cluster's ranks (at most
//   min(8, ceil(N / 32)) chunks, a function of N alone), each rank reducing one
//   chunk, then the ranks add the partial tiles in rank order through
//   distributed shared memory, each finishing 1/chunks of the tile. No
//   workspace, no atomics, one launch;
// - the dW role: 64 x 64 tiles of dW reducing over M. Where the tiles are
//   fewer than the SMs (the flagship's 128-wide layers), M is split over the
//   cluster's ranks too and added in rank order as dx is; else a cluster's
//   ranks take adjacent tiles. The tiles of the first K-tile also sum db,
//   so db is counted once (the Pallas rule "db only on the first in-col
//   tile", :387-393);
// - the forward's 4-slot cp.async ring, 16 deep along the reduction. The
//   mask's bytes are staged as aligned 4-byte words (a row of 127 bytes
//   starts anywhere); once a stage lands, ge = g * mask is formed in place,
//   once per element, behind a second barrier, so no thread re-masks the
//   values it shares and ge never goes to device memory.
//
// At M >= 128, N, K >= 512 and N * K >= 768 * 512 (mlp-deep's 128- and
// 256-row microbatches) the work is FLOP-bound and those tiles are too
// small: 32 accumulators a thread read ~12 16-byte shared loads for every
// 128 FFMA, and 2048 short blocks repeat their prologues and cluster sums.
// There cuda_ops.bwd_plan picks the wide family (row_tile = col_tile = 128;
// on an H100 it lost to the 64-wide plans below that line):
// - one 128 x 128 output tile a block of 256 threads, 8 x 8 outputs a
//   thread as outer products of two float4 of each operand a step (16 FFMA
//   a shared load), one block an SM with up to 255 registers: measured on
//   an H100, two blocks an SM at 128 registers spilled and ran 20% slower;
// - a 4-slot cp.async ring of BK = 16 in 98 KB of dynamic shared memory,
//   each thread's copies kept as running addresses; ge formed one stage
//   ahead of the FFMA, so one barrier a stage: dW's g panel masked in
//   place, dx's g tile masked while it is moved to n-major order (every
//   element once, ge still never in device memory). Where N % 16 == 0, K %
//   4 == 0 and every tensor is 16-byte aligned, every copy (the mask's
//   bytes too) and store moves 16 bytes; else 4-byte copies;
// - dW's tiles reduce all of M; dx's N splits over a cluster of `chunks`
//   ranks added in rank order through distributed shared memory, the
//   chunks chosen by the plan so that the dx blocks, which go first, and
//   the dW blocks end together on the card's 132 SMs.
//
// The order rule (determinism): dx[m][k] = ((p_0 + p_1) + ...) + p_{c-1},
// p_r an fmaf chain over n in chunk r from 0.0f; dW[n][k] and db[n] the
// same over the chunks of M (one chunk when M is not split, and always in
// the wide family), db's chain an __fadd_rn chain. Each in one thread, in
// an order fixed by the shapes, with no atomics: two launches give the same
// bits. The backward has no row-independence rule: its chunking of N and M
// may depend on M, N and K.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "staging.cuh"

namespace cg = cooperative_groups;
using namespace staging;

namespace {

constexpr int DX_COLS = PANEL;  // dx columns (k) per block
constexpr int DX_MWORDS = 5;    // mask words per row of a dx stage: 16 bytes at any offset
constexpr int DW_TILE = PANEL;  // dW tile edge (n and k)
constexpr int DW_MWORDS = 17;   // mask words per row of a dW stage: 64 bytes at any offset

// The dx role's tile: BM rows of M x DX_COLS columns of K per block; TM
// rows (ty + i * RG) and TN columns per thread, the columns in float4
// groups (j / 4) * (4 * TX) + 4 * tx + j % 4 so that a quarter warp's float4
// reads of a W panel row are 128 contiguous bytes.
template <int BM>
struct DxTile {
  static constexpr int TN = BM == 64 ? 8 : 4;
  static constexpr int TX = DX_COLS / TN;  // threads along k
  static constexpr int RG = THREADS / TX;  // threads along m
  static constexpr int TM = BM / RG;
  static_assert(TM * RG == BM, "the row tile splits evenly");
  // one ring slot: ge's source g (BM x LD), a W panel (BK x PANEL), the
  // mask words (BM x DX_MWORDS); every part a multiple of 4 words
  static constexpr int A = BM * LD;
  static constexpr int B = BK * PANEL;
  static constexpr int STAGE = A + B + BM * DX_MWORDS;
  static constexpr int PN = DX_COLS + 4;  // partial tile row stride
  static constexpr int RING = STAGES * STAGE;
  static constexpr int SMEM = RING > BM * PN ? RING : BM * PN;
};

// The dW role: 4 rows of n (4 * ty + i) x 8 columns of k per thread.
constexpr int DW_TM = 4;
constexpr int DW_TN = 8;
constexpr int DW_TX = DW_TILE / DW_TN;  // 8
constexpr int DW_STAGE = 2 * BK * PANEL + BK * DW_MWORDS;
constexpr int DW_PN = DW_TILE + 4;  // partial tile row stride (split M)
constexpr int DW_SMEM = STAGES * DW_STAGE;
static_assert((DW_TILE / DW_TM) * DW_TX == THREADS, "one thread per micro-tile");
static_assert(DW_TILE * DW_PN + DW_TILE <= DW_SMEM, "the partials fit the ring");

template <int BM>
__host__ __device__ constexpr int bwd_smem() {
  return DxTile<BM>::SMEM > DW_SMEM ? DxTile<BM>::SMEM : DW_SMEM;
}

// Column j of a thread's TN columns, in float4 groups (see DxTile).
template <int TX>
__device__ __forceinline__ int col_of(int tx, int j) {
  return (j / 4) * (4 * TX) + 4 * tx + j % 4;
}

// The mask as aligned 4-byte words: byte o of the tensor is byte moff + o
// of `mbase`, which is 4-byte aligned. A word holding any byte of the
// tensor lies inside its allocation, so the copies never fault; the bytes
// past the tensor's end are zero-filled, not read.
struct MaskWords {
  const uint8_t* mbase;
  long long moff;
  long long end;  // moff + M * N
};

// Stage the words holding bytes [o, o + 4 * (WORDS - 1)) of each of ROWS
// mask rows, o = moff + (row0 + r) * N + c0, into dst[r * WORDS + q]. The
// byte for column c0 + c of row r is then byte (o & 3) + c of the row.
template <int ROWS, int WORDS>
__device__ __forceinline__ void stage_mask(uint32_t* dst, const MaskWords& mw, int row0,
                                           int rows, int N, int c0, int tid) {
  constexpr int PIECES = ROWS * WORDS;
#pragma unroll
  for (int i = 0; i < (PIECES + THREADS - 1) / THREADS; ++i) {
    const int e = tid + i * THREADS;
    if (PIECES % THREADS && e >= PIECES) break;
    const int r = e / WORDS;
    const int q = e % WORDS;
    const long long word = ((mw.moff + (long long)(row0 + r) * N + c0) & ~3LL) + 4 * q;
    long long bytes = row0 + r < rows ? mw.end - word : 0;
    bytes = bytes < 0 ? 0 : (bytes > 4 ? 4 : bytes);
    cp_async4(dst + e, bytes ? mw.mbase + word : mw.mbase, (int)bytes);
  }
}

// Where column c0 of mask row `row` sits in its staged words (c0 a
// multiple of 4, as every stage's and tile's first column is).
__device__ __forceinline__ int mask_shift(const MaskWords& mw, int row, int N) {
  return (int)((unsigned)mw.moff + (unsigned)row * (unsigned)N) & 3;
}

// Four floats times the four mask bytes of `v` as 0.0f or 1.0f.
__device__ __forceinline__ float4 masked(float4 a, uint32_t v) {
  a.x *= (v & 0xffu) ? 1.0f : 0.0f;
  a.y *= (v & 0xff00u) ? 1.0f : 0.0f;
  a.z *= (v & 0xff0000u) ? 1.0f : 0.0f;
  a.w *= (v & 0xff000000u) ? 1.0f : 0.0f;
  return a;
}

// ge = g * mask in place, for the ROWS x (4 * QUADS) floats of g staged at
// `g` (row stride `ld`) from mask rows row0.., their words at `words` (row
// stride WORDS). Once per element, for every thread that reads it after
// the next barrier; a multiply, so NaN * 0 stays NaN.
template <int ROWS, int QUADS, int WORDS>
__device__ __forceinline__ void apply_mask(float* g, int ld, const uint32_t* words,
                                           const MaskWords& mw, int row0, int N, int tid) {
  constexpr int PIECES = ROWS * QUADS;
#pragma unroll
  for (int i = 0; i < (PIECES + THREADS - 1) / THREADS; ++i) {
    const int e = tid + i * THREADS;
    if (PIECES % THREADS && e >= PIECES) break;
    const int r = e / QUADS;
    const int q = e % QUADS;
    const uint32_t* w = words + r * WORDS;
    const uint32_t v = __funnelshift_r(w[q], w[q + 1], 8 * mask_shift(mw, row0 + r, N));
    float4* p = reinterpret_cast<float4*>(g + r * ld + 4 * q);
    *p = masked(*p, v);
  }
}

__device__ __forceinline__ float comp(const float4& v, int t) {
  return t == 0 ? v.x : (t == 1 ? v.y : (t == 2 ? v.z : v.w));
}

// dx[m][k] = sum_n ge[m][n] * w[n][k] for one (row tile, column tile) and
// this rank's chunk of N; the cluster then adds the chunks in rank order.
template <int BM>
__device__ __forceinline__ void dx_role(const float* __restrict__ g, const MaskWords& mw,
                                        const float* __restrict__ w, float* __restrict__ dx,
                                        int M, int N, int K, int apply_relu, int chunks,
                                        int chunk_len, int vec_g, int vec_k, float* smem) {
  using T = DxTile<BM>;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tile = (int)blockIdx.x / chunks;
  const int k_tiles = (K + DX_COLS - 1) / DX_COLS;
  const int m0 = (tile / k_tiles) * BM;
  const int k0 = (tile % k_tiles) * DX_COLS;
  const int n_lo = rank * chunk_len;
  const int n_hi = min(N, n_lo + chunk_len);
  const int n_stages = (n_hi - n_lo + BK - 1) / BK;
  const int tid = threadIdx.x;
  const int tx = tid % T::TX;
  const int ty = tid / T::TX;

  auto issue = [&](int s) {
    if (s < n_stages) {
      float* slot = smem + (s % STAGES) * T::STAGE;
      const int ns = n_lo + s * BK;
      stage_tile<BM>(slot, g, m0, M, N, ns, vec_g, tid);
      stage_panel(slot + T::A, w, ns, N, K, k0, vec_k, tid);
      if (apply_relu)
        stage_mask<BM, DX_MWORDS>(reinterpret_cast<uint32_t*>(slot + T::A + T::B), mw, m0, M, N,
                                  ns, tid);
    }
    cp_async_commit();
  };

  float acc[T::TM][T::TN];
#pragma unroll
  for (int i = 0; i < T::TM; ++i)
#pragma unroll
    for (int j = 0; j < T::TN; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    float* as = smem + (s % STAGES) * T::STAGE;
    const float* bs = as + T::A;
    if (apply_relu) {
      apply_mask<BM, BK / 4, DX_MWORDS>(as, LD, reinterpret_cast<const uint32_t*>(bs + T::B),
                                        mw, m0, N, tid);
      __syncthreads();
    }
    issue(s + STAGES - 1);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float4 a[T::TM];
#pragma unroll
      for (int i = 0; i < T::TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(as + (ty + i * T::RG) * LD + kk);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        float v[T::TN];
#pragma unroll
        for (int j4 = 0; j4 < T::TN / 4; ++j4) {
          const float4 q = *reinterpret_cast<const float4*>(bs + (kk + t) * PANEL +
                                                            col_of<T::TX>(tx, 4 * j4));
          v[4 * j4] = q.x;
          v[4 * j4 + 1] = q.y;
          v[4 * j4 + 2] = q.z;
          v[4 * j4 + 3] = q.w;
        }
#pragma unroll
        for (int i = 0; i < T::TM; ++i) {
          const float ai = comp(a[i], t);
#pragma unroll
          for (int j = 0; j < T::TN; ++j) acc[i][j] = fmaf(ai, v[j], acc[i][j]);
        }
      }
    }
  }
  cp_async_wait<0>();
  if (chunks == 1) {  // the sum is this block's partial: store it from registers
#pragma unroll
    for (int i = 0; i < T::TM; ++i) {
      const int gm = m0 + ty + i * T::RG;
      if (gm >= M) continue;
#pragma unroll
      for (int j = 0; j < T::TN; ++j) {
        const int gk = k0 + col_of<T::TX>(tx, j);
        if (gk < K) dx[(size_t)gm * K + gk] = acc[i][j];
      }
    }
    return;
  }
  __syncthreads();  // the ring becomes the partial tile

  float* part = smem;
#pragma unroll
  for (int i = 0; i < T::TM; ++i)
#pragma unroll
    for (int j4 = 0; j4 < T::TN / 4; ++j4)
      *reinterpret_cast<float4*>(part + (ty + i * T::RG) * T::PN + col_of<T::TX>(tx, 4 * j4)) =
          make_float4(acc[i][4 * j4], acc[i][4 * j4 + 1], acc[i][4 * j4 + 2],
                      acc[i][4 * j4 + 3]);
  cluster.sync();

  // DX_COLS divides THREADS: a thread keeps one column throughout
  const int e0 = rank * THREADS + tid;
  const int gk = k0 + e0 % DX_COLS;
  for (int r = e0 / DX_COLS; r < BM && gk < K; r += chunks * (THREADS / DX_COLS)) {
    if (m0 + r >= M) break;
    dx[(size_t)(m0 + r) * K + gk] = ordered_sum(cluster, part, r * T::PN + e0 % DX_COLS, chunks);
  }
  cluster.sync();  // no block leaves while another still reads its tile
}

// dW[n][k] = sum_m ge[m][n] * x[m][k] for one 64 x 64 tile; the tiles of
// the first K-tile also write db[n] = sum_m ge[m][n]. `m_chunk` 0: the
// block reduces all of M (a cluster's ranks take adjacent tiles); else
// rank r reduces rows [r * m_chunk, (r + 1) * m_chunk) and the cluster adds
// the ranks' partial tiles (and db) in rank order.
__device__ __forceinline__ void dw_role(const float* __restrict__ g, const MaskWords& mw,
                                        const float* __restrict__ x, float* __restrict__ dw,
                                        float* __restrict__ db, int M, int N, int K,
                                        int apply_relu, int chunks, int m_chunk, int vec_g,
                                        int vec_k, float* smem, int block) {
  const int k_tiles = K > 0 ? (K + DW_TILE - 1) / DW_TILE : 1;  // db needs one
  const int tile = m_chunk ? block / chunks : block;
  if (!m_chunk && tile >= ((N + DW_TILE - 1) / DW_TILE) * k_tiles) return;  // a spare rank
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = m_chunk ? (int)cluster.block_rank() : 0;
  const int m_lo = rank * m_chunk;
  const int m_hi = m_chunk ? min(M, m_lo + m_chunk) : M;
  const int m_stages = m_hi > m_lo ? (m_hi - m_lo + BK - 1) / BK : 0;
  const int n0 = (tile / k_tiles) * DW_TILE;
  const int k0 = (tile % k_tiles) * DW_TILE;
  const bool with_db = tile % k_tiles == 0;
  const int tid = threadIdx.x;
  const int tx = tid % DW_TX;
  const int ty = tid / DW_TX;  // n rows 4 * ty .. 4 * ty + 3

  auto issue = [&](int s) {
    if (s < m_stages) {
      float* slot = smem + (s % STAGES) * DW_STAGE;
      const int ms = m_lo + s * BK;
      stage_panel(slot, g, ms, M, N, n0, vec_g, tid);
      stage_panel(slot + BK * PANEL, x, ms, M, K, k0, vec_k, tid);
      if (apply_relu)
        stage_mask<BK, DW_MWORDS>(reinterpret_cast<uint32_t*>(slot + 2 * BK * PANEL), mw, ms, M,
                                  N, n0, tid);
    }
    cp_async_commit();
  };

  float acc[DW_TM][DW_TN];
#pragma unroll
  for (int i = 0; i < DW_TM; ++i)
#pragma unroll
    for (int j = 0; j < DW_TN; ++j) acc[i][j] = 0.0f;
  float db_acc = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);
  for (int s = 0; s < m_stages; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    float* as = smem + (s % STAGES) * DW_STAGE;
    const float* bs = as + BK * PANEL;
    if (apply_relu) {
      apply_mask<BK, PANEL / 4, DW_MWORDS>(as, PANEL,
                                           reinterpret_cast<const uint32_t*>(bs + BK * PANEL),
                                           mw, m_lo + s * BK, N, tid);
      __syncthreads();
    }
    issue(s + STAGES - 1);
#pragma unroll 4
    for (int t = 0; t < BK; ++t) {
      const float4 a = *reinterpret_cast<const float4*>(as + t * PANEL + 4 * ty);
      float v[DW_TN];
#pragma unroll
      for (int j4 = 0; j4 < DW_TN / 4; ++j4) {
        const float4 q =
            *reinterpret_cast<const float4*>(bs + t * PANEL + col_of<DW_TX>(tx, 4 * j4));
        v[4 * j4] = q.x;
        v[4 * j4 + 1] = q.y;
        v[4 * j4 + 2] = q.z;
        v[4 * j4 + 3] = q.w;
      }
#pragma unroll
      for (int i = 0; i < DW_TM; ++i) {
        const float ai = comp(a, i);
#pragma unroll
        for (int j = 0; j < DW_TN; ++j) acc[i][j] = fmaf(ai, v[j], acc[i][j]);
      }
    }
    if (with_db && tid < DW_TILE) {
      // thread tid owns db[n0 + tid]; rows past M hold zeros
#pragma unroll
      for (int t = 0; t < BK; ++t) db_acc = __fadd_rn(db_acc, as[t * PANEL + tid]);
    }
  }
  cp_async_wait<0>();

  if (!m_chunk) {
#pragma unroll
    for (int i = 0; i < DW_TM; ++i) {
      const int gn = n0 + 4 * ty + i;
      if (gn >= N) continue;
#pragma unroll
      for (int j = 0; j < DW_TN; ++j) {
        const int gk = k0 + col_of<DW_TX>(tx, j);
        if (gk < K) dw[(size_t)gn * K + gk] = acc[i][j];
      }
    }
    if (with_db && tid < DW_TILE && n0 + tid < N) db[n0 + tid] = db_acc;
    return;
  }

  __syncthreads();  // the ring becomes the partial tile and db
  float* part = smem;
  float* dbp = smem + DW_TILE * DW_PN;
#pragma unroll
  for (int i = 0; i < DW_TM; ++i)
#pragma unroll
    for (int j4 = 0; j4 < DW_TN / 4; ++j4)
      *reinterpret_cast<float4*>(part + (4 * ty + i) * DW_PN + col_of<DW_TX>(tx, 4 * j4)) =
          make_float4(acc[i][4 * j4], acc[i][4 * j4 + 1], acc[i][4 * j4 + 2],
                      acc[i][4 * j4 + 3]);
  if (tid < DW_TILE) dbp[tid] = db_acc;
  cluster.sync();

  // DW_TILE divides THREADS: a thread keeps one column throughout
  const int e0 = rank * THREADS + tid;
  const int gk = k0 + e0 % DW_TILE;
  for (int r = e0 / DW_TILE; r < DW_TILE && gk < K; r += chunks * (THREADS / DW_TILE)) {
    if (n0 + r >= N) break;
    dw[(size_t)(n0 + r) * K + gk] = ordered_sum(cluster, part, r * DW_PN + e0 % DW_TILE, chunks);
  }
  if (with_db && rank == 0 && tid < DW_TILE && n0 + tid < N)
    db[n0 + tid] = ordered_sum(cluster, dbp, tid, chunks);
  cluster.sync();  // no block leaves while another still reads its tile
}

// Blocks [0, dx_blocks) are the dx role, in clusters of `chunks` (one per
// chunk of N); the blocks after them the dW role. The 64-row tile keeps to
// 170 registers so that 3 blocks share an SM (mlp-deep's 128-row shapes).
template <int BM>
__global__ void __launch_bounds__(THREADS, BM == 64 ? 3 : 1)
linear_act_bwd_kernel(const float* __restrict__ g, const uint8_t* mask,
                      const float* __restrict__ x, const float* __restrict__ w,
                      float* __restrict__ dx, float* __restrict__ dw, float* __restrict__ db,
                      int M, int N, int K, int apply_relu, int chunks, int chunk_len,
                      int m_chunk, int dx_blocks, int vec_g, int vec_k) {
  __shared__ __align__(16) float smem[bwd_smem<BM>()];
  const uintptr_t addr = reinterpret_cast<uintptr_t>(mask);
  const MaskWords mw{mask - (addr & 3), (long long)(addr & 3),
                     (long long)(addr & 3) + (long long)M * N};
  if ((int)blockIdx.x < dx_blocks)
    dx_role<BM>(g, mw, w, dx, M, N, K, apply_relu, chunks, chunk_len, vec_g, vec_k, smem);
  else
    dw_role(g, mw, x, dw, db, M, N, K, apply_relu, chunks, m_chunk, vec_g, vec_k, smem,
            (int)blockIdx.x - dx_blocks);
}

template <int BM>
cudaError_t launch(const float* g, const uint8_t* mask, const float* x, const float* w,
                   float* dx, float* dw, float* db, int M, int N, int K, int apply_relu,
                   int chunks, int chunk_len, int m_chunk, cudaStream_t stream) {
  const int dx_blocks = ((M + BM - 1) / BM) * ((K + DX_COLS - 1) / DX_COLS) * chunks;
  const int dw_tiles = ((N + DW_TILE - 1) / DW_TILE) * (K > 0 ? (K + DW_TILE - 1) / DW_TILE : 1);
  const int dw_blocks = m_chunk ? dw_tiles * chunks : ((dw_tiles + chunks - 1) / chunks) * chunks;
  const int vec_g = N % 4 == 0 && aligned16(g);
  const int vec_k = K % 4 == 0 && aligned16(w) && aligned16(x);
  return launch_clustered(linear_act_bwd_kernel<BM>, dim3(dx_blocks + dw_blocks, 1, 1), chunks,
                          stream, g, mask, x, w, dx, dw, db, M, N, K, apply_relu, chunks,
                          chunk_len, m_chunk, dx_blocks, vec_g, vec_k);
}

// ---------------------------------------------------------------------------
// The wide family (cuda_ops.bwd_is_wide: M >= 128, N, K >= 512 and N * K
// >= 768 * 512): one 128 x 128 output tile a block of 256 threads, 8 x 8
// outputs a thread.
// ---------------------------------------------------------------------------

constexpr int WIDE = 128;              // output tile edge of both roles
constexpr int WIDE_THREADS = 256;      // 16 x 16 threads
constexpr int WIDE_BLOCKS_PER_SM = 1;  // up to 255 registers a thread
constexpr int WIDE_STAGES = 4;         // slots of its cp.async ring
constexpr int WIDE_HALF = WIDE / 2;
constexpr int WIDE_PANEL = BK * WIDE;  // a stage-major panel, BK x WIDE floats
// the mask words of a stage, a row's bytes and one word more (MaskStager)
constexpr int WDX_MWORDS = BK / 4 + 1;  // dx: a row holds BK bytes
constexpr int WDW_MWORDS = WIDE / 4 + 1;  // dW: a row holds WIDE bytes
// the dx role's ring slot: g (WIDE rows x LD, reduction-contiguous), a W
// panel, the mask words; after the ring, two panels of ge moved to n-major
// order. The dW role's slot: a g panel, an x panel, the mask words.
constexpr int WDX_A = WIDE * LD;
constexpr int WDX_STAGE = WDX_A + WIDE_PANEL + WIDE * WDX_MWORDS;
constexpr int WDX_FLOATS = WIDE_STAGES * WDX_STAGE + 2 * WIDE_PANEL;
constexpr int WDW_STAGE = 2 * WIDE_PANEL + BK * WDW_MWORDS;
constexpr int WDW_FLOATS = WIDE_STAGES * WDW_STAGE;
constexpr int WIDE_SMEM = 4 * (WDX_FLOATS > WDW_FLOATS ? WDX_FLOATS : WDW_FLOATS);  // bytes
static_assert(WDX_A % 4 == 0 && WDX_STAGE % 4 == 0 && WDW_STAGE % 4 == 0,
              "every part of a slot 16-byte aligned");
static_assert(WIDE * WIDE <= WIDE_STAGES * WDX_STAGE, "the dx partial tile fits the ring");
static_assert(WIDE_BLOCKS_PER_SM * (WIDE_SMEM + 1024) <= 228 * 1024, "the blocks fit an SM");

// Offset in the tile of a thread's row (or column) i of 8: the thread at
// (ty, tx) holds rows 4 * ty + i and WIDE_HALF + 4 * ty + i, i < 4, and
// the same columns of tx, so its fragments are two float4 of each panel
// row and a warp's reads of a panel row are 256 contiguous bytes.
__device__ __forceinline__ int wide_off(int t, int i) {
  return (i < 4 ? 0 : WIDE_HALF) + 4 * t + (i & 3);
}

// One thread's share of staging a ROWS x COLS block of a row-major (rows x
// cols) matrix into dst[r * LDD + c], stage after stage, the block moving
// STEP_R rows and STEP_C columns a stage; zeros outside the matrix. VEC
// (cols % 4 == 0, the matrix 16-byte aligned): 16-byte copies, copy i of
// row tid / (COLS / 4) + i * (WIDE_THREADS / (COLS / 4)) of the block at
// column 4 * (tid % (COLS / 4)); else 4-byte copies, copy i of element
// tid + i * WIDE_THREADS. It keeps copy 0's source, row and column from
// stage to stage.
template <bool VEC, int ROWS, int COLS, int LDD, int STEP_R, int STEP_C>
struct Stager {
  static constexpr int W = VEC ? 4 : 1;            // floats a copy
  static constexpr int Q = COLS / W;               // copies a row
  static constexpr int RSTEP = WIDE_THREADS / Q;   // rows between a thread's copies
  static constexpr int COPIES = ROWS / RSTEP;
  static_assert(WIDE_THREADS % Q == 0 && ROWS % RSTEP == 0, "whole copies per thread");
  const float* at;  // copy 0's source at the next stage
  int row, col;     // copy 0's row and column at the next stage
  int dst;

  __device__ __forceinline__ Stager(const float* m, int row0, int cols, int c0, int tid)
      : row(row0 + tid / Q), col(c0 + W * (tid % Q)), dst((tid / Q) * LDD + W * (tid % Q)) {
    at = m + (size_t)row * cols + col;
  }

  // Stage the next stage into `slot`.
  __device__ __forceinline__ void issue(float* slot, const float* m, int rows, int cols) {
    const bool col_ok = col < cols;
#pragma unroll
    for (int i = 0; i < COPIES; ++i) {
      const bool ok = col_ok && row + i * RSTEP < rows;
      const float* p = ok ? at + (size_t)(i * RSTEP) * cols : m;
      if (VEC)
        cp_async16(slot + dst + i * RSTEP * LDD, p, ok ? 16 : 0);
      else
        cp_async4(slot + dst + i * RSTEP * LDD, p, ok ? 4 : 0);
    }
    at += (size_t)STEP_R * cols + STEP_C;
    row += STEP_R;
    col += STEP_C;
  }
};

// One thread's share of staging the mask bytes of a stage of ROWS rows x
// ROW_BYTES columns, stage after stage, the stage moving STEP_R rows and
// STEP_C columns (STEP_R * N + STEP_C a multiple of 16). VEC (N % 16 ==
// 0, the mask 16-byte aligned): 16-byte copies, a row's bytes at words
// [r * STRIDE, ...), each copy wholly inside or wholly past the row's N
// columns, and zeros past them. Else as stage_mask stages them: the
// aligned words holding a row's bytes and one more, the first byte at
// shift() in the first, none past the tensor's end. Rows past `rows` are
// zeros. No copy reads outside the tensor.
template <bool VEC, int ROWS, int ROW_BYTES, int STEP_R, int STEP_C>
struct MaskStager {
  static constexpr int PARTS = ROW_BYTES / 16;  // 16-byte copies a row
  static constexpr int WORDS = ROW_BYTES / 4 + 1;
  static constexpr int STRIDE = VEC ? ROW_BYTES / 4 : WORDS;  // words between rows in a slot
  static constexpr int PIECES = VEC ? ROWS * PARTS : ROWS * WORDS;
  static constexpr int COPIES = (PIECES + WIDE_THREADS - 1) / WIDE_THREADS;
  long long word[COPIES];  // copy i's byte offset from mw.mbase at the next stage
  int row[COPIES];         // its mask row at the next stage
  int col[COPIES];         // VEC: its first column at the next stage

  __device__ __forceinline__ MaskStager(const MaskWords& mw, int row0, int N, int c0, int tid) {
#pragma unroll
    for (int i = 0; i < COPIES; ++i) {
      const int e = tid + i * WIDE_THREADS;
      if (VEC) {
        row[i] = row0 + e / PARTS;
        col[i] = c0 + 16 * (e % PARTS);
        word[i] = mw.moff + (long long)row[i] * N + col[i];
      } else {
        row[i] = row0 + e / WORDS;
        word[i] = ((mw.moff + (long long)row[i] * N + c0) & ~3LL) + 4 * (e % WORDS);
      }
    }
  }

  // Stage the next stage's bytes into `dst`.
  __device__ __forceinline__ void issue(uint32_t* dst, const MaskWords& mw, int rows, int N,
                                        int tid) {
#pragma unroll
    for (int i = 0; i < COPIES; ++i) {
      const int e = tid + i * WIDE_THREADS;
      if (PIECES % WIDE_THREADS && e >= PIECES) break;
      if (VEC) {
        const bool ok = row[i] < rows && col[i] < N;
        cp_async16(dst + (e / PARTS) * STRIDE + 4 * (e % PARTS),
                   ok ? mw.mbase + word[i] : mw.mbase, ok ? 16 : 0);
        col[i] += STEP_C;
      } else {
        long long bytes = row[i] < rows ? mw.end - word[i] : 0;
        bytes = bytes < 0 ? 0 : (bytes > 4 ? 4 : bytes);
        cp_async4(dst + e, bytes ? mw.mbase + word[i] : mw.mbase, (int)bytes);
      }
      word[i] += (long long)STEP_R * N + STEP_C;
      row[i] += STEP_R;
    }
  }

  // Where the first byte of a stage's row of mask row `r` (N columns)
  // sits in its first word, in bits.
  __device__ __forceinline__ static int shift(const MaskWords& mw, int r, int N) {
    return VEC ? 0 : 8 * mask_shift(mw, r, N);
  }
};

// The ring of one role over `n_stages` stages of BK: issue(s) stages s (an
// empty commit past the end), in turn for s = 0, 1, 2, ...; prep(s) forms
// ge of stage s once it has landed, one stage ahead of compute(s), so that
// one barrier a stage separates every write of a slot from its reads.
// Stage s + 3 refills the slot of stage s - 1, read by compute(s - 1)
// before the barrier.
template <class Issue, class Prep, class Compute>
__device__ __forceinline__ void wide_ring(int n_stages, Issue issue, Prep prep, Compute compute) {
#pragma unroll
  for (int s = 0; s < WIDE_STAGES - 1; ++s) issue(s);
  cp_async_wait<WIDE_STAGES - 2>();
  __syncthreads();
  prep(0);
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<WIDE_STAGES - 3>();  // stage s + 1 has landed
    __syncthreads();
    if (s + 1 < n_stages) prep(s + 1);
    issue(s + WIDE_STAGES - 1);
    compute(s);
  }
  cp_async_wait<0>();
}

// acc[i][j] = fmaf(A[t][row i], B[t][column j], acc[i][j]) for the BK steps
// t of one stage, in order, from two panels of BK x WIDE floats: each
// step two float4 of each panel, 16 FFMA a 16-byte shared load.
__device__ __forceinline__ void wide_steps(float (&acc)[8][8], const float* A, const float* B,
                                           int ty, int tx) {
#pragma unroll
  for (int t = 0; t < BK; ++t) {
    const float4 a0 = *reinterpret_cast<const float4*>(A + t * WIDE + 4 * ty);
    const float4 a1 = *reinterpret_cast<const float4*>(A + t * WIDE + WIDE_HALF + 4 * ty);
    const float4 b0 = *reinterpret_cast<const float4*>(B + t * WIDE + 4 * tx);
    const float4 b1 = *reinterpret_cast<const float4*>(B + t * WIDE + WIDE_HALF + 4 * tx);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// A thread's 8 x 8 outputs to `out` (rows x cols, row-major) for the tile
// at (r0, c0). `vec`: cols % 4 == 0 and out 16-byte aligned.
__device__ __forceinline__ void wide_store(float* __restrict__ out, const float (&acc)[8][8],
                                           int r0, int c0, int rows, int cols, int vec, int ty,
                                           int tx) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = r0 + wide_off(ty, i);
    if (r >= rows) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + wide_off(tx, 4 * h);
      float* p = out + (size_t)r * cols + c;
      if (vec && c < cols) {
        *reinterpret_cast<float4*>(p) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < cols) p[j] = acc[i][4 * h + j];
      }
    }
  }
}

// part[o .. o + 3] of every rank of the cluster, added in rank order as
// ordered_sum adds one float: ((p_0 + p_1) + p_2) + ...
__device__ __forceinline__ float4 ordered_sum4(cg::cluster_group cluster, float* part, int o,
                                               int chunks) {
  float4 p[MAX_CLUSTER];
#pragma unroll
  for (int q = 0; q < MAX_CLUSTER; ++q)
    p[q] = q < chunks ? *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, q) + o)
                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4 z = p[0];
#pragma unroll
  for (int q = 1; q < MAX_CLUSTER; ++q) {
    if (q < chunks) {
      z.x = __fadd_rn(z.x, p[q].x);
      z.y = __fadd_rn(z.y, p[q].y);
      z.z = __fadd_rn(z.z, p[q].z);
      z.w = __fadd_rn(z.w, p[q].w);
    }
  }
  return z;
}

// dx[m][k] = sum_n ge[m][n] * w[n][k] for one 128 x 128 tile and this
// rank's chunk of N; the cluster then adds the chunks in rank order.
template <bool VEC>
__device__ __forceinline__ void wide_dx_role(const float* __restrict__ g, const MaskWords& mw,
                                             const float* __restrict__ w, float* __restrict__ dx,
                                             int M, int N, int K, int apply_relu, int chunks,
                                             int chunk_len, float* smem) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tile = (int)blockIdx.x / chunks;
  const int k_tiles = (K + WIDE - 1) / WIDE;
  const int m0 = (tile / k_tiles) * WIDE;
  const int k0 = (tile % k_tiles) * WIDE;
  const int n_lo = rank * chunk_len;
  const int n_stages = (min(N, n_lo + chunk_len) - n_lo + BK - 1) / BK;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  float* ge = smem + WIDE_STAGES * WDX_STAGE;  // two BK x WIDE panels, ge[n][m]
  auto slot = [&](int s) { return smem + (s % WIDE_STAGES) * WDX_STAGE; };
  Stager<VEC, WIDE, BK, LD, 0, BK> g_tile(g, m0, N, n_lo, tid);
  Stager<VEC, BK, WIDE, WIDE, BK, 0> w_panel(w, n_lo, K, k0, tid);
  using Mask = MaskStager<VEC, WIDE, BK, 0, BK>;
  Mask mask_bytes(mw, m0, N, n_lo, tid);

  auto issue = [&](int s) {
    if (s < n_stages) {
      float* sl = slot(s);
      g_tile.issue(sl, g, M, N);
      w_panel.issue(sl + WDX_A, w, N, K);
      if (apply_relu)
        mask_bytes.issue(reinterpret_cast<uint32_t*>(sl + WDX_A + WIDE_PANEL), mw, M, N, tid);
    }
    cp_async_commit();
  };
  // ge = g * mask (g without the relu) of stage s, once per element, moved
  // to n-major order: a lane a row of m, so reads and writes are
  // conflict-free
  const int m = tid % WIDE;
  const int shift = Mask::shift(mw, m0 + m, N);
  auto prep = [&](int s) {
    const float* sl = slot(s);
    const uint32_t* wd =
        reinterpret_cast<const uint32_t*>(sl + WDX_A + WIDE_PANEL) + m * Mask::STRIDE;
    float* t = ge + (s & 1) * WIDE_PANEL;
#pragma unroll
    for (int i = 0; i < WIDE * BK / (4 * WIDE_THREADS); ++i) {
      const int q = tid / WIDE + 2 * i;
      float4 a = *reinterpret_cast<const float4*>(sl + m * LD + 4 * q);
      if (apply_relu) a = masked(a, __funnelshift_r(wd[q], wd[q + 1], shift));
      t[(4 * q) * WIDE + m] = a.x;
      t[(4 * q + 1) * WIDE + m] = a.y;
      t[(4 * q + 2) * WIDE + m] = a.z;
      t[(4 * q + 3) * WIDE + m] = a.w;
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  wide_ring(n_stages, issue, prep, [&](int s) {
    wide_steps(acc, ge + (s & 1) * WIDE_PANEL, slot(s) + WDX_A, ty, tx);
  });

  if (chunks == 1) {  // the sum is this block's partial: store it from registers
    wide_store(dx, acc, m0, k0, M, K, VEC, ty, tx);
    return;
  }
  __syncthreads();  // the ring becomes the partial tile
  float* part = smem;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float4*>(part + wide_off(ty, i) * WIDE + wide_off(tx, 4 * h)) =
          make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
  cluster.sync();

  // rank r finishes every chunks-th group of WIDE_THREADS float4, from its own
  for (int f = rank * WIDE_THREADS + tid; f < WIDE * WIDE / 4; f += chunks * WIDE_THREADS) {
    const int r = f / (WIDE / 4);
    const int c = 4 * (f % (WIDE / 4));
    if (m0 + r >= M) break;
    const float4 z = ordered_sum4(cluster, part, r * WIDE + c, chunks);
    const int gk = k0 + c;
    float* p = dx + (size_t)(m0 + r) * K + gk;
    if (VEC && gk < K) {
      *reinterpret_cast<float4*>(p) = z;
    } else {
      if (gk < K) p[0] = z.x;
      if (gk + 1 < K) p[1] = z.y;
      if (gk + 2 < K) p[2] = z.z;
      if (gk + 3 < K) p[3] = z.w;
    }
  }
  cluster.sync();  // no block leaves while another still reads its tile
}

// dW[n][k] = sum_m ge[m][n] * x[m][k] for one 128 x 128 tile over all of M;
// the tiles of the first K-tile also write db[n] = sum_m ge[m][n].
template <bool VEC>
__device__ __forceinline__ void wide_dw_role(const float* __restrict__ g, const MaskWords& mw,
                                             const float* __restrict__ x, float* __restrict__ dw,
                                             float* __restrict__ db, int M, int N, int K,
                                             int apply_relu, float* smem, int tile) {
  const int k_tiles = (K + WIDE - 1) / WIDE;
  if (tile >= ((N + WIDE - 1) / WIDE) * k_tiles) return;  // a spare rank
  const int n0 = (tile / k_tiles) * WIDE;
  const int k0 = (tile % k_tiles) * WIDE;
  const bool with_db = tile % k_tiles == 0;
  const int m_stages = (M + BK - 1) / BK;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  auto slot = [&](int s) { return smem + (s % WIDE_STAGES) * WDW_STAGE; };
  Stager<VEC, BK, WIDE, WIDE, BK, 0> g_panel(g, 0, N, n0, tid);
  Stager<VEC, BK, WIDE, WIDE, BK, 0> x_panel(x, 0, K, k0, tid);
  using Mask = MaskStager<VEC, BK, WIDE, BK, 0>;
  Mask mask_bytes(mw, 0, N, n0, tid);

  auto issue = [&](int s) {
    if (s < m_stages) {
      float* sl = slot(s);
      g_panel.issue(sl, g, M, N);
      x_panel.issue(sl + WIDE_PANEL, x, M, K);
      if (apply_relu)
        mask_bytes.issue(reinterpret_cast<uint32_t*>(sl + 2 * WIDE_PANEL), mw, M, N, tid);
    }
    cp_async_commit();
  };
  // ge = g * mask in place, once per element: the thread's quad q of rows
  // r and r + BK / 2, whose bytes sit at the same place in their words
  const int q = tid % (WIDE / 4);
  const int r = tid / (WIDE / 4);
  const int shift = Mask::shift(mw, r, N);
  auto prep = [&](int s) {
    if (apply_relu) {
      float* sl = slot(s);
      const uint32_t* words = reinterpret_cast<const uint32_t*>(sl + 2 * WIDE_PANEL);
#pragma unroll
      for (int i = 0; i < WIDE * BK / (4 * WIDE_THREADS); ++i) {
        const int row = r + i * (WIDE_THREADS / (WIDE / 4));
        const uint32_t* wd = words + row * Mask::STRIDE;
        float4* p = reinterpret_cast<float4*>(sl + row * WIDE + 4 * q);
        *p = masked(*p, __funnelshift_r(wd[q], wd[q + 1], shift));
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  float db_acc = 0.0f;
  wide_ring(m_stages, issue, prep, [&](int s) {
    const float* sl = slot(s);
    wide_steps(acc, sl, sl + WIDE_PANEL, ty, tx);
    if (with_db && tid < WIDE) {
      // thread tid owns db[n0 + tid]; rows past M hold zeros
#pragma unroll
      for (int t = 0; t < BK; ++t) db_acc = __fadd_rn(db_acc, sl[t * WIDE + tid]);
    }
  });

  wide_store(dw, acc, n0, k0, N, K, VEC, ty, tx);
  if (with_db && tid < WIDE && n0 + tid < N) db[n0 + tid] = db_acc;
}

// Blocks [0, dx_blocks) are the dx role, in clusters of `chunks` (one per
// chunk of N); the blocks after them the dW role, one tile each, padded to
// whole clusters. The dx blocks, each `chunk_len` deep, go first. VEC: N %
// 16 == 0, K % 4 == 0 and every tensor 16-byte aligned, so that every copy
// and store moves 16 bytes.
template <bool VEC>
__global__ void __launch_bounds__(WIDE_THREADS, WIDE_BLOCKS_PER_SM)
linear_act_bwd_kernel_wide(const float* __restrict__ g, const uint8_t* mask,
                           const float* __restrict__ x, const float* __restrict__ w,
                           float* __restrict__ dx, float* __restrict__ dw, float* __restrict__ db,
                           int M, int N, int K, int apply_relu, int chunks, int chunk_len,
                           int dx_blocks) {
  extern __shared__ __align__(16) float wide_smem[];
  const uintptr_t addr = reinterpret_cast<uintptr_t>(mask);
  const MaskWords mw{mask - (addr & 3), (long long)(addr & 3),
                     (long long)(addr & 3) + (long long)M * N};
  if ((int)blockIdx.x < dx_blocks)
    wide_dx_role<VEC>(g, mw, w, dx, M, N, K, apply_relu, chunks, chunk_len, wide_smem);
  else
    wide_dw_role<VEC>(g, mw, x, dw, db, M, N, K, apply_relu, wide_smem,
                      (int)blockIdx.x - dx_blocks);
}

template <bool VEC>
cudaError_t launch_wide(const float* g, const uint8_t* mask, const float* x, const float* w,
                        float* dx, float* dw, float* db, int M, int N, int K, int apply_relu,
                        int chunks, int chunk_len, cudaStream_t stream) {
  // the dynamic shared memory above 48 KB, allowed once on each device (as
  // fused_train.cu's resident_clusters sets its kernel up)
  static bool allowed[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!allowed[dev]) {
    err = cudaFuncSetAttribute(linear_act_bwd_kernel_wide<VEC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, WIDE_SMEM);
    if (err != cudaSuccess) return err;
    allowed[dev] = true;
  }
  const int k_tiles = (K + WIDE - 1) / WIDE;
  const int dx_blocks = ((M + WIDE - 1) / WIDE) * k_tiles * chunks;
  const int dw_tiles = ((N + WIDE - 1) / WIDE) * k_tiles;
  const int dw_blocks = ((dw_tiles + chunks - 1) / chunks) * chunks;
  return launch_clustered_with(linear_act_bwd_kernel_wide<VEC>, dim3(dx_blocks + dw_blocks, 1, 1),
                               WIDE_THREADS, chunks, (size_t)WIDE_SMEM, stream, g, mask, x, w, dx,
                               dw, db, M, N, K, apply_relu, chunks, chunk_len, dx_blocks);
}

}  // namespace

// Plain C entry point, bound with ctypes. Pointers are device pointers of
// contiguous fp32 tensors (mask: one byte per element, torch.bool, read
// only when apply_relu; any valid device pointer otherwise); `stream` is
// the caller's cudaStream_t. The launch plan (row_tile, col_tile, chunks,
// chunk_len, dw_chunk_len) is cuda_ops.bwd_plan's: dx's row tile below x 64
// columns, `chunks` chunks of `chunk_len` terms covering N, one per rank of
// a cluster of `chunks` blocks; dW's 64 x 64 tiles either whole (dw_chunk_len
// 0) or with M in `chunks` chunks of dw_chunk_len rows over a cluster. Or
// the wide family, row_tile = col_tile = 128: 128 x 128 tiles of both
// products, N in `chunks` chunks for dx, dW whole (dw_chunk_len 0). One
// launch computes dx, dW and db. Returns its error (0 = launched);
// cudaErrorInvalidValue for a plan outside that set.
extern "C" int linear_act_bwd(const float* g, const uint8_t* mask, const float* x,
                              const float* w, float* dx, float* dw, float* db, int M, int N,
                              int K, int apply_relu, int row_tile, int col_tile, int chunks,
                              int chunk_len, int dw_chunk_len, void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  if (!chunks_cover(N, chunks, chunk_len)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (row_tile == WIDE && col_tile == WIDE) {  // the wide family: dW never splits M
    if (dw_chunk_len || K <= 0) return (int)cudaErrorInvalidValue;
    const bool vec = N % 16 == 0 && K % 4 == 0 && aligned16(g) && aligned16(mask) &&
                     aligned16(x) && aligned16(w) && aligned16(dx) && aligned16(dw);
    return (int)(vec ? launch_wide<true> : launch_wide<false>)(
        g, mask, x, w, dx, dw, db, M, N, K, apply_relu, chunks, chunk_len, s);
  }
  if (col_tile != DX_COLS) return (int)cudaErrorInvalidValue;
  if (dw_chunk_len && (dw_chunk_len < 0 || dw_chunk_len % BK ||
                       (long long)chunks * dw_chunk_len < M))
    return (int)cudaErrorInvalidValue;
  if (row_tile == 8)
    return (int)launch<8>(g, mask, x, w, dx, dw, db, M, N, K, apply_relu, chunks, chunk_len,
                          dw_chunk_len, s);
  if (row_tile == 16)
    return (int)launch<16>(g, mask, x, w, dx, dw, db, M, N, K, apply_relu, chunks, chunk_len,
                           dw_chunk_len, s);
  if (row_tile == 32)
    return (int)launch<32>(g, mask, x, w, dx, dw, db, M, N, K, apply_relu, chunks, chunk_len,
                           dw_chunk_len, s);
  if (row_tile == 64)
    return (int)launch<64>(g, mask, x, w, dx, dw, db, M, N, K, apply_relu, chunks, chunk_len,
                           dw_chunk_len, s);
  return (int)cudaErrorInvalidValue;
}
