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
// The order rule (determinism): dx[m][k] = ((p_0 + p_1) + ...) + p_{c-1},
// p_r an fmaf chain over n in chunk r from 0.0f; dW[n][k] and db[n] the
// same over the chunks of M (one chunk when M is not split), db's chain an
// __fadd_rn chain. Each in one thread, in an order fixed by the shapes, with
// no atomics: two launches give the same bits. The backward has no
// row-independence rule: its chunking of M may depend on N and K.

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
    float4 a = *p;
    a.x *= (v & 0xffu) ? 1.0f : 0.0f;
    a.y *= (v & 0xff00u) ? 1.0f : 0.0f;
    a.z *= (v & 0xff0000u) ? 1.0f : 0.0f;
    a.w *= (v & 0xff000000u) ? 1.0f : 0.0f;
    *p = a;
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

}  // namespace

// Plain C entry point, bound with ctypes. Pointers are device pointers of
// contiguous fp32 tensors (mask: one byte per element, torch.bool, read
// only when apply_relu; any valid device pointer otherwise); `stream` is
// the caller's cudaStream_t. The launch plan (row_tile, col_tile, chunks,
// chunk_len, dw_chunk_len) is cuda_ops.bwd_plan's: dx's row tile below x 64
// columns, `chunks` chunks of `chunk_len` terms covering N, one per rank of
// a cluster of `chunks` blocks; dW's 64 x 64 tiles either whole (dw_chunk_len
// 0) or with M in `chunks` chunks of dw_chunk_len rows over a cluster. One
// launch computes dx, dW and db. Returns its error (0 = launched);
// cudaErrorInvalidValue for a plan outside that set.
extern "C" int linear_act_bwd(const float* g, const uint8_t* mask, const float* x,
                              const float* w, float* dx, float* dw, float* db, int M, int N,
                              int K, int apply_relu, int row_tile, int col_tile, int chunks,
                              int chunk_len, int dw_chunk_len, void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  if (col_tile != DX_COLS || !chunks_cover(N, chunks, chunk_len)) return (int)cudaErrorInvalidValue;
  if (dw_chunk_len && (dw_chunk_len < 0 || dw_chunk_len % BK ||
                       (long long)chunks * dw_chunk_len < M))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
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
