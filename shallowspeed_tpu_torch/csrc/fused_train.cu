// fused_train: a whole training batch, epoch or run of a relu MLP in one launch.
//
// Replaces the TPU kernel of shallowspeed_tpu/pallas_ops.py:631-878
// (fused_train_call -> _train_kernel_body, with _batch_grads :475 and the
// SGD / momentum / Adam update math :560-624), in its three modes:
//   step  (B9):  one batch;
//   epoch (B10): every batch of an epoch, params and state resident;
//   run   (B11): n_epochs x nb batches, with one mean loss per epoch.
// A step is an epoch of one batch, and an epoch a run of one epoch, so one
// code path serves all three: loss[e] = (0 + l_0 + ... + l_{nb-1}) / nb, the
// zero/sum/divide order of the TPU kernel (and of the port's epoch loop).
//
// What bounds it on an H100: a flagship step (B = 128) is ~112.8 MFLOP of
// products against ~1.9 MB moved (SGD; ~4.8 MB with Adam's two mirrors), so
// its bound is operations, ~0.0017 ms at 67 TFLOP/s fp32. What holds it
// back is latency: the math is a chain of small dependent products. So the
// design cuts the chain's grid-wide barriers from 2L + 2 a batch to 2.
//
// Per batch, two passes:
//   1. the group pass, on thread block clusters of `cluster` blocks. A work
//      item is `item_rows` rows of whole head groups (cuda_ops.fused_plan),
//      owned by one cluster; the forward is row-local and the head mixes
//      rows only within a group, so nothing outside the cluster is needed:
//        forward, one cluster phase per layer: A_{l+1} = act(A_l W_l^T + b_l),
//          the blocks of the cluster splitting its columns (16-column tiles,
//          tile u of the item to rank u % cluster);
//        head: the stability max over each whole group, then one warp per
//          row: p = e / (rowsum(e) + 1e-7), the row's share of
//          sum((y - p)^2), G_{L-1} = softmax VJP of -2 (y - p) / batch_size;
//        dX chain, one cluster phase per layer L-1 ... 1 (from the PRE-update
//          weights): G_{l-1} = (G_l W_l) * mask_{l-1}, the mask read back as
//          A_l > 0 (relu keeps NaN, so A_l > 0 is exactly z > 0).
//      The cluster phases meet at barrier.cluster (cluster.sync()); every
//      A_l and G_l goes through the workspace (L2-resident), read back with
//      L2-only loads (cp.async.cg / ld.global.cg), and each phase's first
//      weights are staged before the barrier that precedes it.
//   grid.sync()
//   2. the weight-gradient pass, over every block: dW_l = G_l^T A_l and
//      db_l = colsum(G_l) in 32 x 64 tiles, 8 outputs a thread, each summed
//      by that one thread over the batch's rows in order. Without a clip the
//      thread applies the optimizer to its elements at once (nothing in this
//      pass reads the params); with a clip the tile leaves its sum of
//      squares, and after grid.sync() every block computes the clip factor
//      and updates the params grid-strided.
//   grid.sync()   (the next batch reads the updated params)
// Barriers a batch: 2 grid-wide, 3 with a clip, and 2L - 1 cluster
// barriers inside each cluster.
//
// The products: one 32 x 16 output tile a block at a time, each lane a 4 x 4
// block of it; the reduction (K) cut into chunks of at most KC terms staged into
// shared memory with cp.async (staging.cuh), each chunk cut into 8 equal
// warp ranges. Warp w's partial sums its ranges of every chunk in order
// (fmaf chains), and the 8 partials are added in warp order. So the 784-deep
// first layer is eight 100-term chains, not one thread's 784-term walk.
//
// Determinism: every output element is summed in one fixed order that is a
// function of the shapes alone (the chunks and warp ranges depend on K
// only; dW, db and the head's row sums run over their index in order), and
// every sum across threads or blocks (the warp partials, the loss over
// rows, each tile's and each leaf's sum of squares, the epoch's loss) is
// taken in a fixed order that does not depend on the grid size or on which
// cluster takes an item. No float atomics, so two launches give the same
// bits, an epoch equals a loop of steps and a run a loop of epochs.
//
// Rounding: the head, the loss, the clip and the update are written with
// __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn / __fsqrt_rn, which the
// compiler never contracts into an FMA: each op rounds once, as the
// reference's expressions do (expf, IEEE division and sqrt; no fast math).
// Adam's step count t is float32 and c = 1 - powf(beta, t) is float32.
//
// Operands: the layer widths, the params' and optimizer mirrors' pointers
// and the workspace offsets come in a table of int64 built by
// cuda_ops._fused_train_table (its field names are the enums below), and
// the float hyperparameters in struct Hyper. Both go by value, as kernel
// parameters (struct Table holds MAX_LAYERS layers, 3.2 KB; the whole
// parameter list stays under the classic 4 KB limit), copied from host
// arrays at the launch: no copy to the device, nothing cached between
// launches, and a CUDA graph captures the values. Params, mirrors and t are
// updated in place.
//
// Built with -DFUSED_TRAIN_PHASE_STAMPS (scripts/torch_training_profile.py
// only), block 0 also stamps the device clock at each pass boundary and at
// each phase of its group pass, for the first MAX_STAMPED batches, read back
// with fused_train_stamps().

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "staging.cuh"

namespace cg = cooperative_groups;

namespace {

using staging::cp_async16;
using staging::cp_async4;

constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int ROW_TILE = 32;  // rows of a group-pass output tile
constexpr int COL_TILE = 16;  // columns of a group-pass output tile
constexpr int KC = 800;       // the longest reduction chunk staged at once
constexpr int LDK = KC + 4;   // row stride of a reduction-contiguous tile
constexpr int DW_N = 32;      // dW tile: rows (N) ...
constexpr int DW_K = 64;      // ... and columns (K)
constexpr int MC = 128;       // batch rows of one dW stage
constexpr int MAX_CLUSTER = 8;  // the portable cluster size
constexpr int TILE = ROW_TILE * COL_TILE;
using staging::MAX_DEVICES;
// dynamic shared memory: a group-pass tile's A (ROW_TILE x LDK) and B
// (COL_TILE x LDK, or KC x COL_TILE); the warp partials and the dW stages
// reuse it
constexpr int SMEM_FLOATS = (ROW_TILE + COL_TILE) * LDK;
constexpr int SMEM_BYTES = SMEM_FLOATS * 4;
static_assert(WARPS * ROW_TILE * COL_TILE <= ROW_TILE * LDK, "partials fit in A");
static_assert(LDK % 32 == 4, "conflict-free float4 rows (tile_product)");
static_assert(KC * COL_TILE <= COL_TILE * LDK, "a column panel fits in B");
static_assert(MC * (DW_N + DW_K) <= SMEM_FLOATS, "a dW stage fits");
static_assert(KC % (4 * WARPS) == 0, "warp ranges of whole float4s");

// the table: a header, then one record per layer (cuda_ops.TABLE_HEADER,
// cuda_ops.TABLE_LAYER; tests/test_torch_fused_train.py holds them equal)
constexpr int HEADER_LEN = 16;
enum Header { H_L, H_OPT, H_ROWS, H_GROUP_ROWS, H_N_GROUPS, H_ROW_LOSS, H_T,
              H_HAS_CLIP, H_HAS_DECAY };
constexpr int LAYER_LEN = 16;
enum Layer { R_K, R_N, R_RELU, R_W, R_B, R_S1W, R_S1B, R_S2W, R_S2B, R_ACT_IN,
             R_ACT_OUT, R_G, R_DW, R_DB, R_SQW, R_SQB };
enum Opt { OPT_SGD, OPT_MOMENTUM, OPT_ADAM };
constexpr int MAX_LAYERS = 24;  // deeper models are refused
struct Table { long long v[HEADER_LEN + MAX_LAYERS * LAYER_LEN]; };

// cuda_ops.HYPER, in order
struct Hyper { float lr, decay, mu, b1, b2, omb1, omb2, eps, clip, batch_size; };

#ifdef FUSED_TRAIN_PHASE_STAMPS
constexpr int MAX_STAMPED = 64;  // batches
// per batch: its start, at the first grid barrier, past it, at the last,
// past it; then block 0's group pass, phase by phase: the start and the end
// of each forward layer, of the head, of each dX layer (4L stamps)
constexpr int STAMPS = 5 + 4 * MAX_LAYERS;
__device__ unsigned long long g_stamps[MAX_STAMPED * STAMPS];
__device__ __forceinline__ void stamp(int batch, int i) {
  if (blockIdx.x == 0 && threadIdx.x == 0 && batch < MAX_STAMPED) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_stamps[batch * STAMPS + i] = t;
  }
}
#else
__device__ __forceinline__ void stamp(int, int) {}
#endif

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// the dW tiles of a layer: cuda_ops.fused_plan's dw_tiles (at least one
// K-tile, so that db is computed)
__host__ __device__ __forceinline__ int dw_tiles_n(int N) { return cdiv(N, DW_N); }
__host__ __device__ __forceinline__ int dw_tiles_k(int K) {
  return K > 0 ? cdiv(K, DW_K) : 1;
}

// A reduction of K terms: chunks of chunk_len(K) terms, each cut into WARPS
// ranges of chunk_len(K) / WARPS (cuda_ops.reduction_split)
__device__ __forceinline__ int chunk_len(int K) {
  const int c = cdiv(K, 4 * WARPS) * 4 * WARPS;
  return c < KC ? c : KC;
}

__device__ __forceinline__ float* fptr(long long v) {
  return reinterpret_cast<float*>(v);
}

// max(z, 0) keeping NaN, as torch.relu and jnp.maximum do
__device__ __forceinline__ float relu(float z) {
  return (z > 0.0f || z != z) ? z : 0.0f;
}

// max that propagates NaN, as torch.amax and jnp.max do
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// The reference's relu VJP is a multiply by the float mask (NaN * 0 = NaN).
__device__ __forceinline__ float masked(float g, float act) {
  return __fmul_rn(g, act > 0.0f ? 1.0f : 0.0f);
}

// Sum (or NaN-propagating max) of one value per thread over the block, in a
// fixed tree; every thread gets the result. `red` holds THREADS floats.
__device__ float block_sum(float v, float* red) {
  const int tid = threadIdx.x;
  red[tid] = v;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] = __fadd_rn(red[tid], red[tid + s]);
    __syncthreads();
  }
  const float out = red[0];
  __syncthreads();
  return out;
}

__device__ float block_max(float v, float* red) {
  const int tid = threadIdx.x;
  red[tid] = v;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] = max_nan(red[tid], red[tid + s]);
    __syncthreads();
  }
  const float out = red[0];
  __syncthreads();
  return out;
}

// Stage rows [0, nrows) x columns [0, ncols) of the row-major src (row
// stride ld) into dst[r * ldd + c] with cp.async, zeros where r >= rv or
// c >= cv. `vec`: 16-byte copies (ld, ncols and cv multiples of 4, src
// 16-byte aligned); else 4-byte copies. Each thread walks its pieces with
// one division, not one a piece.
__device__ __forceinline__ void stage(float* dst, int ldd, const float* src, long long ld,
                                      int nrows, int rv, int ncols, int cv, bool vec) {
  const int w = vec ? 4 : 1;
  const int per_row = ncols / w;
  int r = threadIdx.x / per_row, c = (threadIdx.x % per_row) * w;
  const int dr = THREADS / per_row, dc = (THREADS % per_row) * w;
  for (; r < nrows; r += dr) {
    const bool ok = r < rv && c < cv;
    const float* p = ok ? src + r * ld + c : src;
    if (vec)
      cp_async16(dst + r * ldd + c, p, ok ? 16 : 0);
    else
      cp_async4(dst + r * ldd + c, p, ok ? 4 : 0);
    c += dc;
    if (c >= ncols) {
      c -= ncols;
      ++r;
    }
  }
  staging::cp_async_commit();
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ float ldcg(const float* p) { return __ldcg(p); }

// Stage chunk k0 of a tile's B operand (B of tile_product below) into its slot of
// the shared memory `sm`.
template <bool PANEL>
__device__ __forceinline__ void stage_b(const float* w, long long ldw, int K, int c0, int cv,
                                        int k0, float* sm) {
  float* bs = sm + ROW_TILE * LDK;
  const int clen = chunk_len(K);
  if (PANEL) {
    const float* src = w + (long long)k0 * ldw + c0;
    stage(bs, COL_TILE, src, ldw, clen, K - k0, COL_TILE, cv - c0,
          ldw % 4 == 0 && c0 % 4 == 0 && aligned16(src));
  } else {
    const float* src = w + (long long)c0 * K + k0;
    stage(bs, LDK, src, K, COL_TILE, cv - c0, clen, K - k0, K % 4 == 0 && aligned16(src));
  }
}

// One ROW_TILE x COL_TILE tile of a group-pass product,
//   out(r, c) = sum_{k = 0..K-1} A(r, k) B(k, c),
// with A(r, k) = a[r * K + k] for r < rv (the batch's or workspace's rows),
// and B from the weight matrix w (N_w x K_w, row-major):
//   forward (PANEL false): B(k, c) = w[(c0 + c) * K + k], c0 + c < cv;
//   dX chain (PANEL true): B(k, c) = w[k * ldw + c0 + c], c0 + c < cv.
// Every thread gets out() of elements tid and tid + THREADS of the tile
// (row e / COL_TILE, column e % COL_TILE) in res[0..1].
// With `b_ready` the caller has already staged B's first chunk (stage_b,
// k0 = 0): the weights do not wait for the cluster barrier before it.
//
// Lanes: a lane holds rows rq + 8i and columns cq + 4j (forward) or 4 cq + j
// (dX), rq = lane % 8, cq = lane / 8: with LDK = 4 (mod 32) words the eight
// rows' and the four columns' float4 reads fall on distinct banks.
template <bool PANEL>
__device__ void tile_product(const float* a, int rv, int K, const float* w, long long ldw,
                             int c0, int cv, bool b_ready, float* sm, float res[2]) {
  float* as = sm;                   // [ROW_TILE][LDK]
  float* bs = sm + ROW_TILE * LDK;  // [COL_TILE][LDK], or [KC][COL_TILE] as a panel
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rq = lane % 8, cq = lane / 8;
  const int clen = chunk_len(K), wlen = clen / WARPS;
  const bool a_vec = K % 4 == 0 && aligned16(a);
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += clen) {
    stage(as, LDK, a + k0, K, ROW_TILE, rv, clen, K - k0, a_vec);
    if (!b_ready || k0 > 0) stage_b<PANEL>(w, ldw, K, c0, cv, k0, sm);
    staging::cp_async_wait<0>();
    __syncthreads();
    const int kb = warp * wlen, ke = kb + wlen;
    if (k0 + kb < K) {
#pragma unroll 2
      for (int k = kb; k < ke; k += 4) {
        float4 av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          av[i] = *reinterpret_cast<const float4*>(as + (rq + 8 * i) * LDK + k);
        if (PANEL) {
          // bv[t] = B(k + t, 4 cq .. 4 cq + 3)
#pragma unroll
          for (int t = 0; t < 4; ++t)
            bv[t] = *reinterpret_cast<const float4*>(bs + (k + t) * COL_TILE + 4 * cq);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float ak[4] = {av[i].x, av[i].y, av[i].z, av[i].w};
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              acc[i][0] = fmaf(ak[t], bv[t].x, acc[i][0]);
              acc[i][1] = fmaf(ak[t], bv[t].y, acc[i][1]);
              acc[i][2] = fmaf(ak[t], bv[t].z, acc[i][2]);
              acc[i][3] = fmaf(ak[t], bv[t].w, acc[i][3]);
            }
          }
        } else {
          // bv[j] = B(k .. k + 3, cq + 4 j)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            bv[j] = *reinterpret_cast<const float4*>(bs + (cq + 4 * j) * LDK + k);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              float s = acc[i][j];
              s = fmaf(av[i].x, bv[j].x, s);
              s = fmaf(av[i].y, bv[j].y, s);
              s = fmaf(av[i].z, bv[j].z, s);
              s = fmaf(av[i].w, bv[j].w, s);
              acc[i][j] = s;
            }
        }
      }
    }
    __syncthreads();
  }
  // the warp partials, added in warp order by the thread of each element
  float* part = sm;  // [WARPS][TILE], over A's tile
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      part[warp * TILE + (rq + 8 * i) * COL_TILE + (PANEL ? 4 * cq + j : cq + 4 * j)] =
          acc[i][j];
  __syncthreads();
  const int live = cdiv(K < clen ? K : clen, wlen);  // warps with terms
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int e = tid + h * THREADS;
    float s = part[e];
    for (int q = 1; q < live && q < WARPS; ++q)
      s = __fadd_rn(s, part[q * TILE + e]);
    res[h] = s;
  }
  __syncthreads();  // the next tile stages over the partials
}

// Stage B's first chunk of this rank's first tile of the forward of layer
// `rec` (or of its dX with PANEL) over the rows [i0, i1), if it has one.
template <bool PANEL>
__device__ void prefetch_b(const long long* rec, int i0, int i1, int rank, float* sm) {
  const int K = (int)rec[R_K], N = (int)rec[R_N];
  const int width = PANEL ? K : N;  // the phase's output columns
  if (rank >= cdiv(i1 - i0, ROW_TILE) * cdiv(width, COL_TILE)) return;
  const int c0 = (rank % cdiv(width, COL_TILE)) * COL_TILE;
  if (PANEL)
    stage_b<true>(fptr(rec[R_W]), K, N, c0, K, 0, sm);
  else
    stage_b<false>(fptr(rec[R_W]), K, K, c0, N, 0, sm);
}

// forward layer over the rows [i0, i1) of an item: this rank's tiles of
// A_{l+1} = act(A_l W^T + b); `b_ready`: prefetch_b staged the first one's
// weights
__device__ void forward_layer(const long long* rec, const float* in, float* out, int i0,
                              int i1, int rank, int cluster, bool b_ready, float* sm) {
  const int K = (int)rec[R_K], N = (int)rec[R_N];
  const bool act = rec[R_RELU] != 0;
  const float* w = fptr(rec[R_W]);
  const float* bias = fptr(rec[R_B]);
  const int ct = cdiv(N, COL_TILE);
  const int units = cdiv(i1 - i0, ROW_TILE) * ct;
  for (int u = rank; u < units; u += cluster) {
    const int r0 = i0 + (u / ct) * ROW_TILE, c0 = (u % ct) * COL_TILE;
    const int c = c0 + threadIdx.x % COL_TILE;  // both elements' column
    const float b = c < N ? ldcg(bias + c) : 0.0f;  // loaded while the tile stages
    float res[2];
    tile_product<false>(in + (long long)r0 * K, i1 - r0, K, w, K, c0, N, b_ready && u == rank,
                        sm, res);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = r0 + (threadIdx.x + h * THREADS) / COL_TILE;
      if (m < i1 && c < N) {
        const float z = __fadd_rn(res[h], b);
        out[(long long)m * N + c] = act ? relu(z) : z;
      }
    }
  }
}

// dX of layer l over the rows [i0, i1): this rank's tiles of
// G_{l-1} = (G_l W_l) * mask_{l-1}, mask_{l-1} = A_l > 0; the first tile's
// weights were staged by prefetch_b<true>
__device__ void dx_layer(const long long* rec, const long long* prev, float* ws, int i0,
                         int i1, int rank, int cluster, float* sm) {
  const int K = (int)rec[R_K], N = (int)rec[R_N];
  const bool act = prev[R_RELU] != 0;
  const float* w = fptr(rec[R_W]);
  const float* g = ws + rec[R_G];
  const float* a = ws + rec[R_ACT_IN];
  float* out = ws + prev[R_G];
  const int ct = cdiv(K, COL_TILE);
  const int units = cdiv(i1 - i0, ROW_TILE) * ct;
  for (int u = rank; u < units; u += cluster) {
    const int r0 = i0 + (u / ct) * ROW_TILE, c0 = (u % ct) * COL_TILE;
    const int c = c0 + threadIdx.x % COL_TILE;  // both elements' column
    float mask_act[2] = {0.0f, 0.0f};  // A_l, loaded while the tile stages
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = r0 + (threadIdx.x + h * THREADS) / COL_TILE;
      if (act && m < i1 && c < K) mask_act[h] = ldcg(a + (long long)m * K + c);
    }
    float res[2];
    tile_product<true>(g + (long long)r0 * N, i1 - r0, N, w, K, c0, K, u == rank, sm, res);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = r0 + (threadIdx.x + h * THREADS) / COL_TILE;
      if (m < i1 && c < K)
        out[(long long)m * K + c] = act ? masked(res[h], mask_act[h]) : res[h];
    }
  }
}

struct Smem {
  float red[THREADS];
  float gmax[ROW_TILE];  // the stability max of each group a head run touches
  float scratch[WARPS][64];  // each warp's head row: a column block's terms
  float col[DW_N];
  float loss;   // the batch's loss
  float scale;  // the batch's clip factor
};

// The head over the rows [i0, i1) of an item (whole groups of gr rows) of
// z = A_L (rows x N) and y. The ranks split the rows into runs of
// cdiv(rows, cluster); a block first takes the stability max of each group
// its run touches, then each warp takes one row at a time: the lanes compute
// a column each (32 at a time), and lane 0 adds them up in column order
// through the warp's scratch, so every sum runs over c = 0..N-1 in order:
// s = sum(e), den = s + 1e-7, p = e / den, the row's share of the loss,
// gz = p * (-2 (y - p) / batch_size) and its sum, G_{L-1} = gz - p sum(gz)
// (masked when the last layer has a relu). A row's z and y are staged in
// the warp's slice of A's slot (dyn) when they fit, so a prefetched B
// survives the head; wider rows are read in place.
__device__ void head(const float* z, const float* y, float* g_out, float* row_loss, int i0,
                     int i1, int gr, int N, bool relu_last, float batch_size, int rank,
                     int cluster, float* dyn, Smem& sm) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int per = cdiv(i1 - i0, cluster);
  const int r_lo = i0 + rank * per, r_hi = r_lo + per < i1 ? r_lo + per : i1;
  if (r_lo >= r_hi) return;  // no row for this block
  const int g_lo = (r_lo - i0) / gr, g_hi = (r_hi - 1 - i0) / gr;
  for (int j = g_lo; j <= g_hi; ++j) {
    const long long base = (long long)(i0 + j * gr) * N;
    float m = -INFINITY;
    for (int e = tid; e < gr * N; e += THREADS) m = max_nan(m, ldcg(z + base + e));
    m = block_max(m, sm.red);
    if (tid == 0) sm.gmax[j - g_lo] = m;
  }
  __syncthreads();
  const bool staged = WARPS * 2 * N <= ROW_TILE * LDK;
  float* sc = sm.scratch[warp];
  for (int r = r_lo + warp; r < r_hi; r += WARPS) {
    const float m = sm.gmax[(r - i0) / gr - g_lo];
    const float* zr = z + (long long)r * N;
    const float* yr = y + (long long)r * N;
    if (staged) {
      float* zs = dyn + warp * 2 * N;
      for (int c = lane; c < N; c += 32) {
        zs[c] = ldcg(zr + c);
        zs[N + c] = yr[c];
      }
      __syncwarp();
      zr = zs;
      yr = zs + N;
    }
    float s = 0.0f;
    for (int c0 = 0; c0 < N; c0 += 32) {
      const int c = c0 + lane, nc = N - c0 < 32 ? N - c0 : 32;
      if (c < N) sc[lane] = expf(__fsub_rn(zr[c], m));
      __syncwarp();
      if (lane == 0)
        for (int j = 0; j < nc; ++j) s = __fadd_rn(s, sc[j]);
      __syncwarp();
    }
    const float den = __fadd_rn(__shfl_sync(0xffffffffu, s, 0), 1e-7f);
    float lsum = 0.0f, gz_sum = 0.0f;
    for (int c0 = 0; c0 < N; c0 += 32) {
      const int c = c0 + lane, nc = N - c0 < 32 ? N - c0 : 32;
      if (c < N) {
        const float p = __fdiv_rn(expf(__fsub_rn(zr[c], m)), den);
        const float d = __fsub_rn(yr[c], p);
        sc[lane] = __fmul_rn(d, d);
        sc[32 + lane] = __fmul_rn(p, __fdiv_rn(__fmul_rn(-2.0f, d), batch_size));
      }
      __syncwarp();
      if (lane == 0)
        for (int j = 0; j < nc; ++j) {
          lsum = __fadd_rn(lsum, sc[j]);
          gz_sum = __fadd_rn(gz_sum, sc[32 + j]);
        }
      __syncwarp();
    }
    gz_sum = __shfl_sync(0xffffffffu, gz_sum, 0);
    for (int c = lane; c < N; c += 32) {
      const float zc = zr[c];
      const float p = __fdiv_rn(expf(__fsub_rn(zc, m)), den);
      const float d = __fsub_rn(yr[c], p);
      const float gz = __fmul_rn(p, __fdiv_rn(__fmul_rn(-2.0f, d), batch_size));
      const float g = __fsub_rn(gz, __fmul_rn(p, gz_sum));
      g_out[(long long)r * N + c] = relu_last ? masked(g, zc) : g;
    }
    if (lane == 0) row_loss[r] = lsum;
    __syncwarp();  // the warp's staged row is reused by its next row
  }
}

// The optimizer on one element: the param w and its mirrors s1, s2 (read
// by the caller) with the gradient g; updates s1 and s2, returns the new w.
__device__ __forceinline__ float updated(float w, float& s1, float& s2, float g, int opt,
                                         bool has_decay, const Hyper& hp, float c1, float c2) {
  float step;
  if (opt == OPT_SGD) {
    step = __fmul_rn(hp.lr, g);
  } else if (opt == OPT_MOMENTUM) {
    s1 = __fadd_rn(__fmul_rn(s1, hp.mu), g);
    step = __fmul_rn(hp.lr, s1);
  } else {
    s1 = __fadd_rn(__fmul_rn(s1, hp.b1), __fmul_rn(hp.omb1, g));
    s2 = __fadd_rn(__fmul_rn(s2, hp.b2), __fmul_rn(__fmul_rn(hp.omb2, g), g));
    step = __fdiv_rn(__fmul_rn(hp.lr, __fdiv_rn(s1, c1)),
                     __fadd_rn(__fsqrt_rn(__fdiv_rn(s2, c2)), hp.eps));
  }
  if (has_decay) w = __fmul_rn(w, hp.decay);
  return __fsub_rn(w, step);
}

// One element i of a leaf (param p, mirrors s1, s2) through `updated`,
// in place: the reads, the update, the writes.
struct Elem {
  float w = 0.0f, s1 = 0.0f, s2 = 0.0f;
  __device__ __forceinline__ void load(const float* p, const float* m1, const float* m2,
                                       long long i, int opt) {
    w = ldcg(p + i);
    if (opt != OPT_SGD) s1 = ldcg(m1 + i);
    if (opt == OPT_ADAM) s2 = ldcg(m2 + i);
  }
  __device__ __forceinline__ void store(float* p, float* m1, float* m2, long long i,
                                        int opt) const {
    p[i] = w;
    if (opt != OPT_SGD) m1[i] = s1;
    if (opt == OPT_ADAM) m2[i] = s2;
  }
};

// one dW tile (nt, kt) of layer `rec` over the batch's rows: 32 x 64
// elements, 2 x 4 a thread, each summed over m = 0..rows-1 in order (and db
// on the tiles with kt == 0, one thread of warp 0 per column, in order).
// Without the clip the elements are updated at once; with it dW and db go
// to the workspace with the tile's sums of squares.
__device__ void dw_tile(const long long* rec, const float* act_in, float* ws, int rows,
                        int nt, int kt, bool has_clip, int opt, bool has_decay,
                        const Hyper& hp, float c1, float c2, float* dyn, Smem& sm) {
  const int K = (int)rec[R_K], N = (int)rec[R_N];
  const int tid = threadIdx.x, tn = tid / 16, tk = tid % 16;
  const int n0 = nt * DW_N, k0 = kt * DW_K;
  const bool with_db = kt == 0;
  const float* g = ws + rec[R_G] + n0;
  const float* a = act_in + k0;
  float* gs = dyn;              // [MC][DW_N]
  float* xs = dyn + MC * DW_N;  // [MC][DW_K]
  const bool g_vec = N % 4 == 0 && aligned16(g);
  const bool a_vec = K % 4 == 0 && aligned16(a);
  float* w = fptr(rec[R_W]);
  float* s1 = fptr(rec[R_S1W]);
  float* s2 = fptr(rec[R_S2W]);
  // without the clip this thread updates its elements at the end: their
  // params and mirrors are read now, while the rows stage
  Elem el[2][4];
  if (!has_clip) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + 2 * tn + i, k = k0 + 4 * tk + j;
        if (n < N && k < K) el[i][j].load(w, s1, s2, (long long)n * K + k, opt);
      }
  }
  const bool db_here = with_db && tid < DW_N && n0 + tid < N;
  Elem eb;
  if (!has_clip && db_here) eb.load(fptr(rec[R_B]), fptr(rec[R_S1B]), fptr(rec[R_S2B]), n0 + tid, opt);
  float acc[2][4] = {};
  float db = 0.0f;
  for (int m0 = 0; m0 < rows; m0 += MC) {
    stage(gs, DW_N, g + (long long)m0 * N, N, MC, rows - m0, DW_N, N - n0, g_vec);
    stage(xs, DW_K, a + (long long)m0 * K, K, MC, rows - m0, DW_K, K - k0, a_vec);
    staging::cp_async_wait<0>();
    __syncthreads();
    const int mlen = rows - m0 < MC ? rows - m0 : MC;
#pragma unroll 8
    for (int m = 0; m < mlen; ++m) {
      const float2 gv = *reinterpret_cast<const float2*>(gs + m * DW_N + 2 * tn);
      const float4 av = *reinterpret_cast<const float4*>(xs + m * DW_K + 4 * tk);
      const float gi[2] = {gv.x, gv.y};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        acc[i][0] = fmaf(gi[i], av.x, acc[i][0]);
        acc[i][1] = fmaf(gi[i], av.y, acc[i][1]);
        acc[i][2] = fmaf(gi[i], av.z, acc[i][2]);
        acc[i][3] = fmaf(gi[i], av.w, acc[i][3]);
      }
    }
    if (with_db && tid < DW_N)
#pragma unroll 8
      for (int m = 0; m < mlen; ++m) db = __fadd_rn(db, gs[m * DW_N + tid]);
    __syncthreads();
  }
  float sq = 0.0f;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 2 * tn + i, k = k0 + 4 * tk + j;
      if (n >= N || k >= K) continue;
      const long long o = (long long)n * K + k;
      if (has_clip) {
        ws[rec[R_DW] + o] = acc[i][j];
        sq = __fadd_rn(sq, __fmul_rn(acc[i][j], acc[i][j]));
      } else {
        Elem& x = el[i][j];
        x.w = updated(x.w, x.s1, x.s2, acc[i][j], opt, has_decay, hp, c1, c2);
        x.store(w, s1, s2, o, opt);
      }
    }
  if (db_here) {
    if (has_clip) {
      ws[rec[R_DB] + n0 + tid] = db;
    } else {
      eb.w = updated(eb.w, eb.s1, eb.s2, db, opt, has_decay, hp, c1, c2);
      eb.store(fptr(rec[R_B]), fptr(rec[R_S1B]), fptr(rec[R_S2B]), n0 + tid, opt);
    }
  }
  if (!has_clip) return;
  sq = block_sum(sq, sm.red);
  if (tid == 0) ws[rec[R_SQW] + nt * dw_tiles_k(K) + kt] = sq;
  if (with_db) {
    if (tid < DW_N) sm.col[tid] = db_here ? db : 0.0f;
    __syncthreads();
    if (tid == 0) {
      float s = 0.0f;
      for (int i = 0; i < DW_N && n0 + i < N; ++i)
        s = __fadd_rn(s, __fmul_rn(sm.col[i], sm.col[i]));
      ws[rec[R_SQB] + nt] = s;
    }
    __syncthreads();
  }
}

// The clip factor min(1, clip / max(||g||, 1e-12)) from the tiles' sums of
// squares: each leaf (W_0, b_0, W_1, ...) summed by one warp in a fixed
// lane order and shuffle tree, the leaves added in order from 0.
__device__ float clip_scale(const long long* tab, const float* ws, int L, float clip,
                            Smem& sm) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float total = 0.0f;
  for (int first = 0; first < 2 * L; first += WARPS) {
    const int leaf = first + warp;
    if (leaf < 2 * L) {
      const long long* rec = tab + HEADER_LEN + (leaf / 2) * LAYER_LEN;
      const int N = (int)rec[R_N], K = (int)rec[R_K];
      const long long off = (leaf % 2 == 0) ? rec[R_SQW] : rec[R_SQB];
      const int cnt = dw_tiles_n(N) * ((leaf % 2 == 0) ? dw_tiles_k(K) : 1);
      float s = 0.0f;
      for (int i = lane; i < cnt; i += 32) s = __fadd_rn(s, ldcg(ws + off + i));
      for (int o = 16; o > 0; o >>= 1)
        s = __fadd_rn(s, __shfl_down_sync(0xffffffffu, s, o));
      if (lane == 0) sm.red[warp] = s;
    }
    __syncthreads();
    if (tid == 0) {
      for (int w = 0; w < WARPS && first + w < 2 * L; ++w)
        total = __fadd_rn(total, sm.red[w]);
    }
    __syncthreads();
  }
  if (tid == 0) {
    const float norm = __fsqrt_rn(total);
    const float q = __fdiv_rn(clip, max_nan(norm, 1e-12f));
    sm.scale = (q < 1.0f || q != q) ? q : 1.0f;
  }
  __syncthreads();
  return sm.scale;
}

// the clipped update of one leaf of n elements, grid-strided
__device__ void update_leaf(float* p, float* s1, float* s2, const float* grad, long long n,
                            int opt, float scale, bool has_decay, const Hyper& hp, float c1,
                            float c2) {
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n; i += stride) {
    Elem x;
    x.load(p, s1, s2, i, opt);
    x.w = updated(x.w, x.s1, x.s2, __fmul_rn(ldcg(grad + i), scale), opt, has_decay, hp, c1, c2);
    x.store(p, s1, s2, i, opt);
  }
}

// The batch's loss: the rows' shares summed by warp 0 (lane-strided, then a
// fixed shuffle tree), over batch_size.
__device__ float batch_loss(const float* row_loss, int rows, float batch_size) {
  const int lane = threadIdx.x % 32;
  float s = 0.0f;
  for (int r = lane; r < rows; r += 32) s = __fadd_rn(s, ldcg(row_loss + r));
  for (int o = 16; o > 0; o >>= 1) s = __fadd_rn(s, __shfl_down_sync(0xffffffffu, s, o));
  return __fdiv_rn(s, batch_size);
}

__global__ void __launch_bounds__(THREADS, 1)
fused_train_kernel(const float* X, const float* Y, float* loss, float* ws,
                   const __grid_constant__ Table table, Hyper hp, int nb, int n_epochs,
                   int item_rows, int n_items) {
  cg::grid_group grid = cg::this_grid();
  cg::cluster_group cluster = cg::this_cluster();
  const long long* tab = table.v;
  extern __shared__ __align__(16) float dyn[];
  __shared__ Smem sm;
  const int tid = threadIdx.x;
  const int L = (int)tab[H_L];
  const int opt = (int)tab[H_OPT];
  const int rows = (int)tab[H_ROWS];
  const int gr = (int)tab[H_GROUP_ROWS];
  const bool has_clip = tab[H_HAS_CLIP] != 0;
  const bool has_decay = tab[H_HAS_DECAY] != 0;
  float* row_loss = ws + tab[H_ROW_LOSS];
  float* t_ptr = fptr(tab[H_T]);
  const long long* first = tab + HEADER_LEN;
  const long long* last = tab + HEADER_LEN + (L - 1) * LAYER_LEN;
  const int d_in = (int)first[R_K], d_out = (int)last[R_N];
  const int csize = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int n_clusters = gridDim.x / csize;
  const int cid = blockIdx.x / csize;
  int dw_total = 0;
  for (int l = 0; l < L; ++l) {
    const long long* rec = tab + HEADER_LEN + l * LAYER_LEN;
    dw_total += dw_tiles_n((int)rec[R_N]) * dw_tiles_k((int)rec[R_K]);
  }
  float t = opt == OPT_ADAM ? ldcg(t_ptr) : 0.0f;  // every block reads it first
  int batch = 0;

  for (int e = 0; e < n_epochs; ++e) {
    float loss_sum = 0.0f;
    for (int bi = 0; bi < nb; ++bi, ++batch) {
      const float* x = X + (long long)bi * rows * d_in;
      const float* y = Y + (long long)bi * rows * d_out;
      stamp(batch, 0);

      // 1. the group pass: each item on one cluster, cluster barriers only
      for (int it = cid; it < n_items; it += n_clusters) {
        const int i0 = it * item_rows;
        const int i1 = i0 + item_rows < rows ? i0 + item_rows : rows;
        // each phase's first weights are staged before the cluster barrier
        // that precedes it: they do not depend on the other blocks
        for (int l = 0; l < L; ++l) {
          const long long* rec = tab + HEADER_LEN + l * LAYER_LEN;
          const float* in = l == 0 ? x : ws + rec[R_ACT_IN];
          stamp(batch, 5 + 2 * l);
          forward_layer(rec, in, ws + rec[R_ACT_OUT], i0, i1, rank, csize, l > 0, dyn);
          stamp(batch, 6 + 2 * l);
          if (l + 1 < L)
            prefetch_b<false>(rec + LAYER_LEN, i0, i1, rank, dyn);
          else if (L > 1)
            prefetch_b<true>(rec, i0, i1, rank, dyn);
          cluster.sync();
        }
        stamp(batch, 5 + 2 * L);
        head(ws + last[R_ACT_OUT], y, ws + last[R_G], row_loss, i0, i1, gr, d_out,
             last[R_RELU] != 0, hp.batch_size, rank, csize, dyn, sm);
        stamp(batch, 6 + 2 * L);
        if (L > 1) cluster.sync();
        for (int l = L - 1; l >= 1; --l) {
          const long long* rec = tab + HEADER_LEN + l * LAYER_LEN;
          stamp(batch, 5 + 4 * L - 2 * l);
          dx_layer(rec, rec - LAYER_LEN, ws, i0, i1, rank, csize, dyn);
          stamp(batch, 6 + 4 * L - 2 * l);
          if (l > 1) {
            prefetch_b<true>(rec - LAYER_LEN, i0, i1, rank, dyn);
            cluster.sync();
          }
        }
      }
      stamp(batch, 1);
      grid.sync();
      stamp(batch, 2);

      // 2. the weight-gradient pass over every block
      if (blockIdx.x == 0 && tid < 32) {
        const float l = batch_loss(row_loss, rows, hp.batch_size);
        if (tid == 0) loss_sum = __fadd_rn(loss_sum, l);
      }
      float c1 = 1.0f, c2 = 1.0f;
      if (opt == OPT_ADAM) {
        t = __fadd_rn(t, 1.0f);
        c1 = __fsub_rn(1.0f, powf(hp.b1, t));
        c2 = __fsub_rn(1.0f, powf(hp.b2, t));
      }
      for (int tile = blockIdx.x; tile < dw_total; tile += gridDim.x) {
        int l = 0, rest = tile;
        for (;; ++l) {
          const long long* rec = tab + HEADER_LEN + l * LAYER_LEN;
          const int n_t = dw_tiles_n((int)rec[R_N]) * dw_tiles_k((int)rec[R_K]);
          if (rest < n_t) break;
          rest -= n_t;
        }
        const long long* rec = tab + HEADER_LEN + l * LAYER_LEN;
        const int tk = dw_tiles_k((int)rec[R_K]);
        dw_tile(rec, l == 0 ? x : ws + rec[R_ACT_IN], ws, rows, rest / tk, rest % tk, has_clip,
                opt, has_decay, hp, c1, c2, dyn, sm);
      }
      if (has_clip) {
        grid.sync();  // every tile's sum of squares
        const float scale = clip_scale(tab, ws, L, hp.clip, sm);
        for (int l = 0; l < L; ++l) {
          const long long* rec = tab + HEADER_LEN + l * LAYER_LEN;
          const long long N = rec[R_N], K = rec[R_K];
          update_leaf(fptr(rec[R_W]), fptr(rec[R_S1W]), fptr(rec[R_S2W]), ws + rec[R_DW],
                      N * K, opt, scale, has_decay, hp, c1, c2);
          update_leaf(fptr(rec[R_B]), fptr(rec[R_S1B]), fptr(rec[R_S2B]), ws + rec[R_DB], N,
                      opt, scale, has_decay, hp, c1, c2);
        }
      }
      stamp(batch, 3);
      grid.sync();  // the next batch reads the updated params
      stamp(batch, 4);
    }
    if (blockIdx.x == 0 && tid == 0) loss[e] = __fdiv_rn(loss_sum, (float)nb);
  }
  if (opt == OPT_ADAM && blockIdx.x == 0 && tid == 0) *t_ptr = t;
}

struct DeviceInfo {
  int cluster = 0;      // the cluster size max_clusters was asked for
  int max_clusters = 0;  // clusters resident at once
};

// How many clusters of `cluster` blocks are resident at once on `dev`, with
// the kernel's shared memory; set up once per device and cluster size.
cudaError_t resident_clusters(int dev, int cluster, int* out) {
  static DeviceInfo info[MAX_DEVICES];
  DeviceInfo& d = info[dev];
  if (d.cluster != cluster) {
    int coop = 0;
    cudaError_t err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err != cudaSuccess) return err;
    if (!coop) return cudaErrorNotSupported;
    err = cudaFuncSetAttribute(fused_train_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(cluster);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = SMEM_BYTES;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(&d.max_clusters, (void*)fused_train_kernel, &cfg);
    if (err != cudaSuccess) return err;
    d.cluster = cluster;
  }
  *out = d.max_clusters;
  return cudaSuccess;
}

}  // namespace

// Plain C entry point, bound with ctypes. X (nb * rows, d_in), Y (nb * rows,
// d_out), loss (n_epochs) and ws (the workspace) are device pointers;
// table_host (HEADER_LEN + L * LAYER_LEN int64) and hyper_host (the 10
// floats of struct Hyper) are HOST arrays, copied into the launch's
// parameters. The plan (cuda_ops.fused_plan): clusters of `cluster` blocks,
// group-pass items of `item_rows` rows (whole head groups), `n_items` of
// them, `dw_tiles` weight-gradient tiles; the entry point checks it against
// the table and refuses any other. Runs n_epochs x nb batches in one
// cooperative launch in thread block clusters on `stream`, with as many
// clusters as are resident at once, at most enough for the larger pass.
// Returns 0 when launched, else the CUDA error (cudaErrorInvalidValue for
// more than MAX_LAYERS layers or a plan that does not fit the table; the
// launch's own error when the card refuses it).
extern "C" int fused_train(const float* X, const float* Y, float* loss, float* ws,
                           const long long* table_host, const float* hyper_host, int nb,
                           int n_epochs, int cluster, int item_rows, int n_items,
                           int dw_tiles, void* stream) {
  const long long L = table_host[H_L];
  if (nb <= 0 || n_epochs <= 0 || L < 1 || L > MAX_LAYERS) return (int)cudaErrorInvalidValue;
  const long long rows = table_host[H_ROWS], gr = table_host[H_GROUP_ROWS];
  if (cluster < 1 || cluster > MAX_CLUSTER || gr < 1 || item_rows < 1 || item_rows % gr ||
      rows % gr || n_items != cdiv((int)rows, item_rows))
    return (int)cudaErrorInvalidValue;
  int tiles = 0;
  for (long long l = 0; l < L; ++l) {
    const long long* rec = table_host + HEADER_LEN + l * LAYER_LEN;
    tiles += dw_tiles_n((int)rec[R_N]) * dw_tiles_k((int)rec[R_K]);
  }
  if (tiles != dw_tiles) return (int)cudaErrorInvalidValue;
  Table table = {};
  for (long long i = 0; i < HEADER_LEN + L * LAYER_LEN; ++i) table.v[i] = table_host[i];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  int resident = 0;
  err = resident_clusters(dev, cluster, &resident);
  if (err != cudaSuccess) return (int)err;
  if (resident < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  int want = n_items > cdiv(dw_tiles, cluster) ? n_items : cdiv(dw_tiles, cluster);
  const int clusters = want < resident ? want : resident;
  Hyper hp = {hyper_host[0], hyper_host[1], hyper_host[2], hyper_host[3], hyper_host[4],
              hyper_host[5], hyper_host[6], hyper_host[7], hyper_host[8], hyper_host[9]};
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.gridDim = dim3(clusters * cluster);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM_BYTES;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  err = cudaLaunchKernelEx(&cfg, fused_train_kernel, X, Y, loss, ws, table, hp, nb, n_epochs,
                           item_rows, n_items);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

#ifdef FUSED_TRAIN_PHASE_STAMPS
// The device clock (ns) of the first batches of the last launch, STAMPS a
// batch (see STAMPS; a stamp block 0 did not reach is left as it was).
// Copies min(n, MAX_STAMPED * STAMPS) stamps.
extern "C" int fused_train_stamps(unsigned long long* host, int n) {
  const int most = MAX_STAMPED * STAMPS;
  return (int)cudaMemcpyFromSymbol(host, g_stamps,
                                   sizeof(unsigned long long) * (n < most ? n : most));
}
#endif
