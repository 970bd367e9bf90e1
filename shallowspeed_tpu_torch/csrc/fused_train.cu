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
// Per batch, in phases separated by grid-wide barriers:
//   forward, one phase per layer:  A_{l+1} = act(A_l @ W_l^T + b_l)
//   head, one work item per group_rows-row group: the stability max over
//     the whole group, p = e / (rowsum(e) + 1e-7), the group's share of
//     sum((y - p)^2), G_{L-1} = softmax VJP of -2 (y - p) / batch_size
//   backward, one phase per layer (from the PRE-update weights):
//     dW_l = G_l^T @ A_l, db_l = colsum(G_l), G_{l-1} = (G_l @ W_l) * mask,
//     with the mask read back as A_l > 0 (relu keeps NaN, so A_l > 0 is
//     exactly z > 0) and each tile's sum of squares kept for the clip
//   update: the clip factor, then SGD / momentum / Adam on every element.
//
// What bounds it on an H100: a flagship step (B = 128) is ~112.8 MFLOP of
// products against ~1.9 MB moved (SGD; ~4.8 MB with Adam's two mirrors), so
// it is bound by operations: ~0.0017 ms at 67 TFLOP/s fp32. The working set
// (params, grads, activations; ~2.6 MB, ~4 MB with Adam) does not fit one
// SM's 227 KB of shared memory but fits the 50 MB L2 many times over. The
// design: a persistent cooperative kernel (cudaLaunchCooperativeKernel, one
// block per SM at most) whose blocks split each phase's 16x16 output tiles
// among themselves, with activations, gradients and partial sums in a
// workspace in device memory (L2-resident), and grid.sync() between phases.
// One launch then carries a whole batch, epoch or run: the host issues
// nothing between batches. The products are FFMA on the CUDA cores (no
// TF32: the reference is IEEE fp32); its 2L + 2 barriers a batch and small
// tiles leave it far from its bound. wgmma/TMA tiles and fewer barriers are
// later work.
//
// Determinism: every output element is summed by one thread in one fixed
// order (k = 0..K-1; db and the head's row sums over their index in order),
// and every sum across threads or blocks (the loss over groups, each
// tile's and each leaf's sum of squares, the epoch's loss) is taken in a
// fixed order that does not depend on the grid size. No float atomics, so
// two launches give the same bits, an epoch equals a loop of steps and a
// run a loop of epochs.
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

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int T = 16;           // output tile edge
constexpr int BK = 32;          // reduction depth of one shared-memory stage
constexpr int THREADS = T * T;  // one output element per thread
constexpr int WARPS = THREADS / 32;
constexpr int MAX_BLOCKS_PER_SM = 1;  // a barrier waits for every block
constexpr int MAX_DEVICES = 64;

// the table: a header, then one record per layer (cuda_ops.TABLE_HEADER,
// cuda_ops.TABLE_LAYER; tests/test_torch_fused_train.py holds them equal)
constexpr int HEADER_LEN = 16;
enum Header { H_L, H_OPT, H_ROWS, H_GROUP_ROWS, H_N_GROUPS, H_LOSS_PART, H_T,
              H_HAS_CLIP, H_HAS_DECAY };
constexpr int LAYER_LEN = 16;
enum Layer { R_K, R_N, R_RELU, R_W, R_B, R_S1W, R_S1B, R_S2W, R_S2B, R_ACT_IN,
             R_ACT_OUT, R_G, R_DW, R_DB, R_SQW, R_SQB };
enum Opt { OPT_SGD, OPT_MOMENTUM, OPT_ADAM };
constexpr int MAX_LAYERS = 24;  // deeper models are refused
struct Table { long long v[HEADER_LEN + MAX_LAYERS * LAYER_LEN]; };

// cuda_ops.HYPER, in order
struct Hyper { float lr, decay, mu, b1, b2, omb1, omb2, eps, clip, batch_size; };

__device__ __forceinline__ int tiles(int n) { return (n + T - 1) / T; }

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

// One 16x16 output tile, one element per thread at (r0 + ty, c0 + tx):
//   acc = sum_{k = 0..K-1, in order} A(r, k) * B(k, c)
// with A(r, k) = a[r * a_r + k * a_k] and B(k, c) = b[k * b_k + c * b_c];
// rows >= R, columns >= C and k >= K read as 0 (past K both operands are 0,
// so the tail adds 0 * 0 and the order stays k = 0..K-1). With `rowsum`
// the threads with tx == 0 also sum A(r0 + ty, k) over k in order.
__device__ float tile_dot(const float* a, long long a_r, long long a_k,
                          const float* b, long long b_k, long long b_c, int R,
                          int C, int K, int r0, int c0, float (*as)[T + 1],
                          float (*bs)[T + 1], bool rowsum, float* rsum) {
  const int tid = threadIdx.x;
  const int tx = tid % T;
  const int ty = tid / T;
  float acc = 0.0f;
  float rs = 0.0f;
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < T * BK; e += THREADS) {
      // neighbouring threads on neighbouring addresses along the unit stride
      int r, c, ka, kb;
      if (a_k == 1) { r = e / BK; ka = e % BK; } else { ka = e / T; r = e % T; }
      if (b_k == 1) { c = e / BK; kb = e % BK; } else { kb = e / T; c = e % T; }
      const int gr = r0 + r, gka = k0 + ka;
      const int gc = c0 + c, gkb = k0 + kb;
      as[ka][r] = (gr < R && gka < K) ? a[gr * a_r + gka * a_k] : 0.0f;
      bs[kb][c] = (gc < C && gkb < K) ? b[gkb * b_k + gc * b_c] : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < BK; ++k) acc = fmaf(as[k][ty], bs[k][tx], acc);
    if (rowsum && tx == 0) {
      for (int k = 0; k < BK; ++k) rs = __fadd_rn(rs, as[k][ty]);
    }
    __syncthreads();
  }
  if (rowsum) *rsum = rs;
  return acc;
}

struct Smem {
  float as[BK][T + 1];
  float bs[BK][T + 1];
  float red[THREADS];
  float col[T];
  float loss;   // this batch's loss
  float scale;  // this batch's clip factor
};

// forward item: one tile of A_{l+1} (rows x N)
__device__ void forward_item(const long long* rec, const float* in, float* out,
                             int rows, int item, Smem& sm) {
  const int K = (int)rec[R_K], N = (int)rec[R_N];
  const int tn = tiles(N);
  const int r0 = (item / tn) * T, c0 = (item % tn) * T;
  const float* w = fptr(rec[R_W]);
  const float* bias = fptr(rec[R_B]);
  // A(r, k) = in[r][k], B(k, c) = W[c][k]
  const float acc = tile_dot(in, K, 1, w, 1, K, rows, N, K, r0, c0, sm.as,
                             sm.bs, false, nullptr);
  const int r = r0 + (int)threadIdx.x / T, c = c0 + (int)threadIdx.x % T;
  if (r < rows && c < N) {
    const float z = __fadd_rn(acc, bias[c]);
    out[(size_t)r * N + c] = rec[R_RELU] ? relu(z) : z;
  }
}

// head item: one group of `gr` rows of z = A_L (rows x N) and y
__device__ void head_item(const float* z, const float* y, float* g_out,
                          float* loss_part, int gi, int gr, int N, bool relu_last,
                          float batch_size, Smem& sm) {
  const int tid = threadIdx.x;
  const size_t base = (size_t)gi * gr * N;
  const int n_el = gr * N;
  float m = -INFINITY;
  for (int e = tid; e < n_el; e += THREADS) m = max_nan(m, z[base + e]);
  m = block_max(m, sm.red);
  float lsum = 0.0f;
  for (int r = tid; r < gr; r += THREADS) {
    const float* zr = z + base + (size_t)r * N;
    const float* yr = y + base + (size_t)r * N;
    float* gz_r = g_out + base + (size_t)r * N;
    float s = 0.0f;
    for (int c = 0; c < N; ++c) s = __fadd_rn(s, expf(__fsub_rn(zr[c], m)));
    const float den = __fadd_rn(s, 1e-7f);
    float gz_sum = 0.0f;
    for (int c = 0; c < N; ++c) {
      const float p = __fdiv_rn(expf(__fsub_rn(zr[c], m)), den);
      const float d = __fsub_rn(yr[c], p);
      lsum = __fadd_rn(lsum, __fmul_rn(d, d));
      const float gl = __fdiv_rn(__fmul_rn(-2.0f, d), batch_size);
      const float gz = __fmul_rn(p, gl);
      gz_r[c] = gz;
      gz_sum = __fadd_rn(gz_sum, gz);
    }
    for (int c = 0; c < N; ++c) {
      const float p = __fdiv_rn(expf(__fsub_rn(zr[c], m)), den);
      const float g = __fsub_rn(gz_r[c], __fmul_rn(p, gz_sum));
      gz_r[c] = relu_last ? masked(g, zr[c]) : g;
    }
  }
  lsum = block_sum(lsum, sm.red);
  if (tid == 0) loss_part[gi] = lsum;
}

// backward item of layer l: a tile of dW_l (and db_l on the first column
// of tiles), or a tile of G_{l-1}; with sq_sums (the clip is on) each dW
// tile and each db slice also leaves its sum of squares
__device__ void backward_item(const long long* rec, const long long* prev,
                              const float* act_in, float* ws, int rows,
                              int item, bool sq_sums, Smem& sm) {
  const int K = (int)rec[R_K], N = (int)rec[R_N];
  const int tid = threadIdx.x, tx = tid % T, ty = tid / T;
  const int tk = tiles(K);
  const int n_dw = tiles(N) * tk;
  const float* g = ws + rec[R_G];
  if (item < n_dw) {
    // dW[n][k] = sum_m G[m][n] * A[m][k];  db[n] = sum_m G[m][n]
    const int nt = item / tk, kt = item % tk;
    const int r0 = nt * T, c0 = kt * T;
    const bool with_db = kt == 0;
    float rs = 0.0f;
    const float acc = tile_dot(g, 1, N, act_in, K, 1, N, K, rows, r0, c0,
                               sm.as, sm.bs, with_db, &rs);
    const int n = r0 + ty, k = c0 + tx;
    const bool in = n < N && k < K;
    if (in) ws[rec[R_DW] + (size_t)n * K + k] = acc;
    if (with_db && tx == 0 && n < N) ws[rec[R_DB] + n] = rs;
    if (!sq_sums) return;
    const float sq = block_sum(in ? __fmul_rn(acc, acc) : 0.0f, sm.red);
    if (tid == 0) ws[rec[R_SQW] + item] = sq;
    if (with_db) {
      if (tx == 0) sm.col[ty] = rs;
      __syncthreads();
      if (tid == 0) {
        float s = 0.0f;
        for (int i = 0; i < T && r0 + i < N; ++i)
          s = __fadd_rn(s, __fmul_rn(sm.col[i], sm.col[i]));
        ws[rec[R_SQB] + nt] = s;
      }
      __syncthreads();
    }
    return;
  }
  // G_{l-1}[m][k] = (sum_n G[m][n] * W[n][k]) * mask_{l-1}[m][k]
  const int j = item - n_dw;
  const int r0 = (j / tk) * T, c0 = (j % tk) * T;
  const float* w = fptr(rec[R_W]);
  const float acc = tile_dot(g, N, 1, w, K, 1, rows, K, N, r0, c0, sm.as,
                             sm.bs, false, nullptr);
  const int m = r0 + ty, k = c0 + tx;
  if (m < rows && k < K) {
    const size_t o = (size_t)m * K + k;
    ws[prev[R_G] + o] = prev[R_RELU] ? masked(acc, act_in[o]) : acc;
  }
}

// The clip factor min(1, clip / max(||g||, 1e-12)) from the tiles' sums of
// squares: each leaf (W_0, b_0, W_1, ...) summed by one warp in a fixed
// lane order and shuffle tree, the leaves added in order from 0.
__device__ float clip_scale(const long long* tab, const float* ws, int L,
                            float clip, Smem& sm) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float total = 0.0f;
  for (int first = 0; first < 2 * L; first += WARPS) {
    const int leaf = first + warp;
    if (leaf < 2 * L) {
      const long long* rec = tab + HEADER_LEN + (leaf / 2) * LAYER_LEN;
      const int N = (int)rec[R_N], K = (int)rec[R_K];
      const long long off = (leaf % 2 == 0) ? rec[R_SQW] : rec[R_SQB];
      const int cnt = (leaf % 2 == 0) ? tiles(N) * tiles(K) : tiles(N);
      float s = 0.0f;
      for (int i = lane; i < cnt; i += 32) s = __fadd_rn(s, ws[off + i]);
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

// the optimizer on one leaf of n elements, grid-strided
__device__ void update_leaf(float* p, float* s1, float* s2, const float* grad,
                            long long n, int opt, bool has_clip, float scale,
                            bool has_decay, const Hyper& hp, float c1, float c2) {
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += stride) {
    float g = grad[i];
    if (has_clip) g = __fmul_rn(g, scale);
    float step;
    if (opt == OPT_SGD) {
      step = __fmul_rn(hp.lr, g);
    } else if (opt == OPT_MOMENTUM) {
      const float v = __fadd_rn(__fmul_rn(s1[i], hp.mu), g);
      s1[i] = v;
      step = __fmul_rn(hp.lr, v);
    } else {
      const float m = __fadd_rn(__fmul_rn(s1[i], hp.b1), __fmul_rn(hp.omb1, g));
      const float v =
          __fadd_rn(__fmul_rn(s2[i], hp.b2), __fmul_rn(__fmul_rn(hp.omb2, g), g));
      s1[i] = m;
      s2[i] = v;
      step = __fdiv_rn(__fmul_rn(hp.lr, __fdiv_rn(m, c1)),
                       __fadd_rn(__fsqrt_rn(__fdiv_rn(v, c2)), hp.eps));
    }
    float w = p[i];
    if (has_decay) w = __fmul_rn(w, hp.decay);
    p[i] = __fsub_rn(w, step);
  }
}

__global__ void __launch_bounds__(THREADS)
fused_train_kernel(const float* X, const float* Y, float* loss, float* ws,
                   const __grid_constant__ Table table, Hyper hp, int nb,
                   int n_epochs) {
  cg::grid_group grid = cg::this_grid();
  const long long* tab = table.v;
  __shared__ Smem sm;
  const int tid = threadIdx.x;
  const int L = (int)tab[H_L];
  const int opt = (int)tab[H_OPT];
  const int rows = (int)tab[H_ROWS];
  const int gr = (int)tab[H_GROUP_ROWS];
  const int n_groups = (int)tab[H_N_GROUPS];
  const bool has_clip = tab[H_HAS_CLIP] != 0;
  const bool has_decay = tab[H_HAS_DECAY] != 0;
  float* loss_part = ws + tab[H_LOSS_PART];
  float* t_ptr = fptr(tab[H_T]);
  const long long* first = tab + HEADER_LEN;
  const long long* last = tab + HEADER_LEN + (L - 1) * LAYER_LEN;
  const int d_in = (int)first[R_K], d_out = (int)last[R_N];
  float t = opt == OPT_ADAM ? *t_ptr : 0.0f;  // every block reads it first

  for (int e = 0; e < n_epochs; ++e) {
    float loss_sum = 0.0f;
    for (int bi = 0; bi < nb; ++bi) {
      const float* x = X + (size_t)bi * rows * d_in;
      const float* y = Y + (size_t)bi * rows * d_out;

      for (int l = 0; l < L; ++l) {
        const long long* rec = tab + HEADER_LEN + l * LAYER_LEN;
        const float* in = l == 0 ? x : ws + rec[R_ACT_IN];
        const int items = tiles(rows) * tiles((int)rec[R_N]);
        for (int it = blockIdx.x; it < items; it += gridDim.x)
          forward_item(rec, in, ws + rec[R_ACT_OUT], rows, it, sm);
        grid.sync();
      }

      for (int gi = blockIdx.x; gi < n_groups; gi += gridDim.x)
        head_item(ws + last[R_ACT_OUT], y, ws + last[R_G], loss_part, gi, gr,
                  d_out, last[R_RELU] != 0, hp.batch_size, sm);
      grid.sync();

      for (int l = L - 1; l >= 0; --l) {
        const long long* rec = tab + HEADER_LEN + l * LAYER_LEN;
        const long long* prev = rec - LAYER_LEN;  // read only when l > 0
        const float* act_in = l == 0 ? x : ws + rec[R_ACT_IN];
        const int tk = tiles((int)rec[R_K]);
        const int items =
            tiles((int)rec[R_N]) * tk + (l > 0 ? tiles(rows) * tk : 0);
        for (int it = blockIdx.x; it < items; it += gridDim.x)
          backward_item(rec, prev, act_in, ws, rows, it, has_clip, sm);
        grid.sync();
      }

      // the batch's loss, and the clip factor: every block computes them
      // from the same partials in the same order
      if (tid == 0) {
        float s = 0.0f;
        for (int i = 0; i < n_groups; ++i) s = __fadd_rn(s, loss_part[i]);
        sm.loss = __fdiv_rn(s, hp.batch_size);
      }
      __syncthreads();
      const float scale = has_clip ? clip_scale(tab, ws, L, hp.clip, sm) : 1.0f;
      float c1 = 1.0f, c2 = 1.0f;
      if (opt == OPT_ADAM) {
        t = __fadd_rn(t, 1.0f);
        c1 = __fsub_rn(1.0f, powf(hp.b1, t));
        c2 = __fsub_rn(1.0f, powf(hp.b2, t));
      }
      for (int l = 0; l < L; ++l) {
        const long long* rec = tab + HEADER_LEN + l * LAYER_LEN;
        const long long N = rec[R_N], K = rec[R_K];
        update_leaf(fptr(rec[R_W]), fptr(rec[R_S1W]), fptr(rec[R_S2W]),
                    ws + rec[R_DW], N * K, opt, has_clip, scale, has_decay, hp,
                    c1, c2);
        update_leaf(fptr(rec[R_B]), fptr(rec[R_S1B]), fptr(rec[R_S2B]),
                    ws + rec[R_DB], N, opt, has_clip, scale, has_decay, hp, c1,
                    c2);
      }
      loss_sum = __fadd_rn(loss_sum, sm.loss);
      grid.sync();  // the next batch reads the updated params
    }
    if (blockIdx.x == 0 && tid == 0)
      loss[e] = __fdiv_rn(loss_sum, (float)nb);
  }
  if (opt == OPT_ADAM && blockIdx.x == 0 && tid == 0) *t_ptr = t;
}

struct DeviceInfo {
  int sms = 0;
  int per_sm = 0;
};

}  // namespace

// Plain C entry point, bound with ctypes. X (nb * rows, d_in), Y (nb * rows,
// d_out), loss (n_epochs) and ws (the workspace) are device pointers;
// table_host (HEADER_LEN + L * LAYER_LEN int64) and hyper_host (the 10
// floats of struct Hyper) are HOST arrays, copied into the launch's
// parameters. Runs n_epochs x nb batches in one cooperative launch on
// `stream` with at most max_items blocks (the largest phase's work items).
// Returns 0 when launched, else the CUDA error (cudaErrorInvalidValue for
// more than MAX_LAYERS layers, cudaErrorCooperativeLaunchTooLarge when the
// blocks cannot all be resident).
extern "C" int fused_train(const float* X, const float* Y, float* loss,
                           float* ws, const long long* table_host,
                           const float* hyper_host, int nb, int n_epochs,
                           int max_items, void* stream) {
  static DeviceInfo info[MAX_DEVICES];
  const long long L = table_host[H_L];
  if (nb <= 0 || n_epochs <= 0 || max_items <= 0 || L < 1 || L > MAX_LAYERS)
    return (int)cudaErrorInvalidValue;
  Table table = {};
  for (long long i = 0; i < HEADER_LEN + L * LAYER_LEN; ++i)
    table.v[i] = table_host[i];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  DeviceInfo& d = info[dev];
  if (d.sms == 0) {
    int coop = 0;
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err != cudaSuccess) return (int)err;
    if (!coop) return (int)cudaErrorNotSupported;
    err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &d.per_sm, fused_train_kernel, THREADS, 0);
    if (err != cudaSuccess) return (int)err;
  }
  if (d.per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  int grid = d.sms * (d.per_sm < MAX_BLOCKS_PER_SM ? d.per_sm : MAX_BLOCKS_PER_SM);
  if (grid > max_items) grid = max_items;
  Hyper hp = {hyper_host[0], hyper_host[1], hyper_host[2], hyper_host[3],
              hyper_host[4], hyper_host[5], hyper_host[6], hyper_host[7],
              hyper_host[8], hyper_host[9]};
  void* args[] = {(void*)&X,     (void*)&Y,  (void*)&loss, (void*)&ws,
                  (void*)&table, (void*)&hp, (void*)&nb,   (void*)&n_epochs};
  err = cudaLaunchCooperativeKernel((const void*)fused_train_kernel, dim3(grid),
                                    dim3(THREADS), args, 0,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
