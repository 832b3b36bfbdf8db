// TransE margin scoring, forward and backward, on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/transe_score.py::
// transe_score (forward) and the closed-form backward of its custom VJP,
// src/repro/kernels/ops.py::_bwd (an XLA segment_sum there).  Per triplet
// i = [h, r, t, nh, nt]:
//   u = (h + r) - t,  v = (nh + r) - nt
//   d_pos = sum_j |u_j|  or  sqrt(sum_j u_j^2 + 1e-12)   (d_neg from v)
//   loss  = max((margin + d_pos) - d_neg, 0)
// and, given the upstream gradient g_i of loss_i,
//   scale = g_i * [loss_i > 0],  s(x) = sign(x) (L1) or x / (d + 1e-12) (L2)
//   gu = s(u) * scale,  gv = (-s(v)) * scale
//   d_ent[h] += gu, d_ent[t] += -gu, d_ent[nh] += gv, d_ent[nt] += -gv,
//   d_rel[r] += gu + gv.
// Tables are fp32 or bf16 (arithmetic in fp32, gradients written in the
// tables' type).
//
// Workers without a worker axis: the tables may be stacked, (W, N, k), with
// the triplets (W, B, 5) holding each worker's own ids.  Triplet i belongs
// to worker w = i / B, which gathers from table + w * worker_stride (the
// stride is N*k for W separate tables, as SGD's local copies are, and 0 for
// one table shared by all, as BGD's is) and scatters into rows w*N + id of
// a dense (W, N, k) gradient.  One launch serves all W workers.
//
// What bounds it on an H100: bytes.  The forward reads five k-rows per
// triplet and writes three floats, about 0.2 operations per byte at k = 50,
// far under the card's fp32 ridge (~20 per byte); the backward also writes
// every row of the dense gradient.  The designs below keep the loads
// coalesced; they are simple first, and not yet fast.
//
// Exactness.  Sums run over j = 0 .. k-1 in order with __fadd_rn /
// __fmul_rn / __fdiv_rn / __fsqrt_rn (and --fmad=false), the operations of
// the plain version kernels/ref.py (transe_score_ref, transe_score_bwd_ref)
// in the same order, so on the card the two agree bitwise; a warp-tree
// reduction would not.
//
// Forward: a warp takes 32 triplets.  For each group of 32 columns its
// lanes load the five rows of one triplet at a time, coalesced (lane j reads
// column j), form u_j and v_j elementwise and stage them in shared memory;
// then each lane sums its own triplet's staged columns in order.
//
// Backward: no float atomics, whose order changes from run to run.  The
// wrapper sorts the scatter rows stably (entity contributions in the order
// [h..., t..., nh..., nt...] over all triplets, relation contributions in
// triplet order).  A warp owns a few consecutive rows of the dense gradient
// (entity rows first, then relation rows): as many as hold about one
// contribution in all, 1 to 8, so a step's sparse gradient takes a wave of
// warps and a hot row is walked alone.  The warp finds its first row's run
// in the sorted list with a 32-way search; for each of its rows it walks
// the row's run in order, recomputing each contribution's gu / gv from the
// five rows, adds them one at a time into per-lane column accumulators
// (lane j holds columns j, j + 32, ...), and writes the row: exactly +0.0
// where no triplet references it.  Every row is written once, by this
// kernel, so the gradient needs no zero-fill.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;                  // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 32;                  // columns staged per pass
constexpr int kMaxColsPerLane = 8;         // k <= 256 in the backward
constexpr int64_t kMaxRowsPerWarp = 8;     // gradient rows per warp
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// sign(x) as (x > 0) - (x < 0): +0 at zero and at NaN, like the plain version
__device__ __forceinline__ float sgn(float x) {
  return __fsub_rn(x > 0.f ? 1.f : 0.f, x < 0.f ? 1.f : 0.f);
}

template <typename T, bool kL2>
__global__ void __launch_bounds__(kThreads)
transe_score_fwd_kernel(const T* __restrict__ ent, const T* __restrict__ rel,
                        const int* __restrict__ idx, int64_t n,
                        int64_t per_worker, int64_t ent_ws, int64_t rel_ws,
                        int k, float margin, float* __restrict__ loss,
                        float* __restrict__ d_pos, float* __restrict__ d_neg) {
  __shared__ float su[kWarps][32][kCols + 1];
  __shared__ float sv[kWarps][32][kCols + 1];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t base = ((int64_t)blockIdx.x * kWarps + warp) * 32;
  if (base >= n) return;                   // the whole warp leaves together
  const int m = n - base < 32 ? (int)(n - base) : 32;

  float acc_u = 0.f, acc_v = 0.f;
  for (int j0 = 0; j0 < k; j0 += kCols) {
    const int cols = k - j0 < kCols ? k - j0 : kCols;
    for (int i = 0; i < m; ++i) {
      if (lane < cols) {
        const int64_t tri = base + i;
        const int* ti = idx + tri * 5;
        const int64_t w = tri / per_worker;
        const T* eb = ent + w * ent_ws;
        const T* rb = rel + w * rel_ws;
        const int j = j0 + lane;
        const float h = to_f32(eb[(int64_t)ti[0] * k + j]);
        const float r = to_f32(rb[(int64_t)ti[1] * k + j]);
        const float t = to_f32(eb[(int64_t)ti[2] * k + j]);
        const float nh = to_f32(eb[(int64_t)ti[3] * k + j]);
        const float nt = to_f32(eb[(int64_t)ti[4] * k + j]);
        su[warp][i][lane] = __fsub_rn(__fadd_rn(h, r), t);
        sv[warp][i][lane] = __fsub_rn(__fadd_rn(nh, r), nt);
      }
    }
    __syncwarp();
    if (lane < m) {
      for (int jj = 0; jj < cols; ++jj) {
        const float x = su[warp][lane][jj];
        const float y = sv[warp][lane][jj];
        if (kL2) {
          acc_u = __fadd_rn(acc_u, __fmul_rn(x, x));
          acc_v = __fadd_rn(acc_v, __fmul_rn(y, y));
        } else {
          acc_u = __fadd_rn(acc_u, fabsf(x));
          acc_v = __fadd_rn(acc_v, fabsf(y));
        }
      }
    }
    __syncwarp();
  }
  if (lane < m) {
    float dp = acc_u, dn = acc_v;
    if (kL2) {
      dp = __fsqrt_rn(__fadd_rn(dp, 1e-12f));
      dn = __fsqrt_rn(__fadd_rn(dn, 1e-12f));
    }
    const int64_t b = base + lane;
    d_pos[b] = dp;
    d_neg[b] = dn;
    loss[b] = fmaxf(__fsub_rn(__fadd_rn(margin, dp), dn), 0.f);
  }
}

// The first position of the ascending rows[0, len) that holds a value
// >= key (len if none), searched by the 32 lanes of a warp together: each
// round the lanes probe 32 evenly spaced positions of [lo, hi) and a ballot
// keeps the stretch that holds the answer.  Warp-uniform.
__device__ __forceinline__ int64_t warp_lower_bound(const int* rows,
                                                    int64_t len, int64_t key,
                                                    int lane) {
  int64_t lo = 0, hi = len;                // the answer lies in [lo, hi]
  while (hi - lo > 32) {
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t probe = lo + lane * step;
    const int below = __popc(
        __ballot_sync(kFull, probe < hi && rows[probe] < key));
    const int64_t next = lo + below * step;  // the first probe not below
    if (next < hi) hi = next;
    if (below > 0) lo += (below - 1) * step + 1;
  }
  const int64_t probe = lo + lane;
  return lo + __popc(__ballot_sync(kFull, probe < hi && rows[probe] < key));
}

// role of a contribution: 0 h (+gu), 1 t (-gu), 2 nh (+gv), 3 nt (-gv),
// 4 r (gu + gv)
template <typename T, bool kL2>
__global__ void __launch_bounds__(kThreads)
transe_score_bwd_kernel(const T* __restrict__ ent, const T* __restrict__ rel,
                        const int* __restrict__ idx, int64_t n,
                        int64_t per_worker, int64_t ent_ws, int64_t rel_ws,
                        int k, const float* __restrict__ g,
                        const float* __restrict__ loss,
                        const float* __restrict__ d_pos,
                        const float* __restrict__ d_neg,
                        const int* __restrict__ ent_rows,
                        const int* __restrict__ ent_perm,
                        const int* __restrict__ rel_rows,
                        const int* __restrict__ rel_perm,
                        int64_t ent_out_rows, int64_t rel_out_rows,
                        int64_t ent_rpw, int64_t rel_rpw,
                        T* __restrict__ d_ent, T* __restrict__ d_rel) {
  const int lane = threadIdx.x & 31;
  const int64_t wid = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int64_t ent_warps = (ent_out_rows + ent_rpw - 1) / ent_rpw;
  if (wid >= ent_warps + (rel_out_rows + rel_rpw - 1) / rel_rpw) return;
  const bool is_rel = wid >= ent_warps;   // warp-uniform from here on
  const int* rows = is_rel ? rel_rows : ent_rows;
  const int* perm = is_rel ? rel_perm : ent_perm;
  const int64_t len = is_rel ? n : 4 * n;
  const int64_t rpw = is_rel ? rel_rpw : ent_rpw;
  const int64_t row0 = (is_rel ? wid - ent_warps : wid) * rpw;
  const int64_t out_rows = is_rel ? rel_out_rows : ent_out_rows;
  const int64_t row_end = row0 + rpw < out_rows ? row0 + rpw : out_rows;
  T* const out_base = is_rel ? d_rel : d_ent;

  int64_t q = warp_lower_bound(rows, len, row0, lane);
  for (int64_t row = row0; row < row_end; ++row) {
    float acc[kMaxColsPerLane];
#pragma unroll
    for (int c = 0; c < kMaxColsPerLane; ++c) acc[c] = 0.f;
    for (; q < len && rows[q] == row; ++q) {
      const int64_t cid = perm[q];
      const int role = is_rel ? 4 : (int)(cid / n);
      const int64_t tri = is_rel ? cid : cid - (int64_t)role * n;
      const int* ti = idx + tri * 5;
      const int64_t w = tri / per_worker;
      const T* eb = ent + w * ent_ws;
      const T* rb = rel + w * rel_ws;
      const float scale = __fmul_rn(g[tri], loss[tri] > 0.f ? 1.f : 0.f);
      const bool need_u = role == 0 || role == 1 || role == 4;
      const bool need_v = role >= 2;
      const float den_u = kL2 ? __fadd_rn(d_pos[tri], 1e-12f) : 0.f;
      const float den_v = kL2 ? __fadd_rn(d_neg[tri], 1e-12f) : 0.f;
#pragma unroll
      for (int c = 0; c < kMaxColsPerLane; ++c) {
        const int j = lane + 32 * c;
        if (j < k) {
          const float r = to_f32(rb[(int64_t)ti[1] * k + j]);
          float gu = 0.f, gv = 0.f;
          if (need_u) {
            const float u = __fsub_rn(
                __fadd_rn(to_f32(eb[(int64_t)ti[0] * k + j]), r),
                to_f32(eb[(int64_t)ti[2] * k + j]));
            gu = __fmul_rn(kL2 ? __fdiv_rn(u, den_u) : sgn(u), scale);
          }
          if (need_v) {
            const float v = __fsub_rn(
                __fadd_rn(to_f32(eb[(int64_t)ti[3] * k + j]), r),
                to_f32(eb[(int64_t)ti[4] * k + j]));
            gv = __fmul_rn(-(kL2 ? __fdiv_rn(v, den_v) : sgn(v)), scale);
          }
          float val;
          switch (role) {
            case 0: val = gu; break;
            case 1: val = -gu; break;
            case 2: val = gv; break;
            case 3: val = -gv; break;
            default: val = __fadd_rn(gu, gv); break;
          }
          acc[c] = __fadd_rn(acc[c], val);
        }
      }
    }
    T* out = out_base + row * k;
#pragma unroll
    for (int c = 0; c < kMaxColsPerLane; ++c) {
      const int j = lane + 32 * c;
      if (j < k) store(out + j, acc[c]);
    }
  }
}

// Gradient rows per warp: about one contribution per warp on average, so
// clamp(rows / contributions, 1, kMaxRowsPerWarp).
int64_t rows_per_warp(int64_t out_rows, int64_t contributions) {
  const int64_t r = out_rows / contributions;
  return r < 1 ? 1 : (r > kMaxRowsPerWarp ? kMaxRowsPerWarp : r);
}

}  // namespace

// loss, d_pos, d_neg: (n,) fp32.  idx: (n, 5) int32, worker w = i / per_worker
// owns triplet i.  dtype: 0 = fp32, 1 = bf16; norm: 0 = L1, 1 = L2.
extern "C" int transe_score_fwd_launch(
    const void* ent, const void* rel, const void* idx, void* loss,
    void* d_pos, void* d_neg, long long n, long long per_worker,
    long long ent_ws, long long rel_ws, int k, int dtype, int norm,
    float margin, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (k <= 0 || per_worker <= 0 || (dtype != 0 && dtype != 1) ||
      (norm != 0 && norm != 1))
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  float* l = static_cast<float*>(loss);
  float* dp = static_cast<float*>(d_pos);
  float* dn = static_cast<float*>(d_neg);
#define FWD(T, L2)                                                          \
  transe_score_fwd_kernel<T, L2><<<(unsigned)blocks, kThreads, 0, s>>>(     \
      static_cast<const T*>(ent), static_cast<const T*>(rel), ix, n,        \
      per_worker, ent_ws, rel_ws, k, margin, l, dp, dn)
  if (dtype == 0) {
    if (norm == 0) FWD(float, false); else FWD(float, true);
  } else {
    if (norm == 0) FWD(__nv_bfloat16, false); else FWD(__nv_bfloat16, true);
  }
#undef FWD
  return (int)cudaGetLastError();
}

// g, loss, d_pos, d_neg: (n,) fp32.  ent_rows / ent_perm: (4n,) int32, the
// stably sorted entity scatter rows and, for each, its contribution id
// role * n + i; rel_rows / rel_perm: (n,) int32, the same for relations
// (contribution id i).  d_ent / d_rel: dense, ent_out_rows / rel_out_rows
// rows of k values in the tables' type, every one written here (the
// caller need not initialise them).  k <= 256.
extern "C" int transe_score_bwd_launch(
    const void* ent, const void* rel, const void* idx, const void* g,
    const void* loss, const void* d_pos, const void* d_neg,
    const void* ent_rows, const void* ent_perm, const void* rel_rows,
    const void* rel_perm, void* d_ent, void* d_rel, long long n,
    long long per_worker, long long ent_ws, long long rel_ws,
    long long ent_out_rows, long long rel_out_rows, int k, int dtype,
    int norm, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (k <= 0 || k > 32 * kMaxColsPerLane || per_worker <= 0 ||
      ent_out_rows <= 0 || rel_out_rows <= 0 ||
      (dtype != 0 && dtype != 1) || (norm != 0 && norm != 1))
    return (int)cudaErrorInvalidValue;
  const int64_t ent_rpw = rows_per_warp(ent_out_rows, 4 * n);
  const int64_t rel_rpw = rows_per_warp(rel_out_rows, n);
  const int64_t warps = (ent_out_rows + ent_rpw - 1) / ent_rpw +
                        (rel_out_rows + rel_rpw - 1) / rel_rpw;
  const int64_t blocks = (warps + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BWD(T, L2)                                                          \
  transe_score_bwd_kernel<T, L2><<<(unsigned)blocks, kThreads, 0, s>>>(     \
      static_cast<const T*>(ent), static_cast<const T*>(rel),               \
      static_cast<const int*>(idx), n, per_worker, ent_ws, rel_ws, k,       \
      static_cast<const float*>(g), static_cast<const float*>(loss),        \
      static_cast<const float*>(d_pos), static_cast<const float*>(d_neg),   \
      static_cast<const int*>(ent_rows), static_cast<const int*>(ent_perm), \
      static_cast<const int*>(rel_rows), static_cast<const int*>(rel_perm), \
      ent_out_rows, rel_out_rows, ent_rpw, rel_rpw,                         \
      static_cast<T*>(d_ent), static_cast<T*>(d_rel))
  if (dtype == 0) {
    if (norm == 0) BWD(float, false); else BWD(float, true);
  } else {
    if (norm == 0) BWD(__nv_bfloat16, false); else BWD(__nv_bfloat16, true);
  }
#undef BWD
  return (int)cudaGetLastError();
}

// The message of a CUDA error code, for the wrapper's exception.
extern "C" const char* transe_score_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
