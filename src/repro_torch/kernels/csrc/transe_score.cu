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
// What bounds it on an H100: bytes, gathered.  The forward reads five
// k-rows per triplet and writes three floats, about 0.2 operations per
// byte at k = 50, far under the card's fp32 ridge (~20 per byte); the
// backward also writes every row of the dense gradient.  The rows are
// gathered at random, so the designs below are about keeping many
// independent loads in flight: no load waits on another that it need not.
//
// Exactness.  Sums run over j = 0 .. k-1 in order with __fadd_rn /
// __fmul_rn / __fdiv_rn / __fsqrt_rn (and --fmad=false), the operations of
// the plain version kernels/ref.py (transe_score_ref, transe_score_bwd_ref)
// in the same order, so on the card the two agree bitwise; a warp-tree
// reduction would not.
//
// Forward: a block takes tiles of `tile` triplets, tile = ceil(n / SMs) up
// to 32, so a training step (1,024 triplets) spreads over every SM; the
// grid is the SM count times the blocks an SM holds at once, each block
// walking tiles.  Per tile: the block's threads load the tile's 5 * tile
// ids into shared memory, coalesced, as each row's element offset (worker
// stride included); the (triplet, column) grid is spread over all 256
// threads, each loading V columns of the five rows at once (V elements of
// 16 bytes or less, as the rows' alignment allows; V = 1 otherwise, e.g.
// bf16 rows at odd k) and staging u and v in shared memory; then two
// threads per triplet sum u and v over j in order.
//
// Backward: no float atomics, whose order changes from run to run.  Two
// launches, the plain version's two stages.  Phase 1, per triplet, writes
// gu and gv once into an fp32 (n, 2, k) scratch, with the forward's tiles
// and vector loads.  Phase 2, per gradient row, adds the contributions in
// order: the wrapper sorts the scatter rows stably (entity contributions in
// the order [h..., t..., nh..., nt...] over all triplets, relation
// contributions in triplet order), and a warp owns up to 32 consecutive
// rows of the dense gradient, about 128 contributions' worth; the
// relation rows' warps come first, as their runs are the long ones.  The
// warp finds its first row's run with a 32-way search, then walks its
// rows' contributions 32 at a time: the lanes read 32 sorted rows and
// contribution ids at once (the next 32 loaded ahead), then the scratch
// rows of 16 / C contributions are loaded, all in flight, before their
// in-order adds into per-lane column accumulators (lane j holds columns
// j, j + 32, ...; C per lane).  A contribution is one scratch row (+-gu or
// +-gv) or, for a relation, two (gu + gv).  Every row is written once,
// exactly +0.0 where no triplet references it, so the gradient needs no
// zero-fill.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

namespace {

constexpr int kTileThreads = 256;          // threads of a tiled block
constexpr int kMaxTile = 32;               // triplets per tile
constexpr int kSmemBudget = 48 * 1024;     // static + dynamic, no opt-in
constexpr int kWarps = 4;                  // warps per phase-2 block
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxColsPerLane = 8;         // k <= 256 in phase 2
constexpr int64_t kMaxRowsPerWarp = 32;    // gradient rows per warp
constexpr int64_t kWarpContributions = 128;  // 4 passes of 32 lanes
constexpr unsigned kFull = 0xffffffffu;

// What a launch reads and writes.  The forward writes loss / d_pos /
// d_neg; the backward reads them.
struct Batch {
  const void* ent;
  const void* rel;
  const int* idx;
  int64_t n, per_worker, ent_ws, rel_ws;
  int k, tile;
  float margin;
  float* loss;
  float* d_pos;
  float* d_neg;
  const float* g;                          // backward: upstream gradient
  float* grads;                            // backward: (n, 2, k) gu, gv
};

// What phase 2 reads and writes: the sorted scatter rows and their
// contribution ids (role * n + i for entities, i for relations).
struct Scatter {
  const float* grads;
  const int* ent_rows;
  const int* ent_perm;
  const int* rel_rows;
  const int* rel_perm;
  int64_t ent_out_rows, rel_out_rows, ent_rpw, rel_rpw;
  int n, k;
  void* d_ent;
  void* d_rel;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// V consecutive elements, read with one load
template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T x[V];
};

template <typename T, int V>
__device__ __forceinline__ Vec<T, V> load_vec(const T* p) {
  return *reinterpret_cast<const Vec<T, V>*>(p);
}

// sign(x) as (x > 0) - (x < 0): +0 at zero and at NaN, like the plain version
__device__ __forceinline__ float sgn(float x) {
  return __fsub_rn(x > 0.f ? 1.f : 0.f, x < 0.f ? 1.f : 0.f);
}

// offs[5 p + c] = the element offset of column c's row of the tile's
// triplet p, worker stride included; one coalesced pass over the ids.
__device__ __forceinline__ void load_offsets(int64_t* offs, const Batch& b,
                                             int64_t base, int m) {
  for (int t = threadIdx.x; t < 5 * m; t += blockDim.x) {
    const int p = t / 5;
    const int col = t - 5 * p;
    const int64_t w = (base + p) / b.per_worker;
    offs[t] = w * (col == 1 ? b.rel_ws : b.ent_ws) +
              (int64_t)b.idx[base * 5 + t] * b.k;
  }
}

template <typename T, bool kL2, int V>
__global__ void __launch_bounds__(kTileThreads)
transe_score_fwd_kernel(Batch b) {
  extern __shared__ float s[];             // 2 * tile rows of `stride`
  __shared__ int64_t offs[kMaxTile * 5];
  const T* ent = static_cast<const T*>(b.ent);
  const T* rel = static_cast<const T*>(b.rel);
  const int k = b.k;
  const int stride = k | 1;                // odd: the summing threads'
                                           // rows fall in distinct banks
  const int vk = k / V;
  const int64_t tiles = (b.n + b.tile - 1) / b.tile;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t base = tile * b.tile;
    const int m = b.n - base < b.tile ? (int)(b.n - base) : b.tile;
    load_offsets(offs, b, base, m);
    __syncthreads();
    for (int it = threadIdx.x; it < m * vk; it += kTileThreads) {
      const int p = it / vk;
      const int c = (it - p * vk) * V;
      const int64_t* o = offs + 5 * p;
      const Vec<T, V> h = load_vec<T, V>(ent + o[0] + c);
      const Vec<T, V> r = load_vec<T, V>(rel + o[1] + c);
      const Vec<T, V> t = load_vec<T, V>(ent + o[2] + c);
      const Vec<T, V> nh = load_vec<T, V>(ent + o[3] + c);
      const Vec<T, V> nt = load_vec<T, V>(ent + o[4] + c);
      float* su = s + (2 * p) * stride + c;
      float* sv = su + stride;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float re = to_f32(r.x[e]);
        su[e] = __fsub_rn(__fadd_rn(to_f32(h.x[e]), re), to_f32(t.x[e]));
        sv[e] = __fsub_rn(__fadd_rn(to_f32(nh.x[e]), re), to_f32(nt.x[e]));
      }
    }
    __syncthreads();
    // thread 2p sums triplet p's u, thread 2p + 1 its v
    float acc = 0.f;
    if (threadIdx.x < 2 * m) {
      const float* x = s + threadIdx.x * stride;
      for (int j = 0; j < k; ++j)
        acc = __fadd_rn(acc, kL2 ? __fmul_rn(x[j], x[j]) : fabsf(x[j]));
      if (kL2) acc = __fsqrt_rn(__fadd_rn(acc, 1e-12f));
    }
    const float dn = __shfl_xor_sync(kFull, acc, 1);
    if (threadIdx.x < 2 * m && (threadIdx.x & 1) == 0) {
      const int64_t i = base + (threadIdx.x >> 1);
      b.d_pos[i] = acc;
      b.d_neg[i] = dn;
      b.loss[i] = fmaxf(__fsub_rn(__fadd_rn(b.margin, acc), dn), 0.f);
    }
    __syncthreads();                       // s and offs are reused
  }
}

template <typename T, bool kL2, int V>
__global__ void __launch_bounds__(kTileThreads)
transe_score_bwd_grads_kernel(Batch b) {
  __shared__ int64_t offs[kMaxTile * 5];
  __shared__ float scale[kMaxTile], den_u[kMaxTile], den_v[kMaxTile];
  const T* ent = static_cast<const T*>(b.ent);
  const T* rel = static_cast<const T*>(b.rel);
  const int k = b.k;
  const int vk = k / V;
  const int64_t tiles = (b.n + b.tile - 1) / b.tile;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t base = tile * b.tile;
    const int m = b.n - base < b.tile ? (int)(b.n - base) : b.tile;
    load_offsets(offs, b, base, m);
    for (int p = threadIdx.x; p < m; p += kTileThreads) {
      const int64_t i = base + p;
      scale[p] = __fmul_rn(b.g[i], b.loss[i] > 0.f ? 1.f : 0.f);
      if (kL2) {
        den_u[p] = __fadd_rn(b.d_pos[i], 1e-12f);
        den_v[p] = __fadd_rn(b.d_neg[i], 1e-12f);
      }
    }
    __syncthreads();
    for (int it = threadIdx.x; it < m * vk; it += kTileThreads) {
      const int p = it / vk;
      const int c = (it - p * vk) * V;
      const int64_t* o = offs + 5 * p;
      const Vec<T, V> h = load_vec<T, V>(ent + o[0] + c);
      const Vec<T, V> r = load_vec<T, V>(rel + o[1] + c);
      const Vec<T, V> t = load_vec<T, V>(ent + o[2] + c);
      const Vec<T, V> nh = load_vec<T, V>(ent + o[3] + c);
      const Vec<T, V> nt = load_vec<T, V>(ent + o[4] + c);
      Vec<float, V> gu, gv;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float re = to_f32(r.x[e]);
        const float u = __fsub_rn(__fadd_rn(to_f32(h.x[e]), re),
                                  to_f32(t.x[e]));
        const float v = __fsub_rn(__fadd_rn(to_f32(nh.x[e]), re),
                                  to_f32(nt.x[e]));
        gu.x[e] = __fmul_rn(kL2 ? __fdiv_rn(u, den_u[p]) : sgn(u), scale[p]);
        gv.x[e] =
            __fmul_rn(-(kL2 ? __fdiv_rn(v, den_v[p]) : sgn(v)), scale[p]);
      }
      float* out = b.grads + (base + p) * 2 * k + c;
      *reinterpret_cast<Vec<float, V>*>(out) = gu;
      *reinterpret_cast<Vec<float, V>*>(out + k) = gv;
    }
    __syncthreads();                       // offs and the scalars are reused
  }
}

// The first position of the ascending rows[0, len) that holds a value
// >= key (len if none), searched by the 32 lanes of a warp together: each
// round the lanes probe 32 evenly spaced positions of [lo, hi) and the
// count of those below the key keeps the stretch that holds the answer;
// the last round probes every position left.  Warp-uniform.
__device__ __forceinline__ int64_t warp_lower_bound(const int* rows,
                                                    int64_t len, int64_t key,
                                                    int lane) {
  int64_t lo = 0, hi = len;                // the answer lies in [lo, hi]
  for (;;) {
    const bool last = hi - lo <= 32;       // warp-uniform
    const int64_t step = last ? 1 : (hi - lo + 31) / 32;
    const int64_t probe = lo + lane * step;
    const int below =
        __reduce_add_sync(kFull, probe < hi && rows[probe] < key ? 1 : 0);
    if (last) return lo + below;
    const int64_t next = lo + below * step;  // the first probe not below
    if (next < hi) hi = next;
    if (below > 0) lo += (below - 1) * step + 1;
  }
}

// Writes lane's columns of gradient row `row`.
template <typename T, int C>
__device__ __forceinline__ void write_row(T* out, int64_t row, int k,
                                          const float (&acc)[C], int lane) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = lane + 32 * c;
    if (j < k) store(out + row * k + j, acc[c]);
  }
}

// C columns per lane (k <= 32 C); kAhead contributions' loads in flight.
template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
transe_score_bwd_rows_kernel(Scatter a) {
  constexpr int kAhead = 16 / C;           // 2 x 16 values buffered
  const int lane = threadIdx.x & 31;
  const int64_t wid = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int64_t rel_warps = (a.rel_out_rows + a.rel_rpw - 1) / a.rel_rpw;
  if (wid >= rel_warps + (a.ent_out_rows + a.ent_rpw - 1) / a.ent_rpw)
    return;
  const bool is_rel = wid < rel_warps;     // warp-uniform from here on
  const int* rows = is_rel ? a.rel_rows : a.ent_rows;
  const int* perm = is_rel ? a.rel_perm : a.ent_perm;
  const int64_t len = is_rel ? a.n : 4 * (int64_t)a.n;
  const int64_t rpw = is_rel ? a.rel_rpw : a.ent_rpw;
  const int64_t row0 = (is_rel ? wid : wid - rel_warps) * rpw;
  const int64_t out_rows = is_rel ? a.rel_out_rows : a.ent_out_rows;
  const int64_t row_end = row0 + rpw < out_rows ? row0 + rpw : out_rows;
  T* const out = static_cast<T*>(is_rel ? a.d_rel : a.d_ent);
  const int k = a.k;

  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;
  int64_t cur = row0;                      // the row being summed
  int64_t qi = warp_lower_bound(rows, len, row0, lane) + lane;
  int my_row = qi < len ? rows[qi] : INT32_MAX;
  int my_cid = qi < len ? perm[qi] : 0;
  for (;;) {
    // 32 contributions, those of this warp's rows a prefix
    const int m = __popc(__ballot_sync(kFull, my_row < row_end));
    int next_row = INT32_MAX, next_cid = 0;
    if (m == 32) {                         // the next 32, loaded ahead
      qi += 32;
      next_row = qi < len ? rows[qi] : INT32_MAX;
      next_cid = qi < len ? perm[qi] : 0;
    }
    for (int i0 = 0; i0 < m; i0 += kAhead) {
      // kAhead contributions' scratch loads first, all in flight, then
      // their in-order adds: no arithmetic on a value between the loads
      float x0[kAhead][C], x1[kAhead][C];
      int row[kAhead];
      bool neg[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        // past m, another warp's contribution (or id 0): loaded, not added
        const int cid = __shfl_sync(kFull, my_cid, (i0 + u) & 31);
        row[u] = __shfl_sync(kFull, my_row, (i0 + u) & 31);
        const int role = is_rel ? 0 : (int)((unsigned)cid / (unsigned)a.n);
        const float* x =
            a.grads + ((int64_t)(cid - role * a.n) * 2 + (role >> 1)) * k;
        neg[u] = role & 1;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int j = lane + 32 * c;
          x0[u][c] = j < k ? x[j] : 0.f;               // gu, or gv
          x1[u][c] = is_rel && j < k ? x[k + j] : 0.f;  // a relation's gv
        }
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        if (i0 + u < m) {                  // warp-uniform
          if (row[u] != cur) {             // cur is done: write it and
            write_row(out, cur, k, acc, lane);  // the rows skipped (+0.0)
#pragma unroll
            for (int c = 0; c < C; ++c) acc[c] = 0.f;
            for (int64_t r = cur + 1; r < row[u]; ++r)
              write_row(out, r, k, acc, lane);
            cur = row[u];
          }
#pragma unroll
          for (int c = 0; c < C; ++c)
            acc[c] = __fadd_rn(acc[c], is_rel ? __fadd_rn(x0[u][c], x1[u][c])
                                       : neg[u] ? -x0[u][c] : x0[u][c]);
        }
      }
    }
    if (m < 32) break;
    my_row = next_row;
    my_cid = next_cid;
  }
  write_row(out, cur, k, acc, lane);
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;
  for (int64_t r = cur + 1; r < row_end; ++r) write_row(out, r, k, acc, lane);
}

// Gradient rows per warp: about kWarpContributions per warp on average,
// clamp(kWarpContributions * rows / contributions, 1, kMaxRowsPerWarp):
// fewer, longer walks pay the search fewer times.
int64_t rows_per_warp(int64_t out_rows, int64_t contributions) {
  const int64_t r = kWarpContributions * out_rows / contributions;
  return r < 1 ? 1 : (r > kMaxRowsPerWarp ? kMaxRowsPerWarp : r);
}

// --- host side: launch shapes ---

int sm_count() {
  static std::mutex mu;
  static std::map<int, int> cache;
  int dev = 0;
  cudaGetDevice(&dev);
  std::lock_guard<std::mutex> lock(mu);
  auto it = cache.find(dev);
  if (it != cache.end()) return it->second;
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return cache[dev] = sms > 0 ? sms : 1;
}

// Blocks of `kernel` an SM holds at once with `smem` dynamic shared bytes.
int blocks_per_sm(const void* kernel, int threads, size_t smem) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, size_t>, int> cache;
  int dev = 0;
  cudaGetDevice(&dev);
  const auto key = std::make_tuple(kernel, dev, smem);
  std::lock_guard<std::mutex> lock(mu);
  auto it = cache.find(key);
  if (it != cache.end()) return it->second;
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads,
                                                smem);
  return cache[key] = blocks > 0 ? blocks : 1;
}

// Triplets per tile: ceil(n / SMs), so a small batch still reaches every
// SM, up to `most`.
int tile_size(int64_t n, int most) {
  const int64_t t = (n + sm_count() - 1) / sm_count();
  return t < 1 ? 1 : (t > most ? most : (int)t);
}

// Blocks for `tiles` tiles: one per tile, at most as many as the card
// holds at once (the blocks then walk the tiles).
unsigned tile_grid(int64_t tiles, const void* kernel, size_t smem) {
  const int64_t most =
      (int64_t)sm_count() * blocks_per_sm(kernel, kTileThreads, smem);
  return (unsigned)(tiles < most ? tiles : most);
}

size_t fwd_smem(int tile, int k) { return sizeof(float) * 2 * tile * (k | 1); }

// The forward: u and v staged in dynamic shared memory, 2 * tile rows.
template <typename T, bool kL2, int V>
struct Forward {
  static cudaError_t run(Batch b, cudaStream_t s) {
    const int most = (kSmemBudget - (int)sizeof(int64_t) * 5 * kMaxTile) /
                     (int)fwd_smem(1, b.k);
    b.tile = tile_size(b.n, most < kMaxTile ? most : kMaxTile);
    const size_t smem = fwd_smem(b.tile, b.k);
    const unsigned grid =
        tile_grid((b.n + b.tile - 1) / b.tile,
                  (const void*)transe_score_fwd_kernel<T, kL2, V>, smem);
    transe_score_fwd_kernel<T, kL2, V><<<grid, kTileThreads, smem, s>>>(b);
    return cudaGetLastError();
  }
};

// Backward phase 1: gu, gv into b.grads.
template <typename T, bool kL2, int V>
struct Grads {
  static cudaError_t run(Batch b, cudaStream_t s) {
    b.tile = tile_size(b.n, kMaxTile);
    const unsigned grid =
        tile_grid((b.n + b.tile - 1) / b.tile,
                  (const void*)transe_score_bwd_grads_kernel<T, kL2, V>, 0);
    transe_score_bwd_grads_kernel<T, kL2, V><<<grid, kTileThreads, 0, s>>>(b);
    return cudaGetLastError();
  }
};

template <template <typename, bool, int> class Launch, typename T, bool kL2>
cudaError_t by_width(int v, const Batch& b, cudaStream_t s) {
  switch (v) {
    case 1: return Launch<T, kL2, 1>::run(b, s);
    case 2: return Launch<T, kL2, 2>::run(b, s);
    case 4: return Launch<T, kL2, 4>::run(b, s);
  }
  if constexpr (sizeof(T) == 2)
    if (v == 8) return Launch<T, kL2, 8>::run(b, s);
  return cudaErrorInvalidValue;
}

// Launch<T, kL2, V> for the tables' dtype (0 fp32, 1 bf16), the norm
// (0 L1, 1 L2) and the widest vector load the rows allow.
template <template <typename, bool, int> class Launch>
cudaError_t by_type(int dtype, int norm, const Batch& b, cudaStream_t s) {
  const int itemsize = dtype == 0 ? 4 : 2;
  int v = 16 / itemsize;             // elements per load: the most, up to
  while (v > 1 && (b.k % v != 0 ||   // 16 bytes, that divides k and keeps
                   (uintptr_t)b.ent % (v * itemsize) != 0 ||  // both tables'
                   (uintptr_t)b.rel % (v * itemsize) != 0))   // rows aligned
    v /= 2;                          // (worker strides are multiples of k)
  if (dtype == 0)
    return norm ? by_width<Launch, float, true>(v, b, s)
                : by_width<Launch, float, false>(v, b, s);
  return norm ? by_width<Launch, __nv_bfloat16, true>(v, b, s)
              : by_width<Launch, __nv_bfloat16, false>(v, b, s);
}

// Backward phase 2 with C = the fewest of 1, 2, 4, 8 columns per lane.
template <typename T>
cudaError_t scatter_launch(const Scatter& a, unsigned blocks, cudaStream_t s) {
  const int c = (a.k + 31) / 32;
  void (*kernel)(Scatter) = c <= 1   ? transe_score_bwd_rows_kernel<T, 1>
                            : c <= 2 ? transe_score_bwd_rows_kernel<T, 2>
                            : c <= 4 ? transe_score_bwd_rows_kernel<T, 4>
                                     : transe_score_bwd_rows_kernel<T, 8>;
  kernel<<<blocks, kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

bool valid(long long per_worker, int k, int dtype, int norm) {
  return k > 0 && k <= 32 * kMaxColsPerLane && per_worker > 0 &&
         (dtype == 0 || dtype == 1) && (norm == 0 || norm == 1);
}

}  // namespace

// loss, d_pos, d_neg: (n,) fp32.  idx: (n, 5) int32, worker w = i / per_worker
// owns triplet i.  dtype: 0 = fp32, 1 = bf16; norm: 0 = L1, 1 = L2.  k <= 256.
extern "C" int transe_score_fwd_launch(
    const void* ent, const void* rel, const void* idx, void* loss,
    void* d_pos, void* d_neg, long long n, long long per_worker,
    long long ent_ws, long long rel_ws, int k, int dtype, int norm,
    float margin, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (!valid(per_worker, k, dtype, norm)) return (int)cudaErrorInvalidValue;
  const Batch b{ent, rel, static_cast<const int*>(idx), n, per_worker,
                ent_ws, rel_ws, k, 0, margin, static_cast<float*>(loss),
                static_cast<float*>(d_pos), static_cast<float*>(d_neg),
                nullptr, nullptr};
  return (int)by_type<Forward>(dtype, norm, b,
                               static_cast<cudaStream_t>(stream));
}

// g, loss, d_pos, d_neg: (n,) fp32.  grads: (n, 2, k) fp32 scratch, written
// here before it is read.  ent_rows / ent_perm: (4n,) int32, the stably
// sorted entity scatter rows and, for each, its contribution id
// role * n + i; rel_rows / rel_perm: (n,) int32, the same for relations
// (contribution id i).  d_ent / d_rel: dense, ent_out_rows / rel_out_rows
// rows of k values in the tables' type, every one written here (the
// caller need not initialise them).  Two launches on `stream`.
extern "C" int transe_score_bwd_launch(
    const void* ent, const void* rel, const void* idx, const void* g,
    const void* loss, const void* d_pos, const void* d_neg, void* grads,
    const void* ent_rows, const void* ent_perm, const void* rel_rows,
    const void* rel_perm, void* d_ent, void* d_rel, long long n,
    long long per_worker, long long ent_ws, long long rel_ws,
    long long ent_out_rows, long long rel_out_rows, int k, int dtype,
    int norm, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (!valid(per_worker, k, dtype, norm) || ent_out_rows <= 0 ||
      rel_out_rows <= 0 || n > 0x7fffffffLL / 4)  // int32 contribution ids
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the forward's outputs are read only
  const Batch b{ent, rel, static_cast<const int*>(idx), n, per_worker,
                ent_ws, rel_ws, k, 0, 0.f,
                const_cast<float*>(static_cast<const float*>(loss)),
                const_cast<float*>(static_cast<const float*>(d_pos)),
                const_cast<float*>(static_cast<const float*>(d_neg)),
                static_cast<const float*>(g), static_cast<float*>(grads)};
  cudaError_t err = by_type<Grads>(dtype, norm, b, s);
  if (err != cudaSuccess) return (int)err;

  const int64_t ent_rpw = rows_per_warp(ent_out_rows, 4 * n);
  const int64_t rel_rpw = rows_per_warp(rel_out_rows, n);
  const int64_t warps = (ent_out_rows + ent_rpw - 1) / ent_rpw +
                        (rel_out_rows + rel_rpw - 1) / rel_rpw;
  const int64_t blocks = (warps + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const Scatter a{static_cast<const float*>(grads),
                  static_cast<const int*>(ent_rows),
                  static_cast<const int*>(ent_perm),
                  static_cast<const int*>(rel_rows),
                  static_cast<const int*>(rel_perm),
                  ent_out_rows, rel_out_rows, ent_rpw, rel_rpw,
                  (int)n, k, d_ent, d_rel};
  err = dtype == 0 ? scatter_launch<float>(a, (unsigned)blocks, s)
                   : scatter_launch<__nv_bfloat16>(a, (unsigned)blocks, s);
  return (int)err;
}

// The message of a CUDA error code, for the wrapper's exception.
extern "C" const char* transe_score_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
