// Entity-inference rank counts on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rank_topk.py::rank_counts.
// For each query row q_b (h + r for the tail side, t - r for the head side)
// it counts the table rows e strictly closer than gold_d[b]:
//   L1:  sum_j |q_j - e_j|
//   L2:  sqrt(max(qq - 2 qe + ee, 0) + 1e-12)   (the Pallas kernel's form)
// rank = 1 + count.  Inputs are fp32 or bf16 (both operands the same type).
// The counts equal those of the plain version kernels/ref.py::
// rank_counts_ref exactly, in every case: its sums run over j = 0 .. k-1 in
// order, one rounding per operation (built with --fmad=false).
//
// L1, the main path's norm: a sweep on the CUDA cores.  What bounds it on
// an H100 is FP32 issue slots: nothing may contract into an FMA, so every
// (query, row, j) is two instructions (FSUB, and an FADD of its absolute
// value, a free operand modifier), and a sub-partition issues one warp
// instruction a clock: 132 SMs x 128 lanes x 1.98 GHz = 33.45e12 lane-ops/s.
// Every shared-memory load, address step and branch takes a slot from the
// arithmetic, so the sweep keeps them rare:
//   * a block of 256 threads (16 x 16) owns a kTQ-query x 128-row tile; each
//     thread holds a (kTQ / 16) x 8 register tile of sums and reads two
//     consecutive j of each of its rows with one 64-bit shared load (16
//     loads per 256 FADDs at the 8 x 8 tile; its loop compiles to 279
//     instructions, 256 of them FADDs).  Shared rows are fp32 with a stride
//     of 50 words (2 mod 4), so the 16 rows a half-warp reads sit in
//     distinct bank pairs, and the row offsets are compile-time immediates;
//   * columns are staged in chunks of 50 (k = 50 is one chunk; k up to 256
//     takes up to 6, summed chunk after chunk, in order); padded columns are
//     zero, and |0 - 0| = +0 adds nothing to an in-order sum;
//   * table tiles stream through a ring of 3 stages filled with cp.async
//     (8-byte copies where k is even and both tensors 8-byte aligned, else
//     4-byte; bf16 copies 4 bytes, or loads synchronously for an odd k), so
//     tile t + 2 loads while tile t is summed.  TMA cannot load these
//     tables: a 50-wide row is 200 B (fp32) or 100 B (bf16), not a multiple
//     of 16 B.  bf16 tiles are converted to fp32 once, in shared memory;
//   * the grid is persistent: SMs x resident blocks (occupancy API, cached
//     per kernel), each block walking a contiguous range of (query tile,
//     table tile) items, so a 1e6-row table needs no launch per tile;
//   * the tile: 128 x 128 (8 x 8 a thread) where there are at least 4 tiles
//     an SM; below that (the evaluation chunk, 256 x 14,951: 234 tiles for
//     132 SMs) 64 x 128, whose finer items shorten the last wave.  Measured
//     on an H100 80GB HBM3 at 700 W (tools/bench_rank_counts.py --tiles):
//     24.8 against 27.0 us at the evaluation chunk, 20.7 against 18.5 ms
//     at 4,096 x 1e6;
//   * counts are integers: each block reduces its count per query with warp
//     shuffles and one atomicAdd per query; integer adds commute, so the
//     counts are deterministic.
//
// L2: the contraction qe on the tensor cores, with an exact re-check of
// near-ties.  The plain version counts a pair when d2 = fl(fl(qq - 2 qe) +
// ee) satisfies sqrt_rn(fl(max(d2, 0) + 1e-12)) < gold.  That is monotone in
// d2, hence in qe, so it holds exactly for d2 < T, with T the least float
// that fails it, found once per query (threshold below).  The kernel
// computes qe_tc with mma.sync (bf16: m16n8k16, products exact in fp32;
// fp32: 3xTF32 on m16n8k8, hi = tf32(x), lo = tf32(x - hi), hi.hi + hi.lo +
// lo.hi) and a margin delta with |qe_tc - qe_plain| <= delta:
//   delta = 16 k 2^-22 (1 + 2^-10) (||q|| + 2^-50) (||e|| + 2^-50).
// By Cauchy-Schwarz, sum |q_j e_j| <= ||q|| ||e||, and that sum bounds: the
// in-order fp32 sum's error (gamma_k ~ k 2^-24); the TF32 split's error and
// its dropped lo.lo term (~3 2^-22); the tensor cores' accumulation, which is
// not IEEE (truncating adds, a few 2^-23 per mma); qq and ee summed in fp32
// (the 1 + 2^-10); the 2^-50 covers products that underflow.  Together about
// (0.7 k + 7) 2^-22, under 16 k 2^-22 for every k >= 1; a wider band costs
// only re-checks, never a wrong count (kernels/rank_topk.py::
// l2_screen_margin states the same bound).  Then d2 at qe_tc - delta below T
// means the pair counts, d2 at qe_tc + delta at or above T means it does not
// (the shifted arguments rounded outwards).  Anything else is a near-tie,
// recomputed in order from the two rows as the plain version does; so is
// every pair with a NaN, which the pre-pass also puts in the margin of a row
// whose norm reaches 2^50 (there 2 qe could overflow).  d2 = fl(fl(qq - 2x) + ee) is one FFMA and one
// FADD: -2x is exact, so fma(-2, x, qq) rounds qq - 2x once, as the plain
// version's fl(qq - fl(2x)) does.
//
// The per-row work of L2 (qq, ee in order, the margins' norms, T) does not
// depend on the pairing, so a pre-pass kernel computes it once per call,
// one thread per row, into a scratch buffer the wrapper allocates; the main
// kernel copies each tile's share beside the tile.  A block of 8 warps owns
// a 128 x 128 tile (a warp 64 x 32: 4 x 4 mma tiles), with a ring of 2
// (fp32) or 3 (bf16) stages and one barrier a tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <map>
#include <mutex>
#include <tuple>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemMax = 232448;       // the 227 KB a block may opt in to

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
               "l"(src), "n"(kBytes), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

struct Args {
  const void* q;
  const void* table;
  const float* gold;
  int* counts;
  unsigned long long* rechecked;   // optional (null): L2 near-ties re-checked
  float* scratch;                  // L2: per-row sums, 3 B + 2 E floats
  int B, E, k;
  int kpad;        // k rounded up to the kernel's step: the columns summed
  int chunks;      // column chunks: ceil(kpad / chunk width)
  int copy;        // 2: two-element cp.async, 1: one-element, 0: synchronous
  int e_tiles;
  int64_t items;   // query tiles x table tiles
  float margin_k;  // 16 k 2^-22 (1 + 2^-10), rounded up (L2)
};

// Rows [r0, r0 + kRows) of a row-major (n, k) matrix, columns [c0, c0 +
// cols), into `dst` (rows of stride kStride, type T) with cp.async: one warp
// per row, lanes over the columns.  Rows at or past n and columns at or past
// k are zero-filled.  copy: 2 two-element copies, 1 one-element (fp32 only),
// 0 synchronous loads (bf16 rows that are not 4-byte aligned).
template <typename T, int kRows, int kStride>
__device__ __forceinline__ void copy_rows(T* dst, const T* src, int64_t n,
                                          int k, int copy, int64_t r0, int c0,
                                          int cols) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < kRows; r += kWarps) {
    const int64_t row = r0 + r;
    const bool live = row < n;
    const T* s = src + (live ? row * k : 0);
    T* d = dst + r * kStride;
    if (copy == 2) {
      for (int u = 2 * lane; u < cols; u += 64) {
        const bool ok = live && c0 + u < k;
        cp_async<2 * sizeof(T)>(d + u, ok ? s + c0 + u : src,
                                ok ? 2 * (int)sizeof(T) : 0);
      }
    } else if (sizeof(T) == 4 && copy == 1) {
      for (int u = lane; u < cols; u += 32) {
        const bool ok = live && c0 + u < k;
        cp_async<4>(d + u, ok ? s + c0 + u : src, ok ? 4 : 0);
      }
    } else {
      for (int u = lane; u < cols; u += 32) {
        const bool ok = live && c0 + u < k;
        d[u] = ok ? s[c0 + u] : T(0.f);
      }
    }
  }
}

// Query rows [b0, b0 + kRows) into qs, chunk after chunk (chunk ch, row r,
// column c at qs[(ch * kRows + r) * kStride + c]), with cp.async: the copies
// join the caller's next commit group.
template <typename T, int kRows, int kChunk, int kStride>
__device__ __forceinline__ void copy_queries(T* qs, const Args& a,
                                             int64_t b0) {
  for (int ch = 0; ch < a.chunks; ++ch)
    copy_rows<T, kRows, kStride>(qs + ch * kRows * kStride,
                                 static_cast<const T*>(a.q), a.B, a.k, a.copy,
                                 b0, ch * kChunk,
                                 min(kChunk, a.kpad - ch * kChunk));
}

// Items [lo, hi) of this block, split into segments of one query tile.
struct Segment {
  int qt, et0, et1;
};
__device__ __forceinline__ bool next_segment(int64_t& lo, int64_t hi,
                                             int e_tiles, Segment& s) {
  if (lo >= hi) return false;
  s.qt = (int)(lo / e_tiles);
  s.et0 = (int)(lo - (int64_t)s.qt * e_tiles);
  s.et1 = hi - lo < e_tiles - s.et0 ? s.et0 + (int)(hi - lo) : e_tiles;
  lo += s.et1 - s.et0;
  return true;
}

// ---------------------------------------------------------------- L1 sweep

constexpr int kKC = 50;                // columns per chunk = shared row stride
constexpr int kStages = 3;             // table tiles in flight
constexpr int kTE = 128;               // table rows per tile

__device__ __forceinline__ float l1_term(float acc, float x, float y) {
  return __fadd_rn(acc, fabsf(__fsub_rn(x, y)));
}

template <typename T, int kTQ>
__global__ void __launch_bounds__(kThreads, 2)
rank_counts_l1_kernel(Args a) {
  constexpr int kRQ = kTQ / 16, kRE = kTE / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);          // chunks x kTQ x kKC
  T* ring = reinterpret_cast<T*>(qs + a.chunks * kTQ * kKC);
  float* ef = reinterpret_cast<float*>(ring + kStages * kTE * kKC);  // bf16
  float* gs = sizeof(T) == 4 ? ef : ef + kTE * kKC;     // kTQ gold

  const int tx = threadIdx.x & 15;     // table-row lane
  const int ty = threadIdx.x >> 4;     // query-row lane
  const T* table = static_cast<const T*>(a.table);
  int64_t lo = a.items * blockIdx.x / gridDim.x;
  const int64_t hi = a.items * (blockIdx.x + 1) / gridDim.x;
  Segment seg;
  while (next_segment(lo, hi, a.e_tiles, seg)) {
    const int64_t b0 = (int64_t)seg.qt * kTQ;
    __syncthreads();                   // the last segment's reads are done
    if constexpr (sizeof(T) == 4) {    // fp32: straight into place, with
      copy_queries<float, kTQ, kKC, kKC>(qs, a, b0);   // the first stage
    } else {                           // bf16: through ef, to fp32
      T* raw = reinterpret_cast<T*>(ef);
      for (int ch = 0; ch < a.chunks; ++ch) {
        copy_rows<T, kTQ, kKC>(raw, static_cast<const T*>(a.q), a.B, a.k,
                               a.copy, b0, ch * kKC,
                               min(kKC, a.kpad - ch * kKC));
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        for (int i = threadIdx.x; i < kTQ * kKC; i += kThreads)
          qs[ch * kTQ * kKC + i] = to_f32(raw[i]);
        __syncthreads();
      }
    }
    for (int r = threadIdx.x; r < kTQ; r += kThreads)
      gs[r] = b0 + r < a.B ? a.gold[b0 + r] : 0.f;
    const int S = (seg.et1 - seg.et0) * a.chunks;   // stages
    auto issue = [&](int s) {
      const int et = seg.et0 + s / a.chunks, ch = s % a.chunks;
      copy_rows<T, kTE, kKC>(ring + (s % kStages) * kTE * kKC, table, a.E,
                             a.k, a.copy, (int64_t)et * kTE, ch * kKC,
                             min(kKC, a.kpad - ch * kKC));
    };
#pragma unroll
    for (int p = 0; p < kStages - 1; ++p) {
      if (p < S) issue(p);
      cp_async_commit();
    }

    int cnt[kRQ];
#pragma unroll
    for (int i = 0; i < kRQ; ++i) cnt[i] = 0;
    float acc[kRQ][kRE];
    int ch = 0, et = seg.et0;
    for (int s = 0; s < S; ++s) {
      cp_async_wait<kStages - 2>();
      __syncthreads();                 // stage s landed; stage s - 1 is free
      if (s + kStages - 1 < S) issue(s + kStages - 1);
      cp_async_commit();
      const T* tile = ring + (s % kStages) * kTE * kKC;
      const float* es;
      if constexpr (sizeof(T) == 4) {
        es = tile;
      } else {                         // bf16: to fp32 once per tile
        for (int i = threadIdx.x; i < kTE * kKC; i += kThreads)
          ef[i] = to_f32(tile[i]);
        __syncthreads();
        es = ef;
      }
      if (ch == 0) {
#pragma unroll
        for (int i = 0; i < kRQ; ++i)
#pragma unroll
          for (int c = 0; c < kRE; ++c) acc[i][c] = 0.f;
      }
      const int cols = min(kKC, a.kpad - ch * kKC);
      const float* qrow = qs + (ch * kTQ + ty) * kKC;
      const float* erow = es + tx * kKC;
      for (int j = 0; j < cols; j += 2) {
        float2 qv[kRQ], ev[kRE];
#pragma unroll
        for (int i = 0; i < kRQ; ++i)
          qv[i] = *reinterpret_cast<const float2*>(qrow + i * 16 * kKC + j);
#pragma unroll
        for (int c = 0; c < kRE; ++c)
          ev[c] = *reinterpret_cast<const float2*>(erow + c * 16 * kKC + j);
#pragma unroll
        for (int i = 0; i < kRQ; ++i)
#pragma unroll
          for (int c = 0; c < kRE; ++c)
            acc[i][c] = l1_term(l1_term(acc[i][c], qv[i].x, ev[c].x),
                                qv[i].y, ev[c].y);
      }
      if (++ch == a.chunks) {          // the tile's sums are complete
        const int64_t e0 = (int64_t)et * kTE;
#pragma unroll
        for (int i = 0; i < kRQ; ++i) {
          const float g = gs[ty + 16 * i];
#pragma unroll
          for (int c = 0; c < kRE; ++c)
            cnt[i] += (e0 + tx + 16 * c < a.E && acc[i][c] < g) ? 1 : 0;
        }
        ch = 0;
        ++et;
      }
    }
    cp_async_wait<0>();
    // the 16 threads sharing ty are 16 consecutive lanes of one warp
#pragma unroll
    for (int i = 0; i < kRQ; ++i) {
      int c = cnt[i];
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        c += __shfl_xor_sync(0xffffffffu, c, off);
      const int64_t b = b0 + ty + 16 * i;
      if (tx == 0 && b < a.B && c != 0) atomicAdd(a.counts + b, c);
    }
  }
}

template <typename T, int kTQ>
size_t l1_smem(int chunks) {
  return sizeof(float) * chunks * kTQ * kKC + sizeof(T) * kStages * kTE * kKC +
         (sizeof(T) == 4 ? 0 : sizeof(float) * kTE * kKC) +
         sizeof(float) * kTQ;
}

// ------------------------------------------------- L2 on the tensor cores

template <typename T>
struct Mma;
template <>
struct Mma<float> {                    // 3xTF32, m16n8k8
  static constexpr int kK = 8, kChunk = 56, kStride = 60, kStages = 2;
};
template <>
struct Mma<__nv_bfloat16> {            // bf16, m16n8k16
  static constexpr int kK = 16, kChunk = 64, kStride = 72, kStages = 3;
};
// Strides in 32-bit words are 4 mod 8 (60; 72 bf16 = 36 words), so the 8
// rows x 4 words of a fragment load sit in 32 distinct banks.
constexpr int kTcT = 128;              // queries and rows per block tile

// x rounded to TF32 (10 mantissa bits, to nearest, ties away from zero, as
// cvt.rna.tf32.f32 rounds), in two integer operations; low bits zero.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(__fsub_rn(x, __uint_as_float(hi)));
}
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Whether d2 fails the plain version's test against gold.
__device__ __forceinline__ bool fails(float d2, float gold) {
  return !(__fsqrt_rn(__fadd_rn(fmaxf(d2, 0.f), 1e-12f)) < gold);
}
// T, the least float d2 that fails: a pair counts exactly when d2 < T
// (fails is monotone in d2).  A binary search over the bit patterns of the
// non-negative floats, ordered as integers; -inf when even d2 <= 0 fails
// (gold <= 1e-6, or NaN), +inf when no float fails (gold = +inf).
__device__ float threshold(float gold) {
  if (fails(0.f, gold)) return -INFINITY;
  if (!fails(INFINITY, gold)) return INFINITY;
  uint32_t lo = 0, hi = 0x7f800000u;   // !fails(lo), fails(hi)
  while (hi - lo > 1) {
    const uint32_t mid = lo + (hi - lo) / 2;
    if (fails(__uint_as_float(mid), gold)) hi = mid;
    else lo = mid;
  }
  return __uint_as_float(hi);
}

// d2 = fl(fl(qq - 2x) + ee), the first rounding as one FFMA (see the top).
__device__ __forceinline__ float dist2(float qq, float x, float ee) {
  return __fadd_rn(__fmaf_rn(-2.f, x, qq), ee);
}

// ||x|| + 2^-50 rounded up, from the in-order sum of squares s; NaN from
// 2^50 up, which makes every pair of the row a near-tie: with both norms
// under 2^50, |2 qe| < 2^101 cannot overflow, and the screen's arithmetic
// is the plain version's.
__device__ __forceinline__ float norm_up(float s) {
  const float n = __fadd_ru(__fsqrt_ru(s), 0x1p-50f);
  return n < 0x1p50f ? n : NAN;
}

// The in-order sum of squares of one row of k elements.
template <typename T>
__device__ __forceinline__ float row_sq(const T* row, int k) {
  float s = 0.f;
#pragma unroll 10
  for (int j = 0; j < k; ++j) {
    const float x = to_f32(row[j]);
    s = __fadd_rn(s, __fmul_rn(x, x));
  }
  return s;
}

// The per-row pre-pass, one thread per row, into a.scratch: for each query
// qq, its margin factor margin_k (||q|| + 2^-50) and T; for each table row
// ee and ||e|| + 2^-50.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rank_counts_norms_kernel(Args a) {
  const int64_t r = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  float* s = a.scratch;
  if (r < a.B) {
    const float qq = row_sq(static_cast<const T*>(a.q) + r * a.k, a.k);
    s[r] = qq;
    s[a.B + r] = __fmul_ru(a.margin_k, norm_up(qq));
    s[2 * (int64_t)a.B + r] = threshold(a.gold[r]);
  } else if (r < (int64_t)a.B + a.E) {
    const int64_t e = r - a.B;
    const float ee = row_sq(static_cast<const T*>(a.table) + e * a.k, a.k);
    s[3 * (int64_t)a.B + e] = ee;
    s[3 * (int64_t)a.B + a.E + e] = norm_up(ee);
  }
}

// The plain version's decision for one pair, its qe summed in order.
template <typename T>
__device__ __noinline__ int recheck(const T* q, const T* e, int k, float qq,
                                    float ee, float gold) {
  float qe = 0.f;
  for (int j = 0; j < k; ++j)
    qe = __fadd_rn(qe, __fmul_rn(to_f32(q[j]), to_f32(e[j])));
  const float d2 = __fadd_rn(__fsub_rn(qq, __fmul_rn(2.f, qe)), ee);
  return __fsqrt_rn(__fadd_rn(fmaxf(d2, 0.f), 1e-12f)) < gold ? 1 : 0;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
rank_counts_l2_kernel(Args a) {
  constexpr int kChunk = Mma<T>::kChunk, kStride = Mma<T>::kStride;
  constexpr int kRing = Mma<T>::kStages;
  constexpr int kTile = kTcT * kStride;   // elements of one staged tile
  // a ring slot: the tile, then ee and ||e|| + 2^-50 of its rows
  constexpr int kSlot = kTile * sizeof(T) + 2 * kTcT * sizeof(float);
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);                   // chunks x tile
  float* qqs = reinterpret_cast<float*>(qs + a.chunks * kTile);
  float* qms = qqs + kTcT;             // margin factor per query
  float* ths = qms + kTcT;             // T per query
  unsigned char* ring = reinterpret_cast<unsigned char*>(ths + kTcT);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wq = warp >> 2;            // 2 x 64 queries
  const int we = warp & 3;             // 4 x 32 rows
  const T* table = static_cast<const T*>(a.table);
  const float* ee_all = a.scratch + 3 * (int64_t)a.B;
  const float* en_all = ee_all + a.E;
  unsigned long long rechecked = 0;
  int64_t lo = a.items * blockIdx.x / gridDim.x;
  const int64_t hi = a.items * (blockIdx.x + 1) / gridDim.x;
  Segment seg;
  while (next_segment(lo, hi, a.e_tiles, seg)) {
    const int64_t b0 = (int64_t)seg.qt * kTcT;
    const int S = (seg.et1 - seg.et0) * a.chunks;
    auto issue = [&](int s) {
      const int et = seg.et0 + s / a.chunks, ch = s % a.chunks;
      unsigned char* slot = ring + (s % kRing) * kSlot;
      const int64_t e0 = (int64_t)et * kTcT;
      copy_rows<T, kTcT, kStride>(reinterpret_cast<T*>(slot), table, a.E,
                                  a.k, a.copy, e0, ch * kChunk,
                                  min(kChunk, a.kpad - ch * kChunk));
      if (ch + 1 == a.chunks && threadIdx.x < kTcT) {
        float* es = reinterpret_cast<float*>(slot + kTile * sizeof(T));
        const int r = threadIdx.x;
        const bool live = e0 + r < a.E;
        cp_async<4>(es + r, live ? ee_all + e0 + r : ee_all, live ? 4 : 0);
        cp_async<4>(es + kTcT + r, live ? en_all + e0 + r : en_all,
                    live ? 4 : 0);
      }
    };
    __syncthreads();                   // the last segment's reads are done
    copy_queries<T, kTcT, kChunk, kStride>(qs, a, b0);
    for (int r = threadIdx.x; r < kTcT; r += kThreads) {
      const bool live = b0 + r < a.B;  // a query past B never counts
      qqs[r] = live ? a.scratch[b0 + r] : 0.f;
      qms[r] = live ? a.scratch[a.B + b0 + r] : 0.f;
      ths[r] = live ? a.scratch[2 * (int64_t)a.B + b0 + r] : -INFINITY;
    }
#pragma unroll
    for (int p = 0; p < kRing - 1; ++p) {
      if (p < S) issue(p);
      cp_async_commit();
    }

    int cnt[8];                        // queries (mt, half): 4 x 2
#pragma unroll
    for (int i = 0; i < 8; ++i) cnt[i] = 0;
    float acc[4][4][4];
    int ch = 0, et = seg.et0;
    for (int s = 0; s < S; ++s) {
      cp_async_wait<kRing - 2>();
      __syncthreads();                 // stage s landed; stage s - 1 is free
      if (s + kRing - 1 < S) issue(s + kRing - 1);
      cp_async_commit();
      const unsigned char* slot = ring + (s % kRing) * kSlot;
      const T* tile = reinterpret_cast<const T*>(slot);
      if (ch == 0) {
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[m][n][r] = 0.f;
      }
      const int cols = min(kChunk, a.kpad - ch * kChunk);
      const T* qw = qs + ch * kTile + (wq * 64) * kStride;
      const T* ew = tile + (we * 32) * kStride;
      if constexpr (sizeof(T) == 4) {
        for (int kk = 0; kk < cols; kk += 8) {
          uint32_t bh[4][2], bl[4][2];
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const float* e = ew + (n * 8 + g) * kStride + kk + t;
            split(e[0], bh[n][0], bl[n][0]);
            split(e[4], bh[n][1], bl[n][1]);
          }
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const float* q = qw + (m * 16 + g) * kStride + kk + t;
            uint32_t ah[4], al[4];
            split(q[0], ah[0], al[0]);
            split(q[8 * kStride], ah[1], al[1]);
            split(q[4], ah[2], al[2]);
            split(q[8 * kStride + 4], ah[3], al[3]);
#pragma unroll
            for (int n = 0; n < 4; ++n) {
              mma_tf32(acc[m][n], al, bh[n]);
              mma_tf32(acc[m][n], ah, bl[n]);
              mma_tf32(acc[m][n], ah, bh[n]);
            }
          }
        }
      } else {
        constexpr int kW = kStride / 2;     // row stride in 32-bit words
        const uint32_t* qw32 = reinterpret_cast<const uint32_t*>(qw);
        const uint32_t* ew32 = reinterpret_cast<const uint32_t*>(ew);
        for (int kk = 0; kk < cols; kk += 16) {
          const int kw = kk / 2 + t;
          uint32_t b[4][2];
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            b[n][0] = ew32[(n * 8 + g) * kW + kw];
            b[n][1] = ew32[(n * 8 + g) * kW + kw + 4];
          }
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const uint32_t* q = qw32 + (m * 16 + g) * kW + kw;
            const uint32_t av[4] = {q[0], q[8 * kW], q[4], q[8 * kW + 4]};
#pragma unroll
            for (int n = 0; n < 4; ++n) mma_bf16(acc[m][n], av, b[n]);
          }
        }
      }
      if (++ch < a.chunks) continue;

      // qe of the tile is complete: the screen
      ch = 0;
      const int64_t e0 = (int64_t)et++ * kTcT;
      const float* ees =
          reinterpret_cast<const float*>(slot + kTile * sizeof(T));
      const float* ens = ees + kTcT;
      float eev[4][2], env[4][2];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = we * 32 + n * 8 + 2 * t + h;
          eev[n][h] = e0 + col < a.E ? ees[col] : INFINITY;  // never counts
          env[n][h] = ens[col];
        }
      // A pair counts for every qe >= x - d and for no qe <= x + d, d >=
      // delta; anything else is a near-tie (NaN, from a poisoned margin or
      // a non-finite value, fails both tests).
      uint64_t near = 0;               // bit ((m * 2 + hq) * 4 + n) * 2 + h
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int hq = 0; hq < 2; ++hq) {
          const int row = wq * 64 + m * 16 + g + 8 * hq;
          const float qq = qqs[row], qm = qms[row], th = ths[row];
          int c = 0;
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float x = acc[m][n][2 * hq + h];
              const float d = __fmul_ru(qm, env[n][h]);
              const bool in = dist2(qq, __fsub_rd(x, d), eev[n][h]) < th;
              const bool out = dist2(qq, __fadd_ru(x, d), eev[n][h]) >= th;
              c += in ? 1 : 0;
              if (!(in || out))
                near |= 1ull << (((m * 2 + hq) * 4 + n) * 2 + h);
            }
          cnt[2 * m + hq] += c;
        }
      while (near) {                   // re-check each near-tie in order
        const int i = __ffsll(near) - 1;
        near &= near - 1;
        const int row = wq * 64 + (i >> 4) * 16 + g + 8 * ((i >> 3) & 1);
        const int col = we * 32 + ((i >> 1) & 3) * 8 + 2 * t + (i & 1);
        const int64_t b = b0 + row, e = e0 + col;
        if (b >= a.B || e >= a.E) continue;
        ++rechecked;
        const bool staged = a.chunks == 1;   // whole rows in shared memory
        if (recheck(staged ? qs + row * kStride
                           : static_cast<const T*>(a.q) + b * a.k,
                    staged ? tile + col * kStride : table + e * a.k, a.k,
                    qqs[row], ees[col], a.gold[b]))
          atomicAdd(a.counts + b, 1);
      }
    }
    cp_async_wait<0>();
    // the 4 lanes sharing g hold the same queries; the 4 warps sharing wq
    // add theirs each
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      int c = cnt[i];
      c += __shfl_xor_sync(0xffffffffu, c, 1);
      c += __shfl_xor_sync(0xffffffffu, c, 2);
      const int64_t b = b0 + wq * 64 + (i >> 1) * 16 + g + 8 * (i & 1);
      if (t == 0 && b < a.B && c != 0) atomicAdd(a.counts + b, c);
    }
  }
  if (a.rechecked != nullptr && rechecked != 0)
    atomicAdd(a.rechecked, rechecked);
}

template <typename T>
size_t l2_smem(int chunks) {
  return sizeof(T) * chunks * kTcT * Mma<T>::kStride +
         sizeof(float) * 3 * kTcT +
         Mma<T>::kStages * (sizeof(T) * kTcT * Mma<T>::kStride +
                            sizeof(float) * 2 * kTcT);
}

// --------------------------------------------------------------- host side

int sm_count(int dev) {
  static std::mutex mu;
  static std::map<int, int> cache;
  std::lock_guard<std::mutex> lock(mu);
  auto it = cache.find(dev);
  if (it != cache.end()) return it->second;
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return cache[dev] = sms > 0 ? sms : 1;
}

// Opts `kernel` in to kSmemMax dynamic shared bytes (once per device) and
// returns how many of its blocks an SM holds with `smem` bytes (cached).
int blocks_per_sm(const void* kernel, int dev, size_t smem, cudaError_t* err) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int>, bool> opted;
  static std::map<std::tuple<const void*, int, size_t>, int> cache;
  std::lock_guard<std::mutex> lock(mu);
  *err = cudaSuccess;
  const auto key = std::make_tuple(kernel, dev, smem);
  auto it = cache.find(key);
  if (it != cache.end()) return it->second;
  if (!opted[std::make_tuple(kernel, dev)]) {
    *err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (*err != cudaSuccess) return 0;
    opted[std::make_tuple(kernel, dev)] = true;
  }
  int blocks = 0;
  *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                       kThreads, smem);
  if (*err != cudaSuccess) return 0;
  return cache[key] = blocks;
}

// One call's kernels: the L2 pre-pass (or null) and the main kernel with
// its dynamic shared bytes, query tile and arguments.
struct Plan {
  const void* prepass;
  const void* kernel;
  size_t smem;
  int tq;
  Args a;
};

// 16 k 2^-22 (1 + 2^-10) as a float no smaller than the real number.
float margin_factor(int k) {
  const double m = 16.0 * k * 0x1p-22 * (1.0 + 0x1p-10);
  float f = (float)m;
  if ((double)f < m) f = nextafterf(f, 1e30f);
  return f;
}

// tq: the L1 query tile, 128 or 64; 0 picks it from the shape.
template <typename T>
Plan plan(const void* q, const void* table, const float* gold, int* counts,
          void* rechecked, void* scratch, int B, int E, int k, int norm,
          int tq, int sms) {
  Plan p{};
  Args& a = p.a;
  a.q = q; a.table = table; a.gold = gold; a.counts = counts;
  a.rechecked = static_cast<unsigned long long*>(rechecked);
  a.scratch = static_cast<float*>(scratch);
  a.B = B; a.E = E; a.k = k;
  const int step = norm == 0 ? 2 : Mma<T>::kK;
  const int chunk = norm == 0 ? kKC : Mma<T>::kChunk;
  a.kpad = (k + step - 1) / step * step;
  a.chunks = (a.kpad + chunk - 1) / chunk;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(table) |
                         reinterpret_cast<uintptr_t>(q);
  if (k % 2 == 0 && addr % (2 * sizeof(T)) == 0) a.copy = 2;
  else a.copy = sizeof(T) == 4 ? 1 : 0;
  a.margin_k = margin_factor(k);
  a.e_tiles = (E + kTE - 1) / kTE;
  if (norm == 1) {
    tq = kTcT;
    p.prepass = (const void*)rank_counts_norms_kernel<T>;
    p.kernel = (const void*)rank_counts_l2_kernel<T>;
    p.smem = l2_smem<T>(a.chunks);
  } else {
    if (tq == 0)                       // fewer than 4 tiles of 128 an SM
      tq = (int64_t)((B + 127) / 128) * a.e_tiles < 4 * (int64_t)sms ? 64
                                                                     : 128;
    p.kernel = tq == 64 ? (const void*)rank_counts_l1_kernel<T, 64>
                        : (const void*)rank_counts_l1_kernel<T, 128>;
    p.smem = tq == 64 ? l1_smem<T, 64>(a.chunks) : l1_smem<T, 128>(a.chunks);
  }
  p.tq = tq;
  a.items = (int64_t)((B + tq - 1) / tq) * a.e_tiles;
  return p;
}

Plan make_plan(const void* q, const void* table, const void* gold,
               void* counts, void* rechecked, void* scratch, int B, int E,
               int k, int dtype, int norm, int tq, int sms) {
  const float* g = static_cast<const float*>(gold);
  int* out = static_cast<int*>(counts);
  return dtype == 0 ? plan<float>(q, table, g, out, rechecked, scratch, B, E,
                                  k, norm, tq, sms)
                    : plan<__nv_bfloat16>(q, table, g, out, rechecked,
                                          scratch, B, E, k, norm, tq, sms);
}

cudaError_t launch(int B, int E, int k, int dtype, int norm, int tq,
                   const void* q, const void* table, const void* gold,
                   void* counts, void* rechecked, void* scratch,
                   cudaStream_t stream) {
  if (B <= 0 || E <= 0) return cudaSuccess;
  if (k <= 0 || (dtype != 0 && dtype != 1) || (norm != 0 && norm != 1) ||
      (norm == 1 && scratch == nullptr))
    return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const Plan p = make_plan(q, table, gold, counts, rechecked, scratch, B, E,
                           k, dtype, norm, tq, sm_count(dev));
  if (p.smem > (size_t)kSmemMax) return cudaErrorInvalidValue;
  const int per_sm = blocks_per_sm(p.kernel, dev, p.smem, &err);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  void* args[] = {const_cast<Args*>(&p.a)};
  if (p.prepass != nullptr) {
    const int64_t rows = (int64_t)B + E;
    err = cudaLaunchKernel(p.prepass,
                           dim3((unsigned)((rows + kThreads - 1) / kThreads)),
                           dim3(kThreads), args, 0, stream);
    if (err != cudaSuccess) return err;
  }
  int64_t grid = (int64_t)sm_count(dev) * per_sm;
  if (grid > p.a.items) grid = p.a.items;
  err = cudaLaunchKernel(p.kernel, dim3((unsigned)grid), dim3(kThreads), args,
                         p.smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// counts (B,) int32 must be zeroed by the caller; the kernels add to it.
// dtype: 0 = fp32, 1 = bf16 (queries and table alike); norm: 0 = L1, 1 = L2.
// rechecked: an optional uint64 counter (null on the main path) to which the
// L2 kernel adds the pairs it re-checked in order.  scratch: L2 only,
// rank_counts_scratch_floats(B, E, norm) floats that the pre-pass fills.
extern "C" int rank_counts_launch(const void* q, const void* table,
                                  const void* gold, void* counts, int B,
                                  int E, int k, int dtype, int norm,
                                  void* rechecked, void* scratch,
                                  void* stream) {
  return (int)launch(B, E, k, dtype, norm, 0, q, table, gold, counts,
                     rechecked, scratch, static_cast<cudaStream_t>(stream));
}

// The scratch floats a call needs: 3 B + 2 E for L2, none for L1.
extern "C" long long rank_counts_scratch_floats(int B, int E, int norm) {
  return norm == 1 ? 3LL * B + 2LL * E : 0;
}

// As rank_counts_launch for L1, with the query tile fixed (128 or 64): the
// tile-shape measurement of tools/bench_rank_counts.py.
extern "C" int rank_counts_launch_l1_tile(const void* q, const void* table,
                                          const void* gold, void* counts,
                                          int B, int E, int k, int dtype,
                                          int tq, void* stream) {
  if (tq != 64 && tq != 128) return (int)cudaErrorInvalidValue;
  return (int)launch(B, E, k, dtype, 0, tq, q, table, gold, counts, nullptr,
                     nullptr, static_cast<cudaStream_t>(stream));
}

// What the main kernel for (dtype, norm) at width k over B queries and E
// rows takes: out[0] registers a thread, out[1] static shared bytes, out[2]
// dynamic shared bytes, out[3] blocks an SM holds, out[4] threads a block,
// out[5] local (spill) bytes a thread, out[6] queries a tile.
extern "C" int rank_counts_info(int dtype, int norm, int k, int B, int E,
                                int* out) {
  if (k <= 0 || B <= 0 || E <= 0 || (dtype != 0 && dtype != 1) ||
      (norm != 0 && norm != 1))
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const Plan p = make_plan(nullptr, nullptr, nullptr, nullptr, nullptr,
                           nullptr, B, E, k, dtype, norm, 0, sm_count(dev));
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, p.kernel);
  if (err != cudaSuccess) return (int)err;
  const int per_sm = blocks_per_sm(p.kernel, dev, p.smem, &err);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.sharedSizeBytes;
  out[2] = (int)p.smem;
  out[3] = per_sm;
  out[4] = kThreads;
  out[5] = (int)attr.localSizeBytes;
  out[6] = p.tq;
  return 0;
}

// The message of a CUDA error code, for the wrapper's exception.
extern "C" const char* rank_counts_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
