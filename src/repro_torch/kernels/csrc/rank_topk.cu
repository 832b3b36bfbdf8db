// Entity-inference rank counts on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rank_topk.py::rank_counts.
// For each query row q_b (h + r for the tail side, t - r for the head side)
// it counts the table rows e strictly closer than gold_d[b]:
//   L1:  sum_j |q_j - e_j|
//   L2:  sqrt(max(qq - 2 qe + ee, 0) + 1e-12)   (the Pallas kernel's form)
// rank = 1 + count.  Inputs are fp32 or bf16 (both operands the same type);
// all arithmetic is fp32.
//
// What bounds it on an H100: operations.  The sweep does about 2·B·E·k fp32
// operations on (B + E)·k input elements, so at the evaluation chunk
// (B = 256, k = 50) it does ~128 operations per byte read, far above the
// card's fp32 ridge (67 TFLOP/s over 3.35 TB/s, ~20 per byte).  The design
// keeps the arithmetic fed from on-chip memory:
//   * a block stages a tile of TB = 64 queries in shared memory once, then
//     streams tiles of TE = 128 table rows through shared memory, so each
//     table element read from device memory serves 64 queries;
//   * each of the 256 threads holds a 4 x 8 register tile of distances, so
//     one shared-memory load feeds 8 (query) or 4 (table) operations;
//   * rows are stored with an odd stride (k | 1) so the 16 table rows a
//     half-warp reads sit in 16 different banks;
//   * blocks run over (entity-tile range, query tile) in parallel; nothing
//     carries across blocks.  The TPU kernel's revisiting accumulator over
//     its sequential entity axis becomes a warp-shuffle sum and one integer
//     atomicAdd per query per block.  Integer sums do not depend on order,
//     so the counts are deterministic.
// Sums run over j = 0 .. k-1 in order with __fadd_rn / __fmul_rn, which
// nvcc never contracts into FMAs: the same operations, in the same order,
// as the plain version kernels/ref.py::rank_counts_ref, so on the card the
// two give equal counts, not merely close ones.  Ragged edges are masked in
// the kernel (no padded copy of the table).  Still to do for speed: the L2
// contraction on the tensor cores (wgmma) and TMA-fed pipelined tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;        // 16 x 16
constexpr int kTB = 64;              // query rows per block
constexpr int kTE = 128;             // table rows per tile
constexpr int kRQ = kTB / 16;        // query rows per thread
constexpr int kRE = kTE / 16;        // table rows per thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Rows [row0, row0 + rows) of a row-major (n, k) matrix into shared memory
// as fp32 with row stride ks; rows at or past n read as zero.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      int64_t row0, int rows, int64_t n,
                                      int k, int ks) {
  const int64_t base = row0 * k;
  const int64_t limit = n * k;
  for (int i = threadIdx.x; i < rows * k; i += kThreads) {
    const int r = i / k;
    const int c = i - r * k;
    dst[r * ks + c] = base + i < limit ? to_f32(src[base + i]) : 0.f;
  }
}

template <typename T, bool kL2>
__global__ void __launch_bounds__(kThreads)
rank_counts_kernel(const T* __restrict__ q, const T* __restrict__ table,
                   const float* __restrict__ gold, int* __restrict__ counts,
                   int B, int E, int k) {
  extern __shared__ float smem[];
  const int ks = k | 1;
  float* qs = smem;                  // kTB x ks
  float* es = smem + kTB * ks;       // kTE x ks
  const int tx = threadIdx.x & 15;   // table-row lane
  const int ty = threadIdx.x >> 4;   // query-row lane
  const int64_t b0 = (int64_t)blockIdx.y * kTB;

  stage(qs, q, b0, kTB, B, k, ks);
  __syncthreads();

  float g[kRQ], qq[kRQ];
  int cnt[kRQ];
#pragma unroll
  for (int i = 0; i < kRQ; ++i) {
    const int64_t b = b0 + ty + 16 * i;
    g[i] = b < B ? gold[b] : 0.f;
    cnt[i] = 0;
    qq[i] = 0.f;
    if (kL2) {
      const float* row = qs + (ty + 16 * i) * ks;
      for (int j = 0; j < k; ++j) qq[i] = __fadd_rn(qq[i], __fmul_rn(row[j], row[j]));
    }
  }

  const int n_tiles = (E + kTE - 1) / kTE;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t e0 = (int64_t)tile * kTE;
    __syncthreads();                 // the previous tile's reads are done
    stage(es, table, e0, kTE, E, k, ks);
    __syncthreads();

    float acc[kRQ][kRE];
    float ee[kRE];
#pragma unroll
    for (int c = 0; c < kRE; ++c) {
      ee[c] = 0.f;
#pragma unroll
      for (int i = 0; i < kRQ; ++i) acc[i][c] = 0.f;
    }
    for (int j = 0; j < k; ++j) {
      float qv[kRQ], ev[kRE];
#pragma unroll
      for (int i = 0; i < kRQ; ++i) qv[i] = qs[(ty + 16 * i) * ks + j];
#pragma unroll
      for (int c = 0; c < kRE; ++c) ev[c] = es[(tx + 16 * c) * ks + j];
#pragma unroll
      for (int i = 0; i < kRQ; ++i) {
#pragma unroll
        for (int c = 0; c < kRE; ++c) {
          if (kL2) {
            acc[i][c] = __fadd_rn(acc[i][c], __fmul_rn(qv[i], ev[c]));
          } else {
            acc[i][c] = __fadd_rn(acc[i][c], fabsf(__fsub_rn(qv[i], ev[c])));
          }
        }
      }
      if (kL2) {
#pragma unroll
        for (int c = 0; c < kRE; ++c) ee[c] = __fadd_rn(ee[c], __fmul_rn(ev[c], ev[c]));
      }
    }

#pragma unroll
    for (int c = 0; c < kRE; ++c) {
      const bool live = e0 + tx + 16 * c < E;
#pragma unroll
      for (int i = 0; i < kRQ; ++i) {
        float d = acc[i][c];
        if (kL2) {
          const float d2 = __fadd_rn(__fsub_rn(qq[i], __fmul_rn(2.f, d)), ee[c]);
          d = __fsqrt_rn(__fadd_rn(fmaxf(d2, 0.f), 1e-12f));
        }
        cnt[i] += (live && d < g[i]) ? 1 : 0;
      }
    }
  }

  // the 16 threads sharing ty are 16 consecutive lanes of one warp
#pragma unroll
  for (int i = 0; i < kRQ; ++i) {
    int c = cnt[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) c += __shfl_xor_sync(0xffffffffu, c, off);
    const int64_t b = b0 + ty + 16 * i;
    if (tx == 0 && b < B && c != 0) atomicAdd(counts + b, c);
  }
}

template <typename T, bool kL2>
cudaError_t launch(const void* q, const void* table, const float* gold,
                   int* counts, int B, int E, int k, cudaStream_t stream) {
  const size_t smem = (size_t)(kTB + kTE) * (k | 1) * sizeof(float);
  auto kernel = rank_counts_kernel<T, kL2>;
  cudaError_t err;
  if (smem > 48 * 1024) {            // above 48 KB only when opted in
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int q_tiles = (B + kTB - 1) / kTB;
  const int e_tiles = (E + kTE - 1) / kTE;
  // about four blocks per SM in all; each block strides over entity tiles
  int e_blocks = (4 * sms + q_tiles - 1) / q_tiles;
  if (e_blocks < 1) e_blocks = 1;
  if (e_blocks > e_tiles) e_blocks = e_tiles;
  const dim3 grid(e_blocks, q_tiles);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(table), gold, counts,
      B, E, k);
  return cudaGetLastError();
}

}  // namespace

// counts (B,) int32 must be zeroed by the caller; the kernel adds to it.
// dtype: 0 = fp32, 1 = bf16 (queries and table alike); norm: 0 = L1, 1 = L2.
extern "C" int rank_counts_launch(const void* q, const void* table,
                                  const void* gold, void* counts, int B,
                                  int E, int k, int dtype, int norm,
                                  void* stream) {
  if (B <= 0 || E <= 0) return (int)cudaSuccess;
  if (k <= 0 || (dtype != 0 && dtype != 1) || (norm != 0 && norm != 1))
    return (int)cudaErrorInvalidValue;
  const float* g = static_cast<const float*>(gold);
  int* out = static_cast<int*>(counts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = norm == 0 ? launch<float, false>(q, table, g, out, B, E, k, s)
                    : launch<float, true>(q, table, g, out, B, E, k, s);
  } else {
    err = norm == 0 ? launch<__nv_bfloat16, false>(q, table, g, out, B, E, k, s)
                    : launch<__nv_bfloat16, true>(q, table, g, out, B, E, k, s);
  }
  return (int)err;
}

// The message of a CUDA error code, for the wrapper's exception.
extern "C" const char* rank_counts_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
