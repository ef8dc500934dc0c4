// Fused L2 scan with a per-bucket running max, for Hopper (sm_90a).
//
// Replaces tpuvdb/kernels/pallas_scan.py::_scan_kernel (launched by
// pallas_candidates). For every query q and bucket b it computes
//
//     max over rows r < N with r mod NB == b of  2*q.x_r - ||x_r||^2 + mask_r
//
// and the row reaching it, folding rows in increasing order with a strict
// `>` from (-FLT_MAX, -1): on equal scores the lowest row wins, and rows
// whose score is <= -FLT_MAX (mask_r = -FLT_MAX for dead rows) never enter.
// The (Q, N) score matrix is never written to device memory.
//
// Design (simple first; tensor cores, TMA and 3xTF32 are later work):
//   * grid = (query tiles of 16) x (corpus splits). Splits give Q = 1 enough
//     blocks for all 132 SMs; the 16 query-tile blocks of one split run side
//     by side and read the same corpus rows, so the corpus comes from device
//     memory about once and from L2 for the rest.
//   * a block walks its split in steps of 256 rows. Each step is a
//     16 x 256 x d product in f32 FMA: 16-deep slices of the query tile and
//     of the 256 rows are staged in shared memory (double-buffered through
//     registers), and each thread accumulates a 4 x 4 tile of scores.
//   * the per-(query, bucket) running max and row live in shared memory
//     (16 x NB x 8 bytes). 256 consecutive rows fall in 256 distinct buckets
//     when NB >= 256, so no two threads update one slot in a step.
//   * a second kernel merges the per-split buffers in split (= row) order
//     with the same strict `>`, so the result equals the sequential fold.
//   * bf16 corpora are widened to f32 when staged; the wrapper hands in the
//     queries already rounded to bf16, so every product is the exact
//     bf16 x bf16 product, accumulated in f32, as in the reference.
//
// Bound on an H100 SXM, Q = 256, N = 1,048,576, d = 512, f32: 2*Q*N*d =
// 2.7e11 FLOP = 4.1 ms at 67 TFLOP/s of f32 FMA outside the tensor cores;
// the corpus is 2.1 GB = 0.64 ms at 3.35 TB/s, which bounds Q = 1.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC; bound with ctypes (tpuvdb_torch/kernels/scan.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kQT = 16;   // queries per block
constexpr int kRT = 256;  // corpus rows per step
constexpr int kKT = 16;   // depth of one shared-memory stage
constexpr int kTQ = 4;    // queries per thread
constexpr int kTR = 4;    // rows per thread
constexpr float kNegInf = -FLT_MAX;  // finfo(float32).min, as the reference

static_assert(kRT == kThreads, "each thread stages one corpus row");
static_assert(kQT * kKT == kThreads, "each thread stages one query element");
static_assert((kQT / kTQ) * (kRT / kTR) == kThreads,
              "thread tiles cover the block tile");
static_assert(kTQ == 4 && kTR == 4, "the inner product reads float4 tiles");

// One kKT-deep slice of a corpus row as f32; zeros past the ragged edges.
__device__ __forceinline__ void load_slice(const float* __restrict__ x,
                                           long long row, int n, int d,
                                           int k0, bool vec, float (&v)[kKT]) {
  if (row >= n) {
#pragma unroll
    for (int j = 0; j < kKT; ++j) v[j] = 0.f;
    return;
  }
  const float* p = x + row * static_cast<long long>(d) + k0;
  if (vec && k0 + kKT <= d) {
    const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll
    for (int j = 0; j < kKT / 4; ++j) {
      const float4 t = __ldg(p4 + j);
      v[4 * j] = t.x;
      v[4 * j + 1] = t.y;
      v[4 * j + 2] = t.z;
      v[4 * j + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kKT; ++j) v[j] = (k0 + j < d) ? p[j] : 0.f;
  }
}

__device__ __forceinline__ void load_slice(const __nv_bfloat16* __restrict__ x,
                                           long long row, int n, int d,
                                           int k0, bool vec, float (&v)[kKT]) {
  if (row >= n) {
#pragma unroll
    for (int j = 0; j < kKT; ++j) v[j] = 0.f;
    return;
  }
  const __nv_bfloat16* p = x + row * static_cast<long long>(d) + k0;
  if (vec && k0 + kKT <= d) {
    const uint4* p4 = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int j = 0; j < kKT / 8; ++j) {
      const uint4 t = __ldg(p4 + j);
      const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // a bf16 is the high half of an f32: widening is a shift
        v[8 * j + 2 * e] = __uint_as_float(w[e] << 16);
        v[8 * j + 2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kKT; ++j)
      v[j] = (k0 + j < d) ? __bfloat162float(p[j]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
scan_fold_kernel(const float* __restrict__ q, const T* __restrict__ x,
                 const float* __restrict__ sq, const float* __restrict__ mask,
                 float* __restrict__ out_val, int* __restrict__ out_idx,
                 int nq, int n, int d, int nb, int tiles_per_split, bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);      // [2][kKT][kRT]
  float* qs = xs + 2 * kKT * kRT;                      // [2][kKT][kQT]
  float* run_val = qs + 2 * kKT * kQT;                 // [kQT][nb]
  int* run_idx = reinterpret_cast<int*>(run_val + kQT * nb);  // [kQT][nb]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kQT;
  const int split = blockIdx.y;
  const int n_tiles = (n + kRT - 1) / kRT;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, n_tiles);
  const int n_stages = (d + kKT - 1) / kKT;
  const int tq = tid / (kRT / kTR);  // this thread's 4 queries: tq*4 ..
  const int tr = tid % (kRT / kTR);  // this thread's 4 rows: tr*4 ..
  const int lq = tid % kQT;          // query element this thread stages
  const int lk = tid / kQT;
  const bool q_live = q0 + lq < nq;
  const float* q_row = q + static_cast<long long>(q0 + lq) * d;

  for (int i = tid; i < kQT * nb; i += kThreads) {
    run_val[i] = kNegInf;
    run_idx[i] = -1;
  }

  float xv[kKT];
  for (int t = t_begin; t < t_end; ++t) {
    const long long base = static_cast<long long>(t) * kRT;
    float acc[kTQ][kTR];
#pragma unroll
    for (int i = 0; i < kTQ; ++i)
#pragma unroll
      for (int j = 0; j < kTR; ++j) acc[i][j] = 0.f;

    load_slice(x, base + tid, n, d, 0, vec, xv);
    float qv = (q_live && lk < d) ? q_row[lk] : 0.f;
#pragma unroll
    for (int j = 0; j < kKT; ++j) xs[j * kRT + tid] = xv[j];
    qs[lk * kQT + lq] = qv;
    __syncthreads();

    for (int s = 0; s < n_stages; ++s) {
      const int buf = s & 1;
      const bool more = s + 1 < n_stages;
      if (more) {  // prefetch the next stage while this one computes
        const int k0 = (s + 1) * kKT;
        load_slice(x, base + tid, n, d, k0, vec, xv);
        qv = (q_live && k0 + lk < d) ? q_row[k0 + lk] : 0.f;
      }
      const float* xb = xs + buf * kKT * kRT;
      const float* qb = qs + buf * kKT * kQT;
#pragma unroll
      for (int kk = 0; kk < kKT; ++kk) {
        const float4 a =
            *reinterpret_cast<const float4*>(qb + kk * kQT + tq * kTQ);
        const float4 b =
            *reinterpret_cast<const float4*>(xb + kk * kRT + tr * kTR);
        const float av[kTQ] = {a.x, a.y, a.z, a.w};
        const float bv[kTR] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < kTQ; ++i)
#pragma unroll
          for (int j = 0; j < kTR; ++j)
            acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      if (more) {
        float* xn = xs + (buf ^ 1) * kKT * kRT;
#pragma unroll
        for (int j = 0; j < kKT; ++j) xn[j * kRT + tid] = xv[j];
        qs[(buf ^ 1) * kKT * kQT + lk * kQT + lq] = qv;
      }
      __syncthreads();
    }

    // fold this step's scores into the running max (strict >)
#pragma unroll
    for (int j = 0; j < kTR; ++j) {
      const long long r = base + tr * kTR + j;
      if (r >= n) continue;
      const float sq_r = __ldg(sq + r);
      const float mask_r = __ldg(mask + r);
      const int b = static_cast<int>(r % nb);
#pragma unroll
      for (int i = 0; i < kTQ; ++i) {
        const float score = 2.f * acc[i][j] - sq_r + mask_r;
        const int slot = (tq * kTQ + i) * nb + b;
        if (score > run_val[slot]) {
          run_val[slot] = score;
          run_idx[slot] = static_cast<int>(r);
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < kQT * nb; i += kThreads) {
    const int ql = i / nb;
    if (q0 + ql < nq) {
      const long long o =
          (static_cast<long long>(split) * nq + q0 + ql) * nb + (i % nb);
      out_val[o] = run_val[i];
      out_idx[o] = run_idx[i];
    }
  }
}

// Merge (n_splits, count) partial candidates in split order: strict `>`
// keeps the earlier split, i.e. the lower row, on equal scores.
__global__ void merge_splits_kernel(const float* __restrict__ part_val,
                                    const int* __restrict__ part_idx,
                                    float* __restrict__ out_val,
                                    int* __restrict__ out_idx,
                                    long long count, int n_splits) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float best = part_val[i];
  int best_row = part_idx[i];
  for (int s = 1; s < n_splits; ++s) {
    const float v = part_val[s * count + i];
    if (v > best) {
      best = v;
      best_row = part_idx[s * count + i];
    }
  }
  out_val[i] = best;
  out_idx[i] = best_row;
}

template <typename T>
int launch(const float* q, const T* x, const float* sq, const float* mask,
           float* part_val, int* part_idx, float* out_val, int* out_idx,
           int nq, int n, int d, int nb, int n_splits, int tiles_per_split,
           int vec, int device, cudaStream_t stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const size_t smem =
      static_cast<size_t>(2 * kKT * kRT + 2 * kKT * kQT) * sizeof(float) +
      static_cast<size_t>(kQT) * nb * (sizeof(float) + sizeof(int));
  e = cudaFuncSetAttribute(scan_fold_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((nq + kQT - 1) / kQT, n_splits);
  const bool direct = n_splits == 1;
  scan_fold_kernel<T><<<grid, kThreads, smem, stream>>>(
      q, x, sq, mask, direct ? out_val : part_val,
      direct ? out_idx : part_idx, nq, n, d, nb, tiles_per_split, vec != 0);
  e = cudaGetLastError();
  if (e != cudaSuccess || direct) return e;
  const long long count = static_cast<long long>(nq) * nb;
  const int blocks = static_cast<int>((count + 255) / 256);
  merge_splits_kernel<<<blocks, 256, 0, stream>>>(
      part_val, part_idx, out_val, out_idx, count, n_splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int tpuvdb_scan_rows_per_step() { return kRT; }
int tpuvdb_scan_queries_per_block() { return kQT; }

int tpuvdb_scan_f32(const float* q, const float* x, const float* sq,
                    const float* mask, float* part_val, int* part_idx,
                    float* out_val, int* out_idx, int nq, int n, int d,
                    int nb, int n_splits, int tiles_per_split, int vec,
                    int device, cudaStream_t stream) {
  return launch<float>(q, x, sq, mask, part_val, part_idx, out_val, out_idx,
                       nq, n, d, nb, n_splits, tiles_per_split, vec, device,
                       stream);
}

int tpuvdb_scan_bf16(const float* q, const void* x, const float* sq,
                     const float* mask, float* part_val, int* part_idx,
                     float* out_val, int* out_idx, int nq, int n, int d,
                     int nb, int n_splits, int tiles_per_split, int vec,
                     int device, cudaStream_t stream) {
  return launch<__nv_bfloat16>(
      q, static_cast<const __nv_bfloat16*>(x), sq, mask, part_val, part_idx,
      out_val, out_idx, nq, n, d, nb, n_splits, tiles_per_split, vec, device,
      stream);
}

const char* tpuvdb_scan_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
