// Fused L2 scan with a per-bucket running max on Hopper's tensor cores
// (sm_90a).
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
// Bound on an H100 SXM, Q = 256, N = 1,048,576, d = 512: 2*Q*N*d = 2.7e11
// operations. f32 on the tensor cores as 3xTF32 is three tf32 products each,
// 8.2e11 at 495 TFLOP/s = 1.67 ms (below the 4.1 ms of f32 FMA at 67
// TFLOP/s); bf16 2.7e11 at 989 TFLOP/s = 0.27 ms, under the 0.32 ms that its
// 1.07 GB of rows take at 3.35 TB/s. Q = 1 is bound by the rows' bytes
// (0.64 ms f32).
//
// Design (csrc/hopper_mma.cuh holds the shared pipeline):
//   * Rows as M, queries as N. A block owns a bucket range [b0, b0 + 128)
//     and a tile of N queries (N = 8, 32, 64 or 128: Q = 1 pads to 8), and
//     walks the rows g * NB + b0 .. g * NB + b0 + 127 of its split's groups
//     g in increasing g. Those 128 rows are contiguous, so each depth slice
//     is one 2-D TMA box, and accumulator element (m, n) belongs to the one
//     slot (query n, bucket b0 + m) for the whole walk.
//   * The running max of a slot lives in a register of the thread that owns
//     the accumulator element: the strict-`>` fold is a compare in
//     registers, in row order by construction, with no shared
//     read-modify-write between threads. On an improvement the thread writes
//     the group's offset in its split (16 bits) to its own cell of a shared
//     slab, so a slot costs one register; the row is rebuilt at the end.
//   * bf16 corpora: wgmma bf16 x bf16 -> f32. f32 corpora: 3xTF32 (the
//     header of hopper_mma.cuh gives the error it leaves; the plain twin
//     stays full f32).
//   * A ring of 3 (f32) or 4 (bf16) TMA stages with mbarriers, filled by a
//     producer warp ahead of the two consumer warpgroups. A corpus whose
//     base or row stride is not a multiple of 16 bytes takes the producer's
//     element-wise copy into the same layout, still on the tensor cores.
//   * grid = (query tiles) x (NB / 128 bucket ranges) x (splits of the
//     groups); the query tiles of one row range are neighbours in launch
//     order, so the corpus comes from device memory about once. A second
//     kernel merges the per-split buffers in split (= row) order with the
//     same strict `>`, so the result equals the sequential fold.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC; bound with ctypes (tpuvdb_torch/kernels/scan.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

#include "device_guard.cuh"  // DeviceGuard
#include "hopper_mma.cuh"

namespace {

using hop::kBlockRows;
using hop::Layout;

constexpr float kNegInf = -FLT_MAX;  // finfo(float32).min, as the reference

// Walk of a block: the 128-row blocks g * nb + b0, g in [g0, g1).
struct ScanWalk {
  int g, g1, nb, b0, g0;
  __device__ __forceinline__ bool next(int* row0, int* aux0, int* aux1) {
    if (g >= g1) return false;
    *row0 = g * nb + b0;
    *aux0 = g - g0;
    *aux1 = 0;
    ++g;
    return true;
  }
};

// The fold: per accumulator element, its slot's running max in a register
// and the group reaching it in the shared slab.
template <int N>
struct ScanFold {
  float val[N / 2];
  uint16_t* slab;    // [kBlockRows][N]
  const float* sq;
  const float* mask;
  int n, ncols;      // rows of the corpus; live query columns of the tile

  __device__ __forceinline__ void operator()(const float (&acc)[N / 2],
                                             int4 block) {
    const int t = threadIdx.x % 128;
    const int r_lo = (threadIdx.x / 128) * 64 + (t / 32) * 16 + (t % 32) / 4;
    float sq_r[2], mask_r[2];
    bool live[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = block.x + r_lo + 8 * h;
      live[h] = row < n;
      sq_r[h] = live[h] ? __ldg(sq + row) : 0.f;
      mask_r[h] = live[h] ? __ldg(mask + row) : 0.f;
    }
    const uint16_t g = static_cast<uint16_t>(block.y);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const int h = (i % 4) / 2;
      const int col = 8 * (i / 4) + 2 * (t % 4) + (i % 2);
      if (!live[h] || col >= ncols) continue;
      const float score =
          __fadd_rn(__fsub_rn(2.f * acc[i], sq_r[h]), mask_r[h]);
      if (score > val[i]) {
        val[i] = score;
        slab[(r_lo + 8 * h) * N + col] = g;
      }
    }
  }
};

template <typename T, int N>
__global__ void __launch_bounds__(hop::kThreads, 1)
scan_kernel(const __grid_constant__ CUtensorMap map_x,
            const __grid_constant__ CUtensorMap map_qh,
            const __grid_constant__ CUtensorMap map_ql, const T* x,
            const float* __restrict__ sq, const float* __restrict__ mask,
            float* __restrict__ out_val, int* __restrict__ out_idx, int nq,
            int n, int d, int nb, int groups_per_split, int ragged) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = hop::align1024(smem_raw);
  using L = Layout<T, N>;
  hop::init_ring<T, N>(base);

  const int q0 = blockIdx.x * N;
  const int b0 = blockIdx.y * kBlockRows;
  const int split = blockIdx.z;
  const int g0 = split * groups_per_split;
  // groups whose row g * nb + b0 exists
  const int g_rows = n > b0 ? (n - b0 + nb - 1) / nb : 0;
  const int g1 = min(g0 + groups_per_split, g_rows);

  if (threadIdx.x >= hop::kConsumers) {  // the producer warp
    ScanWalk walk{g0, g1, nb, b0, g0};
    hop::produce<T, N>(base, &map_x, &map_qh, &map_ql, x, n, d, q0,
                       ragged != 0, walk);
    return;
  }
  ScanFold<N> fold;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) fold.val[i] = kNegInf;
  fold.slab = reinterpret_cast<uint16_t*>(base + L::kEnd);
  fold.sq = sq;
  fold.mask = mask;
  fold.n = n;
  fold.ncols = min(N, nq - q0);
  hop::consume<T, N>(base, d, fold);

  // this thread's slots -> (split, query, bucket)
  const int t = threadIdx.x % 128;
  const int r_lo = (threadIdx.x / 128) * 64 + (t / 32) * 16 + (t % 32) / 4;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int rl = r_lo + 8 * ((i % 4) / 2);
    const int col = 8 * (i / 4) + 2 * (t % 4) + (i % 2);
    if (col >= fold.ncols) continue;
    const long long o =
        (static_cast<long long>(split) * nq + q0 + col) * nb + b0 + rl;
    const float v = fold.val[i];
    out_val[o] = v;
    out_idx[o] = v > kNegInf
                     ? (g0 + fold.slab[rl * N + col]) * nb + b0 + rl
                     : -1;
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

template <typename T, int N>
cudaError_t launch_tile(const void* qh, const void* ql, const T* x,
                        const float* sq, const float* mask, float* val,
                        int* idx, int nq, int d_pad, int n, int d, int nb,
                        int n_splits, int groups_per_split, int ragged,
                        cudaStream_t stream) {
  CUtensorMap map_x{}, map_qh{}, map_ql{};
  cudaError_t e;
  if (!ragged) {
    e = hop::make_map<T>(&map_x, x, n, d, d, kBlockRows);
    if (e != cudaSuccess) return e;
  }
  e = hop::make_map<T>(&map_qh, qh, nq, d_pad, d_pad, N);
  if (e != cudaSuccess) return e;
  if (Layout<T, N>::kSplit) {
    e = hop::make_map<T>(&map_ql, ql, nq, d_pad, d_pad, N);
    if (e != cudaSuccess) return e;
  }
  const size_t smem = Layout<T, N>::kEnd +
                      static_cast<size_t>(kBlockRows) * N * sizeof(uint16_t) +
                      1024;
  e = cudaFuncSetAttribute(scan_kernel<T, N>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((nq + N - 1) / N, nb / kBlockRows, n_splits);
  scan_kernel<T, N><<<grid, hop::kThreads, smem, stream>>>(
      map_x, map_qh, map_ql, x, sq, mask, val, idx, nq, n, d, nb,
      groups_per_split, ragged);
  return cudaGetLastError();
}

template <typename T>
int launch(const float* q, void* qh, void* ql, const T* x, const float* sq,
           const float* mask, float* part_val, int* part_idx, float* out_val,
           int* out_idx, int nq, int d_pad, int n, int d, int nb,
           int query_tile, int n_splits, int groups_per_split, int ragged,
           int device, cudaStream_t stream) {
  const DeviceGuard guard(device);
  cudaError_t e = guard.status();
  if (e != cudaSuccess) return e;
  if (nb % kBlockRows != 0) return cudaErrorInvalidValue;
  e = hop::prep_queries<T>(q, qh, ql, nq, d, d_pad, stream);
  if (e != cudaSuccess) return e;
  const bool direct = n_splits == 1;
  float* val = direct ? out_val : part_val;
  int* idx = direct ? out_idx : part_idx;
  switch (query_tile) {
    case 8:
      e = launch_tile<T, 8>(qh, ql, x, sq, mask, val, idx, nq, d_pad, n, d,
                            nb, n_splits, groups_per_split, ragged, stream);
      break;
    case 32:
      e = launch_tile<T, 32>(qh, ql, x, sq, mask, val, idx, nq, d_pad, n, d,
                             nb, n_splits, groups_per_split, ragged, stream);
      break;
    case 64:
      e = launch_tile<T, 64>(qh, ql, x, sq, mask, val, idx, nq, d_pad, n, d,
                             nb, n_splits, groups_per_split, ragged, stream);
      break;
    case 128:
      e = launch_tile<T, 128>(qh, ql, x, sq, mask, val, idx, nq, d_pad, n, d,
                              nb, n_splits, groups_per_split, ragged, stream);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (e != cudaSuccess || direct) return e;
  const long long count = static_cast<long long>(nq) * nb;
  const int blocks = static_cast<int>((count + 255) / 256);
  merge_splits_kernel<<<blocks, 256, 0, stream>>>(
      part_val, part_idx, out_val, out_idx, count, n_splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int tpuvdb_scan_bucket_block() { return kBlockRows; }

// q: the (nq, d) f32 queries; qh, ql: (nq, d_pad) scratch for their
// operands, d_pad a multiple of 16 bytes of the corpus type (f32: the tf32
// hi and lo parts; bf16: qh the bf16 queries, ql unused); x the (n, d)
// corpus; ragged = 1 when x's base or row stride is off 16 bytes.
int tpuvdb_scan_f32(const float* q, void* qh, void* ql, const float* x,
                    const float* sq, const float* mask, float* part_val,
                    int* part_idx, float* out_val, int* out_idx, int nq,
                    int d_pad, int n, int d, int nb, int query_tile,
                    int n_splits, int groups_per_split, int ragged,
                    int device, cudaStream_t stream) {
  return launch<float>(q, qh, ql, x, sq, mask, part_val, part_idx, out_val,
                       out_idx, nq, d_pad, n, d, nb, query_tile, n_splits,
                       groups_per_split, ragged, device, stream);
}

int tpuvdb_scan_bf16(const float* q, void* qh, void* ql, const void* x,
                     const float* sq, const float* mask, float* part_val,
                     int* part_idx, float* out_val, int* out_idx, int nq,
                     int d_pad, int n, int d, int nb, int query_tile,
                     int n_splits, int groups_per_split, int ragged,
                     int device, cudaStream_t stream) {
  return launch<__nv_bfloat16>(
      q, qh, ql, static_cast<const __nv_bfloat16*>(x), sq, mask, part_val,
      part_idx, out_val, out_idx, nq, d_pad, n, d, nb, query_tile, n_splits,
      groups_per_split, ragged, device, stream);
}

const char* tpuvdb_scan_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
