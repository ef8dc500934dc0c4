// IVF probe over packed f32/bf16/int8 cells, with a per-(query, slot)
// running max, for Hopper (sm_90a).
//
// Replaces the four TPU probe kernels of tpuvdb/kernels/pallas_ivf.py:
//   _probe_kernel              (expanded form, f32/bf16 cells, launched by
//                               pallas_ivf_candidates)
//   _probe_kernel_packed       (compact form, f32/bf16 cells, launched by
//                               pallas_ivf_candidates_packed)
//   _probe_kernel_int8         (expanded form, int8 cells, launched by
//                               pallas_ivf_candidates_int8)
//   _probe_kernel_packed_int8  (compact form, int8 cells, launched by
//                               pallas_ivf_candidates_packed_int8)
//
// Both fold 128-row chunks of the packed cell array into a (QT, 128 * S)
// candidate buffer per tile of QT <= 8 queries. A chunk c lands in segment
// s(c); its row c * 128 + j in slot s(c) * 128 + j, with the score
//
//     2 * q . x - ||x||^2 + mask      (mask 0 live, -FLT_MAX dead)
//
// and the reference keeps, per slot, the first strict maximum in list order.
// The two forms differ only in where the chunk list comes from:
//   expanded  the tile's sorted list of chunk ids, with a segment per entry
//             (the chunk's rank among the tile's distinct chunks, mod S);
//   compact   the tile's sorted probed cell ids; entry g is chunk
//             min(off128[cells[g / w128]] + g % w128, n_chunks - 1) and its
//             segment is chunk mod S.
// In both, one chunk always lands in the same slots with the same scores,
// and distinct chunks first appear in ascending order (ascending ids in the
// expanded list; off128 ascends with the cell id in the compact one). So the
// sequential fold keeps, per slot, the maximum score and, among equal
// scores, the lowest row id, whatever the order or the repeats. That makes
// the fold order-free, and blocks split a tile's list freely.
//
// Design (simple first; tensor cores and TMA are later work):
//   * grid = (query tiles) x (splits of the tile's list); 128 threads, one
//     per row of a chunk. A block stages its tile's queries in shared memory
//     (zero rows past QT), then walks its entries: thread j reads row
//     chunk * 128 + j in 16-deep slices and accumulates its 8 dot products
//     in f32 FMA (bf16 rows widened exactly; queries come pre-rounded to
//     bf16, so each product is the exact bf16 x bf16 product, as the
//     reference's f32-accumulating dot).
//   * the candidate buffer lives in device memory as 64-bit keys
//     (order-preserving score bits << 32 | ~row), folded with atomicMax: the
//     largest key is the largest score and, on a tie, the lowest row. Rows
//     whose score is <= -FLT_MAX (dead rows) are skipped, as the strict `>`
//     from -FLT_MAX never lets them in; an empty slot keeps key 0, which
//     decodes to (-FLT_MAX, -1). A second kernel decodes the keys.
//   * an entry equal to the one before it (a chunk or a cell shared by the
//     tile's queries) is skipped: it would fold the same keys again.
//   * an entry that names no chunk, segment or cell of the arrays (an id out
//     of range) scores nothing, so no list reads or writes outside them.
//   * device memory, not shared memory, holds the buffer: at a wide fetch
//     (k = 1,024, compact, S = 32) a tile's buffer is 8 x 4,096 x 8 B =
//     256 KiB, more than a block's 227 KiB.
//
// Bound on an H100 SXM: each distinct chunk moves 128 * d * 4 bytes (f32)
// and costs 2 * QT * 128 * d operations; at d = 512 that is 256 KiB against
// 1 MFLOP per chunk and tile, so a probe of few tiles is bound by bytes
// (3.35 TB/s) and a probe of many tiles sharing chunks by operations
// (67 TFLOP/s f32 FMA outside the tensor cores).
//
// int8 cells (probe_fold_i8_kernel). Queries arrive quantized with one
// batch-global scale qs (a device scalar); a row carries its dequant scale
// rs. The score is
//
//     ((2 * qs) * rs) * f32(q_i8 . x_i8) - ||x||^2 + mask
//
// with the dot exact in int32 (__dp4a on 4 packed int8; |dot| <= 127^2 * d).
// The four f32 operations are written with __fmul_rn / __fsub_rn /
// __fadd_rn in that order, so nvcc contracts none of them into an FMA and
// each rounds once, as separate tensor ops do: kernel and plain twin agree
// bit for bit. Queries are staged in shared memory as packed int8x4 words;
// a thread reads its row 16 bytes at a time when d % 16 == 0 and the cell
// array is 16-byte aligned, and byte by byte otherwise. The grid, the
// entry walk, the keys and the decode are those of the f32/bf16 kernel.
// Bound: a distinct chunk moves 128 * (d + 12) bytes (codes, scale, norm,
// mask) and costs 2 * QT * 128 * d int8 operations (1,979 TOP/s on the
// tensor cores; this kernel runs them on the CUDA cores).
//
// The list walk (entry_chunk), the keys (fold_key) and their decode are in
// csrc/probe_common.cuh, shared with the IVF-PQ probe (csrc/pq_probe.cu).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC; bound with ctypes (tpuvdb_torch/kernels/ivf_probe.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

#include "probe_common.cuh"  // kRows, kMaxQT, entry_chunk, fold_key, decode

namespace {

constexpr int kKT = 16;      // depth of one register slice of a row

// One kKT-deep slice of a row as f32; zeros past d.
__device__ __forceinline__ void load_slice(const float* __restrict__ x,
                                           long long row, int d, int k0,
                                           bool vec, float (&v)[kKT]) {
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
    for (int j = 0; j < kKT; ++j) v[j] = (k0 + j < d) ? __ldg(p + j) : 0.f;
  }
}

__device__ __forceinline__ void load_slice(const __nv_bfloat16* __restrict__ x,
                                           long long row, int d, int k0,
                                           bool vec, float (&v)[kKT]) {
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

template <typename T, bool kCompact>
__global__ void __launch_bounds__(kRows)
probe_fold_kernel(const float* __restrict__ q, const T* __restrict__ x,
                  const float* __restrict__ sq, const float* __restrict__ mask,
                  const int* __restrict__ cells, const int* __restrict__ segs,
                  const int* __restrict__ off128,
                  unsigned long long* __restrict__ keys, int qt, int d,
                  int width, int w128, int n_chunks, int nlist, int n_seg,
                  int entries_per_block, bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // [kMaxQT][d_pad]
  const int d_pad = (d + kKT - 1) / kKT * kKT;
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  for (int i = tid; i < kMaxQT * d_pad; i += kRows) {
    const int qi = i / d_pad;
    const int k = i % d_pad;
    qs[i] = (qi < qt && k < d)
                ? q[static_cast<long long>(tile * qt + qi) * d + k]
                : 0.f;
  }
  __syncthreads();

  const int n_entries = kCompact ? width * w128 : width;
  const int e_begin = blockIdx.y * entries_per_block;
  const int e_end = min(e_begin + entries_per_block, n_entries);
  const int* tcells = cells + static_cast<long long>(tile) * width;
  const int* tsegs = kCompact ? nullptr
                              : segs + static_cast<long long>(tile) * width;
  const int n_slots = kRows * n_seg;
  unsigned long long* tkeys =
      keys + static_cast<long long>(tile) * qt * n_slots;

  for (int e = e_begin; e < e_end; ++e) {
    int chunk, seg;
    if (!entry_chunk<kCompact>(e, tcells, tsegs, off128, w128, n_chunks,
                               nlist, n_seg, &chunk, &seg))
      continue;
    const long long row = static_cast<long long>(chunk) * kRows + tid;

    float acc[kMaxQT];
#pragma unroll
    for (int i = 0; i < kMaxQT; ++i) acc[i] = 0.f;
    for (int k0 = 0; k0 < d; k0 += kKT) {
      float v[kKT];
      load_slice(x, row, d, k0, vec, v);
#pragma unroll
      for (int i = 0; i < kMaxQT; ++i) {
        const float* qi = qs + i * d_pad + k0;
        float a = acc[i];
#pragma unroll
        for (int j = 0; j < kKT; j += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(qi + j);
          a = fmaf(qv.x, v[j], a);
          a = fmaf(qv.y, v[j + 1], a);
          a = fmaf(qv.z, v[j + 2], a);
          a = fmaf(qv.w, v[j + 3], a);
        }
        acc[i] = a;
      }
    }

    const float sq_r = __ldg(sq + row);
    const float mask_r = __ldg(mask + row);
    const unsigned long long low = ~static_cast<unsigned int>(row);
#pragma unroll
    for (int i = 0; i < kMaxQT; ++i) {
      if (i >= qt) break;
      const float score = 2.f * acc[i] - sq_r + mask_r;
      fold_key(tkeys + static_cast<long long>(i) * n_slots + seg * kRows + tid,
               score, low);
    }
  }
}

// int8 cells: see the header. q is the quantized batch (Q_pad, d) int8,
// qscale its one f32 scale on the device, rs the per-row dequant scales.
template <bool kCompact>
__global__ void __launch_bounds__(kRows)
probe_fold_i8_kernel(const signed char* __restrict__ q,
                     const float* __restrict__ qscale,
                     const signed char* __restrict__ x,
                     const float* __restrict__ rs, const float* __restrict__ sq,
                     const float* __restrict__ mask,
                     const int* __restrict__ cells,
                     const int* __restrict__ segs,
                     const int* __restrict__ off128,
                     unsigned long long* __restrict__ keys, int qt, int d,
                     int width, int w128, int n_chunks, int nlist, int n_seg,
                     int entries_per_block, bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* qs = reinterpret_cast<int*>(smem_raw);  // [kMaxQT][words] int8x4
  const int words = (d + kKT - 1) / kKT * (kKT / 4);
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  for (int i = tid; i < kMaxQT * words; i += kRows) {
    const int qi = i / words;
    const int k = (i % words) * 4;
    unsigned int packed = 0;
    if (qi < qt) {
      const signed char* qr = q + static_cast<long long>(tile * qt + qi) * d;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k + j < d)
          packed |= static_cast<unsigned int>(
                        static_cast<unsigned char>(qr[k + j]))
                    << (8 * j);
    }
    qs[i] = static_cast<int>(packed);
  }
  __syncthreads();

  const int n_entries = kCompact ? width * w128 : width;
  const int e_begin = blockIdx.y * entries_per_block;
  const int e_end = min(e_begin + entries_per_block, n_entries);
  const int* tcells = cells + static_cast<long long>(tile) * width;
  const int* tsegs = kCompact ? nullptr
                              : segs + static_cast<long long>(tile) * width;
  const int n_slots = kRows * n_seg;
  unsigned long long* tkeys =
      keys + static_cast<long long>(tile) * qt * n_slots;
  const float two_qs = __fmul_rn(2.f, __ldg(qscale));

  for (int e = e_begin; e < e_end; ++e) {
    int chunk, seg;
    if (!entry_chunk<kCompact>(e, tcells, tsegs, off128, w128, n_chunks,
                               nlist, n_seg, &chunk, &seg))
      continue;
    const long long row = static_cast<long long>(chunk) * kRows + tid;
    const signed char* xr = x + row * static_cast<long long>(d);

    int acc[kMaxQT];
#pragma unroll
    for (int i = 0; i < kMaxQT; ++i) acc[i] = 0;
    for (int k0 = 0; k0 < d; k0 += kKT) {
      int v[kKT / 4];
      if (vec) {  // d % 16 == 0: every slice is whole and 16-byte aligned
        const int4 t = __ldg(reinterpret_cast<const int4*>(xr + k0));
        v[0] = t.x;
        v[1] = t.y;
        v[2] = t.z;
        v[3] = t.w;
      } else {
#pragma unroll
        for (int w = 0; w < kKT / 4; ++w) {
          unsigned int packed = 0;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int k = k0 + 4 * w + j;
            if (k < d)
              packed |= static_cast<unsigned int>(
                            static_cast<unsigned char>(__ldg(xr + k)))
                        << (8 * j);
          }
          v[w] = static_cast<int>(packed);
        }
      }
#pragma unroll
      for (int i = 0; i < kMaxQT; ++i) {
        const int4 qv =
            *reinterpret_cast<const int4*>(qs + i * words + k0 / 4);
        int a = acc[i];
        a = __dp4a(v[0], qv.x, a);
        a = __dp4a(v[1], qv.y, a);
        a = __dp4a(v[2], qv.z, a);
        a = __dp4a(v[3], qv.w, a);
        acc[i] = a;
      }
    }

    // ((2 qs) rs) dot - sq + mask, each operation rounded once
    const float scale = __fmul_rn(two_qs, __ldg(rs + row));
    const float sq_r = __ldg(sq + row);
    const float mask_r = __ldg(mask + row);
    const unsigned long long low = ~static_cast<unsigned int>(row);
#pragma unroll
    for (int i = 0; i < kMaxQT; ++i) {
      if (i >= qt) break;
      const float score = __fadd_rn(
          __fsub_rn(__fmul_rn(scale, __int2float_rn(acc[i])), sq_r), mask_r);
      fold_key(tkeys + static_cast<long long>(i) * n_slots + seg * kRows + tid,
               score, low);
    }
  }
}

template <typename T, bool kCompact>
int launch(const float* q, const T* x, const float* sq, const float* mask,
           const int* cells, const int* segs, const int* off128,
           unsigned long long* keys, float* val, int* idx, int tiles, int qt,
           int d, int width, int w128, int n_chunks, int nlist, int n_seg,
           int splits, int entries_per_block, int vec, int device,
           cudaStream_t stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const long long count = static_cast<long long>(tiles) * qt * kRows * n_seg;
  e = cudaMemsetAsync(keys, 0, count * sizeof(unsigned long long), stream);
  if (e != cudaSuccess) return e;
  const int d_pad = (d + kKT - 1) / kKT * kKT;
  const size_t smem = static_cast<size_t>(kMaxQT) * d_pad * sizeof(float);
  e = cudaFuncSetAttribute(probe_fold_kernel<T, kCompact>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid(tiles, splits);
  probe_fold_kernel<T, kCompact><<<grid, kRows, smem, stream>>>(
      q, x, sq, mask, cells, segs, off128, keys, qt, d, width, w128, n_chunks,
      nlist, n_seg, entries_per_block, vec != 0);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int blocks = static_cast<int>((count + 255) / 256);
  decode_kernel<<<blocks, 256, 0, stream>>>(keys, val, idx, count);
  return cudaGetLastError();
}

template <bool kCompact>
int launch_i8(const signed char* q, const float* qscale, const signed char* x,
              const float* rs, const float* sq, const float* mask,
              const int* cells, const int* segs, const int* off128,
              unsigned long long* keys, float* val, int* idx, int tiles,
              int qt, int d, int width, int w128, int n_chunks, int nlist,
              int n_seg, int splits, int entries_per_block, int vec,
              int device, cudaStream_t stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const long long count = static_cast<long long>(tiles) * qt * kRows * n_seg;
  e = cudaMemsetAsync(keys, 0, count * sizeof(unsigned long long), stream);
  if (e != cudaSuccess) return e;
  const size_t smem =
      static_cast<size_t>(kMaxQT) * ((d + kKT - 1) / kKT * kKT);
  e = cudaFuncSetAttribute(probe_fold_i8_kernel<kCompact>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid(tiles, splits);
  probe_fold_i8_kernel<kCompact><<<grid, kRows, smem, stream>>>(
      q, qscale, x, rs, sq, mask, cells, segs, off128, keys, qt, d, width,
      w128, n_chunks, nlist, n_seg, entries_per_block, vec != 0);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int blocks = static_cast<int>((count + 255) / 256);
  decode_kernel<<<blocks, 256, 0, stream>>>(keys, val, idx, count);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int tpuvdb_ivf_rows_per_chunk() { return kRows; }
int tpuvdb_ivf_max_query_tile() { return kMaxQT; }

// Expanded form: cells = chunk ids (tiles, width) sorted per tile, segs the
// segment of each entry.
int tpuvdb_ivf_expanded_f32(const float* q, const float* x, const float* sq,
                            const float* mask, const int* cells,
                            const int* segs, unsigned long long* keys,
                            float* val, int* idx, int tiles, int qt, int d,
                            int width, int n_chunks, int n_seg, int splits,
                            int entries_per_block, int vec, int device,
                            cudaStream_t stream) {
  return launch<float, false>(q, x, sq, mask, cells, segs, nullptr, keys, val,
                              idx, tiles, qt, d, width, 1, n_chunks, 0, n_seg,
                              splits, entries_per_block, vec, device, stream);
}

int tpuvdb_ivf_expanded_bf16(const float* q, const void* x, const float* sq,
                             const float* mask, const int* cells,
                             const int* segs, unsigned long long* keys,
                             float* val, int* idx, int tiles, int qt, int d,
                             int width, int n_chunks, int n_seg, int splits,
                             int entries_per_block, int vec, int device,
                             cudaStream_t stream) {
  return launch<__nv_bfloat16, false>(
      q, static_cast<const __nv_bfloat16*>(x), sq, mask, cells, segs, nullptr,
      keys, val, idx, tiles, qt, d, width, 1, n_chunks, 0, n_seg, splits,
      entries_per_block, vec, device, stream);
}

// Compact form: cells = probed cell ids (tiles, width) sorted per tile,
// off128 the per-cell start in chunks (nlist entries), w128 the scan window
// in chunks.
int tpuvdb_ivf_compact_f32(const float* q, const float* x, const float* sq,
                           const float* mask, const int* cells,
                           const int* off128, unsigned long long* keys,
                           float* val, int* idx, int tiles, int qt, int d,
                           int width, int w128, int n_chunks, int nlist,
                           int n_seg, int splits, int entries_per_block,
                           int vec, int device, cudaStream_t stream) {
  return launch<float, true>(q, x, sq, mask, cells, nullptr, off128, keys, val,
                             idx, tiles, qt, d, width, w128, n_chunks, nlist,
                             n_seg, splits, entries_per_block, vec, device,
                             stream);
}

int tpuvdb_ivf_compact_bf16(const float* q, const void* x, const float* sq,
                            const float* mask, const int* cells,
                            const int* off128, unsigned long long* keys,
                            float* val, int* idx, int tiles, int qt, int d,
                            int width, int w128, int n_chunks, int nlist,
                            int n_seg, int splits, int entries_per_block,
                            int vec, int device, cudaStream_t stream) {
  return launch<__nv_bfloat16, true>(
      q, static_cast<const __nv_bfloat16*>(x), sq, mask, cells, nullptr,
      off128, keys, val, idx, tiles, qt, d, width, w128, n_chunks, nlist,
      n_seg, splits, entries_per_block, vec, device, stream);
}

// int8 cells: q the quantized queries, qscale their scale (one f32 on the
// device), rs the per-row dequant scales; the rest as the forms above.
int tpuvdb_ivf_expanded_i8(const void* q, const float* qscale, const void* x,
                           const float* rs, const float* sq,
                           const float* mask, const int* cells,
                           const int* segs, unsigned long long* keys,
                           float* val, int* idx, int tiles, int qt, int d,
                           int width, int n_chunks, int n_seg, int splits,
                           int entries_per_block, int vec, int device,
                           cudaStream_t stream) {
  return launch_i8<false>(static_cast<const signed char*>(q), qscale,
                          static_cast<const signed char*>(x), rs, sq, mask,
                          cells, segs, nullptr, keys, val, idx, tiles, qt, d,
                          width, 1, n_chunks, 0, n_seg, splits,
                          entries_per_block, vec, device, stream);
}

int tpuvdb_ivf_compact_i8(const void* q, const float* qscale, const void* x,
                          const float* rs, const float* sq, const float* mask,
                          const int* cells, const int* off128,
                          unsigned long long* keys, float* val, int* idx,
                          int tiles, int qt, int d, int width, int w128,
                          int n_chunks, int nlist, int n_seg, int splits,
                          int entries_per_block, int vec, int device,
                          cudaStream_t stream) {
  return launch_i8<true>(static_cast<const signed char*>(q), qscale,
                         static_cast<const signed char*>(x), rs, sq, mask,
                         cells, nullptr, off128, keys, val, idx, tiles, qt, d,
                         width, w128, n_chunks, nlist, n_seg, splits,
                         entries_per_block, vec, device, stream);
}

const char* tpuvdb_ivf_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
