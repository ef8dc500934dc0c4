// IVF-PQ probe: asymmetric distance computation (ADC) over packed PQ code
// cells, with a per-(query, slot) running max, for Hopper (sm_90a).
//
// Replaces the TPU kernel tpuvdb/kernels/pallas_pq.py:_pq_probe_kernel (the
// `pl.pallas_call` of pallas_pq_search, pallas_pq.py:299).
//
// Cells hold Mb code bytes per row: the residual x - c_cell quantized per
// subspace against a (M2, J, d / M2) codebook. J = 256 has one subspace per
// byte (M2 = Mb); J = 16 has two, byte b carrying subspace 2b in its low
// nibble and 2b + 1 in its high one (M2 = 2 Mb). For each tile of QT <= 8
// queries and each entry of the tile's sorted chunk list, row
// r = chunk * 128 + j scores, for query q of the tile,
//
//     sum_m LUT[q, m, code[r, m]]  +  qc2[q, cell(chunk)]  +  bias[r]
//
// with LUT[q, m, j] = 2 q_m . codebook[m, j] rounded to bf16 (as the
// reference rounds it), qc2 = 2 q . c_cell of the chunk's own cell, and
// bias = -||c + r_hat||^2, or -FLT_MAX for a dead row. It is folded into
// slot seg * 128 + j as probe_common.cuh describes: the maximum score and,
// on a tie, the lowest row.
//
// What does not carry over. The TPU body cannot gather, so it expands each
// chunk to a one-hot (128, m_block * 256) in VMEM and contracts it with the
// LUT on the MXU (2 x 16 masked dots for J = 16). Here the table is looked
// up: no one-hot, no matrix product, no m_block or cps.
//
// Design (simple first; a faster layout is later work):
//   * grid = (query of the tile, tile, split of the tile's list); 128
//     threads, one per row of a chunk. The blocks of one (tile, split) read
//     the same codes for their QT queries and are scheduled together, so
//     the codes come from device memory once and from L2 after that.
//   * a block stages its query's whole LUT in dynamic shared memory as bf16
//     bits: M2 * J * 2 bytes (32 KB at Mb = 64, 48 KB at Mb = 96 with
//     J = 256). The wrapper raises above the 227 KB a block can have.
//   * a thread reads its row's Mb bytes, 16 at a time when Mb % 16 == 0 and
//     the code array is 16-byte aligned and byte by byte otherwise, widens
//     each looked-up entry (a bf16 is the high half of an f32) and adds it
//     in subspace order. Code bytes are unsigned.
//   * the sum and the two score additions are written with __fadd_rn in a
//     fixed order (subspaces ascending from +0, then + qc2, then + bias), so
//     nvcc contracts nothing and each rounds once, as separate tensor ops
//     do: kernel and plain twin agree bit for bit.
//   * an entry equal to the one before it is skipped; an entry whose chunk,
//     segment or cell is out of range scores nothing.
//
// Bound on an H100 SXM: a distinct chunk moves 128 * (Mb + 4) bytes (codes
// and bias) over 3.35 TB/s, and costs QT * 128 * M2 lookups per tile. With
// J = 256 the table must live in shared memory, which hands out 128 bytes a
// clock and SM (32 banks of 4 bytes), 64 bf16 entries: 132 * 64 * 1.98e9 =
// 1.67e13 entries a second at the maximum SM clock nvidia-smi reports
// (clocks.max.sm, 1,980 MHz on an NVIDIA H100 80GB HBM3 at a 700 W limit).
// A table laid out [m][code][query of the tile] would serve the tile's 8
// queries from one 16-byte load and could reach that rate; this kernel
// reads one 2-byte entry a lookup, so a bank's word carries half of what it
// could, random codes put several threads of a warp on one bank, and each
// lookup is its own instruction chain. With J = 16 a subspace's table is 32
// bytes and fits in registers, so shared memory is no floor there: the
// operations are the f32 additions, one a lookup, at 128 lanes a clock and
// SM. With 64 cells of 2,048 rows probed per query the lookups bound the
// J = 256 kernel from 8 queries on. PERF.md has the measured times beside
// these bounds.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC; bound with ctypes (tpuvdb_torch/kernels/pq_probe.py).

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

#include "probe_common.cuh"  // kRows, kMaxQT, entry_chunk, fold_key, decode

namespace {

// entry i of the staged LUT, widened: a bf16 is the high half of an f32
__device__ __forceinline__ float lut_at(const unsigned short* lut_s, int i) {
  return __uint_as_float(static_cast<unsigned int>(lut_s[i]) << 16);
}

// acc + the entries that code byte `c` of byte column `b` selects
template <int kJ>
__device__ __forceinline__ float add_code(const unsigned short* lut_s, int b,
                                          unsigned int c, float acc) {
  if (kJ == 256) {
    return __fadd_rn(acc, lut_at(lut_s, b * 256 + static_cast<int>(c)));
  } else {  // two 4-bit codes: low nibble = subspace 2b, high = 2b + 1
    acc = __fadd_rn(acc,
                    lut_at(lut_s, (2 * b) * 16 + static_cast<int>(c & 15u)));
    return __fadd_rn(
        acc, lut_at(lut_s, (2 * b + 1) * 16 + static_cast<int>(c >> 4)));
  }
}

template <int kJ>
__global__ void __launch_bounds__(kRows)
pq_probe_kernel(const unsigned short* __restrict__ lut,   // (Qp, lut_w) bf16
                const float* __restrict__ qc2,            // (Qp, nlist)
                const unsigned char* __restrict__ codes,  // (N_g, mb)
                const float* __restrict__ bias,           // (N_g,)
                const int* __restrict__ cells, const int* __restrict__ segs,
                const int* __restrict__ cellof,
                unsigned long long* __restrict__ keys, int qt, int mb,
                int lut_w, int nlist, int width, int n_chunks, int n_seg,
                int entries_per_block, bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const unsigned short* lut_s =
      reinterpret_cast<const unsigned short*>(smem_raw);  // [lut_w]
  const int qi = blockIdx.x;
  const int tile = blockIdx.y;
  const int tid = threadIdx.x;
  const long long q = static_cast<long long>(tile) * qt + qi;

  // lut_w = M2 * J is a multiple of 16 entries, a row of it of 32 bytes
  const uint4* src = reinterpret_cast<const uint4*>(lut + q * lut_w);
  uint4* dst = reinterpret_cast<uint4*>(smem_raw);
  for (int i = tid; i < lut_w / 8; i += kRows) dst[i] = __ldg(src + i);
  __syncthreads();

  const int e_begin = blockIdx.z * entries_per_block;
  const int e_end = min(e_begin + entries_per_block, width);
  const int* tcells = cells + static_cast<long long>(tile) * width;
  const int* tsegs = segs + static_cast<long long>(tile) * width;
  const int* tcellof = cellof + static_cast<long long>(tile) * width;
  const int n_slots = kRows * n_seg;
  unsigned long long* qkeys = keys + q * n_slots;
  const float* qc = qc2 + q * nlist;

  for (int e = e_begin; e < e_end; ++e) {
    int chunk, seg;
    if (!entry_chunk<false>(e, tcells, tsegs, nullptr, 1, n_chunks, 0, n_seg,
                            &chunk, &seg))
      continue;
    const int cell = tcellof[e];
    if (cell < 0 || cell >= nlist) continue;  // no such cell
    const long long row = static_cast<long long>(chunk) * kRows + tid;
    const unsigned char* p = codes + row * static_cast<long long>(mb);

    float acc = 0.f;
    if (vec) {  // mb % 16 == 0 and the array is 16-byte aligned
      for (int b0 = 0; b0 < mb; b0 += 16) {
        const uint4 t = __ldg(reinterpret_cast<const uint4*>(p + b0));
        const unsigned int w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc = add_code<kJ>(lut_s, b0 + 4 * i + j,
                               (w[i] >> (8 * j)) & 0xffu, acc);
        }
      }
    } else {
      for (int b = 0; b < mb; ++b)
        acc = add_code<kJ>(lut_s, b, static_cast<unsigned int>(__ldg(p + b)),
                           acc);
    }

    // (sum + 2 q.c) + bias, each addition rounded once
    const float score =
        __fadd_rn(__fadd_rn(acc, __ldg(qc + cell)), __ldg(bias + row));
    fold_key(qkeys + seg * kRows + tid, score,
             ~static_cast<unsigned int>(row));
  }
}

template <int kJ>
int launch(const unsigned short* lut, const float* qc2,
           const unsigned char* codes, const float* bias, const int* cells,
           const int* segs, const int* cellof, unsigned long long* keys,
           float* val, int* idx, int tiles, int qt, int mb, int lut_w,
           int nlist, int width, int n_chunks, int n_seg, int splits,
           int entries_per_block, int vec, int device, cudaStream_t stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const long long count = static_cast<long long>(tiles) * qt * kRows * n_seg;
  e = cudaMemsetAsync(keys, 0, count * sizeof(unsigned long long), stream);
  if (e != cudaSuccess) return e;
  const size_t smem = static_cast<size_t>(lut_w) * sizeof(unsigned short);
  e = cudaFuncSetAttribute(pq_probe_kernel<kJ>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid(qt, tiles, splits);
  pq_probe_kernel<kJ><<<grid, kRows, smem, stream>>>(
      lut, qc2, codes, bias, cells, segs, cellof, keys, qt, mb, lut_w, nlist,
      width, n_chunks, n_seg, entries_per_block, vec != 0);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int blocks = static_cast<int>((count + 255) / 256);
  decode_kernel<<<blocks, 256, 0, stream>>>(keys, val, idx, count);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int tpuvdb_pq_rows_per_chunk() { return kRows; }
int tpuvdb_pq_max_query_tile() { return kMaxQT; }

// lut: (tiles * qt, lut_w) bf16 bits, lut_w = M2 * n_codes; qc2:
// (tiles * qt, nlist) f32; codes: (n_chunks * 128, mb) bytes; bias:
// (n_chunks * 128,) f32; cells / segs / cellof: (tiles, width) int32, the
// tile's sorted chunk ids, each entry's segment and its chunk's owning cell.
// n_codes is 256 (mb subspaces) or 16 (2 mb subspaces); other values return
// cudaErrorInvalidValue.
int tpuvdb_pq_probe(const void* lut, const float* qc2, const void* codes,
                    const float* bias, const int* cells, const int* segs,
                    const int* cellof, unsigned long long* keys, float* val,
                    int* idx, int tiles, int qt, int mb, int n_codes,
                    int nlist, int width, int n_chunks, int n_seg, int splits,
                    int entries_per_block, int vec, int device,
                    cudaStream_t stream) {
  const unsigned short* l = static_cast<const unsigned short*>(lut);
  const unsigned char* c = static_cast<const unsigned char*>(codes);
  if (n_codes == 256)
    return launch<256>(l, qc2, c, bias, cells, segs, cellof, keys, val, idx,
                       tiles, qt, mb, mb * 256, nlist, width, n_chunks, n_seg,
                       splits, entries_per_block, vec, device, stream);
  if (n_codes == 16)
    return launch<16>(l, qc2, c, bias, cells, segs, cellof, keys, val, idx,
                      tiles, qt, mb, 2 * mb * 16, nlist, width, n_chunks,
                      n_seg, splits, entries_per_block, vec, device, stream);
  return cudaErrorInvalidValue;
}

const char* tpuvdb_pq_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
