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
// Design:
//   * grid = (group of G queries of the tile, tile, split of the tile's
//     list). A block serves G queries (G = 8, 4, 2 or 1: the widest whose
//     table fits, no wider than the tile needs) from one staged table, so
//     it reads the codes and the bias once for G queries.
//   * The table is staged interleaved, [m][code][G] bf16, from the (Qp,
//     M2 * J) LUT the wrapper builds, during the staging copy (each thread
//     reads 8 entries of each of the G rows as 16-byte loads and writes
//     them out by query). A lane that reads its row's code byte then gets
//     the G queries' entries in one 2, 4, 8 or 16-byte shared-memory load
//     and adds each into its own accumulator. The table is M2 * J * G * 2
//     bytes, within the 227 KB a block can have (SMEM_MAX in the wrapper):
//     G = 8 up to M2 = 56 at J = 256, G = 4 for the engine's 64 bytes (128
//     KB) and the capacity run's 96 (192 KB), G = 2 or 1 above; J = 16
//     fits at G = 8 up to M2 = 907.
//   * A block is TEAMS teams of 128 threads, one thread a row of a chunk;
//     the teams walk the block's range of the list in turn (team t takes
//     entries t, t + TEAMS, ...) against the one staged table, so a block
//     that has the SM to itself (a 128-192 KB table) still has the warps
//     to hide the shared-memory latency: 8 teams, 1,024 threads (4 with
//     G = 8, whose sums take more registers), and about 8 blocks an SM in
//     all from the splits of each tile's list (kernels/pq_probe.py TEAMS,
//     BLOCKS_PER_SM; the other settings' times are in PERF.md).
//   * A thread reads its row's Mb bytes, 16 at a time when Mb % 16 == 0 and
//     the code array is 16-byte aligned and byte by byte otherwise, and
//     widens each looked-up entry (a bf16 is the high half of an f32).
//     Code bytes are unsigned.
//   * Per query, the sum and the two score additions are written with
//     __fadd_rn in a fixed order (subspaces ascending from +0, then + qc2,
//     then + bias), so nvcc contracts nothing and each rounds once, as
//     separate tensor ops do: kernel and plain twin agree bit for bit.
//   * Each of the G scores of a row folds into its slot with an atomicMax
//     that asks for no old value (fold_key).
//   * An entry equal to the one before it is skipped; an entry whose chunk,
//     segment or cell is out of range scores nothing.
//
// Bound on an H100 SXM: a distinct chunk moves 128 * (Mb + 4) bytes (codes
// and bias) over 3.35 TB/s, and costs QT * 128 * M2 lookups per tile. With
// J = 256 the table must live in shared memory, which hands out 128 bytes a
// clock and SM (32 banks of 4 bytes), 64 bf16 entries: 132 * 64 * 1.98e9 =
// 1.67e13 entries a second at the maximum SM clock nvidia-smi reports
// (clocks.max.sm, 1,980 MHz on an NVIDIA H100 80GB HBM3 at a 700 W limit).
// The interleaved table serves G queries a load, so a bank word carries
// whole entries; random codes still put several lanes of a warp on one
// bank, and each entry costs two instructions (widen, add). With J = 16 a
// subspace's table is 32 bytes and fits in registers, so shared memory is
// no floor there: the operations are the f32 additions, one a lookup, at
// 128 lanes a clock and SM. PERF.md has the measured times beside these
// bounds.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC; bound with ctypes (tpuvdb_torch/kernels/pq_probe.py).

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

#include "device_guard.cuh"  // DeviceGuard
#include "probe_common.cuh"  // kRows, kMaxQT, entry_chunk, fold_key, decode

namespace {

// threads a block may have: eight teams of 128, four with the 8-wide
// groups, whose sums and loads take more registers
__host__ __device__ constexpr int max_threads(int g) {
  return g == 8 ? 512 : 1024;
}

// The G entries of one shared-memory load of the interleaved table, entry
// `i` (= m * J + code), widened: a bf16 is the high half of an f32.
template <int kG>
__device__ __forceinline__ void lookup(const unsigned char* lut_s, int i,
                                       float (&e)[kG]) {
  if constexpr (kG == 1) {
    const unsigned int w = reinterpret_cast<const unsigned short*>(lut_s)[i];
    e[0] = __uint_as_float(w << 16);
  } else {
    unsigned int w[kG / 2];
    if constexpr (kG == 2) {
      w[0] = reinterpret_cast<const unsigned int*>(lut_s)[i];
    } else if constexpr (kG == 4) {
      const uint2 v = reinterpret_cast<const uint2*>(lut_s)[i];
      w[0] = v.x;
      w[1] = v.y;
    } else {
      const uint4 v = reinterpret_cast<const uint4*>(lut_s)[i];
      w[0] = v.x;
      w[1] = v.y;
      w[2] = v.z;
      w[3] = v.w;
    }
#pragma unroll
    for (int k = 0; k < kG / 2; ++k) {
      e[2 * k] = __uint_as_float(w[k] << 16);
      e[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
}

template <int kG>
__device__ __forceinline__ void add_entries(const unsigned char* lut_s,
                                            int i, float (&acc)[kG]) {
  float e[kG];
  lookup<kG>(lut_s, i, e);
#pragma unroll
  for (int j = 0; j < kG; ++j) acc[j] = __fadd_rn(acc[j], e[j]);
}

// acc + the entries that code byte `c` of byte column `b` selects
template <int kJ, int kG>
__device__ __forceinline__ void add_code(const unsigned char* lut_s, int b,
                                         unsigned int c, float (&acc)[kG]) {
  if (kJ == 256) {
    add_entries<kG>(lut_s, b * 256 + static_cast<int>(c), acc);
  } else {  // two 4-bit codes: low nibble = subspace 2b, high = 2b + 1
    add_entries<kG>(lut_s, (2 * b) * 16 + static_cast<int>(c & 15u), acc);
    add_entries<kG>(lut_s, (2 * b + 1) * 16 + static_cast<int>(c >> 4), acc);
  }
}

// half word `e` (0..7) of a 16-byte load
__device__ __forceinline__ unsigned short half_of(const uint4& v, int e) {
  const unsigned int w = e < 2 ? v.x : e < 4 ? v.y : e < 6 ? v.z : v.w;
  return static_cast<unsigned short>((e & 1) ? w >> 16 : w & 0xffffu);
}

template <int kJ, int kG>
__global__ void __launch_bounds__(max_threads(kG))
pq_probe_kernel(const unsigned short* __restrict__ lut,   // (Qp, lut_w) bf16
                const float* __restrict__ qc2,            // (Qp, nlist)
                const unsigned char* __restrict__ codes,  // (N_g, mb)
                const float* __restrict__ bias,           // (N_g,)
                const int* __restrict__ cells, const int* __restrict__ segs,
                const int* __restrict__ cellof,
                unsigned long long* __restrict__ keys, int qt, int mb,
                int lut_w, int nlist, int width, int n_chunks, int n_seg,
                int entries_per_block, bool vec) {
  extern __shared__ __align__(16) unsigned char lut_s[];  // [lut_w][kG]
  const int tile = blockIdx.y;
  const int j0 = blockIdx.x * kG;   // the block's first query in the tile
  const int ng = min(kG, qt - j0);  // queries it serves
  const long long q0 = static_cast<long long>(tile) * qt + j0;

  // stage: entry i of query j at [i][j]; lut_w = M2 * J is a multiple of
  // 16 entries, a row of it of 32 bytes
  unsigned short* st = reinterpret_cast<unsigned short*>(lut_s);
  for (int i = threadIdx.x; i < lut_w / 8; i += blockDim.x) {
    uint4 r[kG];
#pragma unroll
    for (int j = 0; j < kG; ++j)
      r[j] = j < ng ? __ldg(reinterpret_cast<const uint4*>(
                                lut + (q0 + j) * lut_w) + i)
                    : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
#pragma unroll
      for (int j = 0; j < kG; ++j) st[(8 * i + e) * kG + j] = half_of(r[j], e);
    }
  }
  __syncthreads();

  const int teams = blockDim.x / kRows;
  const int team = threadIdx.x / kRows;
  const int tid = threadIdx.x % kRows;
  const int e_begin = blockIdx.z * entries_per_block;
  const int e_end = min(e_begin + entries_per_block, width);
  const int* tcells = cells + static_cast<long long>(tile) * width;
  const int* tsegs = segs + static_cast<long long>(tile) * width;
  const int* tcellof = cellof + static_cast<long long>(tile) * width;
  const int n_slots = kRows * n_seg;
  unsigned long long* qkeys = keys + q0 * n_slots;
  const float* qc = qc2 + q0 * nlist;

  for (int e = e_begin + team; e < e_end; e += teams) {
    int chunk, seg;
    if (!entry_chunk<false>(e, tcells, tsegs, nullptr, 1, n_chunks, 0, n_seg,
                            &chunk, &seg))
      continue;
    const int cell = tcellof[e];
    if (cell < 0 || cell >= nlist) continue;  // no such cell
    const long long row = static_cast<long long>(chunk) * kRows + tid;
    const unsigned char* p = codes + row * static_cast<long long>(mb);

    float acc[kG];
#pragma unroll
    for (int j = 0; j < kG; ++j) acc[j] = 0.f;
    if (vec) {  // mb % 16 == 0 and the array is 16-byte aligned
      for (int b0 = 0; b0 < mb; b0 += 16) {
        const uint4 t = __ldg(reinterpret_cast<const uint4*>(p + b0));
        const unsigned int w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            add_code<kJ, kG>(lut_s, b0 + 4 * i + k, (w[i] >> (8 * k)) & 0xffu,
                             acc);
        }
      }
    } else {
      for (int b = 0; b < mb; ++b)
        add_code<kJ, kG>(lut_s, b, static_cast<unsigned int>(__ldg(p + b)),
                         acc);
    }

    // per query (sum + 2 q.c) + bias, each addition rounded once
    const float b = __ldg(bias + row);
    const unsigned long long low = ~static_cast<unsigned int>(row);
#pragma unroll
    for (int j = 0; j < kG; ++j) {
      if (j >= ng) break;
      const float score = __fadd_rn(
          __fadd_rn(acc[j], __ldg(qc + static_cast<long long>(j) * nlist +
                                  cell)),
          b);
      fold_key(qkeys + static_cast<long long>(j) * n_slots + seg * kRows +
                   tid,
               score, low);
    }
  }
}

template <int kJ, int kG>
cudaError_t launch_g(const unsigned short* lut, const float* qc2,
                     const unsigned char* codes, const float* bias,
                     const int* cells, const int* segs, const int* cellof,
                     unsigned long long* keys, int tiles, int qt, int mb,
                     int lut_w, int nlist, int width, int n_chunks, int n_seg,
                     int splits, int entries_per_block, int teams, int vec,
                     cudaStream_t stream) {
  if (teams < 1) return cudaErrorInvalidValue;
  const int threads = min(teams * kRows, max_threads(kG));
  const size_t smem = static_cast<size_t>(lut_w) * kG * sizeof(unsigned short);
  cudaError_t e = cudaFuncSetAttribute(
      pq_probe_kernel<kJ, kG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((qt + kG - 1) / kG, tiles, splits);
  pq_probe_kernel<kJ, kG><<<grid, threads, smem, stream>>>(
      lut, qc2, codes, bias, cells, segs, cellof, keys, qt, mb, lut_w, nlist,
      width, n_chunks, n_seg, entries_per_block, vec != 0);
  return cudaGetLastError();
}

template <int kJ>
int launch(const unsigned short* lut, const float* qc2,
           const unsigned char* codes, const float* bias, const int* cells,
           const int* segs, const int* cellof, unsigned long long* keys,
           float* val, int* idx, int tiles, int qt, int mb, int lut_w,
           int nlist, int width, int n_chunks, int n_seg, int group,
           int teams, int splits, int entries_per_block, int vec, int device,
           cudaStream_t stream) {
  const DeviceGuard guard(device);
  cudaError_t e = guard.status();
  if (e != cudaSuccess) return e;
  const long long count = static_cast<long long>(tiles) * qt * kRows * n_seg;
  e = cudaMemsetAsync(keys, 0, count * sizeof(unsigned long long), stream);
  if (e != cudaSuccess) return e;
#define TPUVDB_PQ(GG)                                                        \
  launch_g<kJ, GG>(lut, qc2, codes, bias, cells, segs, cellof, keys, tiles, \
                   qt, mb, lut_w, nlist, width, n_chunks, n_seg, splits,     \
                   entries_per_block, teams, vec, stream)
  if (group == 8) {
    e = TPUVDB_PQ(8);
  } else if (group == 4) {
    e = TPUVDB_PQ(4);
  } else if (group == 2) {
    e = TPUVDB_PQ(2);
  } else if (group == 1) {
    e = TPUVDB_PQ(1);
  } else {
    return cudaErrorInvalidValue;
  }
#undef TPUVDB_PQ
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
// n_codes is 256 (mb subspaces) or 16 (2 mb subspaces); group (queries a
// block serves) 1, 2, 4 or 8; teams (128-thread teams a block) at least 1,
// at most 8 (4 with group 8) taken; other values return
// cudaErrorInvalidValue.
int tpuvdb_pq_probe(const void* lut, const float* qc2, const void* codes,
                    const float* bias, const int* cells, const int* segs,
                    const int* cellof, unsigned long long* keys, float* val,
                    int* idx, int tiles, int qt, int mb, int n_codes,
                    int nlist, int width, int n_chunks, int n_seg, int group,
                    int teams, int splits, int entries_per_block, int vec,
                    int device, cudaStream_t stream) {
  const unsigned short* l = static_cast<const unsigned short*>(lut);
  const unsigned char* c = static_cast<const unsigned char*>(codes);
  if (n_codes == 256)
    return launch<256>(l, qc2, c, bias, cells, segs, cellof, keys, val, idx,
                       tiles, qt, mb, mb * 256, nlist, width, n_chunks, n_seg,
                       group, teams, splits, entries_per_block, vec, device,
                       stream);
  if (n_codes == 16)
    return launch<16>(l, qc2, c, bias, cells, segs, cellof, keys, val, idx,
                      tiles, qt, mb, 2 * mb * 16, nlist, width, n_chunks,
                      n_seg, group, teams, splits, entries_per_block, vec,
                      device, stream);
  return cudaErrorInvalidValue;
}

const char* tpuvdb_pq_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
