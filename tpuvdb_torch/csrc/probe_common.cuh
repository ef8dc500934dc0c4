// What the probe kernels share (csrc/ivf_probe.cu, csrc/pq_probe.cu): the
// walk over a tile's list, the 64-bit candidate keys and their decode.
//
// A probe folds 128-row chunks of the packed cell array into a
// (QT, 128 * S) candidate buffer per tile of QT <= 8 queries: row
// chunk * 128 + j lands in slot seg(chunk) * 128 + j. The reference keeps,
// per slot, the first strict maximum in list order; since a chunk always
// lands in the same slots with the same scores and distinct chunks first
// appear in ascending order, that is the maximum score and, among equal
// scores, the lowest row, whatever the order or the repeats. The buffer
// therefore lives in device memory as keys
//
//     order_bits(score) << 32 | ~row
//
// folded with atomicMax: the largest key is the largest score and, on a tie,
// the lowest row. A score <= -FLT_MAX (a dead row) never enters; an empty
// slot keeps key 0, which decodes to (-FLT_MAX, -1).
//
// Everything here is in an unnamed namespace: each source that includes the
// header gets its own copy, and the libraries export only their C functions.

#pragma once

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr int kRows = 128;   // rows per chunk = threads per block
constexpr int kMaxQT = 8;    // queries per tile
constexpr float kNegInf = -FLT_MAX;  // finfo(float32).min, as the reference

// f32 bits mapped so that unsigned order is float order
__device__ __forceinline__ unsigned int order_bits(float f) {
  const unsigned int b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float unorder_bits(unsigned int u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// Entry e of a tile's list -> (chunk, segment); false where the entry
// repeats the one before it (a chunk or a cell shared by the tile's
// queries: it would fold the same keys again) or names no chunk, segment or
// cell of the arrays.
template <bool kCompact>
__device__ __forceinline__ bool entry_chunk(int e, const int* tcells,
                                            const int* tsegs,
                                            const int* off128, int w128,
                                            int n_chunks, int nlist, int n_seg,
                                            int* chunk, int* seg) {
  if (kCompact) {
    const int u = e / w128;
    const int cell = tcells[u];
    if (u > 0 && cell == tcells[u - 1]) return false;  // shared cell
    if (cell < 0 || cell >= nlist) return false;       // no such cell
    *chunk = min(off128[cell] + e % w128, n_chunks - 1);
    *seg = *chunk % n_seg;
  } else {
    *chunk = tcells[e];
    if (e > 0 && *chunk == tcells[e - 1]) return false;  // shared chunk
    *seg = tsegs[e];
    if (*seg < 0 || *seg >= n_seg) return false;         // no such segment
  }
  return *chunk >= 0 && *chunk < n_chunks;
}

// The key of a score and its row's low word (~row): the largest key is the
// largest score and, on a tie, the lowest row.
__device__ __forceinline__ unsigned long long make_key(
    float score, unsigned long long low) {
  return (static_cast<unsigned long long>(order_bits(score)) << 32) | low;
}

// Fold one score into its slot: an atomicMax whose old value is not asked
// for, which the card runs as a reduction in L2 with no round trip (loading
// the slot's key first, to skip the scores that lose, measured no faster in
// the PQ probe and slower in the IVF probe: PERF.md). A dead row
// (score <= -FLT_MAX) never enters.
__device__ __forceinline__ void fold_key(unsigned long long* slot, float score,
                                         unsigned long long low) {
  if (score > kNegInf) atomicMax(slot, make_key(score, low));
}

// keys -> (score, row); an empty slot gives (-FLT_MAX, -1)
__global__ void decode_kernel(const unsigned long long* __restrict__ keys,
                              float* __restrict__ val, int* __restrict__ idx,
                              long long count) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const unsigned long long key = keys[i];
  if (key == 0ull) {
    val[i] = kNegInf;
    idx[i] = -1;
  } else {
    val[i] = unorder_bits(static_cast<unsigned int>(key >> 32));
    idx[i] = static_cast<int>(~static_cast<unsigned int>(key));
  }
}

}  // namespace
