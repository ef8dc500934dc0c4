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
// the fold order-free: blocks split a list freely, and one block may serve
// several tiles.
//
// One kernel for the three cell types (probe_mma_kernel), on the tensor
// cores:
//   * A block serves a group of G tiles (G * QT queries, the wgmma width N
//     = 8, 32, 64 or 128 the wrapper picks from Q) and walks the sorted
//     union of the group's chunks, so each chunk is read once a group, not
//     once a tile. The wrapper builds the group table with torch ops, one
//     scatter and no sort (kernels/ivf_probe.py:group_table): per group and
//     chunk id a G-wide row of the segment each tile gives the chunk, or -1
//     where the tile does not list it. The producer walks its split's range
//     of chunk ids 32 at a time (one row a lane, a ballot) and loads only
//     the chunks some tile names, in ascending order. A batch of one tile
//     (Q <= 8) skips the table: its block walks the tile's own list
//     (entry_chunk) directly.
//   * Per chunk, a 128-row x N product: rows as M (the chunk's two m64
//     tiles, one consumer warpgroup each), the group's queries as N; bf16
//     x bf16, 3xTF32 or s8 x s8, with the chunk's 128 contiguous rows loaded
//     slice by slice as 2-D TMA boxes through a ring of 3 (f32), 4 (bf16)
//     or 6 (int8) stages (csrc/hopper_mma.cuh; a grouped array whose base
//     or row stride is off 16 bytes takes the producer's element-wise copy).
//   * The epilogue folds query n's column only into its tile's own segment
//     for the chunk, and nothing where the tile's row of the table is -1: a
//     tile receives exactly the chunks of its own list. It loads its table
//     entries all at once and folds each live score with an atomicMax
//     that asks for no old value (fold_key: a reduction in L2, no round
//     trip). The candidate buffer lives in device memory as 64-bit keys
//     (order-preserving score bits << 32 | ~row, make_key), folded with
//     atomicMax: the largest key is the largest score and, on a tie, the
//     lowest row; a dead row never enters, an empty slot keeps key 0, and
//     a second kernel decodes the keys. The buffer is in device memory because a wide fetch (k = 1,024,
//     compact, S = 32) makes a tile's buffer 256 KiB.
//   * Entries repeating the one before them, and ids out of range, score
//     nothing, in the list walk (entry_chunk) as in the table.
//
// int8 cells: queries arrive quantized with one batch-global scale qs (a
// device scalar), rows padded with zeros to a multiple of 16 bytes; a row
// carries its dequant scale rs. The score is
//
//     ((2 * qs) * rs) * f32(q_i8 . x_i8) - ||x||^2 + mask
//
// with the dot exact in int32 on wgmma s8 (|dot| <= 127^2 * d). The four
// f32 operations are written with __fmul_rn / __fsub_rn / __fadd_rn in that
// order, so nvcc contracts none of them into an FMA and each rounds once,
// as separate tensor ops do: kernel and plain twin agree bit for bit.
//
// Bound on an H100 SXM: each distinct chunk moves 128 * d * 4 bytes (f32;
// bf16 2, int8 1 plus 12 a row: scale, norm, mask) and a tile listing it
// 2 * QT * 128 * d operations (3x that in tf32 for f32 cells: 495
// TFLOP/s; bf16 989; int8 1,979 TOP/s). The group computes its N columns
// for every chunk of its union, whether each tile lists it or not: at
// Q = 256, nprobe 64 of 1,024 cells, a tile lists about a third of its
// group's chunks, so the kernel does about three times the operations of
// the bound.
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
#include <type_traits>

#include "device_guard.cuh"  // DeviceGuard
#include "hopper_mma.cuh"    // the tensor-core pipeline
#include "probe_common.cuh"  // kRows, kMaxQT, entry_chunk, fold_key, decode

namespace {

enum Walk { kListExpanded = 0, kListCompact = 1, kTable = 2 };

// A tile's own list, entries [e, e_end): the chunks entry_chunk accepts,
// with their segments.
template <bool kCompact>
struct ListWalk {
  const int* tcells;
  const int* tsegs;
  const int* off128;
  int w128, n_chunks, nlist, n_seg, e, e_end;
  __device__ __forceinline__ bool next(int* row0, int* aux0, int* aux1) {
    while (e < e_end) {
      int chunk, seg;
      const bool ok = entry_chunk<kCompact>(e, tcells, tsegs, off128, w128,
                                            n_chunks, nlist, n_seg, &chunk,
                                            &seg);
      ++e;
      if (ok) {
        *row0 = chunk * kRows;
        *aux0 = seg;
        *aux1 = 0;
        return true;
      }
    }
    return false;
  }
};

// A group's table, chunk ids [c, c_end): the chunks some tile of the group
// names (a row of the table not all -1), ascending. Each lane looks at one
// of 32 chunk ids at a time, and a ballot keeps the named ones. aux0 is
// the chunk, whose row gives each tile's segment.
struct TableWalk {
  const int* tab;    // the group's rows [n_chunks + 1][group]
  int group, c, c_end, base;
  unsigned int named;
  __device__ __forceinline__ bool next(int* row0, int* aux0, int* aux1) {
    while (named == 0) {
      if (c >= c_end) return false;
      const int mine = c + static_cast<int>(threadIdx.x & 31);
      bool any = false;
      if (mine < c_end) {
        const int* r = tab + static_cast<long long>(mine) * group;
        for (int j = 0; j < group; ++j) any |= __ldg(r + j) >= 0;
      }
      named = __ballot_sync(0xffffffffu, any);
      base = c;
      c += 32;
    }
    const int chunk = base + __ffs(named) - 1;
    named &= named - 1;
    *row0 = chunk * kRows;
    *aux0 = chunk;
    *aux1 = 0;
    return true;
  }
};

// The epilogue: column n of the product is query q0 + n, of the group's
// tile n / qt; it folds into that tile's segment for the chunk. A load
// costs a round trip to L2, so the epilogue loads once, all together: the
// rows' norms, masks (int8: scales) and the table entries of the thread's
// N / 4 columns. It never loads a slot's key (fold_key). T = int8 scores
// s32 dots with the row's scale, the others 2 * dot.
template <typename T, int N, bool kTabled>
struct ProbeFold {
  using Acc = typename hop::Tile<T>::Acc;
  static constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  static constexpr int kCols = N / 4;  // columns a thread holds
  const float* sq;
  const float* mask;
  const float* rs;               // int8: per-row dequant scales
  float two_qs;                  // int8: 2 * the batch's query scale
  const int* tab;                // the group's rows [n_chunks + 1][group]
  unsigned long long* keys;      // slot 0 of query q0
  int qt, group, ncols, n_slots;

  __device__ __forceinline__ void operator()(const Acc (&acc)[N / 2],
                                             int4 block) {
    const int t = threadIdx.x % 128;
    const int r_lo = (threadIdx.x / 128) * 64 + (t / 32) * 16 + (t % 32) / 4;
    float sq_r[2], mask_r[2], scale_r[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sq_r[h] = __ldg(sq + block.x + r_lo + 8 * h);
      mask_r[h] = __ldg(mask + block.x + r_lo + 8 * h);
      if constexpr (kInt8)
        scale_r[h] = __fmul_rn(two_qs, __ldg(rs + block.x + r_lo + 8 * h));
    }
    // column c of the thread is 8 (c / 2) + 2 (t % 4) + c % 2 (element i
    // of the accumulator holds column c = 2 (i / 4) + i % 2); its tile's
    // segment for the chunk, or -1
    int seg[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = 8 * (c / 2) + 2 * (t % 4) + (c % 2);
      seg[c] = col >= ncols ? -1
               : kTabled    ? __ldg(tab + block.y * group + col / qt)
                            : block.y;
    }
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const int c = 2 * (i / 4) + (i % 2);
      const int h = (i % 4) / 2;
      float score;
      if constexpr (kInt8)  // ((2 qs) rs) dot - sq + mask, each rounded
        score = __fadd_rn(
            __fsub_rn(__fmul_rn(scale_r[h], __int2float_rn(acc[i])),
                      sq_r[h]),
            mask_r[h]);
      else
        score = __fadd_rn(__fsub_rn(2.f * acc[i], sq_r[h]), mask_r[h]);
      if (seg[c] < 0) continue;
      const int col = 8 * (c / 2) + 2 * (t % 4) + (c % 2);
      const unsigned int row = block.x + r_lo + 8 * h;
      fold_key(keys + col * n_slots + seg[c] * kRows + r_lo + 8 * h, score,
               ~row);
    }
  }
};

// grid = (groups, or the one tile of a list walk) x (splits of the walk)
template <typename T, int N, int kWalk>
__global__ void __launch_bounds__(hop::kThreads, 1)
probe_mma_kernel(const __grid_constant__ CUtensorMap map_x,
                 const __grid_constant__ CUtensorMap map_qh,
                 const __grid_constant__ CUtensorMap map_ql, const T* x,
                 const float* __restrict__ rs,
                 const float* __restrict__ qscale,
                 const float* __restrict__ sq, const float* __restrict__ mask,
                 const int* __restrict__ cells, const int* __restrict__ segs,
                 const int* __restrict__ off128,
                 const int* __restrict__ tab,
                 unsigned long long* __restrict__ keys, int tiles, int qt,
                 int group, int d, int width, int w128, int n_chunks,
                 int nlist, int n_seg, int splits, int ragged) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = hop::align1024(smem_raw);
  hop::init_ring<T, N>(base);

  const int g = blockIdx.x;
  const int t0 = g * group;            // the group's first tile
  const int q0 = t0 * qt;
  const int n_slots = kRows * n_seg;
  const int n_rows = n_chunks * kRows;

  if (threadIdx.x >= hop::kConsumers) {  // the producer warp
    if (kWalk == kTable) {  // width = n_chunks: the ids this group sees
      TableWalk walk{
          tab + static_cast<long long>(g) * (width + 1) * group, group,
          static_cast<int>(static_cast<long long>(width) * blockIdx.y /
                           splits),
          static_cast<int>(static_cast<long long>(width) *
                           (blockIdx.y + 1) / splits),
          0, 0u};
      hop::produce<T, N>(base, &map_x, &map_qh, &map_ql, x, n_rows, d, q0,
                         ragged != 0, walk);
    } else {
      constexpr bool kCompact = kWalk == kListCompact;
      const long long n_entries =
          kCompact ? static_cast<long long>(width) * w128 : width;
      ListWalk<kCompact> walk{
          cells + static_cast<long long>(t0) * width,
          kCompact ? nullptr : segs + static_cast<long long>(t0) * width,
          off128, w128, n_chunks, nlist, n_seg,
          static_cast<int>(n_entries * blockIdx.y / splits),
          static_cast<int>(n_entries * (blockIdx.y + 1) / splits)};
      hop::produce<T, N>(base, &map_x, &map_qh, &map_ql, x, n_rows, d, q0,
                         ragged != 0, walk);
    }
    return;
  }
  ProbeFold<T, N, kWalk == kTable> fold;
  fold.sq = sq;
  fold.mask = mask;
  fold.rs = rs;
  fold.two_qs = qscale != nullptr ? __fmul_rn(2.f, __ldg(qscale)) : 0.f;
  fold.tab = kWalk == kTable
                 ? tab + static_cast<long long>(g) * (width + 1) * group
                 : nullptr;
  fold.keys = keys + static_cast<long long>(q0) * n_slots;
  fold.qt = qt;
  fold.group = group;
  fold.ncols = min(group, tiles - t0) * qt;
  fold.n_slots = n_slots;
  hop::consume<T, N>(base, d, fold);
}

template <typename T, int N, int kWalk>
cudaError_t launch_probe(const void* qh, const void* ql, const T* x,
                         const float* rs, const float* qscale,
                         const float* sq, const float* mask, const int* cells,
                         const int* segs, const int* off128, const int* tab,
                         unsigned long long* keys, int blocks, int tiles,
                         int qt, int group, int q_rows, int d_pad, int d,
                         int width, int w128, int n_chunks, int nlist,
                         int n_seg, int splits, int ragged,
                         cudaStream_t stream) {
  CUtensorMap map_x{}, map_qh{}, map_ql{};
  cudaError_t e;
  const long long n_rows = static_cast<long long>(n_chunks) * kRows;
  if (!ragged) {
    e = hop::make_map<T>(&map_x, x, n_rows, d, d, hop::kBlockRows);
    if (e != cudaSuccess) return e;
  }
  e = hop::make_map<T>(&map_qh, qh, q_rows, d_pad, d_pad, N);
  if (e != cudaSuccess) return e;
  if (hop::Layout<T, N>::kSplit) {
    e = hop::make_map<T>(&map_ql, ql, q_rows, d_pad, d_pad, N);
    if (e != cudaSuccess) return e;
  }
  const size_t smem = hop::Layout<T, N>::kEnd + 1024;
  e = cudaFuncSetAttribute(probe_mma_kernel<T, N, kWalk>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid(blocks, splits);
  probe_mma_kernel<T, N, kWalk><<<grid, hop::kThreads, smem, stream>>>(
      map_x, map_qh, map_ql, x, rs, qscale, sq, mask, cells, segs, off128,
      tab, keys, tiles, qt, group, d, width, w128, n_chunks, nlist, n_seg,
      splits, ragged);
  return cudaGetLastError();
}

// walk: kListExpanded / kListCompact (cells, segs / off128: one tile's list
// a block, group 1, the width-8 product) or kTable (tab, the table of
// kernels/ivf_probe.py:group_table, (groups, n_chunks + 1, group); width =
// n_chunks: group tiles a block, the width-`cols` product). q: the f32
// queries, split here into qh / ql (f32, bf16); int8 takes its quantized
// queries as qh and q = nullptr.
template <typename T>
int launch(const float* q, void* qh, void* ql, const T* x, const float* rs,
           const float* qscale, const float* sq, const float* mask,
           const int* cells, const int* segs, const int* off128,
           const int* tab, unsigned long long* keys, float* val, int* idx,
           int walk, int tiles, int qt, int group, int cols, int q_rows,
           int d_pad, int d, int width, int w128, int n_chunks, int nlist,
           int n_seg, int splits, int ragged, int device,
           cudaStream_t stream) {
  const DeviceGuard guard(device);
  cudaError_t e = guard.status();
  if (e != cudaSuccess) return e;
  if (group * qt > cols || (walk != kTable && (group != 1 || cols != 8)))
    return cudaErrorInvalidValue;
  if constexpr (!std::is_same<T, int8_t>::value) {
    e = hop::prep_queries<T>(q, qh, ql, q_rows, d, d_pad, stream);
    if (e != cudaSuccess) return e;
  }
  const long long count = static_cast<long long>(tiles) * qt * kRows * n_seg;
  e = cudaMemsetAsync(keys, 0, count * sizeof(unsigned long long), stream);
  if (e != cudaSuccess) return e;
  const int blocks = (tiles + group - 1) / group;
#define TPUVDB_PROBE(NN, WW)                                                 \
  launch_probe<T, NN, WW>(qh, ql, x, rs, qscale, sq, mask, cells, segs,     \
                          off128, tab, keys, blocks, tiles, qt, group,       \
                          q_rows, d_pad, d, width, w128, n_chunks, nlist,    \
                          n_seg, splits, ragged, stream)
  if (walk == kListExpanded) {
    e = TPUVDB_PROBE(8, kListExpanded);
  } else if (walk == kListCompact) {
    e = TPUVDB_PROBE(8, kListCompact);
  } else if (cols == 8) {
    e = TPUVDB_PROBE(8, kTable);
  } else if (cols == 32) {
    e = TPUVDB_PROBE(32, kTable);
  } else if (cols == 64) {
    e = TPUVDB_PROBE(64, kTable);
  } else if (cols == 128) {
    e = TPUVDB_PROBE(128, kTable);
  } else {
    return cudaErrorInvalidValue;
  }
#undef TPUVDB_PROBE
  if (e != cudaSuccess) return e;
  const int dblocks = static_cast<int>((count + 255) / 256);
  decode_kernel<<<dblocks, 256, 0, stream>>>(keys, val, idx, count);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int tpuvdb_ivf_rows_per_chunk() { return kRows; }
int tpuvdb_ivf_max_query_tile() { return kMaxQT; }

// f32/bf16 cells, either form. q: the padded (q_rows, d) f32 queries; qh,
// ql: (q_rows, d_pad) scratch for their operands (f32: tf32 hi and lo
// parts; bf16: qh the bf16 queries, ql unused); the lists of the walk (see
// launch); keys the (Q_pad, 128 * n_seg) scratch decoded into val / idx.
int tpuvdb_ivf_probe_f32(const float* q, void* qh, void* ql, const float* x,
                         const float* sq, const float* mask, const int* cells,
                         const int* segs, const int* off128, const int* tab,
                         unsigned long long* keys, float* val, int* idx,
                         int walk, int tiles, int qt, int group, int cols,
                         int q_rows, int d_pad, int d, int width, int w128,
                         int n_chunks, int nlist, int n_seg, int splits,
                         int ragged, int device, cudaStream_t stream) {
  return launch<float>(q, qh, ql, x, nullptr, nullptr, sq, mask, cells, segs,
                       off128, tab, keys, val, idx, walk, tiles, qt, group,
                       cols, q_rows, d_pad, d, width, w128, n_chunks, nlist,
                       n_seg, splits, ragged, device, stream);
}

int tpuvdb_ivf_probe_bf16(const float* q, void* qh, void* ql, const void* x,
                          const float* sq, const float* mask,
                          const int* cells, const int* segs,
                          const int* off128, const int* tab,
                          unsigned long long* keys, float* val, int* idx,
                          int walk, int tiles, int qt, int group, int cols,
                          int q_rows, int d_pad, int d, int width, int w128,
                          int n_chunks, int nlist, int n_seg, int splits,
                          int ragged, int device, cudaStream_t stream) {
  return launch<__nv_bfloat16>(
      q, qh, ql, static_cast<const __nv_bfloat16*>(x), nullptr, nullptr, sq,
      mask, cells, segs, off128, tab, keys, val, idx, walk, tiles, qt, group,
      cols, q_rows, d_pad, d, width, w128, n_chunks, nlist, n_seg, splits,
      ragged, device, stream);
}

// int8 cells, either form: q8 the quantized queries (q_rows, d_pad) int8,
// rows padded with zeros; qscale their one f32 scale on the device; rs the
// per-row dequant scales; the rest as the forms above.
int tpuvdb_ivf_probe_i8(const void* q8, const float* qscale, const void* x,
                        const float* rs, const float* sq, const float* mask,
                        const int* cells, const int* segs, const int* off128,
                        const int* tab, unsigned long long* keys, float* val,
                        int* idx, int walk, int tiles, int qt, int group,
                        int cols, int q_rows, int d_pad, int d, int width,
                        int w128, int n_chunks, int nlist, int n_seg,
                        int splits, int ragged, int device,
                        cudaStream_t stream) {
  return launch<int8_t>(nullptr, const_cast<void*>(q8), nullptr,
                        static_cast<const int8_t*>(x), rs, qscale, sq, mask,
                        cells, segs, off128, tab, keys, val, idx, walk, tiles,
                        qt, group, cols, q_rows, d_pad, d, width, w128,
                        n_chunks, nlist, n_seg, splits, ragged, device,
                        stream);
}

const char* tpuvdb_ivf_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
