// K7: damped pair products reduced by compact covisibility segment.
//
//   out[9m+n, k] = Σ_{pairs q of segment k} [ W_i(q) · V_λ(q)⁻¹ · W_j(q)ᵀ ][m, n]
//
// packed (63, Np): rows 0–26 W[pair_i], 27–53 W[pair_j], 54–62 V[pair_pt];
// the pairs are sorted by segment. Replaces the Pallas kernel
// tpu_ba/kernels/pairblocks.py:fused_pair_blocks (pair products in VMEM,
// one-hot MXU reduction over a chunk/tile work list).
//
// Bound: device-memory bytes. A pair is 63 floats in and does ~700
// operations; a segment is 81 floats out.
//
// Design: the work is split by pairs, not by segment. Segment lengths are
// heavy-tailed (venice-1778 with community covisibility: median 3 pairs,
// longest 179,458), so a group of lanes per segment takes as long as its
// longest segment takes one group. A schedule built once per structure
// (kernels/pairblocks.py:pair_schedule) gives the kernel three kinds of block:
//   piece  a segment longer than the short cut-off is cut into pieces of
//          512 consecutive pairs; a whole block of 64 threads works a piece,
//          consecutive threads on consecutive pairs, so each of a warp's 63
//          row loads is one 128-byte line. The block folds its 64 sums by
//          warp shuffles in a fixed tree, adds the two warps' sums in order
//          and writes them to partial[:, piece];
//   short  a group of G lanes owns a short segment (at most G·8 pairs), its
//          lanes taking the pairs in turn, and folds by shuffles inside the
//          group (G from the segments' median length);
//   zero   a thread writes an empty segment's column of zeros (the padding
//          pairs' trash segment among them).
// Each thread keeps a whole 9×9 block in registers and forms V_λ⁻¹ and
// W_i·V_λ⁻¹ once per pair. A second kernel, the fold, adds each split
// segment's pieces in piece order. No atomics: the same sum every run.
#include <cuda_runtime.h>

#include "bandmath.cuh"

namespace {

constexpr int kThreads = 64;
constexpr int kWarps = kThreads / 32;
constexpr int kFoldThreads = 128;

// acc += W_i(q) · V_λ(q)⁻¹ · W_j(q)ᵀ for the pair in column q of packed
__device__ __forceinline__ void add_pair(const float* __restrict__ packed, size_t np, size_t q,
                                         float lam, float lo, float hi, float acc[81]) {
  float v[9], inv[9], wi[27], mrows[27];
#pragma unroll
  for (int e = 0; e < 9; ++e) v[e] = packed[(54 + e) * np + q];
  tba::damped_inv3(v, lam, lo, hi, inv);
#pragma unroll
  for (int e = 0; e < 27; ++e) wi[e] = packed[e * np + q];
#pragma unroll
  for (int m = 0; m < 9; ++m) {
#pragma unroll
    for (int b = 0; b < 3; ++b) mrows[3 * m + b] = tba::w_inv_entry(wi, inv, m, b);
  }
#pragma unroll
  for (int n = 0; n < 9; ++n) {
    const float w0 = packed[(27 + 3 * n) * np + q];
    const float w1 = packed[(28 + 3 * n) * np + q];
    const float w2 = packed[(29 + 3 * n) * np + q];
#pragma unroll
    for (int m = 0; m < 9; ++m) {
      acc[9 * m + n] += mrows[3 * m] * w0 + mrows[3 * m + 1] * w1 + mrows[3 * m + 2] * w2;
    }
  }
}

// blocks [0, n_pieces) work pieces, the next n_short blocks short items (G
// lanes each), the rest zero the empty segments; the kind is uniform over a
// block
template <int G>
__global__ void __launch_bounds__(kThreads)
pair_blocks_kernel(const float* __restrict__ packed, const float* __restrict__ lam_p,
                   const int* __restrict__ items, int n_items, int n_short,
                   const int* __restrict__ pieces, int n_pieces, const int* __restrict__ empty,
                   int n_empty, float* __restrict__ partial, float* __restrict__ out,
                   int n_pairs, int k_pad, float lo, float hi) {
  __shared__ float warp_sums[kWarps][81];
  const int block = blockIdx.x;
  if (block >= n_pieces + n_short) {
    const int j = (block - n_pieces - n_short) * kThreads + threadIdx.x;
    if (j < n_empty) {
      const size_t seg = empty[j];
#pragma unroll
      for (int e = 0; e < 81; ++e) out[static_cast<size_t>(e) * k_pad + seg] = 0.0f;
    }
    return;
  }
  const float lam = *lam_p;
  const size_t np = static_cast<size_t>(n_pairs);
  float acc[81];
#pragma unroll
  for (int e = 0; e < 81; ++e) acc[e] = 0.0f;

  if (block < n_pieces) {
    const int piece = block;
    const int end = pieces[n_pieces + piece];
    for (int q = pieces[piece] + threadIdx.x; q < end; q += kThreads) {
      add_pair(packed, np, q, lam, lo, hi, acc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int e = 0; e < 81; ++e) acc[e] += __shfl_down_sync(0xffffffffu, acc[e], off);
    }
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
      for (int e = 0; e < 81; ++e) warp_sums[warp][e] = acc[e];
    }
    __syncthreads();
    for (int e = threadIdx.x; e < 81; e += kThreads) {
      float s = warp_sums[0][e];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) s += warp_sums[w][e];
      partial[static_cast<size_t>(e) * n_pieces + piece] = s;
    }
    return;
  }

  const int item = (block - n_pieces) * (kThreads / G) + static_cast<int>(threadIdx.x) / G;
  const int lane = static_cast<int>(threadIdx.x) % G;
  const bool active = item < n_items;
  if (active) {
    const int end = items[2 * n_items + item];
    for (int q = items[n_items + item] + lane; q < end; q += G) {
      add_pair(packed, np, q, lam, lo, hi, acc);
    }
  }
  // every lane of the warp takes part in the shuffles; groups never mix
#pragma unroll
  for (int off = G >> 1; off > 0; off >>= 1) {
#pragma unroll
    for (int e = 0; e < 81; ++e) acc[e] += __shfl_down_sync(0xffffffffu, acc[e], off, G);
  }
  if (active && lane == 0) {
    const int seg = items[item];
#pragma unroll
    for (int e = 0; e < 81; ++e) out[static_cast<size_t>(e) * k_pad + seg] = acc[e];
  }
}

// out[e, fold_seg[j]] = Σ_{pieces p of split segment j, in order} partial[e, p];
// entry e on blockIdx.y
__global__ void __launch_bounds__(kFoldThreads)
pair_fold_kernel(const float* __restrict__ partial, int n_pieces,
                 const int* __restrict__ fold_seg, const int* __restrict__ fold_start,
                 int n_split, float* __restrict__ out, int k_pad) {
  const int j = blockIdx.x * kFoldThreads + threadIdx.x;
  if (j >= n_split) return;
  const float* row = partial + static_cast<size_t>(blockIdx.y) * n_pieces;
  float s = 0.0f;
  const int end = fold_start[j + 1];
  for (int p = fold_start[j]; p < end; ++p) s += row[p];
  out[static_cast<size_t>(blockIdx.y) * k_pad + fold_seg[j]] = s;
}

template <int G>
cudaError_t launch(const float* packed, const float* lam, const int* items, int n_items,
                   const int* pieces, int n_pieces, const int* empty, int n_empty,
                   float* partial, float* out, int n_pairs, int k_pad, float lo, float hi,
                   cudaStream_t stream) {
  const int n_short = (n_items + kThreads / G - 1) / (kThreads / G);
  const int n_blocks = n_pieces + n_short + (n_empty + kThreads - 1) / kThreads;
  if (n_blocks == 0) return cudaSuccess;
  pair_blocks_kernel<G><<<n_blocks, kThreads, 0, stream>>>(
      packed, lam, items, n_items, n_short, pieces, n_pieces, empty, n_empty, partial, out,
      n_pairs, k_pad, lo, hi);
  return cudaGetLastError();
}

}  // namespace

extern "C" int tba_pair_blocks(const float* packed, const float* lam, const int* items,
                               int n_items, const int* pieces, int n_pieces, const int* empty,
                               int n_empty, const int* fold_seg, const int* fold_start,
                               int n_split, float* partial, float* out, int n_pairs, int k_pad,
                               int group_log2, float diag_floor, float diag_ceil,
                               void* stream) {
  if (k_pad <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define TBA_PAIR_LAUNCH(G)                                                                 \
  launch<G>(packed, lam, items, n_items, pieces, n_pieces, empty, n_empty, partial, out, \
            n_pairs, k_pad, diag_floor, diag_ceil, s)
  switch (group_log2) {
    case 0: err = TBA_PAIR_LAUNCH(1); break;
    case 1: err = TBA_PAIR_LAUNCH(2); break;
    case 2: err = TBA_PAIR_LAUNCH(4); break;
    case 3: err = TBA_PAIR_LAUNCH(8); break;
    case 4: err = TBA_PAIR_LAUNCH(16); break;
    case 5: err = TBA_PAIR_LAUNCH(32); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TBA_PAIR_LAUNCH
  if (err != cudaSuccess || n_split == 0) return static_cast<int>(err);
  const dim3 grid((n_split + kFoldThreads - 1) / kFoldThreads, 81);
  pair_fold_kernel<<<grid, kFoldThreads, 0, s>>>(partial, n_pieces, fold_seg, fold_start,
                                                 n_split, out, k_pad);
  return static_cast<int>(cudaGetLastError());
}
