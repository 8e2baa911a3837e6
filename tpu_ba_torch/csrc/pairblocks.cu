// K7: damped pair products reduced by compact covisibility segment.
//
//   out[9m+n, k] = Σ_{pairs q of segment k} [ W_i(q) · V_λ(q)⁻¹ · W_j(q)ᵀ ][m, n]
//
// packed (63, Np): rows 0–26 W[pair_i], 27–53 W[pair_j], 54–62 V[pair_pt];
// the pairs are sorted by segment, seg_start (k_pad + 1) are the CSR starts.
// Replaces the Pallas kernel tpu_ba/kernels/pairblocks.py:fused_pair_blocks
// (pair products in VMEM, one-hot MXU reduction over a chunk/tile work list).
//
// Bound: device-memory bytes. A pair is 63 floats in and does ~900 flops; a
// segment is 81 floats out, and most of the band grid's segments are empty
// (ladybug-1723: 77,824 pairs into 30,720 segments), so the write of the
// zero-filled output is a third of the traffic.
//
// Design: a group of G lanes (a power of two ≤ 32, chosen by the caller from
// the mean segment length) owns one segment. Its lanes take the segment's
// pairs in turn, each keeping the whole 9×9 block in registers, and the group
// folds the blocks with warp shuffles in a fixed tree: no atomics, the same
// sum every run. An empty segment writes exact zeros, so the output needs no
// clearing pass. The pair products never reach memory.
#include <cuda_runtime.h>

#include "bandmath.cuh"

namespace {

constexpr int kPairThreads = 128;

template <int G>
__global__ void __launch_bounds__(kPairThreads)
pair_blocks_kernel(const float* __restrict__ packed, const int* __restrict__ seg_start,
                   const float* __restrict__ lam_p, float* __restrict__ out, int n_pairs,
                   int k_pad, float lo, float hi) {
  const long long gid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int seg = static_cast<int>(gid / G);
  const int lane = static_cast<int>(gid % G);
  const bool active = seg < k_pad;
  const float lam = *lam_p;
  const size_t np = static_cast<size_t>(n_pairs);

  float acc[81];
#pragma unroll
  for (int e = 0; e < 81; ++e) acc[e] = 0.0f;

  if (active) {
    const int end = seg_start[seg + 1];
    for (int q = seg_start[seg] + lane; q < end; q += G) {
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
  }
  // every lane of the warp takes part in the shuffles; groups never mix
#pragma unroll
  for (int off = G >> 1; off > 0; off >>= 1) {
#pragma unroll
    for (int e = 0; e < 81; ++e) acc[e] += __shfl_down_sync(0xffffffffu, acc[e], off, G);
  }
  if (active && lane == 0) {
#pragma unroll
    for (int e = 0; e < 81; ++e) out[static_cast<size_t>(e) * k_pad + seg] = acc[e];
  }
}

template <int G>
cudaError_t launch(const float* packed, const int* seg_start, const float* lam, float* out,
                   int n_pairs, int k_pad, float lo, float hi, cudaStream_t stream) {
  const long long n_threads = static_cast<long long>(k_pad) * G;
  const long long n_blocks = (n_threads + kPairThreads - 1) / kPairThreads;
  pair_blocks_kernel<G><<<static_cast<unsigned>(n_blocks), kPairThreads, 0, stream>>>(
      packed, seg_start, lam, out, n_pairs, k_pad, lo, hi);
  return cudaGetLastError();
}

}  // namespace

extern "C" int tba_pair_blocks(const float* packed, const int* seg_start, const float* lam,
                               float* out, int n_pairs, int k_pad, int group_log2,
                               float diag_floor, float diag_ceil, void* stream) {
  if (k_pad <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (group_log2) {
    case 0: return static_cast<int>(launch<1>(packed, seg_start, lam, out, n_pairs, k_pad, diag_floor, diag_ceil, s));
    case 1: return static_cast<int>(launch<2>(packed, seg_start, lam, out, n_pairs, k_pad, diag_floor, diag_ceil, s));
    case 2: return static_cast<int>(launch<4>(packed, seg_start, lam, out, n_pairs, k_pad, diag_floor, diag_ceil, s));
    case 3: return static_cast<int>(launch<8>(packed, seg_start, lam, out, n_pairs, k_pad, diag_floor, diag_ceil, s));
    case 4: return static_cast<int>(launch<16>(packed, seg_start, lam, out, n_pairs, k_pad, diag_floor, diag_ceil, s));
    case 5: return static_cast<int>(launch<32>(packed, seg_start, lam, out, n_pairs, k_pad, diag_floor, diag_ceil, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
