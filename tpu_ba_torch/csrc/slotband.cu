// K6: band blocks of the slot-major points (short tracks with gaps), one
// launch per degree bucket.
//
// For a point p of the bucket with slots a ≤ b (both unmasked), cameras
// cam_a < cam_b (or a = b) and off = cam_b − cam_a:
//
//   out[9m+n, off_idx[off]·c_pad + cam_a] += [ W_a(p) · V_λ(p)⁻¹ · W_b(p)ᵀ ][m, n]
//
// W (27, d, Pk), cam (d, Pk) int32, mask (d, Pk), V (9, Pk), points sorted by
// start camera cam[0]; row_start (c_pad + 1) are the CSR starts of the real
// points' start cameras; off_idx (17) maps a local offset to its slot in the
// band (−1: none, the product is dropped); out (81 rows of ld_out) holds the
// off-major band grid in its first columns and is accumulated into: the
// caller hands over the band under assembly, or a cleared grid. Replaces the
// Pallas kernel
// tpu_ba/kernels/slotband.py:fused_slot_blocks and the fold that
// slot_band_blocks chains behind it (a tile-local one-hot grid, a host-sorted
// permutation and a segment sum): here the products go straight to the band.
//
// Bound: device-memory bytes (ladybug-1723, one bucket of degree 4: 14.6 MB
// of W, 1.2 MB of V, 1.1 MB of cameras and masks read; the band cells of the
// 13 local offsets that have a band slot, 7.5 MB, read and written in
// place), against ~4,000 flops a point.
//
// Design: one block per band row r (a camera). A point touches row r only
// through a slot whose camera is r, and cam_a − cam_0 ≤ span ≤ 16, so the
// candidates are the contiguous run of points with start camera in
// [r − span, r]. The block stages that run in chunks (coalesced), finds each
// point's slot on r, forms M = W_a·V_λ⁻¹ once, and adds M·W_bᵀ for b ≥ a
// into 17 × 81 shared accumulators, one per local offset. Three groups of 81
// threads share the offsets (group g owns off ≡ g mod 3), so an accumulator
// has one owner and the points are added in run order: no atomics, the same
// sum every run. Each (row, offset) cell belongs to one block, so the final
// read-modify-write of the band needs no synchronisation either.
#include <cuda_runtime.h>

#include "bandmath.cuh"

namespace {

constexpr int kSlotThreads = 256;
constexpr int kSlotGroups = 3;       // 3 × 81 = 243 accumulating threads
constexpr int kSlotMaxD = 16;        // SLOT_DEG_CAP
constexpr int kSlotOffs = 17;        // SLOT_SPAN_CAP + 1
constexpr int kSlotStage = 128;      // staged (point, slot) cells per step
constexpr int kSlotPts = 32;         // at most this many points per step

__global__ void __launch_bounds__(kSlotThreads)
slot_blocks_kernel(const float* __restrict__ W, const int* __restrict__ cam,
                   const float* __restrict__ mask, const float* __restrict__ V,
                   const int* __restrict__ row_start, const int* __restrict__ off_idx,
                   const float* __restrict__ lam_p, float* __restrict__ out, int d, int pk,
                   int span, int c_pad, int ld_out, float lo, float hi) {
  __shared__ float w_s[kSlotStage * 27];          // [(j·d + s)·27 + row]
  __shared__ float m_s[kSlotPts][27];
  __shared__ float inv_s[kSlotPts][9];
  __shared__ int a_s[kSlotPts];                   // the point's slot on row r, −1: none
  __shared__ int off_s[kSlotPts][kSlotMaxD];      // cam_b − r for usable b ≥ a, else −1
  __shared__ float acc_s[kSlotOffs][81];

  const int r = blockIdx.x;
  const int t = threadIdx.x;
  const int g = t / 81, e = t % 81;
  const int em = e / 9, en = e % 9;
  const float lam = *lam_p;
  const size_t pp = static_cast<size_t>(pk);
  const int pts = min(kSlotPts, kSlotStage / d);

  for (int idx = t; idx < kSlotOffs * 81; idx += kSlotThreads) (&acc_s[0][0])[idx] = 0.0f;
  __syncthreads();   // a row without points reads the accumulators straight away

  const int lo_p = row_start[max(r - span, 0)];
  const int hi_p = row_start[r + 1];
  for (int base = lo_p; base < hi_p; base += pts) {
    const int np = min(pts, hi_p - base);
    if (t < np) {
      const size_t p = static_cast<size_t>(base + t);
      int a = -1;
      for (int s = 0; s < d; ++s) {
        if (a < 0 && mask[s * pp + p] > 0.0f && cam[s * pp + p] == r) a = s;
      }
      a_s[t] = a;
      for (int s = 0; s < d; ++s) {
        const int off = cam[s * pp + p] - r;
        const bool use = a >= 0 && s >= a && mask[s * pp + p] > 0.0f && off >= 0 &&
                         off < kSlotOffs;
        off_s[t][s] = use ? off : -1;
      }
      float v[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) v[k] = V[k * pp + p];
      tba::damped_inv3(v, lam, lo, hi, inv_s[t]);
    }
    for (int idx = t; idx < np * d * 27; idx += kSlotThreads) {
      const int j = idx % np;
      const int rest = idx / np;
      const int s = rest % d;
      const int row = rest / d;
      const size_t p = static_cast<size_t>(base + j);
      w_s[(j * d + s) * 27 + row] =
          W[(static_cast<size_t>(row) * d + s) * pp + p] * mask[s * pp + p];
    }
    __syncthreads();
    for (int idx = t; idx < np * 27; idx += kSlotThreads) {
      const int j = idx / 27, q = idx % 27;
      const int a = a_s[j];
      if (a >= 0) m_s[j][q] = tba::w_inv_entry(&w_s[(j * d + a) * 27], inv_s[j], q / 3, q % 3);
    }
    __syncthreads();
    if (g < kSlotGroups) {
      for (int j = 0; j < np; ++j) {
        const int a = a_s[j];
        if (a < 0) continue;
        for (int s = a; s < d; ++s) {
          const int off = off_s[j][s];
          if (off < 0 || off % kSlotGroups != g) continue;
          acc_s[off][e] += tba::block_entry(m_s[j], &w_s[(j * d + s) * 27], em, en);
        }
      }
    }
    __syncthreads();
  }
  if (g < kSlotGroups) {
    for (int off = g; off < kSlotOffs; off += kSlotGroups) {
      const int oi = off_idx[off];
      if (oi >= 0) {
        float* cell = out + static_cast<size_t>(e) * ld_out + static_cast<size_t>(oi) * c_pad + r;
        *cell += acc_s[off][e];
      }
    }
  }
}

}  // namespace

extern "C" int tba_slot_blocks(const float* W, const int* cam, const float* mask, const float* V,
                               const int* row_start, const int* off_idx, const float* lam,
                               float* out, int degree, int pt_pad, int span, int c_pad,
                               int ld_out, float diag_floor, float diag_ceil, void* stream) {
  if (degree < 1 || degree > kSlotMaxD || span < 0 || span >= kSlotOffs) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (c_pad <= 0) return static_cast<int>(cudaGetLastError());
  slot_blocks_kernel<<<static_cast<unsigned>(c_pad), kSlotThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      W, cam, mask, V, row_start, off_idx, lam, out, degree, pt_pad, span, c_pad, ld_out,
      diag_floor, diag_ceil);
  return static_cast<int>(cudaGetLastError());
}
