// K6: band blocks of the slot-major points (short tracks with gaps), one
// launch per degree bucket.
//
// For a point p of the bucket with slots a ≤ b (both unmasked), cameras
// cam_a < cam_b (or a = b) and off = cam_b − cam_a:
//
//   out[9m+n, off_idx[off]·c_pad + cam_a] += [ W_a(p) · V_λ(p)⁻¹ · W_b(p)ᵀ ][m, n]
//
// W (27, d, Pk), cam (d, Pk) int32, mask (d, Pk), V (9, Pk); inc_start
// (c_pad + 1) and inc (the bucket's unmasked (point, slot) incidences, code
// p·16 + a) list, band row by band row r, the incidences whose camera is r in
// ascending p; off_idx (17) maps a local offset to its slot in the band (−1:
// none, the product is dropped); out (81 rows of ld_out) holds the off-major
// band grid in its first columns and is accumulated into: the caller hands
// over the band under assembly, or a cleared grid. Replaces the Pallas kernel
// tpu_ba/kernels/slotband.py:fused_slot_blocks and the fold that
// slot_band_blocks chains behind it (a tile-local one-hot grid, a host-sorted
// permutation and a segment sum): here the products go straight to the band.
//
// Bound: device-memory bytes (ladybug-1723, one bucket of degree 4: 14.6 MB
// of W, 1.2 MB of V, 1.1 MB of cameras and masks, 0.5 MB of incidences read;
// the band cells of the 13 local offsets that have a band slot, 7.5 MB, read
// and written in place), against ~4,000 flops a point. W's point axis is the
// fast one, so one (point, slot)'s 27 values lie d·Pk·4 bytes apart: what
// costs is the number of times a (point, slot) is fetched, and from where.
//
// Design: one block per band row r, over r's incidences only. The earlier
// design took every point whose start camera lay in [r − span, r] (about 17 ×
// the points that touch r) and staged all their slots; here the host lists
// the (point, slot a) with cam_a = r, so a block reads W_b for b ≥ a of the
// points that touch r and nothing else, and forms each damped inverse and
// M = W_a·V_λ⁻¹ once per incidence. The incidences come in chunks of up to 32
// (at most 128 staged slots), neighbouring threads on neighbouring
// incidences, so neighbouring lanes read nearby points. Each of the 17 local
// offsets has a warp that owns its 81 cells in registers (a lane holds
// entries lane, lane + 32, lane + 64); per chunk it takes one ballot of which
// incidences reach its offset and adds those in ascending order: each cell
// has one owner, the points are added in the order of the list, so the sum
// is the same every run, with no atomics, and each (row, offset) cell is
// written by one block, once. Three barriers per chunk; an offset without a
// band slot costs its warp nothing past staging.
//
// Measured on an H100 (ladybug-1723, adding into the band, W from device
// memory): 0.196 ms against 0.353 for the earlier design, ~24× the byte
// bound, and the same from L2, so W's bytes are not what limits it. A
// variant with the offsets listed on the host (no cam or mask reads), every
// warp staging W and fewer shared loads a product ran slower (0.224 ms, with
// register spills at this block's 32-register cap): the limit lies in the
// chunk's barriers and the offset-0 warp, which walks every incidence of the
// row while the others wait, not in memory traffic.
#include <cuda_runtime.h>

#include "bandmath.cuh"

namespace {

constexpr int kSlotOffs = 17;                  // SLOT_SPAN_CAP + 1: a warp each
constexpr int kSlotThreads = 32 * kSlotOffs;   // 544
constexpr int kSlotMaxD = 16;                  // SLOT_DEG_CAP
constexpr int kSlotStage = 128;                // staged (incidence, slot) cells per chunk
constexpr int kSlotInc = 32;                   // at most this many incidences per chunk

__global__ void __launch_bounds__(kSlotThreads, 3)
slot_blocks_kernel(const float* __restrict__ W, const int* __restrict__ cam,
                   const float* __restrict__ mask, const float* __restrict__ V,
                   const int* __restrict__ inc_start, const int* __restrict__ inc,
                   const int* __restrict__ off_idx, const float* __restrict__ lam_p,
                   float* __restrict__ out, int d, int pk, int c_pad, int ld_out, float lo,
                   float hi) {
  __shared__ float w_s[kSlotStage * 27];        // [(j·d + s)·27 + row], s ≥ a_j only
  __shared__ float m_s[kSlotInc][27];
  __shared__ float inv_s[kSlotInc][9];
  __shared__ int a_s[kSlotInc];
  __shared__ signed char b_s[kSlotInc][kSlotOffs];   // slot b of incidence j at offset o, −1: none

  const int r = blockIdx.x;
  const int t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31;      // warp = the local offset it owns
  const bool owns = off_idx[warp] >= 0;
  const float lam = *lam_p;
  const size_t pp = static_cast<size_t>(pk);
  const int chunk = min(kSlotInc, kSlotStage / d);
  float acc[3] = {0.0f, 0.0f, 0.0f};

  const int lo_i = inc_start[r];
  const int hi_i = inc_start[r + 1];
  for (int base = lo_i; base < hi_i; base += chunk) {
    const int nj = min(chunk, hi_i - base);
    if (t < nj) {
      const int code = inc[base + t];
      const int p = code >> 4, a = code & 15;
      a_s[t] = a;
      for (int o = 0; o < kSlotOffs; ++o) b_s[t][o] = -1;
      for (int s = a; s < d; ++s) {
        const int off = cam[s * pp + p] - r;
        if (mask[s * pp + p] > 0.0f && off >= 0 && off < kSlotOffs) {
          b_s[t][off] = static_cast<signed char>(s);
        }
      }
      float v[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) v[k] = V[k * pp + p];
      tba::damped_inv3(v, lam, lo, hi, inv_s[t]);
    }
    // W_s for s ≥ a of every incidence of the chunk; j runs fastest, so a
    // warp reads one W row at ascending points
    for (int idx = t; idx < nj * d * 27; idx += kSlotThreads) {
      const int j = idx % nj;
      const int rest = idx / nj;
      const int s = rest % d;
      const int row = rest / d;
      const int code = inc[base + j];
      if (s < (code & 15)) continue;
      w_s[(j * d + s) * 27 + row] =
          W[(static_cast<size_t>(row) * d + s) * pp + static_cast<size_t>(code >> 4)];
    }
    __syncthreads();
    for (int idx = t; idx < nj * 27; idx += kSlotThreads) {
      const int j = idx / 27, q = idx % 27;
      m_s[j][q] = tba::w_inv_entry(&w_s[(j * d + a_s[j]) * 27], inv_s[j], q / 3, q % 3);
    }
    __syncthreads();
    if (owns) {
      const int my_b = lane < nj ? b_s[lane][warp] : -1;
      unsigned hit = __ballot_sync(0xffffffffu, my_b >= 0);
      while (hit) {                            // ascending j: the order of the list
        const int j = __ffs(hit) - 1;
        hit &= hit - 1;
        const int b = __shfl_sync(0xffffffffu, my_b, j);
        const float* wb = &w_s[(j * d + b) * 27];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const int e = lane + 32 * k;
          if (e < 81) acc[k] += tba::block_entry(m_s[j], wb, e / 9, e % 9);
        }
      }
    }
    __syncthreads();
  }
  if (owns) {
    const size_t col = static_cast<size_t>(off_idx[warp]) * c_pad + r;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int e = lane + 32 * k;
      if (e < 81) out[static_cast<size_t>(e) * ld_out + col] += acc[k];
    }
  }
}

}  // namespace

extern "C" int tba_slot_blocks(const float* W, const int* cam, const float* mask, const float* V,
                               const int* inc_start, const int* inc, const int* off_idx,
                               const float* lam, float* out, int degree, int pt_pad, int c_pad,
                               int ld_out, float diag_floor, float diag_ceil, void* stream) {
  if (degree < 1 || degree > kSlotMaxD) return static_cast<int>(cudaErrorInvalidValue);
  if (c_pad <= 0) return static_cast<int>(cudaGetLastError());
  slot_blocks_kernel<<<static_cast<unsigned>(c_pad), kSlotThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      W, cam, mask, V, inc_start, inc, off_idx, lam, out, degree, pt_pad, c_pad, ld_out,
      diag_floor, diag_ceil);
  return static_cast<int>(cudaGetLastError());
}
