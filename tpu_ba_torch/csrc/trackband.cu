// K5: band blocks of the consecutive-camera tracks.
//
// For a tracked point p with start camera key[p] and slots a ≤ b (masked
// slots count as zero W):
//
//   out[(b−a)·81 + 9m+n, key[p] + a] += [ W_a(p) · V_λ(p)⁻¹ · W_b(p)ᵀ ][m, n]
//
// Wt (27, dmax, Pt), Vt (9, Pt), mask (dmax, Pt), points sorted by key;
// key_start (c_pad + 1) are the CSR starts of the keys of the real points;
// out (dmax·81, c_pad). Replaces the Pallas kernel
// tpu_ba/kernels/trackband.py:fused_track_blocks (slot-pair products in VMEM,
// one-hot MXU reduction keyed by start camera over a margin-extended work
// list).
//
// Bound: device-memory bytes; Wt is the largest operand of the whole band
// build (ladybug-1723: 58.6 MB of 64.7 MB read, 2.9 MB written), against
// ~8,000 flops a point.
//
// Design: one block per band column c. The keys are sorted, so the points
// that write column c through slot a are the contiguous run with key = c − a:
// the block walks a = 0..dmax−1 and each run in order, which fixes the sum
// order and needs neither atomics nor the reference's margin plan. A chunk of
// 16 points is staged in shared memory (W of slots a.. premultiplied by the
// mask, V_λ⁻¹, then M = W_a·V_λ⁻¹), and each thread owns up to three of the
// column's dmax·81 outputs in registers. A point is read once for each slot
// it has, mostly from L2, since neighbouring columns run at the same time. A
// column no track reaches writes exact zeros.
#include <cuda_runtime.h>

#include "bandmath.cuh"

namespace {

constexpr int kTrkThreads = 256;
constexpr int kTrkPts = 16;     // points staged per step
constexpr int kTrkMaxD = 8;     // the planner's dmax_cap
constexpr int kTrkOwn = (kTrkMaxD * 81 + kTrkThreads - 1) / kTrkThreads;

__global__ void __launch_bounds__(kTrkThreads)
track_blocks_kernel(const float* __restrict__ Wt, const float* __restrict__ Vt,
                    const float* __restrict__ mask, const int* __restrict__ key_start,
                    const float* __restrict__ lam_p, float* __restrict__ out, int dmax,
                    int pt_pad, int c_pad, float lo, float hi) {
  __shared__ float w_s[kTrkPts][kTrkMaxD][27];
  __shared__ float m_s[kTrkPts][27];
  __shared__ float inv_s[kTrkPts][9];

  const int c = blockIdx.x;
  const int t = threadIdx.x;
  const float lam = *lam_p;
  const int n_rows = dmax * 81;
  const size_t pp = static_cast<size_t>(pt_pad);

  float acc[kTrkOwn];
  int o_off[kTrkOwn], o_m[kTrkOwn], o_n[kTrkOwn];
#pragma unroll
  for (int q = 0; q < kTrkOwn; ++q) {
    const int o = t + q * kTrkThreads;
    acc[q] = 0.0f;
    o_off[q] = o < n_rows ? o / 81 : dmax;    // dmax: owns nothing
    o_m[q] = (o % 81) / 9;
    o_n[q] = o % 9;
  }

  for (int a = 0; a < dmax && a <= c; ++a) {
    const int key = c - a;
    const int p0 = key_start[key], p1 = key_start[key + 1];
    const int n_slots = dmax - a;             // slots a..dmax−1 are needed
    for (int base = p0; base < p1; base += kTrkPts) {
      const int np = min(kTrkPts, p1 - base);
      for (int idx = t; idx < np * n_slots * 27; idx += kTrkThreads) {
        const int j = idx % np;
        const int rest = idx / np;
        const int s = a + rest % n_slots;
        const int row = rest / n_slots;
        const size_t p = static_cast<size_t>(base + j);
        w_s[j][s][row] = Wt[(static_cast<size_t>(row) * dmax + s) * pp + p] * mask[s * pp + p];
      }
      if (t < np) {
        float v[9];
#pragma unroll
        for (int e = 0; e < 9; ++e) v[e] = Vt[e * pp + base + t];
        tba::damped_inv3(v, lam, lo, hi, inv_s[t]);
      }
      __syncthreads();
      for (int idx = t; idx < np * 27; idx += kTrkThreads) {
        const int j = idx / 27, r = idx % 27;
        m_s[j][r] = tba::w_inv_entry(w_s[j][a], inv_s[j], r / 3, r % 3);
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < kTrkOwn; ++q) {
        const int b = a + o_off[q];
        if (b < dmax) {
          float sum = acc[q];
          for (int j = 0; j < np; ++j) sum += tba::block_entry(m_s[j], w_s[j][b], o_m[q], o_n[q]);
          acc[q] = sum;
        }
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int q = 0; q < kTrkOwn; ++q) {
    const int o = t + q * kTrkThreads;
    if (o < n_rows) out[static_cast<size_t>(o) * c_pad + c] = acc[q];
  }
}

}  // namespace

extern "C" int tba_track_blocks(const float* Wt, const float* Vt, const float* mask,
                                const int* key_start, const float* lam, float* out, int dmax,
                                int pt_pad, int c_pad, float diag_floor, float diag_ceil,
                                void* stream) {
  if (dmax < 1 || dmax > kTrkMaxD) return static_cast<int>(cudaErrorInvalidValue);
  if (c_pad <= 0) return static_cast<int>(cudaGetLastError());
  track_blocks_kernel<<<static_cast<unsigned>(c_pad), kTrkThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      Wt, Vt, mask, key_start, lam, out, dmax, pt_pad, c_pad, diag_floor, diag_ceil);
  return static_cast<int>(cudaGetLastError());
}
