// Arithmetic shared by the three band-build kernels (pairblocks.cu,
// trackband.cu, slotband.cu): the damped 3×3 point-block inverse and the two
// small products of  W_a · V_λ⁻¹ · W_bᵀ.  One definition, so the three
// builds cannot drift apart; the plain PyTorch counterpart is
// tpu_ba_torch/solver/schur.py:inv3x3_rows with the damping of
// tpu_ba_torch/kernels/pairblocks.py:damped_vinv_rows.
//
// Layouts: a 3×3 point block is 9 floats, entry 3a+b; a W block (9×3) is 27
// floats, entry 3m+a; a camera-pair block (9×9) is 81 floats, entry 9m+n.
#pragma once
#include <cuda_runtime.h>

namespace tba {

__device__ __forceinline__ float clipf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// inv = (V + λ·clip(diag V, lo, hi))⁻¹ by the adjugate over the determinant,
// in the order of inv3x3_rows; a determinant below 1e-30 in magnitude (a
// padded or empty block) is replaced by 1e-30. At small λ the blocks of short
// tracks are near-singular, so any f32 evaluation is far from f64 there; the
// compiler's fused multiply-adds make it no worse (measured on an H100 at
// ladybug-1723, λ = 1e-4: within a factor 2.7 of the plain f32 version's
// error on all three builds, with or without contraction).
__device__ __forceinline__ void damped_inv3(const float v[9], float lam, float lo, float hi,
                                            float inv[9]) {
  const float a = v[0] + lam * clipf(v[0], lo, hi), b = v[1], c = v[2];
  const float d = v[3], e = v[4] + lam * clipf(v[4], lo, hi), f = v[5];
  const float g = v[6], h = v[7], i = v[8] + lam * clipf(v[8], lo, hi);
  const float A = e * i - f * h;
  const float B = f * g - d * i;
  const float Cc = d * h - e * g;
  float det = a * A + b * B + c * Cc;
  if (fabsf(det) < 1e-30f) det = 1e-30f;
  inv[0] = A / det;
  inv[1] = (c * h - b * i) / det;
  inv[2] = (b * f - c * e) / det;
  inv[3] = B / det;
  inv[4] = (a * i - c * g) / det;
  inv[5] = (c * d - a * f) / det;
  inv[6] = Cc / det;
  inv[7] = (b * g - a * h) / det;
  inv[8] = (a * e - b * d) / det;
}

// One entry of M = W · V_λ⁻¹ (9×3): M[3m+b] = Σ_a W[3m+a] · inv[3a+b].
__device__ __forceinline__ float w_inv_entry(const float* w, const float* inv, int m, int b) {
  return w[3 * m] * inv[b] + w[3 * m + 1] * inv[3 + b] + w[3 * m + 2] * inv[6 + b];
}

// One entry of the block M · W_bᵀ (9×9): Σ_b M[3m+b] · W_b[3n+b].
__device__ __forceinline__ float block_entry(const float* m_rows, const float* wb, int m, int n) {
  return m_rows[3 * m] * wb[3 * n] + m_rows[3 * m + 1] * wb[3 * n + 1] +
         m_rows[3 * m + 2] * wb[3 * n + 2];
}

}  // namespace tba
