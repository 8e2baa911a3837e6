// Shared per-observation BAL projection and robust loss, for the linearize
// kernel (K2) and the trial-cost kernel (K3) in linearize.cu.
//
// Both kernels call the SAME project_bal_core, so the projection model
// (Rodrigues with its small-angle Taylor branch, the z-guard, the radial
// distortion) cannot diverge between the cost and the linearization. This is
// the rule of tpu_ba/kernels/linearize.py:_projection_core, whose arithmetic
// this file follows line for line, in f32.
#pragma once

#include <cuda_runtime.h>

namespace tba {

// below this squared rotation angle the Rodrigues coefficients switch to
// their Taylor forms (tpu_ba/geometry/rotations.py:_SMALL_THETA2)
constexpr float kSmallTheta2 = 1e-12f;
constexpr float kZGuard = 1e-12f;

enum RobustKind { kRobustNone = 0, kRobustHuber = 1, kRobustCauchy = 2, kRobustArctan = 3 };

struct Projection {
  float aa[3];
  float K[3][3];  // skew(aa)
  float R[3][3];
  float t2;       // θ²
  bool small;     // θ² < kSmallTheta2
  float inv_z, p0, p1, s, d;
  float r0, r1;   // masked residual (u − uv)·mask
};

// cam: [aa(3), t(3), f, k1, k2]; X: point; (u_obs, v_obs): measurement;
// mk: 1 for a real observation, 0 for a padding row.
__device__ __forceinline__ void project_bal_core(const float cam[9], const float X[3],
                                                 float u_obs, float v_obs, float mk,
                                                 Projection& o) {
  const float a0 = cam[0], a1 = cam[1], a2 = cam[2];
  o.aa[0] = a0;
  o.aa[1] = a1;
  o.aa[2] = a2;
  const float t2 = a0 * a0 + a1 * a1 + a2 * a2;
  const bool small = t2 < kSmallTheta2;
  const float th = sqrtf(small ? 1.0f : t2);
  // R = I + A·K + B·(aa aaᵀ − θ² I)
  const float A = small ? 1.0f - t2 / 6.0f : sinf(th) / th;
  const float B = small ? 0.5f - t2 / 24.0f : (1.0f - cosf(th)) / t2;
  o.K[0][0] = 0.0f; o.K[0][1] = -a2;  o.K[0][2] = a1;
  o.K[1][0] = a2;   o.K[1][1] = 0.0f; o.K[1][2] = -a0;
  o.K[2][0] = -a1;  o.K[2][1] = a0;   o.K[2][2] = 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float delta = (i == j) ? 1.0f : 0.0f;
      o.R[i][j] = delta + A * o.K[i][j] + B * (o.aa[i] * o.aa[j] - ((i == j) ? t2 : 0.0f));
    }
  }
  o.t2 = t2;
  o.small = small;

  // P = R X + t, perspective division down −z, radial distortion
  float P[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    P[i] = o.R[i][0] * X[0] + o.R[i][1] * X[1] + o.R[i][2] * X[2] + cam[3 + i];
  }
  const float z = P[2];
  const float z_safe = fabsf(z) < kZGuard ? kZGuard : z;
  o.inv_z = 1.0f / z_safe;
  o.p0 = -P[0] * o.inv_z;
  o.p1 = -P[1] * o.inv_z;
  o.s = o.p0 * o.p0 + o.p1 * o.p1;
  const float f = cam[6], k1 = cam[7], k2 = cam[8];
  o.d = 1.0f + o.s * (k1 + o.s * k2);
  o.r0 = (f * o.d * o.p0 - u_obs) * mk;
  o.r1 = (f * o.d * o.p1 - v_obs) * mk;
}

// arctan(x) for x ≥ 0: the same reduction and minimax polynomial as
// tpu_ba/residuals/robust.py:atan_pos, which the reference's kernels use.
__device__ __forceinline__ float atan_pos(float x) {
  const bool inv = x > 1.0f;
  const float xr = inv ? 1.0f / fmaxf(x, 1e-30f) : x;
  const bool big = xr > 0.4142135623730951f;
  const float x1 = big ? (xr - 1.0f) / (xr + 1.0f) : xr;
  const float z = x1 * x1;
  const float p = x1 + x1 * z * (-3.33329491539e-1f + z * (1.99777106478e-1f +
                                  z * (-1.38776856032e-1f + z * 8.05374449538e-2f)));
  const float r = big ? 0.7853981633974483f + p : p;
  return inv ? 1.5707963267948966f - r : r;
}

// ρ(s) for a squared residual norm s (tpu_ba/residuals/robust.py:robust_rho,
// pallas=True)
__device__ __forceinline__ float robust_rho(int kind, float s, float scale) {
  const float a2 = scale * scale;
  switch (kind) {
    case kRobustHuber:
      return s <= a2 ? s : 2.0f * scale * sqrtf(fmaxf(s, a2)) - a2;
    case kRobustCauchy:
      return a2 * log1pf(s / a2);
    case kRobustArctan:
      return a2 * atan_pos(s / a2);
    default:
      return s;
  }
}

// IRLS weight ρ′(s) (tpu_ba/residuals/robust.py:robust_weight)
__device__ __forceinline__ float robust_weight(int kind, float s, float scale) {
  const float a2 = scale * scale;
  switch (kind) {
    case kRobustHuber:
      return s <= a2 ? 1.0f : scale / sqrtf(fmaxf(s, a2));
    case kRobustCauchy:
      return 1.0f / (1.0f + s / a2);
    case kRobustArctan: {
      const float q = s / a2;
      return 1.0f / (1.0f + q * q);
    }
    default:
      return 1.0f;
  }
}

// Sum of v over the warp, returned in every lane; a fixed order, so the
// result is deterministic.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace tba
