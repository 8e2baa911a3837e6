// K2: fused linearize + assemble, and K3: fused trial cost (BAL model).
//
// K2 replaces tpu_ba/kernels/linearize.py:fused_linearize_assemble
// (_make_kernel). Per observation it computes the residual, the analytic
// Jacobian blocks Jc (2×9) and Jp (2×3), the robust IRLS weight √ρ′ and the
// products the Schur solver needs:
//   obs_out rows  0..26  W   = Jcᵀ Jp          (row 3m+n)
//                27..35  VtV = Jpᵀ Jp          (row 3m+n)
//                36..38  gp  = Jpᵀ r
//                39      ρ(|r|²)·mask
// and reduces U = Σ Jcᵀ Jc (C,9,9) and gc = Σ Jcᵀ r (C,9) by camera. ρ is taken
// on the unweighted residual; every product uses the √ρ′-weighted J and r.
//
// K3 replaces tpu_ba/kernels/linearize.py:fused_cost (_make_cost_kernel):
// ½ Σ ρ(|r|²) over the valid observations.
//
// Both call tba::project_bal_core (projection.cuh), so cost and
// linearization cannot diverge.
//
// Bound: K2 is bound by its writes, 40 floats per observation (109 MB at
// ladybug-1723), plus about 400 flops per observation, well below the
// card's f32 rate. K3 reads 14 values per observation and writes nothing per
// observation; it is bound by the gathers of camera and point rows.
//
// Design of K2: one block per camera. The problem is camera-sorted
// (tpu_ba_torch/core.py:make_problem), so a camera's observations are one
// contiguous run [cam_start[c], cam_start[c+1]). The block loads the camera
// once; each thread takes a strided share of the run, writes each
// observation's 40 rows (coalesced across the block) and keeps its share of
// the 45 upper-triangle entries of U and the 9 of gc in registers. A warp
// shuffle and a fixed-order pass over the warps then reduce those 54 sums,
// and U's lower triangle is mirrored from the upper. No atomics, so the
// result is deterministic. Padding rows carry mask 0 and the last camera's
// and point's index: their weight √ρ′·mask is 0, so they write exact zeros.
//
// Design of K3: a grid-stride pass in which each thread sums ρ·mask over its
// observations, one partial per block, then one block adds the partials in a
// fixed order and writes ½Σ. The grid size depends only on O, so the sum
// order, and the result, are the same on every call.
#include <cuda_runtime.h>

#include "projection.cuh"

namespace {

using tba::Projection;

constexpr int kLinThreads = 128;
constexpr int kLinWarps = kLinThreads / 32;
constexpr int kUpper = 45;           // upper triangle of the 9×9 U block
constexpr int kCamSums = kUpper + 9; // + gc
constexpr int kObsRows = 40;
constexpr int kCostThreads = 256;

__global__ void __launch_bounds__(kLinThreads)
linearize_kernel(const float* __restrict__ cams, const float* __restrict__ pts,
                 const float* __restrict__ obs, const int* __restrict__ pt_idx,
                 const unsigned char* __restrict__ mask, const int* __restrict__ cam_start,
                 int n_obs, int robust_kind, float robust_scale, unsigned freeze_mask,
                 float* __restrict__ U, float* __restrict__ gc, float* __restrict__ obs_out) {
  const int c = blockIdx.x;
  const int begin = cam_start[c];
  const int end = cam_start[c + 1];
  float cam[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) cam[i] = cams[static_cast<size_t>(c) * 9 + i];
  const float f = cam[6], k1 = cam[7], k2 = cam[8];

  float acc[kCamSums];
#pragma unroll
  for (int q = 0; q < kCamSums; ++q) acc[q] = 0.0f;

  for (int o = begin + threadIdx.x; o < end; o += kLinThreads) {
    const int p = pt_idx[o];
    const float X[3] = {pts[3 * static_cast<size_t>(p)], pts[3 * static_cast<size_t>(p) + 1],
                        pts[3 * static_cast<size_t>(p) + 2]};
    const float mk = mask[o] ? 1.0f : 0.0f;
    Projection pc;
    tba::project_bal_core(cam, X, obs[2 * static_cast<size_t>(o)],
                          obs[2 * static_cast<size_t>(o) + 1], mk, pc);

    // robust IRLS on the unweighted (masked) residual
    const float sr = pc.r0 * pc.r0 + pc.r1 * pc.r1;
    const float rho = tba::robust_rho(robust_kind, sr, robust_scale) * mk;
    const float sw = sqrtf(tba::robust_weight(robust_kind, sr, robust_scale)) * mk;

    // du/dp (2×2) and du/dP (2×3)
    const float pv[2] = {pc.p0, pc.p1};
    const float g2 = 2.0f * (k1 + 2.0f * k2 * pc.s);
    float du_dp[2][2];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        du_dp[a][b] = f * (pc.d * (a == b ? 1.0f : 0.0f) + g2 * pv[a] * pv[b]);
      }
    }
    float du_dP[2][3];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      du_dP[a][0] = -du_dp[a][0] * pc.inv_z;
      du_dP[a][1] = -du_dp[a][1] * pc.inv_z;
      du_dP[a][2] = -(du_dp[a][0] * pc.p0 + du_dp[a][1] * pc.p1) * pc.inv_z;
    }

    // dP/daa: Gallego–Yezzi, −R[X]×(aa aaᵀ + (Rᵀ − I)[aa]×)/θ², or −[X]× for small θ
    const float Xk[3][3] = {{0.0f, -X[2], X[1]}, {X[2], 0.0f, -X[0]}, {-X[1], X[0], 0.0f}};
    float dPda[3][3];
    if (pc.small) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j) dPda[i][j] = -Xk[i][j];
      }
    } else {
      float core[3][3], RXk[3][3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          float acc_c = pc.aa[i] * pc.aa[j];
#pragma unroll
          for (int l = 0; l < 3; ++l) acc_c += (pc.R[l][i] - (l == i ? 1.0f : 0.0f)) * pc.K[l][j];
          core[i][j] = acc_c / pc.t2;
          RXk[i][j] = pc.R[i][0] * Xk[0][j] + pc.R[i][1] * Xk[1][j] + pc.R[i][2] * Xk[2][j];
        }
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          dPda[i][j] = -(RXk[i][0] * core[0][j] + RXk[i][1] * core[1][j] + RXk[i][2] * core[2][j]);
        }
      }
    }

    // weighted Jc (2×9), Jp (2×3) and residual
    float Jc[2][9], Jp[2][3];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        Jc[a][j] = (du_dP[a][0] * dPda[0][j] + du_dP[a][1] * dPda[1][j] +
                    du_dP[a][2] * dPda[2][j]) * sw;
        Jc[a][3 + j] = du_dP[a][j] * sw;
        Jp[a][j] = (du_dP[a][0] * pc.R[0][j] + du_dP[a][1] * pc.R[1][j] +
                    du_dP[a][2] * pc.R[2][j]) * sw;
      }
      Jc[a][6] = pc.d * pv[a] * sw;
      Jc[a][7] = f * pc.s * pv[a] * sw;
      Jc[a][8] = f * pc.s * pc.s * pv[a] * sw;
#pragma unroll
      for (int col = 0; col < 9; ++col) {
        if ((freeze_mask >> col) & 1u) Jc[a][col] = 0.0f;  // frozen column ⇒ zero step
      }
    }
    const float r0 = pc.r0 * sw;
    const float r1 = pc.r1 * sw;

    // per-observation rows
    float* out = obs_out + o;
    const size_t stride = static_cast<size_t>(n_obs);
#pragma unroll
    for (int m = 0; m < 9; ++m) {
#pragma unroll
      for (int n = 0; n < 3; ++n) {
        out[(3 * m + n) * stride] = Jc[0][m] * Jp[0][n] + Jc[1][m] * Jp[1][n];
      }
    }
#pragma unroll
    for (int m = 0; m < 3; ++m) {
#pragma unroll
      for (int n = 0; n < 3; ++n) {
        out[(27 + 3 * m + n) * stride] = Jp[0][m] * Jp[0][n] + Jp[1][m] * Jp[1][n];
      }
    }
#pragma unroll
    for (int m = 0; m < 3; ++m) out[(36 + m) * stride] = Jp[0][m] * r0 + Jp[1][m] * r1;
    out[39 * stride] = rho;

    // camera-side sums, kept in registers
    int q = 0;
#pragma unroll
    for (int m = 0; m < 9; ++m) {
#pragma unroll
      for (int n = m; n < 9; ++n) acc[q++] += Jc[0][m] * Jc[0][n] + Jc[1][m] * Jc[1][n];
    }
#pragma unroll
    for (int m = 0; m < 9; ++m) acc[kUpper + m] += Jc[0][m] * r0 + Jc[1][m] * r1;
  }

  // block reduction of the 54 sums: warp shuffle, then the warps in order
  __shared__ float partial[kLinWarps][kCamSums];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < kCamSums; ++q) {
    const float v = tba::warp_sum(acc[q]);
    if (lane == 0) partial[warp][q] = v;
  }
  __syncthreads();
  const int q = threadIdx.x;
  if (q < kCamSums) {
    float v = 0.0f;
#pragma unroll
    for (int w = 0; w < kLinWarps; ++w) v += partial[w][q];
    if (q < kUpper) {
      int m = 0, rest = q;
      while (rest >= 9 - m) {
        rest -= 9 - m;
        ++m;
      }
      const int n = m + rest;
      float* Uc = U + static_cast<size_t>(c) * 81;
      Uc[9 * m + n] = v;
      Uc[9 * n + m] = v;
    } else {
      gc[static_cast<size_t>(c) * 9 + (q - kUpper)] = v;
    }
  }
}

__device__ __forceinline__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = tba::warp_sum(v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float total = 0.0f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < (blockDim.x >> 5); ++w) total += scratch[w];
  }
  return total;  // valid in thread 0
}

__global__ void __launch_bounds__(kCostThreads)
cost_partial_kernel(const float* __restrict__ cams, const float* __restrict__ pts,
                    const float* __restrict__ obs, const int* __restrict__ cam_idx,
                    const int* __restrict__ pt_idx, const unsigned char* __restrict__ mask,
                    int n_obs, int robust_kind, float robust_scale, float* __restrict__ partial) {
  __shared__ float scratch[kCostThreads / 32];
  float acc = 0.0f;
  for (int o = blockIdx.x * kCostThreads + threadIdx.x; o < n_obs; o += gridDim.x * kCostThreads) {
    const size_t c = static_cast<size_t>(cam_idx[o]);
    const size_t p = static_cast<size_t>(pt_idx[o]);
    float cam[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) cam[i] = cams[c * 9 + i];
    const float X[3] = {pts[3 * p], pts[3 * p + 1], pts[3 * p + 2]};
    const float mk = mask[o] ? 1.0f : 0.0f;
    Projection pc;
    tba::project_bal_core(cam, X, obs[2 * static_cast<size_t>(o)],
                          obs[2 * static_cast<size_t>(o) + 1], mk, pc);
    const float sr = pc.r0 * pc.r0 + pc.r1 * pc.r1;
    acc += tba::robust_rho(robust_kind, sr, robust_scale) * mk;
  }
  const float total = block_sum(acc, scratch);
  if (threadIdx.x == 0) partial[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kCostThreads)
cost_final_kernel(const float* __restrict__ partial, int n_partial, float* __restrict__ out) {
  __shared__ float scratch[kCostThreads / 32];
  float acc = 0.0f;
  for (int i = threadIdx.x; i < n_partial; i += kCostThreads) acc += partial[i];
  const float total = block_sum(acc, scratch);
  if (threadIdx.x == 0) out[0] = 0.5f * total;
}

}  // namespace

extern "C" int tba_linearize(const float* cams, const float* pts, const float* obs,
                             const int* pt_idx, const unsigned char* mask, const int* cam_start,
                             int n_cameras, int n_obs, int robust_kind, float robust_scale,
                             unsigned freeze_mask, float* U, float* gc, float* obs_out,
                             void* stream) {
  if (n_cameras > 0) {
    linearize_kernel<<<n_cameras, kLinThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        cams, pts, obs, pt_idx, mask, cam_start, n_obs, robust_kind, robust_scale, freeze_mask, U,
        gc, obs_out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tba_cost(const float* cams, const float* pts, const float* obs, const int* cam_idx,
                        const int* pt_idx, const unsigned char* mask, int n_obs, int robust_kind,
                        float robust_scale, float* partial, int n_partial, float* out,
                        void* stream) {
  if (n_partial < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cost_partial_kernel<<<n_partial, kCostThreads, 0, s>>>(cams, pts, obs, cam_idx, pt_idx, mask,
                                                         n_obs, robust_kind, robust_scale, partial);
  cost_final_kernel<<<1, kCostThreads, 0, s>>>(partial, n_partial, out);
  return static_cast<int>(cudaGetLastError());
}
