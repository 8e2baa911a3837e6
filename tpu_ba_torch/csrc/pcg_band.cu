// K4: the whole block-Jacobi PCG solve of the banded reduced camera system
// S = U_λ − T in one kernel (fold-damp variant).
//
// blk (81, ld): the first n_off·c_pad columns are the band grid, column
// o·c_pad + c holding T_{c, c+offs[o]} (entry 9m+n), zero where absent;
// U_t (81, c_pad): the undamped camera blocks; b, x0, x: (C, 9).
//
//   prologue  Ul = U + λ·clip(diag U) on the diagonal; diag S = Ul − T_{c,c};
//             M⁻¹ = (diag S)⁻¹ by 9×9 Gauss–Jordan without pivoting
//   matvec    y_c = Ul_c x_c − Σ_off [ T_{c,c+off} x_{c+off}
//                                      + (off > 0) T_{c−off,c}ᵀ x_{c−off} ]
//   loop      while k < max_iters and r·r > tol²·max(b·b, 1e-30) and ok:
//               pAp = p·Sp; broke = pAp ≤ 0 or rz ≤ 0; α = broke ? 0 : rz/pAp
//               x += αp; r −= αSp; z = M⁻¹r; β = r·z / rz; p = z + βp
//               ok &= !broke; k += 1
//
// step for step the loop of tpu_ba_torch/solver/pcg.py. Replaces the Pallas
// kernel tpu_ba/kernels/pcg_band.py:pcg_banded (fold_damp=True, block-Jacobi),
// which keeps every operand in VMEM and applies the offsets as lane rolls.
//
// Bound: nothing the roofline names. One CG iteration reads the band twice
// (forward and transposed pass; ladybug-1723: 2 × 9.4 MB) from L2, where it
// stays resident across iterations, and does 2·81·33 flops a camera; what it
// costs is the latency of three device-wide barriers and of dependent L2
// reads.
//
// Design: one cooperative launch, all blocks co-resident (the grid is sized
// from the occupancy query), cooperative_groups grid.sync() between the
// phases of an iteration. A block owns groups of 16 cameras; thread (c, j)
// owns row j of camera c, so band and vector reads are coalesced along c. A
// neighbour is addressed as c ± off and bound-checked against C, so the
// ring's wrap-around offsets are ordinary offsets. Vectors live in a small
// global work area (L2). A dot product is a per-block partial (warp shuffles,
// then the warps in order) that every block sums again in index order after
// the barrier: every block gets the same bits and takes the same branch, so
// the loop test runs on the device, nothing is read by the host, and two runs
// give the same iterates. No atomics.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "bandmath.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCams = 16;                  // cameras per group
constexpr int kLive = kCams * 9;           // threads that own a (camera, row)
constexpr int kPcgThreads = 160;           // five full warps; the last 16 threads only reduce
constexpr int kMaxOffsets = 64;

// vector rows are c_pad apart; entries written during the launch are read
// through L2 (__ldcg), since another SM may have written them
__device__ __forceinline__ float vget(const float* v, int c_pad, int j, int c) {
  return __ldcg(v + static_cast<size_t>(j) * c_pad + c);
}

__device__ float block_sum(float v, float* red_s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5;
  __syncthreads();                         // red_s may still be read from the last call
  if ((threadIdx.x & 31) == 0) red_s[warp] = v;
  __syncthreads();
  float s = 0.0f;
  for (int w = 0; w < kPcgThreads / 32; ++w) s += red_s[w];
  return s;
}

__device__ float grid_sum(const float* partial, int n, float* red_s) {
  float v = 0.0f;
  for (int i = threadIdx.x; i < n; i += kPcgThreads) v += __ldcg(partial + i);
  return block_sum(v, red_s);
}

__device__ __forceinline__ float safe_div(float x) { return fabsf(x) < 1e-30f ? 1e-30f : x; }

// row j of (S v)_c
__device__ float apply_S_row(const float* __restrict__ blk, int ld, const float* Ul,
                             const float* v, const int* offs_s, int n_off, int C, int c_pad,
                             int c, int j) {
  float y = 0.0f;
#pragma unroll
  for (int n = 0; n < 9; ++n) {
    y += Ul[static_cast<size_t>(9 * j + n) * c_pad + c] * vget(v, c_pad, n, c);
  }
  float t = 0.0f;
  for (int o = 0; o < n_off; ++o) {
    const int off = offs_s[o];
    const float* band = blk + static_cast<size_t>(o) * c_pad;
    if (c + off < C) {
#pragma unroll
      for (int n = 0; n < 9; ++n) {
        t += band[static_cast<size_t>(9 * j + n) * ld + c] * vget(v, c_pad, n, c + off);
      }
    }
    if (off > 0 && c - off >= 0) {
#pragma unroll
      for (int m = 0; m < 9; ++m) {
        t += band[static_cast<size_t>(9 * m + j) * ld + c - off] * vget(v, c_pad, m, c - off);
      }
    }
  }
  return y - t;
}

__global__ void __launch_bounds__(kPcgThreads)
pcg_banded_kernel(const float* __restrict__ blk, int ld, const float* __restrict__ U_t,
                  const float* __restrict__ b, const float* __restrict__ x0,
                  const int* __restrict__ offs, int n_off, int C, int c_pad,
                  const float* __restrict__ lam_p, const float* __restrict__ tol_p,
                  int max_iters, float lo, float hi, float* work, float* partial,
                  float* __restrict__ x_out, int* __restrict__ it_out, int* __restrict__ ok_out) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float red_s[kPcgThreads / 32];
  __shared__ int offs_s[kMaxOffsets];
  __shared__ float gj_s[kCams][9][19];     // [A | I] rows, padded

  const size_t cp = static_cast<size_t>(c_pad);
  float* Ul = work;
  float* Minv = Ul + 81 * cp;
  float* xg = Minv + 81 * cp;
  float* rg = xg + 9 * cp;
  float* pg = rg + 9 * cp;
  float* apg = pg + 9 * cp;
  float* zg = apg + 9 * cp;

  const int t = threadIdx.x;
  const bool live = t < kLive;
  const int j = live ? t / kCams : 0;      // row of the camera block
  const int cl = live ? t % kCams : 0;     // camera within the group
  const int n_groups = (C + kCams - 1) / kCams;
  const int G = gridDim.x;
  const float lam = *lam_p;
  const float tol = *tol_p;

  for (int i = t; i < n_off; i += kPcgThreads) offs_s[i] = offs[i];

  // prologue: damp U, invert the block diagonal of S, place b-masked x0
  for (int g = blockIdx.x; g < n_groups; g += G) {
    const int c = g * kCams + cl;
    const bool act = live && c < C;
    if (live) {
#pragma unroll
      for (int n = 0; n < 9; ++n) {
        float a = n == j ? 1.0f : 0.0f;    // identity where there is no camera
        if (act) {
          float u = U_t[static_cast<size_t>(9 * j + n) * cp + c];
          if (n == j) u += lam * tba::clipf(u, lo, hi);
          Ul[static_cast<size_t>(9 * j + n) * cp + c] = u;
          a = u - blk[static_cast<size_t>(9 * j + n) * ld + c];
        }
        gj_s[cl][j][n] = a;
        gj_s[cl][j][9 + n] = n == j ? 1.0f : 0.0f;
      }
    }
    __syncthreads();
    for (int kk = 0; kk < 9; ++kk) {
      if (live && j == kk) {
        const float piv = 1.0f / gj_s[cl][kk][kk];
#pragma unroll
        for (int n = 0; n < 18; ++n) gj_s[cl][kk][n] *= piv;
      }
      __syncthreads();
      if (live && j != kk) {
        const float f = gj_s[cl][j][kk];
#pragma unroll
        for (int n = 0; n < 18; ++n) gj_s[cl][j][n] -= f * gj_s[cl][kk][n];
      }
      __syncthreads();
    }
    if (act) {
#pragma unroll
      for (int n = 0; n < 9; ++n) Minv[static_cast<size_t>(9 * j + n) * cp + c] = gj_s[cl][j][9 + n];
      xg[j * cp + c] = x0 != nullptr ? x0[static_cast<size_t>(c) * 9 + j] : 0.0f;
    }
    __syncthreads();
  }
  grid.sync();

  // r0 = b − S x0, z0 = M⁻¹ r0, p0 = z0
  float s_rz = 0.0f, s_bb = 0.0f, s_rr = 0.0f;
  for (int g = blockIdx.x; g < n_groups; g += G) {
    const int c = g * kCams + cl;
    const bool act = live && c < C;
    float bj = 0.0f, r = 0.0f;
    if (act) {
      bj = b[static_cast<size_t>(c) * 9 + j];
      r = bj - apply_S_row(blk, ld, Ul, xg, offs_s, n_off, C, c_pad, c, j);
      rg[j * cp + c] = r;
    }
    __syncthreads();
    if (act) {
      float z = 0.0f;
#pragma unroll
      for (int n = 0; n < 9; ++n) z += Minv[static_cast<size_t>(9 * j + n) * cp + c] * vget(rg, c_pad, n, c);
      zg[j * cp + c] = z;
      pg[j * cp + c] = z;
      s_rz += r * z;
      s_bb += bj * bj;
      s_rr += r * r;
    }
  }
  s_rz = block_sum(s_rz, red_s);
  s_bb = block_sum(s_bb, red_s);
  s_rr = block_sum(s_rr, red_s);
  if (t == 0) {
    partial[blockIdx.x] = s_rz;
    partial[G + blockIdx.x] = s_bb;
    partial[2 * G + blockIdx.x] = s_rr;
  }
  grid.sync();
  float rz = grid_sum(partial, G, red_s);
  const float bb = grid_sum(partial + G, G, red_s);
  float rr = grid_sum(partial + 2 * G, G, red_s);
  const float thresh = tol * tol * fmaxf(bb, 1e-30f);

  int k = 0;
  bool ok = true;
  while (k < max_iters && rr > thresh && ok) {
    float s_pap = 0.0f;
    for (int g = blockIdx.x; g < n_groups; g += G) {
      const int c = g * kCams + cl;
      if (live && c < C) {
        const float ap = apply_S_row(blk, ld, Ul, pg, offs_s, n_off, C, c_pad, c, j);
        apg[j * cp + c] = ap;
        s_pap += vget(pg, c_pad, j, c) * ap;
      }
    }
    s_pap = block_sum(s_pap, red_s);
    if (t == 0) partial[3 * G + blockIdx.x] = s_pap;
    grid.sync();
    const float pAp = grid_sum(partial + 3 * G, G, red_s);
    // pAp ≤ 0: S is not positive definite at this damping; rz ≤ 0: the
    // preconditioner is not. Freeze the iterate, flag not-ok, stop.
    const bool broke = pAp <= 0.0f || rz <= 0.0f;
    const float alpha = broke ? 0.0f : rz / safe_div(pAp);

    float s_rz1 = 0.0f;
    s_rr = 0.0f;
    for (int g = blockIdx.x; g < n_groups; g += G) {
      const int c = g * kCams + cl;
      const bool act = live && c < C;
      float r = 0.0f;
      if (act) {                           // a thread reads and writes only its own entries
        xg[j * cp + c] = vget(xg, c_pad, j, c) + alpha * vget(pg, c_pad, j, c);
        r = vget(rg, c_pad, j, c) - alpha * vget(apg, c_pad, j, c);
        rg[j * cp + c] = r;
      }
      __syncthreads();                     // the camera's new r is whole
      if (act) {
        float z = 0.0f;
#pragma unroll
        for (int n = 0; n < 9; ++n) z += Minv[static_cast<size_t>(9 * j + n) * cp + c] * vget(rg, c_pad, n, c);
        zg[j * cp + c] = z;
        s_rz1 += r * z;
        s_rr += r * r;
      }
    }
    s_rz1 = block_sum(s_rz1, red_s);
    s_rr = block_sum(s_rr, red_s);
    if (t == 0) {
      partial[4 * G + blockIdx.x] = s_rz1;
      partial[5 * G + blockIdx.x] = s_rr;
    }
    grid.sync();
    const float rz1 = grid_sum(partial + 4 * G, G, red_s);
    rr = grid_sum(partial + 5 * G, G, red_s);
    const float beta = rz1 / safe_div(rz);
    for (int g = blockIdx.x; g < n_groups; g += G) {
      const int c = g * kCams + cl;
      if (live && c < C) pg[j * cp + c] = vget(zg, c_pad, j, c) + beta * vget(pg, c_pad, j, c);
    }
    rz = rz1;
    ok = ok && !broke;
    ++k;
    grid.sync();                           // p is whole before the next matvec reads it
  }

  for (int g = blockIdx.x; g < n_groups; g += G) {
    const int c = g * kCams + cl;
    if (live && c < C) x_out[static_cast<size_t>(c) * 9 + j] = vget(xg, c_pad, j, c);
  }
  if (blockIdx.x == 0 && t == 0) {
    *it_out = k;
    *ok_out = ok ? 1 : 0;
  }
}

}  // namespace

extern "C" int tba_pcg_banded(const float* blk, int ld, const float* U_t, const float* b,
                              const float* x0, const int* offsets, int n_offsets, int n_cameras,
                              int c_pad, const float* lam, const float* tol, int max_iters,
                              float diag_floor, float diag_ceil, float* work, float* partial,
                              float* x, int* iterations, int* ok, void* stream) {
  if (n_offsets < 1 || n_offsets > kMaxOffsets || n_cameras < 1 || n_cameras > c_pad) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0, sms = 0, per_sm = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pcg_banded_kernel, kPcgThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_groups = (n_cameras + kCams - 1) / kCams;
  const int resident = per_sm * sms;                   // co-resident by construction
  const int n_blocks = n_groups < resident ? n_groups : resident;
  if (n_blocks < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  void* args[] = {&blk, &ld, &U_t, &b, &x0, &offsets, &n_offsets, &n_cameras, &c_pad, &lam,
                  &tol, &max_iters, &diag_floor, &diag_ceil, &work, &partial, &x, &iterations,
                  &ok};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(pcg_banded_kernel), dim3(n_blocks),
                                    dim3(kPcgThreads), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
