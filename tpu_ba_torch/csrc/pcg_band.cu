// K4 and K8: the whole preconditioned-CG solve of the banded reduced camera
// system S = U_λ − T in one kernel, in three forms of one template:
//
//   fold-damp (K4)   U_t (81, c_pad) undamped and λ given; the prologue damps
//                    U and inverts the block diagonal of S (block-Jacobi)
//   given (K8)       Ul and M⁻¹ given as (C, 9, 9); the prologue copies them
//   tridiagonal (K8) Ul given as (C, 9, 9); the preconditioner is the
//                    PCR-factored inverse of the block-tridiagonal part of S,
//                    given as P, Q (levels·81, c_pad) and D⁻¹ (81, c_pad):
//                    per level k, s = 2ᵏ, for every camera from the level's
//                    input  r_c ← r_c − Pᵏ_c r_{c−s} − Qᵏ_c r_{c+s},
//                    then z = D⁻¹ r
//
// blk (81, ld): the first n_off·c_pad columns are the band grid, column
// o·c_pad + c holding T_{c, c+offs[o]} (entry 9m+n), zero where absent; the
// n_left columns behind it hold the off-band leftover blocks T_{ci, cj}
// (ci < cj), listed by row camera (row_start, row_cj) and, through a stable
// permutation, by column camera (col_start, col_seg, col_ci). b, x0, x: (C, 9).
//
//   matvec    y_c = Ul_c x_c − Σ_off [ T_{c,c+off} x_{c+off}
//                                      + (off > 0) T_{c−off,c}ᵀ x_{c−off} ]
//                   − Σ_{left: ci=c} T x_cj − Σ_{left: cj=c} Tᵀ x_ci
//   loop      while k < max_iters and r·r > tol²·max(b·b, 1e-30) and ok:
//               pAp = p·Sp; broke = pAp ≤ 0 or rz ≤ 0; α = broke ? 0 : rz/pAp
//               x += αp; r −= αSp; z = M⁻¹r; β = r·z / rz; p = z + βp
//               ok &= !broke; k += 1
//
// step for step the loop of tpu_ba_torch/solver/pcg.py. Replaces the Pallas
// kernel tpu_ba/kernels/pcg_band.py:pcg_banded in all its variants
// (fold_damp, given Ul/M⁻¹, pcr_levels > 0), which keeps every operand in
// VMEM and applies the offsets and the PCR strides as lane rolls; rolls wrap,
// indices here do not, so every neighbour c ± off, c ± s is bound-checked.
//
// Bound: nothing the roofline names. One CG iteration reads the band twice
// (forward and transposed pass; ladybug-1723: 2 × 9.4 MB) and, in the
// tridiagonal form, P and Q once (2 × 11 × 81 × 1,792 × 4 B = 12.8 MB), all
// from L2, where they stay resident across iterations; what it costs is the
// latency of the device-wide barriers (three an iteration, and one more for
// each PCR level: a level reads r_{c±s} of cameras that other blocks own) and
// of dependent L2 reads.
//
// Design: one cooperative launch, all blocks co-resident (the grid is sized
// from the occupancy query), cooperative_groups grid.sync() between the
// phases of an iteration. A block owns groups of 16 cameras; thread (c, j)
// owns row j of camera c, so band, factor and vector reads are coalesced
// along c. Vectors live in a small global work area (L2); a PCR level reads
// one buffer and writes the other. A leftover list is walked by its camera
// in order. A dot product is a per-block partial (warp shuffles, then the
// warps in order) that every block sums again in index order after the
// barrier: every block gets the same bits and takes the same branch, so the
// loop test runs on the device, nothing is read by the host, and two runs
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

struct PcgArgs {
  const float* blk;        // (81, ld)
  int ld;
  const float* U;          // fold-damp: U_t (81, c_pad) undamped; else Ul (C, 9, 9)
  const float* Minv;       // given form: (C, 9, 9); else unused
  const float* pcr_P;      // tridiagonal form: (levels·81, c_pad)
  const float* pcr_Q;
  const float* pcr_D;      // (81, c_pad)
  int pcr_levels;
  const float* b;
  const float* x0;         // may be null
  const int* offs;
  int n_off, C, c_pad;
  const int* row_start;    // leftovers by row camera: (C + 1) starts into row_cj
  const int* row_cj;       // (n_left) column camera of leftover segment i
  const int* col_start;    // leftovers by column camera: (C + 1) starts into col_seg / col_ci
  const int* col_seg;      // (n_left) leftover segment
  const int* col_ci;       // (n_left) its row camera
  int left_base, n_left;   // first leftover column of blk; leftover segments
  const float* lam;        // fold-damp only
  const float* tol;
  int max_iters;
  float lo, hi;
  float* work;             // (2·81 + 7·9, c_pad)
  float* partial;          // (6, blocks)
  float* x_out;
  int* it_out;
  int* ok_out;
};

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
__device__ __forceinline__ float apply_S_row(const PcgArgs& a, const float* Ul,
                                             const float* v, const int* offs_s, int c, int j) {
  const float* __restrict__ blk = a.blk;
  const int ld = a.ld, C = a.C, c_pad = a.c_pad;
  float y = 0.0f;
#pragma unroll
  for (int n = 0; n < 9; ++n) {
    y += Ul[static_cast<size_t>(9 * j + n) * c_pad + c] * vget(v, c_pad, n, c);
  }
  float t = 0.0f;
  for (int o = 0; o < a.n_off; ++o) {
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
  if (a.n_left > 0) {
    const float* left = blk + a.left_base;
    for (int i = a.row_start[c]; i < a.row_start[c + 1]; ++i) {      // T_{c,cj} x_cj
      const int cj = a.row_cj[i];
#pragma unroll
      for (int n = 0; n < 9; ++n) {
        t += left[static_cast<size_t>(9 * j + n) * ld + i] * vget(v, c_pad, n, cj);
      }
    }
    for (int i = a.col_start[c]; i < a.col_start[c + 1]; ++i) {      // T_{ci,c}ᵀ x_ci
      const int seg = a.col_seg[i], ci = a.col_ci[i];
#pragma unroll
      for (int m = 0; m < 9; ++m) {
        t += left[static_cast<size_t>(9 * m + j) * ld + seg] * vget(v, c_pad, m, ci);
      }
    }
  }
  return y - t;
}

// z = M⁻¹ r for the cameras of this block, r as the block's threads have just
// written it; adds r·z and r·r of the thread's entries to s_rz and s_rr.
// Block-Jacobi: M⁻¹ is the block diagonal in the work area. Tridiagonal: the
// PCR levels first, each behind a device-wide barrier (its input must be
// whole on every block), then the final block diagonal.
template <bool kPcr>
__device__ __forceinline__ void precondition(cg::grid_group& grid, const PcgArgs& a,
                                             const float* Minv, const float* rg, float* zg,
                                             float* t0, float* t1, bool live, int j, int cl,
                                             float& s_rz, float& s_rr) {
  const int C = a.C, c_pad = a.c_pad;
  const size_t cp = static_cast<size_t>(c_pad);
  const int n_groups = (C + kCams - 1) / kCams;
  const float* src = rg;
  const float* diag = Minv;
  if (kPcr) {
    for (int k = 0; k < a.pcr_levels; ++k) {
      const int s = 1 << k;
      float* dst = (k & 1) ? t1 : t0;
      const float* Pk = a.pcr_P + static_cast<size_t>(k) * 81 * cp;
      const float* Qk = a.pcr_Q + static_cast<size_t>(k) * 81 * cp;
      grid.sync();
      for (int g = blockIdx.x; g < n_groups; g += gridDim.x) {
        const int c = g * kCams + cl;
        if (live && c < C) {
          float v = vget(src, c_pad, j, c);
          if (c - s >= 0) {
#pragma unroll
            for (int n = 0; n < 9; ++n) {
              v -= Pk[static_cast<size_t>(9 * j + n) * cp + c] * vget(src, c_pad, n, c - s);
            }
          }
          if (c + s < C) {
#pragma unroll
            for (int n = 0; n < 9; ++n) {
              v -= Qk[static_cast<size_t>(9 * j + n) * cp + c] * vget(src, c_pad, n, c + s);
            }
          }
          dst[j * cp + c] = v;
        }
      }
      src = dst;
    }
    diag = a.pcr_D;
  }
  __syncthreads();                         // the camera's vector is whole
  for (int g = blockIdx.x; g < n_groups; g += gridDim.x) {
    const int c = g * kCams + cl;
    if (live && c < C) {
      float z = 0.0f;
#pragma unroll
      for (int n = 0; n < 9; ++n) {
        z += diag[static_cast<size_t>(9 * j + n) * cp + c] * vget(src, c_pad, n, c);
      }
      zg[j * cp + c] = z;
      const float r = vget(rg, c_pad, j, c);
      s_rz += r * z;
      s_rr += r * r;
    }
  }
}

template <bool kFold, bool kPcr>
__global__ void __launch_bounds__(kPcgThreads) pcg_banded_kernel(const PcgArgs a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float red_s[kPcgThreads / 32];
  __shared__ int offs_s[kMaxOffsets];
  __shared__ float gj_s[kFold ? kCams : 1][9][19];     // [A | I] rows, padded

  const int C = a.C, c_pad = a.c_pad;
  const size_t cp = static_cast<size_t>(c_pad);
  float* Ul = a.work;
  float* Minv = Ul + 81 * cp;
  float* xg = Minv + 81 * cp;
  float* rg = xg + 9 * cp;
  float* pg = rg + 9 * cp;
  float* apg = pg + 9 * cp;
  float* zg = apg + 9 * cp;
  float* t0 = zg + 9 * cp;
  float* t1 = t0 + 9 * cp;
  float* partial = a.partial;

  const int t = threadIdx.x;
  const bool live = t < kLive;
  const int j = live ? t / kCams : 0;      // row of the camera block
  const int cl = live ? t % kCams : 0;     // camera within the group
  const int n_groups = (C + kCams - 1) / kCams;
  const int G = gridDim.x;
  const float tol = *a.tol;

  for (int i = t; i < a.n_off; i += kPcgThreads) offs_s[i] = a.offs[i];

  // prologue: Ul and M⁻¹ into the work area, lane-major; x0 placed
  for (int g = blockIdx.x; g < n_groups; g += G) {
    const int c = g * kCams + cl;
    const bool act = live && c < C;
    if (kFold) {
      // damp U, invert the block diagonal of S by Gauss–Jordan without pivoting
      const float lam = *a.lam;
      if (live) {
#pragma unroll
        for (int n = 0; n < 9; ++n) {
          float d = n == j ? 1.0f : 0.0f;  // identity where there is no camera
          if (act) {
            float u = a.U[static_cast<size_t>(9 * j + n) * cp + c];
            if (n == j) u += lam * tba::clipf(u, a.lo, a.hi);
            Ul[static_cast<size_t>(9 * j + n) * cp + c] = u;
            d = u - a.blk[static_cast<size_t>(9 * j + n) * a.ld + c];
          }
          gj_s[cl][j][n] = d;
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
        for (int n = 0; n < 9; ++n) {
          Minv[static_cast<size_t>(9 * j + n) * cp + c] = gj_s[cl][j][9 + n];
        }
      }
      __syncthreads();
    } else if (act) {
      const size_t row = (static_cast<size_t>(c) * 9 + j) * 9;
#pragma unroll
      for (int n = 0; n < 9; ++n) {
        Ul[static_cast<size_t>(9 * j + n) * cp + c] = a.U[row + n];
        if (!kPcr) Minv[static_cast<size_t>(9 * j + n) * cp + c] = a.Minv[row + n];
      }
    }
    if (act) xg[j * cp + c] = a.x0 != nullptr ? a.x0[static_cast<size_t>(c) * 9 + j] : 0.0f;
  }
  grid.sync();

  // r0 = b − S x0, z0 = M⁻¹ r0, p0 = z0
  float s_rz = 0.0f, s_bb = 0.0f, s_rr = 0.0f;
  for (int g = blockIdx.x; g < n_groups; g += G) {
    const int c = g * kCams + cl;
    if (live && c < C) {
      const float bj = a.b[static_cast<size_t>(c) * 9 + j];
      rg[j * cp + c] = bj - apply_S_row(a, Ul, xg, offs_s, c, j);
      s_bb += bj * bj;
    }
  }
  precondition<kPcr>(grid, a, Minv, rg, zg, t0, t1, live, j, cl, s_rz, s_rr);
  for (int g = blockIdx.x; g < n_groups; g += G) {
    const int c = g * kCams + cl;
    if (live && c < C) pg[j * cp + c] = zg[j * cp + c];   // the thread's own entry
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
  while (k < a.max_iters && rr > thresh && ok) {
    float s_pap = 0.0f;
    for (int g = blockIdx.x; g < n_groups; g += G) {
      const int c = g * kCams + cl;
      if (live && c < C) {
        const float ap = apply_S_row(a, Ul, pg, offs_s, c, j);
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

    for (int g = blockIdx.x; g < n_groups; g += G) {
      const int c = g * kCams + cl;
      if (live && c < C) {                 // a thread reads and writes only its own entries
        xg[j * cp + c] = vget(xg, c_pad, j, c) + alpha * vget(pg, c_pad, j, c);
        rg[j * cp + c] = vget(rg, c_pad, j, c) - alpha * vget(apg, c_pad, j, c);
      }
    }
    float s_rz1 = 0.0f;
    s_rr = 0.0f;
    precondition<kPcr>(grid, a, Minv, rg, zg, t0, t1, live, j, cl, s_rz1, s_rr);
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
    if (live && c < C) a.x_out[static_cast<size_t>(c) * 9 + j] = vget(xg, c_pad, j, c);
  }
  if (blockIdx.x == 0 && t == 0) {
    *a.it_out = k;
    *a.ok_out = ok ? 1 : 0;
  }
}

template <bool kFold, bool kPcr>
int launch(PcgArgs a, cudaStream_t stream) {
  int device = 0, sms = 0, per_sm = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pcg_banded_kernel<kFold, kPcr>,
                                                      kPcgThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_groups = (a.C + kCams - 1) / kCams;
  const int resident = per_sm * sms;                   // co-resident by construction
  const int n_blocks = n_groups < resident ? n_groups : resident;
  if (n_blocks < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(pcg_banded_kernel<kFold, kPcr>),
                                    dim3(n_blocks), dim3(kPcgThreads), args, 0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// form 0: fold-damp (U = U_t undamped, lam); 1: Ul and Minv given; 2: Ul and
// the PCR factors given. The leftover lists may be null when n_left is 0.
extern "C" int tba_pcg_banded(int form, const float* blk, int ld, const float* U,
                              const float* Minv, const float* pcr_P, const float* pcr_Q,
                              const float* pcr_D, int pcr_levels, const float* b, const float* x0,
                              const int* offsets, int n_offsets, int n_cameras, int c_pad,
                              const int* row_start, const int* row_cj, const int* col_start,
                              const int* col_seg, const int* col_ci, int left_base, int n_left,
                              const float* lam, const float* tol, int max_iters,
                              float diag_floor, float diag_ceil, float* work, float* partial,
                              float* x, int* iterations, int* ok, void* stream) {
  if (n_offsets < 1 || n_offsets > kMaxOffsets || n_cameras < 1 || n_cameras > c_pad ||
      n_left < 0 || pcr_levels < 0 || pcr_levels > 30) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PcgArgs a{blk, ld, U, Minv, pcr_P, pcr_Q, pcr_D, pcr_levels, b, x0, offsets, n_offsets,
            n_cameras, c_pad, row_start, row_cj, col_start, col_seg, col_ci, left_base, n_left,
            lam, tol, max_iters, diag_floor, diag_ceil, work, partial, x, iterations, ok};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (form) {
    case 0: return launch<true, false>(a, s);
    case 1: return launch<false, false>(a, s);
    case 2: return launch<false, true>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
