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
// Bound: nothing the roofline names. The band is read once (ladybug-1723:
// 9.4 MB) and the work of an iteration is small; what an iteration costs is
// the latency of its device-wide exchanges of partial sums and of what is
// read between them. chip_smoke.py measures a floor for that: a kernel of the
// same grid that does nothing but the two exchanges of an iteration.
//
// Two forms of one kernel, chosen by the wrapper from the plan's shapes:
//
// Resident (the main path). One block of 384 threads per group of kCams
// cameras (16 or 8: the widest whose slice fits; the planner caps a band at 32
// offsets, 63 items, which fit at 8), every group on the card
// at once. A block keeps for the whole solve, in shared memory, its slice of
// the band as "items": for each offset the forward blocks T_{c,c+off} of its
// cameras and, for off > 0, the blocks T_{c-off,c} stored transposed, so both
// passes are one loop  y_j -= sum_n item[9j+n] * p_item[n]; item 0 holds
// T_cc - Ul, so the product with Ul is part of the loop. 17 offsets at 16
// cameras: 33 items, 167 KB of slab, 209 KB in all of the 227 KB a block may
// have. The slices arrive by cp.async while the prologue inverts the block
// diagonal. A CG iteration then reads no band entry from L2 or device memory.
// The vector the items multiply is staged in shared memory once per camera
// the block's items reach: the ranges c + delta + [0, kCams) of the items, taken
// by rising shift and merged where they overlap (ladybug-1723: offsets 0 ...
// 12 and 1719 ... 1722 reach three runs of 78 cameras in all, not 33 x 16),
// an item reading its range at pos_s[item]. A thread owns three rows of one
// camera and every (384 / 3 kCams)-th item; the partial rows are combined in
// a fixed order. x and r of an entry live in the registers of its owner
// thread. An iteration makes two device-wide exchanges: p.Sp, then r.z with
// r.r, z being written to the work area before the second. After it every
// block knows beta bit for bit and forms p = z + beta p for its own cameras
// and for every neighbour camera it has staged, from z and its own copy of
// the old p: no third barrier. Leftover blocks read p of arbitrary cameras;
// they form it on the fly from z and the p of the iteration before, which
// its owner wrote to one of two buffers. An exchange is a per-block partial
// sum written to the work area, cooperative_groups grid.sync(), and every
// block summing all partials again from L2 in one fixed order, so every
// block gets the same bits and takes the same branch, and nothing is read by
// the host. In the tridiagonal form each PCR level still waits on a barrier
// of its own (its input r_{c+-s} belongs to other blocks) and P, Q stay in
// L2.
//
// Streaming (bands whose slices do not fit: more groups than co-resident
// blocks, or more than 227 KB a group). One cooperative launch sized from the
// occupancy query, cooperative_groups grid.sync() between the phases (three an
// iteration and one per PCR level), a block walks groups of 16 cameras, thread
// (c, j) owns row j of camera c, band, factors and vectors are read from L2
// (or device memory beyond 50 MB) coalesced along c; vectors live in a global
// work area. A dot product is a per-block partial that every block sums again
// in index order after the barrier.
//
// Both: a leftover list is walked by its camera in order; no atomics; two
// runs give the same iterates.
#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <initializer_list>

#include "bandmath.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kStreamCams = 16;            // streaming form: cameras per group
constexpr int kLive = kStreamCams * 9;     // its threads that own a (camera, row)
constexpr int kPcgThreads = 160;           // five full warps; the last 16 threads only reduce
constexpr int kMaxOffsets = 64;
constexpr int kResThreads = 384;           // resident form: 3·kCams·(items walked side by side)
constexpr int kResWarps = kResThreads / 32;
constexpr int kRedFloats = 40;             // 3 sums × 12 warps, rounded up to 8 floats

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
  float* partial;          // (6, blocks) floats: the blocks' partial sums
  float* x_out;
  int* it_out;
  int* ok_out;
  // resident form: an item per offset and, for each offset > 0, one for its transposed pass
  __host__ __device__ int n_items() const { return 2 * n_off - 1; }
};

// vector rows are c_pad apart; entries written during the launch are read
// through L2 (__ldcg), since another SM may have written them
__device__ __forceinline__ float vget(const float* v, int c_pad, int j, int c) {
  return __ldcg(v + static_cast<size_t>(j) * c_pad + c);
}

__device__ __forceinline__ float safe_div(float x) { return fabsf(x) < 1e-30f ? 1e-30f : x; }

// The vector a matvec is applied to, as the leftover blocks read it: entry
// (j, c) at v[j·sj + c·sc], or, with p_old given, z + β p_old formed on the
// fly (the resident form's p of this iteration, which no buffer holds whole).
struct VecSrc {
  const float* v;
  const float* p_old;
  float beta;
  size_t sj;
  int sc;
  __device__ __forceinline__ float get(int j, int c) const {
    const size_t at = static_cast<size_t>(j) * sj + static_cast<size_t>(c) * sc;
    const float z = __ldcg(v + at);
    return p_old != nullptr ? fmaf(beta, __ldcg(p_old + at), z) : z;
  }
};

// row j of the leftover part of (T v)_c: each camera walks its own lists
__device__ __forceinline__ float left_rows(const PcgArgs& a, const VecSrc& src, int c, int j) {
  const float* __restrict__ left = a.blk + a.left_base;
  const int ld = a.ld;
  float t = 0.0f;
  for (int i = a.row_start[c]; i < a.row_start[c + 1]; ++i) {      // T_{c,cj} x_cj
    const int cj = a.row_cj[i];
#pragma unroll
    for (int n = 0; n < 9; ++n) {
      t += left[static_cast<size_t>(9 * j + n) * ld + i] * src.get(n, cj);
    }
  }
  for (int i = a.col_start[c]; i < a.col_start[c + 1]; ++i) {      // T_{ci,c}ᵀ x_ci
    const int seg = a.col_seg[i], ci = a.col_ci[i];
#pragma unroll
    for (int m = 0; m < 9; ++m) {
      t += left[static_cast<size_t>(9 * m + j) * ld + seg] * src.get(m, ci);
    }
  }
  return t;
}

// one PCR level for row j of camera c: r_c − Pᵏ_c r_{c−s} − Qᵏ_c r_{c+s}
__device__ __forceinline__ float pcr_level_row(const PcgArgs& a, const float* src, int k, int c,
                                               int j) {
  const int C = a.C, c_pad = a.c_pad, s = 1 << k;
  const size_t cp = static_cast<size_t>(c_pad);
  const float* Pk = a.pcr_P + static_cast<size_t>(k) * 81 * cp;
  const float* Qk = a.pcr_Q + static_cast<size_t>(k) * 81 * cp;
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
  return v;
}

// Gauss–Jordan without pivoting on the [A | I] rows gj[cl][j][0..17] (19
// floats a row) of the cameras of a group, row j by thread (cl, j); every
// thread of the block calls it
__device__ __forceinline__ void gauss_jordan_9(float* gj, bool live, int cl, int j) {
  float* row = gj + (cl * 9 + j) * 19;
  for (int kk = 0; kk < 9; ++kk) {
    float* pivot = gj + (cl * 9 + kk) * 19;
    if (live && j == kk) {
      const float piv = 1.0f / pivot[kk];
#pragma unroll
      for (int n = 0; n < 18; ++n) pivot[n] *= piv;
    }
    __syncthreads();
    if (live && j != kk) {
      const float f = row[kk];
#pragma unroll
      for (int n = 0; n < 18; ++n) row[n] -= f * pivot[n];
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// the streaming form
// ---------------------------------------------------------------------------

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
    t += left_rows(a, VecSrc{v, nullptr, 0.0f, static_cast<size_t>(c_pad), 1}, c, j);
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
  const int n_groups = (C + kStreamCams - 1) / kStreamCams;
  const float* src = rg;
  const float* diag = Minv;
  if (kPcr) {
    for (int k = 0; k < a.pcr_levels; ++k) {
      float* dst = (k & 1) ? t1 : t0;
      grid.sync();
      for (int g = blockIdx.x; g < n_groups; g += gridDim.x) {
        const int c = g * kStreamCams + cl;
        if (live && c < C) dst[j * cp + c] = pcr_level_row(a, src, k, c, j);
      }
      src = dst;
    }
    diag = a.pcr_D;
  }
  __syncthreads();                         // the camera's vector is whole
  for (int g = blockIdx.x; g < n_groups; g += gridDim.x) {
    const int c = g * kStreamCams + cl;
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
  __shared__ float gj_s[kFold ? kStreamCams * 9 * 19 : 1];       // [A | I] rows, padded

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
  const int j = live ? t / kStreamCams : 0;   // row of the camera block
  const int cl = live ? t % kStreamCams : 0;  // camera within the group
  const int n_groups = (C + kStreamCams - 1) / kStreamCams;
  const int G = gridDim.x;
  const float tol = *a.tol;

  for (int i = t; i < a.n_off; i += kPcgThreads) offs_s[i] = a.offs[i];

  // prologue: Ul and M⁻¹ into the work area, lane-major; x0 placed
  for (int g = blockIdx.x; g < n_groups; g += G) {
    const int c = g * kStreamCams + cl;
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
          gj_s[(cl * 9 + j) * 19 + n] = d;
          gj_s[(cl * 9 + j) * 19 + 9 + n] = n == j ? 1.0f : 0.0f;
        }
      }
      __syncthreads();
      gauss_jordan_9(gj_s, live, cl, j);
      if (act) {
#pragma unroll
        for (int n = 0; n < 9; ++n) {
          Minv[static_cast<size_t>(9 * j + n) * cp + c] = gj_s[(cl * 9 + j) * 19 + 9 + n];
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
    const int c = g * kStreamCams + cl;
    if (live && c < C) {
      const float bj = a.b[static_cast<size_t>(c) * 9 + j];
      rg[j * cp + c] = bj - apply_S_row(a, Ul, xg, offs_s, c, j);
      s_bb += bj * bj;
    }
  }
  precondition<kPcr>(grid, a, Minv, rg, zg, t0, t1, live, j, cl, s_rz, s_rr);
  for (int g = blockIdx.x; g < n_groups; g += G) {
    const int c = g * kStreamCams + cl;
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
      const int c = g * kStreamCams + cl;
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
      const int c = g * kStreamCams + cl;
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
      const int c = g * kStreamCams + cl;
      if (live && c < C) pg[j * cp + c] = vget(zg, c_pad, j, c) + beta * vget(pg, c_pad, j, c);
    }
    rz = rz1;
    ok = ok && !broke;
    ++k;
    grid.sync();                           // p is whole before the next matvec reads it
  }

  for (int g = blockIdx.x; g < n_groups; g += G) {
    const int c = g * kStreamCams + cl;
    if (live && c < C) a.x_out[static_cast<size_t>(c) * 9 + j] = vget(xg, c_pad, j, c);
  }
  if (blockIdx.x == 0 && t == 0) {
    *a.it_out = k;
    *a.ok_out = ok ? 1 : 0;
  }
}

// ---------------------------------------------------------------------------
// the resident form
// ---------------------------------------------------------------------------

// sums over the block of N values a thread, the warps taken in order: every
// thread gets the same N sums
template <int N>
__device__ __forceinline__ void block_sums(float (&v)[N], float* red_s) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[n] += __shfl_down_sync(0xffffffffu, v[n], off);
  }
  const int warp = threadIdx.x >> 5;
  __syncthreads();                         // red_s may still be read from the last call
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int n = 0; n < N; ++n) red_s[n * kResWarps + warp] = v[n];
  }
  __syncthreads();
#pragma unroll
  for (int n = 0; n < N; ++n) {
    float s = 0.0f;
    for (int w = 0; w < kResWarps; ++w) s += red_s[n * kResWarps + w];
    v[n] = s;
  }
}

// Device-wide exchange: v[n] becomes the sum over all blocks of the blocks'
// sums of v[n], with the same bits on every block (the partials are summed
// again by every block in one fixed order), and everything the block's
// threads wrote before the call is visible to every block after it. The
// partials alternate between two sets: a block that is ahead writes the next
// exchange's while a slower one still reads this one's. A hand-written
// exchange in one pass (every block polling every block's (value, epoch)
// word) was measured at 2.8 us on 108 blocks of an H100 against 1.6 us for
// this one: the polls of all blocks on all slots contend in L2, grid.sync()
// waits on one counter.
template <int N>
__device__ __forceinline__ void grid_sums(cg::grid_group& grid, float (&v)[N], float* partial,
                                          unsigned& epoch, float* red_s) {
  const int G = gridDim.x;
  block_sums<N>(v, red_s);
  float* set = partial + static_cast<size_t>(epoch++ & 1u) * 3 * G;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int n = 0; n < N; ++n) set[n * G + blockIdx.x] = v[n];
  }
  grid.sync();
#pragma unroll
  for (int n = 0; n < N; ++n) v[n] = 0.0f;
  for (int i = threadIdx.x; i < G; i += kResThreads) {
#pragma unroll
    for (int n = 0; n < N; ++n) v[n] += __ldcg(set + n * G + i);
  }
  block_sums<N>(v, red_s);
}

// floats of shared memory the resident form takes at n_items items: the
// slab, the staged vector (at most a range of kCams cameras an item), M⁻¹,
// the partial rows, r, the reduction scratch, four ints an item and the
// cameras of the staged ranges, the Gauss–Jordan rows
__host__ __device__ constexpr size_t resident_floats(int n_items, int cams, bool fold) {
  return static_cast<size_t>(n_items) * 90 * cams + 81 * cams + 3 * kResThreads + 9 * cams +
         kRedFloats + 4 * n_items + n_items * cams + (fold ? cams * 9 * 19 : 0);
}

enum StageMode { kStageX0, kStageFirst, kStageUpdate };

// The vector the items multiply, staged over the cameras the block's items
// reach (halo_cam: n_halo cameras, −1 where there is none; entry (n, h) at
// pst[n·n_halo + h]): from x0 (C, 9), from z (p0 = z0), or p ← z + β p on
// the copy the block holds.
__device__ __forceinline__ void stage(const PcgArgs& a, float* pst, const int* halo_cam,
                                      int n_halo, StageMode mode, float beta, const float* zg) {
  constexpr int kBatch = 4;                // loads in flight a thread: a round trip to L2 a batch
  const int total = 9 * n_halo;
  for (int base = threadIdx.x; base < total; base += kBatch * kResThreads) {
    float p[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = base + u * kResThreads;
      p[u] = 0.0f;
      if (idx < total) {
        const int n = idx / n_halo;
        const int cc = halo_cam[idx - n * n_halo];
        if (cc >= 0) {
          p[u] = mode == kStageX0 ? a.x0[static_cast<size_t>(cc) * 9 + n] : vget(zg, a.c_pad, n, cc);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = base + u * kResThreads;
      if (idx < total) {
        // an entry of a camera that does not exist stays 0: p = 0 and its old value is 0
        pst[idx] = mode == kStageUpdate ? fmaf(beta, pst[idx], p[u]) : p[u];
      }
    }
  }
}

// every thread: rows 3jg … 3jg+2 of its camera over the items h, h + kSplit, …
template <int kCams>
__device__ __forceinline__ void matvec_parts(const float* slab, const float* pst,
                                             const int* pos_s, int n_halo, float* part_s,
                                             int n_items) {
  constexpr int kSplit = kResThreads / (3 * kCams);
  const int cl = threadIdx.x % kCams;
  const int jg = (threadIdx.x / kCams) % 3;
  const int h = threadIdx.x / (3 * kCams);
  float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f;
  for (int i = h; i < n_items; i += kSplit) {
    const float* sl = slab + (static_cast<size_t>(i) * 81 + 27 * jg) * kCams + cl;
    const float* pv = pst + pos_s[i] + cl;
#pragma unroll
    for (int n = 0; n < 9; ++n) {
      const float p = pv[n * n_halo];
      acc0 += sl[n * kCams] * p;
      acc1 += sl[(9 + n) * kCams] * p;
      acc2 += sl[(18 + n) * kCams] * p;
    }
  }
  float* out = part_s + (h * 9 + 3 * jg) * kCams + cl;
  out[0] = acc0;
  out[kCams] = acc1;
  out[2 * kCams] = acc2;
}

// owner thread: row j of (S v)_c from the partial rows, in a fixed order,
// and the leftover blocks
template <int kCams>
__device__ __forceinline__ float owner_row(const PcgArgs& a, const float* part_s,
                                           const VecSrc& src, int c, int j, int cl) {
  constexpr int kSplit = kResThreads / (3 * kCams);
  float s = 0.0f;
#pragma unroll
  for (int h = 0; h < kSplit; ++h) s += part_s[(h * 9 + j) * kCams + cl];
  float y = -s;                            // item 0 holds T_cc − Ul
  if (a.n_left > 0) y -= left_rows(a, src, c, j);
  return y;
}

template <bool kFold, bool kPcr, int kCams>
__global__ void __launch_bounds__(kResThreads, 1) pcg_resident_kernel(const PcgArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  constexpr int kOwners = 9 * kCams;
  const int C = a.C, c_pad = a.c_pad, n_off = a.n_off, n_items = a.n_items();
  const size_t cp = static_cast<size_t>(c_pad);
  float* slab = smem;                                            // (n_items, 81, kCams)
  float* pst = slab + static_cast<size_t>(n_items) * 81 * kCams;  // (9, n_halo), n_halo ≤ n_items·kCams
  float* minv_s = pst + n_items * 9 * kCams;                     // (81, kCams): M⁻¹, or D⁻¹ of PCR
  float* part_s = minv_s + 81 * kCams;                           // (kSplit, 9, kCams)
  float* r_s = part_s + 3 * kResThreads;                         // (9, kCams)
  float* red_s = r_s + kOwners;
  int* delta_s = reinterpret_cast<int*>(red_s + kRedFloats);     // camera shift of each item
  int* pos_s = delta_s + n_items;                                // where its range starts in pst
  int* order_s = pos_s + n_items;                                // items by rising shift
  int* len_s = order_s + n_items;                                // cameras its range adds to pst
  int* halo_cam = len_s + n_items;                               // camera of each staged column
  float* gj_s = reinterpret_cast<float*>(halo_cam + n_items * kCams);   // fold-damp only

  float* zg = a.work;                      // z, whole on every block after the second exchange
  float* pg0 = zg + 9 * cp;                // p of the iteration before, two buffers in turn
  float* pg1 = pg0 + 9 * cp;               //   (written only where there are leftovers)
  float* rg = pg1 + 9 * cp;                // PCR: r, and the two buffers of the levels
  float* t0 = rg + 9 * cp;
  float* t1 = t0 + 9 * cp;
  float* partial = a.partial;              // (2, 3, blocks): the partial sums of an exchange

  const int t = threadIdx.x;
  const int c0 = blockIdx.x * kCams;
  const bool live = t < kOwners;           // owner of entry (camera cl, row j)
  const int j = live ? t / kCams : 0;
  const int cl = live ? t % kCams : 0;
  const int c = c0 + cl;
  const bool act = live && c < C;
  const float tol = *a.tol;
  unsigned epoch = 0;

  for (int i = t; i < n_items; i += kResThreads) {
    delta_s[i] = i < n_off ? a.offs[i] : -a.offs[i - n_off + 1];
  }
  __syncthreads();
  // The items' camera ranges c0 + delta + [0, kCams) overlap (offsets 0 … 12
  // reach 28 cameras, not 13 × 16): p is staged once per camera. Items by
  // rising shift (the shifts are distinct), each adding the cameras up to
  // the next item's first; a range then lies contiguous from pos_s[i].
  for (int i = t; i < n_items; i += kResThreads) {
    int rank = 0;
    for (int q = 0; q < n_items; ++q) rank += delta_s[q] < delta_s[i] ? 1 : 0;
    order_s[rank] = i;
  }
  __syncthreads();
  if (t == 0) {
    int pos = 0;
    for (int q = 0; q < n_items; ++q) {
      const int i = order_s[q];
      const int gap = q + 1 < n_items ? delta_s[order_s[q + 1]] - delta_s[i] : kCams;
      pos_s[i] = pos;
      len_s[i] = gap < kCams ? gap : kCams;
      pos += len_s[i];
    }
    order_s[0] = pos;                      // n_halo; the order is no longer needed
  }
  __syncthreads();
  const int n_halo = order_s[0];
  for (int idx = t; idx < n_items * kCams; idx += kResThreads) {
    const int i = idx / kCams, q = idx - i * kCams;
    if (q < len_s[i]) {
      const int cc = c0 + delta_s[i] + q;
      halo_cam[pos_s[i] + q] = cc >= 0 && cc < C ? cc : -1;
    }
  }
  __syncthreads();

  // the band slice: items 1 … arrive asynchronously; an absent block is zero
  for (int idx = t + 81 * kCams; idx < n_items * 81 * kCams; idx += kResThreads) {
    const int i = idx / (81 * kCams);
    const int rem = idx - i * 81 * kCams;
    const int e = rem / kCams;
    const int cc = c0 + (rem - e * kCams);
    const int d = delta_s[i];
    const float* src;
    float* dst;
    bool there;
    if (i < n_off) {                       // T_{cc, cc+off}, as it lies
      there = cc + d < C;
      src = a.blk + static_cast<size_t>(e) * a.ld + static_cast<size_t>(i) * cp + cc;
      dst = slab + idx;
    } else {                               // T_{cc−off, cc}, transposed
      there = cc < C && cc + d >= 0;
      src = a.blk + static_cast<size_t>(e) * a.ld + static_cast<size_t>(i - n_off + 1) * cp + cc + d;
      dst = slab + (static_cast<size_t>(i) * 81 + (e % 9) * 9 + e / 9) * kCams + (rem - e * kCams);
    }
    if (there) {
      __pipeline_memcpy_async(dst, src, sizeof(float));
    } else {
      *dst = 0.0f;
    }
  }
  __pipeline_commit();

  // item 0 = T_cc − Ul, and the preconditioner's block diagonal
  if (live) {
    const float lam = kFold ? *a.lam : 0.0f;
    const size_t row = (static_cast<size_t>(c) * 9 + j) * 9;
#pragma unroll
    for (int n = 0; n < 9; ++n) {
      const int e = 9 * j + n;
      float d = n == j ? 1.0f : 0.0f;      // identity where there is no camera
      float m = 0.0f;
      if (act) {
        float u;
        if (kFold) {
          u = a.U[static_cast<size_t>(e) * cp + c];
          if (n == j) u += lam * tba::clipf(u, a.lo, a.hi);
        } else {
          u = a.U[row + n];
          m = kPcr ? a.pcr_D[static_cast<size_t>(e) * cp + c] : a.Minv[row + n];
        }
        d = u - a.blk[static_cast<size_t>(e) * a.ld + c];
      }
      slab[e * kCams + cl] = act ? -d : 0.0f;
      if (kFold) {
        gj_s[(cl * 9 + j) * 19 + n] = d;
        gj_s[(cl * 9 + j) * 19 + 9 + n] = n == j ? 1.0f : 0.0f;
      } else {
        minv_s[e * kCams + cl] = m;
      }
    }
  }
  __syncthreads();
  if (kFold) {
    gauss_jordan_9(gj_s, live, cl, j);
    if (live) {
#pragma unroll
      for (int n = 0; n < 9; ++n) minv_s[(9 * j + n) * kCams + cl] = gj_s[(cl * 9 + j) * 19 + 9 + n];
    }
  }
  __pipeline_wait_prior(0);
  __syncthreads();

  // z = M⁻¹ r for the owner's entry; z goes to the work area
  auto precondition = [&](float r) -> float {
    float z = 0.0f;
    if (!kPcr) {
      if (live) r_s[j * kCams + cl] = r;   // 0 where there is no camera
      __syncthreads();
      if (live) {
#pragma unroll
        for (int n = 0; n < 9; ++n) z += minv_s[(9 * j + n) * kCams + cl] * r_s[n * kCams + cl];
      }
    } else {
      if (act) rg[j * cp + c] = r;
      const float* src = rg;
      for (int k = 0; k < a.pcr_levels; ++k) {
        float* dst = (k & 1) ? t1 : t0;
        grid.sync();                       // the level's input is whole on every block
        if (act) dst[j * cp + c] = pcr_level_row(a, src, k, c, j);
        src = dst;
      }
      __syncthreads();                     // the camera's vector is whole
      if (act) {
#pragma unroll
        for (int n = 0; n < 9; ++n) z += minv_s[(9 * j + n) * kCams + cl] * vget(src, c_pad, n, c);
      }
    }
    if (act) zg[j * cp + c] = z;
    return z;
  };

  // r0 = b − S x0, z0 = M⁻¹ r0, p0 = z0
  const float bj = act ? a.b[static_cast<size_t>(c) * 9 + j] : 0.0f;
  float x = 0.0f, r = bj;
  if (a.x0 != nullptr) {
    if (act) x = a.x0[static_cast<size_t>(c) * 9 + j];
    stage(a, pst, halo_cam, n_halo, kStageX0, 0.0f, nullptr);
    __syncthreads();
    matvec_parts<kCams>(slab, pst, pos_s, n_halo, part_s, n_items);
    __syncthreads();
    if (act) r = bj - owner_row<kCams>(a, part_s, VecSrc{a.x0, nullptr, 0.0f, 1, 9}, c, j, cl);
  }
  float z = precondition(r);
  float s3[3] = {r * z, bj * bj, r * r};
  grid_sums<3>(grid, s3, partial, epoch, red_s);
  float rz = s3[0], rr = s3[2];
  const float thresh = tol * tol * fmaxf(s3[1], 1e-30f);
  stage(a, pst, halo_cam, n_halo, kStageFirst, 0.0f, zg);
  if (a.n_left > 0 && act) pg1[j * cp + c] = z;         // p0, read on the fly from iteration 1 on
  __syncthreads();

  const int own = pos_s[0] + cl;           // the owner's camera in pst
  int k = 0;
  bool ok = true;
  float beta = 0.0f;
  while (k < a.max_iters && rr > thresh && ok) {
    matvec_parts<kCams>(slab, pst, pos_s, n_halo, part_s, n_items);
    __syncthreads();
    const float pj = live ? pst[j * n_halo + own] : 0.0f;   // item 0 multiplies the block's own p
    float ap = 0.0f;
    if (act) {
      // p of this iteration at a leftover's camera: z + β p_old (p0 = z0)
      const VecSrc src{zg, k == 0 ? nullptr : ((k & 1) ? pg1 : pg0), beta, cp, 1};
      ap = owner_row<kCams>(a, part_s, src, c, j, cl);
    }
    float s1[1] = {pj * ap};
    grid_sums<1>(grid, s1, partial, epoch, red_s);
    const float pAp = s1[0];
    // pAp ≤ 0: S is not positive definite at this damping; rz ≤ 0: the
    // preconditioner is not. Freeze the iterate, flag not-ok, stop.
    const bool broke = pAp <= 0.0f || rz <= 0.0f;
    const float alpha = broke ? 0.0f : rz / safe_div(pAp);
    x += alpha * pj;
    r -= alpha * ap;
    z = precondition(r);
    float s2[2] = {r * z, r * r};
    grid_sums<2>(grid, s2, partial, epoch, red_s);
    rr = s2[1];
    beta = s2[0] / safe_div(rz);
    rz = s2[0];
    // p ← z + β p on every copy: the owner's and the neighbours' agree bit for bit
    stage(a, pst, halo_cam, n_halo, kStageUpdate, beta, zg);
    __syncthreads();
    if (a.n_left > 0 && act) ((k & 1) ? pg1 : pg0)[j * cp + c] = pst[j * n_halo + own];
    ok = ok && !broke;
    ++k;
  }

  if (act) a.x_out[static_cast<size_t>(c) * 9 + j] = x;
  if (blockIdx.x == 0 && t == 0) {
    *a.it_out = k;
    *a.ok_out = ok ? 1 : 0;
  }
}

// The floor of an iteration's synchronisation: n exchanges of one partial
// sum (the resident form's grid_sums) and nothing else, on a grid and with
// the shared memory given.
__global__ void __launch_bounds__(kResThreads, 1)
barrier_floor_kernel(float* partial, int n, float* out) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float red_s[kRedFloats];
  unsigned epoch = 0;
  float acc = 0.0f;
  for (int i = 0; i < n; ++i) {
    float v[1] = {threadIdx.x == 0 ? 1.0f : 0.0f};
    grid_sums<1>(grid, v, partial, epoch, red_s);
    acc += v[0];
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *out = acc;
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

struct Card {
  int sms = 0, smem_optin = 0;
  cudaError_t err = cudaSuccess;
};

Card card() {
  Card k;
  int device = 0, coop = 0;
  k.err = cudaGetDevice(&device);
  if (k.err != cudaSuccess) return k;
  k.err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (k.err != cudaSuccess) return k;
  if (!coop) {
    k.err = cudaErrorNotSupported;
    return k;
  }
  k.err = cudaDeviceGetAttribute(&k.sms, cudaDevAttrMultiProcessorCount, device);
  if (k.err != cudaSuccess) return k;
  k.err = cudaDeviceGetAttribute(&k.smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return k;
}

template <bool kFold, bool kPcr>
int launch_streaming(PcgArgs a, cudaStream_t stream) {
  const Card k = card();
  if (k.err != cudaSuccess) return static_cast<int>(k.err);
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, pcg_banded_kernel<kFold, kPcr>, kPcgThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_groups = (a.C + kStreamCams - 1) / kStreamCams;
  const int co_resident = per_sm * k.sms;              // co-resident by construction
  const int n_blocks = n_groups < co_resident ? n_groups : co_resident;
  if (n_blocks < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(pcg_banded_kernel<kFold, kPcr>),
                                    dim3(n_blocks), dim3(kPcgThreads), args, 0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The resident form at kCams cameras a group: 0 launched (or, with launch
// false, it would fit), −1 the slices do not fit the card at this width, else
// a cudaError.
template <bool kFold, bool kPcr, int kCams>
int resident(PcgArgs a, cudaStream_t stream, bool launch) {
  const Card k = card();
  if (k.err != cudaSuccess) return static_cast<int>(k.err);
  const size_t bytes = sizeof(float) * resident_floats(a.n_items(), kCams, kFold);
  if (bytes > static_cast<size_t>(k.smem_optin)) return -1;
  auto kernel = pcg_resident_kernel<kFold, kPcr, kCams>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kResThreads, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_groups = (a.C + kCams - 1) / kCams;
  if (n_groups > per_sm * k.sms) return -1;           // every group is on the card at once
  if (!launch) return 0;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(n_groups),
                                    dim3(kResThreads), args, bytes, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <bool kFold, bool kPcr>
int resident_at(int cams, PcgArgs a, cudaStream_t stream, bool launch) {
  switch (cams) {
    case 16: return resident<kFold, kPcr, 16>(a, stream, launch);
    case 8: return resident<kFold, kPcr, 8>(a, stream, launch);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// cams 0: the streaming form; 16, 8: the resident form at that group width
int dispatch(int form, int cams, PcgArgs a, cudaStream_t stream, bool launch) {
  if (cams == 0) {
    switch (form) {
      case 0: return launch_streaming<true, false>(a, stream);
      case 1: return launch_streaming<false, false>(a, stream);
      case 2: return launch_streaming<false, true>(a, stream);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (form) {
    case 0: return resident_at<true, false>(cams, a, stream, launch);
    case 1: return resident_at<false, false>(cams, a, stream, launch);
    case 2: return resident_at<false, true>(cams, a, stream, launch);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The widest group (16 or 8 cameras) at which the resident form holds a
// band of n_offsets offsets (the first 0, the others positive) over n_cameras
// cameras on this card; 0 if none does; a negative cudaError on failure.
extern "C" int tba_pcg_resident_cams(int form, int n_offsets, int n_cameras) {
  if (n_offsets < 1 || n_offsets > kMaxOffsets || n_cameras < 1) return 0;
  PcgArgs a{};
  a.n_off = n_offsets;
  a.C = n_cameras;
  for (int cams : {16, 8}) {
    const int status = dispatch(form, cams, a, nullptr, false);
    if (status == 0) return cams;
    if (status != -1) return -status;
  }
  return 0;
}

// form 0: fold-damp (U = U_t undamped, lam); 1: Ul and Minv given; 2: Ul and
// the PCR factors given. cams 0: the streaming form; else the resident form
// at that group width (tba_pcg_resident_cams), which needs offsets[0] = 0 <
// the others, all distinct; partial: 6 floats a block. The leftover lists may be null when n_left
// is 0.
extern "C" int tba_pcg_banded(int form, int cams, const float* blk, int ld, const float* U,
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
  const int status = dispatch(form, cams, a, static_cast<cudaStream_t>(stream), true);
  return status == -1 ? static_cast<int>(cudaErrorLaunchOutOfResources) : status;
}

// n exchanges on a cooperative grid of n_blocks blocks of the resident form's
// size with smem_bytes of dynamic shared memory each; partial: 6 · n_blocks
// floats; out: one float, n_blocks · n.
extern "C" int tba_pcg_barrier_floor(int n_blocks, int smem_bytes, int n, float* partial,
                                     float* out, void* stream) {
  if (n_blocks < 1 || smem_bytes < 0 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(barrier_floor_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&partial, &n, &out};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(barrier_floor_kernel),
                                    dim3(n_blocks), dim3(kResThreads), args, smem_bytes,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// bytes of dynamic shared memory of the resident form (for the floor's grid)
extern "C" int tba_pcg_resident_smem(int form, int n_offsets, int cams) {
  return static_cast<int>(sizeof(float) * resident_floats(2 * n_offsets - 1, cams, form == 0));
}
