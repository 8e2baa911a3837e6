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
// Both call tba::camera_part and tba::project_point (projection.cuh), so cost
// and linearization cannot diverge.
//
// Bound: K2 is bound by its writes, 40 floats per observation (109 MB at
// ladybug-1723, 800 MB at venice-1778-community), plus about 600 operations
// per observation, well below the card's f32 rate. K3 reads 11 bytes and a
// gathered point per observation and writes a scalar.
//
// Design: the observations are camera-sorted (tpu_ba_torch/core.py:
// make_problem), so a camera's are one contiguous run. Runs are heavy-tailed
// (venice-1778-community: median 1,088, longest 179,458), and a block per
// camera left the longest runs to one SM each while the others waited. A
// schedule built once per structure (kernels/linearize.py:
// linearize_schedule) cuts each run into near-equal pieces of at most Q
// consecutive observations; each piece is one block of T threads. In K2:
//   - the block stages the piece's inputs in shared memory first (indices,
//     measurements and mask, then the gathered points), all its loads in
//     flight at once; thread 0 meanwhile forms the camera's part of the
//     projection (R, t, intrinsics, the factor of dP/daa: sqrtf, sinf, cosf
//     and the divisions by θ²) once per block;
//   - consecutive threads take consecutive observations over windows that
//     start at a multiple of 32, so each of a warp's 40 row stores is one
//     whole 128-byte line; the rows are streamed out (evict-first), since
//     nothing reads them before the next kernel;
//   - each thread keeps its share of the 45 upper-triangle entries of U and
//     the 9 of gc in registers; a warp shuffle tree and a pass over the warps
//     in order reduce them;
//   - a camera of one piece writes its U (lower triangle mirrored) and gc
//     from that block. A camera of more writes each piece's 54 sums to a
//     scratch row; the block that finishes last (an integer counter per
//     camera, after a __threadfence) adds the camera's rows in piece order,
//     writes U and gc, and resets the counter for the next call;
//   - blocks past the pieces write the empty cameras' U and gc as zeros.
// No float atomics: the same sums every run. Padding rows carry mask 0 and
// the last camera's and point's index: their weight √ρ′·mask is 0, so they
// write exact zeros.
//
// K3 runs on the same pieces, one launch. One block per piece lost to the
// earlier grid-stride kernel at ladybug-1723: a kernel of ~100 operations an
// observation pays a block's set-up and tail per piece. So a fixed grid of
// 1,024 blocks of 256 threads (all resident: at most 32 registers) walks the
// pieces, block b taking pieces b, b + 1,024, …; each thread forms a piece's
// camera part in registers (no barrier before its first loads) and sums
// ρ·mask over its observations of the piece; each block writes one partial,
// and the last block to finish (an integer counter) adds them in block order
// and writes ½Σ. The sum order depends only on the schedule.
#include <cuda_runtime.h>

#include "projection.cuh"

namespace {

using tba::CameraPart;
using tba::Projection;

constexpr int kUpper = 45;           // upper triangle of the 9×9 U block
constexpr int kCamSums = kUpper + 9; // + gc
// the longest piece a block stages: 28 bytes an observation, 28 KB, under the
// 48 KB of dynamic shared memory a launch may take without opting in
constexpr int kMaxPieceObs = 1024;
// K3's grid: at most kCostBlocks blocks of kCostThreads, a fixed number, so
// that the sum order does not depend on the card
constexpr int kCostThreads = 256;
constexpr int kCostBlocks = 1024;

// A piece's inputs, staged in shared memory by stage_piece: for
// observation lo + i, the point (x, y, z), the measurement (u, v) and the
// mask as 0 or 1, each an array of q_max floats, then the point indices.
constexpr int kStaged = 6;

// Stage the n observations of [lo, lo + n) (n ≤ q_max) and form camera c's
// part of the projection into cp: the block's threads read the index,
// measurement and mask rows together (thread 0 forms the camera part while
// its loads are in flight), then gather the points, so each thread has its
// loads in flight at once instead of one dependent chain per observation.
template <int T>
__device__ __forceinline__ void stage_piece(const float* __restrict__ cams,
                                            const float* __restrict__ pts,
                                            const float* __restrict__ obs,
                                            const int* __restrict__ pt_idx,
                                            const unsigned char* __restrict__ mask, int c,
                                            int lo, int n, int q_max, float* in,
                                            CameraPart& cp) {
  int* pt = reinterpret_cast<int*>(in + kStaged * q_max);
  const float2* obs2 = reinterpret_cast<const float2*>(obs);
#pragma unroll 8
  for (int i = threadIdx.x; i < n; i += T) {
    pt[i] = pt_idx[lo + i];
    const float2 uv = obs2[lo + i];
    in[3 * q_max + i] = uv.x;
    in[4 * q_max + i] = uv.y;
    in[5 * q_max + i] = mask[lo + i] ? 1.0f : 0.0f;
  }
  if (threadIdx.x == 0) tba::camera_part(cams + static_cast<size_t>(c) * 9, cp);
  __syncthreads();
#pragma unroll 8
  for (int i = threadIdx.x; i < n; i += T) {
    const size_t p = static_cast<size_t>(pt[i]);
    in[i] = pts[3 * p];
    in[q_max + i] = pts[3 * p + 1];
    in[2 * q_max + i] = pts[3 * p + 2];
  }
  __syncthreads();
}

// The 40 rows of the staged observation i into out[k * stride], and its
// camera-side terms into acc (45 entries of U's upper triangle, then 9 of gc).
__device__ __forceinline__ void linearize_obs(const CameraPart& cp, const float* in, int q_max,
                                              int i, int robust_kind, float robust_scale,
                                              unsigned freeze_mask, float* __restrict__ out,
                                              size_t stride, float acc[kCamSums]) {
  const float X[3] = {in[i], in[q_max + i], in[2 * q_max + i]};
  const float mk = in[5 * q_max + i];
  Projection pc;
  tba::project_point(cp, X, in[3 * q_max + i], in[4 * q_max + i], mk, pc);
  const float f = cp.f;

  // robust IRLS on the unweighted (masked) residual
  const float sr = pc.r0 * pc.r0 + pc.r1 * pc.r1;
  const float rho = tba::robust_rho(robust_kind, sr, robust_scale) * mk;
  const float sw = sqrtf(tba::robust_weight(robust_kind, sr, robust_scale)) * mk;

  // du/dp (2×2) and du/dP (2×3)
  const float pv[2] = {pc.p0, pc.p1};
  const float g2 = 2.0f * (cp.k1 + 2.0f * cp.k2 * pc.s);
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

  // dP/daa: Gallego–Yezzi, −R[X]× core, or −[X]× for small θ
  const float Xk[3][3] = {{0.0f, -X[2], X[1]}, {X[2], 0.0f, -X[0]}, {-X[1], X[0], 0.0f}};
  float dPda[3][3];
  if (cp.small) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) dPda[i][j] = -Xk[i][j];
    }
  } else {
    float RXk[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        RXk[i][j] = cp.R[i][0] * Xk[0][j] + cp.R[i][1] * Xk[1][j] + cp.R[i][2] * Xk[2][j];
      }
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        dPda[i][j] = -(RXk[i][0] * cp.core[0][j] + RXk[i][1] * cp.core[1][j] +
                       RXk[i][2] * cp.core[2][j]);
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
      Jp[a][j] = (du_dP[a][0] * cp.R[0][j] + du_dP[a][1] * cp.R[1][j] +
                  du_dP[a][2] * cp.R[2][j]) * sw;
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
#pragma unroll
  for (int m = 0; m < 9; ++m) {
#pragma unroll
    for (int n = 0; n < 3; ++n) {
      __stcs(out + (3 * m + n) * stride, Jc[0][m] * Jp[0][n] + Jc[1][m] * Jp[1][n]);
    }
  }
#pragma unroll
  for (int m = 0; m < 3; ++m) {
#pragma unroll
    for (int n = 0; n < 3; ++n) {
      __stcs(out + (27 + 3 * m + n) * stride, Jp[0][m] * Jp[0][n] + Jp[1][m] * Jp[1][n]);
    }
  }
#pragma unroll
  for (int m = 0; m < 3; ++m) __stcs(out + (36 + m) * stride, Jp[0][m] * r0 + Jp[1][m] * r1);
  __stcs(out + 39 * stride, rho);

  // camera-side sums
  int q = 0;
#pragma unroll
  for (int m = 0; m < 9; ++m) {
#pragma unroll
    for (int n = m; n < 9; ++n) acc[q++] += Jc[0][m] * Jc[0][n] + Jc[1][m] * Jc[1][n];
  }
#pragma unroll
  for (int m = 0; m < 9; ++m) acc[kUpper + m] += Jc[0][m] * r0 + Jc[1][m] * r1;
}

// U and gc of camera c from its sum v of entry q (q < 45: U's upper triangle,
// row by row, mirrored; then gc)
__device__ __forceinline__ void write_camera(int c, int q, float v, float* __restrict__ U,
                                             float* __restrict__ gc) {
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

// blocks [0, n_pieces) work the pieces (pieces: camera, first, end rows of a
// (3, n_pieces) array, in camera order); the rest zero the empty cameras
template <int T>
__global__ void __launch_bounds__(T)
linearize_kernel(const float* __restrict__ cams, const float* __restrict__ pts,
                 const float* __restrict__ obs, const int* __restrict__ pt_idx,
                 const unsigned char* __restrict__ mask, const int* __restrict__ pieces,
                 int n_pieces, int q_max, const int* __restrict__ piece_start,
                 const int* __restrict__ empty, int n_empty, int n_obs, int robust_kind,
                 float robust_scale, unsigned freeze_mask, float* __restrict__ U,
                 float* __restrict__ gc, float* __restrict__ obs_out,
                 float* __restrict__ scratch, int* ticket) {
  static_assert(T >= kCamSums && T % 32 == 0, "a thread per camera sum, whole warps");
  constexpr int kWarps = T / 32;
  extern __shared__ float in[];
  __shared__ CameraPart cp;
  __shared__ float partial[kWarps][kCamSums];
  __shared__ int is_last;
  const int block = blockIdx.x;
  if (block >= n_pieces) {
    const int j = (block - n_pieces) * T + threadIdx.x;
    if (j < n_empty) {
      const size_t c = static_cast<size_t>(empty[j]);
#pragma unroll
      for (int e = 0; e < 81; ++e) U[c * 81 + e] = 0.0f;
#pragma unroll
      for (int e = 0; e < 9; ++e) gc[c * 9 + e] = 0.0f;
    }
    return;
  }
  const int c = pieces[block];
  const int lo = pieces[n_pieces + block];
  const int hi = pieces[2 * n_pieces + block];
  stage_piece<T>(cams, pts, obs, pt_idx, mask, c, lo, hi - lo, q_max, in, cp);

  float acc[kCamSums];
#pragma unroll
  for (int q = 0; q < kCamSums; ++q) acc[q] = 0.0f;
  // windows of T observations from the 32-aligned one at or below lo, so
  // that each of a warp's row stores is one whole 128-byte line
  const size_t stride = static_cast<size_t>(n_obs);
  for (int o = (lo & ~31) + static_cast<int>(threadIdx.x); o < hi; o += T) {
    if (o >= lo) {
      linearize_obs(cp, in, q_max, o - lo, robust_kind, robust_scale, freeze_mask, obs_out + o,
                    stride, acc);
    }
  }

  // the piece's 54 sums: warp shuffle, then the warps in order
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < kCamSums; ++q) {
    const float v = tba::warp_sum(acc[q]);
    if (lane == 0) partial[warp][q] = v;
  }
  __syncthreads();
  const int q = threadIdx.x;
  float v = 0.0f;
  if (q < kCamSums) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += partial[w][q];
  }
  const int first = piece_start[c];
  const int count = piece_start[c + 1] - first;
  if (count > 1) {
    // a scratch row per piece; the camera's last block to finish adds them
    // in piece order
    if (q < kCamSums) scratch[static_cast<size_t>(block) * kCamSums + q] = v;
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) is_last = atomicAdd(ticket + c, 1) == count - 1;
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    if (q < kCamSums) {
      v = 0.0f;
      const float* row = scratch + static_cast<size_t>(first) * kCamSums + q;
#pragma unroll 8
      for (int k = 0; k < count; ++k) v += __ldcg(row + static_cast<size_t>(k) * kCamSums);
    }
    if (threadIdx.x == 0) ticket[c] = 0;
  }
  if (q < kCamSums) write_camera(c, q, v, U, gc);
}

// Sum of v over K3's block, in a fixed order; valid in thread 0. The caller
// separates two uses of the same scratch by a __syncthreads.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = tba::warp_sum(v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float total = 0.0f;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < kCostThreads / 32; ++w) total += scratch[w];
  }
  return total;
}

// K3: block b works pieces b, b + G, … (G = gridDim.x); each thread forms a
// piece's camera part in registers and sums ρ·mask over its observations of
// the piece. At most 32 registers, so that all G = 1,024 blocks of 256 are
// resident at once.
__global__ void __launch_bounds__(kCostThreads, 2048 / kCostThreads)
cost_kernel(const float* __restrict__ cams, const float* __restrict__ pts,
            const float* __restrict__ obs, const int* __restrict__ pt_idx,
            const unsigned char* __restrict__ mask, const int* __restrict__ pieces, int n_pieces,
            int robust_kind, float robust_scale, float* __restrict__ partial, int* ticket,
            float* __restrict__ out) {
  __shared__ float scratch[kCostThreads / 32];
  __shared__ int is_last;
  const int G = gridDim.x;
  float acc = 0.0f;
  for (int b = blockIdx.x; b < n_pieces; b += G) {
    const int lo = pieces[n_pieces + b];
    const int hi = pieces[2 * n_pieces + b];
    CameraPart cp;
    tba::camera_part(cams + static_cast<size_t>(pieces[b]) * 9, cp);
    for (int o = lo + threadIdx.x; o < hi; o += kCostThreads) {
      const size_t p = static_cast<size_t>(pt_idx[o]);
      const float X[3] = {pts[3 * p], pts[3 * p + 1], pts[3 * p + 2]};
      const float mk = mask[o] ? 1.0f : 0.0f;
      Projection pc;
      tba::project_point(cp, X, obs[2 * static_cast<size_t>(o)],
                         obs[2 * static_cast<size_t>(o) + 1], mk, pc);
      const float sr = pc.r0 * pc.r0 + pc.r1 * pc.r1;
      acc += tba::robust_rho(robust_kind, sr, robust_scale) * mk;
    }
  }
  // one partial a block; the last block to finish adds them in block order
  const float total = block_sum(acc, scratch);
  if (threadIdx.x == 0) {
    partial[blockIdx.x] = total;
    __threadfence();
    is_last = atomicAdd(ticket, 1) == G - 1;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  float s = 0.0f;
#pragma unroll 4
  for (int k = threadIdx.x; k < G; k += kCostThreads) s += __ldcg(partial + k);
  const float sum = block_sum(s, scratch);
  if (threadIdx.x == 0) {
    out[0] = 0.5f * sum;
    ticket[0] = 0;
  }
}

// dynamic shared memory of a block staging pieces of at most q_max observations
size_t staged_bytes(int q_max) {
  return static_cast<size_t>(q_max) * (kStaged * sizeof(float) + sizeof(int));
}

template <int T>
cudaError_t launch_linearize(const float* cams, const float* pts, const float* obs,
                             const int* pt_idx, const unsigned char* mask, const int* pieces,
                             int n_pieces, int q_max, const int* piece_start, const int* empty,
                             int n_empty, int n_obs, int robust_kind, float robust_scale,
                             unsigned freeze_mask, float* U, float* gc, float* obs_out,
                             float* scratch, int* ticket, cudaStream_t stream) {
  const int n_blocks = n_pieces + (n_empty + T - 1) / T;
  if (n_blocks == 0) return cudaSuccess;
  linearize_kernel<T><<<n_blocks, T, staged_bytes(q_max), stream>>>(
      cams, pts, obs, pt_idx, mask, pieces, n_pieces, q_max, piece_start, empty, n_empty, n_obs,
      robust_kind, robust_scale, freeze_mask, U, gc, obs_out, scratch, ticket);
  return cudaGetLastError();
}

}  // namespace

extern "C" int tba_linearize(const float* cams, const float* pts, const float* obs,
                             const int* pt_idx, const unsigned char* mask, const int* pieces,
                             int n_pieces, int piece_obs, const int* piece_start,
                             const int* empty, int n_empty, int n_obs, int threads,
                             int robust_kind, float robust_scale, unsigned freeze_mask, float* U,
                             float* gc, float* obs_out, float* scratch, int* ticket,
                             void* stream) {
  if (piece_obs < 1 || piece_obs > kMaxPieceObs) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TBA_LIN_LAUNCH(T)                                                                     \
  launch_linearize<T>(cams, pts, obs, pt_idx, mask, pieces, n_pieces, piece_obs, piece_start, \
                      empty, n_empty, n_obs, robust_kind, robust_scale, freeze_mask, U, gc,   \
                      obs_out, scratch, ticket, s)
  cudaError_t err;
  switch (threads) {
    case 64: err = TBA_LIN_LAUNCH(64); break;
    case 128: err = TBA_LIN_LAUNCH(128); break;
    case 256: err = TBA_LIN_LAUNCH(256); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TBA_LIN_LAUNCH
  return static_cast<int>(err);
}

extern "C" int tba_cost(const float* cams, const float* pts, const float* obs, const int* pt_idx,
                        const unsigned char* mask, const int* pieces, int n_pieces,
                        int robust_kind, float robust_scale, float* partial, int* ticket,
                        float* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_pieces == 0) return static_cast<int>(cudaMemsetAsync(out, 0, sizeof(float), s));
  const int n_blocks = n_pieces < kCostBlocks ? n_pieces : kCostBlocks;
  cost_kernel<<<n_blocks, kCostThreads, 0, s>>>(cams, pts, obs, pt_idx, mask, pieces, n_pieces,
                                               robust_kind, robust_scale, partial, ticket, out);
  return static_cast<int>(cudaGetLastError());
}
