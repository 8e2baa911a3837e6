// K5: band blocks of the consecutive-camera tracks.
//
// For a tracked point p with start camera key[p] and slots a ≤ b whose mask
// is set (a masked slot's W counts as zero):
//
//   out[(9m+n)·ld_out + (b−a)·c_pad + key[p] + a] += [ W_a(p) · V_λ(p)⁻¹ · W_b(p)ᵀ ][m, n]
//
// Wt (27, dmax, Pt), Vt (9, Pt), mask (dmax, Pt) of 0 and 1, points sorted by
// key; key_start (c_pad + 1) are the CSR starts of the keys of the real
// points; out (81 rows of ld_out ≥ dmax·c_pad) holds the off-major grid of the
// band offsets 0..dmax−1 in its first columns and is accumulated into: the
// caller hands over the band under assembly (whose first dmax offsets are
// 0..dmax−1) or a cleared grid. Replaces the Pallas kernel
// tpu_ba/kernels/trackband.py:fused_track_blocks (slot-pair products in VMEM,
// a one-hot MXU reduction keyed by start camera over a margin-extended work
// list) and the per-offset adds that carried its output into the band.
//
// Bound: device-memory bytes. ladybug-1723 (dmax 5, 108,300 points, Pt
// 108,544): Wt 58.6 MB, Vt 3.9 MB and the mask 2.2 MB read, the band cells of
// the 5 track offsets (2.9 MB) read and written: 70.5 MB, 0.021 ms at 3.35
// TB/s, against 1.45 M live 9×9 products (0.35 G multiply-adds, 0.011 ms).
//
// The earlier design (one block per band row, walking a = 0..dmax−1 and the
// run of key r − a each time) took 0.35 ms, 17× the bound:
// - a point of degree 5 was staged 5 times, slots a..dmax−1 each time: W read
//   15 slot-times a point (~175 MB a call), the inverse formed 5 times, by 16
//   of 256 threads while the rest waited;
// - four divisions by run-time values per staged float;
// - 16 points a chunk and three barriers each, ~70 barriers a block;
// - an owner per (offset, entry): at slot a only offsets below dmax − a work
//   (~60% live), and products past a point's degree were formed as zeros;
// - 6 shared loads for 3 multiply-adds per entry;
// - a (dmax·81, c_pad) temporary, then dmax slice adds into the band.
//
// Design: one block per tile of G consecutive band rows r0..r0+G−1 (G = 4:
// 448 blocks at c_pad 1,792). The points that write the tile are the keys
// r0+G−1 down to r0−dmax+1, G+dmax−1 contiguous runs; the block walks them in
// descending key and ascending point within a key, each point once, in chunks
// of 32 points:
// - staging: item (point j, slot s) is thread 32·s + j, so a warp reads a W
//   row at 32 consecutive points. dmax is a template argument and a staged
//   index finds its run by counting the run starts it has passed: no
//   division. The item forms V_λ⁻¹ itself (dmax-fold, in parallel, with no
//   barrier between) and M_s = W_s·V_λ⁻¹, and stores W_s and M_s in row groups
//   padded to 16 bytes. The next chunk's loads go into registers before the
//   current chunk's products, which hide their latency.
// - per call a (point, slot)'s W is read once for each tile its key falls in,
//   (G + dmax − 1)/G = 2 times at G = 4 (the second mostly from L2, since the
//   neighbouring tile runs at the same time), and V_λ⁻¹ and M_s are formed
//   twice per live (point, slot): ~0.97 M of each on ladybug-1723, against
//   ~1.6 M stagings and 0.54 M inverses before.
// - products: an owner holds a 3×3 sub-block of one (row, offset) cell, 9
//   owners a cell, G·dmax·9 owners (180 in 192 threads at dmax 5). In
//   descending key order the points of cell (r, off), keys r down to
//   r − (dmax−1−off), are one contiguous range of the staged list: the owner
//   walks its part of each chunk and adds only live products (both slots under
//   the point's degree), 6 float4 shared loads for 27 multiply-adds.
// - two barriers a chunk: after staging and after the products.
// - each cell has one owner, which sums keys r, r−1, … and points ascending
//   within a key, from 0, in the earlier design's order and arithmetic
//   (bandmath.cuh), and then adds the sum to the band once: no atomics and
//   the same bits every run.
//
// Measured on an H100 (ladybug-1723, adding into the band, W from device
// memory): 0.198 ms against 0.336 for the earlier design and its slice adds,
// ~9× the byte bound, and the same from L2. A per-warp clock profile puts most
// of a block's time in the products and about a third of it in staging, with
// short barrier waits; 124 registers a thread let 2 blocks share an SM. Tiles
// of 8 rows ran slower (0.269 ms); a warp per band row, its lanes on one list
// of points (uniform ranges, broadcast loads of M_a), ran at 0.216 ms, and
// with a staging warp that forms each V_λ⁻¹ once no faster than this design.
#include <cuda_runtime.h>

#include "bandmath.cuh"

namespace {

constexpr int kTrkMaxD = 8;       // the planner's dmax_cap
constexpr int kTrkChunk = 32;     // staged points per chunk
constexpr int kTrkPad = 36;       // a staged 9×3 block: row groups 3g..3g+2 (9 floats) at 12g
constexpr int kTrkTile = 4;       // band rows a block

template <int D>
struct TrackTile {
  static constexpr int G = kTrkTile;
  static constexpr int kKeys = G + D - 1;                 // the runs a tile reads
  static constexpr int kOwners = G * D * 9;               // 3×3 sub-blocks of the tile's cells
  static constexpr int kThreads = (kOwners + 31) / 32 * 32;
  static constexpr int kItems = kTrkChunk * D;            // staged (point, slot) items a chunk
  static constexpr size_t kSmem = sizeof(float) * 2 * kTrkChunk * D * kTrkPad;
  static_assert(kItems <= kThreads, "one staged item a thread");
};

// A 9×3 block (entry 3m+a) into its padded staging: rows 3g..3g+2 at 12g.
__device__ __forceinline__ void store_block(float* dst, const float x[27]) {
  float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int g = 0; g < 3; ++g) {
    const float* s = x + 9 * g;
    d4[3 * g] = make_float4(s[0], s[1], s[2], s[3]);
    d4[3 * g + 1] = make_float4(s[4], s[5], s[6], s[7]);
    d4[3 * g + 2] = make_float4(s[8], 0.0f, 0.0f, 0.0f);
  }
}

// The 9 floats of one padded row group.
__device__ __forceinline__ void load_group(const float* src, float x[9]) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
  const float4 a = s4[0], b = s4[1], c = s4[2];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  x[8] = c.x;
}

template <int D>
__global__ void __launch_bounds__(TrackTile<D>::kThreads)
track_tile_kernel(const float* __restrict__ Wt, const float* __restrict__ Vt,
                  const float* __restrict__ mask, const int* __restrict__ key_start,
                  const float* __restrict__ lam_p, float* __restrict__ out, int pt_pad,
                  int c_pad, int ld_out, float lo, float hi) {
  using T = TrackTile<D>;
  constexpr int G = T::G;
  extern __shared__ __align__(16) float smem[];
  float* w_s = smem;                                   // [j][s][kTrkPad]: W_s·mask
  float* m_s = smem + kTrkChunk * D * kTrkPad;         // [j][s][kTrkPad]: M_s = W_s·V_λ⁻¹
  __shared__ int start_s[T::kKeys];                    // run kk: key r0+G−1−kk, its first point
  __shared__ int so_s[T::kKeys + 1];                   // and its offset in the staged list
  __shared__ int kk_s[kTrkChunk];                      // the run of each staged point
  __shared__ unsigned char live_s[kTrkChunk][D];       // its slots' mask

  const int t = threadIdx.x;
  const int r0 = blockIdx.x * G;
  const float lam = *lam_p;
  const size_t pp = static_cast<size_t>(pt_pad);

  if (t == 0) {
    int n = 0;
#pragma unroll
    for (int kk = 0; kk < T::kKeys; ++kk) {
      const int key = r0 + G - 1 - kk;
      const bool in = key >= 0 && key < c_pad;
      const int s0 = in ? key_start[key] : 0;
      start_s[kk] = s0;
      so_s[kk] = n;
      n += in ? key_start[key + 1] - s0 : 0;
    }
    so_s[T::kKeys] = n;
  }
  __syncthreads();
  const int n_staged = so_s[T::kKeys];

  // owner t: sub-block (gi, gj) of cell (row r0 + rr, offset off)
  const int cell = t / 9, sub = t - 9 * cell;
  const int gi = sub / 3, gj = sub - 3 * gi;
  const int rr = cell / D, off = cell - D * rr;
  const int r = r0 + rr;
  const int kr = G - 1 - rr;                           // the run of key r
  const bool owns = t < T::kOwners && r < c_pad;
  const int lo_j = owns ? so_s[kr] : 0;                // the cell's points: runs kr..kr+D−1−off
  const int hi_j = owns ? so_s[kr + D - off] : 0;

  // staging item t: point js of the chunk, slot ss
  const bool item = t < T::kItems;
  const int js = t % kTrkChunk, ss = t / kTrkChunk;
  float wr[27], vr[9];
  float mk = 0.0f;
  int kk_i = 0;
  auto fetch = [&](int c0) {
    const int i = c0 + js;
    if (!item || i >= n_staged) return;
    int kk = 0;
#pragma unroll
    for (int q = 1; q < T::kKeys; ++q) kk += i >= so_s[q];
    kk_i = kk;
    const size_t p = static_cast<size_t>(start_s[kk] + (i - so_s[kk]));
    mk = mask[ss * pp + p];
#pragma unroll
    for (int row = 0; row < 27; ++row) wr[row] = Wt[(static_cast<size_t>(row) * D + ss) * pp + p];
#pragma unroll
    for (int e = 0; e < 9; ++e) vr[e] = Vt[e * pp + p];
  };
  auto commit = [&](int np) {
    if (!item || js >= np) return;
    if (ss == 0) kk_s[js] = kk_i;
    live_s[js][ss] = mk != 0.0f;
    if (mk == 0.0f) return;
    float w[27], inv[9], m[27];
#pragma unroll
    for (int row = 0; row < 27; ++row) w[row] = wr[row] * mk;
    tba::damped_inv3(vr, lam, lo, hi, inv);
#pragma unroll
    for (int q = 0; q < 27; ++q) m[q] = tba::w_inv_entry(w, inv, q / 3, q % 3);
    store_block(w_s + (js * D + ss) * kTrkPad, w);
    store_block(m_s + (js * D + ss) * kTrkPad, m);
  };

  float acc[9];
#pragma unroll
  for (int e = 0; e < 9; ++e) acc[e] = 0.0f;
  fetch(0);
  for (int c0 = 0; c0 < n_staged; c0 += kTrkChunk) {
    const int np = min(kTrkChunk, n_staged - c0);
    commit(np);
    __syncthreads();
    fetch(c0 + kTrkChunk);
    const int q1 = min(hi_j, c0 + np) - c0;
    for (int q = max(lo_j, c0) - c0; q < q1; ++q) {
      const int a = kk_s[q] - kr;                       // the point's slot at row r
      const int b = a + off;
      if (live_s[q][a] & live_s[q][b]) {
        float mrow[9], wcol[9];
        load_group(m_s + (q * D + a) * kTrkPad + 12 * gi, mrow);
        load_group(w_s + (q * D + b) * kTrkPad + 12 * gj, wcol);
#pragma unroll
        for (int mm = 0; mm < 3; ++mm) {
#pragma unroll
          for (int nn = 0; nn < 3; ++nn) acc[3 * mm + nn] += tba::block_entry(mrow, wcol, mm, nn);
        }
      }
    }
    __syncthreads();
  }
  if (owns) {
    float* col = out + static_cast<size_t>(off) * c_pad + r;
#pragma unroll
    for (int mm = 0; mm < 3; ++mm) {
#pragma unroll
      for (int nn = 0; nn < 3; ++nn) {
        const int e = 9 * (3 * gi + mm) + 3 * gj + nn;
        col[static_cast<size_t>(e) * ld_out] += acc[3 * mm + nn];
      }
    }
  }
}

struct TrackArgs {
  const float *Wt, *Vt, *mask;
  const int* key_start;
  const float* lam;
  float* out;
  int pt_pad, c_pad, ld_out;
  float lo, hi;
};

template <int D>
int launch_tile(const TrackArgs& a, cudaStream_t stream) {
  using T = TrackTile<D>;
  auto kernel = track_tile_kernel<D>;
  // set once, at the first launch (before any graph capture)
  static const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(T::kSmem));
  if (set != cudaSuccess) return static_cast<int>(set);
  const unsigned n_tiles = static_cast<unsigned>((a.c_pad + T::G - 1) / T::G);
  kernel<<<n_tiles, T::kThreads, T::kSmem, stream>>>(
      a.Wt, a.Vt, a.mask, a.key_start, a.lam, a.out, a.pt_pad, a.c_pad, a.ld_out, a.lo, a.hi);
  return static_cast<int>(cudaGetLastError());
}

int launch(int dmax, const TrackArgs& a, cudaStream_t stream) {
  switch (dmax) {
    case 1: return launch_tile<1>(a, stream);
    case 2: return launch_tile<2>(a, stream);
    case 3: return launch_tile<3>(a, stream);
    case 4: return launch_tile<4>(a, stream);
    case 5: return launch_tile<5>(a, stream);
    case 6: return launch_tile<6>(a, stream);
    case 7: return launch_tile<7>(a, stream);
    case 8: return launch_tile<8>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int tba_track_blocks(const float* Wt, const float* Vt, const float* mask,
                                const int* key_start, const float* lam, float* out, int dmax,
                                int pt_pad, int c_pad, int ld_out, float diag_floor,
                                float diag_ceil, void* stream) {
  if (dmax < 1 || dmax > kTrkMaxD || ld_out < dmax * c_pad) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (c_pad <= 0) return static_cast<int>(cudaGetLastError());
  const TrackArgs a{Wt, Vt, mask, key_start, lam, out, pt_pad, c_pad, ld_out, diag_floor,
                    diag_ceil};
  return launch(dmax, a, static_cast<cudaStream_t>(stream));
}
