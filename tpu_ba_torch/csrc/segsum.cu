// K1: sorted segment sum, lane-major, with an optional gather fused in.
//
//   out[d, k] = Σ_{o : seg_start[k] ≤ o < seg_start[k+1]} values[d, perm ? perm[o] : o]
//
// Replaces the Pallas kernel tpu_ba/kernels/segsum.py:sorted_segment_sum_t
// (_segsum_kernel, a one-hot MXU matmul over a chunk/tile work list) and,
// with perm, the gather into key-sorted order that precedes it where the
// values lie in another order (the point-keyed sums of camera-sorted
// observations, the column-camera sums of the compact matvec).
//
// Bound: device-memory bandwidth. Every input value is read once and the
// output is D·n_out floats, with no arithmetic to speak of; at the main
// path's sizes (O = 678,912, D ∈ {3, 9, 12, 81}) a call moves 8–220 MB. The
// smaller calls take a few microseconds at that rate, so what they cost is
// how many loads are in flight while the grid ramps up and drains.
//
// Design: the keys are sorted, so each segment is a contiguous run of
// observations, given by CSR starts built once per problem on the host
// (tpu_ba_torch/solver/plans.py). A task is one segment over a tile of R rows
// (R = 3, 4, 2 or 1, the first that divides D; the row tiles lie on
// blockIdx.y): the starts and, with perm, the gathered indices are read once
// for the R rows, no thread divides, and the R loads of a step are
// independent. Two schedules, chosen by the caller from the mean and the
// longest segment's length (kernels/segsum.py:group_log2):
//   lanes   a group of 2ᵍ lanes (g ≤ 5) owns the task, walks the run in
//           strides of the group with the loop unrolled four times, and
//           folds by warp shuffles inside the group: point segments (a
//           handful of observations each, g = 1 … 3: neighbouring threads
//           read neighbouring runs, their lines shared through L1) and even
//           camera segments (a warp each);
//   block   128 threads own the task: segments far longer than the mean
//           (thousands of observations), for which lanes would wait. Without perm a row's run is read as 16-byte
//           loads between a scalar head and tail up to the alignment of its
//           address; the four warps' sums are added in order. Any run length.
// No atomics: the sum order is fixed and the result deterministic. An empty
// segment comes out exactly 0.
//
// The same kernels in double (tba_segsum_t_f64) serve the plain solver tiers
// in f64 on the card (kernels/segsum.py:segment_sum_t), whose sums must repeat
// bit for bit as the f32 ones do; the block schedule there reads scalars.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kLanesThreads = 256;
constexpr int kBlockThreads = 128;
constexpr int kBlockLog2 = 7;              // group_log2 of the block schedule

template <typename T, int R, bool kPerm>
__global__ void __launch_bounds__(kLanesThreads)
segsum_lanes_kernel(const T* __restrict__ values, const int* __restrict__ perm,
                    const int* __restrict__ seg_start, T* __restrict__ out, int n_obs,
                    int n_out, int group_log2) {
  const int group = 1 << group_log2;
  const unsigned gid = blockIdx.x * kLanesThreads + threadIdx.x;
  const int seg = static_cast<int>(gid >> group_log2);
  const int lane = static_cast<int>(gid & (group - 1));
  const size_t row0 = static_cast<size_t>(blockIdx.y) * R;
  const bool active = seg < n_out;
  T acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = T(0);
  if (active) {
    const T* v = values + row0 * n_obs;
    const int end = seg_start[seg + 1];
#pragma unroll 4
    for (int o = seg_start[seg] + lane; o < end; o += group) {
      const int at = kPerm ? perm[o] : o;
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] += v[static_cast<size_t>(r) * n_obs + at];
    }
  }
  // every lane of the warp takes part in the shuffles; groups never mix
  for (int off = group >> 1; off > 0; off >>= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] += __shfl_down_sync(0xffffffffu, acc[r], off, group);
  }
  if (active && lane == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) out[(row0 + r) * n_out + seg] = acc[r];
  }
}

template <typename T, int R, bool kPerm>
__global__ void __launch_bounds__(kBlockThreads)
segsum_block_kernel(const T* __restrict__ values, const int* __restrict__ perm,
                    const int* __restrict__ seg_start, T* __restrict__ out, int n_obs,
                    int n_out) {
  __shared__ T warp_s[kBlockThreads / 32][R];
  const int seg = blockIdx.x, tid = threadIdx.x;
  const size_t row0 = static_cast<size_t>(blockIdx.y) * R;
  const int start = seg_start[seg], end = seg_start[seg + 1];
  const T* v = values + row0 * n_obs;
  T acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = T(0);
  if constexpr (!std::is_same<T, float>::value) {
    // double: scalar loads, a row's run strided over the block
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const T* p = v + static_cast<size_t>(r) * n_obs;
#pragma unroll 4
      for (int o = start + tid; o < end; o += kBlockThreads) acc[r] += p[kPerm ? perm[o] : o];
    }
  } else if (kPerm) {
#pragma unroll 4
    for (int o = start + tid; o < end; o += kBlockThreads) {
      const int at = perm[o];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] += v[static_cast<size_t>(r) * n_obs + at];
    }
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float* p = v + static_cast<size_t>(r) * n_obs + start;   // the row's run
      const int len = end - start;
      // scalars up to the next 16-byte boundary, 16-byte loads, scalars behind
      int head = static_cast<int>((4 - ((reinterpret_cast<uintptr_t>(p) >> 2) & 3)) & 3);
      head = head < len ? head : len;
      const int n4 = (len - head) >> 2;
      const float4* p4 = reinterpret_cast<const float4*>(p + head);
      if (tid < head) acc[r] += p[tid];
#pragma unroll 2
      for (int i = tid; i < n4; i += kBlockThreads) {
        const float4 q = p4[i];
        acc[r] += (q.x + q.y) + (q.z + q.w);
      }
      const int tail = head + 4 * n4 + tid;
      if (tail < len) acc[r] += p[tail];
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc[r] += __shfl_down_sync(0xffffffffu, acc[r], off);
  }
  if ((tid & 31) == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) warp_s[tid >> 5][r] = acc[r];
  }
  __syncthreads();
  if (tid < R) {
    out[(row0 + tid) * n_out + seg] =
        ((warp_s[0][tid] + warp_s[1][tid]) + warp_s[2][tid]) + warp_s[3][tid];
  }
}

template <typename T, int R, bool kPerm>
int launch(const T* values, const int* perm, const int* seg_start, T* out, int n_rows,
           int n_obs, int n_out, int group_log2, cudaStream_t stream) {
  const unsigned tiles = static_cast<unsigned>(n_rows / R);
  if (tiles > 65535u) return static_cast<int>(cudaErrorInvalidValue);      // gridDim.y
  if (group_log2 == kBlockLog2) {
    segsum_block_kernel<T, R, kPerm><<<dim3(static_cast<unsigned>(n_out), tiles), kBlockThreads,
                                       0, stream>>>(values, perm, seg_start, out, n_obs, n_out);
  } else {
    const long long n_threads = static_cast<long long>(n_out) << group_log2;
    const unsigned n_blocks = static_cast<unsigned>((n_threads + kLanesThreads - 1) / kLanesThreads);
    segsum_lanes_kernel<T, R, kPerm><<<dim3(n_blocks, tiles), kLanesThreads, 0, stream>>>(
        values, perm, seg_start, out, n_obs, n_out, group_log2);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int R>
int launch_rows(const T* values, const int* perm, const int* seg_start, T* out,
                int n_rows, int n_obs, int n_out, int group_log2, cudaStream_t stream) {
  return perm != nullptr
             ? launch<T, R, true>(values, perm, seg_start, out, n_rows, n_obs, n_out,
                                  group_log2, stream)
             : launch<T, R, false>(values, perm, seg_start, out, n_rows, n_obs, n_out,
                                   group_log2, stream);
}

template <typename T>
int segsum_t(const T* values, const int* perm, const int* seg_start, T* out, int n_rows,
             int n_obs, int n_out, int group_log2, void* stream) {
  if (group_log2 < 0 || (group_log2 > 5 && group_log2 != kBlockLog2) || n_rows < 0 ||
      n_out < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rows == 0 || n_out == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_rows % 3 == 0) {
    return launch_rows<T, 3>(values, perm, seg_start, out, n_rows, n_obs, n_out, group_log2, s);
  }
  if (n_rows % 4 == 0) {
    return launch_rows<T, 4>(values, perm, seg_start, out, n_rows, n_obs, n_out, group_log2, s);
  }
  if (n_rows % 2 == 0) {
    return launch_rows<T, 2>(values, perm, seg_start, out, n_rows, n_obs, n_out, group_log2, s);
  }
  return launch_rows<T, 1>(values, perm, seg_start, out, n_rows, n_obs, n_out, group_log2, s);
}

}  // namespace

// perm: (n_obs) int32 or null. group_log2: 0 … 5 lanes a segment, or 7 for
// the block schedule.
extern "C" int tba_segsum_t(const float* values, const int* perm, const int* seg_start,
                            float* out, int n_rows, int n_obs, int n_out, int group_log2,
                            void* stream) {
  return segsum_t<float>(values, perm, seg_start, out, n_rows, n_obs, n_out, group_log2, stream);
}

extern "C" int tba_segsum_t_f64(const double* values, const int* perm, const int* seg_start,
                                double* out, int n_rows, int n_obs, int n_out, int group_log2,
                                void* stream) {
  return segsum_t<double>(values, perm, seg_start, out, n_rows, n_obs, n_out, group_log2,
                          stream);
}
