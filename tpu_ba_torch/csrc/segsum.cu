// K1: sorted segment sum, lane-major.
//
//   out[d, k] = Σ_{o : seg_start[k] ≤ o < seg_start[k+1]} values[d, o]
//
// Replaces the Pallas kernel tpu_ba/kernels/segsum.py:sorted_segment_sum_t
// (_segsum_kernel, a one-hot MXU matmul over a chunk/tile work list).
//
// Bound: device-memory bandwidth. Every input value is read once and the
// output is D·n_out floats, with no arithmetic to speak of; at the slice's
// sizes (O = 678,912, D ∈ {3, 9, 12, 81}) a call moves 8–220 MB.
//
// Design: the keys are sorted, so each segment is a contiguous run of
// observations, given by CSR starts built once per problem on the host
// (tpu_ba_torch/solver/plans.py). A group of G lanes owns one (row, segment)
// task; the lanes walk the run with coalesced reads and reduce with warp
// shuffles inside the group. G is a power of two ≤ 32 chosen by the caller
// from the mean segment length (a quarter of it, rounded up), so one
// schedule serves camera segments (hundreds of observations, G = 32) and
// point segments (a handful, G = 2) without idling most of a warp. Tasks
// are numbered row-major, so neighbouring groups read neighbouring runs. No atomics: the sum order is
// fixed and the result deterministic. An empty segment comes out exactly 0.
#include <cuda_runtime.h>

namespace {

constexpr int kSegsumThreads = 256;

__global__ void __launch_bounds__(kSegsumThreads)
segsum_t_kernel(const float* __restrict__ values, const int* __restrict__ seg_start,
                float* __restrict__ out, int n_rows, int n_obs, int n_out, int group_log2) {
  const int group = 1 << group_log2;
  const long long gid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long task = gid >> group_log2;
  const int lane = static_cast<int>(gid & (group - 1));
  const long long n_tasks = static_cast<long long>(n_rows) * n_out;
  const bool active = task < n_tasks;
  int row = 0, seg = 0;
  float acc = 0.0f;
  if (active) {
    row = static_cast<int>(task / n_out);
    seg = static_cast<int>(task - static_cast<long long>(row) * n_out);
    const float* v = values + static_cast<size_t>(row) * n_obs;
    const int end = seg_start[seg + 1];
    for (int o = seg_start[seg] + lane; o < end; o += group) acc += v[o];
  }
  // every lane of the warp takes part in the shuffles; groups never mix
  for (int off = group >> 1; off > 0; off >>= 1) {
    acc += __shfl_down_sync(0xffffffffu, acc, off, group);
  }
  if (active && lane == 0) out[static_cast<size_t>(row) * n_out + seg] = acc;
}

}  // namespace

extern "C" int tba_segsum_t(const float* values, const int* seg_start, float* out, int n_rows,
                            int n_obs, int n_out, int group_log2, void* stream) {
  if (group_log2 < 0 || group_log2 > 5) return static_cast<int>(cudaErrorInvalidValue);
  const long long n_threads = (static_cast<long long>(n_rows) * n_out) << group_log2;
  if (n_threads == 0) return static_cast<int>(cudaGetLastError());
  const long long n_blocks = (n_threads + kSegsumThreads - 1) / kSegsumThreads;
  segsum_t_kernel<<<static_cast<unsigned>(n_blocks), kSegsumThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(values, seg_start, out, n_rows, n_obs,
                                                         n_out, group_log2);
  return static_cast<int>(cudaGetLastError());
}
