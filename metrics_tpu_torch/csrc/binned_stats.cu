// Per-class, per-threshold counts for the binned PR-curve metrics, on Hopper.
//
// Replaces the TPU kernel metrics_tpu/ops/pallas_binned.py::_kernel (launched
// by _binned_stats_pallas). For preds [N, C] float32, target [N, C] (nonzero =
// positive) and thresholds [T] float32 it counts, for every class c and
// threshold t:
//   tp[c, t]  = #{n : target[n, c] != 0 and preds[n, c] >= thr[t]}
//   cnt[c, t] = #{n : preds[n, c] >= thr[t]}
//   pos[c]    = #{n : target[n, c] != 0}
// The caller forms FP = cnt - tp and FN = pos - tp (ops/binned_stats.py).
//
// Exactness. The compare is `pred >= thr` in float32, so a pred exactly at a
// threshold is positive and a NaN pred is negative at every threshold, as in
// the compare oracle. Counts are int32 and merged with integer atomics, so
// the order in which blocks finish cannot change a bit; thresholds in any
// order are fine (no sortedness is assumed). The metrics keep these counts as
// float32 states, which are exact while a count stays below 2^24.
//
// Bound on an H100 SXM. The kernel must read N*C*(4 + sizeof(target)) bytes
// and do N*C*T float32 compares. Against 3.35 TB/s and 67 T float32 op/s the
// two are close, the bytes a little larger: 2048x10x100 (float32 target) is
// 164 KB (0.05 us) against 2.0 M compares (0.03 us); 65536x8x128 is 4.2 MB
// (1.25 us) against 67 M compares (1.0 us). So the bound is memory, and at
// these sizes a launch costs more than either.
//
// Design. The TPU kernel streams class-major tiles through one core in order
// and carries sums in its output block. Here blocks run in parallel: the grid
// is (row chunks) x (tiles of 32 classes). A block stages its [rows, classes]
// tile of preds and targets in shared memory with coalesced loads (rows are
// contiguous in memory), then each thread owns one class and four thresholds,
// holds the four thresholds and eight integer counters in registers, and
// walks the staged rows, so each staged pred is read once per four compares.
// At the end each thread adds its counts to the [C, T] outputs with one
// integer atomicAdd per (class, threshold), skipping zeros. The wrapper picks
// the rows per block so that the grid holds about four blocks per SM. A later
// redesign may bucket each pred once (binary search in shared memory, O(log T)
// per element) instead of comparing against all T thresholds.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kClassTile = 32;
constexpr int kRowsMax = 256;
constexpr int kThrPerThread = 4;

template <typename TT>
__global__ void __launch_bounds__(kThreads) binned_stats_kernel(
    const float* __restrict__ preds, const TT* __restrict__ target,
    const float* __restrict__ thresholds, long long n, int c, int t, int rows_per_block,
    int* __restrict__ tp, int* __restrict__ cnt, int* __restrict__ pos) {
  __shared__ float s_pred[kRowsMax * kClassTile];
  __shared__ unsigned char s_tgt[kRowsMax * kClassTile];

  const long long row0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const int c0 = blockIdx.y * kClassTile;
  const int ctile = min(kClassTile, c - c0);
  const int rows = static_cast<int>(min(static_cast<long long>(rows_per_block), n - row0));

  for (int i = threadIdx.x; i < rows * ctile; i += blockDim.x) {
    const int r = i / ctile;
    const int cl = i - r * ctile;
    const long long g = (row0 + r) * c + c0 + cl;
    s_pred[i] = preds[g];
    s_tgt[i] = target[g] != TT(0);
  }
  __syncthreads();

  const int tgroups = (t + kThrPerThread - 1) / kThrPerThread;
  for (int item = threadIdx.x; item < ctile * tgroups; item += blockDim.x) {
    const int cl = item / tgroups;
    const int t0 = (item - cl * tgroups) * kThrPerThread;
    float thr[kThrPerThread];
    int tp_c[kThrPerThread];
    int cnt_c[kThrPerThread];
#pragma unroll
    for (int k = 0; k < kThrPerThread; ++k) {
      thr[k] = t0 + k < t ? thresholds[t0 + k] : 0.0f;
      tp_c[k] = 0;
      cnt_c[k] = 0;
    }
    for (int r = 0; r < rows; ++r) {
      const float x = s_pred[r * ctile + cl];
      const int w = s_tgt[r * ctile + cl];
#pragma unroll
      for (int k = 0; k < kThrPerThread; ++k) {
        const int ge = x >= thr[k];  // false for a NaN pred
        cnt_c[k] += ge;
        tp_c[k] += ge & w;
      }
    }
    const int out0 = (c0 + cl) * t + t0;
#pragma unroll
    for (int k = 0; k < kThrPerThread; ++k) {
      if (t0 + k < t) {
        if (cnt_c[k]) atomicAdd(&cnt[out0 + k], cnt_c[k]);
        if (tp_c[k]) atomicAdd(&tp[out0 + k], tp_c[k]);
      }
    }
  }

  for (int cl = threadIdx.x; cl < ctile; cl += blockDim.x) {
    int s = 0;
    for (int r = 0; r < rows; ++r) s += s_tgt[r * ctile + cl];
    if (s) atomicAdd(&pos[c0 + cl], s);
  }
}

template <typename TT>
void launch(const void* preds, const void* target, const void* thresholds, long long n, int c,
            int t, int rows_per_block, void* tp, void* cnt, void* pos, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((n + rows_per_block - 1) / rows_per_block),
                  static_cast<unsigned>((c + kClassTile - 1) / kClassTile));
  binned_stats_kernel<TT><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(preds), static_cast<const TT*>(target),
      static_cast<const float*>(thresholds), n, c, t, rows_per_block, static_cast<int*>(tp),
      static_cast<int*>(cnt), static_cast<int*>(pos));
}

}  // namespace

// target_kind: 0 float32, 1 int32, 2 int64.
// tp and cnt are zeroed int32 [C, T], pos a zeroed int32 [C]; all pointers
// are device pointers of contiguous tensors. Returns the cudaError_t of the
// launch (0 on success). Launches on `stream` and does not synchronize.
extern "C" int binned_stats_launch(const void* preds, const void* target, int target_kind,
                                   const void* thresholds, long long n, int c, int t,
                                   int rows_per_block, void* tp, void* cnt, void* pos,
                                   void* stream) {
  if (n <= 0 || c <= 0 || t <= 0 || rows_per_block <= 0 || rows_per_block > kRowsMax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (target_kind) {
    case 0: launch<float>(preds, target, thresholds, n, c, t, rows_per_block, tp, cnt, pos, s); break;
    case 1: launch<int>(preds, target, thresholds, n, c, t, rows_per_block, tp, cnt, pos, s); break;
    case 2: launch<long long>(preds, target, thresholds, n, c, t, rows_per_block, tp, cnt, pos, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
