// The multiclass confusion-matrix counts of one batch, on Hopper.
//
// Replaces no TPU kernel: the JAX package computes these counts as an XLA
// composition (metrics_tpu/functional/classification/confusion_matrix.py:
// one-hot formatting of preds and target, an argmax of each back to a class,
// target * C + pred, a scatter add into C*C bins). The port ran the same
// composition, about ten passes over int64 tensors up to C times the input's
// width; this kernel reads each input once.
//
// What it computes, for preds [N, C, *X] float scores or [N, *X] integer
// labels and target [N, *X] integer labels, with nc = num_classes and W the
// one-hot width of the composition (at least 2):
//   pred class   = the first maximum along C, NaN the largest (the first
//                  NaN), as torch.argmax; for labels the label where it lies
//                  in [0, W), else 0 (the argmax of an all-zero one-hot row)
//   target class = by the labels' rule
//   cell         = target class * nc + pred class, never negative; a cell at
//                  or above nc*nc is dropped (utils/data.py::_bincount)
//   out[cell]   += 1, out int64 [nc, nc], zeroed here on the stream
// Counts are integers, so the order of the atomics changes no bit: the result
// equals the composition's bit for bit (ops/confusion_counts.py holds its
// plain form).
//
// Bound on an H100 SXM: bytes. A call reads N*C*X scores (or N*X labels) and
// N*X targets once and touches at most min(N*X, nc*nc) int64 cells; at
// [1, 19, 1024, 2048] float32 scores and int64 targets that is 176.2 MB,
// 52.6 us at 3.35 TB/s. The compares (C per position) are far below the
// card's rate.
//
// Designs, picked by the wrapper from the shapes alone (_plan):
//  - planes (scores, X > 1, or X == 1 with C <= 32): a thread per position
//    loops over the C planes at stride X, so neighbouring threads read
//    neighbouring addresses of each plane; four positions a thread with
//    16-byte loads where X is a multiple of four and the pointers allow.
//  - rows (scores, X == 1, C > 32): a group of 2-32 lanes per row reads the
//    row along C (16-byte loads where C is a multiple of four), each lane
//    keeps its first maximum, and warp shuffles merge the lanes' candidates,
//    the lower index winning a tie.
//  - labels: a thread per four positions (16-byte loads where allowed).
// Histogram: where nc*nc uint32 bins fit a block's shared memory, each block
// counts privately with shared atomics and adds its non-zero bins to `out`
// with one 64-bit global atomic each (a block counts fewer than 2^31
// positions, which the wrapper's grid keeps); otherwise every position adds
// to `out` with a 64-bit global atomic. The grid is about one wave and
// strides over the positions: one launch, no pass per plane.
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr long long kSmemOptin = 232448;  // a block's opt-in shared memory on sm_90
constexpr long long kSmemReserve = 1024;
constexpr long long kMaxClasses = 1LL << 28;  // keeps 8 * nc * nc inside 64 bits

struct Params {
  long long n;      // rows (N)
  long long x;      // positions per row (prod of X; 1 for [N, C] rows)
  long long nc;     // num_classes: the matrix is nc x nc
  long long width;  // W: a label outside [0, W) counts as class 0
  int c;            // the scores' C (1 for labels)
  int lanes;        // lanes per row (rows design)
  u64* out;
};

// True when (v, i) comes before (best, bi) in torch.argmax's order: a NaN
// beats every number, and between equal values, or two NaNs, the lower index
// wins.
template <typename S>
__device__ __forceinline__ bool beats(S v, int i, S best, int bi) {
  if (v != v) return best == best || i < bi;
  return v > best || (v == best && i < bi);
}

// The same for a candidate of a higher index than the one held.
template <typename S>
__device__ __forceinline__ bool beats_later(S v, S best) {
  return v != v ? best == best : v > best;
}

template <typename S>
__device__ __forceinline__ S neg_inf();
template <>
__device__ __forceinline__ float neg_inf<float>() { return __int_as_float(static_cast<int>(0xff800000u)); }
template <>
__device__ __forceinline__ double neg_inf<double>() {
  return __longlong_as_double(static_cast<long long>(0xfff0000000000000ULL));
}

template <typename L>
__device__ __forceinline__ long long label_class(L v, long long width) {
  const long long w = static_cast<long long>(v);
  return (w >= 0 && w < width) ? w : 0;
}

__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
}
__device__ __forceinline__ void load4(const double* p, double* v) {
  const double2 a = __ldg(reinterpret_cast<const double2*>(p));
  const double2 b = __ldg(reinterpret_cast<const double2*>(p + 2));
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}
__device__ __forceinline__ void load4(const int* p, int* v) {
  const int4 a = __ldg(reinterpret_cast<const int4*>(p));
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
}
__device__ __forceinline__ void load4(const long long* p, long long* v) {
  const longlong2 a = __ldg(reinterpret_cast<const longlong2*>(p));
  const longlong2 b = __ldg(reinterpret_cast<const longlong2*>(p + 2));
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}

// V consecutive values from p: one or two 16-byte loads for V == 4.
template <int V, typename E>
__device__ __forceinline__ void load(const E* p, E* v) {
  if constexpr (V == 4) {
    load4(p, v);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = __ldg(p + k);
  }
}

template <bool kShared>
__device__ __forceinline__ void count(long long t, long long p, const Params& a, unsigned* s_hist) {
  const long long cell = t * a.nc + p;
  if (cell >= a.nc * a.nc) return;
  if (kShared) {
    atomicAdd(s_hist + cell, 1u);
  } else {
    atomicAdd(a.out + cell, 1ull);
  }
}

template <bool kShared>
__device__ __forceinline__ void zero_bins(unsigned* s_hist, long long bins) {
  if (!kShared) return;
  for (long long i = threadIdx.x; i < bins; i += blockDim.x) s_hist[i] = 0u;
  __syncthreads();
}

template <bool kShared>
__device__ __forceinline__ void flush_bins(const unsigned* s_hist, long long bins, u64* out) {
  if (!kShared) return;
  __syncthreads();
  for (long long i = threadIdx.x; i < bins; i += blockDim.x) {
    const unsigned v = s_hist[i];
    if (v) atomicAdd(out + i, static_cast<u64>(v));
  }
}

// A thread per V positions; V divides X, so the V positions share their row.
template <typename S, typename T, int V, bool kShared>
__global__ void __launch_bounds__(kThreads)
    planes_kernel(const S* __restrict__ preds, const T* __restrict__ target, Params a) {
  extern __shared__ unsigned s_hist[];
  const long long bins = a.nc * a.nc;
  zero_bins<kShared>(s_hist, bins);
  const long long groups = a.n * a.x / V;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; g < groups; g += stride) {
    const long long pos = g * V;
    const long long row = pos / a.x;
    const S* p = preds + row * a.c * a.x + (pos - row * a.x);
    S best[V];
    int bi[V];
    load<V>(p, best);
#pragma unroll
    for (int v = 0; v < V; ++v) bi[v] = 0;
#pragma unroll 4
    for (int k = 1; k < a.c; ++k) {
      S val[V];
      load<V>(p + k * a.x, val);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if (beats_later(val[v], best[v])) best[v] = val[v], bi[v] = k;
      }
    }
    T tv[V];
    load<V>(target + pos, tv);
#pragma unroll
    for (int v = 0; v < V; ++v) count<kShared>(label_class(tv[v], a.width), bi[v], a, s_hist);
  }
  flush_bins<kShared>(s_hist, bins, a.out);
}

// A group of `lanes` lanes (a power of two up to 32) per row of C scores. The
// loop runs warp by warp, so that every lane of a warp takes each shuffle.
template <typename S, typename T, int V, bool kShared>
__global__ void __launch_bounds__(kThreads)
    rows_kernel(const S* __restrict__ preds, const T* __restrict__ target, Params a) {
  extern __shared__ unsigned s_hist[];
  const long long bins = a.nc * a.nc;
  zero_bins<kShared>(s_hist, bins);
  const int lanes = a.lanes;
  const int lane = threadIdx.x & (lanes - 1);
  const int per_warp = 32 / lanes;
  const long long warp = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long warps = (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  const int group = (threadIdx.x & 31) / lanes;
  const S empty = neg_inf<S>();
  for (long long r0 = warp * per_warp; r0 < a.n; r0 += warps * per_warp) {
    const long long r = r0 + group;
    // a lane with no element holds (-inf, INT_MAX), which every element beats
    S best = empty;
    int bi = 0x7FFFFFFF;
    if (r < a.n) {
      const S* row = preds + r * a.c;
#pragma unroll 4
      for (int i = lane * V; i < a.c; i += lanes * V) {
        S val[V];
        load<V>(row + i, val);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          if (bi == 0x7FFFFFFF || beats_later(val[v], best)) best = val[v], bi = i + v;
        }
      }
    }
    for (int off = lanes >> 1; off > 0; off >>= 1) {
      const S ov = __shfl_xor_sync(kFull, best, off);
      const int oi = __shfl_xor_sync(kFull, bi, off);
      if (beats(ov, oi, best, bi)) best = ov, bi = oi;
    }
    if (lane == 0 && r < a.n) count<kShared>(label_class(__ldg(target + r), a.width), bi, a, s_hist);
  }
  flush_bins<kShared>(s_hist, bins, a.out);
}

template <typename L, typename T, int V, bool kShared>
__global__ void __launch_bounds__(kThreads)
    labels_kernel(const L* __restrict__ preds, const T* __restrict__ target, Params a) {
  extern __shared__ unsigned s_hist[];
  const long long bins = a.nc * a.nc;
  zero_bins<kShared>(s_hist, bins);
  const long long groups = a.n * a.x / V;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; g < groups; g += stride) {
    L pv[V];
    T tv[V];
    load<V>(preds + g * V, pv);
    load<V>(target + g * V, tv);
#pragma unroll
    for (int v = 0; v < V; ++v) count<kShared>(label_class(tv[v], a.width), label_class(pv[v], a.width), a, s_hist);
  }
  flush_bins<kShared>(s_hist, bins, a.out);
}

template <typename P, typename T>
int run(void (*kernel)(const P*, const T*, Params), const P* preds, const T* target, const Params& a, int blocks,
        bool shared, cudaStream_t s) {
  const long long smem = shared ? 4 * a.nc * a.nc : 0;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<blocks, kThreads, static_cast<size_t>(smem), s>>>(preds, target, a);
  return static_cast<int>(cudaGetLastError());
}

template <typename S, typename T, int V, bool kShared>
int launch_scores(int design, const void* preds, const void* target, const Params& a, int blocks, cudaStream_t s) {
  const S* p = static_cast<const S*>(preds);
  const T* t = static_cast<const T*>(target);
  auto planes = planes_kernel<S, T, V, kShared>;
  auto rows = rows_kernel<S, T, V, kShared>;
  return design == 0 ? run(planes, p, t, a, blocks, kShared, s) : run(rows, p, t, a, blocks, kShared, s);
}

template <typename L, typename T, int V, bool kShared>
int launch_labels(const void* preds, const void* target, const Params& a, int blocks, cudaStream_t s) {
  auto labels = labels_kernel<L, T, V, kShared>;
  return run(labels, static_cast<const L*>(preds), static_cast<const T*>(target), a, blocks, kShared, s);
}

bool aligned16(const void* p) { return reinterpret_cast<unsigned long long>(p) % 16 == 0; }

template <typename S, typename T>
int dispatch_scores(int design, bool shared, const void* preds, const void* target, const Params& a, int blocks,
                    cudaStream_t s) {
  // 16-byte loads: four positions of a plane (planes) or four scores of a row
  // (rows), from 16-byte aligned starts
  const bool vec = design == 0 ? a.x % 4 == 0 && aligned16(preds) && aligned16(target)
                               : a.c % 4 == 0 && aligned16(preds);
  if (vec) {
    return shared ? launch_scores<S, T, 4, true>(design, preds, target, a, blocks, s)
                  : launch_scores<S, T, 4, false>(design, preds, target, a, blocks, s);
  }
  return shared ? launch_scores<S, T, 1, true>(design, preds, target, a, blocks, s)
                : launch_scores<S, T, 1, false>(design, preds, target, a, blocks, s);
}

template <typename L, typename T>
int dispatch_labels(bool shared, const void* preds, const void* target, const Params& a, int blocks, cudaStream_t s) {
  const bool vec = (a.n * a.x) % 4 == 0 && aligned16(preds) && aligned16(target);
  if (vec) {
    return shared ? launch_labels<L, T, 4, true>(preds, target, a, blocks, s)
                  : launch_labels<L, T, 4, false>(preds, target, a, blocks, s);
  }
  return shared ? launch_labels<L, T, 1, true>(preds, target, a, blocks, s)
                : launch_labels<L, T, 1, false>(preds, target, a, blocks, s);
}

template <typename T>
int dispatch(int preds_kind, int design, bool shared, const void* preds, const void* target, const Params& a,
             int blocks, cudaStream_t s) {
  switch (preds_kind) {
    case 0: return dispatch_scores<float, T>(design, shared, preds, target, a, blocks, s);
    case 1: return dispatch_scores<double, T>(design, shared, preds, target, a, blocks, s);
    case 2: return dispatch_labels<int, T>(shared, preds, target, a, blocks, s);
    case 3: return dispatch_labels<long long, T>(shared, preds, target, a, blocks, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// preds_kind: 0 float32, 1 float64 scores [n, c, x]; 2 int32, 3 int64 labels
// [n, x]. target_kind: 0 int32, 1 int64, target [n, x]. design: 0 planes,
// 1 rows (scores), 2 labels (labels); lanes a power of two up to 32 (rows),
// else 1. shared: count in shared memory (4 * nc * nc bytes must fit a
// block's). out is int64 [nc, nc], zeroed here on `stream`. All pointers are
// device pointers of contiguous tensors, n * x > 0. Returns the cudaError_t of
// the memset or the launch (0 on success). Launches on `stream` and does not
// synchronize.
extern "C" int confusion_counts_launch(const void* preds, int preds_kind, const void* target, int target_kind,
                                       long long n, int c, long long x, long long num_classes, long long width,
                                       int design, int lanes, int blocks, int shared, void* out, void* stream) {
  const bool labels = preds_kind == 2 || preds_kind == 3;
  if (n <= 0 || x <= 0 || c <= 0 || num_classes <= 0 || num_classes > kMaxClasses || width <= 0 ||
      width > 0x7FFFFFFF || blocks <= 0 ||
      lanes <= 0 || lanes > 32 || (lanes & (lanes - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (labels ? design != 2 : (design != 0 && design != 1)) return static_cast<int>(cudaErrorInvalidValue);
  if (shared && 4 * num_classes * num_classes > kSmemOptin - kSmemReserve) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = cudaMemsetAsync(out, 0, static_cast<size_t>(8 * num_classes * num_classes), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Params a{n, x, num_classes, width, c, lanes, static_cast<u64*>(out)};
  switch (target_kind) {
    case 0: return dispatch<int>(preds_kind, design, shared != 0, preds, target, a, blocks, s);
    case 1: return dispatch<long long>(preds_kind, design, shared != 0, preds, target, a, blocks, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
