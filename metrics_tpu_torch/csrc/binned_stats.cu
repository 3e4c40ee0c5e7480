// Per-class, per-threshold counts for the binned PR-curve metrics, on Hopper.
//
// Replaces the TPU kernel metrics_tpu/ops/pallas_binned.py::_kernel (launched
// by _binned_stats_pallas). For preds [N, C] float32, target [N, C] (nonzero =
// positive) and thresholds [T] float32 it writes out = float32 [3, C, T]:
//   out[0, c, t] = TP = #{n : target[n, c] != 0 and preds[n, c] >= thr[t]}
//   out[1, c, t] = FP = cnt - TP, with cnt = #{n : preds[n, c] >= thr[t]}
//   out[2, c, t] = FN = pos - TP, with pos = #{n : target[n, c] != 0}
//
// Exactness. A pred counts at every threshold it is >= to, in float32: a pred
// exactly at a threshold is positive, a NaN pred is negative everywhere, and
// a NaN threshold counts nothing. Counts stay integers until the one cast to
// float32 at the very end, and integer atomics commute, so the order in which
// blocks finish changes no bit. The result equals the compare oracle
// (ops/binned_stats.py::_binned_stats_compare) bit for bit.
//
// Bound on an H100 SXM. The function must read N*C*(4 + sizeof(target)) bytes
// and write 12*C*T; the histogram design does about N*C*log2(T+1) float32
// compares. Against 3.35 TB/s and 67 T float32 op/s the bytes are the bound:
// (2048, 1000, 100) moves 17.6 MB, 5.3 us. At the main path's (2048, 10, 100)
// the bound is 0.05 us and a launch costs more than the work.
//
// Design 1, the histogram (every shape whose tables fit in shared memory):
//  - one launch does everything. The C entry zeroes the scratch with one
//    cudaMemsetAsync, only when the grid has more than one row block, and
//    launches binned_hist_kernel, which writes TP, FP and FN as float32. No
//    tensor op runs after it.
//  - each block sorts (value, index) keys of the thresholds in shared memory
//    (NaN last): for T <= 256 a key's rank, one pass over the keys, is its
//    place; above that a bitonic sort. Thresholds in any order and duplicates
//    take the same path, and the host reads nothing back.
//  - each element is bucketed once, bucket = #{sorted non-NaN thr <= x}, by a
//    binary search in shared memory (O(log T), not the O(T) compare loop),
//    and counted in [class tile][T+1] shared-memory histograms of raw and of
//    target counts with shared-memory atomics. The searches of a thread's
//    batch (8 scalar or 4 x 16-byte items) run in lockstep and branch-free,
//    so a step's loads issue together, and the table has a word of padding
//    after every 32 entries, so that one step's reads, a power of two apart,
//    spread over the banks. The next batch loads while this one counts; the
//    first loads before the sort.
//  - the grid is one wave, at most one block per SM and about eight elements
//    per thread. Class tiles come first: whole rows, or tiles of a multiple
//    of 8 (4) classes, whole 32-byte sectors, with 16-byte loads when C and
//    the tile are multiples of four. Row blocks split the rows only when the
//    class tiles do not fill the wave, with at least about four rows per bin
//    in each, so a block's flush is small against its work.
//  - with one row block, a block owns its classes and runs the epilogue from
//    its own shared memory. With more, each block adds its non-zero bins to
//    uint64 [C, T+1] scratch with one 64-bit atomic each (raw count in the
//    low word, target count in the high word), and the last block of each
//    class tile (a __threadfence and an atomic ticket) copies the merged bins
//    back into its shared memory and runs the epilogue.
//  - the epilogue: a warp per class takes a suffix scan over the bins and
//    scatters cnt, TP and pos - TP back through the sort's permutation.
//
// Design 2, the compare (kept for T too large for the tables, above about
// 8192 thresholds, and forced by the wrapper's `design="compare"`): row chunks
// x tiles of 32 classes, the tile staged in shared memory, each thread compares
// one class against four thresholds per staged row with counters in registers
// and adds them to int32 scratch with one atomicAdd per (class, threshold);
// the last block of each class tile writes the float32 result.
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;

// ---------------------------------------------------------------- histogram

// An order on float32 bits that refines float order (-0.0 before +0.0) and
// puts every NaN after +inf.
__device__ __forceinline__ unsigned sort_key(float f) {
  const unsigned u = __float_as_uint(f);
  if (f != f) return 0xFFFFFFFFu;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The threshold of a (sort_key << 32 | index) key (a NaN for a NaN's key).
__device__ __forceinline__ float key_value(u64 key) {
  const unsigned hi = static_cast<unsigned>(key >> 32);
  return __uint_as_float((hi & 0x80000000u) ? (hi & 0x7FFFFFFFu) : ~hi);
}

template <typename TT>
__device__ __forceinline__ unsigned nonzero(TT v) {
  return v != TT(0) ? 1u : 0u;
}

template <int V, typename TT>
struct Load;

template <typename TT>
struct Load<1, TT> {
  static __device__ __forceinline__ void run(const float* p, const TT* w, float* x, unsigned* y) {
    x[0] = __ldg(p);
    y[0] = nonzero(__ldg(w));
  }
};

__device__ __forceinline__ void load4(const float* w, unsigned* y) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(w));
  y[0] = nonzero(v.x), y[1] = nonzero(v.y), y[2] = nonzero(v.z), y[3] = nonzero(v.w);
}
__device__ __forceinline__ void load4(const int* w, unsigned* y) {
  const int4 v = __ldg(reinterpret_cast<const int4*>(w));
  y[0] = nonzero(v.x), y[1] = nonzero(v.y), y[2] = nonzero(v.z), y[3] = nonzero(v.w);
}
__device__ __forceinline__ void load4(const long long* w, unsigned* y) {
  const longlong2 a = __ldg(reinterpret_cast<const longlong2*>(w));
  const longlong2 b = __ldg(reinterpret_cast<const longlong2*>(w + 2));
  y[0] = nonzero(a.x), y[1] = nonzero(a.y), y[2] = nonzero(b.x), y[3] = nonzero(b.y);
}

template <typename TT>
struct Load<4, TT> {
  static __device__ __forceinline__ void run(const float* p, const TT* w, float* x, unsigned* y) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
    load4(w, y);
  }
};

// Where sorted threshold i sits in the padded table.
__host__ __device__ __forceinline__ int thr_at(int i) { return i + (i >> 5); }

__device__ __forceinline__ u64 warp_sum(u64 v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Dynamic shared memory: a region of max(P, class_tile * (T+1)) 8-byte words
// (first the P sort keys, P the power of two >= T; then the histogram: raw
// counts [class tile][T+1], then target counts [class tile][T+1], uint32),
// then the original indices of the sorted thresholds [T] and the sorted
// thresholds, NaN-padded to T + P/2 entries, with one word of padding after
// every 32 (thr_at), so that the steps of the binary search, which read
// indices a power of two apart, do not all fall on one bank.
template <typename TT, int V>
__global__ void __launch_bounds__(kThreads) binned_hist_kernel(
    const float* __restrict__ preds, const TT* __restrict__ target, const float* __restrict__ thresholds,
    long long n, int c, int t, int class_tile, int rows_per_block, u64* __restrict__ g_hist,
    unsigned* __restrict__ g_ticket, float* __restrict__ out) {
  constexpr int U = V == 1 ? 8 : 4;  // items of V elements each thread has in flight
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_tv;
  __shared__ bool s_last;
  const int bins = t + 1;
  int p2 = 1;
  while (p2 < t) p2 <<= 1;
  const int region = max(p2, class_tile * bins);
  u64* s_keys = reinterpret_cast<u64*>(smem);
  unsigned* s_raw = reinterpret_cast<unsigned*>(smem);
  int* s_perm = reinterpret_cast<int*>(smem + 8LL * region);
  float* s_thr = reinterpret_cast<float*>(s_perm + t);

  // 0. this block's rows x class tile, walked in items of V elements of a
  //    row; the first U items per thread are loaded before the sort, so that
  //    their latency hides behind it
  const int c0 = blockIdx.y * class_tile;
  const int ctile = min(class_tile, c - c0);
  const long long row0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const int rows = static_cast<int>(min(static_cast<long long>(rows_per_block), n - row0));
  const int vpr = ctile / V;  // items per row of the tile
  const long long items = static_cast<long long>(rows) * vpr;
  const int dr = kThreads / vpr, dv = kThreads - dr * vpr;
  int r = threadIdx.x / vpr, v = threadIdx.x - r * vpr;
  float x[U][V], xn[U][V];  // this batch and the next
  unsigned y[U][V], yn[U][V];
  int cl[U], cln[U];  // class of the item's first element in the tile, -1 past the end
  // branch-free, so that the batch's loads issue together: an item past the
  // end loads the block's first item again and is marked -1
  auto load_batch = [&](long long i) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool in = i + static_cast<long long>(u) * kThreads < items;
      const long long g = row0 * c + c0 + (in ? static_cast<long long>(r) * c + static_cast<long long>(v) * V : 0);
      Load<V, TT>::run(preds + g, target + g, xn[u], yn[u]);
      cln[u] = in ? v * V : -1;
      r += dr;
      v += dv;
      if (v >= vpr) {
        v -= vpr;
        ++r;
      }
    }
  };
  load_batch(threadIdx.x);

  // 1. sort the thresholds by (value, index), NaN last: the keys are
  //    distinct, so for T <= kThreads a key's rank (one pass over the keys)
  //    is its place; above that a bitonic sort. s_tv counts the non-NaN ones.
  if (threadIdx.x == 0) s_tv = 0;
  __syncthreads();
  int valid = 0;
  for (int i = threadIdx.x; i < p2; i += kThreads) {
    const unsigned key = i < t ? sort_key(thresholds[i]) : 0xFFFFFFFFu;
    valid += key != 0xFFFFFFFFu;
    s_keys[i] = (static_cast<u64>(key) << 32) | static_cast<unsigned>(i);
  }
  if (valid) atomicAdd(&s_tv, valid);
  __syncthreads();
  if (t <= kThreads) {
    if (threadIdx.x < t) {
      const u64 key = s_keys[threadIdx.x];
      int rank = 0;
      for (int i = 0; i < t; ++i) rank += s_keys[i] < key;
      s_perm[rank] = threadIdx.x;
      s_thr[thr_at(rank)] = key_value(key);
    }
  } else {
    for (int k = 2; k <= p2; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int i = threadIdx.x; i < p2; i += kThreads) {
          const int ixj = i ^ j;
          if (ixj > i) {
            const u64 a = s_keys[i], b = s_keys[ixj];
            if ((a > b) == ((i & k) == 0)) {
              s_keys[i] = b;
              s_keys[ixj] = a;
            }
          }
        }
        __syncthreads();
      }
    }
    for (int i = threadIdx.x; i < t; i += kThreads) {
      s_perm[i] = static_cast<int>(s_keys[i] & 0xFFFFFFFFull);
      s_thr[thr_at(i)] = key_value(s_keys[i]);
    }
  }
  __syncthreads();

  // 2. zero this tile's histogram (it overlays the keys, all read by now)
  //    and pad the table with NaN: the search reads below tv + P/2
  for (int i = t + threadIdx.x; i < t + p2 / 2; i += kThreads) s_thr[thr_at(i)] = __int_as_float(0x7FFFFFFF);
  const int tv = s_tv;
  const int top = tv ? 1 << (31 - __clz(tv)) : 0;  // steps top, top/2, ..., 1 reach any count <= tv
  unsigned* s_tgt = s_raw + ctile * bins;
  for (int i = threadIdx.x; i < 2 * ctile * bins; i += kThreads) s_raw[i] = 0u;
  __syncthreads();

  // 3. bucket every element once, the searches of a batch in lockstep, while
  //    the next batch loads
  for (long long i = threadIdx.x; i < items; i += U * kThreads) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      cl[u] = cln[u];
#pragma unroll
      for (int k = 0; k < V; ++k) x[u][k] = xn[u][k], y[u][k] = yn[u][k];
    }
    if (i + U * kThreads < items) load_batch(i + U * kThreads);
    int pos[U][V] = {};
    for (int step = top; step > 0; step >>= 1) {
      // all loads of a step first, then all selects: no branch, so that the
      // loads issue together. Entries from tv on are NaN, so the test needs
      // no bound; written `thr <= x`, it is also false for a NaN x, which
      // stays in bucket 0.
      float thr[U][V];
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int k = 0; k < V; ++k) thr[u][k] = s_thr[thr_at(pos[u][k] + step - 1)];
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int k = 0; k < V; ++k) pos[u][k] = thr[u][k] <= x[u][k] ? pos[u][k] + step : pos[u][k];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (cl[u] < 0) continue;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int bin = (cl[u] + k) * bins + pos[u][k];
        atomicAdd(s_raw + bin, 1u);
        if (y[u][k]) atomicAdd(s_tgt + bin, 1u);
      }
    }
  }
  __syncthreads();

  // 4. merge the row blocks of this class tile; the last one goes on with
  //    the merged bins copied back into its shared memory
  if (gridDim.x > 1) {
    u64* col = g_hist + static_cast<long long>(c0) * bins;
    for (int i = threadIdx.x; i < ctile * bins; i += kThreads) {
      const u64 val = s_raw[i] | static_cast<u64>(s_tgt[i]) << 32;
      if (val) atomicAdd(col + i, val);
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) s_last = atomicAdd(g_ticket + blockIdx.y, 1u) == gridDim.x - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    for (int i = threadIdx.x; i < ctile * bins; i += kThreads) {
      const u64 val = __ldcg(col + i);
      s_raw[i] = static_cast<unsigned>(val);
      s_tgt[i] = static_cast<unsigned>(val >> 32);
    }
    __syncthreads();
  }

  // 5. epilogue: per class, suffix sums over the bins, scattered back
  const int lane = threadIdx.x & 31;
  float* out_tp = out;
  float* out_fp = out + static_cast<long long>(c) * t;
  float* out_fn = out + 2LL * c * t;
  for (int cl = threadIdx.x >> 5; cl < ctile; cl += kThreads / 32) {
    // a bin as one word: the raw count low, the target count high
    auto bin = [&](int b) { return s_raw[cl * bins + b] | static_cast<u64>(s_tgt[cl * bins + b]) << 32; };
    u64 total = 0;
    for (int b = lane; b <= tv; b += 32) total += bin(b);
    const unsigned pos = static_cast<unsigned>(warp_sum(total) >> 32);
    const long long row = static_cast<long long>(c0 + cl) * t;
    u64 carry = 0;
    // bins tv, tv-1, ..., 1 in chunks of 32, lane 0 on the highest; the count
    // at sorted threshold j is the sum of the bins above j
    for (int hi = tv; hi >= 1; hi -= 32) {
      const int b = hi - lane;
      u64 s = b >= 1 ? bin(b) : 0ull;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const u64 o = __shfl_up_sync(kFull, s, off);
        if (lane >= off) s += o;
      }
      if (b >= 1) {
        const u64 incl = carry + s;
        const unsigned tp = static_cast<unsigned>(incl >> 32), cnt = static_cast<unsigned>(incl);
        const long long o = row + s_perm[b - 1];
        out_tp[o] = static_cast<float>(tp);
        out_fp[o] = static_cast<float>(cnt - tp);
        out_fn[o] = static_cast<float>(pos - tp);
      }
      carry += __shfl_sync(kFull, s, 31);
    }
    for (int j = tv + lane; j < t; j += 32) {  // NaN thresholds count nothing
      const long long o = row + s_perm[j];
      out_tp[o] = 0.0f;
      out_fp[o] = 0.0f;
      out_fn[o] = static_cast<float>(pos);
    }
  }
}

// ------------------------------------------------------------------ compare

constexpr int kCompareTile = 32;
constexpr int kRowsMax = 256;
constexpr int kThrPerThread = 4;

template <typename TT>
__global__ void __launch_bounds__(kThreads) binned_compare_kernel(
    const float* __restrict__ preds, const TT* __restrict__ target, const float* __restrict__ thresholds,
    long long n, int c, int t, int rows_per_block, int* __restrict__ tp, int* __restrict__ cnt,
    int* __restrict__ pos, unsigned* __restrict__ g_ticket, float* __restrict__ out) {
  __shared__ float s_pred[kRowsMax * kCompareTile];
  __shared__ unsigned char s_tgt[kRowsMax * kCompareTile];
  __shared__ bool s_last;

  const long long row0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const int c0 = blockIdx.y * kCompareTile;
  const int ctile = min(kCompareTile, c - c0);
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
        const int ge = x >= thr[k];  // false for a NaN pred or a NaN threshold
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

  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(g_ticket + blockIdx.y, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const volatile int* vtp = tp;
  const volatile int* vcnt = cnt;
  const volatile int* vpos = pos;
  for (int i = threadIdx.x; i < ctile * t; i += blockDim.x) {
    const int cl = i / t;
    const long long o = static_cast<long long>(c0 + cl) * t + (i - cl * t);
    const int tpv = vtp[o];
    out[o] = static_cast<float>(tpv);
    out[static_cast<long long>(c) * t + o] = static_cast<float>(vcnt[o] - tpv);
    out[2LL * c * t + o] = static_cast<float>(vpos[c0 + cl] - tpv);
  }
}

// -------------------------------------------------------------------- launch

int pow2_at_least(int t) {
  int p2 = 1;
  while (p2 < t) p2 <<= 1;
  return p2;
}

// The wrapper's ops/binned_stats.py::_hist_smem_bytes computes the same.
long long hist_smem_bytes(int t, int class_tile) {
  const long long words = static_cast<long long>(class_tile) * (t + 1);
  const int p2 = pow2_at_least(t);
  return 8LL * (words > p2 ? words : p2) + 4LL * t + 4LL * (thr_at(t + p2 / 2) + 1);
}

template <typename TT, int V>
int launch_hist(const void* preds, const void* target, const void* thresholds, long long n, int c, int t,
                int class_tile, int rows_per_block, void* scratch, void* out, cudaStream_t stream) {
  const unsigned row_blocks = static_cast<unsigned>((n + rows_per_block - 1) / rows_per_block);
  const unsigned class_tiles = static_cast<unsigned>((c + class_tile - 1) / class_tile);
  const long long smem = hist_smem_bytes(t, class_tile);
  auto kernel = binned_hist_kernel<TT, V>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  u64* g_hist = static_cast<u64*>(scratch);
  unsigned* g_ticket =
      row_blocks > 1 ? reinterpret_cast<unsigned*>(g_hist + static_cast<long long>(c) * (t + 1)) : nullptr;
  kernel<<<dim3(row_blocks, class_tiles), kThreads, static_cast<size_t>(smem), stream>>>(
      static_cast<const float*>(preds), static_cast<const TT*>(target), static_cast<const float*>(thresholds),
      n, c, t, class_tile, rows_per_block, g_hist, g_ticket, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename TT>
int launch_compare(const void* preds, const void* target, const void* thresholds, long long n, int c, int t,
                   int rows_per_block, void* scratch, void* out, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((n + rows_per_block - 1) / rows_per_block),
                  static_cast<unsigned>((c + kCompareTile - 1) / kCompareTile));
  int* tp = static_cast<int*>(scratch);
  int* cnt = tp + static_cast<long long>(c) * t;
  int* pos = cnt + static_cast<long long>(c) * t;
  unsigned* ticket = reinterpret_cast<unsigned*>(pos + c);
  binned_compare_kernel<TT><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(preds), static_cast<const TT*>(target), static_cast<const float*>(thresholds),
      n, c, t, rows_per_block, tp, cnt, pos, ticket, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename TT>
int launch(const void* preds, const void* target, const void* thresholds, long long n, int c, int t, int design,
           int class_tile, int rows_per_block, void* scratch, void* out, cudaStream_t stream) {
  if (design == 1) return launch_compare<TT>(preds, target, thresholds, n, c, t, rows_per_block, scratch, out, stream);
  const bool vec = c % 4 == 0 && class_tile % 4 == 0 && reinterpret_cast<unsigned long long>(preds) % 16 == 0 &&
                   reinterpret_cast<unsigned long long>(target) % 16 == 0;
  if (vec) return launch_hist<TT, 4>(preds, target, thresholds, n, c, t, class_tile, rows_per_block, scratch, out, stream);
  return launch_hist<TT, 1>(preds, target, thresholds, n, c, t, class_tile, rows_per_block, scratch, out, stream);
}

// Bytes of device scratch a launch needs (the wrapper sizes it the same way,
// ops/binned_stats.py::_scratch_bytes): the histogram design keeps uint64
// [C, T+1] bins and a uint32 ticket per class tile (nothing when the grid has
// one row block), the compare design int32 TP and cnt [C, T], pos [C] and a
// ticket per class tile.
long long scratch_bytes_needed(long long n, int c, int t, int design, int class_tile, int rows_per_block) {
  const long long row_blocks = (n + rows_per_block - 1) / rows_per_block;
  if (design == 1) {
    const long long tiles = (c + kCompareTile - 1) / kCompareTile;
    return 4LL * (2LL * c * t + c + tiles);
  }
  if (row_blocks <= 1) return 0;
  return 8LL * c * (t + 1) + 4LL * ((c + class_tile - 1) / class_tile);
}

}  // namespace

// target_kind: 0 float32, 1 int32, 2 int64. design: 0 histogram, 1 compare
// (class_tile must then be 32 and rows_per_block at most 256). scratch holds
// at least scratch_bytes_needed(...) bytes (it is zeroed here, on
// `stream`); out is float32 [3, C, T]. All pointers are device pointers of
// contiguous tensors. Returns the cudaError_t of the memset or the launch (0
// on success). Launches on `stream` and does not synchronize.
extern "C" int binned_stats_launch(const void* preds, const void* target, int target_kind, const void* thresholds,
                                   long long n, int c, int t, int design, int class_tile, int rows_per_block,
                                   void* scratch, long long scratch_bytes, void* out, void* stream) {
  if (n <= 0 || c <= 0 || t <= 0 || rows_per_block <= 0 || class_tile <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (design == 1 ? (class_tile != kCompareTile || rows_per_block > kRowsMax) : design != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long need = scratch_bytes_needed(n, c, t, design, class_tile, rows_per_block);
  if (scratch_bytes < need || (need > 0 && scratch == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (need > 0) {
    const cudaError_t e = cudaMemsetAsync(scratch, 0, static_cast<size_t>(need), s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  switch (target_kind) {
    case 0: return launch<float>(preds, target, thresholds, n, c, t, design, class_tile, rows_per_block, scratch, out, s);
    case 1: return launch<int>(preds, target, thresholds, n, c, t, design, class_tile, rows_per_block, scratch, out, s);
    case 2:
      return launch<long long>(preds, target, thresholds, n, c, t, design, class_tile, rows_per_block, scratch, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
