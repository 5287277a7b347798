// Row-indexed segmented reductions over the batch's edge slots: the shared
// body of segment_extremum.cu (max/min), segment_sum.cu (sum) and
// segment_extremum_argmax.cu (max/min with the first winning slot).
//
// Input. data [e_pad, m] float32 or bfloat16 in slot order; the plan's row
// index: row_offsets [n_plan_rows + 1] and row_slots [e_pad] (the real slots
// of row g are row_slots[row_offsets[g] : row_offsets[g + 1]], in increasing
// slot order; graph/batching.py builds it once per batch). local_rows and
// tile_row_blocks give the row of a slot (tile_row_blocks[e / tile] * r +
// local_rows[e]), which the split of long rows needs.
//
// Work. A group of g lanes (g = 1 .. 32, a power of two) owns one (row,
// column chunk) pair; each lane holds V = 4 columns (one 16-byte float32 or
// 8-byte bf16 load) or, where the width or the alignment forbids, V = 1.
// The group walks its row's slot list in batches of kBatch slots whose loads
// are all issued before any is folded, and folds in float32 registers: no
// shared memory, no barrier. Each (row, column) is folded by one lane, in
// increasing slot order. ArgMax/ArgMin carry the slot of the running value
// beside it and replace it only on a strict compare, so the first
// occurrence wins, -0.0 and +0.0 keep the earlier slot, and NaN never wins.
//
// Long rows. A row of more than `chunk` slots is cut at the multiples of
// `chunk` in the slot-list positions: its owner group folds the head piece
// (from the row's first position to the next multiple), and window group w
// folds the body piece that starts at position w * chunk, for the row that
// holds that position. Each piece writes a float32 partial (and, for the
// argmax ops, an int32 slot partial) (head pieces to partials[window of the
// row's start], body pieces to partials[n_windows + w]; no two pieces share
// one) and takes a ticket from the (row, column chunk)'s counter; the piece
// that takes the last ticket folds the partials in piece order (a strict
// compare for the argmax ops, so an earlier piece wins a tie), writes the
// row and sets the counter back to 0, so the counters are 0 between
// launches. Rows of at most `chunk` slots never touch the partials or the
// counters.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace row_reduce {

constexpr int kThreads = 256;
constexpr int kBatch = 8;  // slots whose loads one lane keeps in flight

// kExtremum: the extremum's output rule applies (see emit). kArg: the op
// carries the slot of its value (wins(x, v): x replaces v).
struct Max {
  static constexpr float kInit = -3.0e38f;
  static constexpr bool kExtremum = true;
  static constexpr bool kArg = false;
  __device__ static float fold(float a, float b) { return fmaxf(a, b); }
};
struct Min {
  static constexpr float kInit = 3.0e38f;
  static constexpr bool kExtremum = true;
  static constexpr bool kArg = false;
  __device__ static float fold(float a, float b) { return fminf(a, b); }
};
struct Sum {
  static constexpr float kInit = 0.0f;
  static constexpr bool kExtremum = false;
  static constexpr bool kArg = false;
  __device__ static float fold(float a, float b) { return __fadd_rn(a, b); }
};
struct ArgMax {
  static constexpr float kInit = -3.0e38f;
  static constexpr bool kExtremum = true;
  static constexpr bool kArg = true;
  __device__ static bool wins(float x, float v) { return x > v; }
};
struct ArgMin {
  static constexpr float kInit = 3.0e38f;
  static constexpr bool kExtremum = true;
  static constexpr bool kArg = true;
  __device__ static bool wins(float x, float v) { return x < v; }
};

template <int V>
struct Vec {
  float v[V];
};

// A lane's running result: V values and, for the argmax ops, their slots.
template <class Op, int V>
struct Acc {
  Vec<V> val;
  int slot[Op::kArg ? V : 1];
};

template <class Op, int V>
__device__ __forceinline__ Vec<V> init() {
  Vec<V> x;
#pragma unroll
  for (int k = 0; k < V; ++k) x.v[k] = Op::kInit;
  return x;
}

template <class Op, int V>
__device__ __forceinline__ Acc<Op, V> init_acc() {
  Acc<Op, V> acc;
  acc.val = init<Op, V>();
#pragma unroll
  for (int k = 0; k < (Op::kArg ? V : 1); ++k) acc.slot[k] = -1;
  return acc;
}

// Folds x (from `slot`, for the argmax ops) into acc; also combines a later
// piece's partial into an earlier one's.
template <class Op, int V>
__device__ __forceinline__ void fold(Acc<Op, V>& acc, const Vec<V>& x, const int* slot) {
#pragma unroll
  for (int k = 0; k < V; ++k) {
    if constexpr (Op::kArg) {
      if (Op::wins(x.v[k], acc.val.v[k])) {
        acc.val.v[k] = x.v[k];
        acc.slot[k] = slot[k];
      }
    } else {
      acc.val.v[k] = Op::fold(acc.val.v[k], x.v[k]);
    }
  }
}

__device__ __forceinline__ float bf16_bits_to_float(unsigned bits) { return __uint_as_float(bits << 16); }

template <typename T, int V>
__device__ __forceinline__ Vec<V> load(const T* __restrict__ p);

template <>
__device__ __forceinline__ Vec<4> load<float, 4>(const float* __restrict__ p) {
  const float4 f = __ldg(reinterpret_cast<const float4*>(p));
  return Vec<4>{{f.x, f.y, f.z, f.w}};
}

template <>
__device__ __forceinline__ Vec<4> load<__nv_bfloat16, 4>(const __nv_bfloat16* __restrict__ p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return Vec<4>{{bf16_bits_to_float(u.x & 0xffffu), bf16_bits_to_float(u.x >> 16),
                 bf16_bits_to_float(u.y & 0xffffu), bf16_bits_to_float(u.y >> 16)}};
}

template <>
__device__ __forceinline__ Vec<1> load<float, 1>(const float* __restrict__ p) {
  return Vec<1>{{__ldg(p)}};
}

template <>
__device__ __forceinline__ Vec<1> load<__nv_bfloat16, 1>(const __nv_bfloat16* __restrict__ p) {
  return Vec<1>{{__bfloat162float(*p)}};
}

template <int V>
__device__ __forceinline__ void store(float* p, const Vec<V>& x) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x.v[0], x.v[1], x.v[2], x.v[3]);
  } else {
    *p = x.v[0];
  }
}

template <int V>
__device__ __forceinline__ void store_slots(int* p, const int* s) {
  if constexpr (V == 4) {
    *reinterpret_cast<int4*>(p) = make_int4(s[0], s[1], s[2], s[3]);
  } else {
    *p = s[0];
  }
}

// The partials are written and read by different CTAs of one launch: both
// go through L2 (L1 is not coherent between SMs).
template <int V>
__device__ __forceinline__ void store_l2(float* p, const Vec<V>& x) {
  if constexpr (V == 4) {
    __stcg(reinterpret_cast<float4*>(p), make_float4(x.v[0], x.v[1], x.v[2], x.v[3]));
  } else {
    __stcg(p, x.v[0]);
  }
}

template <int V>
__device__ __forceinline__ Vec<V> load_l2(const float* p) {
  if constexpr (V == 4) {
    const float4 f = __ldcg(reinterpret_cast<const float4*>(p));
    return Vec<4>{{f.x, f.y, f.z, f.w}};
  } else {
    return Vec<1>{{__ldcg(p)}};
  }
}

template <int V>
__device__ __forceinline__ void store_slots_l2(int* p, const int* s) {
  if constexpr (V == 4) {
    __stcg(reinterpret_cast<int4*>(p), make_int4(s[0], s[1], s[2], s[3]));
  } else {
    __stcg(p, s[0]);
  }
}

template <int V>
__device__ __forceinline__ void load_slots_l2(int* s, const int* p) {
  if constexpr (V == 4) {
    const int4 v = __ldcg(reinterpret_cast<const int4*>(p));
    s[0] = v.x, s[1] = v.y, s[2] = v.z, s[3] = v.w;
  } else {
    s[0] = __ldcg(p);
  }
}

// Folds data rows row_slots[begin:end) into acc, in position order.
template <class Op, typename T, int V>
__device__ __forceinline__ void walk(Acc<Op, V>& acc, const T* __restrict__ data,
                                     const int* __restrict__ row_slots, long long begin,
                                     long long end, int m, int col, bool active) {
  for (long long i = begin; i < end; i += kBatch) {
    int slot[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) slot[j] = i + j < end ? __ldg(row_slots + i + j) : -1;
    Vec<V> x[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      x[j] = (active && slot[j] >= 0) ? load<T, V>(data + (long long)slot[j] * m + col) : init<Op, V>();
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (slot[j] >= 0) {
        int slots[V];
#pragma unroll
        for (int k = 0; k < V; ++k) slots[k] = slot[j];
        fold<Op, V>(acc, x[j], slots);
      }
    }
  }
}

struct Args {
  const void* data;
  const int* row_offsets;
  const int* row_slots;
  const int* local_rows;
  const int* tile_row_blocks;
  const int* agg_counts;  // read by the extremum only
  float* out;             // [n_rows, m]
  int* out_slots;         // [n_rows, m], the argmax ops only
  float* partials;        // [2 * n_windows, m]
  int* partial_slots;     // [2 * n_windows, m], the argmax ops only
  unsigned* counters;     // [n_rows * column chunks], 0 between launches
  long long n_rows, e_pad;
  int tile, r, m, chunk;
};

// Writes a row's result with the extremum's output rule: rows whose count
// is 0 or whose value is degenerate (|v| >= 1.5e38) read 0 (and slot -1),
// and + 0.0f turns -0.0 into +0.0. The sum has none.
template <class Op, int V>
__device__ __forceinline__ void emit(Acc<Op, V> acc, const Args& a, long long row, int col) {
  if constexpr (Op::kExtremum) {
    const bool empty_row = __ldg(a.agg_counts + row) == 0;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const bool invalid = empty_row || fabsf(acc.val.v[k]) >= 1.5e38f;
      acc.val.v[k] = invalid ? 0.0f : __fadd_rn(acc.val.v[k], 0.0f);
      if constexpr (Op::kArg) acc.slot[k] = invalid ? -1 : acc.slot[k];
    }
  }
  store<V>(a.out + row * a.m + col, acc.val);
  if constexpr (Op::kArg) store_slots<V>(a.out_slots + row * a.m + col, acc.slot);
}

template <class Op, typename T, int V>
__device__ __forceinline__ void row_reduce(const Args& a, int group_log2, int col_chunks) {
  const T* __restrict__ data = static_cast<const T*>(a.data);
  const int g = 1 << group_log2;
  const int lane = threadIdx.x & (g - 1);
  const unsigned group_mask =
      g == 32 ? 0xffffffffu : ((1u << g) - 1u) << ((threadIdx.x & 31) & ~(g - 1));
  const long long item = (long long)blockIdx.x * (kThreads >> group_log2) + (threadIdx.x >> group_log2);
  const int c = (int)(item % col_chunks);
  const int col = (c * g + lane) * V;
  const bool active = col < a.m;
  const long long owner_items = a.n_rows * col_chunks;
  const long long n_windows = (a.e_pad + a.chunk - 1) / a.chunk;

  long long row, start, count, begin, end, piece;
  if (item < owner_items) {
    row = item / col_chunks;
    start = __ldg(a.row_offsets + row);
    count = __ldg(a.row_offsets + row + 1) - start;
    Acc<Op, V> acc = init_acc<Op, V>();
    if (count <= a.chunk) {  // the whole row: every row on a batch of bounded degree
      walk<Op, T, V>(acc, data, a.row_slots, start, start + count, a.m, col, active);
      if (active) emit<Op, V>(acc, a, row, col);
      return;
    }
    begin = start;
    end = (start / a.chunk + 1) * a.chunk;
    piece = start / a.chunk;
  } else {
    const long long w = (item - owner_items) / col_chunks;
    if (w >= n_windows) return;
    begin = w * a.chunk;
    const int slot = __ldg(a.row_slots + begin);
    if (slot < 0) return;  // past the real slots
    row = (long long)__ldg(a.tile_row_blocks + slot / a.tile) * a.r + __ldg(a.local_rows + slot);
    if (row >= a.n_rows) return;
    start = __ldg(a.row_offsets + row);
    count = __ldg(a.row_offsets + row + 1) - start;
    if (count <= a.chunk || start == begin) return;  // no body piece starts here
    end = begin + a.chunk < start + count ? begin + a.chunk : start + count;
    piece = n_windows + w;
  }

  // One piece of a long row: its partial, then the ticket.
  Acc<Op, V> acc = init_acc<Op, V>();
  walk<Op, T, V>(acc, data, a.row_slots, begin, end, a.m, col, active);
  if (active) {
    store_l2<V>(a.partials + piece * a.m + col, acc.val);
    if constexpr (Op::kArg) store_slots_l2<V>(a.partial_slots + piece * a.m + col, acc.slot);
  }
  __threadfence();
  __syncwarp(group_mask);
  unsigned* counter = a.counters + row * col_chunks + c;
  unsigned ticket = 0;
  if (lane == 0) ticket = atomicAdd(counter, 1u);
  ticket = __shfl_sync(group_mask, ticket, 0, g);
  const long long first = start / a.chunk;
  const long long last = (start + count - 1) / a.chunk;
  if (ticket != (unsigned)(last - first)) return;  // not the last piece
  __threadfence();
  if (active) {
    Acc<Op, V> total;
    total.val = load_l2<V>(a.partials + first * a.m + col);
    if constexpr (Op::kArg) load_slots_l2<V>(total.slot, a.partial_slots + first * a.m + col);
    for (long long w = first + 1; w <= last; ++w) {
      const long long p = (n_windows + w) * a.m + col;
      int slots[V];
      if constexpr (Op::kArg) load_slots_l2<V>(slots, a.partial_slots + p);
      fold<Op, V>(total, load_l2<V>(a.partials + p), slots);
    }
    emit<Op, V>(total, a, row, col);
  }
  if (lane == 0) *counter = 0u;
}

// Launch geometry: V, the group size and the column chunks of a width.
struct Geometry {
  int v, group_log2, col_chunks;
};

inline Geometry geometry(const Args& a, size_t elem_bytes) {
  Geometry geo;
  const bool vec = a.m % 4 == 0 && reinterpret_cast<uintptr_t>(a.data) % (4 * elem_bytes) == 0;
  geo.v = vec ? 4 : 1;
  const int cols = a.m < 32 * geo.v ? a.m : 32 * geo.v;
  const int lanes = (cols + geo.v - 1) / geo.v;
  geo.group_log2 = 0;
  while ((1 << geo.group_log2) < lanes) ++geo.group_log2;
  const int span = (1 << geo.group_log2) * geo.v;
  geo.col_chunks = (a.m + span - 1) / span;
  return geo;
}

// Checks the arguments and the scratch capacities, then launches
// kernel<T, V> (a thin __global__ wrapper of row_reduce<Op, T, V>).
template <class Launch>
int launch(const Args& a, int dtype, long long partial_capacity, long long counter_capacity,
           cudaStream_t stream, Launch&& kernel) {
  if ((dtype != 0 && dtype != 1) || a.m <= 0 || a.chunk <= 0 || a.tile <= 0 || a.r <= 0 ||
      a.n_rows < 0 || a.e_pad < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry geo = geometry(a, dtype == 0 ? 4 : 2);
  const long long n_windows = (a.e_pad + a.chunk - 1) / a.chunk;
  if (partial_capacity < 2 * n_windows * a.m || counter_capacity < a.n_rows * geo.col_chunks)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long items = (a.n_rows + n_windows) * geo.col_chunks;
  const long long per_block = kThreads >> geo.group_log2;
  const long long blocks = (items + per_block - 1) / per_block;
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel(dtype, geo, (unsigned)blocks, stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace row_reduce
