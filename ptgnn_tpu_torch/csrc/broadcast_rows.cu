// Receiver broadcast: out[e] = table[tile_row_blocks[e / tile] * R + local_rows[e]],
// with 0 at sentinel slots (local_rows[e] outside [0, R)) and at rows past the
// table, in the table's own element type (any: the kernel moves bytes).
//
// Replaces ptgnn_tpu/ops/pallas/segment_kernels.py::_broadcast_kernel (the
// one-hot-matmul row selection launched by planned_broadcast_to_edges). The
// TPU kernel keeps one row block's [R, D] rows resident while its sequential
// grid walks the block's tiles and writes each [tile, D] output tile once.
//
// Bound: bytes. The work is a copy: the least time is the receivers' table
// rows, the slot and tile indices read once and the [num_slots, D] rows
// written once, over the memory rate. The rows written dominate; a row
// block's table rows are reused by all its slots and stay in L2.
//
// Design. Each warp copies a chunk of consecutive slots, about 4 KB of
// output rows (a power of two of slots, at most 32; fewer in a launch that
// would leave the card with fewer than 16 warps an SM, as long as a warp
// still has a unit for each lane). Its index work is done once per slot,
// not once per 16 bytes: lane s loads slot s's local row and its tile's row
// block (two independent loads; one 32-bit division per slot, none per
// element) and forms the source row, or -1 for a zero row. A chunk of zero
// rows (the padding of a sparse layout such as a node shard's boundary) is
// stored at once. Otherwise every lane takes its units of the chunk's rows
// (neighbouring lanes on neighbouring addresses), reads each one's source
// row from its owner lane with a shuffle, issues all its table loads (up to
// 8 independent 16-byte loads in flight per lane) and then stores them. No
// shared memory and no block barrier: each warp runs its chain (indices,
// table rows, stores) on its own, so the card's warps overlap one another's
// latency, and the grid covers the chunks in one launch sized to the work.
//  * Rows of whole 16-byte vectors, table and output 16-byte aligned, move
//    as 16-byte vectors; the vectors in a row are a template parameter at
//    the widths in use (8-96), and one instance takes any other count.
//  * Any other row (a width that is not a whole number of 16-byte vectors,
//    such as a mean's g | counts table, or a misaligned table view) moves in
//    the widest unit (8, 4, 2 or 1 bytes) that divides the row and both
//    addresses. No padded copy of the table.
// Tried on the card and dropped (PERF.md): shared-memory stages filled by
// cp.async and written by one TMA bulk store each, in persistent blocks (no
// faster at any main-path width, a higher launch floor); a lane's loads
// issued 2 or 4 at a time; 2 KB and 8 KB chunks. Nothing is allocated and no
// scratch is kept: the launch is capturable in a CUDA graph, on the
// caller's stream.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunkBytes = 4096;  // output rows a warp copies, about
constexpr int kInFlight = 8;       // units a lane loads before it stores

struct Args {
  const int* local_rows;
  const int* tile_row_blocks;
  int num_slots;
  int tile;
  int rows_per_block;
  int n_rows;
};

int sm_count() {
  static int counts[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (counts[dev] == 0 && cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 132;
  return counts[dev];
}

// Slots a warp copies: about kChunkBytes of rows, fewer where that leaves
// the card with fewer than 16 warps an SM (a short launch then spreads over
// more warps, which shortens its chain of latencies) while a warp keeps at
// least 32 units.
int slots_per_warp(int num_slots, long long row_bytes, int units) {
  int s = 1;
  while (s < 32 && 2 * s * row_bytes <= kChunkBytes) s *= 2;
  const long long min_warps = 16LL * sm_count();
  while (s > 1 && 2LL * s * units > 64 && (static_cast<long long>(num_slots) + s - 1) / s < min_warps) s /= 2;
  return s;
}

// Source row of slot `e`, or -1: a sentinel slot or a row past the table.
__device__ __forceinline__ int source_row(const Args& a, int e) {
  const int lr = __ldg(a.local_rows + e);
  const long long row = static_cast<long long>(__ldg(a.tile_row_blocks + e / a.tile)) * a.rows_per_block + lr;
  return (lr >= 0 && lr < a.rows_per_block && row >= 0 && row < a.n_rows) ? static_cast<int>(row) : -1;
}

// T: the unit moved; N: units per row (0: `units` at run time).
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
broadcast_rows_kernel(const T* __restrict__ table, Args a, T* __restrict__ out, int units, int slots) {
  if (N > 0) units = N;
  const int lane = threadIdx.x & 31;
  const long long first = (static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32) * slots;
  if (first >= a.num_slots) return;  // the whole warp
  const int slot0 = static_cast<int>(first);
  const int count = min(slots, a.num_slots - slot0);
  const int src = lane < count ? source_row(a, slot0 + lane) : -1;
  const int n = count * units;
  T* dst = out + static_cast<size_t>(slot0) * units;
  if (__all_sync(0xffffffffu, src < 0)) {  // a chunk of zero rows
    for (int v = lane; v < n; v += 32) dst[v] = T{};
    return;
  }
  for (int base = 0; base < n; base += 32 * kInFlight) {
    T r[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int v = base + u * 32 + lane;
      const int s = v / units;
      const int row = __shfl_sync(0xffffffffu, src, s & 31);
      r[u] = T{};
      if (v < n && row >= 0) r[u] = __ldg(table + static_cast<size_t>(row) * units + (v - s * units));
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int v = base + u * 32 + lane;
      if (v < n) dst[v] = r[u];
    }
  }
}

template <typename T, int N>
int launch(const void* table, const Args& a, void* out, int units, cudaStream_t stream) {
  const int slots = slots_per_warp(a.num_slots, static_cast<long long>(units) * sizeof(T), units);
  const long long chunks = (static_cast<long long>(a.num_slots) + slots - 1) / slots;
  const long long grid = (chunks + kWarps - 1) / kWarps;
  broadcast_rows_kernel<T, N><<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
      static_cast<const T*>(table), a, static_cast<T*>(out), units, slots);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* ptgnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// table: [n_rows, row_bytes] of any element type, rows contiguous; out:
// [num_slots, row_bytes]; local_rows: [num_slots] int32; tile_row_blocks:
// [num_slots / tile] int32. Slots and rows are counted in 32 bits. Returns
// cudaGetLastError() after the launch (0 = success).
extern "C" int ptgnn_broadcast_rows(const void* table, const void* local_rows, const void* tile_row_blocks,
                                    void* out, long long num_slots, int row_bytes, int tile, int rows_per_block,
                                    long long n_rows, void* stream) {
  if (row_bytes < 0 || tile <= 0 || rows_per_block <= 0 || num_slots < 0 || num_slots % tile != 0 ||
      num_slots > 2147483647LL || n_rows < 0 || n_rows > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_slots == 0 || row_bytes == 0) return static_cast<int>(cudaSuccess);
  Args a;
  a.local_rows = static_cast<const int*>(local_rows);
  a.tile_row_blocks = static_cast<const int*>(tile_row_blocks);
  a.num_slots = static_cast<int>(num_slots);
  a.tile = tile;
  a.rows_per_block = rows_per_block;
  a.n_rows = static_cast<int>(n_rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t aligned = reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(out) |
                            static_cast<uintptr_t>(row_bytes);
  if (aligned % 16 == 0) {
    const int vecs = row_bytes / 16;
    switch (vecs) {
      case 8: return launch<uint4, 8>(table, a, out, vecs, s);
      case 16: return launch<uint4, 16>(table, a, out, vecs, s);
      case 24: return launch<uint4, 24>(table, a, out, vecs, s);
      case 32: return launch<uint4, 32>(table, a, out, vecs, s);
      case 48: return launch<uint4, 48>(table, a, out, vecs, s);
      case 64: return launch<uint4, 64>(table, a, out, vecs, s);
      case 96: return launch<uint4, 96>(table, a, out, vecs, s);
      default: return launch<uint4, 0>(table, a, out, vecs, s);
    }
  }
  if (aligned % 8 == 0) return launch<uint2, 0>(table, a, out, row_bytes / 8, s);
  if (aligned % 4 == 0) return launch<unsigned, 0>(table, a, out, row_bytes / 4, s);
  if (aligned % 2 == 0) return launch<unsigned short, 0>(table, a, out, row_bytes / 2, s);
  return launch<unsigned char, 0>(table, a, out, row_bytes, s);
}
