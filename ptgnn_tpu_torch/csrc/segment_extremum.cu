// Segment max/min over the batch's receiver-blocked, type-pure edge tiles.
//
// Replaces ptgnn_tpu/ops/pallas/segment_kernels.py::_extremum_kernel
// (launched by _run_kernel for planned_segment_extremum).
//
// Semantics: out[g] = max (or min) over the slots e with
// tile_row_blocks[e / tile] * R + local_rows[e] == g of data[e], accumulated
// in float32 from an initial +-3e38; sentinel slots (local_rows == R) are
// skipped. Rows with agg_counts[g] == 0 or |out| >= 1.5e38 become 0 (the
// torch-scatter empty-segment fill), and every value gets + 0.0f so -0.0
// reads as +0.0, which the TPU kernel's selection matmul also produces.
//
// Bound: bytes. One comparison per input element is far below the card's
// arithmetic rate; the least time is the edge data read once plus the
// [N, M] float32 output written once.
//
// Design. The TPU kernel keeps one row block's [R, M] output resident while
// its sequential grid walks the block's tiles; Hopper blocks share no such
// carry, so each CTA owns one row block: its tile range [start[b],
// start[b + 1]) comes from the non-decreasing tile_row_blocks (the wrapper's
// searchsorted), and its float32 accumulator lives in shared memory (R*M*4
// bytes: 64 KB at M = 64, 128 KB at M = 128, opted in above 48 KB). Inside a
// tile the receivers are sorted, so each receiver is one contiguous run:
// the CTA compacts the run starts with a ballot scan, then its threads
// split (run, column) pairs and fold each run into acc[row] with no
// conflicts; consecutive threads take consecutive columns, so the loads of
// one slot's row are coalesced. Tiles are walked in order with a barrier
// between them, since one receiver's edges span several type tiles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSharedBytes = 232448;  // the opt-in limit of one block on sm_90

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, bool kMax>
__global__ void __launch_bounds__(kThreads)
segment_extremum_kernel(const T* __restrict__ data, const int* __restrict__ local_rows,
                        const long long* __restrict__ block_tile_start,
                        const int* __restrict__ agg_counts, float* __restrict__ out,
                        long long n_rows, int tile, int r, int m) {
  extern __shared__ float smem[];
  float* acc = smem;                                   // [r * m]
  int* rows = reinterpret_cast<int*>(acc + (size_t)r * m);  // [tile]
  int* runs = rows + tile;                             // [tile] run starts
  int* warp_base = runs + tile;                        // [kWarps + 1]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float neutral = kMax ? -3.0e38f : 3.0e38f;

  for (int i = tid; i < r * m; i += kThreads) acc[i] = neutral;

  const long long t0 = block_tile_start[blockIdx.x];
  const long long t1 = block_tile_start[blockIdx.x + 1];
  for (long long t = t0; t < t1; ++t) {
    const long long e0 = t * tile;
    __syncthreads();  // the previous tile's folds are done with rows/runs
    int row = r;
    if (tid < tile) {
      row = local_rows[e0 + tid];
      rows[tid] = row;
    }
    __syncthreads();
    const bool start = tid < tile && row >= 0 && row < r && (tid == 0 || rows[tid - 1] != row);
    const unsigned ballot = __ballot_sync(0xffffffffu, start);
    if (lane == 0) warp_base[warp] = __popc(ballot);
    __syncthreads();
    if (tid == 0) {
      int s = 0;
      for (int w = 0; w < kWarps; ++w) {
        const int c = warp_base[w];
        warp_base[w] = s;
        s += c;
      }
      warp_base[kWarps] = s;
    }
    __syncthreads();
    if (start) runs[warp_base[warp] + __popc(ballot & ((1u << lane) - 1u))] = tid;
    __syncthreads();
    const int pairs = warp_base[kWarps] * m;
    for (int k = tid; k < pairs; k += kThreads) {
      const int ri = k / m;
      const int c = k - ri * m;
      const int s = runs[ri];
      const int run_row = rows[s];
      float v = acc[run_row * m + c];
      for (int q = s; q < tile && rows[q] == run_row; ++q) {
        const float x = to_float(data[(e0 + q) * m + c]);
        v = kMax ? fmaxf(v, x) : fminf(v, x);
      }
      acc[run_row * m + c] = v;
    }
  }
  __syncthreads();
  for (int i = tid; i < r * m; i += kThreads) {
    const int lr = i / m;
    const long long g = (long long)blockIdx.x * r + lr;
    if (g >= n_rows) continue;
    const float v = acc[i];
    const bool empty = agg_counts[g] == 0 || fabsf(v) >= 1.5e38f;
    out[g * m + (i - lr * m)] = empty ? 0.0f : __fadd_rn(v, 0.0f);
  }
}

template <typename T, bool kMax>
int launch(const void* data, const void* local_rows, const void* block_tile_start,
           const void* agg_counts, void* out, long long n_rows, int num_blocks, int tile,
           int r, int m, cudaStream_t stream) {
  const size_t smem = (size_t)r * m * sizeof(float) + 2 * (size_t)tile * sizeof(int) +
                      (kWarps + 1) * sizeof(int);
  if (tile <= 0 || tile > kThreads || r <= 0 || m <= 0 || smem > (size_t)kMaxSharedBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  // Opt in once per instantiation, before any stream capture can begin.
  static const cudaError_t configured = cudaFuncSetAttribute(
      segment_extremum_kernel<T, kMax>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSharedBytes);
  if (configured != cudaSuccess) return static_cast<int>(configured);
  if (num_blocks == 0) return static_cast<int>(cudaSuccess);
  segment_extremum_kernel<T, kMax><<<num_blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(data), static_cast<const int*>(local_rows),
      static_cast<const long long*>(block_tile_start), static_cast<const int*>(agg_counts),
      static_cast<float*>(out), n_rows, tile, r, m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* ptgnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16. data: [num_tiles * tile, m]; out: [n_rows, m]
// float32; block_tile_start: [num_blocks + 1] int64; agg_counts: [num_blocks * r] int32.
// Returns cudaGetLastError() after the launch (0 = success).
extern "C" int ptgnn_segment_extremum(const void* data, int dtype, int is_max,
                                      const void* local_rows, const void* block_tile_start,
                                      const void* agg_counts, void* out, long long n_rows,
                                      int num_blocks, int tile, int r, int m, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return is_max ? launch<float, true>(data, local_rows, block_tile_start, agg_counts, out,
                                        n_rows, num_blocks, tile, r, m, s)
                  : launch<float, false>(data, local_rows, block_tile_start, agg_counts, out,
                                         n_rows, num_blocks, tile, r, m, s);
  }
  if (dtype == 1) {
    return is_max ? launch<__nv_bfloat16, true>(data, local_rows, block_tile_start, agg_counts,
                                                out, n_rows, num_blocks, tile, r, m, s)
                  : launch<__nv_bfloat16, false>(data, local_rows, block_tile_start,
                                                 agg_counts, out, n_rows, num_blocks, tile, r,
                                                 m, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
