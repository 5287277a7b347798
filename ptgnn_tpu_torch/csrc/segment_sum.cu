// Segment sum over the batch's receiver-blocked edge layout.
//
// Replaces ptgnn_tpu/ops/pallas/segment_kernels.py::_sum_kernel (launched by
// _run_kernel for planned_segment_sum): acc[R, D] += onehot(local_rows)^T . tile
// per row block, in float32.
//
// Semantics: out[g, c] = the float32 sum of data[e, c] over the slots e with
// tile_row_blocks[e / tile] * R + local_rows[e] == g. Sentinel slots (local_rows
// outside [0, R)) add nothing. Every row g < n_rows is written: 0 where no slot
// maps to it. f32 or bf16 input; the sum is always taken in float32.
//
// Bound: bytes. One add per input element is far below the card's arithmetic
// rate; the least time is the real slots' data and the slot rows read once
// plus the [n_rows, D] float32 output written once.
//
// Design. The TPU kernel walks all tiles in one sequential grid and keeps a
// row block's [R, D] sum resident while it walks the block's tiles. On Hopper
// one CTA per row block would leave most SMs idle (the bench layout has 32
// row blocks), so the work is split three ways: CTA (b, k, s) takes row
// block b, the 32 columns [32k, 32k + 32), and part s of the block's tile
// range. Its [R, 32] float32 sum lives in shared memory (32 KB at R = 256).
// Lane l of every warp owns column 32k + l, and warp w owns the rows
// r = w (mod 8): a warp walks the part's slots in order, 32 at a time, picks
// the slots whose row it owns with a ballot, and adds each such slot's
// 32-column segment (one coalesced load) to its rows. So each output element
// is summed by one thread, in slot order, with no atomics, and the result is
// the same bits on every run. When the tile range is split (splits > 1),
// each part writes a float32 partial [n_rows, D] and a second kernel adds
// the partials in part order, which is deterministic too.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 32;  // columns per CTA: one per lane
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSharedBytes = 232448;  // the opt-in limit of one block on sm_90

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// First index i in [0, n) with a[i] >= key (a is non-decreasing).
__device__ __forceinline__ long long lower_bound(const int* __restrict__ a, long long n, int key) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (__ldg(a + mid) < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const T* __restrict__ data, const int* __restrict__ local_rows,
                   const int* __restrict__ tile_row_blocks, long long num_tiles,
                   float* __restrict__ dst, long long n_rows, int tile, int r, int d) {
  extern __shared__ float acc[];  // [r, kCols]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x;
  const int col = blockIdx.y * kCols + lane;
  const long long splits = gridDim.z;
  const long long s = blockIdx.z;

  for (int i = threadIdx.x; i < r * kCols; i += kThreads) acc[i] = 0.0f;
  const long long t0 = lower_bound(tile_row_blocks, num_tiles, b);
  const long long nt = lower_bound(tile_row_blocks, num_tiles, b + 1) - t0;
  const long long e_begin = (t0 + nt * s / splits) * tile;
  const long long e_end = (t0 + nt * (s + 1) / splits) * tile;
  __syncthreads();

  for (long long e0 = e_begin; e0 < e_end; e0 += 32) {
    const int row = e0 + lane < e_end ? __ldg(local_rows + e0 + lane) : -1;
    unsigned todo = __ballot_sync(0xffffffffu, row >= 0 && row < r && row % kWarps == warp);
    while (todo) {  // warp-uniform
      const int j = __ffs(todo) - 1;
      todo &= todo - 1;
      const int rj = __shfl_sync(0xffffffffu, row, j);
      if (col < d) acc[rj * kCols + lane] += to_float(data[(e0 + j) * d + col]);
    }
  }
  __syncthreads();

  float* part = dst + s * n_rows * d;
  for (int i = threadIdx.x; i < r * kCols; i += kThreads) {
    const int lr = i / kCols;
    const int c = blockIdx.y * kCols + (i - lr * kCols);
    const long long g = (long long)b * r + lr;
    if (g < n_rows && c < d) part[g * d + c] = acc[i];
  }
}

__global__ void combine_partials_kernel(const float* __restrict__ partial, float* __restrict__ out,
                                        long long count, int splits) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < count; i += stride) {
    float v = partial[i];
    for (int s = 1; s < splits; ++s) v += partial[s * count + i];
    out[i] = v;
  }
}

template <typename T>
int launch(const void* data, const void* local_rows, const void* tile_row_blocks,
           long long num_tiles, void* partial, void* out, long long n_rows, int num_blocks,
           int tile, int r, int d, int splits, cudaStream_t stream) {
  const size_t smem = (size_t)r * kCols * sizeof(float);
  if (tile <= 0 || r <= 0 || d <= 0 || splits <= 0 || splits > 65535 ||
      smem > (size_t)kMaxSharedBytes || (splits > 1 && partial == nullptr) ||
      n_rows > (long long)num_blocks * r)
    return static_cast<int>(cudaErrorInvalidValue);
  // Opt in once per instantiation, before any stream capture can begin.
  static const cudaError_t configured = cudaFuncSetAttribute(
      segment_sum_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSharedBytes);
  if (configured != cudaSuccess) return static_cast<int>(configured);
  if (n_rows == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(num_blocks, (d + kCols - 1) / kCols, splits);
  float* dst = static_cast<float*>(splits > 1 ? partial : out);
  segment_sum_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(data), static_cast<const int*>(local_rows),
      static_cast<const int*>(tile_row_blocks), num_tiles, dst, n_rows, tile, r, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long count = n_rows * d;
  long long blocks = (count + 255) / 256;
  if (blocks > 132LL * 8) blocks = 132LL * 8;
  combine_partials_kernel<<<(unsigned)blocks, 256, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), count, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* ptgnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16. data: [num_tiles * tile, d]; local_rows:
// [num_tiles * tile] int32; tile_row_blocks: [num_tiles] int32, non-decreasing;
// out: [n_rows, d] float32; partial: [splits, n_rows, d] float32 scratch when
// splits > 1 (else unused). Returns cudaGetLastError() after the launches
// (0 = success).
extern "C" int ptgnn_segment_sum(const void* data, int dtype, const void* local_rows,
                                 const void* tile_row_blocks, long long num_tiles, void* partial,
                                 void* out, long long n_rows, int num_blocks, int tile, int r,
                                 int d, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(data, local_rows, tile_row_blocks, num_tiles, partial, out, n_rows,
                         num_blocks, tile, r, d, splits, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(data, local_rows, tile_row_blocks, num_tiles, partial, out,
                                 n_rows, num_blocks, tile, r, d, splits, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
