// Typed tile matmul: y[e] = x[e] @ W[tile_types[e / tile]].
//
// Replaces ptgnn_tpu/ops/typed_linear.py::_pallas_typed_matmul_impl (the
// kernel body at :62, launched by the pallas_call at :86): one grid step per
// edge tile, the tile's weight block picked by the scalar-prefetched tile
// types, one MXU dot with float32 accumulation.
//
// Semantics: x is [num_tiles * tile, din], W is [num_types, din, m] in x's
// dtype (float32 or bfloat16), tile_types is [num_tiles] int32. Row e of the
// [num_tiles * tile, m] output is x[e] @ W[tile_types[e / tile]], summed in
// float32 and rounded once to x's dtype. Every tile is computed, padding
// tiles included; a tile whose type lies outside [0, num_types) reads zeros.
//
// Bound. At the PPI shapes ([122880, 512] x [3, 512, 256] and [122880, 256]
// x [3, 256, 256]) the bf16 product does about 170 operations per byte moved,
// below the H100's ~295 for bf16 tensor cores, so it is bound by bytes: x
// read once, y written once, W (a few hundred KB) once. In float32 without
// TF32 it is bound by operations (67 TFLOP/s on the CUDA cores).
//
// Design. A grouped GEMM over the type-pure tiles, not a copy of the Pallas
// block loop. A CTA takes one (row block of a tile, M block) pair, reads its
// tile's type once, and streams that type's W block through shared memory in
// K chunks alongside the tile's x rows. bf16: 128 x 128 output blocks, eight
// warps of 32 x 64, nvcuda::wmma 16x16x16 fragments with float32
// accumulators, K chunks of 32 double-buffered with cp.async. float32: 64 x 64
// blocks, 4 x 4 outputs a thread, fmaf on the CUDA cores (no TF32, for
// parity with the float32 reference). Each output element is accumulated in
// the same order over din wherever its row sits (chunk by chunk, fragment by
// fragment; no atomics, no split K), so equal rows of one type give equal
// bits in any tile or slot: the fused backward's value-tie routing compares
// messages recomputed in another slot with ==. Simple first: wgmma and TMA
// are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

// ---- bfloat16: tensor cores through wmma ----------------------------------
constexpr int kBM = 128;  // rows per CTA
constexpr int kBN = 128;  // output columns per CTA
constexpr int kBK = 32;   // depth per shared-memory chunk
constexpr int kWarpsM = 4;
constexpr int kWarpsN = 2;
constexpr int kThreads = 32 * kWarpsM * kWarpsN;
constexpr int kFragM = kBM / kWarpsM / 16;  // 2 fragments down a warp's 32 rows
constexpr int kFragN = kBN / kWarpsN / 16;  // 4 fragments across its 64 columns
constexpr int kLdA = kBK + 8;  // padded rows: 80 bytes, a multiple of 16 (cp.async) and of 8 elements (wmma)
constexpr int kLdB = kBN + 8;  // 272 bytes

// ---- float32: CUDA cores --------------------------------------------------
constexpr int kFBM = 64;
constexpr int kFBN = 64;
constexpr int kFBK = 16;
constexpr int kFThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Two floats rounded to nearest-even bf16, as one 32-bit word (first in the low half).
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// The CTA's rows: [row0, row0 + rows) of one tile. Returns the tile's type.
__device__ __forceinline__ int cta_rows(const int* __restrict__ tile_types, int tile,
                                        int blocks_per_tile, int block_rows, long long* row0,
                                        int* rows) {
  const long long tile_idx = blockIdx.x / blocks_per_tile;
  const int sub = blockIdx.x % blocks_per_tile;
  *row0 = tile_idx * tile + (long long)sub * block_rows;
  *rows = min(block_rows, tile - sub * block_rows);
  return __ldg(tile_types + tile_idx);
}

template <typename T>
__device__ void zero_block(T* __restrict__ y, long long row0, int rows, int col0, int cols, int m) {
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
    const int r = i / cols;
    const int c = col0 + i - r * cols;
    if (c < m) y[(row0 + r) * m + c] = T(0.0f);
  }
}

__global__ void __launch_bounds__(kThreads)
typed_matmul_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                         const int* __restrict__ tile_types, __nv_bfloat16* __restrict__ y,
                         int tile, int blocks_per_tile, int din, int m, int num_types) {
  __shared__ __align__(128) __nv_bfloat16 sa[2][kBM * kLdA];
  __shared__ __align__(128) __nv_bfloat16 sb[2][kBK * kLdB];
  __shared__ __align__(128) float stage[kWarpsM * kWarpsN][16 * 16];

  long long row0;
  int rows;
  const int type = cta_rows(tile_types, tile, blocks_per_tile, kBM, &row0, &rows);
  const int col0 = blockIdx.y * kBN;
  if (type < 0 || type >= num_types) {
    zero_block(y, row0, rows, col0, kBN, m);
    return;
  }
  const __nv_bfloat16* wt = w + (long long)type * din * m;

  // One K chunk of x (kBM x kBK) and of W (kBK x kBN): 512 16-byte vectors
  // each, two a thread. Rows past the tile, depth past din and columns past
  // m read as zeros.
  auto load_chunk = [&](int k0, int buf) {
#pragma unroll
    for (int v = threadIdx.x; v < kBM * kBK / 8; v += kThreads) {
      const int r = v / (kBK / 8);
      const int c = (v % (kBK / 8)) * 8;
      const bool ok = r < rows && k0 + c < din;
      const __nv_bfloat16* src = ok ? x + (row0 + r) * din + k0 + c : x;
      cp_async16(&sa[buf][r * kLdA + c], src, ok);
    }
#pragma unroll
    for (int v = threadIdx.x; v < kBK * kBN / 8; v += kThreads) {
      const int r = v / (kBN / 8);
      const int c = (v % (kBN / 8)) * 8;
      const bool ok = k0 + r < din && col0 + c < m;
      const __nv_bfloat16* src = ok ? wt + (long long)(k0 + r) * m + col0 + c : wt;
      cp_async16(&sb[buf][r * kLdB + c], src, ok);
    }
    cp_async_commit();
  };

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp / kWarpsN;
  const int wn = warp % kWarpsN;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kFragM][kFragN];
#pragma unroll
  for (int i = 0; i < kFragM; ++i)
#pragma unroll
    for (int j = 0; j < kFragN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int num_chunks = (din + kBK - 1) / kBK;
  load_chunk(0, 0);
  for (int kc = 0; kc < num_chunks; ++kc) {
    if (kc + 1 < num_chunks) {
      load_chunk((kc + 1) * kBK, (kc + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* a_buf = sa[kc & 1];
    const __nv_bfloat16* b_buf = sb[kc & 1];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[kFragM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[kFragN];
#pragma unroll
      for (int i = 0; i < kFragM; ++i)
        wmma::load_matrix_sync(a[i], a_buf + (wm * 32 + i * 16) * kLdA + kk, kLdA);
#pragma unroll
      for (int j = 0; j < kFragN; ++j)
        wmma::load_matrix_sync(b[j], b_buf + kk * kLdB + wn * 64 + j * 16, kLdB);
#pragma unroll
      for (int i = 0; i < kFragM; ++i)
#pragma unroll
        for (int j = 0; j < kFragN; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // the buffer is refilled by the next iteration's load
  }

  // Epilogue: each fragment goes through the warp's float32 staging tile and
  // leaves as 16-byte rows of 8 bf16 values (m is a multiple of 8).
  float* st = stage[warp];
  const int sr = lane >> 1;
  const int sc = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < kFragM; ++i) {
#pragma unroll
    for (int j = 0; j < kFragN; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int r = wm * 32 + i * 16 + sr;
      const int c = col0 + wn * 64 + j * 16 + sc;
      if (r < rows && c < m) {
        const float* v = st + sr * 16 + sc;
        *reinterpret_cast<uint4*>(y + (row0 + r) * m + c) =
            make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]), pack_bf16x2(v[4], v[5]),
                       pack_bf16x2(v[6], v[7]));
      }
      __syncwarp();
    }
  }
}

__global__ void __launch_bounds__(kFThreads)
typed_matmul_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                        const int* __restrict__ tile_types, float* __restrict__ y, int tile,
                        int blocks_per_tile, int din, int m, int num_types) {
  __shared__ __align__(16) float sa[kFBK][kFBM + 4];  // x chunk, transposed: [k][row]
  __shared__ __align__(16) float sb[kFBK][kFBN + 4];  // W chunk: [k][col]

  long long row0;
  int rows;
  const int type = cta_rows(tile_types, tile, blocks_per_tile, kFBM, &row0, &rows);
  const int col0 = blockIdx.y * kFBN;
  if (type < 0 || type >= num_types) {
    zero_block(y, row0, rows, col0, kFBN, m);
    return;
  }
  const float* wt = w + (long long)type * din * m;
  const int t = threadIdx.x;
  const int ty = t / 16;  // output rows ty*4 .. ty*4+3
  const int tx = t % 16;  // output columns tx*4 .. tx*4+3
  float acc[4][4] = {};

  for (int k0 = 0; k0 < din; k0 += kFBK) {
    {  // x: 64 rows x 16 depth = one float4 a thread (din is a multiple of 4)
      const int r = t / 4;
      const int c = (t % 4) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < rows && k0 + c < din) v = *reinterpret_cast<const float4*>(x + (row0 + r) * din + k0 + c);
      sa[c + 0][r] = v.x;
      sa[c + 1][r] = v.y;
      sa[c + 2][r] = v.z;
      sa[c + 3][r] = v.w;
    }
    {  // W: 16 depth x 64 columns = one float4 a thread (m is a multiple of 4)
      const int r = t / 16;
      const int c = (t % 16) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + r < din && col0 + c < m) v = *reinterpret_cast<const float4*>(wt + (long long)(k0 + r) * m + col0 + c);
      *reinterpret_cast<float4*>(&sb[r][c]) = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&sa[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&sb[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  const int c = col0 + tx * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r < rows && c < m)
      *reinterpret_cast<float4*>(y + (row0 + r) * m + c) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

}  // namespace

extern "C" const char* ptgnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16. x: [num_tiles * tile, din]; w: [num_types,
// din, m]; tile_types: [num_tiles] int32; y: [num_tiles * tile, m]; all
// contiguous, 16-byte aligned, din and m multiples of 8 (bf16) or 4 (f32).
// Returns cudaGetLastError() after the launch (0 = success).
extern "C" int ptgnn_typed_matmul(const void* x, const void* w, const void* tile_types, void* y,
                                  int dtype, long long num_tiles, int tile, int din, int m,
                                  int num_types, void* stream) {
  const int vec = dtype == 1 ? 8 : 4;
  if ((dtype != 0 && dtype != 1) || tile <= 0 || din <= 0 || m <= 0 || num_types <= 0 ||
      din % vec || m % vec || num_tiles < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_tiles == 0) return static_cast<int>(cudaSuccess);
  const int block_rows = dtype == 1 ? kBM : kFBM;
  const int block_cols = dtype == 1 ? kBN : kFBN;
  const int blocks_per_tile = (tile + block_rows - 1) / block_rows;
  const long long grid_x = num_tiles * blocks_per_tile;
  const long long grid_y = (m + block_cols - 1) / block_cols;
  if (grid_x > 2147483647LL || grid_y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(grid_x), static_cast<unsigned>(grid_y));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    typed_matmul_bf16_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<const int*>(tile_types), static_cast<__nv_bfloat16*>(y), tile, blocks_per_tile,
        din, m, num_types);
  else
    typed_matmul_f32_kernel<<<grid, kFThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const int*>(tile_types), static_cast<float*>(y), tile, blocks_per_tile, din, m,
        num_types);
  return static_cast<int>(cudaGetLastError());
}
