// Keyed message dropout: out[e, c] = x[e, c] / keep where the hash of the
// element's directed edge key, the step's seed and its column clears the
// threshold, and +0 elsewhere, over every slot e and column c of an [E, C]
// block. The mask is made and applied in one pass, from the slot's endpoint
// ids; no key, hash or mask is written to device memory.
//
// Replaces no TPU kernel: the JAX package computes the mask with XLA's
// uint32 elementwise ops (ptgnn_tpu/ops/fused_mp.py::_keyed_dropout_mask),
// which XLA fuses into one loop. The port ran it as about 27 PyTorch int64
// kernels over [E, C] temporaries a mask, and about 30 [E] kernels a key,
// at 1.6 % of the memory roofline; this kernel takes their place.
//
// What it computes, bit for bit the plain version
// (ptgnn_tpu_torch/ops/keyed_dropout.py::keyed_dropout_plain), in wrapping
// uint32 arithmetic, with H the xorshift-multiply avalanche hash:
//   key(e)  = H(H(u * 2654435761) ^ H(v * 2246822519) ^ H(t * 3266489917)),
//             u, v the slot's endpoint ids and t = types[e / tile], each an
//             int32 read as its uint32 bits (padding ids included);
//   kept    = H((key(e) ^ seed) + (col_offset + c) * 0x9E3779B9) >= thr,
//             seed the low 32 bits of an int64 read from device memory;
//   out     = kept ? x / divisor : +0, the divisor the keep probability in
//             x's dtype: float32 by IEEE-rounded division, bf16 as
//             float(x) / divisor rounded to nearest even, as PyTorch's
//             opmath divides.
//
// Bound: bytes. x read once, out written once, three 4-byte ids a row: at
// [131072, 128] float32 134 MB, 0.040 ms at 3.35 TB/s. The integer work,
// about 10 uint32 operations an element and 16 a row key, is a fraction of
// that at the card's integer rate.
//
// Design, after the broadcast kernel (csrc/broadcast_rows.cu). Each warp
// takes a chunk of consecutive rows, about 4 KB of them (a power of two of
// rows, at most 32). Lane s loads row s's three ids (coalesced), hashes its
// key once and folds the seed in. The warp then walks the chunk's 16-byte
// units, neighbouring lanes on neighbouring addresses: each lane issues up
// to 8 independent loads, then takes each unit's row key from its owner
// lane with a shuffle, hashes each element's column (the column term is
// computed from the column index) and stores. A grid of up to 8 blocks an
// SM strides over the chunks. Rows of whole 16-byte vectors (x, out and x's
// row stride 16-byte aligned) move as vectors, the vectors in a row a
// template parameter at the widths in use; any other row moves element by
// element. The seed is read through its pointer and nothing is allocated,
// so the launch is capturable in a CUDA graph, and a replay follows a seed
// rewritten between replays.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunkBytes = 4096;  // input rows a warp takes, about
constexpr int kInFlight = 8;       // units a lane loads before it stores
constexpr int kBlocksPerSm = 8;

struct Params {
  const int* src;
  const int* dst;
  const int* types;         // one a `tile` rows
  const long long* seed;    // [1]
  long long ld;             // x's row stride, in units
  int rows;
  int tile;
  unsigned col_offset;
  unsigned thr;
  float divisor;
};

int sm_count() {
  static int counts[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (counts[dev] == 0 && cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 132;
  return counts[dev];
}

__device__ __forceinline__ uint32_t mix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t edge_key(const Params& p, int e) {
  const uint32_t u = static_cast<uint32_t>(__ldg(p.src + e));
  const uint32_t v = static_cast<uint32_t>(__ldg(p.dst + e));
  const uint32_t t = static_cast<uint32_t>(__ldg(p.types + e / p.tile));
  return mix(mix(u * 2654435761u) ^ mix(v * 2246822519u) ^ mix(t * 3266489917u));
}

__device__ __forceinline__ bool kept(uint32_t ks, uint32_t col, const Params& p) {
  return mix(ks + col * 0x9E3779B9u) >= p.thr;
}

// One float32 element, as its bits.
__device__ __forceinline__ uint32_t drop_f32(uint32_t bits, uint32_t ks, uint32_t col, const Params& p) {
  return kept(ks, col, p) ? __float_as_uint(__fdiv_rn(__uint_as_float(bits), p.divisor)) : 0u;
}

// One bf16 element, as its bits in the low half.
__device__ __forceinline__ uint32_t drop_bf16(uint32_t bits, uint32_t ks, uint32_t col, const Params& p) {
  if (!kept(ks, col, p)) return 0u;
  return __bfloat16_as_ushort(__float2bfloat16_rn(__fdiv_rn(__uint_as_float(bits << 16), p.divisor)));
}

template <bool BF16>
__device__ __forceinline__ uint32_t drop_word(uint32_t w, uint32_t ks, uint32_t col, const Params& p) {
  if (BF16) return drop_bf16(w & 0xFFFFu, ks, col, p) | (drop_bf16(w >> 16, ks, col + 1, p) << 16);
  return drop_f32(w, ks, col, p);
}

// A unit starting at column `col`: 16 bytes, or one element.
template <bool BF16>
__device__ __forceinline__ uint4 drop_unit(uint4 v, uint32_t ks, uint32_t col, const Params& p) {
  constexpr uint32_t w = BF16 ? 2 : 1;
  v.x = drop_word<BF16>(v.x, ks, col, p);
  v.y = drop_word<BF16>(v.y, ks, col + w, p);
  v.z = drop_word<BF16>(v.z, ks, col + 2 * w, p);
  v.w = drop_word<BF16>(v.w, ks, col + 3 * w, p);
  return v;
}

template <bool BF16>
__device__ __forceinline__ uint32_t drop_unit(uint32_t v, uint32_t ks, uint32_t col, const Params& p) {
  return drop_f32(v, ks, col, p);
}

template <bool BF16>
__device__ __forceinline__ unsigned short drop_unit(unsigned short v, uint32_t ks, uint32_t col, const Params& p) {
  return static_cast<unsigned short>(drop_bf16(v, ks, col, p));
}

// U: the unit moved; N: units a row (0: `units` at run time).
template <bool BF16, typename U, int N>
__global__ void __launch_bounds__(kThreads)
keyed_dropout_kernel(const U* __restrict__ x, U* __restrict__ out, Params p, int units, int rows_per_chunk) {
  if (N > 0) units = N;
  constexpr uint32_t kPer = sizeof(U) / (BF16 ? 2 : 4);  // elements a unit
  const int lane = threadIdx.x & 31;
  const uint32_t seed = static_cast<uint32_t>(__ldg(p.seed));
  const long long chunks = (static_cast<long long>(p.rows) + rows_per_chunk - 1) / rows_per_chunk;
  for (long long chunk = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32; chunk < chunks;
       chunk += static_cast<long long>(gridDim.x) * kWarps) {
    const int row0 = static_cast<int>(chunk * rows_per_chunk);
    const int count = min(rows_per_chunk, p.rows - row0);
    const uint32_t ks = lane < count ? edge_key(p, row0 + lane) ^ seed : 0u;
    const int n = count * units;
    const U* src = x + static_cast<long long>(row0) * p.ld;
    U* dst = out + static_cast<long long>(row0) * units;
    for (int base = 0; base < n; base += 32 * kInFlight) {
      U r[kInFlight];
#pragma unroll
      for (int i = 0; i < kInFlight; ++i) {
        const int v = base + i * 32 + lane;
        const int s = v / units;
        r[i] = U{};
        if (v < n) r[i] = src[static_cast<long long>(s) * p.ld + (v - s * units)];
      }
#pragma unroll
      for (int i = 0; i < kInFlight; ++i) {
        const int v = base + i * 32 + lane;
        const int s = v / units;
        const uint32_t k = __shfl_sync(0xffffffffu, ks, s & 31);
        if (v < n) dst[v] = drop_unit<BF16>(r[i], k, p.col_offset + static_cast<uint32_t>(v - s * units) * kPer, p);
      }
    }
  }
}

template <bool BF16, typename U, int N>
int launch(const void* x, void* out, const Params& p, int units, cudaStream_t stream) {
  const long long row_bytes = static_cast<long long>(units) * sizeof(U);
  int rows_per_chunk = 1;
  while (rows_per_chunk < 32 && 2 * rows_per_chunk * row_bytes <= kChunkBytes) rows_per_chunk *= 2;
  const long long chunks = (static_cast<long long>(p.rows) + rows_per_chunk - 1) / rows_per_chunk;
  long long grid = (chunks + kWarps - 1) / kWarps;
  const long long cap = static_cast<long long>(kBlocksPerSm) * sm_count();
  if (grid > cap) grid = cap;
  keyed_dropout_kernel<BF16, U, N><<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
      static_cast<const U*>(x), static_cast<U*>(out), p, units, rows_per_chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* ptgnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x: [rows, cols] float32 (dtype 0) or bf16 (dtype 1), rows `ld` elements
// apart, columns contiguous; out: [rows, cols] contiguous, of x's dtype;
// src, dst: [rows] int32; types: [rows / tile] int32 (tile 1: one a slot);
// seed: a device int64. thr: int(rate * 0xFFFFFFFF); divisor: the keep
// probability in x's dtype. Rows are counted in 32 bits. Returns
// cudaGetLastError() after the launch (0 = success).
extern "C" int ptgnn_keyed_dropout(const void* x, long long ld, void* out, const void* src, const void* dst,
                                   const void* types, int tile, const void* seed, long long rows, int cols,
                                   int col_offset, unsigned thr, float divisor, int dtype, void* stream) {
  if (rows < 0 || rows > 2147483647LL || cols < 0 || tile <= 0 || rows % tile != 0 || col_offset < 0 ||
      (rows > 1 && ld < cols) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0 || cols == 0) return static_cast<int>(cudaSuccess);
  Params p;
  p.src = static_cast<const int*>(src);
  p.dst = static_cast<const int*>(dst);
  p.types = static_cast<const int*>(types);
  p.seed = static_cast<const long long*>(seed);
  p.rows = static_cast<int>(rows);
  p.tile = tile;
  p.col_offset = static_cast<unsigned>(col_offset);
  p.thr = thr;
  p.divisor = divisor;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long esize = dtype == 1 ? 2 : 4;
  const long long row_bytes = cols * esize;
  const uintptr_t aligned = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out) |
                            static_cast<uintptr_t>(ld * esize) | static_cast<uintptr_t>(row_bytes);
  if (aligned % 16 == 0) {
    const int vecs = static_cast<int>(row_bytes / 16);
    p.ld = ld * esize / 16;
    if (dtype == 0) {
      switch (vecs) {
        case 32: return launch<false, uint4, 32>(x, out, p, vecs, s);
        case 64: return launch<false, uint4, 64>(x, out, p, vecs, s);
        default: return launch<false, uint4, 0>(x, out, p, vecs, s);
      }
    }
    switch (vecs) {
      case 16: return launch<true, uint4, 16>(x, out, p, vecs, s);
      case 32: return launch<true, uint4, 32>(x, out, p, vecs, s);
      default: return launch<true, uint4, 0>(x, out, p, vecs, s);
    }
  }
  p.ld = ld;
  if (dtype == 0) return launch<false, uint32_t, 0>(x, out, p, cols, s);
  return launch<true, unsigned short, 0>(x, out, p, cols, s);
}
