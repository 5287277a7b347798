// Typed weight gradient: dW[t] = sum over the edge tiles i of type t of
// X_i^T G_i, in float32, from bf16 operands.
//
// The gradient of the typed tile product (csrc/typed_matmul.cu) with respect
// to its weight stack. Replaces no Pallas kernel: the JAX package forms it
// with XLA dots of the bf16 operands at preferred_element_type float32
// (ptgnn_tpu/ops/fused_mp.py's dW routes, ptgnn_tpu/ops/typed_linear.py's
// _pallas_typed_matmul_bwd), which the port had taken as per-type masked
// float32 products on the CUDA cores: T full-length products over every
// slot, two thirds of them multiplying zeros at PPI's three types.
//
// Semantics: x is [num_tiles * tile, din] bf16 with row stride x_ld, g is
// [num_tiles * tile, m] bf16 with row stride g_ld (a row-strided view is
// read in place); tile_types is [num_tiles] int32. out[t] ([num_types, din,
// m] float32) sums x_e^T g_e over the slots e of the tiles of type t; tiles
// whose type lies outside [0, num_types) add nothing, and a type with no
// tiles gives zeros. Every product of two bf16 values is exact in float32,
// and the sums are float32, as in the routes it replaces; only their order
// differs. The order is fixed by the inputs and the chunk length, with no
// atomics, so the same inputs give the same bits on every run and in a CUDA
// graph replay.
//
// Bound. At PPI's shape ([122880, 512] and [122880, 256] over 3 types) the
// product does 2 E din m = 32.2 GFLOP over 189 MB read, 171 operations a
// byte, below the H100's ~295 for bf16 tensor cores: bound by bytes, 57 us
// at 3.35 TB/s. The float32 partials add 2 * chunks * din * m * 4 bytes
// (about 17 MB at PPI's shape) that the second pass reads from L2.
//
// Design: TMA + wgmma with both operands MN-major. The contraction runs over
// edge rows, so the shared tiles are X [64 rows][64 din] and G [64 rows][64
// m] boxes as they lie in memory (din and m contiguous), which wgmma's
// transposed-operand form for 16-bit types reads directly: A = X^T (M = din,
// transposed), B = G (N = m, transposed), K = 64 rows a stage. Both are 3-D
// TMA tensors [num_tiles, tile, width], so a box never crosses an edge tile
// (and so never a type boundary); rows past the tile, and columns past din
// or m, read as zeros, so every tile size works. A unit is (type, chunk of
// at most chunk_len of that type's tiles in tile order, 128-row din block,
// BN-column m block); the units of one chunk are adjacent, so the blocks
// that re-read a chunk's rows run together and find them in L2. Each CTA
// counts the tiles of each type (shared-memory atomics over tile_types) and
// scans the chunk bases once; its producer warp finds each chunk's tiles by
// ballots over tile_types. A persistent CTA per SM walks the units: one
// producer thread keeps a ring of stages (X 64 x 128 + G 64 x BN) in flight
// against full/empty mbarriers; two consumer warpgroups (64 din rows each)
// run wgmma m64nBNk16 over a stage's four k16 steps, float32 accumulators in
// registers, and store the unit's [128, BN] float32 partial to its slot
// (chunk, din block, m block). The second kernel sums each element's
// partials in chunk order and writes out, zeros for a type with no chunks.
// Both kernels carry typed_dw_bf16_kernel in their names (the benchmark's
// typed_dw_roofline reads their device time).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

constexpr int kRows = 64;        // edge rows of a stage: the contraction depth per stage
constexpr int kDinBlock = 128;   // din rows of a unit: two consumer warpgroups of 64
constexpr int kConsumers = 2;    // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kBoxBytes = 64 * 64 * 2;  // one [64 rows][64 columns] bf16 box, 128-byte swizzled
constexpr int kXBoxes = kDinBlock / 64;
constexpr int kRingBytes = 192 * 1024;  // the stages' share of shared memory
constexpr int kMaxTypes = 1024;
constexpr int kSumThreads = 256;

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Waits until the barrier's phase of the given parity has completed. A lost
// phase (a TMA that never lands) traps after about ten seconds instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > 20000000000LL) __trap();
  }
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// An MN-major operand in shared memory with the 128-byte swizzle: 64
// contiguous MN values (128 bytes) a K row, rows 128 bytes apart, 8-row
// groups 1024 bytes apart (SBO), 64-wide MN blocks one box (8 KB) apart
// (LBO), layout B128. Every start lies on a 1024-byte boundary; a k16 step
// (16 K rows) adds 2048 bytes.
__device__ __forceinline__ uint64_t mn_sw128_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(kBoxBytes >> 4) << 16) | (uint64_t(1024 >> 4) << 32) | (1ull << 62);
}

constexpr uint64_t kK16Step = 2048 >> 4;  // descriptor units

template <int N>
struct Wgmma;

// wgmma.mma_async m64nNk16, bf16 x bf16 -> float32, both operands MN-major
// (transposed) from shared memory, D += A B.
template <>
struct Wgmma<64> {
  __device__ static void mma(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  __device__ static void mma(float (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<256> {
  __device__ static void mma(float (&d)[128], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int BN>
struct Config {
  static constexpr int kGBoxes = BN / 64;
  static constexpr int kStageBytes = (kXBoxes + kGBoxes) * kBoxBytes;
  static constexpr int kStages = kRingBytes / kStageBytes;  // 4, 6 or 8
  static constexpr size_t kSmem = 1024 + size_t(kStages) * kStageBytes + 2 * kStages * 8 + 2 * (kMaxTypes + 1) * 4;
};

// Work unit u: (chunk of one type's tiles, din block, m block), the blocks
// of one chunk adjacent. ``base`` holds each type's first chunk (non-
// decreasing, base[num_types] = the chunks of all types), ``count`` its tiles.
struct Unit {
  int chunk, type, rank0, tiles, din0, m0;
};

template <int BN>
__device__ __forceinline__ Unit unit_of(int u, int blocks, int m_blocks, const int* count, const int* base,
                                        int num_types, int chunk_len) {
  Unit w;
  w.chunk = u / blocks;
  const int b = u - w.chunk * blocks;
  int lo = 0, hi = num_types;  // the last type whose first chunk is at most this chunk
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (base[mid] <= w.chunk) lo = mid;
    else hi = mid;
  }
  w.type = lo;
  w.rank0 = (w.chunk - base[lo]) * chunk_len;
  w.tiles = min(chunk_len, count[lo] - w.rank0);
  w.din0 = (b / m_blocks) * kDinBlock;
  w.m0 = (b % m_blocks) * BN;
  return w;
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
typed_dw_bf16_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap gmap,
                     const int* __restrict__ tile_types, float* __restrict__ partial, int* __restrict__ chunk_base,
                     int num_tiles, int tile, int din, int m, int num_types, int chunk_len) {
  using C = Config<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + C::kStages * C::kStageBytes);
  uint64_t* empty = full + C::kStages;
  int* count = reinterpret_cast<int*>(empty + C::kStages);  // [num_types] tiles of each type
  int* base = count + kMaxTypes + 1;                         // [num_types + 1] first chunk of each type

  for (int t = threadIdx.x; t < num_types; t += blockDim.x) count[t] = 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (int i = threadIdx.x; i < num_tiles; i += blockDim.x) {
    const int t = __ldg(tile_types + i);
    if (t >= 0 && t < num_types) atomicAdd(&count[t], 1);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int chunks = 0;
    for (int t = 0; t < num_types; ++t) {
      base[t] = chunks;
      chunks += (count[t] + chunk_len - 1) / chunk_len;
    }
    base[num_types] = chunks;
  }
  __syncthreads();
  if (blockIdx.x == 0)  // the second pass's chunk ranges
    for (int t = threadIdx.x; t <= num_types; t += blockDim.x) chunk_base[t] = base[t];

  const int m_blocks = (m + BN - 1) / BN;
  const int blocks = ((din + kDinBlock - 1) / kDinBlock) * m_blocks;
  const int units = base[num_types] * blocks;
  const int steps_per_tile = (tile + kRows - 1) / kRows;

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // Producer warpgroup: its first warp finds each chunk's tiles, one
    // thread issues every load.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x < kConsumers * 128 + 32) {
      const int lane = threadIdx.x % 32;
      int stage = 0;
      unsigned phase = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const Unit w = unit_of<BN>(u, blocks, m_blocks, count, base, num_types, chunk_len);
        const int x_boxes = min(kXBoxes, (din - w.din0 + 63) / 64);
        const int g_boxes = min(C::kGBoxes, (m - w.m0 + 63) / 64);
        const unsigned stage_bytes = (x_boxes + g_boxes) * kBoxBytes;
        int seen = 0, found = 0;  // tiles of the type passed, and of the chunk issued
        for (int first = 0; found < w.tiles && first < num_tiles; first += 32) {
          const int i = first + lane;
          const int t = i < num_tiles ? __ldg(tile_types + i) : -1;
          unsigned hits = __ballot_sync(0xffffffffu, t == w.type);
          if (seen + __popc(hits) <= w.rank0) {
            seen += __popc(hits);
            continue;
          }
          while (hits != 0 && found < w.tiles) {
            const int bit = __ffs(hits) - 1;
            hits &= hits - 1;
            if (seen++ < w.rank0) continue;
            ++found;
            if (lane != 0) continue;
            for (int s = 0; s < steps_per_tile; ++s) {
              mbar_wait(&empty[stage], phase ^ 1);
              mbar_expect_tx(&full[stage], stage_bytes);
              uint8_t* st = ring + stage * C::kStageBytes;
              for (int j = 0; j < x_boxes; ++j)
                tma_load_3d(st + j * kBoxBytes, &xmap, &full[stage], w.din0 + 64 * j, s * kRows, first + bit);
              for (int j = 0; j < g_boxes; ++j)
                tma_load_3d(st + (kXBoxes + j) * kBoxBytes, &gmap, &full[stage], w.m0 + 64 * j, s * kRows,
                            first + bit);
              if (++stage == C::kStages) {
                stage = 0;
                phase ^= 1;
              }
            }
          }
        }
      }
    }
  } else {
    // Consumer warpgroups: din rows [din0 + wg * 64, din0 + wg * 64 + 64) of each unit.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    float acc[BN / 2];
    int stage = 0;
    unsigned phase = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const Unit w = unit_of<BN>(u, blocks, m_blocks, count, base, num_types, chunk_len);
      const int row0 = w.din0 + wg * 64;
      const bool live = row0 < din;  // din past the block's first 64 rows leaves the second warpgroup idle
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
      fence_operands(acc);
      const int steps = w.tiles * steps_per_tile;
      for (int s = 0; s < steps; ++s) {
        mbar_wait(&full[stage], phase);
        if (live) {
          uint8_t* st = ring + stage * C::kStageBytes;
          const uint64_t da = mn_sw128_desc(st + wg * kBoxBytes);
          const uint64_t db = mn_sw128_desc(st + kXBoxes * kBoxBytes);
          asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
          for (int kk = 0; kk < kRows / 16; ++kk) Wgmma<BN>::mma(acc, da + kk * kK16Step, db + kk * kK16Step);
          asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
          asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
          fence_operands(acc);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[stage]);
        if (++stage == C::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      if (!live) continue;
      // The unit's partial: row r, column c of the [64, BN] accumulator
      // tile (thread layout of wgmma's D fragment), two columns a store.
      float* dst = partial + (static_cast<long long>(w.chunk) * din + row0) * m + w.m0;
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = warp * 16 + lane / 4 + 8 * h;
          const int c = n * 8 + (lane % 4) * 2;
          if (row0 + r < din && w.m0 + c < m)
            *reinterpret_cast<float2*>(dst + static_cast<long long>(r) * m + c) =
                make_float2(acc[4 * n + 2 * h], acc[4 * n + 2 * h + 1]);
        }
      }
    }
  }
}

// out[t][i][j] = the sum of partial[c][i][j] over type t's chunks c in
// increasing order, four columns a thread; 0 where t has no chunk.
__global__ void __launch_bounds__(kSumThreads)
typed_dw_bf16_kernel_sum(const float4* __restrict__ partial, const int* __restrict__ chunk_base,
                         float4* __restrict__ out, int num_types, long long per_type) {
  const long long i = static_cast<long long>(blockIdx.x) * kSumThreads + threadIdx.x;
  if (i >= num_types * per_type) return;
  const int t = static_cast<int>(i / per_type);
  const long long e = i - t * per_type;
  const int c1 = __ldg(chunk_base + t + 1);
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = __ldg(chunk_base + t); c < c1; ++c) {
    const float4 v = __ldg(partial + c * per_type + e);
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  out[i] = s;
}

// ---- host side --------------------------------------------------------------
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API call: fetched through the runtime's
// entry-point query, so the library needs no link against libcuda.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess) ? reinterpret_cast<EncodeTiled>(p)
                                                                        : nullptr;
  }();
  return fn;
}

// Rows of ``width`` bf16 values ``ld`` apart, in tiles of ``tile`` rows, as a
// 3-D TMA map [num_tiles, tile, width] with 64 x 64 boxes and the 128-byte
// swizzle; out-of-bounds elements read as zero.
bool bf16_map(CUtensorMap* map, const void* base, uint64_t width, uint64_t ld, uint64_t tile, uint64_t num_tiles) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {width, tile, num_tiles};
  const cuuint64_t strides[2] = {ld * 2, ld * tile * 2};
  const cuuint32_t box[3] = {64, kRows, 1};
  const cuuint32_t element_strides[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
                element_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int kMaxDevices = 64;

int sm_count() {
  static int counts[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return 132;
  if (counts[dev] == 0 && cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 132;
  return counts[dev];
}

template <int BN>
int launch(const CUtensorMap& xmap, const CUtensorMap& gmap, const int* tile_types, float* partial, int* chunk_base,
           int num_tiles, int tile, int din, int m, int num_types, int chunk_len, long long max_units,
           cudaStream_t stream) {
  constexpr size_t smem = Config<BN>::kSmem;
  // The opt-in holds for the current device only: once per instantiation
  // and device, at the first launch on each card (before any capture).
  static std::atomic<int> configured[kMaxDevices];  // 0: not yet, else the opt-in's error + 1
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  int state = configured[dev].load();
  if (state == 0) {
    state = 1 + static_cast<int>(cudaFuncSetAttribute(typed_dw_bf16_kernel<BN>,
                                                      cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                      static_cast<int>(smem)));
    configured[dev].store(state);
  }
  if (state != 1) return state - 1;
  const long long grid = max_units < sm_count() ? max_units : sm_count();
  typed_dw_bf16_kernel<BN><<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(
      xmap, gmap, tile_types, partial, chunk_base, num_tiles, tile, din, m, num_types, chunk_len);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* ptgnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x: [num_tiles * tile, din] bf16, rows x_ld elements apart; g: [num_tiles *
// tile, m] bf16, rows g_ld apart; tile_types: [num_tiles] int32; partial:
// max_chunks * din * m float32 scratch, max_chunks at least num_tiles /
// chunk_len + num_types; chunk_base: num_types + 1 int32 scratch; out:
// [num_types, din, m] float32. Addresses 16-byte aligned, din, m, x_ld and
// g_ld multiples of 8, 1 <= num_types <= 1024. Returns cudaGetLastError()
// after the launches (0 = success).
extern "C" int ptgnn_typed_dw(const void* x, long long x_ld, const void* g, long long g_ld, const void* tile_types,
                              void* partial, void* chunk_base, void* out, long long num_tiles, int tile, int din,
                              int m, int num_types, int chunk_len, long long max_chunks, void* stream) {
  if (tile <= 0 || din <= 0 || m <= 0 || num_types <= 0 || num_types > kMaxTypes || chunk_len <= 0 || din % 8 ||
      m % 8 || x_ld % 8 || g_ld % 8 || x_ld < din || g_ld < m || num_tiles <= 0 || num_tiles >= (1LL << 30) ||
      max_chunks < num_tiles / chunk_len + num_types || max_chunks * din * m >= (1LL << 40))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xmap, gmap;
  if (!bf16_map(&xmap, x, din, x_ld, tile, num_tiles) || !bf16_map(&gmap, g, m, g_ld, tile, num_tiles))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tt = static_cast<const int*>(tile_types);
  float* p = static_cast<float*>(partial);
  int* cb = static_cast<int*>(chunk_base);
  const int n = static_cast<int>(num_tiles);
  const int bn = m <= 64 ? 64 : (m <= 128 ? 128 : 256);
  const long long max_units = max_chunks * ((din + kDinBlock - 1) / kDinBlock) * ((m + bn - 1) / bn);
  int err;
  if (bn == 64) err = launch<64>(xmap, gmap, tt, p, cb, n, tile, din, m, num_types, chunk_len, max_units, s);
  else if (bn == 128) err = launch<128>(xmap, gmap, tt, p, cb, n, tile, din, m, num_types, chunk_len, max_units, s);
  else err = launch<256>(xmap, gmap, tt, p, cb, n, tile, din, m, num_types, chunk_len, max_units, s);
  if (err != 0) return err;
  const long long per_type = static_cast<long long>(din) * m / 4;
  const long long blocks = (num_types * per_type + kSumThreads - 1) / kSumThreads;
  typed_dw_bf16_kernel_sum<<<static_cast<unsigned>(blocks), kSumThreads, 0, s>>>(
      static_cast<const float4*>(partial), cb, static_cast<float4*>(out), num_types, per_type);
  return static_cast<int>(cudaGetLastError());
}
