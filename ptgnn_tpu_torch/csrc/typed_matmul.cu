// Typed tile matmul: y[e] = x[e] @ W[tile_types[e / tile]].
//
// Replaces ptgnn_tpu/ops/typed_linear.py::_pallas_typed_matmul_impl (the
// kernel body at :62, launched by the pallas_call at :86): one grid step per
// edge tile, the tile's weight block picked by the scalar-prefetched tile
// types, one MXU dot with float32 accumulation.
//
// Semantics: x is [num_tiles * tile, din]; the weights come transposed, wt
// [num_types, m, din] (each type's block W[t]^T, din contiguous), in x's
// dtype (float32 or bfloat16); tile_types is [num_tiles] int32. Row e of the
// [num_tiles * tile, m] output is x[e] @ W[tile_types[e / tile]], summed in
// float32 and rounded once to x's dtype. Every tile is computed, padding
// tiles included; a tile whose type lies outside [0, num_types) gives zeros.
// Each output element sums over din in one fixed order (depth chunks in
// increasing order, and inside a chunk the same order for every row), with
// no split K and no atomics: equal rows of one type give equal bits in any
// tile or slot, which the fused backward's value-tie routing needs (it
// compares messages recomputed in another slot with ==).
//
// Bound. At the PPI shapes ([122880, 512] x [3, 512, 256] and [122880, 256]
// x [3, 256, 256]) the bf16 product does about 170 operations per byte moved,
// below the H100's ~295 for bf16 tensor cores, so it is bound by bytes: x
// read once, y written once, W (a few hundred KB, L2-resident) once. In
// float32 without TF32 it is bound by operations (67 TFLOP/s on the CUDA
// cores).
//
// bfloat16 design: TMA + wgmma, x read from HBM once. x is a 3-D TMA tensor
// [num_tiles, tile, din]: a box of up to 128 rows x 64 deep never crosses a
// tile (and so never a type boundary); rows past the tile and depth past din
// read as zeros, so every tile size works (a 48-row tile is a 64-row box with
// 16 zero rows). W^T [num_types, m, din] is a TMA tensor too, so both
// operands have the same K-major 128-byte-swizzled shared layout and one
// wgmma descriptor form; K-major also makes the backward's dx call (which
// passes W's transpose) a copy-free view of W, while the forward copies its
// under-1-MB stack once a call against ~190 MB moved. A persistent CTA per SM
// walks work units (tile, 128-row block, 256-column pass), the passes of one
// row block adjacent so that x is re-read from L2 when m > 256. One producer
// thread keeps a 3-stage ring (x 128x64 + W^T BNx64 per stage) in flight with
// TMA against full/empty mbarriers; two consumer warpgroups (64 rows each)
// run wgmma m64nBNk16 (BN = 64, 128 or 256 columns, float32 accumulators in
// registers, setmaxnreg 232) over the stage's four k16 steps in order. The
// epilogue rounds to bf16 (nearest-even) once into a swizzled staging buffer
// that a TMA store writes out (it clips rows past the tile and columns past
// m), overlapping the next unit's loads. A unit whose type is out of range
// loads nothing and stores zeros.
//
// float32 design: a SIMT GEMM on the CUDA cores (no TF32: the float32
// reference parity needs full float32). A CTA per (tile, 128-row block,
// 128-column block), the column blocks of one row block adjacent in launch
// order (x from L2 the second time); 256 threads with 8 x 8 outputs each.
// Both operands are K-major in memory and stored transposed in shared
// memory ([k][row], [k][col]) for conflict-free float4 fragment reads, so
// each 8-deep chunk comes through registers: 16-byte loads a chunk ahead of
// the products, transposed stores into the other of two shared buffers, one
// barrier a chunk; the fragments are double-buffered in registers. (A
// 3-stage ring of 4-byte cp.async, which transposes in flight, ran slower
// than the library call on the H100: each of its warp instructions touches
// 32 rows.) Two CTAs an SM (128 registers a thread) keep 16 warps resident.
// fmaf over din in increasing order for every output.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Two floats rounded to nearest-even bf16, as one 32-bit word (first in the low half).
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// ---- bfloat16: TMA + wgmma -------------------------------------------------
constexpr int kRows = 128;       // rows of a work unit: two consumer warpgroups of 64
constexpr int kDepth = 64;       // depth per stage: one 128-byte swizzle row of bf16
constexpr int kStages = 3;
constexpr int kConsumers = 2;    // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kABytes = kRows * kDepth * 2;  // x stage
constexpr int kBoxBytes = 64 * 64 * 2;       // one 64 x 64 bf16 swizzled box

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

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0, int c1, int c2) {
  asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n"
               ::"l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
               : "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// A K-major operand in shared memory with the 128-byte swizzle (rows of 64
// bf16, 8-row groups 1024 bytes apart): start address, LBO 1 (unused for
// swizzled K-major), SBO 1024 bytes, layout B128. The tile must start on a
// 1024-byte boundary; a k16 step inside the 64-deep chunk adds 32 bytes.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

template <int N>
struct Wgmma;

// wgmma.mma_async m64nNk16, bf16 x bf16 -> float32, both operands K-major
// from shared memory, D += A B.
template <>
struct Wgmma<64> {
  __device__ static void mma(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
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
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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
        "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
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

struct Unit {
  int tile_idx, row0, col0, type;
  bool valid;
};

// Work unit u: (tile, 128-row block, column pass), the passes of one row block adjacent.
template <int BN>
__device__ __forceinline__ Unit unit_of(long long u, int passes, int blocks_per_tile,
                                        const int* __restrict__ tile_types, int num_types) {
  const long long rb = u / passes;
  Unit w;
  w.col0 = static_cast<int>(u % passes) * BN;
  w.tile_idx = static_cast<int>(rb / blocks_per_tile);
  w.row0 = static_cast<int>(rb % blocks_per_tile) * kRows;
  w.type = __ldg(tile_types + w.tile_idx);
  w.valid = w.type >= 0 && w.type < num_types;
  return w;
}

template <int BN>
constexpr size_t bf16_smem_bytes() {
  return 1024 + kStages * (kABytes + BN * kDepth * 2) + kConsumers * 64 * BN * 2 + 2 * kStages * 8;
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
typed_matmul_bf16_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                         const __grid_constant__ CUtensorMap ymap, const int* __restrict__ tile_types,
                         long long num_tiles, int tile, int din, int m, int num_types) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sa = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sb = sa + kStages * kABytes;              // [kStages][BN][64] bf16, W^T rows
  uint8_t* se = sb + kStages * BN * kDepth * 2;      // [kConsumers][BN / 64][64][64] bf16, output staging
  uint64_t* full = reinterpret_cast<uint64_t*>(se + kConsumers * 64 * BN * 2);
  uint64_t* empty = full + kStages;

  const int box_rows = tile > 64 ? kRows : 64;
  const int blocks_per_tile = (tile + kRows - 1) / kRows;
  const int passes = (m + BN - 1) / BN;
  const int chunks = (din + kDepth - 1) / kDepth;
  const long long units = num_tiles * blocks_per_tile * passes;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // Producer warpgroup: one thread issues every load.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == kConsumers * 128) {
      const unsigned stage_bytes = box_rows * kDepth * 2 + BN * kDepth * 2;
      int stage = 0;
      unsigned phase = 0;
      for (long long u = blockIdx.x; u < units; u += gridDim.x) {
        const Unit w = unit_of<BN>(u, passes, blocks_per_tile, tile_types, num_types);
        if (!w.valid) continue;
        for (int kc = 0; kc < chunks; ++kc) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], stage_bytes);
          tma_load_3d(sa + stage * kABytes, &xmap, &full[stage], kc * kDepth, w.row0, w.tile_idx);
          tma_load_3d(sb + stage * BN * kDepth * 2, &wmap, &full[stage], kc * kDepth, w.col0, w.type);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // Consumer warpgroups: rows [wg * 64, wg * 64 + 64) of each unit.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    const bool lead = threadIdx.x % 128 == 0;
    const bool live = wg * 64 < box_rows;  // a tile of at most 64 rows leaves the second warpgroup idle
    uint8_t* eb = se + wg * 64 * BN * 2;
    float acc[BN / 2];
    int stage = 0;
    unsigned phase = 0;
    for (long long u = blockIdx.x; u < units; u += gridDim.x) {
      const Unit w = unit_of<BN>(u, passes, blocks_per_tile, tile_types, num_types);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
      fence_operands(acc);
      if (w.valid) {
        for (int kc = 0; kc < chunks; ++kc) {
          mbar_wait(&full[stage], phase);
          if (live) {
            const uint64_t da = sw128_desc(sa + stage * kABytes + wg * 64 * 128);
            const uint64_t db = sw128_desc(sb + stage * BN * kDepth * 2);
            asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
            for (int kk = 0; kk < kDepth / 16; ++kk) Wgmma<BN>::mma(acc, da + 2 * kk, db + 2 * kk);
            asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
            asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
            fence_operands(acc);
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[stage]);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
      if (!live || w.row0 + wg * 64 >= tile) continue;
      // Epilogue: round once to bf16 into the staging buffer, in the TMA's
      // 128-byte swizzle (64-column boxes of 64 rows), then store it.
      if (lead) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");  // the last store has read it
      named_barrier(1 + wg, 128);
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = warp * 16 + lane / 4 + 8 * h;
          const int chunk = (n % 8) ^ (r % 8);
          *reinterpret_cast<uint32_t*>(eb + (n / 8) * kBoxBytes + r * 128 + chunk * 16 + (lane % 4) * 4) =
              pack_bf16x2(acc[4 * n + 2 * h], acc[4 * n + 2 * h + 1]);
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_barrier(1 + wg, 128);
      if (lead) {
        for (int box = 0; box < BN / 64; ++box)
          if (w.col0 + box * 64 < m)
            tma_store_3d(&ymap, eb + box * kBoxBytes, w.col0 + box * 64, w.row0 + wg * 64, w.tile_idx);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
    if (lead) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// ---- float32: CUDA cores ----------------------------------------------------
constexpr int kFTile = 128;       // rows and columns of a CTA's output block
constexpr int kFDepth = 8;        // depth per stage, a multiple of 8
constexpr int kFThreads = 256;    // 16 x 16 threads, 8 x 8 outputs each
constexpr int kFLd = kFTile + 4;  // padded shared rows: 16-byte aligned, conflict-free transposed stores

__global__ void __launch_bounds__(kFThreads, 2)
typed_matmul_f32_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                        const int* __restrict__ tile_types, float* __restrict__ y, int tile,
                        int blocks_per_tile, int col_blocks, int din, int m, int num_types) {
  __shared__ __align__(16) float sa[2][kFDepth][kFLd];  // x rows, transposed: [k][row]
  __shared__ __align__(16) float sb[2][kFDepth][kFLd];  // W^T rows, transposed: [k][col]

  const long long rb = blockIdx.x / col_blocks;
  const int col0 = (blockIdx.x % col_blocks) * kFTile;
  const long long tile_idx = rb / blocks_per_tile;
  const int sub = static_cast<int>(rb % blocks_per_tile);
  const long long row0 = tile_idx * tile + (long long)sub * kFTile;
  const int rows = min(kFTile, tile - sub * kFTile);
  const int cols = min(kFTile, m - col0);
  const int type = __ldg(tile_types + tile_idx);
  const int t = threadIdx.x;
  if (type < 0 || type >= num_types) {
    for (int i = t; i < rows * (cols / 4); i += kFThreads) {
      const int r = i / (cols / 4);
      const int c = (i - r * (cols / 4)) * 4;
      *reinterpret_cast<float4*>(y + (row0 + r) * m + col0 + c) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }

  // Loads: thread t reads depths (t % 2) * 4 + 8j .. + 3 of row (and
  // column) t / 2 of the chunk as 16-byte loads of x and of W^T (a warp: 16
  // rows x 32 bytes, whole sectors), a chunk ahead of the compute, and stores
  // them transposed. Rows past the tile, columns past m and depth past din
  // read as zeros (din is a multiple of 4: a float4 lies wholly in or out).
  constexpr int kVecs = kFDepth / 8;
  const int lr = t / 2;
  const int lq = (t % 2) * 4;
  const bool row_ok = lr < rows;
  const bool col_ok = lr < cols;
  const float* xs = x + (row0 + (row_ok ? lr : 0)) * din + lq;
  const float* ws = wt + ((long long)type * m + col0 + (col_ok ? lr : 0)) * din + lq;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 xv[kVecs], wv[kVecs];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const bool k_ok = k0 + 8 * j + lq < din;
      xv[j] = row_ok && k_ok ? __ldg(reinterpret_cast<const float4*>(xs + k0 + 8 * j)) : zero;
      wv[j] = col_ok && k_ok ? __ldg(reinterpret_cast<const float4*>(ws + k0 + 8 * j)) : zero;
    }
  };
  auto put = [&](int stage) {
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const int k = 8 * j + lq;
      sa[stage][k + 0][lr] = xv[j].x;
      sa[stage][k + 1][lr] = xv[j].y;
      sa[stage][k + 2][lr] = xv[j].z;
      sa[stage][k + 3][lr] = xv[j].w;
      sb[stage][k + 0][lr] = wv[j].x;
      sb[stage][k + 1][lr] = wv[j].y;
      sb[stage][k + 2][lr] = wv[j].z;
      sb[stage][k + 3][lr] = wv[j].w;
    }
  };

  // Thread (ty, tx) owns rows ty*4 + {0..3} and 64 + ty*4 + {0..3}, and the
  // same pattern of columns with tx.
  const int ty = t / 16;
  const int tx = t % 16;
  auto fragments = [&](float (&a)[8], float (&b)[8], int stage, int kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(&sa[stage][kk][ty * 4]);
    const float4 a1 = *reinterpret_cast<const float4*>(&sa[stage][kk][64 + ty * 4]);
    const float4 b0 = *reinterpret_cast<const float4*>(&sb[stage][kk][tx * 4]);
    const float4 b1 = *reinterpret_cast<const float4*>(&sb[stage][kk][64 + tx * 4]);
    a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w; a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
    b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w; b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  const int chunks = (din + kFDepth - 1) / kFDepth;
  fetch(0);
  put(0);
  __syncthreads();
  for (int kc = 0; kc < chunks; ++kc) {
    const bool more = kc + 1 < chunks;
    if (more) fetch((kc + 1) * kFDepth);  // in flight during this chunk's products
    const int s = kc & 1;
    float a[2][8], b[2][8];
    fragments(a[0], b[0], s, 0);
#pragma unroll
    for (int kk = 0; kk < kFDepth; ++kk) {
      if (kk + 1 < kFDepth) fragments(a[(kk + 1) & 1], b[(kk + 1) & 1], s, kk + 1);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[kk & 1][i], b[kk & 1][j], acc[i][j]);
    }
    if (more) put(s ^ 1);  // that stage's last readers passed the previous barrier
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = (i < 4 ? 0 : 64) + ty * 4 + (i % 4);
    if (r >= rows) continue;
    float* yr = y + (row0 + r) * m + col0;
    if (tx * 4 < cols)
      *reinterpret_cast<float4*>(yr + tx * 4) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    if (64 + tx * 4 < cols)
      *reinterpret_cast<float4*>(yr + 64 + tx * 4) = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
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

// A bf16 [d2, d1, d0] row-major tensor (d0 contiguous) as a 3-D TMA map with
// boxes of b1 x 64 and the 128-byte swizzle; out-of-bounds elements read as
// zero and are not written.
bool bf16_map(CUtensorMap* map, const void* base, uint64_t d0, uint64_t d1, uint64_t d2, uint32_t b1) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * 2, d0 * d1 * 2};
  const cuuint32_t box[3] = {64, b1, 1};
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
int launch_bf16(const void* x, const void* wt, const int* tile_types, void* y, long long num_tiles, int tile,
                int din, int m, int num_types, cudaStream_t stream) {
  constexpr size_t smem = bf16_smem_bytes<BN>();
  // The opt-in holds for the current device only: once per instantiation
  // and device, at the first launch on each card (before any capture).
  // Two threads that race on a card both set the same attribute.
  static std::atomic<int> configured[kMaxDevices];  // 0: not yet, else the opt-in's error + 1
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  int state = configured[dev].load();
  if (state == 0) {
    state = 1 + static_cast<int>(cudaFuncSetAttribute(typed_matmul_bf16_kernel<BN>,
                                                      cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                      static_cast<int>(smem)));
    configured[dev].store(state);
  }
  if (state != 1) return state - 1;
  CUtensorMap xmap, wmap, ymap;
  if (!bf16_map(&xmap, x, din, tile, num_tiles, tile > 64 ? kRows : 64) ||
      !bf16_map(&wmap, wt, din, m, num_types, BN) || !bf16_map(&ymap, y, m, tile, num_tiles, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long units = num_tiles * ((tile + kRows - 1) / kRows) * ((m + BN - 1) / BN);
  const long long grid = units < sm_count() ? units : sm_count();
  typed_matmul_bf16_kernel<BN><<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(
      xmap, wmap, ymap, tile_types, num_tiles, tile, din, m, num_types);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* ptgnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16. x: [num_tiles * tile, din]; wt: [num_types,
// m, din], the weight stack transposed; tile_types: [num_tiles] int32; y:
// [num_tiles * tile, m]; all contiguous, 16-byte aligned, din and m multiples
// of 8 (bf16) or 4 (f32). Returns cudaGetLastError() after the launch (0 =
// success).
extern "C" int ptgnn_typed_matmul(const void* x, const void* wt, const void* tile_types, void* y, int dtype,
                                  long long num_tiles, int tile, int din, int m, int num_types, void* stream) {
  const int vec = dtype == 1 ? 8 : 4;
  if ((dtype != 0 && dtype != 1) || tile <= 0 || din <= 0 || m <= 0 || num_types <= 0 || din % vec ||
      m % vec || num_tiles < 0 || num_tiles > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_tiles == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tt = static_cast<const int*>(tile_types);
  if (dtype == 1) {
    if (m <= 64) return launch_bf16<64>(x, wt, tt, y, num_tiles, tile, din, m, num_types, s);
    if (m <= 128) return launch_bf16<128>(x, wt, tt, y, num_tiles, tile, din, m, num_types, s);
    return launch_bf16<256>(x, wt, tt, y, num_tiles, tile, din, m, num_types, s);
  }
  const int blocks_per_tile = (tile + kFTile - 1) / kFTile;
  const int col_blocks = (m + kFTile - 1) / kFTile;
  const long long grid = num_tiles * blocks_per_tile * col_blocks;
  if (grid > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  typed_matmul_f32_kernel<<<static_cast<unsigned>(grid), kFThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(wt), tt, static_cast<float*>(y), tile,
      blocks_per_tile, col_blocks, din, m, num_types);
  return static_cast<int>(cudaGetLastError());
}
