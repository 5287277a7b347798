// Segment sum over the batch's edge slots, row by row.
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
// rate; the least time is the real slots' data rows, their slot ids and the
// row offsets read once plus the [n_rows, D] float32 output written once.
//
// Design (row_reduce.cuh). The TPU kernel keeps a row block's [R, D] sum
// resident while its sequential grid walks the block's tiles. The first
// Hopper version kept it per CTA in shared memory: each warp walked every slot
// of its part of the block's tiles, kept the eighth whose rows it owned and
// added them one at a time (latency-bound), and to fill the card the tiles
// were split into parts whose [n_rows, D] float32 partials a second kernel
// added (at D = 64 more bytes than the input). Here the batch's row index
// (row_offsets, row_slots; built once per batch on the host) lists each
// row's slots in increasing slot order, and each (row, column chunk) is
// summed on its own by a group of lanes, starting from +0.0 and adding the
// slots in that order, with eight slot loads in flight per lane: one launch,
// no shared memory, no partial buffers. Each output element is one float32
// chain in slot order, so the result is the same bits on every run and the
// bits of index_add_ on the CPU, which adds in index order. Rows longer than
// the chunk are split into pieces whose partials the last piece to finish
// adds in piece order: deterministic, within float32 rounding of the
// sequential sum.
#include "row_reduce.cuh"

namespace {

template <typename T, int V>
__global__ void __launch_bounds__(row_reduce::kThreads)
segment_sum_kernel(row_reduce::Args a, int group_log2, int col_chunks) {
  row_reduce::row_reduce<row_reduce::Sum, T, V>(a, group_log2, col_chunks);
}

}  // namespace

extern "C" const char* ptgnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16. data: [e_pad, d]; row_offsets: [n_plan_rows
// + 1] int32; row_slots, local_rows: [e_pad] int32; tile_row_blocks: [e_pad /
// tile] int32; out: [n_rows, d] float32 (n_rows <= n_plan_rows). partials:
// float32 scratch of partial_capacity elements; counters: int32 scratch of
// counter_capacity elements, all 0, which the kernel leaves at 0. Rows of more
// than `chunk` slots are split. Returns cudaGetLastError() after the launch
// (0 = success).
extern "C" int ptgnn_segment_sum(const void* data, int dtype, const void* row_offsets,
                                 const void* row_slots, const void* local_rows,
                                 const void* tile_row_blocks, void* out, void* partials,
                                 long long partial_capacity, void* counters,
                                 long long counter_capacity, long long n_rows, long long e_pad,
                                 int tile, int r, int d, int chunk, void* stream) {
  const row_reduce::Args a{data,
                           static_cast<const int*>(row_offsets),
                           static_cast<const int*>(row_slots),
                           static_cast<const int*>(local_rows),
                           static_cast<const int*>(tile_row_blocks),
                           nullptr,
                           static_cast<float*>(out),
                           nullptr,
                           static_cast<float*>(partials),
                           nullptr,
                           static_cast<unsigned*>(counters),
                           n_rows, e_pad, tile, r, d, chunk};
  return row_reduce::launch(
      a, dtype, partial_capacity, counter_capacity, static_cast<cudaStream_t>(stream),
      [&](int dt, row_reduce::Geometry geo, unsigned blocks, cudaStream_t s) {
        const int t = row_reduce::kThreads;
        const int lg = geo.group_log2, cc = geo.col_chunks;
        if (dt == 0 && geo.v == 4) segment_sum_kernel<float, 4><<<blocks, t, 0, s>>>(a, lg, cc);
        else if (dt == 0) segment_sum_kernel<float, 1><<<blocks, t, 0, s>>>(a, lg, cc);
        else if (geo.v == 4) segment_sum_kernel<__nv_bfloat16, 4><<<blocks, t, 0, s>>>(a, lg, cc);
        else segment_sum_kernel<__nv_bfloat16, 1><<<blocks, t, 0, s>>>(a, lg, cc);
      });
}
