// Segment max/min over the batch's edge slots, row by row.
//
// Replaces ptgnn_tpu/ops/pallas/segment_kernels.py::_extremum_kernel
// (launched by _run_kernel for planned_segment_extremum).
//
// Semantics: out[g] = max (or min) over the slots e with
// tile_row_blocks[e / tile] * R + local_rows[e] == g of data[e], accumulated
// in float32 from an initial +-3e38; sentinel slots belong to no row. Rows
// with agg_counts[g] == 0 or |out| >= 1.5e38 become 0 (the torch-scatter
// empty-segment fill), and every value gets + 0.0f so -0.0 reads as +0.0,
// which the TPU kernel's selection matmul also produces.
//
// Bound: bytes. One comparison per input element is far below the card's
// arithmetic rate; the least time is the real slots' data rows, their slot
// ids, the row offsets and the counts read once plus the [N, M] float32
// output written once.
//
// Design (row_reduce.cuh). The TPU kernel carries a row block's [R, M]
// output across its sequential grid. The first Hopper version copied that:
// a CTA per row block (32 CTAs on 132 SMs at the bench layout) walked the
// block's tiles one after another, with five barriers and a one-thread
// prefix per tile, and one thread folded a receiver's run slot by slot. A
// maximum does not depend on the order of its inputs, so no tile walk is
// needed: the batch's row index (row_offsets, row_slots; built once per
// batch on the host) lists each row's slots, and each (row, column chunk)
// is folded on its own by a group of lanes (16 at M = 64, a warp at M =
// 128) with eight slot loads in flight per lane, in float32 registers: no
// shared memory, no barrier, one launch and nothing computed per launch on
// the host. The result equals the plain version bit for bit. Rows longer
// than the chunk are split over several groups and their pieces combined by
// the last one to finish.
#include "row_reduce.cuh"

namespace {

template <class Op, typename T, int V>
__global__ void __launch_bounds__(row_reduce::kThreads)
segment_extremum_kernel(row_reduce::Args a, int group_log2, int col_chunks) {
  row_reduce::row_reduce<Op, T, V>(a, group_log2, col_chunks);
}

template <class Op>
int launch(const row_reduce::Args& a, int dtype, long long partial_capacity,
           long long counter_capacity, cudaStream_t stream) {
  return row_reduce::launch(
      a, dtype, partial_capacity, counter_capacity, stream,
      [&](int dt, row_reduce::Geometry geo, unsigned blocks, cudaStream_t s) {
        const int t = row_reduce::kThreads;
        const int lg = geo.group_log2, cc = geo.col_chunks;
        if (dt == 0 && geo.v == 4) segment_extremum_kernel<Op, float, 4><<<blocks, t, 0, s>>>(a, lg, cc);
        else if (dt == 0) segment_extremum_kernel<Op, float, 1><<<blocks, t, 0, s>>>(a, lg, cc);
        else if (geo.v == 4) segment_extremum_kernel<Op, __nv_bfloat16, 4><<<blocks, t, 0, s>>>(a, lg, cc);
        else segment_extremum_kernel<Op, __nv_bfloat16, 1><<<blocks, t, 0, s>>>(a, lg, cc);
      });
}

}  // namespace

extern "C" const char* ptgnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16. data: [e_pad, m]; row_offsets: [n_plan_rows
// + 1] int32; row_slots, local_rows: [e_pad] int32; tile_row_blocks: [e_pad /
// tile] int32; agg_counts: [n_plan_rows] int32; out: [n_rows, m] float32
// (n_rows <= n_plan_rows). partials: float32 scratch of partial_capacity
// elements; counters: int32 scratch of counter_capacity elements, all 0, which
// the kernel leaves at 0. Rows of more than `chunk` slots are split. Returns
// cudaGetLastError() after the launch (0 = success).
extern "C" int ptgnn_segment_extremum(const void* data, int dtype, int is_max,
                                      const void* row_offsets, const void* row_slots,
                                      const void* local_rows, const void* tile_row_blocks,
                                      const void* agg_counts, void* out, void* partials,
                                      long long partial_capacity, void* counters,
                                      long long counter_capacity, long long n_rows,
                                      long long e_pad, int tile, int r, int m, int chunk,
                                      void* stream) {
  if (agg_counts == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const row_reduce::Args a{data,
                           static_cast<const int*>(row_offsets),
                           static_cast<const int*>(row_slots),
                           static_cast<const int*>(local_rows),
                           static_cast<const int*>(tile_row_blocks),
                           static_cast<const int*>(agg_counts),
                           static_cast<float*>(out),
                           nullptr,
                           static_cast<float*>(partials),
                           nullptr,
                           static_cast<unsigned*>(counters),
                           n_rows, e_pad, tile, r, m, chunk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_max ? launch<row_reduce::Max>(a, dtype, partial_capacity, counter_capacity, s)
                : launch<row_reduce::Min>(a, dtype, partial_capacity, counter_capacity, s);
}
