// Segment max/min with the first winning slot, over the batch's edge slots,
// row by row.
//
// Replaces ptgnn_tpu/ops/pallas/segment_kernels.py::_extremum_argmax_kernel
// (launched by planned_segment_extremum_with_argmax).
//
// Semantics: for every plan row g and column c, out_val[g, c] = max (or min)
// over the slots e with tile_row_blocks[e / tile] * R + local_rows[e] == g of
// data[e, c], compared in float32 from an initial +-3e38, and out_arg[g, c] =
// the smallest such slot e attaining it (int32); sentinel slots (local_rows
// == R) belong to no row. Rows with agg_counts[g] == 0 or |out_val| >= 1.5e38
// give value 0 and arg -1. -0.0 and +0.0 compare equal, so the earlier slot
// wins between them, and every value gets + 0.0f so -0.0 reads as +0.0 (as
// the segment extremum kernel does). NaN inputs never win.
//
// Bound: bytes. One comparison per input element is far below the card's
// arithmetic rate; the least time is the real slots' data rows, their slot
// ids, the row offsets and the counts read once plus the [N, M] float32
// values and int32 slots written once.
//
// Design (row_reduce.cuh, as the segment extremum). The first Hopper version
// carried the TPU kernel's sequential walk over a row block's tiles: a CTA
// per (row block, 16 columns), 32 KB of shared state, four barriers and a
// ballot scan per tile, and a searchsorted + arange on the host side of
// every call to find each block's tiles. The batch's row index lists each
// row's slots in increasing order, so a group of lanes owns a (row, column
// chunk) and walks its slots with eight loads in flight per lane, keeping a
// float32 value and an int32 slot per column in registers and replacing
// them only on a strict compare: the first occurrence wins, as in the plain
// version. Rows longer than the chunk are split into pieces whose (value,
// slot) partials the last piece folds in piece order with the same strict
// compare, so an earlier piece wins a tie and the result is the plain
// version's on every run. No shared memory, no barrier, one launch a call.
#include "row_reduce.cuh"

namespace {

template <class Op, typename T, int V>
__global__ void __launch_bounds__(row_reduce::kThreads)
segment_extremum_argmax_kernel(row_reduce::Args a, int group_log2, int col_chunks) {
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
        if (dt == 0 && geo.v == 4) segment_extremum_argmax_kernel<Op, float, 4><<<blocks, t, 0, s>>>(a, lg, cc);
        else if (dt == 0) segment_extremum_argmax_kernel<Op, float, 1><<<blocks, t, 0, s>>>(a, lg, cc);
        else if (geo.v == 4) segment_extremum_argmax_kernel<Op, __nv_bfloat16, 4><<<blocks, t, 0, s>>>(a, lg, cc);
        else segment_extremum_argmax_kernel<Op, __nv_bfloat16, 1><<<blocks, t, 0, s>>>(a, lg, cc);
      });
}

}  // namespace

extern "C" const char* ptgnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16. data: [e_pad, m]; row_offsets: [n_plan_rows
// + 1] int32; row_slots, local_rows: [e_pad] int32; tile_row_blocks: [e_pad /
// tile] int32; agg_counts: [n_plan_rows] int32; out_val: [n_rows, m] float32;
// out_arg: [n_rows, m] int32 (n_rows <= n_plan_rows). partials: float32 and
// partial_slots: int32 scratch of partial_capacity elements each; counters:
// int32 scratch of counter_capacity elements, all 0, which the kernel leaves
// at 0. Rows of more than `chunk` slots are split. Returns cudaGetLastError()
// after the launch (0 = success).
extern "C" int ptgnn_segment_extremum_argmax(const void* data, int dtype, int is_max,
                                             const void* row_offsets, const void* row_slots,
                                             const void* local_rows, const void* tile_row_blocks,
                                             const void* agg_counts, void* out_val, void* out_arg,
                                             void* partials, void* partial_slots,
                                             long long partial_capacity, void* counters,
                                             long long counter_capacity, long long n_rows,
                                             long long e_pad, int tile, int r, int m, int chunk,
                                             void* stream) {
  if (agg_counts == nullptr || out_arg == nullptr || partial_slots == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const row_reduce::Args a{data,
                           static_cast<const int*>(row_offsets),
                           static_cast<const int*>(row_slots),
                           static_cast<const int*>(local_rows),
                           static_cast<const int*>(tile_row_blocks),
                           static_cast<const int*>(agg_counts),
                           static_cast<float*>(out_val),
                           static_cast<int*>(out_arg),
                           static_cast<float*>(partials),
                           static_cast<int*>(partial_slots),
                           static_cast<unsigned*>(counters),
                           n_rows, e_pad, tile, r, m, chunk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_max ? launch<row_reduce::ArgMax>(a, dtype, partial_capacity, counter_capacity, s)
                : launch<row_reduce::ArgMin>(a, dtype, partial_capacity, counter_capacity, s);
}
