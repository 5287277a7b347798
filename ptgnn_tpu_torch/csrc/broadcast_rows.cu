// Receiver broadcast: out[e] = table[tile_row_blocks[e / tile] * R + local_rows[e]],
// with 0 at sentinel slots (local_rows[e] == R) and at rows past the table.
//
// Replaces ptgnn_tpu/ops/pallas/segment_kernels.py::_broadcast_kernel (the
// one-hot-matmul row selection launched by planned_broadcast_to_edges).
//
// Bound: bytes. The work is a pure row copy (no arithmetic), so the least
// time is (table + indices read once + edge rows written once) over the
// memory rate. Design: a grid-stride loop in which each thread moves 16 B
// of one row (a uint4), so a warp moves whole rows with 16-byte loads and
// stores on neighbouring addresses, for any element type whose row is a
// multiple of 16 B (f32 and bf16 at D = 64 and 128). The table rows of one
// row block are reused by every slot of that block, so they stay in L2 and
// the traffic to device memory is dominated by the edge rows written.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void broadcast_rows_kernel(const uint4* __restrict__ table,
                                      const int* __restrict__ local_rows,
                                      const int* __restrict__ tile_row_blocks,
                                      uint4* __restrict__ out, long long total_vecs,
                                      int vecs_per_row, int tile, int rows_per_block,
                                      long long n_rows) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total_vecs;
       i += stride) {
    const long long e = i / vecs_per_row;
    const int c = (int)(i - e * vecs_per_row);
    const int lr = __ldg(local_rows + e);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (lr >= 0 && lr < rows_per_block) {
      const long long src = (long long)__ldg(tile_row_blocks + e / tile) * rows_per_block + lr;
      if (src < n_rows) v = __ldg(table + src * vecs_per_row + c);
    }
    out[i] = v;
  }
}

}  // namespace

extern "C" const char* ptgnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// table: [n_rows, row_bytes] of any element type; out: [num_slots, row_bytes].
// Returns cudaGetLastError() after the launch (0 = success).
extern "C" int ptgnn_broadcast_rows(const void* table, const void* local_rows,
                                    const void* tile_row_blocks, void* out,
                                    long long num_slots, int row_bytes, int tile,
                                    int rows_per_block, long long n_rows, void* stream) {
  if (row_bytes <= 0 || row_bytes % 16 != 0 || tile <= 0 || rows_per_block <= 0 ||
      num_slots % tile != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_slots == 0) return static_cast<int>(cudaSuccess);
  const int vecs_per_row = row_bytes / 16;
  const long long total = num_slots * vecs_per_row;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132LL * 16) blocks = 132LL * 16;  // grid-stride beyond 16 blocks per SM
  broadcast_rows_kernel<<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(table), static_cast<const int*>(local_rows),
      static_cast<const int*>(tile_row_blocks), static_cast<uint4*>(out), total, vecs_per_row,
      tile, rows_per_block, n_rows);
  return static_cast<int>(cudaGetLastError());
}
