// The host layout assembler of ptgnn_tpu_torch/graph/batching.py in C++:
// raw edge arrays -> the unified (receiver row block, edge type, receiver)
// layout with every (block, type) segment padded to a tile multiple and
// every block's run padded to the supertile alignment, in one pass (a
// counting sort by (block, type), then a stable sort of each bucket by
// receiver). Bitwise the numpy assembler's output, which stays as the
// oracle (tests/test_torch_native_assembler.py).
//
// Plain C ABI, loaded with ctypes by ptgnn_tpu_torch/native/__init__.py,
// which validates every id before the call: nothing here checks ranges.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Returns 0 on success, -1 if the edges exceed the e_pad slot budget.
// Inputs: senders/receivers/types/pair_ids [num_edges] (pair_ids are the
// forward/backward pair numbers, -1 for self edges, carried through the sort
// as the senders are). Outputs (caller-allocated): senders, receivers,
// types, local_rows, mask (uint8) and pair_ids [e_pad]; tile_types and
// tile_row_blocks [e_pad / tile]; counts [num_blocks * agg_rows].
int ptgnn_assemble_edge_layout(
    const int32_t* senders, const int32_t* receivers, const int32_t* types, const int32_t* pair_ids,
    int64_t num_edges, int32_t max_nodes, int64_t e_pad, int32_t tile, int32_t agg_rows, int32_t num_types,
    int32_t align,
    int32_t* out_senders, int32_t* out_receivers, int32_t* out_types, int32_t* out_local_rows,
    uint8_t* out_mask, int32_t* out_tile_types, int32_t* out_tile_row_blocks, int32_t* out_counts,
    int32_t* out_pair_ids) {
  const int32_t num_blocks = (max_nodes + agg_rows - 1) / agg_rows;
  const int64_t n_tiles = e_pad / tile;
  const int64_t num_buckets = static_cast<int64_t>(num_blocks) * num_types;
  if (align < tile) align = tile;

  // Bucket = block * num_types + type: a counting sort.
  std::vector<int64_t> bucket_count(num_buckets, 0);
  std::vector<int64_t> edge_bucket(num_edges);
  for (int64_t i = 0; i < num_edges; ++i) {
    edge_bucket[i] = static_cast<int64_t>(receivers[i] / agg_rows) * num_types + types[i];
    ++bucket_count[edge_bucket[i]];
  }

  // Slot offsets, block by block: each non-empty bucket padded to a tile
  // multiple (its type fills the tail too: tiles are type-pure), each
  // block's run padded to the alignment (an empty block gets one run).
  std::vector<int64_t> bucket_offset(num_buckets, -1);
  std::memset(out_types, 0, sizeof(int32_t) * e_pad);
  int64_t cursor = 0;
  int64_t tile_cursor = 0;
  for (int32_t b = 0; b < num_blocks; ++b) {
    const int64_t block_start = cursor;
    for (int32_t t = 0; t < num_types; ++t) {
      const int64_t k = static_cast<int64_t>(b) * num_types + t;
      if (bucket_count[k] == 0) continue;
      const int64_t seg = (bucket_count[k] + tile - 1) / tile * tile;
      if (cursor + seg > e_pad) return -1;
      bucket_offset[k] = cursor;
      for (int64_t j = 0; j < seg / tile; ++j) {
        out_tile_types[tile_cursor + j] = t;
        out_tile_row_blocks[tile_cursor + j] = b;
      }
      for (int64_t j = 0; j < seg; ++j) out_types[cursor + j] = t;
      cursor += seg;
      tile_cursor += seg / tile;
    }
    const int64_t run = std::max<int64_t>(cursor - block_start, 1);
    const int64_t target = block_start + (run + align - 1) / align * align;
    if (target > e_pad) return -1;
    for (; cursor < target; cursor += tile, ++tile_cursor) {
      out_tile_types[tile_cursor] = 0;
      out_tile_row_blocks[tile_cursor] = b;
    }
  }
  // Trailing spare tiles continue the last row block (all padding).
  for (int64_t j = tile_cursor; j < n_tiles; ++j) {
    out_tile_types[j] = 0;
    out_tile_row_blocks[j] = num_blocks - 1;
  }

  // Padding slots: sender 0, receiver max_nodes, local row agg_rows, pair -1.
  std::memset(out_senders, 0, sizeof(int32_t) * e_pad);
  std::memset(out_mask, 0, e_pad);
  std::fill(out_receivers, out_receivers + e_pad, max_nodes);
  std::fill(out_local_rows, out_local_rows + e_pad, agg_rows);
  std::fill(out_pair_ids, out_pair_ids + e_pad, -1);

  // Scatter the edges into their buckets in input order, then sort each
  // bucket by receiver, stably (numpy's lexsort order).
  struct Edge { int32_t recv, send, pair; };
  std::vector<int64_t> fill(num_buckets, 0);
  std::vector<Edge> sorted(num_edges);
  // The buckets packed densely in `sorted`: starts are the counts' prefix sums.
  std::vector<int64_t> dense_start(num_buckets + 1, 0);
  for (int64_t k = 0; k < num_buckets; ++k) dense_start[k + 1] = dense_start[k] + bucket_count[k];
  for (int64_t i = 0; i < num_edges; ++i) {
    const int64_t k = edge_bucket[i];
    sorted[dense_start[k] + fill[k]++] = {receivers[i], senders[i], pair_ids[i]};
  }
  for (int64_t k = 0; k < num_buckets; ++k) {
    if (bucket_count[k] == 0) continue;
    Edge* first = sorted.data() + dense_start[k];
    Edge* last = first + bucket_count[k];
    std::stable_sort(first, last, [](const Edge& a, const Edge& b) { return a.recv < b.recv; });
    const int32_t block_base = static_cast<int32_t>(k / num_types) * agg_rows;
    int64_t slot = bucket_offset[k];
    for (const Edge* e = first; e != last; ++e, ++slot) {
      out_senders[slot] = e->send;
      out_receivers[slot] = e->recv;
      out_pair_ids[slot] = e->pair;
      out_local_rows[slot] = e->recv - block_base;
      out_mask[slot] = 1;
    }
  }

  // In-degrees.
  std::memset(out_counts, 0, sizeof(int32_t) * num_blocks * agg_rows);
  for (int64_t i = 0; i < num_edges; ++i) ++out_counts[receivers[i]];
  return 0;
}

}  // extern "C"
