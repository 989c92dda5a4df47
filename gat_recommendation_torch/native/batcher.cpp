// The session-graph batch engine of the PyTorch port (C ABI, loaded with
// ctypes by gat_recommendation_torch/data/native.py, which builds it at first
// use with g++ -O3 -march=native). A copy of the JAX package's engine: the
// same inner loops and the same SplitMix64 negative stream, so the two
// packages assemble the same batches bit for bit.
//
// Semantics mirror data/batching.py's numpy engine:
//   * nodes = ascending unique context item ids, truncated to bucket_n;
//   * edges = CSR rows intersected with the node set, adj[dst][src] = 1;
//   * negatives drawn uniformly from [1, num_items) excluding ALL session
//     items (context + target), via rejection sampling;
//   * batch padding slots stay zero with sample_mask = 0.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// SplitMix64 — deterministic, seedable, no global state.
static inline uint64_t splitmix64(uint64_t* s) {
  uint64_t z = (*s += 0x9e3779b97f4a7c15ULL);
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
  return z ^ (z >> 31);
}

// Build CSR from directed edges. indptr: [num_items+1]; indices: [n_edges].
// Caller passes edges in any order; output rows are sorted.
void build_csr(const int64_t* item_i, const int64_t* item_j, int64_t n_edges,
               int64_t num_items, int64_t* indptr, int32_t* indices) {
  std::memset(indptr, 0, sizeof(int64_t) * (num_items + 1));
  for (int64_t e = 0; e < n_edges; ++e) indptr[item_i[e] + 1]++;
  for (int64_t v = 0; v < num_items; ++v) indptr[v + 1] += indptr[v];
  // Temporary write cursors.
  int64_t* cursor = new int64_t[num_items];
  std::memcpy(cursor, indptr, sizeof(int64_t) * num_items);
  for (int64_t e = 0; e < n_edges; ++e)
    indices[cursor[item_i[e]]++] = static_cast<int32_t>(item_j[e]);
  delete[] cursor;
  for (int64_t v = 0; v < num_items; ++v)
    std::sort(indices + indptr[v], indices + indptr[v + 1]);
}

// Assemble one fixed-shape batch.
//
// items_all/offsets_all: the DATASET's flat item array + per-session offsets
// (already truncated to max_session_length); sess_idx[0..n_sel) selects the
// sessions filling batch slots 0..n_sel (slots >= n_sel are padding). The
// last item of each session is the target, the rest are context. Indexing
// the dataset arrays here (rather than having Python copy each session into
// a per-batch buffer) removes ~2 ms/batch of Python slice overhead at
// B=512.
//
// Outputs (pre-allocated by the caller, zero-filled here):
//   node_ids   [B, bucket_n] int32
//   node_mask  [B, bucket_n] uint8
//   adj        [B, bucket_n, bucket_n] uint8   (adj[dst][src])
//   num_nodes  [B] int32
//   targets    [B] int32
//   negatives  [B, num_negatives] int32
//   sample_mask[B] uint8
//
// slot_offset keys the per-slot negative RNG by GLOBAL batch slot
// (slot_offset + b): in multi-host feeding each process assembles rows
// [p*local, (p+1)*local) of every global batch, and offsetting here makes
// the concatenation of all processes' local batches bit-identical to a
// single-process assembly of the full batch. Single-process callers pass 0.
void assemble_batch(
    const int64_t* items_all, const int64_t* offsets_all,
    const int64_t* sess_idx, int64_t n_sel, int64_t batch_size,
    const int64_t* indptr, const int32_t* indices, int64_t num_items,
    int64_t bucket_n, int64_t num_negatives, uint64_t seed,
    int64_t slot_offset,
    int32_t* node_ids, uint8_t* node_mask, uint8_t* adj, int32_t* num_nodes,
    int32_t* targets, int32_t* negatives, uint8_t* sample_mask) {
  const int64_t NN = bucket_n * bucket_n;
  std::memset(node_ids, 0, sizeof(int32_t) * batch_size * bucket_n);
  std::memset(node_mask, 0, batch_size * bucket_n);
  std::memset(adj, 0, batch_size * NN);
  std::memset(num_nodes, 0, sizeof(int32_t) * batch_size);
  std::memset(targets, 0, sizeof(int32_t) * batch_size);
  std::memset(negatives, 0, sizeof(int32_t) * batch_size * num_negatives);
  std::memset(sample_mask, 0, batch_size);

  // Scratch buffers sized to the longest SELECTED session (fixed stack
  // arrays would overflow for long --max-session-length). One heap
  // allocation per batch call is noise next to the assembly work itself.
  int64_t max_len = 1;
  for (int64_t b = 0; b < n_sel && b < batch_size; ++b) {
    const int64_t l = offsets_all[sess_idx[b] + 1] - offsets_all[sess_idx[b]];
    if (l > max_len) max_len = l;
  }
  std::vector<int64_t> session_vec(max_len), uniq_vec(max_len);
  int64_t* session_buf = session_vec.data();
  int64_t* uniq = uniq_vec.data();

  for (int64_t b = 0; b < n_sel && b < batch_size; ++b) {
    const int64_t start = offsets_all[sess_idx[b]];
    const int64_t end = offsets_all[sess_idx[b] + 1];
    const int64_t* items = items_all;  // global offsets index the flat array
    const int64_t len = end - start;
    if (len <= 0) continue;  // padding slot
    sample_mask[b] = 1;
    targets[b] = static_cast<int32_t>(items[end - 1]);

    // Sorted-unique context (everything but the last event).
    const int64_t clen = len - 1;
    for (int64_t i = 0; i < clen; ++i) session_buf[i] = items[start + i];
    std::sort(session_buf, session_buf + clen);
    int64_t n = std::unique(session_buf, session_buf + clen) - session_buf;
    if (n > bucket_n) n = bucket_n;
    num_nodes[b] = static_cast<int32_t>(n);
    for (int64_t i = 0; i < n; ++i) {
      node_ids[b * bucket_n + i] = static_cast<int32_t>(session_buf[i]);
      node_mask[b * bucket_n + i] = 1;
    }

    // Induced edges, per-row adaptive strategy: a source u with a short CSR
    // row scans the row and binary-searches each neighbor in the node set
    // (O(deg log n)); a POPULAR u (Zipf catalogs produce rows with 10k+
    // neighbors) instead binary-searches each of the <= n session nodes in
    // its sorted row (O(n log deg)). Without the switch, every session
    // containing a head item paid its full degree — the dominant assembly
    // cost at reference scale.
    uint8_t* A = adj + b * NN;
    for (int64_t u_local = 0; u_local < n; ++u_local) {
      const int64_t u = session_buf[u_local];
      const int64_t rs = indptr[u], re = indptr[u + 1];
      if (re - rs > 4 * n) {
        for (int64_t v_local = 0; v_local < n; ++v_local) {
          const int32_t v = static_cast<int32_t>(session_buf[v_local]);
          if (std::binary_search(indices + rs, indices + re, v))
            A[v_local * bucket_n + u_local] = 1;  // adj[dst][src]
        }
      } else {
        for (int64_t p = rs; p < re; ++p) {
          const int64_t v = indices[p];
          const int64_t* hit =
              std::lower_bound(session_buf, session_buf + n, v);
          if (hit != session_buf + n && *hit == v) {
            const int64_t v_local = hit - session_buf;
            A[v_local * bucket_n + u_local] = 1;  // adj[dst][src]
          }
        }
      }
    }

    // Negatives: rejection sample from [1, num_items) excluding the full
    // session (context + target). Sessions are tiny; linear scan of uniq.
    // Bounded attempts guard termination when num_items <= 1 or the session
    // covers nearly the whole catalog (tiny test datasets) — after the cap,
    // in-session negatives are permitted (matches the numpy engine's
    // sample_negatives fallback, data/batching.py).
    int64_t m = 0;
    for (int64_t i = 0; i < len; ++i) uniq[m++] = items[start + i];
    std::sort(uniq, uniq + m);
    m = std::unique(uniq, uniq + m) - uniq;

    uint64_t rng = seed ^ (0x9e3779b97f4a7c15ULL * (uint64_t)(slot_offset + b + 1));
    int64_t got = 0;
    if (num_items > 1) {
      int64_t attempts = 0;
      const int64_t max_attempts = 128 * num_negatives;
      while (got < num_negatives && attempts < max_attempts) {
        ++attempts;
        const int64_t cand = 1 + (int64_t)(splitmix64(&rng) % (uint64_t)(num_items - 1));
        const int64_t* hit = std::lower_bound(uniq, uniq + m, cand);
        if (hit != uniq + m && *hit == cand) continue;
        negatives[b * num_negatives + got++] = static_cast<int32_t>(cand);
      }
      while (got < num_negatives) {  // degenerate catalog fallback
        const int64_t cand = 1 + (int64_t)(splitmix64(&rng) % (uint64_t)(num_items - 1));
        negatives[b * num_negatives + got++] = static_cast<int32_t>(cand);
      }
    }  // num_items <= 1: negatives stay 0 (padding id, masked downstream)
  }
}

}  // extern "C"
