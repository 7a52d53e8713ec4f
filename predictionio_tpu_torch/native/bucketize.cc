// Native ratings bucketizer: COO triples -> padded per-row slabs.
//
// The host-side data-prep hot path for the ALS engine (ops/als.py
// bucket_rows): groups ratings by row, caps heavy rows keeping their
// top-valued entries, and packs each power-of-`growth` degree class
// into dense (n, pad_len) slabs. The Python/NumPy implementation loops
// per unique row (~|users| Python iterations at MovieLens-20M scale);
// this does one counting sort + one packing pass in C, O(nnz).
//
// Handle-based C API (ctypes, see native/__init__.py load_bucketize):
//   h  = pio_bucketize(nnz, rows, cols, vals, num_rows, min_len, growth,
//                      max_len)
//   nb = pio_bucketize_num_buckets(h)
//   pio_bucketize_bucket_info(h, b, &pad_len, &n)
//   pio_bucketize_fill(h, b, row_ids_out, cols_out, vals_out, deg_out)
//   pio_bucketize_free(h)
// Output buffers are caller(NumPy)-allocated; fill packs entries to the
// row prefix (cols/vals zero-padded past deg), matching the Python
// layout contract in ops/als.Bucket.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <memory>
#include <vector>

namespace {

struct RowRef {
    int64_t start;   // offset into the row-sorted order
    int32_t row_id;
    int32_t count;   // raw degree
    int32_t kept;    // capped degree
};

struct BucketPlan {
    int32_t pad_len;
    std::vector<int64_t> row_refs;  // indices into rows_
};

struct Bucketizer {
    std::vector<int64_t> order;     // nnz entries sorted by row (stable)
    std::vector<RowRef> rows_;
    std::vector<BucketPlan> buckets;
    const int32_t* cols;
    const float* vals;
};

int32_t pad_len_for(int32_t kept, int32_t min_len, int32_t growth) {
    int64_t len = min_len;
    while (len < kept) len *= growth;
    return static_cast<int32_t>(len);
}

// Shared grouping pipeline behind pio_bucketize and pio_ladder: row
// validation, counting sort, RowRef construction (max_len == 0 means
// no cap), and stable grouping by the caller's pad rule. Returns a
// heap Bucketizer, or nullptr on invalid input; exception-safe via
// unique_ptr (an allocation throw must not leak across the ctypes
// boundary).
template <typename PadFn>
Bucketizer* build_grouped(int64_t nnz, const int32_t* rows,
                          const int32_t* cols, const float* vals,
                          int32_t num_rows, int32_t max_len, PadFn pad_fn) {
    auto bz = std::make_unique<Bucketizer>();
    bz->cols = cols;
    bz->vals = vals;
    // row ids must be dense indices in [0, num_rows): out-of-range ids
    // (corrupted input / int32 overflow upstream) would be
    // out-of-bounds writes below — reject and let the caller fall back
    // to the NumPy path
    for (int64_t i = 0; i < nnz; ++i) {
        if (rows[i] < 0 || rows[i] >= num_rows) return nullptr;
    }
    const int64_t n_rows = num_rows;
    std::vector<int64_t> counts(n_rows + 1, 0);
    for (int64_t i = 0; i < nnz; ++i) ++counts[rows[i] + 1];
    std::vector<int64_t> offsets(counts);
    for (int64_t r = 0; r < n_rows; ++r) offsets[r + 1] += offsets[r];
    bz->order.resize(nnz);
    {
        std::vector<int64_t> cursor(offsets.begin(), offsets.end() - 1);
        for (int64_t i = 0; i < nnz; ++i) bz->order[cursor[rows[i]]++] = i;
    }
    for (int64_t r = 0; r < n_rows; ++r) {
        const int64_t c = offsets[r + 1] - offsets[r];
        if (c == 0) continue;
        RowRef ref;
        ref.start = offsets[r];
        ref.row_id = static_cast<int32_t>(r);
        ref.count = static_cast<int32_t>(c);
        ref.kept = (max_len > 0 && c > max_len) ? max_len
                                                : static_cast<int32_t>(c);
        bz->rows_.push_back(ref);
    }
    // group rows by pad length (ascending, like np.unique in Python)
    std::vector<std::pair<int32_t, int64_t>> keyed;
    keyed.reserve(bz->rows_.size());
    for (int64_t i = 0; i < static_cast<int64_t>(bz->rows_.size()); ++i) {
        keyed.emplace_back(pad_fn(bz->rows_[i].kept), i);
    }
    std::stable_sort(keyed.begin(), keyed.end(),
                     [](const auto& a, const auto& b) {
                         return a.first < b.first;
                     });
    for (const auto& [pl, idx] : keyed) {
        if (bz->buckets.empty() || bz->buckets.back().pad_len != pl) {
            bz->buckets.push_back(BucketPlan{pl, {}});
        }
        bz->buckets.back().row_refs.push_back(idx);
    }
    return bz.release();
}

}  // namespace

extern "C" {

void* pio_bucketize(int64_t nnz, const int32_t* rows, const int32_t* cols,
                    const float* vals, int32_t num_rows, int32_t min_len,
                    int32_t growth, int32_t max_len) try {
    if (nnz < 0 || num_rows < 0 || min_len <= 0 || growth < 2) return nullptr;
    return build_grouped(nnz, rows, cols, vals, num_rows, max_len,
                         [min_len, growth](int32_t kept) {
                             return pad_len_for(kept, min_len, growth);
                         });
} catch (...) {
    // no C++ exception may cross the ctypes boundary (std::terminate)
    return nullptr;
}

int32_t pio_bucketize_num_buckets(void* handle) {
    if (!handle) return -1;
    return static_cast<int32_t>(
        static_cast<Bucketizer*>(handle)->buckets.size());
}

int pio_bucketize_bucket_info(void* handle, int32_t b, int32_t* pad_len,
                              int64_t* n) {
    if (!handle) return -1;
    auto* bz = static_cast<Bucketizer*>(handle);
    if (b < 0 || b >= static_cast<int32_t>(bz->buckets.size())) return -1;
    *pad_len = bz->buckets[b].pad_len;
    *n = static_cast<int64_t>(bz->buckets[b].row_refs.size());
    return 0;
}

int pio_bucketize_fill(void* handle, int32_t b, int32_t* row_ids_out,
                       int32_t* cols_out, float* vals_out, int32_t* deg_out)
try {
    if (!handle) return -1;
    auto* bz = static_cast<Bucketizer*>(handle);
    if (b < 0 || b >= static_cast<int32_t>(bz->buckets.size())) return -1;
    const BucketPlan& plan = bz->buckets[b];
    const int32_t pl = plan.pad_len;

    std::vector<int64_t> scratch;  // value-sorted entry indices (capped rows)
    for (int64_t j = 0; j < static_cast<int64_t>(plan.row_refs.size()); ++j) {
        const RowRef& ref = bz->rows_[plan.row_refs[j]];
        row_ids_out[j] = ref.row_id;
        deg_out[j] = ref.kept;
        int32_t* crow = cols_out + j * pl;
        float* vrow = vals_out + j * pl;
        std::memset(crow, 0, sizeof(int32_t) * pl);
        std::memset(vrow, 0, sizeof(float) * pl);
        if (ref.kept < ref.count) {
            // capped heavy row: keep the top-valued entries
            scratch.resize(ref.count);
            for (int32_t t = 0; t < ref.count; ++t) {
                scratch[t] = bz->order[ref.start + t];
            }
            std::partial_sort(
                scratch.begin(), scratch.begin() + ref.kept, scratch.end(),
                [bz](int64_t a, int64_t c) {
                    return bz->vals[a] > bz->vals[c];
                });
            for (int32_t t = 0; t < ref.kept; ++t) {
                crow[t] = bz->cols[scratch[t]];
                vrow[t] = bz->vals[scratch[t]];
            }
        } else {
            for (int32_t t = 0; t < ref.kept; ++t) {
                const int64_t e = bz->order[ref.start + t];
                crow[t] = bz->cols[e];
                vrow[t] = bz->vals[e];
            }
        }
    }
    return 0;
} catch (...) {
    return -1;
}

void pio_bucketize_free(void* handle) {
    delete static_cast<Bucketizer*>(handle);
}

// Ladder variant (ops/als.ladder_rows): same handle/info/fill/free
// contract as pio_bucketize — the only difference is the pad rule:
// rows with degree <= small_len pad to small_len; otherwise to
// width * c with c the smallest ladder count covering ceil(deg/width),
// the ladder extending by doubling past its last entry (arbitrary
// degrees supported, no capping ever).
void* pio_ladder(int64_t nnz, const int32_t* rows, const int32_t* cols,
                 const float* vals, int32_t num_rows, int32_t width,
                 int32_t small_len, const int64_t* ladder,
                 int32_t n_ladder) try {
    if (nnz < 0 || num_rows < 0 || width <= 0 || small_len <= 0 ||
        n_ladder <= 0) {
        return nullptr;
    }
    auto ladder_pad = [width, small_len, ladder,
                       n_ladder](int32_t kept) -> int32_t {
        if (kept <= small_len) return small_len;
        const int64_t need = (static_cast<int64_t>(kept) + width - 1) / width;
        int64_t c = ladder[n_ladder - 1];
        for (int32_t j = 0; j < n_ladder; ++j) {
            if (ladder[j] >= need) { c = ladder[j]; break; }
        }
        while (c < need) c *= 2;                   // extend by doubling
        return static_cast<int32_t>(c * width);
    };
    // max_len = 0: the ladder never caps
    return build_grouped(nnz, rows, cols, vals, num_rows, 0, ladder_pad);
} catch (...) {
    return nullptr;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Chunker: greedy fixed-size decomposition (ops/als.chunk_rows contract)
// ---------------------------------------------------------------------------
//
// Every row decomposes greedily into full chunks of the largest size,
// cascading down; the final remainder pads to the smallest size. Chunks
// of one row are consecutive and carry the row's entries in their
// row-sorted order — identical layout to the NumPy implementation.
//
//   h = pio_chunk(nnz, rows, cols, vals, num_rows, sizes, n_sizes)
//       (sizes strictly descending, all > 0)
//   n = pio_chunk_num_slabs(h)            // one slab set per size with chunks
//   pio_chunk_slab_info(h, s, &L, &n_chunks)
//   pio_chunk_fill(h, s, row_ids_out, cols_out, vals_out, deg_out)
//   pio_chunk_free(h)

namespace {

struct ChunkRef {
    int64_t start;   // offset into the row-sorted entry order
    int32_t row_id;
    int32_t count;   // real entries in this chunk (<= L)
};

struct SlabPlan {
    int32_t len;
    std::vector<ChunkRef> chunks;
};

struct Chunker {
    std::vector<int64_t> order;
    std::vector<SlabPlan> slabs;
    const int32_t* cols;
    const float* vals;
};

}  // namespace

extern "C" {

void* pio_chunk(int64_t nnz, const int32_t* rows, const int32_t* cols,
                const float* vals, int32_t num_rows, const int32_t* sizes,
                int32_t n_sizes) try {
    if (nnz < 0 || num_rows < 0 || n_sizes <= 0) return nullptr;
    for (int32_t i = 0; i < n_sizes; ++i) {
        if (sizes[i] <= 0) return nullptr;
        if (i > 0 && sizes[i] >= sizes[i - 1]) return nullptr;  // descending
    }
    for (int64_t i = 0; i < nnz; ++i) {
        if (rows[i] < 0 || rows[i] >= num_rows) return nullptr;
    }
    auto* ck = new Chunker();
    ck->cols = cols;
    ck->vals = vals;

    // counting sort by row id (stable)
    const int64_t n_rows = num_rows;
    std::vector<int64_t> counts(n_rows + 1, 0);
    for (int64_t i = 0; i < nnz; ++i) ++counts[rows[i] + 1];
    std::vector<int64_t> offsets(counts);
    for (int64_t r = 0; r < n_rows; ++r) offsets[r + 1] += offsets[r];
    ck->order.resize(nnz);
    {
        std::vector<int64_t> cursor(offsets.begin(), offsets.end() - 1);
        for (int64_t i = 0; i < nnz; ++i) ck->order[cursor[rows[i]]++] = i;
    }

    // greedy cascade: per size class, full chunks (remainder pads into
    // the smallest class)
    std::vector<int64_t> consumed(n_rows, 0);
    ck->slabs.reserve(n_sizes);
    for (int32_t s = 0; s < n_sizes; ++s) {
        const int64_t L = sizes[s];
        SlabPlan plan;
        plan.len = sizes[s];
        for (int64_t r = 0; r < n_rows; ++r) {
            const int64_t deg = offsets[r + 1] - offsets[r];
            const int64_t remaining = deg - consumed[r];
            if (remaining <= 0) continue;
            int64_t covered;
            if (s < n_sizes - 1) {
                covered = (remaining / L) * L;   // full chunks only
            } else {
                covered = remaining;             // remainder pads to last size
            }
            for (int64_t off = 0; off < covered; off += L) {
                ChunkRef ref;
                ref.start = offsets[r] + consumed[r] + off;
                ref.row_id = static_cast<int32_t>(r);
                ref.count = static_cast<int32_t>(std::min(L, covered - off));
                plan.chunks.push_back(ref);
            }
            consumed[r] += covered;
        }
        if (!plan.chunks.empty()) ck->slabs.push_back(std::move(plan));
    }
    return ck;
} catch (...) {
    return nullptr;
}

int32_t pio_chunk_num_slabs(void* handle) {
    if (!handle) return -1;
    return static_cast<int32_t>(static_cast<Chunker*>(handle)->slabs.size());
}

int pio_chunk_slab_info(void* handle, int32_t s, int32_t* len,
                        int64_t* n_chunks) {
    if (!handle) return -1;
    auto* ck = static_cast<Chunker*>(handle);
    if (s < 0 || s >= static_cast<int32_t>(ck->slabs.size())) return -1;
    *len = ck->slabs[s].len;
    *n_chunks = static_cast<int64_t>(ck->slabs[s].chunks.size());
    return 0;
}

int pio_chunk_fill(void* handle, int32_t s, int32_t* row_ids_out,
                   int32_t* cols_out, float* vals_out, int32_t* deg_out) try {
    if (!handle) return -1;
    auto* ck = static_cast<Chunker*>(handle);
    if (s < 0 || s >= static_cast<int32_t>(ck->slabs.size())) return -1;
    const SlabPlan& plan = ck->slabs[s];
    const int32_t L = plan.len;
    for (int64_t j = 0; j < static_cast<int64_t>(plan.chunks.size()); ++j) {
        const ChunkRef& ref = plan.chunks[j];
        row_ids_out[j] = ref.row_id;
        deg_out[j] = ref.count;
        int32_t* crow = cols_out + j * L;
        float* vrow = vals_out + j * L;
        if (ref.count < L) {
            std::memset(crow + ref.count, 0, sizeof(int32_t) * (L - ref.count));
            std::memset(vrow + ref.count, 0, sizeof(float) * (L - ref.count));
        }
        for (int32_t t = 0; t < ref.count; ++t) {
            const int64_t e = ck->order[ref.start + t];
            crow[t] = ck->cols[e];
            vrow[t] = ck->vals[e];
        }
    }
    return 0;
} catch (...) {
    return -1;
}

void pio_chunk_free(void* handle) {
    delete static_cast<Chunker*>(handle);
}

}  // extern "C"
