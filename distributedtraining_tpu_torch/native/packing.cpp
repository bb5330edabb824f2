// Native sequence packer: the hot host-side loop of the data pipeline.
//
// The port's copy of the JAX package's native/packing.cpp. Exact
// behavioural twin of the Python packer in data/packing.py (greedy fill,
// per-chunk position restart, successor-in-segment loss mask, fresh
// segment id for the padding tail); the Python loop is its plain version,
// which the tests hold it against. It keeps the host's packing off the
// training step's critical path from one CPU core.
//
// C ABI only (loaded via ctypes): no Python.h, no build-time dependency on
// the interpreter.

#include <cstdint>
#include <cstring>

extern "C" {

// Pack concatenated documents into fixed-length rows.
//
// tokens    : all documents back to back, int32
// doc_lens  : length of each document, int64[n_docs]
// seq_len   : row width
// drop_remainder : when 0, a trailing partial row is emitted
// ids/seg/pos/mask : caller-allocated [rows_cap, seq_len] outputs
// rows_cap  : capacity in rows; the function never writes beyond it
//
// Returns the number of rows written, or -1 if rows_cap was insufficient
// (the caller sizes rows_cap = total_tokens/seq_len + 1, which always
// suffices; -1 is a defensive contract, not an expected path).
int64_t dt_pack(const int32_t* tokens, const int64_t* doc_lens,
                int64_t n_docs, int64_t seq_len, int drop_remainder,
                int32_t* ids, int32_t* seg, int32_t* pos, float* mask,
                int64_t rows_cap) {
    if (seq_len <= 0 || rows_cap < 0) return -1;
    int64_t row = 0;       // rows completed
    int64_t fill = 0;      // tokens in the current row
    int32_t seg_id = 0;    // next segment id within the current row
    int64_t consumed = 0;  // global token cursor

    auto row_base = [&](int64_t r) { return r * seq_len; };

    // zero the first row lazily as we go: every cell of a completed row is
    // written exactly once below, except the mask (cleared per chunk tail),
    // so clear mask/ids up front per row instead.
    auto begin_row = [&]() {
        if (row >= rows_cap) return false;
        int64_t b = row_base(row);
        std::memset(ids + b, 0, sizeof(int32_t) * seq_len);
        std::memset(seg + b, 0, sizeof(int32_t) * seq_len);
        std::memset(pos + b, 0, sizeof(int32_t) * seq_len);
        std::memset(mask + b, 0, sizeof(float) * seq_len);
        return true;
    };
    if (!begin_row()) return n_docs == 0 ? 0 : -1;

    for (int64_t d = 0; d < n_docs; ++d) {
        int64_t remaining = doc_lens[d];
        while (remaining > 0) {
            int64_t space = seq_len - fill;
            int64_t take = remaining < space ? remaining : space;
            int64_t b = row_base(row) + fill;
            std::memcpy(ids + b, tokens + consumed,
                        sizeof(int32_t) * take);
            for (int64_t i = 0; i < take; ++i) {
                seg[b + i] = seg_id;
                pos[b + i] = static_cast<int32_t>(i);  // parity: restart per chunk
            }
            for (int64_t i = 0; i + 1 < take; ++i) mask[b + i] = 1.0f;
            consumed += take;
            remaining -= take;
            fill += take;
            if (fill == seq_len) {
                ++row;
                fill = 0;
                seg_id = 0;
                if (!begin_row()) {
                    // out of capacity; only acceptable if nothing remains
                    if (remaining == 0 && d == n_docs - 1) return row;
                    return -1;
                }
            } else {
                ++seg_id;
            }
        }
    }
    if (fill > 0 && !drop_remainder) {
        int64_t b = row_base(row);
        for (int64_t i = fill; i < seq_len; ++i) seg[b + i] = seg_id + 1;
        ++row;
    }
    return row;
}

}  // extern "C"
