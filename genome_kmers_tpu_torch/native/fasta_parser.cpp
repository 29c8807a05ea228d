// Native FASTA -> sequence-byte-array parser.
//
// The reference parses FASTA with a per-line Python loop at ~40 Mbp/s
// (reference sequence_collection.py:476-576).  At TPU ingest rates that
// parser dominates wall-clock (SURVEY.md §7.3-5), so the hot byte work —
// stripping headers/newlines, uppercasing, inserting '$' separators —
// lives here as a single linear scan; Python keeps only the (tiny) record
// name handling.  Exposed as extern "C" for ctypes.
//
// Contract (mirrors io/fasta.py parse_fasta_bytes):
//   * records separated by '$' in the output; no trailing separator
//   * sequence bytes uppercased; '\r' and '\n' dropped
//   * gk_fasta_stats returns per-record sequence lengths so the caller can
//     validate empty sequences and allocate exactly.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline uint8_t upper(uint8_t c) {
    return (c >= 'a' && c <= 'z') ? static_cast<uint8_t>(c - 32) : c;
}

// Align a nominal chunk boundary to the start of the next line so every
// chunk begins in at_line_start state.
inline int64_t align_to_line(const uint8_t* data, int64_t n, int64_t pos) {
    if (pos <= 0) return 0;
    if (pos >= n) return n;
    while (pos < n && data[pos - 1] != '\n') pos++;
    return pos;
}

}  // namespace

extern "C" {

// Pass 1: count records and per-record sequence lengths.
//   data/n:       raw file bytes
//   seq_lens_out: capacity max_records; filled with per-record bp counts
//   returns number of records, or -1 if more than max_records.
int64_t gk_fasta_stats(const uint8_t* data, int64_t n, int64_t* seq_lens_out,
                       int64_t max_records) {
    int64_t num_records = 0;
    int64_t i = 0;
    bool at_line_start = true;
    bool in_header = false;
    while (i < n) {
        uint8_t c = data[i];
        if (at_line_start) {
            in_header = (c == '>');
            if (in_header) {
                if (num_records >= max_records) return -1;
                seq_lens_out[num_records++] = 0;
            }
            at_line_start = false;
        }
        if (c == '\n') {
            at_line_start = true;
        } else if (!in_header && c != '\r') {
            if (num_records > 0) seq_lens_out[num_records - 1]++;
        }
        i++;
    }
    return num_records;
}

// Pass 2: fill the '$'-separated, uppercased SBA.
//   sba_out must have capacity sum(seq_lens) + num_records - 1.
//   header_starts_out/header_ends_out (capacity num_records) receive the
//   byte offsets of each header line (exclusive of '\n' and '\r').
//   Returns bytes written, or -1 on logic error.
int64_t gk_fasta_fill(const uint8_t* data, int64_t n, uint8_t* sba_out,
                      int64_t sba_capacity, int64_t* header_starts_out,
                      int64_t* header_ends_out) {
    int64_t out = 0;
    int64_t i = 0;
    int64_t record = 0;
    bool at_line_start = true;
    bool in_header = false;
    while (i < n) {
        uint8_t c = data[i];
        if (at_line_start) {
            in_header = (c == '>');
            if (in_header) {
                if (record > 0) {
                    if (out >= sba_capacity) return -1;
                    sba_out[out++] = '$';
                }
                header_starts_out[record] = i;
                record++;
            }
            at_line_start = false;
        }
        if (c == '\n') {
            if (in_header) {
                int64_t e = i;
                if (e > 0 && data[e - 1] == '\r') e--;
                header_ends_out[record - 1] = e;
            }
            at_line_start = true;
            in_header = false;
        } else if (!in_header && c != '\r') {
            if (out >= sba_capacity) return -1;
            sba_out[out++] = upper(c);
        }
        i++;
    }
    if (in_header) {  // file ends inside a header line without newline
        header_ends_out[record - 1] = n;
    }
    return out;
}

// ---------------------------------------------------------------------------
// Multithreaded variants: the buffer is split into line-aligned chunks; a
// two-phase parallel stats scan gathers per-chunk header/byte counts (merged
// in Python, which knows nothing of threads), and a parallel fill writes each
// chunk at its precomputed output offset with its precomputed record base.
// ---------------------------------------------------------------------------

// Compute line-aligned chunk bounds. bounds_out has n_chunks+1 entries.
void gk_chunk_bounds(const uint8_t* data, int64_t n, int64_t n_chunks,
                     int64_t* bounds_out) {
    for (int64_t c = 0; c <= n_chunks; c++) {
        int64_t nominal = (n * c) / n_chunks;
        bounds_out[c] = align_to_line(data, n, nominal);
    }
    bounds_out[0] = 0;
    bounds_out[n_chunks] = n;
}

namespace {

struct ChunkStats {
    int64_t seq_bytes = 0;   // total sequence bytes in chunk
    int64_t lead_bytes = 0;  // sequence bytes before the first header
    int64_t n_headers = 0;
};

void stats_scan_chunk(const uint8_t* data, int64_t a, int64_t b, ChunkStats* st,
                      int64_t* hdr_offsets, int64_t* hdr_counts) {
    // hdr_offsets/hdr_counts may be null (phase A) or sized st->n_headers
    // (phase B). Counting logic mirrors gk_fasta_stats.
    int64_t i = a;
    bool at_line_start = true;
    bool in_header = false;
    int64_t n_headers = 0;
    int64_t seq_bytes = 0;
    int64_t lead = 0;
    int64_t cur_count = 0;
    bool seen_header = false;
    while (i < b) {
        uint8_t c = data[i];
        if (at_line_start) {
            in_header = (c == '>');
            if (in_header) {
                if (seen_header && hdr_counts) hdr_counts[n_headers - 1] = cur_count;
                if (hdr_offsets) hdr_offsets[n_headers] = i;
                n_headers++;
                seen_header = true;
                cur_count = 0;
            }
            at_line_start = false;
        }
        if (c == '\n') {
            at_line_start = true;
        } else if (!in_header && c != '\r') {
            seq_bytes++;
            if (seen_header) cur_count++; else lead++;
        }
        i++;
    }
    if (seen_header && hdr_counts) hdr_counts[n_headers - 1] = cur_count;
    if (st) {
        st->seq_bytes = seq_bytes;
        st->lead_bytes = lead;
        st->n_headers = n_headers;
    }
}

}  // namespace

// Phase A+B parallel stats over precomputed bounds.
//   seq_bytes_out/lead_out/nheaders_out: per chunk (n_chunks)
//   hdr_offsets_out/hdr_counts_out: global, chunk-major (capacity max_records)
// Returns total headers, or -1 on overflow.
int64_t gk_fasta_stats_mt(const uint8_t* data, int64_t n, int64_t n_chunks,
                          const int64_t* bounds, int64_t* seq_bytes_out,
                          int64_t* lead_out, int64_t* nheaders_out,
                          int64_t* hdr_offsets_out, int64_t* hdr_counts_out,
                          int64_t max_records) {
    std::vector<ChunkStats> stats(n_chunks);
    {
        std::vector<std::thread> ts;
        for (int64_t c = 0; c < n_chunks; c++) {
            ts.emplace_back(stats_scan_chunk, data, bounds[c], bounds[c + 1],
                            &stats[c], nullptr, nullptr);
        }
        for (auto& t : ts) t.join();
    }
    int64_t total = 0;
    std::vector<int64_t> slab(n_chunks);
    for (int64_t c = 0; c < n_chunks; c++) {
        slab[c] = total;
        total += stats[c].n_headers;
        seq_bytes_out[c] = stats[c].seq_bytes;
        lead_out[c] = stats[c].lead_bytes;
        nheaders_out[c] = stats[c].n_headers;
    }
    if (total > max_records) return -1;
    {
        std::vector<std::thread> ts;
        for (int64_t c = 0; c < n_chunks; c++) {
            ts.emplace_back(stats_scan_chunk, data, bounds[c], bounds[c + 1],
                            nullptr, hdr_offsets_out + slab[c],
                            hdr_counts_out + slab[c]);
        }
        for (auto& t : ts) t.join();
    }
    return total;
}

namespace {

void fill_chunk(const uint8_t* data, int64_t a, int64_t b, uint8_t* sba_out,
                int64_t out_offset, int64_t record_base,
                int64_t* header_starts_out, int64_t* header_ends_out) {
    int64_t out = out_offset;
    int64_t i = a;
    int64_t record = record_base;
    bool at_line_start = true;
    bool in_header = false;
    while (i < b) {
        uint8_t c = data[i];
        if (at_line_start) {
            in_header = (c == '>');
            if (in_header) {
                if (record > 0) sba_out[out++] = '$';
                header_starts_out[record] = i;
                record++;
            }
            at_line_start = false;
        }
        if (c == '\n') {
            if (in_header) {
                int64_t e = i;
                if (e > 0 && data[e - 1] == '\r') e--;
                header_ends_out[record - 1] = e;
            }
            at_line_start = true;
            in_header = false;
        } else if (!in_header && c != '\r') {
            sba_out[out++] = upper(c);
        }
        i++;
    }
    if (in_header) header_ends_out[record - 1] = b;
}

}  // namespace

// Parallel fill. out_offsets/record_bases: per chunk (n_chunks), computed by
// the caller from the merged stats. sba_out must be fully preallocated.
void gk_fasta_fill_mt(const uint8_t* data, int64_t n, int64_t n_chunks,
                      const int64_t* bounds, const int64_t* out_offsets,
                      const int64_t* record_bases, uint8_t* sba_out,
                      int64_t* header_starts_out, int64_t* header_ends_out) {
    std::vector<std::thread> ts;
    for (int64_t c = 0; c < n_chunks; c++) {
        ts.emplace_back(fill_chunk, data, bounds[c], bounds[c + 1], sba_out,
                        out_offsets[c], record_bases[c], header_starts_out,
                        header_ends_out);
    }
    for (auto& t : ts) t.join();
}

namespace {

// One chunk [lo, hi) of the alphabet scan: the index of its first byte of
// class bit 1 (not allowed), or hi, and the class bits of the bytes before it.
void scan_alphabet_chunk(const uint8_t* sba, int64_t lo, int64_t hi,
                         const uint8_t* cls, int64_t* first_bad, uint8_t* seen_out) {
    uint8_t seen = 0;
    int64_t i = lo;
    // blocks of 64 bytes with no branch inside; the block holding the first
    // offending byte is walked again byte by byte below
    for (; i + 64 <= hi; i += 64) {
        uint8_t block = 0;
        for (int j = 0; j < 64; j++) block |= cls[sba[i + j]];
        if (block & 2) break;
        seen |= block;
    }
    for (; i < hi; i++) {
        const uint8_t c = cls[sba[i]];
        if (c & 2) break;
        seen |= c;
    }
    *first_bad = i;
    *seen_out = seen;
}

}  // namespace

// Validate alphabet against an allowed-bytes table (256 entries, 1 = ok).
// Returns the first offending byte value, or -1 if all allowed.  The same
// pass sets *outside_acgt to 1 when a byte outside {A, C, G, T, $} was seen
// (the 2-bit keys need none), else 0; after an offending byte it is 1.
// n_threads equal chunks are scanned at once; the first chunk holding an
// offending byte gives it.
int64_t gk_validate_alphabet(const uint8_t* sba, int64_t n,
                             const uint8_t* allowed, int64_t n_threads,
                             int64_t* outside_acgt) {
    // byte class: bit 0 = outside ACGT$, bit 1 = not allowed
    uint8_t cls[256];
    for (int b = 0; b < 256; b++) {
        const bool acgt = b == 'A' || b == 'C' || b == 'G' || b == 'T' || b == '$';
        cls[b] = static_cast<uint8_t>((acgt ? 0 : 1) | (allowed[b] ? 0 : 2));
    }
    if (n_threads < 1) n_threads = 1;
    std::vector<int64_t> bounds(n_threads + 1), bad(n_threads);
    std::vector<uint8_t> seen(n_threads);
    for (int64_t t = 0; t <= n_threads; t++) bounds[t] = n * t / n_threads;
    if (n_threads == 1) {
        scan_alphabet_chunk(sba, 0, n, cls, &bad[0], &seen[0]);
    } else {
        std::vector<std::thread> ts;
        for (int64_t t = 0; t < n_threads; t++) {
            ts.emplace_back(scan_alphabet_chunk, sba, bounds[t], bounds[t + 1], cls,
                            &bad[t], &seen[t]);
        }
        for (auto& th : ts) th.join();
    }
    uint8_t all = 0;
    for (int64_t t = 0; t < n_threads; t++) {
        if (bad[t] < bounds[t + 1]) {
            *outside_acgt = 1;
            return sba[bad[t]];
        }
        all |= seen[t];
    }
    *outside_acgt = all & 1;
    return -1;
}

// Reverse complement: out[i] = table[in[n-1-i]].  table is a 256-entry map.
void gk_reverse_complement(const uint8_t* in, int64_t n, const uint8_t* table,
                           uint8_t* out) {
    for (int64_t i = 0; i < n; i++) {
        out[i] = table[in[n - 1 - i]];
    }
}

}  // extern "C"

namespace {

// Pack ranks of bases [w*bpw, (w+1)*bpw) into out[w], first base in the top
// field; tail bases beyond n pack as rank 0 (matches the NumPy strided pack
// in ops/large.py).
void pack_chunk(const uint8_t* data, int64_t n, const uint8_t* table,
                int64_t bits, int64_t w0, int64_t w1, uint32_t* out) {
    const int64_t bpw = 32 / bits;
    const int64_t shift_top = 32 - bits;
    for (int64_t w = w0; w < w1; w++) {
        uint32_t word = 0;
        const int64_t base = w * bpw;
        int64_t m = n - base;
        if (m > bpw) m = bpw;
        for (int64_t j = 0; j < m; j++) {
            word |= static_cast<uint32_t>(table[data[base + j]])
                    << (shift_top - bits * j);
        }
        out[w] = word;
    }
}

}  // namespace

extern "C" {

// Strided rank pack (the host half of the device ingest path: the strided
// words are 1/4 or 1/2 the bytes of the SBA and expand to per-position key
// words on device).  bits in {2, 4}; table maps byte -> rank.  out must
// hold ceil(n / (32/bits)) words (any zero-padded tail beyond that is the
// caller's).
void gk_pack_strided(const uint8_t* data, int64_t n, const uint8_t* table,
                     int64_t bits, int64_t n_threads, uint32_t* out) {
    const int64_t bpw = 32 / bits;
    const int64_t n_words = (n + bpw - 1) / bpw;
    if (n_threads < 1) n_threads = 1;
    if (n_threads == 1) {
        pack_chunk(data, n, table, bits, 0, n_words, out);
        return;
    }
    std::vector<std::thread> ts;
    for (int64_t t = 0; t < n_threads; t++) {
        const int64_t w0 = n_words * t / n_threads;
        const int64_t w1 = n_words * (t + 1) / n_threads;
        if (w0 < w1) {
            ts.emplace_back(pack_chunk, data, n, table, bits, w0, w1, out);
        }
    }
    for (auto& th : ts) th.join();
}

}  // extern "C"

namespace {

// One k-byte contiguous copy per row.  The NumPy formulation is k strided
// column writes (out[:, j] = sba[pos + j]) — each pass touches every row's
// cache line once, so the whole decode is k round-trips through the output
// working set; this is a single pass with sequential writes.
void decode_rows_chunk(const uint8_t* sba, const int64_t* pos, int64_t r0,
                       int64_t r1, int64_t k, uint8_t* out) {
    for (int64_t r = r0; r < r1; r++) {
        std::memcpy(out + r * k, sba + pos[r], static_cast<size_t>(k));
    }
}

}  // namespace

extern "C" {

// Bulk fixed-width k-mer decode: out[r*k : (r+1)*k] = sba[pos[r] : pos[r]+k].
// Bounds are the CALLER's contract (kmers.py checks pos+k against segment
// ends before decoding; the ctypes wrapper re-checks against the sba length).
void gk_decode_rows(const uint8_t* sba, const int64_t* pos, int64_t n,
                    int64_t k, int64_t n_threads, uint8_t* out) {
    if (n_threads < 1) n_threads = 1;
    if (n_threads == 1) {
        decode_rows_chunk(sba, pos, 0, n, k, out);
        return;
    }
    std::vector<std::thread> ts;
    for (int64_t t = 0; t < n_threads; t++) {
        const int64_t r0 = n * t / n_threads;
        const int64_t r1 = n * (t + 1) / n_threads;
        if (r0 < r1) {
            ts.emplace_back(decode_rows_chunk, sba, pos, r0, r1, k, out);
        }
    }
    for (auto& th : ts) th.join();
}

}  // extern "C"

namespace {

void decode_rows_var_chunk(const uint8_t* sba, const int64_t* pos,
                           const int64_t* lens, const int64_t* offs,
                           int64_t r0, int64_t r1, uint8_t* out) {
    for (int64_t r = r0; r < r1; r++) {
        std::memcpy(out + offs[r], sba + pos[r], static_cast<size_t>(lens[r]));
    }
}

}  // namespace

extern "C" {

// Variable-width decode (suffix-mode / kmer_len=None rows): row r copies
// lens[r] bytes from sba[pos[r]] to out[offs[r]], where offs is the
// exclusive prefix sum of lens.  Same caller-validates-bounds contract as
// gk_decode_rows; out is an arrow-style (offsets, data) string column.
void gk_decode_rows_var(const uint8_t* sba, const int64_t* pos,
                        const int64_t* lens, const int64_t* offs, int64_t n,
                        int64_t n_threads, uint8_t* out) {
    if (n_threads < 1) n_threads = 1;
    if (n_threads == 1) {
        decode_rows_var_chunk(sba, pos, lens, offs, 0, n, out);
        return;
    }
    std::vector<std::thread> ts;
    for (int64_t t = 0; t < n_threads; t++) {
        const int64_t r0 = n * t / n_threads;
        const int64_t r1 = n * (t + 1) / n_threads;
        if (r0 < r1) {
            ts.emplace_back(decode_rows_var_chunk, sba, pos, lens, offs, r0,
                            r1, out);
        }
    }
    for (auto& th : ts) th.join();
}

}  // extern "C"
