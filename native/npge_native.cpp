// npge_native — C++ host-runtime kernels for the pangenome engine.
//
// The reference (NPGe) is an all-C++ program; its accelerator successor keeps
// the *compute* path in JAX/XLA and reimplements the host-side hot
// paths natively here (SURVEY.md §2.6): FASTA ingest + base encoding
// (Sequence readers ⚠[B]), 2-bit packed storage (CompactSequence ⚠[B]), and
// the occupancy/interval primitives backing Rest/OverlapsResolver ⚠[B].
//
// C ABI only (consumed via ctypes — no pybind11 in this image). All buffers
// are caller-allocated numpy arrays; functions return element counts or
// negative error codes.

#include <cstdint>
#include <cstring>

namespace {

// base codes: A=0 C=1 G=2 T=3 N=4 (matches npge_tpu.util.codes)
struct CodeTable {
    unsigned char t[256];
    CodeTable() {
        std::memset(t, 4, sizeof(t));
        t[(unsigned char)'A'] = 0; t[(unsigned char)'a'] = 0;
        t[(unsigned char)'C'] = 1; t[(unsigned char)'c'] = 1;
        t[(unsigned char)'G'] = 2; t[(unsigned char)'g'] = 2;
        t[(unsigned char)'T'] = 3; t[(unsigned char)'t'] = 3;
        t[(unsigned char)'-'] = 5;
    }
};
const CodeTable kCodes;

}  // namespace

extern "C" {

// Translate raw bytes to base codes. out must hold n bytes.
void npge_encode_bytes(const char* s, int64_t n, unsigned char* out) {
    for (int64_t i = 0; i < n; ++i) {
        out[i] = kCodes.t[(unsigned char)s[i]];
    }
}

// One-pass FASTA parser.
//   data/n:        raw file bytes
//   codes_out:     caller buffer (>= n bytes); sequence codes, concatenated
//   seq_offsets:   [max_seqs+1]; seq_offsets[i]..seq_offsets[i+1] in codes_out
//   hdr_starts/hdr_ends: [max_seqs]; byte ranges of each header's first word
// Returns number of sequences parsed, or -1 if max_seqs exceeded.
int64_t npge_fasta_encode(const char* data, int64_t n,
                          unsigned char* codes_out, int64_t* seq_offsets,
                          int64_t* hdr_starts, int64_t* hdr_ends,
                          int64_t max_seqs) {
    int64_t nseq = 0;
    int64_t w = 0;
    int64_t i = 0;
    bool in_seq = false;
    seq_offsets[0] = 0;
    while (i < n) {
        if (data[i] == '>') {
            if (nseq >= max_seqs) return -1;
            if (in_seq) seq_offsets[nseq] = w;
            ++i;
            int64_t hs = i;
            while (i < n && data[i] != '\n' && data[i] != ' ' &&
                   data[i] != '\t' && data[i] != '\r')
                ++i;
            hdr_starts[nseq] = hs;
            hdr_ends[nseq] = i;
            while (i < n && data[i] != '\n') ++i;  // rest of header line
            ++nseq;
            in_seq = true;
        } else {
            char c = data[i];
            if (c != '\n' && c != '\r' && c != ' ' && c != '\t') {
                codes_out[w++] = kCodes.t[(unsigned char)c];
            }
            ++i;
        }
        if (in_seq) seq_offsets[nseq] = w;
    }
    return nseq;
}

// 2-bit pack: 16 bases per uint32 (base i at bits 2*(i%16)), N positions
// packed as A with nmask bit set (nmask: 1 byte per base, could be bitset
// later). packed must hold ceil(n/16) words.
void npge_pack2(const unsigned char* codes, int64_t n, uint32_t* packed,
                unsigned char* nmask) {
    int64_t words = (n + 15) / 16;
    for (int64_t wi = 0; wi < words; ++wi) packed[wi] = 0;
    for (int64_t i = 0; i < n; ++i) {
        unsigned char c = codes[i];
        unsigned char b = c < 4 ? c : 0;
        nmask[i] = c >= 4 ? 1 : 0;
        packed[i / 16] |= (uint32_t)b << (2 * (i % 16));
    }
}

void npge_unpack2(const uint32_t* packed, const unsigned char* nmask,
                  int64_t n, unsigned char* out) {
    for (int64_t i = 0; i < n; ++i) {
        unsigned char b = (packed[i / 16] >> (2 * (i % 16))) & 3;
        out[i] = nmask[i] ? 4 : b;
    }
}

// Occupancy: set occ[start[k] .. start[k]+len[k]) for every interval.
void npge_mark_intervals(unsigned char* occ, int64_t occ_len,
                         const int32_t* start, const int32_t* len,
                         int64_t n_intervals) {
    for (int64_t k = 0; k < n_intervals; ++k) {
        int64_t a = start[k];
        int64_t b = a + len[k];
        if (a < 0) a = 0;
        if (b > occ_len) b = occ_len;
        for (int64_t i = a; i < b; ++i) occ[i] = 1;
    }
}

// Maximal zero-runs of occ -> (starts, ends). Returns count (<= max_runs)
// or -1 on overflow.
int64_t npge_uncovered_runs(const unsigned char* occ, int64_t n,
                            int32_t* starts, int32_t* ends,
                            int64_t max_runs) {
    int64_t cnt = 0;
    int64_t i = 0;
    while (i < n) {
        if (!occ[i]) {
            int64_t j = i;
            while (j < n && !occ[j]) ++j;
            if (cnt >= max_runs) return -1;
            starts[cnt] = (int32_t)i;
            ends[cnt] = (int32_t)j;
            ++cnt;
            i = j;
        } else {
            ++i;
        }
    }
    return cnt;
}

// Free-mask for one candidate block: free_cols[c] = 1 iff no present
// fragment occupies an occupied position at column c. Gapless fast path:
// fragments described by (seq_occ pointer chosen by caller per fragment).
// Here: one fragment at a time; caller ANDs across fragments.
//   ori=+1: position of column c = start + c
//   ori=-1: position of column c = start + len - 1 - c
void npge_free_mask_and(const unsigned char* occ, int64_t occ_len,
                        int32_t start, int32_t len, int32_t ori,
                        int64_t n_cols, unsigned char* free_cols) {
    if (ori == 1) {
        for (int64_t c = 0; c < n_cols; ++c) {
            int64_t p = start + c;
            if (p >= 0 && p < occ_len && occ[p]) free_cols[c] = 0;
        }
    } else {
        for (int64_t c = 0; c < n_cols; ++c) {
            int64_t p = (int64_t)start + len - 1 - c;
            if (p >= 0 && p < occ_len && occ[p]) free_cols[c] = 0;
        }
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Greedy gapless overlap resolution — the host hot loop of the pipeline
// (algo/overlaps.py resolve_overlaps, C++ fast path). Exact same semantics
// as the Python implementation; parity-tested. Candidates are gapless
// multi-fragment blocks in CSR form; admission slices each candidate to its
// free column runs, re-checks the good-block predicate (identity as exact
// integer rational; identical first/last min_end columns), extracts the
// longest good slice when a run fails, and marks occupancy.

namespace {

struct GoodSliceResult { int64_t c0, c1; bool ok; };

// Longest [c0,c1) window of good_col with: all-good m-prefix and m-suffix,
// length >= min_len, and sum(den*good - num) >= 0. Mirrors
// algo/filter.best_good_slice (ties -> leftmost).
GoodSliceResult best_good_slice(const unsigned char* good, int64_t n,
                                int64_t m, int64_t min_len,
                                int64_t num, int64_t den) {
    if (m < 1) m = 1;
    if (min_len < m) min_len = m;
    if (n < min_len) return {0, 0, false};
    // wall[i] = good[i..i+m-1] all true, i in [0, n-m]
    int64_t nw = n - m + 1;
    // allocate per call (n small); simple heap buffers
    int64_t* P = new int64_t[n + 1];
    P[0] = 0;
    for (int64_t i = 0; i < n; ++i) P[i + 1] = P[i] + (den * (good[i] ? 1 : 0) - num);
    // prefix count of good for window-all test
    int64_t* G = new int64_t[n + 1];
    G[0] = 0;
    for (int64_t i = 0; i < n; ++i) G[i + 1] = G[i] + (good[i] ? 1 : 0);
    // start candidates l (wall true), with prefix running-min of P[l]
    int64_t* starts = new int64_t[nw];
    int64_t* prefmin = new int64_t[nw];
    int64_t ns = 0;
    for (int64_t l = 0; l < nw; ++l) {
        if (G[l + m] - G[l] == m) {
            starts[ns] = l;
            prefmin[ns] = ns ? (P[l] < prefmin[ns - 1] ? P[l] : prefmin[ns - 1]) : P[l];
            ++ns;
        }
    }
    GoodSliceResult best{0, 0, false};
    int64_t best_len = 0;
    if (ns) {
        for (int64_t e = 0; e < nw; ++e) {
            if (G[e + m] - G[e] != m) continue;
            int64_t r = e + m - 1;  // inclusive end
            int64_t max_l = r - min_len + 1;
            if (max_l < starts[0]) continue;
            // hi = count of starts <= max_l (binary search)
            int64_t lo = 0, hi = ns;
            while (lo < hi) { int64_t mid = (lo + hi) / 2; if (starts[mid] <= max_l) lo = mid + 1; else hi = mid; }
            int64_t cnt = lo;
            if (!cnt) continue;
            int64_t target = P[r + 1];
            // first j in [0, cnt) with prefmin[j] <= target (prefmin non-increasing)
            lo = 0; hi = cnt;
            while (lo < hi) { int64_t mid = (lo + hi) / 2; if (prefmin[mid] <= target) hi = mid; else lo = mid + 1; }
            if (lo >= cnt) continue;
            int64_t l = starts[lo];
            int64_t length = r - l + 1;
            if (length > best_len) { best_len = length; best = {l, r + 1, true}; }
        }
    }
    delete[] P; delete[] G; delete[] starts; delete[] prefmin;
    return best;
}

}  // namespace

extern "C" {

// Returns number of output blocks, or -1 on output overflow.
int64_t npge_resolve_gapless(
    const unsigned char* codes, const int64_t* seq_offsets, int32_t n_seqs,
    unsigned char* occ,  // [total_len] concatenated per-seq occupancy
    const int64_t* cand_offsets, const int32_t* f_seq, const int32_t* f_start,
    const int32_t* f_len, const int32_t* f_ori,
    const int64_t* order, int64_t n_cand,
    int64_t min_length, int64_t min_end, int64_t ident_num, int64_t ident_den,
    int64_t* out_offsets, int32_t* o_seq, int32_t* o_start, int32_t* o_len,
    int32_t* o_ori, int64_t* o_src,  // source candidate index per out block
    int64_t max_out_blocks, int64_t max_out_frags) {
    int64_t nb = 0, nf = 0;
    out_offsets[0] = 0;
    // scratch reused across candidates
    int64_t cap = 0;
    unsigned char* freec = nullptr;
    unsigned char* goodc = nullptr;
    unsigned char* mnc = nullptr;
    unsigned char* mxc = nullptr;
    for (int64_t oi = 0; oi < n_cand; ++oi) {
        int64_t ci = order[oi];
        int64_t fa = cand_offsets[ci], fb = cand_offsets[ci + 1];
        int64_t F = fb - fa;
        if (F < 2) continue;
        int64_t n_cols = f_len[fa];
        if (n_cols < min_length) continue;
        // self-overlap check (O(F^2); F is small)
        bool selfov = false;
        for (int64_t i = fa; i < fb && !selfov; ++i)
            for (int64_t j = i + 1; j < fb; ++j)
                if (f_seq[i] == f_seq[j]) {
                    int64_t a1 = f_start[i], b1 = a1 + f_len[i];
                    int64_t a2 = f_start[j], b2 = a2 + f_len[j];
                    if (a1 < b2 && a2 < b1) { selfov = true; break; }
                }
        if (selfov) continue;
        if (n_cols > cap) {
            delete[] freec; delete[] goodc; delete[] mnc; delete[] mxc;
            cap = n_cols * 2;
            freec = new unsigned char[cap];
            goodc = new unsigned char[cap];
            mnc = new unsigned char[cap];
            mxc = new unsigned char[cap];
        }
        // free mask + per-column identity, accumulated FRAGMENT-major:
        // each fragment's span is read with unit stride (streaming,
        // prefetch-friendly) instead of hopping across F distant genome
        // regions per column — the column-major form was the resolve
        // stage's dominant cost at 17 Mbp (cache miss per access)
        memset(freec, 1, (size_t)n_cols);
        memset(mnc, 255, (size_t)n_cols);
        memset(mxc, 0, (size_t)n_cols);
        for (int64_t i = fa; i < fb; ++i) {
            const unsigned char* cd = codes + seq_offsets[f_seq[i]];
            const unsigned char* oc = occ + seq_offsets[f_seq[i]];
            int64_t st = f_start[i];
            if (f_ori[i] == 1) {
                for (int64_t c = 0; c < n_cols; ++c) {
                    unsigned char ch = cd[st + c];
                    freec[c] &= (unsigned char)(oc[st + c] == 0);
                    if (ch < mnc[c]) mnc[c] = ch;
                    if (ch > mxc[c]) mxc[c] = ch;
                }
            } else {
                int64_t last = st + f_len[i] - 1;
                for (int64_t c = 0; c < n_cols; ++c) {
                    unsigned char ch = cd[last - c];
                    freec[c] &= (unsigned char)(oc[last - c] == 0);
                    if (ch < 4) ch = (unsigned char)(3 - ch);
                    if (ch < mnc[c]) mnc[c] = ch;
                    if (ch > mxc[c]) mxc[c] = ch;
                }
            }
        }
        for (int64_t c = 0; c < n_cols; ++c)
            goodc[c] = (mnc[c] == mxc[c] && mxc[c] < 4) ? 1 : 0;
        // maximal free runs
        int64_t c = 0;
        while (c < n_cols) {
            if (!freec[c]) { ++c; continue; }
            int64_t r0 = c;
            while (c < n_cols && freec[c]) ++c;
            int64_t r1 = c;
            if (r1 - r0 < min_length) continue;
            // goodness of the whole run
            int64_t gsum = 0;
            for (int64_t x = r0; x < r1; ++x) gsum += goodc[x];
            int64_t L = r1 - r0;
            int64_t m = min_end < L ? min_end : L;
            bool ends_ok = true;  // m<=0: no ends requirement (python parity)
            for (int64_t x = 0; x < m; ++x)
                if (!goodc[r0 + x] || !goodc[r1 - 1 - x]) { ends_ok = false; break; }
            int64_t a0 = r0, a1 = r1;
            bool ok = ends_ok && gsum * ident_den >= ident_num * L;
            if (!ok) {
                GoodSliceResult gs = best_good_slice(
                    goodc + r0, L, min_end, min_length, ident_num, ident_den);
                if (!gs.ok) continue;
                a0 = r0 + gs.c0;
                a1 = r0 + gs.c1;
            }
            // accept slice [a0, a1)
            if (nb >= max_out_blocks || nf + F > max_out_frags) {
                delete[] freec; delete[] goodc; delete[] mnc; delete[] mxc;
                return -1;
            }
            for (int64_t i = fa; i < fb; ++i) {
                int64_t st, ln = a1 - a0;
                if (f_ori[i] == 1) st = f_start[i] + a0;
                else st = (int64_t)f_start[i] + f_len[i] - a1;
                o_seq[nf] = f_seq[i];
                o_start[nf] = (int32_t)st;
                o_len[nf] = (int32_t)ln;
                o_ori[nf] = f_ori[i];
                int64_t base = seq_offsets[f_seq[i]] + st;
                memset(occ + base, 1, (size_t)ln);
                ++nf;
            }
            o_src[nb] = ci;
            ++nb;
            out_offsets[nb] = nf;
        }
    }
    delete[] freec; delete[] goodc; delete[] mnc; delete[] mxc;
    return nb;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Global Needleman-Wunsch with linear gaps — exact mirror of
// npge_tpu.algo.similar.nw_align (values AND traceback tie-breaks:
// diag > up > left). The Python version pays ~0.2 ms of numpy call
// overhead per (short) gap-patch alignment; the Joiner runs thousands per
// build. out_a/out_b must hold n+m bytes; the alignment is written to the
// FINAL L bytes (returned), exactly as the Python reversed-list build.

extern "C" {

int64_t npge_nw_align(const unsigned char* a, int64_t n,
                      const unsigned char* b, int64_t m,
                      int64_t match, int64_t mismatch, int64_t gap,
                      unsigned char gap_code,
                      unsigned char* out_a, unsigned char* out_b) {
    int64_t w = m + 1;
    int64_t* H = new int64_t[(n + 1) * w];
    for (int64_t j = 0; j <= m; ++j) H[j] = j * gap;
    for (int64_t i = 1; i <= n; ++i) {
        int64_t* cur = H + i * w;
        const int64_t* prev = cur - w;
        cur[0] = i * gap;
        unsigned char ai = a[i - 1];
        for (int64_t j = 1; j <= m; ++j) {
            int64_t best = prev[j - 1] + (b[j - 1] == ai ? match : mismatch);
            int64_t up = prev[j] + gap;
            if (up > best) best = up;
            int64_t left = cur[j - 1] + gap;
            if (left > best) best = left;
            cur[j] = best;
        }
    }
    int64_t i = n, j = m, p = n + m;
    while (i > 0 || j > 0) {
        int64_t cur = H[i * w + j];
        if (i > 0 && j > 0 &&
            cur == H[(i - 1) * w + (j - 1)] +
                       (a[i - 1] == b[j - 1] ? match : mismatch)) {
            --p;
            out_a[p] = a[--i];
            out_b[p] = b[--j];
        } else if (i > 0 && cur == H[(i - 1) * w + j] + gap) {
            --p;
            out_a[p] = a[--i];
            out_b[p] = gap_code;
        } else {
            --p;
            out_a[p] = gap_code;
            out_b[p] = b[--j];
        }
    }
    delete[] H;
    return n + m - p;
}

}  // extern "C"
