// lamsa_tpu native host components.
//
// Host-side counterparts of the reference's C core (SURVEY.md §2b):
//   * lamsa_banded_sw_cpu  — scalar banded affine-gap SW with traceback
//       (the ksw.c-equivalent; serves as the measurable CPU baseline and
//       a fast exact oracle for differential tests)
//   * lamsa_decode_steps   — batch decoder of the on-device traceback
//       walk's per-row step words -> CIGAR runs (hot host loop)
//   * lamsa_traceback_banded — CIGAR walk over banded direction bytes
//       (CPU-engine path)
//   * lamsa_encode_nt4 / lamsa_revcomp4 — byte-level sequence encoding
//   * lamsa_nm_from_cigar  — NM (edit distance) accumulation
//
// Exposed as a C ABI for ctypes (no pybind11 in this image). CIGAR runs
// are packed uint32: (len << 4) | op, ops per io/sam.py CIGAR_OPS.
//
// Build: lamsa_tpu/native/build.py (g++ -O3 -shared -fPIC).

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>
#include <thread>

extern "C" {

static const int OP_M = 0, OP_I = 1, OP_D = 2;

// ---------------------------------------------------------------- encoding

void lamsa_encode_nt4(const uint8_t* seq, int64_t n, uint8_t* out) {
    static uint8_t table[256];
    static bool init = false;
    if (!init) {
        memset(table, 4, sizeof(table));
        table['A'] = 0; table['C'] = 1; table['G'] = 2; table['T'] = 3;
        table['a'] = 0; table['c'] = 1; table['g'] = 2; table['t'] = 3;
        init = true;
    }
    for (int64_t i = 0; i < n; i++) out[i] = table[seq[i]];
}

void lamsa_revcomp4(const uint8_t* codes, int64_t n, uint8_t* out) {
    static const uint8_t comp[5] = {3, 2, 1, 0, 4};
    for (int64_t i = 0; i < n; i++) out[i] = comp[codes[n - 1 - i]];
}

// ------------------------------------------------------------ cigar helpers

struct RunBuf {
    uint32_t* out;
    int32_t maxc;
    int32_t count;
    bool overflow;
    void push(int op, int64_t len) {
        if (len <= 0) return;
        if (count > 0 && (int)(out[count - 1] & 0xF) == op) {
            out[count - 1] += (uint32_t)(len << 4);
            return;
        }
        if (count >= maxc) { overflow = true; return; }
        out[count++] = (uint32_t)((len << 4) | op);
    }
};

// reverse run order in place (used to flip backward-emitted walks)
static void reverse_runs(uint32_t* ops, int32_t n) {
    for (int32_t a = 0, b = n - 1; a < b; a++, b--) {
        uint32_t t = ops[a]; ops[a] = ops[b]; ops[b] = t;
    }
}

// ---------------------------------------------------- device-steps decoding

// steps[b*M + (r-1)] for DP row r: (d_count) | (op << 16); op 0=M 1=I
// 2=inactive. term[b*term_stride + 0] = terminal leading-D count.
// Emits forward CIGARs. Returns 0, or -1 if any instance overflowed.
int lamsa_decode_steps(const int32_t* steps, const int32_t* term,
                       const int32_t* start_i, int32_t B, int32_t M,
                       int32_t term_stride, uint32_t* out_ops,
                       int32_t out_stride, int32_t* out_n) {
    int rc = 0;
    for (int32_t b = 0; b < B; b++) {
        RunBuf rb{out_ops + (int64_t)b * out_stride, out_stride, 0, false};
        const int32_t* srow = steps + (int64_t)b * M;
        // backward emission
        for (int32_t r = start_i[b]; r >= 1; r--) {
            int32_t w = srow[r - 1];
            int32_t op = w >> 16;
            int32_t cnt = w & 0xFFFF;
            rb.push(OP_D, cnt);
            if (op == 0) rb.push(OP_M, 1);
            else if (op == 1) rb.push(OP_I, 1);
        }
        rb.push(OP_D, term[(int64_t)b * term_stride]);
        reverse_runs(rb.out, rb.count);
        out_n[b] = rb.overflow ? -1 : rb.count;
        if (rb.overflow) rc = -1;
    }
    return rc;
}

// 16-bit packed variant: two rows per int32 word, each (count:14|op:2).
int lamsa_decode_steps16(const int32_t* steps16, const int32_t* term,
                         const int32_t* start_i, int32_t B, int32_t M2,
                         int32_t term_stride, uint32_t* out_ops,
                         int32_t out_stride, int32_t* out_n) {
    int rc = 0;
    for (int32_t b = 0; b < B; b++) {
        RunBuf rb{out_ops + (int64_t)b * out_stride, out_stride, 0, false};
        const int32_t* srow = steps16 + (int64_t)b * M2;
        for (int32_t r = start_i[b]; r >= 1; r--) {
            uint32_t w = (uint32_t)srow[(r - 1) >> 1];
            uint32_t s16 = (w >> (16 * ((r - 1) & 1))) & 0xFFFF;
            int32_t cnt = s16 & 0x3FFF;
            int32_t op = s16 >> 14;
            rb.push(OP_D, cnt);
            if (op == 0) rb.push(OP_M, 1);
            else if (op == 1) rb.push(OP_I, 1);
        }
        rb.push(OP_D, term[(int64_t)b * term_stride]);
        reverse_runs(rb.out, rb.count);
        out_n[b] = rb.overflow ? -1 : rb.count;
        if (rb.overflow) rc = -1;
    }
    return rc;
}

// Compact device-traceback decode: op bitmap (1 bit per DP row, 1 = I)
// + sparse 16-bit D events ((idx << 5) | count, count <= 30, ascending
// by idx, E uint16 slots = E/2 packed int32 words on the wire).
// See ops/banded_sw.py::_dp_tb_fused for the producer. n_ev[b] > E
// (including the 0xFFFF overflow sentinel for runs > 30) means the
// instance overflowed on device: out_n[b] = -2 and the caller must
// recompute it (native banded_sw_tb below).
int lamsa_decode_compact(const int32_t* opbits, const uint16_t* events,
                         const int32_t* term0, const int32_t* start_i,
                         const int32_t* n_ev, int32_t B, int32_t nw,
                         int32_t E, uint32_t* out_ops, int32_t out_stride,
                         int32_t* out_n) {
    int rc = 0;
    for (int32_t b = 0; b < B; b++) {
        if (n_ev[b] > E) { out_n[b] = -2; rc = -1; continue; }
        RunBuf rb{out_ops + (int64_t)b * out_stride, out_stride, 0, false};
        const int32_t* ob = opbits + (int64_t)b * nw;
        const uint16_t* ev = events + (int64_t)b * E;
        int32_t ptr = n_ev[b] - 1;
        for (int32_t r = start_i[b]; r >= 1; r--) {
            int32_t idx = r - 1;
            if (ptr >= 0 && (ev[ptr] >> 5) == idx) {
                rb.push(OP_D, ev[ptr] & 31);
                ptr--;
            }
            int bit = (ob[idx >> 5] >> (idx & 31)) & 1;
            rb.push(bit ? OP_I : OP_M, 1);
        }
        rb.push(OP_D, term0[b]);
        reverse_runs(rb.out, rb.count);
        out_n[b] = rb.overflow ? -1 : rb.count;
        if (rb.overflow) rc = -1;
    }
    return rc;
}

// Wide-event variant for buckets with M > 2048 (DP row indices do not
// fit the narrow 16-bit event): one int32 event per word,
// (row << 13) | count with count <= 8191, ascending by row,
// 0x7FFFFFFF padding. See ops/banded_sw.py::compact_wide.
int lamsa_decode_compact_wide(const int32_t* opbits,
                              const int32_t* events,
                              const int32_t* term0, const int32_t* start_i,
                              const int32_t* n_ev, int32_t B, int32_t nw,
                              int32_t E, uint32_t* out_ops,
                              int32_t out_stride, int32_t* out_n) {
    int rc = 0;
    for (int32_t b = 0; b < B; b++) {
        if (n_ev[b] > E) { out_n[b] = -2; rc = -1; continue; }
        RunBuf rb{out_ops + (int64_t)b * out_stride, out_stride, 0, false};
        const int32_t* ob = opbits + (int64_t)b * nw;
        const int32_t* ev = events + (int64_t)b * E;
        int32_t ptr = n_ev[b] - 1;
        for (int32_t r = start_i[b]; r >= 1; r--) {
            int32_t idx = r - 1;
            if (ptr >= 0 && (ev[ptr] >> 13) == idx) {
                rb.push(OP_D, ev[ptr] & 8191);
                ptr--;
            }
            int bit = (ob[idx >> 5] >> (idx & 31)) & 1;
            rb.push(bit ? OP_I : OP_M, 1);
        }
        rb.push(OP_D, term0[b]);
        reverse_runs(rb.out, rb.count);
        out_n[b] = rb.overflow ? -1 : rb.count;
        if (rb.overflow) rc = -1;
    }
    return rc;
}

// ------------------------------------------------- banded dirs traceback

// dirs: uint8[M, W], row r at index r-1; lane d of row i = cell
// (i, i + lo + d). Bit layout per ops/oracle.py.
int lamsa_traceback_banded(const uint8_t* dirs, int32_t M, int32_t W,
                           int32_t lo, int32_t i, int32_t j,
                           uint32_t* out_ops, int32_t maxc,
                           int32_t* out_n) {
    RunBuf rb{out_ops, maxc, 0, false};
    int state = 0;  // 0=H 1=E 2=F
    while (i > 0 && j > 0) {
        int d = dirs[(int64_t)(i - 1) * W + (j - i - lo)];
        if (state == 0) {
            int src = d & 3;
            if (src == 0) { rb.push(OP_M, 1); i--; j--; }
            else if (src == 1) state = 1;
            else state = 2;
        } else if (state == 1) {
            rb.push(OP_D, 1);
            if (!(d & 4)) state = 0;
            j--;
        } else {
            rb.push(OP_I, 1);
            if (!(d & 8)) state = 0;
            i--;
        }
    }
    if (j > 0) rb.push(OP_D, j);
    if (i > 0) rb.push(OP_I, i);
    reverse_runs(rb.out, rb.count);
    *out_n = rb.overflow ? -1 : rb.count;
    return rb.overflow ? -1 : 0;
}

// -------------------------------------------------------- scalar banded SW

// Shared DP fill for the ksw-equivalent CPU kernel: banded affine-gap
// DP with the identical scoring/tie-break contract as ops/oracle.py.
// Fills `dir` (rows 0..m, W lanes) and returns H[m][n] via *score_mn.
static int sw_fill_dirs(const uint8_t* q, int32_t m, const uint8_t* t,
                        int32_t n, int32_t match, int32_t mis,
                        int32_t gapo, int32_t gape, int32_t lo, int32_t hi,
                        std::vector<uint8_t>& dir, int32_t* score_mn) {
    const int32_t NEG = -(1 << 29);
    if (!(lo <= 0 && hi >= 0)) return -2;
    int32_t W = hi - lo + 1;
    std::vector<int32_t> H((int64_t)(m + 1) * W, NEG), E(H), F(H);
    dir.assign((int64_t)(m + 1) * W, 0);
    auto idx = [&](int32_t i, int32_t j) -> int64_t {
        return (int64_t)i * W + (j - i - lo);
    };
    auto inb = [&](int32_t i, int32_t j) {
        return j >= 0 && j <= n && j - i >= lo && j - i <= hi;
    };
    H[idx(0, 0)] = 0;
    for (int32_t j = 1; j <= n && j <= hi; j++) {
        E[idx(0, j)] = -(gapo + j * gape);
        H[idx(0, j)] = E[idx(0, j)];
        dir[idx(0, j)] = 1 | (j > 1 ? 4 : 0);
    }
    for (int32_t i = 1; i <= m && -i >= lo; i++) {
        F[idx(i, 0)] = -(gapo + i * gape);
        H[idx(i, 0)] = F[idx(i, 0)];
        dir[idx(i, 0)] = 2 | (i > 1 ? 8 : 0);
    }
    for (int32_t i = 1; i <= m; i++) {
        int32_t jlo = i + lo > 1 ? i + lo : 1;
        int32_t jhi = i + hi < n ? i + hi : n;
        for (int32_t j = jlo; j <= jhi; j++) {
            uint8_t d = 0;
            int32_t e_open = inb(i, j - 1) ? H[idx(i, j - 1)] - gapo - gape
                                            : NEG;
            int32_t e_ext = inb(i, j - 1) ? E[idx(i, j - 1)] - gape : NEG;
            int32_t e;
            // no NEG clamp on E/F: tie-breaking must match
            // ops/oracle.py, which clamps H only
            if (e_ext >= e_open) { e = e_ext; d |= 4; } else e = e_open;
            E[idx(i, j)] = e;
            int32_t f_open = inb(i - 1, j) ? H[idx(i - 1, j)] - gapo - gape
                                            : NEG;
            int32_t f_ext = inb(i - 1, j) ? F[idx(i - 1, j)] - gape : NEG;
            int32_t f;
            if (f_ext >= f_open) { f = f_ext; d |= 8; } else f = f_open;
            F[idx(i, j)] = f;
            int32_t s = (q[i - 1] < 4 && t[j - 1] < 4 && q[i - 1] == t[j - 1])
                            ? match : -mis;
            int32_t dg = inb(i - 1, j - 1) ? H[idx(i - 1, j - 1)] + s : NEG;
            int32_t best = dg;
            uint8_t src = 0;
            if (e > best) { best = e; src = 1; }
            if (f > best) { best = f; src = 2; }
            if (best < NEG) best = NEG;
            H[idx(i, j)] = best;
            dir[idx(i, j)] = d | src;
        }
    }
    *score_mn = (n - m >= lo && n - m <= hi) ? H[idx(m, n)] : NEG;
    return 0;
}

// Global entry: fill + traceback from (m, n).
int lamsa_banded_sw_cpu(const uint8_t* q, int32_t m, const uint8_t* t,
                        int32_t n, int32_t match, int32_t mis,
                        int32_t gapo, int32_t gape, int32_t lo, int32_t hi,
                        int32_t* score_out, uint32_t* out_ops,
                        int32_t maxc, int32_t* out_n) {
    if (!(lo <= 0 && hi >= 0 && lo <= n - m && n - m <= hi)) return -2;
    std::vector<uint8_t> dir;
    int rc = sw_fill_dirs(q, m, t, n, match, mis, gapo, gape, lo, hi, dir,
                          score_out);
    if (rc != 0) return rc;
    int32_t W = hi - lo + 1;
    // dir stores row i at index i (row 0 = init row); the walker expects
    // row i at index i-1, and lane d of row i here is (j - i - lo) which
    // matches the walker's convention — skip the init row.
    return lamsa_traceback_banded(dir.data() + W, m, W, lo, m, n, out_ops,
                                  maxc, out_n);
}

// Arbitrary-start entry: fill + traceback from (si, sj). Used to
// recompute (bit-identically) the rare instances whose compact device
// traceback overflowed the event budget. Score is not returned (the
// device already shipped it).
int lamsa_banded_sw_tb(const uint8_t* q, int32_t m, const uint8_t* t,
                       int32_t n, int32_t match, int32_t mis,
                       int32_t gapo, int32_t gape, int32_t lo, int32_t hi,
                       int32_t si, int32_t sj, uint32_t* out_ops,
                       int32_t maxc, int32_t* out_n) {
    if (si < 0 || si > m || sj < 0 || sj > n) return -2;
    std::vector<uint8_t> dir;
    int32_t score;
    int rc = sw_fill_dirs(q, m, t, n, match, mis, gapo, gape, lo, hi, dir,
                          &score);
    if (rc != 0) return rc;
    int32_t W = hi - lo + 1;
    return lamsa_traceback_banded(dir.data() + W, m, W, lo,
                                  si, sj, out_ops, maxc, out_n);
}

// -------------------------------------------------- anchors -> blocks

// Chain anchors (q, r int64 pairs, chain order) -> non-overlapping
// exact-match blocks (q_start, r_start, length). Same-diagonal
// contiguous anchors merge; conflicting overlaps drop the anchor.
// Mirrors pipeline/skeleton.py::anchors_to_blocks (the spec).
int64_t lamsa_anchors_to_blocks(const int64_t* anchors, int64_t n,
                                int32_t k, int64_t* out_blocks) {
    int64_t m = 0;
    for (int64_t i = 0; i < n; i++) {
        int64_t q = anchors[2 * i], r = anchors[2 * i + 1];
        if (m == 0) {
            out_blocks[0] = q; out_blocks[1] = r; out_blocks[2] = k;
            m = 1;
            continue;
        }
        int64_t* b = out_blocks + 3 * (m - 1);
        int64_t bq = b[0], br = b[1], bl = b[2];
        if (q - r == bq - br && q <= bq + bl) {
            int64_t nl = q + k - bq;
            if (nl > bl) b[2] = nl;
        } else if (q >= bq + bl && r >= br + bl) {
            out_blocks[3 * m] = q;
            out_blocks[3 * m + 1] = r;
            out_blocks[3 * m + 2] = k;
            m++;
        }
    }
    return m;
}

// ---------------------------------------------------------------- NM calc

// nm over the core cigar (no clips) given aligned q/t code windows.
int64_t lamsa_nm_from_cigar(const uint8_t* q, const uint8_t* t,
                            const uint32_t* ops, int32_t n_ops) {
    int64_t nm = 0, i = 0, j = 0;
    for (int32_t k = 0; k < n_ops; k++) {
        int op = ops[k] & 0xF;
        int64_t ln = ops[k] >> 4;
        if (op == OP_M) {
            for (int64_t x = 0; x < ln; x++)
                nm += (q[i + x] != t[j + x]) || q[i + x] >= 4 ||
                      t[j + x] >= 4;
            i += ln; j += ln;
        } else if (op == OP_I) { nm += ln; i += ln; }
        else if (op == OP_D) { nm += ln; j += ln; }
        else if (op == 4) { i += ln; }  // S
    }
    return nm;
}

}  // extern "C"

// ----------------------------------------------------- suffix array (SA-IS)
//
// Linear-time suffix array construction (Nong/Zhang/Chan SA-IS),
// written from the published algorithm. Used to build the FM-index
// (BWT + Occ + sampled SA) that replaces the reference's external GEM
// FM-index for whole-genome seeding (SURVEY.md section 7 step 2a).
// uint32 indices: texts up to 4 Gi (GRCh38 = 3.1 G). T must end with a
// unique smallest sentinel (value 0, occurring exactly once, at T[n-1]).

namespace {

const uint32_t EMPTY_ = 0xFFFFFFFFu;

inline bool is_lms(const uint8_t* st, size_t i) {
    return i > 0 && st[i] && !st[i - 1];
}

// Memory-optimal SA-IS (still the published Nong/Zhang/Chan induced-
// sorting algorithm; the output suffix array is unique, so these
// engineering changes are bit-exact by construction — property-tested
// in tests/test_native.py):
//   * the reduced text s1 and the LMS-position table P live inside
//     SA's free tail (n1 <= n/2 guarantees the regions never overlap,
//     including across recursion levels) instead of separate vectors —
//     at GRCh38 scale this removes ~18 GB of peak RSS;
//   * the per-symbol histogram is computed ONCE per level (the old
//     fill_bkt rescanned the whole text on every bucket (re)fill —
//     ~5 redundant full-text scans per level);
//   * the suffix-type array is uint8 (vector<bool> bit extraction sat
//     in the induce inner loops);
//   * the LMS-substring naming compares run on a small thread pool
//     (each i compares SA[i] vs SA[i-1] independently; the name
//     prefix-sum stays sequential).
template <typename C>
void sais_impl(const C* T, uint32_t* SA, size_t n, size_t K) {
    std::vector<uint8_t> st(n);
    st[n - 1] = 1;
    for (size_t i = n - 1; i-- > 0;)
        st[i] = (T[i] < T[i + 1]) || (T[i] == T[i + 1] && st[i + 1]);

    std::vector<uint32_t> cnt(K, 0u), bkt(K);
    for (size_t i = 0; i < n; i++) cnt[T[i]]++;
    auto fill_bkt = [&](bool ends) {
        uint32_t sum = 0;
        for (size_t c = 0; c < K; c++) {
            sum += cnt[c];
            bkt[c] = ends ? sum : sum - cnt[c];
        }
    };
    const uint8_t* stp = st.data();
    auto induce = [&]() {
        fill_bkt(false);
        for (size_t i = 0; i < n; i++) {
            uint32_t j = SA[i];
            if (j != EMPTY_ && j > 0 && !stp[j - 1]) SA[bkt[T[j - 1]]++] = j - 1;
        }
        fill_bkt(true);
        for (size_t i = n; i-- > 0;) {
            uint32_t j = SA[i];
            if (j != EMPTY_ && j > 0 && stp[j - 1]) SA[--bkt[T[j - 1]]] = j - 1;
        }
    };

    std::fill(SA, SA + n, EMPTY_);
    fill_bkt(true);
    for (size_t i = 1; i < n; i++)
        if (is_lms(stp, i)) SA[--bkt[T[i]]] = (uint32_t)i;
    induce();

    size_t n1 = 0;
    for (size_t i = 0; i < n; i++)
        if (SA[i] != EMPTY_ && is_lms(stp, SA[i])) SA[n1++] = SA[i];
    std::fill(SA + n1, SA + n, EMPTY_);

    // name LMS substrings: parallel per-i "differs from predecessor"
    // compares, then a sequential prefix-sum into names
    size_t name = 0;
    if (n1 > 0) {
        std::vector<uint8_t> diff(n1, 0);
        auto cmp_range = [&](size_t lo, size_t hi) {
            for (size_t i = lo; i < hi; i++) {
                if (i == 0) { diff[0] = 1; continue; }
                uint32_t pos = SA[i], prev = SA[i - 1];
                for (size_t d = 0;; d++) {
                    if (pos + d == n || prev + d == n ||
                        T[pos + d] != T[prev + d] ||
                        stp[pos + d] != stp[prev + d]) {
                        diff[i] = 1;
                        break;
                    }
                    if (d > 0 && (is_lms(stp, pos + d) ||
                                  is_lms(stp, prev + d))) {
                        diff[i] = !(is_lms(stp, pos + d) &&
                                    is_lms(stp, prev + d));
                        break;
                    }
                }
            }
        };
        unsigned nt = std::thread::hardware_concurrency();
        if (nt > 1 && n1 > (1u << 20)) {
            nt = nt > 4 ? 4 : nt;
            std::vector<std::thread> ths;
            size_t per = (n1 + nt - 1) / nt;
            for (unsigned t = 0; t < nt; t++) {
                size_t lo = t * per, hi = lo + per < n1 ? lo + per : n1;
                if (lo < hi) ths.emplace_back(cmp_range, lo, hi);
            }
            for (auto& th : ths) th.join();
        } else {
            cmp_range(0, n1);
        }
        for (size_t i = 0; i < n1; i++) {
            name += diff[i];
            uint32_t pos = SA[i];
            SA[n1 + pos / 2] = (uint32_t)(name - 1);
        }
    }
    // compact names into SA's tail: the reduced text s1 = SA[n-n1, n)
    for (size_t i = n, j = n; i-- > n1;)
        if (SA[i] != EMPTY_) SA[--j] = SA[i];
    uint32_t* s1 = SA + n - n1;

    if (name < n1) {
        sais_impl<uint32_t>(s1, SA, n1, name);
    } else {
        for (size_t i = 0; i < n1; i++) SA[s1[i]] = (uint32_t)i;
    }
    // s1's text is consumed; reuse its region for the LMS position
    // table P (text order), then map reduced-SA entries to positions
    for (size_t i = 1, j = 0; i < n; i++)
        if (is_lms(stp, i)) s1[j++] = (uint32_t)i;
    for (size_t i = 0; i < n1; i++) SA[i] = s1[SA[i]];
    std::fill(SA + n1, SA + n, EMPTY_);
    fill_bkt(true);
    for (size_t i = n1; i-- > 0;) {
        uint32_t j = SA[i];
        SA[i] = EMPTY_;
        SA[--bkt[T[j]]] = j;
    }
    induce();
}

}  // namespace

extern "C" {

// Build the suffix array of codes[0..n) + implicit handling: caller
// appends the sentinel (value 0 must be unique; pass codes shifted +1
// with a trailing 0). K = alphabet size including sentinel.
int lamsa_sais_u8(const uint8_t* T, uint32_t* SA, int64_t n, int32_t K) {
    if (n <= 0 || T[n - 1] != 0) return -1;
    sais_impl<uint8_t>(T, SA, (size_t)n, (size_t)K);
    return 0;
}

// BWT from SA: bwt[i] = T[SA[i]-1] (codes WITHOUT sentinel shift),
// sentinel row excluded (BWA-style): returns primary (the row where
// SA[i]==0, whose BWT char is the sentinel). bwt_out has length n-1
// (the $-less BWT over the original n-1 chars... here n includes the
// sentinel, so output length n-1).
int64_t lamsa_bwt_from_sa(const uint8_t* codes, const uint32_t* SA,
                          int64_t n, uint8_t* bwt_out) {
    // find the sentinel row first; every output index is then
    // i - (i > primary), so the fill parallelizes cleanly
    int64_t primary = -1;
    for (int64_t i = 0; i < n; i++)
        if (SA[i] == 0) { primary = i; break; }
    if (primary < 0) return -1;
    auto fill = [&](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; i++) {
            if (i == primary) continue;
            bwt_out[i - (i > primary)] = codes[SA[i] - 1];
        }
    };
    unsigned nt = std::thread::hardware_concurrency();
    if (nt > 1 && n > (int64_t)1 << 24) {
        nt = nt > 4 ? 4 : nt;
        std::vector<std::thread> ths;
        int64_t per = (n + nt - 1) / nt;
        for (unsigned t = 0; t < nt; t++) {
            int64_t lo = (int64_t)t * per, hi = lo + per < n ? lo + per : n;
            if (lo < hi) ths.emplace_back(fill, lo, hi);
        }
        for (auto& th : ths) th.join();
    } else {
        fill(0, n);
    }
    return primary;
}

}  // extern "C"


// ---------------------------------------------------------------- chains
// Native twin of pipeline/skeleton.py::backtrack_chains (the Python
// body is the spec; property-tested equal in tests/test_skeleton.py).
// Greedy chain selection from sparse-DP output with anchor-coverage
// overlap rejection. Outputs chains in encounter order:
//   out_idx:  flat anchor hit-indices (root->end per chain)
//   out_off:  per-chain start offsets into out_idx (n_chains+1 entries)
//   out_meta: per-chain [is_secondary, score, strand, read_start,
//             read_end] (5 x int32)
//   out_alt:  best rejected chain score
// Returns n_chains emitted (accepted + secondaries), or -1 on overflow.
extern "C" int lamsa_backtrack_chains(
        const int32_t* f, const int32_t* pred, const int32_t* qpos,
        const int32_t* strand, const uint8_t* valid, int32_t H,
        int32_t k, int32_t read_len, int32_t min_anchors,
        int32_t min_score, int32_t max_chains, double max_overlap_frac,
        int32_t keep_secondaries,
        int32_t* out_idx, int32_t* out_off, int32_t* out_meta,
        int32_t* out_alt) {
    std::vector<int32_t> order(H);
    for (int32_t i = 0; i < H; i++) order[i] = i;
    std::stable_sort(order.begin(), order.end(),
                     [&](int32_t a, int32_t b) { return f[a] > f[b]; });

    std::vector<uint8_t> used(H, 0);
    const int32_t nbits = read_len + 1;
    const int32_t nw = (nbits + 63) / 64;
    std::vector<uint64_t> covered(nw, 0), own(nw, 0);
    std::vector<int32_t> idxs;
    idxs.reserve(H);

    auto set_range = [&](std::vector<uint64_t>& bs, int64_t a, int64_t b) {
        // bits [a, b) within [0, nbits)
        if (a < 0) a = 0;
        if (b > nbits) b = nbits;
        for (int64_t x = a; x < b; x++) bs[x >> 6] |= 1ULL << (x & 63);
    };

    int32_t n_chains = 0, n_parts = 0, n_sec = 0, alt = 0, widx = 0;
    out_off[0] = 0;
    for (int32_t oi = 0; oi < H; oi++) {
        int32_t end = order[oi];
        if (f[end] < min_score || !valid[end]) break;
        if (used[end]) continue;
        idxs.clear();
        int32_t i = end;
        bool clean = true;
        while (i >= 0) {
            if (used[i]) { clean = false; break; }
            idxs.push_back(i);
            i = pred[i];
        }
        if (!clean || (int32_t)idxs.size() < min_anchors) {
            for (int32_t x : idxs) used[x] = 1;
            continue;
        }
        std::reverse(idxs.begin(), idxs.end());
        for (int32_t x : idxs) used[x] = 1;

        int32_t st = strand[idxs.front()];
        int32_t q0 = qpos[idxs.front()], q1 = qpos[idxs.back()] + k;
        int32_t rs = (st == 0) ? q0 : read_len - q1;
        int32_t re = (st == 0) ? q1 : read_len - q0;

        std::fill(own.begin(), own.end(), 0);
        for (int32_t x : idxs) {
            int64_t a = (st == 0) ? (int64_t)qpos[x]
                                  : (int64_t)read_len - qpos[x] - k;
            set_range(own, a, a + k);
        }
        int64_t own_sum = 0, overlap = 0;
        for (int32_t w = 0; w < nw; w++) {
            own_sum += __builtin_popcountll(own[w]);
            overlap += __builtin_popcountll(own[w] & covered[w]);
        }
        bool secondary = false;
        if ((double)overlap >
                max_overlap_frac * (double)(own_sum > 1 ? own_sum : 1)
            || n_parts >= max_chains) {
            if (f[end] > alt) alt = f[end];
            if (n_sec >= keep_secondaries) continue;
            secondary = true;
            n_sec++;
        } else {
            for (int32_t w = 0; w < nw; w++) covered[w] |= own[w];
            n_parts++;
        }
        if (widx + (int32_t)idxs.size() > H) return -1;  // can't happen
        for (int32_t x : idxs) out_idx[widx++] = x;
        int32_t* m = out_meta + 5 * n_chains;
        m[0] = secondary;
        m[1] = f[end];
        m[2] = st;
        m[3] = rs;
        m[4] = re;
        out_off[++n_chains] = widx;
    }
    *out_alt = alt;
    return n_chains;
}
