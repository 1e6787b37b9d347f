// Native host data path: sequence scanning and site sorting.
//
// TPU-native counterpart of the reference's host-side native layer
// (/root/reference/src/ISSL/isslCreateIndex.cpp does its scanning and
// sorting in C++; the Python extractor extractOfftargets.py:23-24,97-108
// uses regex + external sort). Here: rolling 2-bit windows with branch-light
// predicate tests, OpenMP-parallel chunking, and a parallel radix sort for
// the site lists. Exposed through ctypes (see native/__init__.py).
//
// Semantics replicated exactly (score-visible quirks included):
//  * off-target forward  (?=([ACG][ACGT]{19}[ACGT][AG]G)) -> first 20
//  * off-target reverse  (?=(C[CT][ACGT][ACGT]{19}[TGC])) -> rc(first 20)
//    (i.e. the stored reverse site includes the PAM bases, like the
//    reference)
//  * candidate forward   (?=([ATCG]{21}GG))    -> 23-mer
//  * candidate reverse   (?=(CC[ACGT]{21}))    -> rc(23-mer)
// Signatures are packed low-first: position j at bits 2j (A=0,C=1,G=2,T=3).
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC extract.cpp

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>
#include <memory>
#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr uint8_t BAD = 255;

inline void build_code_table(uint8_t* table, bool to_upper) {
    memset(table, BAD, 256);
    table[(unsigned)'A'] = 0;
    table[(unsigned)'C'] = 1;
    table[(unsigned)'G'] = 2;
    table[(unsigned)'T'] = 3;
    if (to_upper) {
        table[(unsigned)'a'] = 0;
        table[(unsigned)'c'] = 1;
        table[(unsigned)'g'] = 2;
        table[(unsigned)'t'] = 3;
    }
}

// reverse complement of a low-first packed L-mer
inline uint64_t rc_sig(uint64_t sig, int L) {
    uint64_t out = 0;
    for (int j = 0; j < L; j++) {
        uint64_t base = (sig >> (2 * j)) & 3;
        out |= (base ^ 3ULL) << (2 * (L - 1 - j));
    }
    return out;
}

struct Scan {
    std::vector<uint8_t> codes;
    std::vector<int32_t> badpfx;   // prefix count of invalid codes

    Scan(const char* seq, int64_t n, bool to_upper) : codes(n), badpfx(n + 1) {
        uint8_t table[256];
        build_code_table(table, to_upper);
        badpfx[0] = 0;
        for (int64_t i = 0; i < n; i++) {
            uint8_t c = table[(uint8_t)seq[i]];
            codes[i] = c;
            badpfx[i + 1] = badpfx[i] + (c == BAD);
        }
    }

    inline bool window_valid(int64_t i, int len) const {
        return badpfx[i + len] == badpfx[i];
    }

    inline uint64_t pack(int64_t i, int len) const {
        uint64_t sig = 0;
        for (int j = 0; j < len; j++)
            sig |= (uint64_t)codes[i + j] << (2 * j);
        return sig;
    }
};

}  // namespace

extern "C" {

// All possible off-target 20-mer signatures. Returns the count; writes up
// to `cap` signatures (forward hits first, then reverse, matching the
// Python extractor's per-sequence ordering). OpenMP over chunks of window
// starts: a counting pass places each chunk's hits, a second pass writes
// them, so the output is the serial scan's, in its order.
int64_t ct_extract_offtargets(const char* seq, int64_t n, int to_upper,
                              uint64_t* out, int64_t cap) {
    if (n < 23) return 0;
    uint8_t table[256];
    build_code_table(table, to_upper != 0);
    std::unique_ptr<uint8_t[]> buf(new uint8_t[n]);
    uint8_t* codes = buf.get();
    #ifdef _OPENMP
    #pragma omp parallel for schedule(static)
    #endif
    for (int64_t i = 0; i < n; i++) codes[i] = table[(uint8_t)seq[i]];

    const int64_t last = n - 22;
    const uint64_t mask40 = (1ULL << 40) - 1;
    const int64_t nchunk = std::min<int64_t>(last, 1024);
    std::vector<int64_t> fcnt(nchunk + 1, 0), rcnt(nchunk + 1, 0);
    // pass 0 counts each chunk's forward and reverse hits; pass 1 writes
    // them at the offsets the counts give
    for (int pass = 0; pass < 2; pass++) {
        #ifdef _OPENMP
        #pragma omp parallel for schedule(dynamic, 1)
        #endif
        for (int64_t k = 0; k < nchunk; k++) {
            const int64_t lo = last * k / nchunk, hi = last * (k + 1) / nchunk;
            int bad = 0;            // invalid codes in codes[i, i + 23)
            uint64_t sig = 0, rc = 0;
            for (int j = 0; j < 22; j++) bad += codes[lo + j] == BAD;
            for (int j = 0; j < 20; j++) {
                sig |= (uint64_t)(codes[lo + j] & 3) << (2 * j);
                rc |= (uint64_t)((codes[lo + j] & 3) ^ 3) << (2 * (19 - j));
            }
            int64_t f = pass ? fcnt[k] : 0, r = pass ? rcnt[k] : 0;
            for (int64_t i = lo; i < hi; i++) {
                const uint8_t c0 = codes[i], c1 = codes[i + 1],
                              c21 = codes[i + 21], c22 = codes[i + 22];
                bad += c22 == BAD;
                if (bad == 0) {
                    if (c0 != 3 && c22 == 2 && (c21 & 1) == 0) {
                        if (pass && f < cap) out[f] = sig;
                        f++;
                    }
                    if (c0 == 1 && (c1 & 1) == 1 && c22 != 0) {
                        if (pass && r < cap) out[r] = rc;
                        r++;
                    }
                }
                bad -= c0 == BAD;
                const uint64_t c20 = codes[i + 20] & 3;
                sig = (sig >> 2) | (c20 << 38);
                rc = ((rc << 2) | (c20 ^ 3)) & mask40;
            }
            if (!pass) {
                fcnt[k] = f;
                rcnt[k] = r;
            }
        }
        if (!pass) {
            // exclusive offsets: the forward hits, then the reverse
            int64_t acc = 0;
            for (int64_t k = 0; k < nchunk; k++) {
                const int64_t c = fcnt[k];
                fcnt[k] = acc;
                acc += c;
            }
            for (int64_t k = 0; k < nchunk; k++) {
                const int64_t c = rcnt[k];
                rcnt[k] = acc;
                acc += c;
            }
            fcnt[nchunk] = rcnt[nchunk] = acc;
        }
    }
    return fcnt[nchunk];
}

// Candidate 23-mer target sites. Writes signatures, start positions and
// strands ('+' = 0, '-' = 1); forward hits first then reverse, ascending
// position within each strand (reference Crackling.py:151-165).
int64_t ct_extract_candidates(const char* seq, int64_t n,
                              uint64_t* out_sig, int64_t* out_pos,
                              uint8_t* out_strand, int64_t cap) {
    if (n < 23) return 0;
    Scan sc(seq, n, /*to_upper=*/false);
    int64_t count = 0;
    const int64_t last = n - 22;
    for (int64_t i = 0; i < last; i++) {
        if (sc.codes[i + 21] == 2 && sc.codes[i + 22] == 2 &&
            sc.window_valid(i, 23)) {
            if (count < cap) {
                out_sig[count] = sc.pack(i, 23);
                out_pos[count] = i;
                out_strand[count] = 0;
            }
            count++;
        }
    }
    for (int64_t i = 0; i < last; i++) {
        if (sc.codes[i] == 1 && sc.codes[i + 1] == 1 && sc.window_valid(i, 23)) {
            if (count < cap) {
                out_sig[count] = rc_sig(sc.pack(i, 23), 23);
                out_pos[count] = i;
                out_strand[count] = 1;
            }
            count++;
        }
    }
    return count;
}

// PAM-candidate 23-mer windows over an already-encoded genome (codes 0..3,
// 255 at record separators). Emits (low-first signature, position) for
// every valid window that can match a guide PAM variant — forward windows
// ending GG/AG or reverse-candidate windows starting CC/CT — in ascending
// position order. Returns the count (writes up to cap). Backs the
// positioning stage's persistent window index (pipeline/positioning.py).
int64_t ct_pam_windows(const uint8_t* codes, int64_t n, uint64_t* out_sig,
                       int64_t* out_pos, int64_t cap) {
    if (n < 23) return 0;
    const int64_t last = n - 22;
    const uint64_t mask46 = (1ULL << 46) - 1;
    int64_t count = 0;
    uint64_t sig = 0;
    int bad = 0;  // invalid codes among the current window's first 22 bases
    for (int64_t j = 0; j < 22; j++) {
        bad += codes[j] > 3;
        sig |= (uint64_t)(codes[j] & 3) << (2 * j);
    }
    for (int64_t i = 0; i < last; i++) {
        const uint8_t cl = codes[i + 22];
        bad += cl > 3;
        sig |= (uint64_t)(cl & 3) << 44;
        const uint8_t c0 = codes[i], c1 = codes[i + 1], c21 = codes[i + 21];
        const bool fwd = cl == 2 && (c21 == 2 || c21 == 0);
        const bool rev = c0 == 1 && (c1 == 1 || c1 == 3);
        if ((fwd || rev) && bad == 0) {
            if (count < cap) {
                out_sig[count] = sig;
                out_pos[count] = i;
            }
            count++;
        }
        bad -= codes[i] > 3;
        sig = (sig >> 2) & mask46;
    }
    return count;
}

// Lexicographic site signatures -> ASCII text rows "SEQ\n" ((length+1)
// bytes per row). The extraction CLI's output formatter: OpenMP over
// sites (the numpy fallback costs ~1 us/site, which dominated extraction
// at genome scale).
void ct_lex_to_text(const uint64_t* in, int64_t n, int length, uint8_t* out) {
    static const char L[4] = {'A', 'C', 'G', 'T'};
    const int w = length + 1;
    #ifdef _OPENMP
    #pragma omp parallel for
    #endif
    for (int64_t i = 0; i < n; i++) {
        uint64_t v = in[i];
        uint8_t* row = out + i * w;
        for (int j = length - 1; j >= 0; j--) {
            row[j] = L[v & 3];
            v >>= 2;
        }
        row[length] = '\n';
    }
}

// Fixed-width ASCII site lines -> low-first packed signatures (the
// createIsslIndex text-ingest hot loop). Returns -1 on success or the
// index of the first row with a non-ACGT base.
int64_t ct_pack_lines(const uint8_t* rows, int64_t n, int width,
                      int seq_length, uint64_t* out) {
    uint8_t table[256];
    build_code_table(table, /*to_upper=*/true);
    int64_t bad = -1;
    #ifdef _OPENMP
    #pragma omp parallel for
    #endif
    for (int64_t i = 0; i < n; i++) {
        const uint8_t* row = rows + i * width;
        uint64_t sig = 0;
        bool ok = true;
        for (int j = 0; j < seq_length; j++) {
            uint8_t c = table[row[j]];
            ok &= c != BAD;
            sig |= (uint64_t)(c & 3) << (2 * j);
        }
        out[i] = sig;
        if (!ok) {
            #ifdef _OPENMP
            #pragma omp critical
            #endif
            { if (bad < 0 || i < bad) bad = i; }
        }
    }
    return bad;
}

// In-place parallel LSD radix sort of uint64 keys, 8 bits a pass. A pass
// whose byte is the same in every key is skipped (40-bit signatures take
// 5). Each thread counts its own range; ranges scatter in order, so every
// pass is stable.
void ct_sort_u64(uint64_t* arr, int64_t n) {
    if (n < 2) return;
    uint64_t all_or = 0, all_and = ~0ULL;
    #ifdef _OPENMP
    #pragma omp parallel for reduction(|:all_or) reduction(&:all_and)
    #endif
    for (int64_t i = 0; i < n; i++) {
        all_or |= arr[i];
        all_and &= arr[i];
    }
    const uint64_t varies = all_or ^ all_and;
    std::unique_ptr<uint64_t[]> tmp(new uint64_t[n]);
    uint64_t* src = arr;
    uint64_t* dst = tmp.get();
    int maxt = 1;
    #ifdef _OPENMP
    maxt = omp_get_max_threads();
    #endif
    std::vector<int64_t> pos((size_t)maxt * 256);
    for (int pass = 0; pass < 8; pass++) {
        const int shift = pass * 8;
        if (((varies >> shift) & 0xFF) == 0) continue;
        #ifdef _OPENMP
        #pragma omp parallel num_threads(maxt)
        #endif
        {
            int t = 0, nt = 1;
            #ifdef _OPENMP
            t = omp_get_thread_num();
            nt = omp_get_num_threads();
            #endif
            const int64_t lo = n * t / nt, hi = n * (t + 1) / nt;
            int64_t* mine = pos.data() + (size_t)t * 256;
            std::fill(mine, mine + 256, 0);
            for (int64_t i = lo; i < hi; i++) mine[(src[i] >> shift) & 0xFF]++;
            #ifdef _OPENMP
            #pragma omp barrier
            #pragma omp single
            #endif
            {
                int64_t acc = 0;
                for (int b = 0; b < 256; b++)
                    for (int u = 0; u < nt; u++) {
                        const int64_t c = pos[(size_t)u * 256 + b];
                        pos[(size_t)u * 256 + b] = acc;
                        acc += c;
                    }
            }
            for (int64_t i = lo; i < hi; i++)
                dst[mine[(src[i] >> shift) & 0xFF]++] = src[i];
        }
        std::swap(src, dst);
    }
    if (src != arr) memcpy(arr, src, (size_t)n * sizeof(uint64_t));
}

// Run-length unique of a sorted array: writes distinct values and counts,
// returns the number of distinct values (reference occurrence counting,
// isslCreateIndex.cpp:184-207). Each thread takes the runs that start in
// its range of the input.
int64_t ct_unique_counts(const uint64_t* sorted, int64_t n,
                         uint64_t* out_vals, uint32_t* out_counts) {
    if (n == 0) return 0;
    int maxt = 1;
    #ifdef _OPENMP
    maxt = omp_get_max_threads();
    #endif
    std::vector<int64_t> heads(maxt + 1, 0);
    int used = 1;
    #ifdef _OPENMP
    #pragma omp parallel num_threads(maxt)
    #endif
    {
        int t = 0, nt = 1;
        #ifdef _OPENMP
        t = omp_get_thread_num();
        nt = omp_get_num_threads();
        #endif
        const int64_t lo = n * t / nt, hi = n * (t + 1) / nt;
        int64_t m = 0;
        for (int64_t i = lo; i < hi; i++)
            m += i == 0 || sorted[i] != sorted[i - 1];
        heads[t + 1] = m;
        #ifdef _OPENMP
        #pragma omp barrier
        #pragma omp single
        #endif
        {
            used = nt;
            for (int u = 0; u < nt; u++) heads[u + 1] += heads[u];
        }
        m = heads[t];
        for (int64_t i = lo; i < hi; i++) {
            if (i != 0 && sorted[i] == sorted[i - 1]) continue;
            int64_t j = i + 1;
            while (j < n && sorted[j] == sorted[i]) j++;
            out_vals[m] = sorted[i];
            out_counts[m] = (uint32_t)(j - i);
            m++;
        }
    }
    return heads[used];
}

// One slice of the index's inverted lists: the ids 0..n-1 ordered by
// their bucket (sigs >> shift) & (nbuckets - 1), stably, as numpy's stable
// argsort orders them, and the buckets' starts (offsets[b], with
// offsets[nbuckets] == n). A parallel counting sort.
void ct_bucket_order(const uint64_t* sigs, int64_t n, int shift,
                     int nbuckets, int32_t* order, int64_t* offsets) {
    const uint64_t mask = (uint64_t)nbuckets - 1;
    int maxt = 1;
    #ifdef _OPENMP
    maxt = omp_get_max_threads();
    #endif
    std::vector<int64_t> pos((size_t)maxt * nbuckets);
    #ifdef _OPENMP
    #pragma omp parallel num_threads(maxt)
    #endif
    {
        int t = 0, nt = 1;
        #ifdef _OPENMP
        t = omp_get_thread_num();
        nt = omp_get_num_threads();
        #endif
        const int64_t lo = n * t / nt, hi = n * (t + 1) / nt;
        int64_t* mine = pos.data() + (size_t)t * nbuckets;
        std::fill(mine, mine + nbuckets, 0);
        for (int64_t i = lo; i < hi; i++) mine[(sigs[i] >> shift) & mask]++;
        #ifdef _OPENMP
        #pragma omp barrier
        #pragma omp single
        #endif
        {
            int64_t acc = 0;
            for (int b = 0; b < nbuckets; b++) {
                offsets[b] = acc;
                for (int u = 0; u < nt; u++) {
                    const int64_t c = pos[(size_t)u * nbuckets + b];
                    pos[(size_t)u * nbuckets + b] = acc;
                    acc += c;
                }
            }
            offsets[nbuckets] = acc;
        }
        for (int64_t i = lo; i < hi; i++)
            order[mine[(sigs[i] >> shift) & mask]++] = (int32_t)i;
    }
}

// Linear merge of two sorted uint64 blocks (stable: ties take from a
// first). Building block of the external-sort cascade that replaces the
// reference's heapq.merge k-way file merge (extractOfftargets.py:130-191).
void ct_merge_u64(const uint64_t* a, int64_t na, const uint64_t* b,
                  int64_t nb, uint64_t* out) {
    int64_t i = 0, j = 0, o = 0;
    while (i < na && j < nb)
        out[o++] = (b[j] < a[i]) ? b[j++] : a[i++];
    if (i < na) memcpy(out + o, a + i, (na - i) * sizeof(uint64_t));
    if (j < nb) memcpy(out + o, b + j, (nb - j) * sizeof(uint64_t));
}

// Bit-order conversion between low-first and big-endian (lexicographic)
// 2-bit packings (see codec.py): out may alias in.
void ct_lex_convert(const uint64_t* in, uint64_t* out, int64_t n, int length) {
    #ifdef _OPENMP
    #pragma omp parallel for
    #endif
    for (int64_t i = 0; i < n; i++) {
        uint64_t v = in[i];
        uint64_t r = 0;
        for (int j = 0; j < length; j++) {
            r |= ((v >> (2 * j)) & 3ULL) << (2 * (length - 1 - j));
        }
        out[i] = r;
    }
}

}  // extern "C"
