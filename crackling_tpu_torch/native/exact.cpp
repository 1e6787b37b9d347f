// Reference-exact ISSL scoring on the host, parallel across queries.
//
// The hybrid TPU scorer (ops/issl_dense.HybridIsslScorer) re-scores the
// small set of near-threshold queries with the reference's exact f64
// arithmetic. At mammal-genome depth the bit-exact MXU engine's one-hot
// planes no longer fit HBM next to the fast engine, and the XLA
// early-exit emulation on CPU measured ~7 guides/s — so the re-score
// runs here instead: the same per-query bucket walk the reference
// binary performs (isslScoreOfftargets.cpp:344-496), written against
// this package's id-ordered index arrays.
//
// Semantics matched to the reference (and to ops/oracle.score_exact,
// which is %f-equal to the binary across a 10-parameter grid):
//   * per-slice bucket walk in slice order, entries in bucket order
//   * dedup: a site is counted at its FIRST encountering slice only.
//     The binary marks a seen-bits vector (cpp:385-387); here the
//     stateless equivalent used by every TPU kernel in this repo — at
//     slice s the site was seen earlier iff some slice s' < s matches
//     cleanly (its collapsed-mask byte is zero). Same scan position,
//     same early-exit interaction, no per-query memset.
//   * MIT local scores from the dense f64 table (ops/tables.py
//     mit_dense_table == the map isslCreateIndex.cpp:239-252 builds)
//   * CFD per-hit product in ascending position order with the PAM
//     factor first (cpp:410-458); dist-0 hits contribute 1.0 (cpp:408)
//   * early exit AFTER each counted hit, per method (cpp:467-496)
//
// Layout restriction: w == 8 (4 positions per slice, so slice bytes of
// the collapsed mask are byte-aligned); the Python wrapper enforces it.

#include <cstdint>

static inline uint64_t collapse40(uint64_t x) {
    // "01" in every mismatched 2-bit slot (isslScoreOfftargets.cpp:376)
    return ((x & 0xAAAAAAAAAAULL) >> 1) | (x & 0x5555555555ULL);
}

extern "C" void ct_exact_score(
    const uint64_t* sites, const uint32_t* occ, int64_t n_sites,
    const int32_t* order,             // (S, n_sites) per-slice id lists
    const int64_t* boff,              // (S, B+1) bucket CSR offsets
    int S, int B, int w,
    const uint64_t* queries, int64_t n_q,
    int max_dist, double maximum_sum, int method,
    const double* mit_table,          // (1<<20,) by 20-bit mismatch mask
    const double* pos_pen,            // (20, 16) CFD position penalties
    double pam,
    double* mit_out, double* cfd_out) // raw per-query sums
{
    const uint64_t bmask = (1ULL << w) - 1;
    const bool calc_mit = method == 0 || method >= 2;
    const bool calc_cfd = method >= 1;
#pragma omp parallel for schedule(dynamic, 8)
    for (int64_t qi = 0; qi < n_q; ++qi) {
        const uint64_t q = queries[qi];
        double tot_mit = 0.0, tot_cfd = 0.0;
        bool go = true;
        for (int s = 0; s < S && go; ++s) {
            const uint64_t v = (q >> (uint64_t)(w * s)) & bmask;
            const int32_t* ids = order + (int64_t)s * n_sites;
            const int64_t lo = boff[(int64_t)s * (B + 1) + (int64_t)v];
            const int64_t hi = boff[(int64_t)s * (B + 1) + (int64_t)v + 1];
            for (int64_t k = lo; k < hi; ++k) {
                const int64_t id = ids[k];
                const uint64_t ot = sites[id];
                const uint64_t c = collapse40(q ^ ot);
                const int dist = __builtin_popcountll(c);
                if (dist > max_dist) continue;       // cpp:382, no effects
                bool seen = false;                   // first-clean-slice
                for (int sp = 0; sp < s; ++sp)
                    if (((c >> (8 * sp)) & 0xFFULL) == 0) {
                        seen = true;
                        break;
                    }
                if (seen) continue;
                const double oc = (double)occ[id];
                if (calc_mit && dist > 0) {
                    uint32_t m20 = 0;
                    for (int p = 0; p < 20; ++p)
                        m20 |= (uint32_t)((c >> (2 * p)) & 1ULL) << p;
                    tot_mit += mit_table[m20] * oc;
                }
                if (calc_cfd) {
                    double cfd = 1.0;
                    if (dist != 0) {
                        cfd = pam;
                        for (int p = 0; p < 20; ++p) {
                            const uint64_t qb = (q >> (2 * p)) & 3ULL;
                            const uint64_t ob = (ot >> (2 * p)) & 3ULL;
                            if (qb != ob)
                                cfd *= pos_pen[p * 16
                                               + (int)((qb << 2) | (ob ^ 3))];
                        }
                    }
                    tot_cfd += cfd * oc;
                }
                bool stop;                           // cpp:467-496
                switch (method) {
                    case 0: stop = tot_mit > maximum_sum; break;
                    case 1: stop = tot_cfd > maximum_sum; break;
                    case 2: stop = tot_mit > maximum_sum
                                   && tot_cfd > maximum_sum; break;
                    case 3: stop = tot_mit > maximum_sum
                                   || tot_cfd > maximum_sum; break;
                    default: stop = (tot_mit + tot_cfd) / 2.0
                                    > maximum_sum; break;
                }
                if (stop) {
                    go = false;
                    break;
                }
            }
        }
        mit_out[qi] = tot_mit;
        cfd_out[qi] = tot_cfd;
    }
}
