// Exact-order hit replay for the MXU engine's bit-exact score path.
//
// The reference scorer accumulates each query's deduped hits sequentially
// in (slice, in-bucket) order with a score-visible early exit
// (isslScoreOfftargets.cpp:463-496): the reported score is
// 10000/(100+partial_sum) frozen at the exit point. The per-hit MIT/CFD
// contributions are vectorized in PyTorch (the exact replay's plain
// version, ops/mxu_replay.py:mxu_replay_plain, which the CPU engine runs);
// this translation unit runs ONLY the running-sum/early-exit recurrence —
// the one part that is inherently sequential per query — in C, parallel
// across queries (each query's sum is a single thread's work, like the
// reference's `omp for` over queries, isslScoreOfftargets.cpp:316).
// Identical f64 adds in identical order => bit-identical sums.

#include <cstdint>

namespace {
enum Method { M_MIT = 0, M_CFD = 1, M_AND = 2, M_OR = 3, M_AVG = 4 };
}

extern "C" void ct_replay_accumulate(
    const int64_t* starts,      // n_groups+1 boundaries into the hit arrays
    int64_t n_groups,
    const double* mit_c,        // per-hit MIT contribution (already x occ)
    const double* cfd_c,        // per-hit CFD contribution (already x occ)
    const uint8_t* keep,        // 1 = first (query, site) occurrence
    int method,
    double maximum_sum,
    double* out_m,              // per-group frozen MIT sum
    double* out_cc) {           // per-group frozen CFD sum
#pragma omp parallel for schedule(dynamic, 64)
    for (int64_t g = 0; g < n_groups; ++g) {
        double m = 0.0, cc = 0.0;
        const int64_t i1 = starts[g + 1];
        for (int64_t i = starts[g]; i < i1; ++i) {
            if (!keep[i]) continue;
            m += mit_c[i];
            cc += cfd_c[i];
            bool exit_now;
            switch (method) {
                case M_AND: exit_now = m > maximum_sum && cc > maximum_sum; break;
                case M_OR:  exit_now = m > maximum_sum || cc > maximum_sum; break;
                case M_AVG: exit_now = (m + cc) / 2.0 > maximum_sum; break;
                case M_MIT: exit_now = m > maximum_sum; break;
                default:    exit_now = cc > maximum_sum; break;
            }
            if (exit_now) break;
        }
        out_m[g] = m;
        out_cc[g] = cc;
    }
}
