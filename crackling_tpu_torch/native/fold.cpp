// Native Zuker MFE fold with Turner-2004-style parameters (d2 dangles).
//
// Host-side replacement for the reference's RNAfold subprocess
// (/root/reference/src/crackling/Crackling.py:426-435): the pipeline folds
// fixed-length guide+scaffold constructs, so a tight O(n^2 * (L^2 + n)) DP
// with OpenMP over the batch delivers RNAfold-class speed without any
// external binary. The energy model lives in ops/rna_params.py (single
// source of truth); this file consumes its packed float64 blob so the C++
// and JAX engines agree on the model bit-for-bit.
//
// Compiled into _libcrackling_native.so next to extract.cpp.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr double INFE = 1e6;
constexpr int MAXLOOP = 30;
constexpr double EPS = 1e-6;

// blob layout — must match ops/rna_params.py::_BLOB_SECTIONS
struct Params {
    const double *stack;        // (7,7)
    const double *hairpin;      // (513,)
    const double *bulge;        // (513,)
    const double *internal_;    // (513,)
    const double *mm_h;         // (7,4,4)
    const double *mm_i;         // (7,4,4)
    const double *mm_m;         // (7,4,4)
    const double *mm_e;         // (7,4,4)
    const double *mm_1n;        // (7,4,4)
    const double *mm_23;        // (7,4,4)
    const double *d5;           // (7,4)
    const double *d3;           // (7,4)
    const double *int11;        // (7,7,4,4)     [outer, rev(inner), si1, sj1]
    const double *int21;        // (7,7,4,4,4)
    const double *int22;        // (7,7,4,4,4,4)
    const double *tetra;        // (4096,)  TOTAL hairpin energy, INF = none
    const double *tri;          // (1024,)
    const double *hexa;         // (65536,)
    double terminal_au, ninio, ninio_max, ml_close, ml_intern, ml_base;
};

constexpr int64_t BLOB_LEN =
    7 * 7 + 3 * 513 + 6 * 7 * 4 * 4 + 2 * 7 * 4 +
    7 * 7 * 4 * 4 + 7 * 7 * 4 * 4 * 4 + 7 * 7 * 4 * 4 * 4 * 4 +
    4096 + 1024 + 65536 + 6;

Params unpack(const double *blob) {
    Params p;
    const double *q = blob;
    p.stack = q;     q += 7 * 7;
    p.hairpin = q;   q += 513;
    p.bulge = q;     q += 513;
    p.internal_ = q; q += 513;
    p.mm_h = q;      q += 7 * 4 * 4;
    p.mm_i = q;      q += 7 * 4 * 4;
    p.mm_m = q;      q += 7 * 4 * 4;
    p.mm_e = q;      q += 7 * 4 * 4;
    p.mm_1n = q;     q += 7 * 4 * 4;
    p.mm_23 = q;     q += 7 * 4 * 4;
    p.d5 = q;        q += 7 * 4;
    p.d3 = q;        q += 7 * 4;
    p.int11 = q;     q += 7 * 7 * 4 * 4;
    p.int21 = q;     q += 7 * 7 * 4 * 4 * 4;
    p.int22 = q;     q += 7 * 7 * 4 * 4 * 4 * 4;
    p.tetra = q;     q += 4096;
    p.tri = q;       q += 1024;
    p.hexa = q;      q += 65536;
    p.terminal_au = q[0];
    p.ninio = q[1];
    p.ninio_max = q[2];
    p.ml_close = q[3];
    p.ml_intern = q[4];
    p.ml_base = q[5];
    return p;
}

// pair codes: 0 CG, 1 GC, 2 GU, 3 UG, 4 AU, 5 UA, 6 none
const int8_t PAIR_REV[7] = {1, 0, 3, 2, 5, 4, 6};
const int8_t PAIR_AU[7] = {0, 0, 1, 1, 1, 1, 0};

inline int pair_code(int a, int b) {
    static const int8_t T[4][4] = {
        {-1, -1, -1, 4},
        {-1, -1, 0, -1},
        {-1, 1, -1, 2},
        {5, -1, 3, -1},
    };
    int v = T[a][b];
    return v < 0 ? 6 : v;
}

inline double mm(const double *t, int p, int b5, int b3) {
    return t[(p * 4 + b5) * 4 + b3];
}

struct Fold {
    const Params &P;
    const uint8_t *s;
    int n;
    std::vector<double> V, fML, fM1, f5;

    Fold(const Params &P_, const uint8_t *s_, int n_)
        : P(P_), s(s_), n(n_),
          V((size_t)n_ * n_, INFE), fML((size_t)n_ * n_, INFE),
          fM1((size_t)n_ * n_, INFE), f5(n_, 0.0) {}

    inline double &at(std::vector<double> &t, int i, int j) {
        return t[(size_t)i * n + j];
    }
    inline double cat(const std::vector<double> &t, int i, int j) const {
        return t[(size_t)i * n + j];
    }

    inline double au(int p) const {
        return PAIR_AU[p] ? P.terminal_au : 0.0;
    }

    // ViennaRNA E_Hairpin semantics: a special tri/tetra/hexaloop entry is
    // the loop's TOTAL energy and replaces the generic formula
    double hairpin_e(int i, int j, int p) const {
        int ls = j - i - 1;
        if (ls < 3) return INFE;
        double e = P.hairpin[std::min(ls, 512)];
        if (ls == 3) {
            int idx = 0;
            for (int m = 0; m < 5; ++m) idx = idx * 4 + s[i + m];
            if (P.tri[idx] < INFE / 2) return P.tri[idx];
            return e + au(p);
        }
        if (ls == 4) {
            int idx = 0;
            for (int m = 0; m < 6; ++m) idx = idx * 4 + s[i + m];
            if (P.tetra[idx] < INFE / 2) return P.tetra[idx];
        } else if (ls == 6) {
            int idx = 0;
            for (int m = 0; m < 8; ++m) idx = idx * 4 + s[i + m];
            if (P.hexa[idx] < INFE / 2) return P.hexa[idx];
        }
        return e + mm(P.mm_h, p, s[i + 1], s[j - 1]);
    }

    // interior/bulge/stack transition energy (i,j) -> (k,l), ViennaRNA
    // E_IntLoop decomposition: dedicated 1x1/2x1/2x2 tables, 1xn and 2x3
    // mismatch families, generic init+Ninio+mismatches otherwise
    double loop_e(int i, int j, int k, int l, int p1, int p2) const {
        int a = k - i - 1, b = j - l - 1;
        int size = a + b;
        if (a == 0 && b == 0) return P.stack[p1 * 7 + p2];
        if (a == 0 || b == 0) {            // bulge
            double e = P.bulge[std::min(size, 512)];
            if (size == 1) e += P.stack[p1 * 7 + p2];
            else e += au(p1) + au(p2);
            return e;
        }
        int q2 = PAIR_REV[p2];
        int si1 = s[i + 1], sj1 = s[j - 1], sp1 = s[k - 1], sq1 = s[l + 1];
        if (a == 1 && b == 1)
            return P.int11[((p1 * 7 + q2) * 4 + si1) * 4 + sj1];
        if (a == 1 && b == 2)
            return P.int21[(((p1 * 7 + q2) * 4 + si1) * 4 + sq1) * 4 + sj1];
        if (a == 2 && b == 1)
            return P.int21[(((q2 * 7 + p1) * 4 + sq1) * 4 + si1) * 4 + sp1];
        if (a == 2 && b == 2)
            return P.int22[((((p1 * 7 + q2) * 4 + si1) * 4 + sp1) * 4 + sq1)
                           * 4 + sj1];
        double ninio = std::min(P.ninio_max, P.ninio * std::abs(a - b));
        if (a == 1 || b == 1)              // 1xn, n > 2
            return P.internal_[std::min(size, 512)] + ninio
                + mm(P.mm_1n, p1, si1, sj1) + mm(P.mm_1n, q2, sq1, sp1);
        if (size == 5)                     // 2x3 / 3x2
            return P.internal_[5] + ninio
                + mm(P.mm_23, p1, si1, sj1) + mm(P.mm_23, q2, sq1, sp1);
        return P.internal_[std::min(size, 512)] + ninio
            + mm(P.mm_i, p1, si1, sj1) + mm(P.mm_i, q2, sq1, sp1);
    }

    // d2 stem weight inside a multiloop (t = mm_m) or exterior (t = mm_e):
    // adjacent loop bases are si1 = s[k-1], sj1 = s[l+1], boundary-aware.
    double stem_e(const double *t, int k, int l, int p) const {
        double e = au(p);
        bool left = k > 0, right = l < n - 1;
        if (left && right) e += mm(t, p, s[k - 1], s[l + 1]);
        else if (left) e += P.d5[p * 4 + s[k - 1]];
        else if (right) e += P.d3[p * 4 + s[l + 1]];
        return e;
    }

    inline double ml_stem(int k, int l) const {
        int p = pair_code(s[k], s[l]);
        if (p == 6) return INFE;
        return cat(V, k, l) + P.ml_intern + stem_e(P.mm_m, k, l, p);
    }

    inline double ext_stem(int k, int j) const {
        int p = pair_code(s[k], s[j]);
        if (p == 6) return INFE;
        return cat(V, k, j) + stem_e(P.mm_e, k, j, p);
    }

    // multiloop closing-pair contribution for pair (i,j): the pair seen
    // from inside the loop is the reversed pair (j,i), with adjacent loop
    // bases si1 = s[j-1], sj1 = s[i+1].
    inline double ml_close_e(int i, int j, int p) const {
        return P.ml_close + P.ml_intern + au(p)
            + mm(P.mm_m, PAIR_REV[p], s[j - 1], s[i + 1]);
    }

    void run() {
        for (int j = 1; j < n; ++j) {
            for (int i = j - 1; i >= 0; --i) {
                int p1 = pair_code(s[i], s[j]);
                if (p1 != 6) {
                    double v = hairpin_e(i, j, p1);
                    int kmax = std::min(j - 2, i + 1 + MAXLOOP);
                    for (int k = i + 1; k <= kmax; ++k) {
                        int lmin = std::max(k + 1, j - 1 - (MAXLOOP - (k - i - 1)));
                        for (int l = j - 1; l >= lmin; --l) {
                            int p2 = pair_code(s[k], s[l]);
                            if (p2 == 6) continue;
                            double e = loop_e(i, j, k, l, p1, p2) + cat(V, k, l);
                            v = std::min(v, e);
                        }
                    }
                    // multiloop: close + fML(i+1, k-1) + fM1(k, j-1)
                    if (j - i > 4) {
                        double best = INFE;
                        for (int k = i + 2; k < j; ++k)
                            best = std::min(best,
                                cat(fML, i + 1, k - 1) + cat(fM1, k, j - 1));
                        v = std::min(v, ml_close_e(i, j, p1) + best);
                    }
                    at(V, i, j) = v;
                }
                // fM1(i,j) = min(fM1(i,j-1) + base, MLstem(i,j))
                double m1 = ml_stem(i, j);
                if (j > i) m1 = std::min(m1, cat(fM1, i, j - 1) + P.ml_base);
                at(fM1, i, j) = m1;
                // fML
                double ml = m1;
                if (j > i) ml = std::min(ml, cat(fML, i, j - 1) + P.ml_base);
                if (i + 1 <= j) ml = std::min(ml, cat(fML, i + 1, j) + P.ml_base);
                for (int k = i + 1; k <= j; ++k)
                    ml = std::min(ml, cat(fML, i, k - 1) + cat(fM1, k, j));
                at(fML, i, j) = ml;
            }
        }
        // exterior loop
        f5[0] = 0.0;
        for (int j = 1; j < n; ++j) {
            double best = f5[j - 1];
            for (int k = 0; k <= j - 4; ++k) {
                double st = ext_stem(k, j);
                if (st >= INFE / 2) continue;
                double prev = k > 0 ? f5[k - 1] : 0.0;
                best = std::min(best, prev + st);
            }
            f5[j] = best;
        }
    }

    // ---- traceback ----------------------------------------------------
    void trace_v(int i, int j, char *out);
    void trace_fm1(int i, int j, char *out);
    void trace_fml(int i, int j, char *out);

    void trace(char *out) {
        std::fill(out, out + n, '.');
        if (n < 2 || f5[n - 1] >= -EPS) return;
        int j = n - 1;
        while (j > 0) {
            if (std::abs(f5[j] - f5[j - 1]) < EPS) { --j; continue; }
            bool found = false;
            for (int k = 0; k <= j - 4; ++k) {
                double st = ext_stem(k, j);
                if (st >= INFE / 2) continue;
                double prev = k > 0 ? f5[k - 1] : 0.0;
                if (std::abs(f5[j] - (prev + st)) < EPS) {
                    trace_v(k, j, out);
                    j = k - 1;
                    found = true;
                    break;
                }
            }
            if (!found) break;
        }
    }
};

void Fold::trace_v(int i, int j, char *out) {
    out[i] = '(';
    out[j] = ')';
    int p1 = pair_code(s[i], s[j]);
    double e = cat(V, i, j);
    if (std::abs(e - hairpin_e(i, j, p1)) < EPS) return;
    int kmax = std::min(j - 2, i + 1 + MAXLOOP);
    for (int k = i + 1; k <= kmax; ++k) {
        int lmin = std::max(k + 1, j - 1 - (MAXLOOP - (k - i - 1)));
        for (int l = j - 1; l >= lmin; --l) {
            int p2 = pair_code(s[k], s[l]);
            if (p2 == 6) continue;
            if (std::abs(e - (loop_e(i, j, k, l, p1, p2) + cat(V, k, l))) < EPS) {
                trace_v(k, l, out);
                return;
            }
        }
    }
    if (j - i > 4) {
        double close = ml_close_e(i, j, p1);
        for (int k = i + 2; k < j; ++k) {
            if (std::abs(e - (close + cat(fML, i + 1, k - 1)
                              + cat(fM1, k, j - 1))) < EPS) {
                trace_fml(i + 1, k - 1, out);
                trace_fm1(k, j - 1, out);
                return;
            }
        }
    }
}

void Fold::trace_fm1(int i, int j, char *out) {
    while (j > i && std::abs(cat(fM1, i, j)
                             - (cat(fM1, i, j - 1) + P.ml_base)) < EPS)
        --j;
    trace_v(i, j, out);
}

void Fold::trace_fml(int i, int j, char *out) {
    while (true) {
        double e = cat(fML, i, j);
        if (std::abs(e - cat(fM1, i, j)) < EPS) { trace_fm1(i, j, out); return; }
        if (i < j && std::abs(e - (cat(fML, i + 1, j) + P.ml_base)) < EPS) {
            ++i;
            continue;
        }
        if (j > i && std::abs(e - (cat(fML, i, j - 1) + P.ml_base)) < EPS) {
            --j;
            continue;
        }
        bool done = false;
        for (int k = i + 1; k <= j; ++k) {
            if (std::abs(e - (cat(fML, i, k - 1) + cat(fM1, k, j))) < EPS) {
                trace_fm1(k, j, out);
                j = k - 1;
                done = true;
                break;
            }
        }
        if (!done) return;
    }
}

}  // namespace

extern "C" {

// Fold B equal-length sequences (codes A=0 C=1 G=2 U=3, shape (B, n)).
// energies: (B,) f64 (0.0 for a fully unpaired strand); structures: (B, n)
// bytes of '(' ')' '.'. nthreads <= 0 means the OpenMP default.
// Returns 0 on success, -1 when blob_len does not match this build's
// parameter layout (library/Python version skew).
int ct_fold_batch(const uint8_t *seqs, int64_t B, int64_t n,
                  const double *blob, int64_t blob_len,
                  double *energies, char *structures, int nthreads) {
    if (blob_len != BLOB_LEN) return -1;
    Params P = unpack(blob);
#ifdef _OPENMP
    if (nthreads > 0) omp_set_num_threads(nthreads);
#pragma omp parallel for schedule(dynamic)
#endif
    for (int64_t b = 0; b < B; ++b) {
        Fold f(P, seqs + b * n, (int)n);
        f.run();
        double e = std::min(f.f5[n - 1], 0.0);
        energies[b] = e;
        f.trace(structures + b * n);
    }
    return 0;
}

}  // extern "C"
