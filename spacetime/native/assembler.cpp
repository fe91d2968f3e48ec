// Native P1 finite-element assembly core.
//
// Counterpart of the reference's NGSolve (C++) assembly engine
// (SURVEY.md §2 "Native components"): computes per-element mass/stiffness
// triplets for simplicial meshes (triangles and tetrahedra) in one parallel
// pass. The Python layer (spacetime.native) loads this via ctypes and
// feeds the triplets to scipy's COO->CSR; NumPy remains the fallback and the
// parity reference.
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC assembler.cpp
//
// Triplet layout per element e, local pair (a, b):
//   rows[k] = T[e,a], cols[k] = T[e,b],
//   mass[k] / stiff[k] = local matrix entries,  k = e*nloc^2 + a*nloc + b.
//
// kv / cv: optional (nullable) per-element coefficient values at element
// centroids for the weighted spatial form int kappa grad.grad + c u v —
// stiff then carries kappa[e]*K_el + c[e]*M_el while mass stays the plain
// mass matrix (it carries the d/dt pairing and the trace term).

#include <cstdint>
#include <cstddef>

extern "C" {

// 2D: vertices (nv, 2) float64, triangles (ne, 3) int32.
void assemble_p1_tri(const double* V, const int32_t* T, int64_t ne,
                     const double* kv, const double* cv,
                     int32_t* rows, int32_t* cols,
                     double* mass, double* stiff) {
#pragma omp parallel for schedule(static)
    for (int64_t e = 0; e < ne; ++e) {
        const int32_t i0 = T[3 * e], i1 = T[3 * e + 1], i2 = T[3 * e + 2];
        const double x0 = V[2 * i0], y0 = V[2 * i0 + 1];
        const double x1 = V[2 * i1], y1 = V[2 * i1 + 1];
        const double x2 = V[2 * i2], y2 = V[2 * i2 + 1];
        const double d1x = x1 - x0, d1y = y1 - y0;
        const double d2x = x2 - x0, d2y = y2 - y0;
        const double det = d1x * d2y - d1y * d2x;
        const double area = (det < 0 ? -det : det) * 0.5;
        const double inv = 1.0 / det;
        // gradients of barycentric basis
        double g[3][2];
        g[1][0] = d2y * inv;  g[1][1] = -d2x * inv;
        g[2][0] = -d1y * inv; g[2][1] = d1x * inv;
        g[0][0] = -g[1][0] - g[2][0];
        g[0][1] = -g[1][1] - g[2][1];
        const int32_t idx[3] = {i0, i1, i2};
        const double m_off = area / 12.0;
        const double kap = kv ? kv[e] : 1.0;
        const double cw = cv ? cv[e] : 0.0;
        int64_t k = e * 9;
        for (int a = 0; a < 3; ++a) {
            for (int b = 0; b < 3; ++b, ++k) {
                rows[k] = idx[a];
                cols[k] = idx[b];
                const double m_ab = (a == b) ? 2.0 * m_off : m_off;
                mass[k] = m_ab;
                stiff[k] = kap * area * (g[a][0] * g[b][0] + g[a][1] * g[b][1])
                           + cw * m_ab;
            }
        }
    }
}

// 3D: vertices (nv, 3) float64, tets (ne, 4) int32.
void assemble_p1_tet(const double* V, const int32_t* T, int64_t ne,
                     const double* kv, const double* cv,
                     int32_t* rows, int32_t* cols,
                     double* mass, double* stiff) {
#pragma omp parallel for schedule(static)
    for (int64_t e = 0; e < ne; ++e) {
        const int32_t* t = T + 4 * e;
        double D[3][3];
        for (int c = 0; c < 3; ++c)
            for (int d = 0; d < 3; ++d)
                D[c][d] = V[3 * t[c + 1] + d] - V[3 * t[0] + d];
        const double det =
            D[0][0] * (D[1][1] * D[2][2] - D[1][2] * D[2][1]) -
            D[0][1] * (D[1][0] * D[2][2] - D[1][2] * D[2][0]) +
            D[0][2] * (D[1][0] * D[2][1] - D[1][1] * D[2][0]);
        const double vol = (det < 0 ? -det : det) / 6.0;
        const double inv = 1.0 / det;
        // grad lambda_c = column (c-1) of D^{-1}: g[c][j] = cof[c-1][j]/det.
        double g[4][3];
        g[1][0] = (D[1][1] * D[2][2] - D[1][2] * D[2][1]) * inv;
        g[1][1] = (D[1][2] * D[2][0] - D[1][0] * D[2][2]) * inv;
        g[1][2] = (D[1][0] * D[2][1] - D[1][1] * D[2][0]) * inv;
        g[2][0] = (D[0][2] * D[2][1] - D[0][1] * D[2][2]) * inv;
        g[2][1] = (D[0][0] * D[2][2] - D[0][2] * D[2][0]) * inv;
        g[2][2] = (D[0][1] * D[2][0] - D[0][0] * D[2][1]) * inv;
        g[3][0] = (D[0][1] * D[1][2] - D[0][2] * D[1][1]) * inv;
        g[3][1] = (D[0][2] * D[1][0] - D[0][0] * D[1][2]) * inv;
        g[3][2] = (D[0][0] * D[1][1] - D[0][1] * D[1][0]) * inv;
        for (int d = 0; d < 3; ++d)
            g[0][d] = -g[1][d] - g[2][d] - g[3][d];
        const double m_off = vol / 20.0;
        const double kap = kv ? kv[e] : 1.0;
        const double cw = cv ? cv[e] : 0.0;
        int64_t k = e * 16;
        for (int a = 0; a < 4; ++a) {
            for (int b = 0; b < 4; ++b, ++k) {
                rows[k] = t[a];
                cols[k] = t[b];
                const double m_ab = (a == b) ? 2.0 * m_off : m_off;
                mass[k] = m_ab;
                stiff[k] = kap * vol * (g[a][0] * g[b][0] + g[a][1] * g[b][1] +
                                        g[a][2] * g[b][2])
                           + cw * m_ab;
            }
        }
    }
}

// Greedy smoothed-aggregation passes over a CSR strength graph —
// bit-exact mirror of the Python reference in ops/multigrid.sa_prolongator
// (same visit order, same tie-breaks), which is three Python loops over
// all nodes and dominated the AMG setup on the 1-core host. Inherently
// sequential (greedy), so no OpenMP here; the C loop is ~100x the Python
// one. agg must arrive filled with -1; returns the aggregate count.
int64_t sa_aggregate(const int32_t* indptr, const int32_t* indices,
                     int64_t n, int64_t* agg) {
    int64_t na = 0;
    // pass 1: roots whose strong neighborhood is fully unaggregated
    for (int64_t i = 0; i < n; ++i) {
        if (agg[i] != -1) continue;
        bool clean = true;
        for (int32_t p = indptr[i]; p < indptr[i + 1]; ++p)
            if (agg[indices[p]] != -1) { clean = false; break; }
        if (!clean) continue;
        agg[i] = na;
        for (int32_t p = indptr[i]; p < indptr[i + 1]; ++p)
            agg[indices[p]] = na;
        ++na;
    }
    // pass 2: attach stragglers to the FIRST pass-1 aggregate among their
    // neighbors (pass1 snapshot == agg here: pass 2 only writes nodes that
    // are -1 in the snapshot, and reads via the snapshot values).
    int64_t* pass1 = new int64_t[n];
    for (int64_t i = 0; i < n; ++i) pass1[i] = agg[i];
    for (int64_t i = 0; i < n; ++i) {
        if (pass1[i] != -1) continue;
        for (int32_t p = indptr[i]; p < indptr[i + 1]; ++p) {
            const int64_t h = pass1[indices[p]];
            if (h != -1) { agg[i] = h; break; }
        }
    }
    delete[] pass1;
    // pass 3: leftovers form their own aggregates
    for (int64_t i = 0; i < n; ++i) {
        if (agg[i] != -1) continue;
        agg[i] = na;
        for (int32_t p = indptr[i]; p < indptr[i + 1]; ++p)
            if (agg[indices[p]] == -1) agg[indices[p]] = na;
        ++na;
    }
    return na;
}

}  // extern "C"
