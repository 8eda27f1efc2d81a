// Native lattice graph-builder for the irregular multi-resolution lattice.
//
// The port's own copy of lanczos_tpu/native/neighbor_engine.cpp: the
// neighbor search (count_neighbors, fill_neighbors), the edge reciprocity
// scan (reciprocal_mask) and the COO -> padded-ELL packer (pack_ell).  It is
// host code, built with the host C++ compiler by lanczos_tpu_torch/native.
//
// C++ replacement for the hot host-side assembly loop of the reference
// (the reference's Python/Irregular/IrrGrid.py:67-138 GetNearbyPoints — a
// per-point interpreted Python walk that takes hours at production sizes,
// and the reference's Python/Irregular/IrrHamiltonian.py:39-70 which drives
// it).  Semantics are identical to lanczos_tpu_torch.models.lattice.find_neighbors
// (the vectorized numpy path), which tests cross-check against this
// engine:
//
//  * fast path — every box a point's +-D*a cube touches shares its spacing:
//    neighbors are the aligned (2D+1)^3-1 sub-lattice stencil at the point's
//    own spacing (all guaranteed to exist);
//  * edge path — some touched box differs in spacing: scan the fine cube of
//    radius D*local_a and keep candidates that exist AND whose mirror image
//    through the center exists (the reference's mirror-symmetry filter,
//    IrrGrid.py:125-137 / symetry.py:6-36), preserving even-moment symmetry
//    of the least-squares stencil.
//
// Two-phase API (count, then fill) so the caller can allocate exactly
// max-degree-wide padded arrays instead of worst-case cubes.
//
// Build: g++ -O3 -shared -fPIC (see lanczos_tpu_torch/native/__init__.py).

#include <cstdint>
#include <algorithm>

namespace {

struct Lattice {
    const int64_t* occupancy;    // [n^3] fine coord -> point idx or -1
    const int64_t* coords;       // [P*3] point -> fine (x, y, z)
    const int32_t* box_of_point; // [P]
    const int64_t* spacings;     // [nb] per-box spacing
    int64_t n;                   // fine grid dim
    int64_t bd;                  // box_depth
    int64_t npb;                 // points per box side = n / bd

    inline int64_t wrap(int64_t c) const {
        int64_t m = c % n;
        return m < 0 ? m + n : m;
    }
    inline int64_t flat(int64_t x, int64_t y, int64_t z) const {
        return wrap(x) + wrap(y) * n + wrap(z) * n * n;
    }
    inline int64_t lookup(int64_t x, int64_t y, int64_t z) const {
        return occupancy[flat(x, y, z)];
    }
    inline int64_t box_of(int64_t x, int64_t y, int64_t z) const {
        int64_t bx = wrap(x) / npb, by = wrap(y) / npb, bz = wrap(z) / npb;
        return bx + by * bd + bz * bd * bd;
    }
};

// Max spacing among the boxes the +-reach cube touches, and whether any
// touched box differs from the point's own spacing
// (IsCloseToEdgeWithDifferentSpacing, IrrGrid.py:229-242).
inline void local_max_spacing(const Lattice& L, const int64_t* p,
                              int64_t a_own, int64_t reach,
                              int64_t* a_max_out, bool* differs_out) {
    int64_t a_max = a_own;
    bool differs = false;
    for (int dx = -1; dx <= 1; ++dx)
        for (int dy = -1; dy <= 1; ++dy)
            for (int dz = -1; dz <= 1; ++dz) {
                int64_t b = L.box_of(p[0] + dx * reach, p[1] + dy * reach,
                                     p[2] + dz * reach);
                int64_t a_t = L.spacings[b];
                if (a_t > a_max) a_max = a_t;
                if (a_t != a_own) differs = true;
            }
    *a_max_out = a_max;
    *differs_out = differs;
}

// Visit the neighbors of one point in the canonical order (x slowest,
// z fastest — matching itertools.product in the numpy fallback).  The
// callback receives (point_idx, relx, rely, relz); returns the count.
template <typename F>
inline int64_t visit_neighbors(const Lattice& L, int64_t i, int64_t d, F&& emit) {
    const int64_t* p = &L.coords[3 * i];
    int64_t a_own = L.spacings[L.box_of_point[i]];
    int64_t a_loc;
    bool differs;
    local_max_spacing(L, p, a_own, d * a_own, &a_loc, &differs);

    int64_t count = 0;
    if (!differs) {
        // Aligned sub-lattice stencil at own spacing.
        for (int64_t vx = -d; vx <= d; ++vx)
            for (int64_t vy = -d; vy <= d; ++vy)
                for (int64_t vz = -d; vz <= d; ++vz) {
                    if (!vx && !vy && !vz) continue;
                    int64_t rx = vx * a_own, ry = vy * a_own, rz = vz * a_own;
                    int64_t q = L.lookup(p[0] + rx, p[1] + ry, p[2] + rz);
                    // q >= 0 always: aligned points exist by construction.
                    emit(q, rx, ry, rz, count);
                    ++count;
                }
    } else {
        // Fine cube scan of radius D*local_a with the mirror filter.
        int64_t r = d * a_loc;
        for (int64_t vx = -r; vx <= r; ++vx)
            for (int64_t vy = -r; vy <= r; ++vy)
                for (int64_t vz = -r; vz <= r; ++vz) {
                    if (!vx && !vy && !vz) continue;
                    int64_t q = L.lookup(p[0] + vx, p[1] + vy, p[2] + vz);
                    if (q < 0) continue;
                    if (L.lookup(p[0] - vx, p[1] - vy, p[2] - vz) < 0) continue;
                    emit(q, vx, vy, vz, count);
                    ++count;
                }
    }
    return count;
}

}  // namespace

extern "C" {

// Phase 1: neighbor count per queried point -> out_counts[nq].
void count_neighbors(const int64_t* occupancy, const int64_t* coords,
                     const int32_t* box_of_point, const int64_t* spacings,
                     int64_t n, int64_t bd,
                     const int64_t* idx, int64_t nq, int64_t d,
                     int64_t* out_counts) {
    Lattice L{occupancy, coords, box_of_point, spacings, n, bd, n / bd};
    for (int64_t t = 0; t < nq; ++t) {
        out_counts[t] = visit_neighbors(
            L, idx[t], d, [](int64_t, int64_t, int64_t, int64_t, int64_t) {});
    }
}

// Phase 2: fill padded (nq, k) neighbor indices (-1 pad) and (nq, k, 3)
// relative fine-grid offsets (0 pad).
void fill_neighbors(const int64_t* occupancy, const int64_t* coords,
                    const int32_t* box_of_point, const int64_t* spacings,
                    int64_t n, int64_t bd,
                    const int64_t* idx, int64_t nq, int64_t d, int64_t k,
                    int64_t* out_nbrs, int64_t* out_rels) {
    Lattice L{occupancy, coords, box_of_point, spacings, n, bd, n / bd};
    std::fill(out_nbrs, out_nbrs + nq * k, int64_t(-1));
    std::fill(out_rels, out_rels + nq * k * 3, int64_t(0));
    for (int64_t t = 0; t < nq; ++t) {
        int64_t* nb = &out_nbrs[t * k];
        int64_t* rl = &out_rels[t * k * 3];
        visit_neighbors(L, idx[t], d,
                        [&](int64_t q, int64_t rx, int64_t ry, int64_t rz,
                            int64_t c) {
                            nb[c] = q;
                            rl[3 * c + 0] = rx;
                            rl[3 * c + 1] = ry;
                            rl[3 * c + 2] = rz;
                        });
    }
}

// Edge reciprocity: keep[i, j] = 1 iff the edge (i -> nbrs[i, j]) has its
// reverse (nbrs[i, j] -> i) among the neighbor's own k entries; -1 pads
// are never kept.  One scan of the neighbor's row per edge.
void reciprocal_mask(const int64_t* nbrs, int64_t p, int64_t k, uint8_t* keep) {
    for (int64_t i = 0; i < p; ++i) {
        const int64_t base = i * k;
        for (int64_t j = 0; j < k; ++j) {
            const int64_t dst = nbrs[base + j];
            uint8_t ok = 0;
            if (dst >= 0) {
                const int64_t* row = nbrs + dst * k;
                for (int64_t t = 0; t < k; ++t) {
                    if (row[t] == i) { ok = 1; break; }
                }
            }
            keep[base + j] = ok;
        }
    }
}

// COO -> padded ELL: rows non-decreasing, duplicates already summed, no
// row longer than k (the caller checks all three).  Writes the (m, k) ELL
// with col = row / val = 0 padding: the O(nnz) inner loop of
// ops/assemble.py:ell_from_coo without numpy's temporaries.  Columns are
// int64, the port's EllOperator index type.
void pack_ell(const int64_t* rows, const int64_t* cols, const double* vals,
              int64_t nnz, int64_t m, int64_t k, int64_t* out_cols, double* out_vals) {
    for (int64_t r = 0; r < m; ++r) {
        for (int64_t j = 0; j < k; ++j) {
            out_cols[r * k + j] = r;
            out_vals[r * k + j] = 0.0;
        }
    }
    int64_t pos = 0;
    int64_t prev_row = -1;
    for (int64_t e = 0; e < nnz; ++e) {
        const int64_t r = rows[e];
        pos = (r == prev_row) ? pos + 1 : 0;
        prev_row = r;
        out_cols[r * k + pos] = cols[e];
        out_vals[r * k + pos] = vals[e];
    }
}

}  // extern "C"
