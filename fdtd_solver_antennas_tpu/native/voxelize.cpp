// Native voxelizer core: oriented-box containment over point grids.
//
// The in-repo counterpart of the geometry rasterization CSXCAD.dll does
// in C++ for the reference (AddBox/AddTransform → cell properties). The
// Python voxelizer calls this for its hot loop — testing every Yee-edge
// midpoint / cell center against every scene primitive — and falls back to
// the NumPy implementation when the shared library is unavailable.
//
// Built by native/build.py:  g++ -O3 -shared -fPIC -std=c++17 voxelize.cpp -o _libvoxelize.so
// (-march=native deliberately omitted: the .so may outlive the host it was
//  built on; baseline vectorization is plenty for this memory-bound loop)
// Interface: plain C ABI consumed via ctypes (no pybind11 dependency).

#include <cstdint>
#include <cstring>

extern "C" {

// Box record layout (doubles):
//   lo[3], hi[3]          local-frame bounds (already tolerance-inflated)
//   rot[9]                world→local rotation (row-major; identity if none)
//   origin[3]             rotation origin
//   trans[3]              translation
//   has_rot               0.0 or 1.0
// total: 22 doubles per box
constexpr int BOX_DOUBLES = 22;

// out[i] = 1 if pts[i] is inside the box (world frame), else unchanged.
// This "OR-accumulate" form lets callers paint multiple boxes into one
// mask without materializing intermediates.
void box_contains_or(const double* pts, int64_t n_pts,
                     const double* box, uint8_t* out) {
    const double* lo = box;
    const double* hi = box + 3;
    const double* rot = box + 6;
    const double* org = box + 15;
    const double* trn = box + 18;
    const bool has_rot = box[21] != 0.0;

    for (int64_t i = 0; i < n_pts; ++i) {
        double p0 = pts[3 * i] - trn[0];
        double p1 = pts[3 * i + 1] - trn[1];
        double p2 = pts[3 * i + 2] - trn[2];
        if (has_rot) {
            // local = (p - origin) @ R + origin   (row-vector convention,
            // matching models.scene.Box.to_local)
            const double q0 = p0 - org[0];
            const double q1 = p1 - org[1];
            const double q2 = p2 - org[2];
            p0 = q0 * rot[0] + q1 * rot[3] + q2 * rot[6] + org[0];
            p1 = q0 * rot[1] + q1 * rot[4] + q2 * rot[7] + org[1];
            p2 = q0 * rot[2] + q1 * rot[5] + q2 * rot[8] + org[2];
        }
        if (p0 >= lo[0] && p0 <= hi[0] &&
            p1 >= lo[1] && p1 <= hi[1] &&
            p2 >= lo[2] && p2 <= hi[2]) {
            out[i] = 1;
        }
    }
}

// Paint material values by priority order: for each box (pre-sorted
// ascending priority), overwrite eps/sigma wherever the cell center is
// inside. boxes: n_boxes × 22 doubles; vals: n_boxes × 2 (eps, sigma).
void paint_materials(const double* pts, int64_t n_pts,
                     const double* boxes, const double* vals,
                     int64_t n_boxes, double* eps, double* sigma) {
    for (int64_t b = 0; b < n_boxes; ++b) {
        const double* box = boxes + b * BOX_DOUBLES;
        const double* lo = box;
        const double* hi = box + 3;
        const double* rot = box + 6;
        const double* org = box + 15;
        const double* trn = box + 18;
        const bool has_rot = box[21] != 0.0;
        const double e = vals[2 * b];
        const double s = vals[2 * b + 1];
        for (int64_t i = 0; i < n_pts; ++i) {
            double p0 = pts[3 * i] - trn[0];
            double p1 = pts[3 * i + 1] - trn[1];
            double p2 = pts[3 * i + 2] - trn[2];
            if (has_rot) {
                const double q0 = p0 - org[0];
                const double q1 = p1 - org[1];
                const double q2 = p2 - org[2];
                p0 = q0 * rot[0] + q1 * rot[3] + q2 * rot[6] + org[0];
                p1 = q0 * rot[1] + q1 * rot[4] + q2 * rot[7] + org[1];
                p2 = q0 * rot[2] + q1 * rot[5] + q2 * rot[8] + org[2];
            }
            if (p0 >= lo[0] && p0 <= hi[0] &&
                p1 >= lo[1] && p1 <= hi[1] &&
                p2 >= lo[2] && p2 <= hi[2]) {
                eps[i] = e;
                sigma[i] = s;
            }
        }
    }
}

}  // extern "C"

// Fused cell→edge material average. ``cell`` is the (nx, ny, nz)
// cell-centered array; ``out`` the (nx+1, ny+1, nz+1) padded edge
// array for E-component ``axis`` (0=ex, 1=ey, 2=ez). The component's
// own axis replicates the clamped cell value; the two transverse axes
// take the standard staggered-grid node average of the adjacent cells
// (clamped at the walls). The rounding ORDER reproduces the NumPy
// fallback bit-for-bit: the fallback nests two avg_along passes —
// 0.5*(0.5*(A+B) + 0.5*(C+D)) with the inner pair along the LOWER
// transverse axis — and downstream validation (the CPML DC-residual
// floor) sits close enough to its asserted band that a one-ULP
// reassociation (e.g. a flat 0.25*(A+B+C+D)) measurably moved it.
// Replaces a 12-pass NumPy pad/add pipeline (the single biggest
// prepare cost on the 4.2M-cell scene) with one read + one write per
// element. Templated on the element type: the engine assembles Ca/Cb
// in float64 (an all-f32 pipeline shifted the same floor), with the
// f32 entry kept for callers that average already-f32 data.
template <typename T>
static void cell_edge_avg_impl(const T* cell, int64_t nx, int64_t ny,
                               int64_t nz, int axis, T* out) {
    const int64_t Py = ny + 1, Pz = nz + 1;
    const int64_t sx = ny * nz, sy = nz;
    const T H = T(0.5);
    for (int64_t i = 0; i < nx + 1; ++i) {
        int64_t i0, i1;
        if (axis == 0) { i0 = i1 = (i < nx ? i : nx - 1); }
        else { i0 = i > 0 ? i - 1 : 0; i1 = i < nx ? i : nx - 1; }
        for (int64_t j = 0; j < Py; ++j) {
            int64_t j0, j1;
            if (axis == 1) { j0 = j1 = (j < ny ? j : ny - 1); }
            else { j0 = j > 0 ? j - 1 : 0; j1 = j < ny ? j : ny - 1; }
            const T* r00 = cell + i0 * sx + j0 * sy;
            const T* r01 = cell + i0 * sx + j1 * sy;
            const T* r10 = cell + i1 * sx + j0 * sy;
            const T* r11 = cell + i1 * sx + j1 * sy;
            T* o = out + (i * Py + j) * Pz;
            if (axis == 2) {
                // ez: inner pair along x, outer along y (NumPy
                // avg_along(avg_along(cell, 0), 1)).
                for (int64_t k = 0; k < Pz; ++k) {
                    const int64_t kc = k < nz ? k : nz - 1;
                    o[k] = H * (H * (r00[kc] + r10[kc])
                                + H * (r01[kc] + r11[kc]));
                }
            } else if (axis == 1) {
                // ey: inner pair along x, outer along z
                // (avg_along(avg_along(cell, 0), 2)); j0 == j1.
                for (int64_t k = 0; k < Pz; ++k) {
                    const int64_t k0 = k > 0 ? k - 1 : 0;
                    const int64_t k1 = k < nz ? k : nz - 1;
                    o[k] = H * (H * (r00[k0] + r10[k0])
                                + H * (r00[k1] + r10[k1]));
                }
            } else {
                // ex: inner pair along y, outer along z
                // (avg_along(avg_along(cell, 1), 2)); i0 == i1.
                for (int64_t k = 0; k < Pz; ++k) {
                    const int64_t k0 = k > 0 ? k - 1 : 0;
                    const int64_t k1 = k < nz ? k : nz - 1;
                    o[k] = H * (H * (r00[k0] + r01[k0])
                                + H * (r00[k1] + r01[k1]));
                }
            }
        }
    }
}

extern "C" {

void cell_edge_avg_f32(const float* cell, int64_t nx, int64_t ny,
                       int64_t nz, int axis, float* out) {
    cell_edge_avg_impl<float>(cell, nx, ny, nz, axis, out);
}

void cell_edge_avg_f64(const double* cell, int64_t nx, int64_t ny,
                       int64_t nz, int axis, double* out) {
    cell_edge_avg_impl<double>(cell, nx, ny, nz, axis, out);
}

}  // extern "C"
