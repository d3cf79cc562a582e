// Native I/O runtime for the IB-LBM framework.
//
// The reference's runtime is native C++ (host driver main.cu:263-1066 +
// portable timer seconds.cpp); here the performance-relevant runtime pieces
// are native too: the bulk formatted snapshot writers (a 2048^2 field
// snapshot is ~4M formatted lines — two orders of magnitude faster in C
// than in Python) and a monotonic timer.  Formats are byte-compatible with
// the reference's output files (fluid: main.cu:954-971, cilia: :984-994),
// i.e. C++ iostream default 6-significant-digit formatting, tab separators,
// gnuplot-style blank row separators.
//
// Exposed as a plain C ABI consumed via ctypes (io/native.py).

#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {

// C++ iostream default formatting for double == printf %g with 6
// significant digits.
inline char* fmt_g6(char* p, double v) {
    return p + std::snprintf(p, 32, "%.6g", v);
}

}  // namespace

extern "C" {

double iblb_monotonic_seconds() {
    using clock = std::chrono::steady_clock;
    return std::chrono::duration<double>(clock::now().time_since_epoch())
        .count();
}

// Write "<x*xs>\t<y*xs>\t<ux*ss>\t<uy*ss>\t<|u|*ss>\t<rho>\n" per cell,
// blank line after each grid row.  Arrays are row-major [ydim][xdim].
// Returns 0 on success, nonzero errno-style code on failure.
int iblb_write_fluid_snapshot(const char* path, int32_t xdim, int32_t ydim,
                              double x_scale, double s_scale,
                              const double* rho, const double* ux,
                              const double* uy) {
    FILE* fp = std::fopen(path, "wb");
    if (!fp) return 1;
    // ~96 bytes per line worst case; buffer a full grid row.
    const size_t line_cap = 160;
    char* buf = new char[line_cap * (size_t)xdim + 8];
    for (int32_t y = 0; y < ydim; ++y) {
        char* p = buf;
        const size_t row = (size_t)y * xdim;
        for (int32_t x = 0; x < xdim; ++x) {
            const double vx = ux[row + x] * s_scale;
            const double vy = uy[row + x] * s_scale;
            // sqrt BEFORE scaling: matches the reference (main.cu:958)
            // and io/writers.py, so the %.6g digits round identically
            const double ab =
                std::sqrt(ux[row + x] * ux[row + x]
                          + uy[row + x] * uy[row + x]) * s_scale;
            p = fmt_g6(p, x * x_scale);
            *p++ = '\t';
            p = fmt_g6(p, y * x_scale);
            *p++ = '\t';
            p = fmt_g6(p, vx);
            *p++ = '\t';
            p = fmt_g6(p, vy);
            *p++ = '\t';
            p = fmt_g6(p, ab);
            *p++ = '\t';
            p = fmt_g6(p, rho[row + x]);
            *p++ = '\n';
        }
        *p++ = '\n';  // blank separator after each grid row (main.cu:968)
        if (std::fwrite(buf, 1, (size_t)(p - buf), fp) != (size_t)(p - buf)) {
            delete[] buf;
            std::fclose(fp);
            return 2;
        }
    }
    delete[] buf;
    return std::fclose(fp) ? 3 : 0;
}

// Cilia snapshot: "<x*xs>\t<y*xs>\t<us*ss>\t<vs*ss>\t<eps>\n"; blank line
// after each cilium (every `length` points) or where the filament wraps
// across the periodic x boundary (main.cu:991).
int iblb_write_cilia_snapshot(const char* path, int32_t ns, int32_t length,
                              int32_t xdim, double x_scale, double s_scale,
                              const double* s, const double* u_s,
                              const int32_t* eps) {
    FILE* fp = std::fopen(path, "wb");
    if (!fp) return 1;
    char buf[256];
    for (int32_t k = 0; k < ns; ++k) {
        char* p = buf;
        p = fmt_g6(p, s[2 * k + 0] * x_scale);
        *p++ = '\t';
        p = fmt_g6(p, s[2 * k + 1] * x_scale);
        *p++ = '\t';
        p = fmt_g6(p, u_s[2 * k + 0] * s_scale);
        *p++ = '\t';
        p = fmt_g6(p, u_s[2 * k + 1] * s_scale);
        *p++ = '\t';
        p += std::snprintf(p, 16, "%d", (int)eps[k]);
        *p++ = '\n';
        if (k % length == length - 1 || s[2 * k] > xdim - 1 || s[2 * k] < 1)
            *p++ = '\n';
        if (std::fwrite(buf, 1, (size_t)(p - buf), fp) != (size_t)(p - buf)) {
            std::fclose(fp);
            return 2;
        }
    }
    return std::fclose(fp) ? 3 : 0;
}

}  // extern "C"
