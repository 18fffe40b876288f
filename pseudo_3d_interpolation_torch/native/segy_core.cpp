// Native SEG-Y hot paths: IBM<->IEEE float conversion and strided
// trace-block decoding, parallelized with OpenMP.
//
// The PyTorch port's copy of the JAX package's native/segy_core.cpp,
// byte for byte below this comment. pseudo_3d_interpolation_torch/io/
// native.py builds it with g++ at first use into the package's _build/;
// the codec (io/segy.py) falls back to vectorized numpy when it cannot be
// built. It accelerates bulk loads of large surveys where the IBM-float
// decode dominates (format 1 files).
//
// ABI: plain C functions over contiguous buffers (ctypes-friendly).

#include <cstdint>
#include <cstring>
#include <cmath>

#if defined(_OPENMP)
#include <omp.h>
#endif

extern "C" {

// big-endian 32-bit load
static inline uint32_t load_be32(const uint8_t* p) {
    return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
           (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

static inline int32_t load_be32s(const uint8_t* p) {
    return (int32_t)load_be32(p);
}

static inline int16_t load_be16s(const uint8_t* p) {
    return (int16_t)((uint16_t(p[0]) << 8) | uint16_t(p[1]));
}

static inline float ibm_to_float(uint32_t u) {
    if ((u & 0x7fffffffu) == 0) return 0.0f;
    const double sign = (u >> 31) ? -1.0 : 1.0;
    const int exponent = int((u >> 24) & 0x7f) - 64;
    const double mantissa = double(u & 0x00ffffffu) / double(1 << 24);
    return (float)(sign * mantissa * std::pow(16.0, exponent));
}

static inline uint32_t float_to_ibm(float xf) {
    double x = (double)xf;
    uint32_t sign = x < 0 ? (1u << 31) : 0u;
    double ax = std::fabs(x);
    if (ax == 0.0 || std::isnan(x)) return 0u;
    // saturate at IBM max like the numpy codec (log2(inf) would be UB in
    // the int cast below); IBM single max ~= 7.2e75
    if (std::isinf(x) || ax >= 7.237005577332262e75)
        return sign | 0x7fffffffu;
    int e = (int)std::floor(std::log2(ax) / 4.0) + 1;
    double mant = ax / std::pow(16.0, e);
    if (mant >= 1.0) { mant /= 16.0; ++e; }
    if (mant < 1.0 / 16.0) { mant *= 16.0; --e; }
    uint64_t m24 = (uint64_t)std::llround(mant * double(1 << 24));
    if (m24 >= (1ull << 24)) { m24 >>= 4; ++e; }
    int exp = e + 64;
    if (exp < 0) exp = 0;
    if (exp > 127) exp = 127;
    return sign | (uint32_t(exp) << 24) | (uint32_t(m24) & 0x00ffffffu);
}

// Convert n IBM floats (as raw big-endian bytes) to float32.
void ibm2ieee_buffer(const uint8_t* in, float* out, int64_t n) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        out[i] = ibm_to_float(load_be32(in + 4 * i));
    }
}

void ieee2ibm_buffer(const float* in, uint8_t* out, int64_t n) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        uint32_t u = float_to_ibm(in[i]);
        out[4 * i + 0] = (uint8_t)(u >> 24);
        out[4 * i + 1] = (uint8_t)(u >> 16);
        out[4 * i + 2] = (uint8_t)(u >> 8);
        out[4 * i + 3] = (uint8_t)(u);
    }
}

// Decode the sample block of `ntraces` traces laid out with stride
// `trace_size` bytes starting at `base` (header already skipped by caller
// passing base = file + data_start + 240). Formats: 1 IBM, 2 i32, 3 i16,
// 5 IEEE f32, 8 i8.
int decode_traces(const uint8_t* base, int64_t trace_size, int64_t ntraces,
                  int64_t nsamples, int format, float* out) {
    switch (format) {
    case 1:
#pragma omp parallel for schedule(static)
        for (int64_t t = 0; t < ntraces; ++t) {
            const uint8_t* p = base + t * trace_size;
            float* o = out + t * nsamples;
            for (int64_t s = 0; s < nsamples; ++s)
                o[s] = ibm_to_float(load_be32(p + 4 * s));
        }
        return 0;
    case 2:
#pragma omp parallel for schedule(static)
        for (int64_t t = 0; t < ntraces; ++t) {
            const uint8_t* p = base + t * trace_size;
            float* o = out + t * nsamples;
            for (int64_t s = 0; s < nsamples; ++s)
                o[s] = (float)load_be32s(p + 4 * s);
        }
        return 0;
    case 3:
#pragma omp parallel for schedule(static)
        for (int64_t t = 0; t < ntraces; ++t) {
            const uint8_t* p = base + t * trace_size;
            float* o = out + t * nsamples;
            for (int64_t s = 0; s < nsamples; ++s)
                o[s] = (float)load_be16s(p + 2 * s);
        }
        return 0;
    case 5:
#pragma omp parallel for schedule(static)
        for (int64_t t = 0; t < ntraces; ++t) {
            const uint8_t* p = base + t * trace_size;
            float* o = out + t * nsamples;
            for (int64_t s = 0; s < nsamples; ++s) {
                uint32_t u = load_be32(p + 4 * s);
                float f;
                std::memcpy(&f, &u, 4);
                o[s] = f;
            }
        }
        return 0;
    case 8:
#pragma omp parallel for schedule(static)
        for (int64_t t = 0; t < ntraces; ++t) {
            const uint8_t* p = base + t * trace_size;
            float* o = out + t * nsamples;
            for (int64_t s = 0; s < nsamples; ++s)
                o[s] = (float)(int8_t)p[s];
        }
        return 0;
    default:
        return -1;
    }
}

// Extract one big-endian header column (width 2 or 4 bytes at 0-based
// `offset` inside each 240-byte trace header) into int64 out.
int header_column(const uint8_t* base, int64_t trace_size, int64_t ntraces,
                  int64_t offset, int width, int64_t* out) {
    if (width == 4) {
#pragma omp parallel for schedule(static)
        for (int64_t t = 0; t < ntraces; ++t)
            out[t] = (int64_t)load_be32s(base + t * trace_size + offset);
        return 0;
    }
    if (width == 2) {
#pragma omp parallel for schedule(static)
        for (int64_t t = 0; t < ntraces; ++t)
            out[t] = (int64_t)load_be16s(base + t * trace_size + offset);
        return 0;
    }
    return -1;
}

}  // extern "C"
