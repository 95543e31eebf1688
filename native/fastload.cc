// Fast npy data loader: mmap + parallel scrub/cast/transpose.
//
// Native runtime component of the DPMM framework (the reference's data
// path is a single-threaded Julia npy read + NaN scrub + transpose,
// src/utils.jl:5-14).  For the 10M x 64-d flagship workloads the Python
// loader becomes a startup bottleneck; this library does the whole
// file -> float32 [N, D] row-major conversion with OpenMP across cores and
// no intermediate copies beyond the output buffer.
//
// Exposed as a tiny C ABI consumed via ctypes (dpmmsubclusters_tpu/io/npy.py).
// Build: see native/build.sh (produces libdpmmfastload.so).

#include <cmath>
#include <cstdint>
#include <cstring>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

template <typename SrcT>
void convert_rows(const SrcT* src, float* dst, int64_t n, int64_t d,
                  bool swap_dims) {
  // swap_dims: file stores D x N (reference layout); output is N x D.
  if (!swap_dims) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
      const SrcT* row = src + i * d;
      float* out = dst + i * d;
      for (int64_t j = 0; j < d; ++j) {
        float v = static_cast<float>(row[j]);
        out[j] = std::isnan(v) ? 0.0f : v;
      }
    }
  } else {
    // blocked transpose for cache friendliness
    const int64_t B = 64;
#pragma omp parallel for collapse(2) schedule(static)
    for (int64_t ib = 0; ib < n; ib += B) {
      for (int64_t jb = 0; jb < d; jb += B) {
        int64_t imax = ib + B < n ? ib + B : n;
        int64_t jmax = jb + B < d ? jb + B : d;
        for (int64_t i = ib; i < imax; ++i) {
          for (int64_t j = jb; j < jmax; ++j) {
            float v = static_cast<float>(src[j * n + i]);
            dst[i * d + j] = std::isnan(v) ? 0.0f : v;
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// dtype codes: 0=f32, 1=f64, 2=i32, 3=i64, 4=u8, 5=i16, 6=u16, 7=i8
int dpmm_convert(const void* src, int dtype, float* dst, int64_t n, int64_t d,
                 int swap_dims) {
  bool sw = swap_dims != 0;
  switch (dtype) {
    case 0: convert_rows(static_cast<const float*>(src), dst, n, d, sw); break;
    case 1: convert_rows(static_cast<const double*>(src), dst, n, d, sw); break;
    case 2: convert_rows(static_cast<const int32_t*>(src), dst, n, d, sw); break;
    case 3: convert_rows(static_cast<const int64_t*>(src), dst, n, d, sw); break;
    case 4: convert_rows(static_cast<const uint8_t*>(src), dst, n, d, sw); break;
    case 5: convert_rows(static_cast<const int16_t*>(src), dst, n, d, sw); break;
    case 6: convert_rows(static_cast<const uint16_t*>(src), dst, n, d, sw); break;
    case 7: convert_rows(static_cast<const int8_t*>(src), dst, n, d, sw); break;
    default: return -1;
  }
  return 0;
}

int dpmm_num_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
