// Shared tile-copy kernels for the native host runtime: block-cyclic
// scatter/gather between a row-major global matrix view and per-device
// shard buffers. Used by the in-memory layout engine (layout_native.cpp)
// and the mmap streaming IO engine (io_native.cpp).
//
// Layout convention (matches conflux_tpu_torch.geometry.LUGeometry.scatter):
//   global tile (ti, tj) of size v x v lives on device (ti % Px, tj % Py)
//   at local tile slot (ti / Px, tj / Py); shards is one contiguous buffer
//   of shape (Px, Py, Ml, Nl) with Ml = Mt/Px*v, Nl = Nt/Py*v.

#pragma once

#include <cstdint>
#include <cstring>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace conflux_native {

template <typename T>
void scatter_impl(const T* A, T* shards, int64_t M, int64_t N, int64_t v,
                  int64_t Px, int64_t Py) {
  const int64_t Mt = M / v, Nt = N / v;
  const int64_t Ml = (Mt / Px) * v, Nl = (Nt / Py) * v;
#pragma omp parallel for collapse(2) schedule(static)
  for (int64_t ti = 0; ti < Mt; ++ti) {
    for (int64_t tj = 0; tj < Nt; ++tj) {
      const int64_t px = ti % Px, py = tj % Py;
      const int64_t lt = ti / Px, lj = tj / Py;
      const T* src = A + ti * v * N + tj * v;
      T* dst = shards + ((px * Py + py) * Ml + lt * v) * Nl + lj * v;
      for (int64_t r = 0; r < v; ++r) {
        std::memcpy(dst + r * Nl, src + r * N, sizeof(T) * v);
      }
    }
  }
}

template <typename T>
void gather_impl(const T* shards, T* A, int64_t M, int64_t N, int64_t v,
                 int64_t Px, int64_t Py) {
  const int64_t Mt = M / v, Nt = N / v;
  const int64_t Ml = (Mt / Px) * v, Nl = (Nt / Py) * v;
#pragma omp parallel for collapse(2) schedule(static)
  for (int64_t ti = 0; ti < Mt; ++ti) {
    for (int64_t tj = 0; tj < Nt; ++tj) {
      const int64_t px = ti % Px, py = tj % Py;
      const int64_t lt = ti / Px, lj = tj / Py;
      T* dst = A + ti * v * N + tj * v;
      const T* src = shards + ((px * Py + py) * Ml + lt * v) * Nl + lj * v;
      for (int64_t r = 0; r < v; ++r) {
        std::memcpy(dst + r * N, src + r * Nl, sizeof(T) * v);
      }
    }
  }
}

}  // namespace conflux_native

namespace conflux_native {

// Block-cyclic shard buffer (Px, Py, Ml, Nl) <-> tiles packed in global
// (ti, tj) row-major order, each tile (v, v) contiguous. Owner-agnostic:
// the custom-layout (costa::custom_layout) transform slices per-owner
// VIEWS of the packed buffer on the Python side, so one kernel serves
// every owner array.

template <typename T>
void bc_to_tiles_impl(const T* shards, T* tiles, int64_t M, int64_t N,
                      int64_t v, int64_t Px, int64_t Py) {
  const int64_t Mt = M / v, Nt = N / v;
  const int64_t Ml = (Mt / Px) * v, Nl = (Nt / Py) * v;
#if defined(_OPENMP)
#pragma omp parallel for collapse(2) schedule(static)
#endif
  for (int64_t ti = 0; ti < Mt; ++ti) {
    for (int64_t tj = 0; tj < Nt; ++tj) {
      const int64_t px = ti % Px, py = tj % Py;
      const int64_t lt = ti / Px, lj = tj / Py;
      const T* src = shards + ((px * Py + py) * Ml + lt * v) * Nl + lj * v;
      T* dst = tiles + (ti * Nt + tj) * v * v;
      for (int64_t r = 0; r < v; ++r) {
        std::memcpy(dst + r * v, src + r * Nl, sizeof(T) * v);
      }
    }
  }
}

template <typename T>
void tiles_to_bc_impl(const T* tiles, T* shards, int64_t M, int64_t N,
                      int64_t v, int64_t Px, int64_t Py) {
  const int64_t Mt = M / v, Nt = N / v;
  const int64_t Ml = (Mt / Px) * v, Nl = (Nt / Py) * v;
#if defined(_OPENMP)
#pragma omp parallel for collapse(2) schedule(static)
#endif
  for (int64_t ti = 0; ti < Mt; ++ti) {
    for (int64_t tj = 0; tj < Nt; ++tj) {
      const int64_t px = ti % Px, py = tj % Py;
      const int64_t lt = ti / Px, lj = tj / Py;
      const T* src = tiles + (ti * Nt + tj) * v * v;
      T* dst = shards + ((px * Py + py) * Ml + lt * v) * Nl + lj * v;
      for (int64_t r = 0; r < v; ++r) {
        std::memcpy(dst + r * Nl, src + r * v, sizeof(T) * v);
      }
    }
  }
}

}  // namespace conflux_native
