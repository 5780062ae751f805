// Native layout engine: block-cyclic scatter/gather between a row-major
// global matrix and per-device shard buffers.
//
// This is the port's counterpart of the reference's native
// redistribution layer (COSTA, consumed through src/conflux/lu/layout.cpp):
// the host-side half of moving matrices between user layout and the
// framework's block-cyclic device layout. The hot path is a strided tile
// copy, memory-bandwidth-bound, parallelized over tiles with OpenMP
// (kernels in tile_copy.hpp, shared with the streaming IO engine).
//
// Exposed as a plain C ABI for ctypes (no pybind11 needed).

#include <cstdint>

#include "tile_copy.hpp"

extern "C" {

void conflux_scatter_f32(const float* A, float* shards, int64_t M, int64_t N,
                         int64_t v, int64_t Px, int64_t Py) {
  conflux_native::scatter_impl(A, shards, M, N, v, Px, Py);
}
void conflux_scatter_f64(const double* A, double* shards, int64_t M, int64_t N,
                         int64_t v, int64_t Px, int64_t Py) {
  conflux_native::scatter_impl(A, shards, M, N, v, Px, Py);
}
void conflux_gather_f32(const float* shards, float* A, int64_t M, int64_t N,
                        int64_t v, int64_t Px, int64_t Py) {
  conflux_native::gather_impl(shards, A, M, N, v, Px, Py);
}
void conflux_gather_f64(const double* shards, double* A, int64_t M, int64_t N,
                        int64_t v, int64_t Px, int64_t Py) {
  conflux_native::gather_impl(shards, A, M, N, v, Px, Py);
}

int conflux_native_nthreads() {
#if defined(_OPENMP)
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"

extern "C" {

void conflux_bc_to_tiles_f32(const float* shards, float* tiles, int64_t M,
                             int64_t N, int64_t v, int64_t Px, int64_t Py) {
  conflux_native::bc_to_tiles_impl(shards, tiles, M, N, v, Px, Py);
}
void conflux_bc_to_tiles_f64(const double* shards, double* tiles, int64_t M,
                             int64_t N, int64_t v, int64_t Px, int64_t Py) {
  conflux_native::bc_to_tiles_impl(shards, tiles, M, N, v, Px, Py);
}
void conflux_tiles_to_bc_f32(const float* tiles, float* shards, int64_t M,
                             int64_t N, int64_t v, int64_t Px, int64_t Py) {
  conflux_native::tiles_to_bc_impl(tiles, shards, M, N, v, Px, Py);
}
void conflux_tiles_to_bc_f64(const double* tiles, double* shards, int64_t M,
                             int64_t N, int64_t v, int64_t Px, int64_t Py) {
  conflux_native::tiles_to_bc_impl(tiles, shards, M, N, v, Px, Py);
}

}  // extern "C"
