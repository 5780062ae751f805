// Native streaming IO engine: move matrices between binary files and
// block-cyclic shard buffers WITHOUT materializing the global matrix.
//
// Role of the reference's MPI-IO layer (`src/conflux/cholesky/CholeskyIO.cpp`
// :185-375 file parse + tile scatter, :384-501 MPI_File_write_at dumps): on a
// single host there is one filesystem instead of a rank-collective file view, so
// the equivalent is an mmap'd window over the file with the same OpenMP tile
// copy the in-memory layout engine uses. For matrices larger than host RAM
// the page cache streams tiles in and out; only the shard buffers are real
// allocations.
//
// Plain C ABI for ctypes (no pybind11 needed). Return codes:
// 0 ok, -1 open failed, -2 file too short, -3 mmap failed, -4 resize failed.

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <cstdint>

#include "tile_copy.hpp"

namespace {

template <typename T>
int file_scatter(const char* path, T* shards, int64_t header, int64_t M,
                 int64_t N, int64_t v, int64_t Px, int64_t Py) {
  const int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  const size_t len = size_t(header) + size_t(M) * N * sizeof(T);
  struct stat st;
  if (fstat(fd, &st) != 0 || size_t(st.st_size) < len) {
    close(fd);
    return -2;
  }
  void* map = mmap(nullptr, len, PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);
  if (map == MAP_FAILED) return -3;
  const T* A = reinterpret_cast<const T*>(static_cast<const char*>(map) + header);
  conflux_native::scatter_impl(A, shards, M, N, v, Px, Py);
  munmap(map, len);
  return 0;
}

template <typename T>
int file_gather(const char* path, const T* shards, int64_t header, int64_t M,
                int64_t N, int64_t v, int64_t Px, int64_t Py) {
  // file must already exist with the header written (Python owns the format)
  const int fd = open(path, O_RDWR);
  if (fd < 0) return -1;
  const size_t len = size_t(header) + size_t(M) * N * sizeof(T);
  if (ftruncate(fd, off_t(len)) != 0) {
    close(fd);
    return -4;
  }
  void* map = mmap(nullptr, len, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (map == MAP_FAILED) return -3;
  T* A = reinterpret_cast<T*>(static_cast<char*>(map) + header);
  conflux_native::gather_impl(shards, A, M, N, v, Px, Py);
  munmap(map, len);  // MAP_SHARED: kernel flushes dirtied pages
  return 0;
}

}  // namespace

extern "C" {

int conflux_file_scatter_f32(const char* path, float* shards, int64_t header,
                             int64_t M, int64_t N, int64_t v, int64_t Px,
                             int64_t Py) {
  return file_scatter(path, shards, header, M, N, v, Px, Py);
}
int conflux_file_scatter_f64(const char* path, double* shards, int64_t header,
                             int64_t M, int64_t N, int64_t v, int64_t Px,
                             int64_t Py) {
  return file_scatter(path, shards, header, M, N, v, Px, Py);
}
int conflux_file_gather_f32(const char* path, const float* shards,
                            int64_t header, int64_t M, int64_t N, int64_t v,
                            int64_t Px, int64_t Py) {
  return file_gather(path, shards, header, M, N, v, Px, Py);
}
int conflux_file_gather_f64(const char* path, const double* shards,
                            int64_t header, int64_t M, int64_t N, int64_t v,
                            int64_t Px, int64_t Py) {
  return file_gather(path, shards, header, M, N, v, Px, Py);
}

}  // extern "C"
