// Batched lower Cholesky of (B, n, n) systems, with the probe row
// wA = w^T A of each untouched input.
//
// Replaces the TPU kernel `_pallas_bchol` / `_bchol_kernel` in
// conflux_tpu/ops/pallas_factor.py (public `pallas_cholesky_factor_batched`):
// the factor of every SPD serve plan and of its coalesced factor lane. Per
// slot and column j, with a_jj the running diagonal:
//   - every entry (i, k) with i > j and k > j becomes
//     A[i,k] - (A[i,j] * A[j,k]) / a_jj, three separately rounded steps.
//     The update covers BOTH triangles, as the TPU kernel's does: row j is
//     read from the upper triangle, which earlier columns kept current, so
//     an input whose upper triangle differs from its lower one gives the
//     TPU kernel's result and not that of its lower triangle alone;
//   - column j from the diagonal down becomes A[i,j] / sqrt(a_jj).
// The output is the lower triangle with the strict upper triangle zero.
//
// Bound on an H100: the updates' traffic. The arithmetic is ~n^3/3 updates
// per slot; one (256, 256) f32 slot is 256 KiB, more than a CTA's 227 KB of
// shared memory, so every column's update reads and writes the running
// matrix in L2 (all of it at 32 x 256 x 256) or HBM (at 32 x 1024 x 1024).
//
// Design: K4's (batched_lu.cu) without the pivot election. One CTA per
// slot, the running matrix in the output buffer, the column loop inside the
// CTA and ONE block barrier per column. Each warp owns whole rows i > j; its
// lanes sweep the columns after j coalesced, eight columns a lane loaded
// before any is written. Row j is only read during column j (its trailing
// part lies outside the update), so the one hazard is the diagonal: every
// thread reads a_jj at the top of column j, so its write-back is deferred
// to the top of column j + 1, past the barrier. The update and the scale
// use the _rn intrinsics, which nvcc never contracts into an FMA: the plain
// PyTorch version (`hopper_kernels.batched_chol_plain`) does the same three
// roundings with tensor ops, and the two agree bit for bit. Each element's
// value is a fixed chain whatever thread runs it, so a slot's bits depend
// only on its own input. a_jj <= 0 (a slot that is not positive definite)
// gives NaN from the square root in column j of that slot and nowhere else.
// Updating only the lower triangle (half the traffic) needs a stated
// symmetric-input contract first, and is later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "slot_io.cuh"

namespace {

constexpr int NT = 512;  // threads per CTA
constexpr int NWARPS = NT / 32;
constexpr int U = 8;  // columns in flight per lane in the update

template <typename T>
struct Rn;

template <>
struct Rn<float> {
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float sqrt(float a) { return __fsqrt_rn(a); }
};

template <>
struct Rn<double> {
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double sqrt(double a) { return __dsqrt_rn(a); }
};

template <typename T>
__global__ void __launch_bounds__(NT)
batched_chol_kernel(int n, const T* __restrict__ a, T* out, const T* __restrict__ w,
                    T* __restrict__ wa) {
  using R = Rn<T>;
  const size_t slot = blockIdx.x;
  const size_t nn = static_cast<size_t>(n) * n;
  const T* A = a + slot * nn;
  T* O = out + slot * nn;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  conflux::copy_slot_and_probe<T, NT>(n, A, O, w, w == nullptr ? nullptr : wa + slot * n);
  __syncthreads();

  T pend = T(0);  // thread 0: L_{j-1,j-1}, written once column j has begun
  for (int j = 0; j < n; ++j) {
    T* Oj = O + static_cast<size_t>(j) * n;
    const T ajj = Oj[j];
    const T ljj = R::sqrt(ajj);
    if (tid == 0) {
      if (j > 0) O[static_cast<size_t>(j - 1) * n + (j - 1)] = pend;
      pend = R::div(ajj, ljj);
    }
    for (int r = j + 1 + warp; r < n; r += NWARPS) {
      T* Or = O + static_cast<size_t>(r) * n;
      const T arj = Or[j];
      for (int c0 = j + 1 + lane; c0 < n; c0 += 32 * U) {
        T av[U], pv[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int c = c0 + 32 * u;
          if (c < n) {
            av[u] = Or[c];
            pv[u] = Oj[c];
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int c = c0 + 32 * u;
          if (c < n) Or[c] = R::sub(av[u], R::div(R::mul(arj, pv[u]), ajj));
        }
      }
      __syncwarp();  // every lane has read Or[j]
      if (lane == 0) Or[j] = R::div(arj, ljj);
    }
    __syncthreads();
  }
  // every read of the upper triangle is done: zero it, and write the last
  // diagonal entry
  if (tid == 0) O[static_cast<size_t>(n - 1) * n + (n - 1)] = pend;
  for (size_t e = tid; e < nn; e += NT) {
    const size_t r = e / n, c = e % n;
    if (c > r) O[e] = T(0);
  }
}

template <typename T>
int launch(int batch, int n, const void* a, void* out, const void* w, void* wa,
           cudaStream_t stream) {
  batched_chol_kernel<T><<<batch, NT, 0, stream>>>(
      n, static_cast<const T*>(a), static_cast<T*>(out), static_cast<const T*>(w),
      static_cast<T*>(wa));
  return cudaGetLastError();
}

}  // namespace

// dtype 0: float32, 1: float64. a, out: (batch, n, n) contiguous of that
// dtype; w: (n,) of that dtype or NULL (no probe row); wa: (batch, n) or
// NULL. out receives the lower Cholesky factors, strict upper triangles
// zero. Returns the cudaError_t of the launch.
extern "C" int conflux_batched_chol(int dtype, int device, int batch, int n, const void* a,
                                    void* out, const void* w, void* wa, void* stream) {
  if (batch <= 0 || n <= 0) return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(batch, n, a, out, w, wa, s);
  if (dtype == 1) return launch<double>(batch, n, a, out, w, wa, s);
  return cudaErrorInvalidValue;
}
