// Batched blocked triangular solve T x = b through precomputed inverses of
// T's (bs, bs) diagonal blocks, lower (forward) or upper (back).
//
// Replaces the TPU kernel `_pallas_btrsm` / `_btrsm_kernel` in
// conflux_tpu/ops/batched_trsm.py (public `pallas_blocked_trsm`): the
// substitution engine of blocked serve plans. Per block step j (in order
// for a lower solve, in reverse for an upper one): x_j = Dinv_j r_j, then
// the rows not yet solved are downdated by T[rows, j-block] x_j. Only the
// strictly-lower (lower) or strictly-upper (upper) panels of T are read, so
// T may be a packed LU: its other triangle is never touched.
//
// Bound on an H100: bytes and latency. A (256, 256) system with 16
// right-hand sides does ~1 Mflop on ~0.3 MB of T; the block steps are a
// chain (step j needs x of every earlier step), 8 of them at n = 256.
//
// Design: one CTA per (system, tile of up to 16 right-hand-side columns),
// the step loop inside the CTA. The running right-hand side of the tile
// lives in shared memory for the whole solve (256 x 16 f32 is 16 KiB,
// 1024 x 16 is 64 KiB), so T's column panel and Dinv_j are the only reads
// of device memory, each once per step. A ragged n (n not a multiple of
// bs) is handled in place, with the result of an identity-extended T: pad
// rows of the right-hand side are zero, pad entries of T read as zero and
// pad rows are never downdated. Sums are fused multiply-adds in the
// accumulation type (f32 for f32 operands, f64 for f64); each output
// depends only on its own system, so a system's answer does not depend on
// the batch. Tensor cores (wgmma, f64 DMMA) and TMA are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;  // threads per CTA

template <typename T>
__global__ void __launch_bounds__(NT)
btrsm_kernel(int n, int nb, int bs, int k, int kt, int lower, const T* __restrict__ t,
             const T* __restrict__ dinv, const T* __restrict__ b, T* __restrict__ x) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* acc = reinterpret_cast<T*>(smem_raw);  // (np, kt) running right-hand side
  const int np = nb * bs;
  T* xs = acc + static_cast<size_t>(np) * kt;  // (bs, kt) this step's x block

  const size_t sys = blockIdx.x;
  const int c0 = blockIdx.y * kt;
  const int kw = min(kt, k - c0);
  const T* Ts = t + sys * n * n;
  const T* D = dinv + sys * nb * bs * bs;
  const T* Bs = b + sys * n * k;
  T* X = x + sys * n * k;
  const int tid = threadIdx.x;

  for (int e = tid; e < np * kt; e += NT) {
    const int r = e / kt, c = e % kt;
    acc[e] = (r < n && c < kw) ? Bs[static_cast<size_t>(r) * k + c0 + c] : T(0);
  }
  __syncthreads();

  for (int s = 0; s < nb; ++s) {
    const int j = lower ? s : nb - 1 - s;
    const int j0 = j * bs;
    // x_j = Dinv_j r_j
    const T* Dj = D + static_cast<size_t>(j) * bs * bs;
    for (int e = tid; e < bs * kt; e += NT) {
      const int r = e / kt, c = e % kt;
      const T* Dr = Dj + static_cast<size_t>(r) * bs;
      T sum = T(0);
      for (int q = 0; q < bs; ++q) sum = fma(Dr[q], acc[(j0 + q) * kt + c], sum);
      xs[e] = sum;
    }
    __syncthreads();
    for (int e = tid; e < bs * kt; e += NT) {
      const int r = j0 + e / kt, c = e % kt;
      if (r < n && c < kw) X[static_cast<size_t>(r) * k + c0 + c] = xs[e];
    }
    // downdate the rows not yet solved: below the block (lower), above it
    // (upper); pad rows (>= n) stay zero
    const int r_lo = lower ? j0 + bs : 0;
    const int r_hi = lower ? n : j0;
    const int qmax = min(bs, n - j0);  // pad columns of T read as zero
    for (int e = tid; e < (r_hi - r_lo) * kt; e += NT) {
      const int r = r_lo + e / kt, c = e % kt;
      const T* Tr = Ts + static_cast<size_t>(r) * n + j0;
      T sum = T(0);
      for (int q = 0; q < qmax; ++q) sum = fma(Tr[q], xs[q * kt + c], sum);
      acc[r * kt + c] -= sum;
    }
    __syncthreads();
  }
}

template <typename T>
int launch(int n, int nb, int bs, int k, int kt, int lower, const void* t,
           const void* dinv, const void* b, void* x, int batch, cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(nb) * bs + bs) * kt * sizeof(T);
  cudaError_t e = cudaFuncSetAttribute(btrsm_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid(batch, (k + kt - 1) / kt);
  btrsm_kernel<T><<<grid, NT, smem, stream>>>(
      n, nb, bs, k, kt, lower, static_cast<const T*>(t), static_cast<const T*>(dinv),
      static_cast<const T*>(b), static_cast<T*>(x));
  return cudaGetLastError();
}

}  // namespace

// dtype 0: float32, 1: float64. t: (batch, n, n), dinv: (batch, nb, bs, bs),
// b and x: (batch, n, k), all contiguous and of that dtype; nb * bs >= n.
// kt: right-hand-side columns per CTA. Returns the cudaError_t of the launch.
extern "C" int conflux_btrsm(int dtype, int device, int batch, int n, int nb, int bs,
                             int k, int kt, int lower, const void* t, const void* dinv,
                             const void* b, void* x, void* stream) {
  if (batch <= 0 || n <= 0 || k <= 0 || kt <= 0 || bs <= 0 || nb * bs < n)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(n, nb, bs, k, kt, lower, t, dinv, b, x, batch, s);
  if (dtype == 1) return launch<double>(n, nb, bs, k, kt, lower, t, dinv, b, x, batch, s);
  return cudaErrorInvalidValue;
}
