// Batched partial-pivot LU of (B, n, n) systems, rows never moving, with the
// probe row wA = w^T A of each untouched input.
//
// Replaces the TPU kernel `_pallas_blu` / `_blu_kernel` in
// conflux_tpu/ops/pallas_factor.py (public `pallas_lu_factor_batched`): the
// factor of every LU serve plan and of the coalesced factor lane. Per slot
// and column j: the pivot is the live row with the largest |a[r, j]| (ties
// to the smallest row; a NaN scores below every number, so a column of NaNs
// still elects a live row and nothing is indexed out of range); piv[j]
// records it; every other live row gets its multiplier a[r, j] / a[p, j] (an
// IEEE division) in column j and a full-width rank-1 update of every column
// after j (one fused multiply-add per element); the pivot row is frozen in
// place and so already holds its finished U row. The caller gathers rows
// into LAPACK order.
//
// Bound on an H100: the rank-1 updates' traffic. The arithmetic is 2/3 n^3
// flops per slot, ~0.34 ms of the card's f32 rate for 32 slots at n = 1024;
// the TPU kept each slot in VMEM, but one (256, 256) f32 slot is 256 KiB,
// more than a CTA's 227 KB of shared memory, so every update here reads and
// writes the running matrix in L2 (all of it at 32 x 256 x 256) or HBM.
//
// Design: one CTA per slot, the running matrix in global memory (the output
// buffer), the column loop inside the CTA, two block barriers per column.
// The live rows are a list in shared memory (the pivot is swapped out of it
// each column), so each column's argmax scans only live rows. The update
// gives each warp a live row: the lanes take its multiplier, then sweep the
// columns after j coalesced, eight columns a lane loaded before any is
// written, so a thread keeps eight loads in flight (one would leave the
// SM's memory pipe idle behind L2 and HBM latency). Each
// element's value is a fixed chain of FMAs, whatever thread runs it, and
// the argmax is a total order (score, then row), so a slot's bits depend on
// nothing but its own input: not on B, not on the other slots. Clusters
// with the slot in distributed shared memory, and blocked updates on the
// tensor cores, are later work.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "slot_io.cuh"

namespace {

constexpr int NT = 512;  // threads per CTA
constexpr int NWARPS = NT / 32;
constexpr int U = 8;  // columns in flight per lane in the update

template <typename T>
__device__ __forceinline__ bool better(T v, int r, T bv, int br) {
  return v > bv || (v == bv && r < br);
}

template <typename T>
__global__ void __launch_bounds__(NT)
batched_lu_kernel(int n, const T* __restrict__ a, T* __restrict__ out, int* __restrict__ piv,
                  const T* __restrict__ w, T* __restrict__ wa) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* pval = reinterpret_cast<T*>(smem_raw);          // per-warp argmax partials
  int* prow = reinterpret_cast<int*>(pval + NWARPS);
  int* lrow = prow + NWARPS;                          // live rows
  int* where = lrow + n;                              // row -> index in lrow

  const size_t slot = blockIdx.x;
  const size_t nn = static_cast<size_t>(n) * n;
  const T* A = a + slot * nn;
  T* O = out + slot * nn;
  int* P = piv + slot * n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // the slot into the output buffer, and the fused probe row off the
  // untouched input
  conflux::copy_slot_and_probe<T, NT>(n, A, O, w, w == nullptr ? nullptr : wa + slot * n);
  for (int r = tid; r < n; r += NT) {
    lrow[r] = r;
    where[r] = r;
  }
  __syncthreads();

  for (int j = 0; j < n; ++j) {
    const int cnt = n - j;  // live rows
    // pivot election over the live rows of column j
    T bv = T(-2);
    int br = INT_MAX;
    for (int i = tid; i < cnt; i += NT) {
      const int r = lrow[i];
      T v = fabs(O[static_cast<size_t>(r) * n + j]);
      if (isnan(v)) v = T(-1);
      if (better(v, r, bv, br)) { bv = v; br = r; }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const T ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int orow = __shfl_down_sync(0xffffffffu, br, off);
      if (better(ov, orow, bv, br)) { bv = ov; br = orow; }
    }
    if (lane == 0) {
      pval[warp] = bv;
      prow[warp] = br;
    }
    __syncthreads();
    // every thread reduces the partials in the same order
    bv = pval[0];
    int p = prow[0];
    for (int q = 1; q < NWARPS; ++q)
      if (better(pval[q], prow[q], bv, p)) { bv = pval[q]; p = prow[q]; }
    const T* Op = O + static_cast<size_t>(p) * n;
    const T pivot = Op[j];
    // live rows after this column: the pivot's slot takes the last row
    const int ip = where[p];
    const int rlast = lrow[cnt - 1];
    const int m = cnt - 1;
    if (tid == 0) {
      P[j] = p;
      if (ip != m) {  // else the pivot is already the last live row
        lrow[ip] = rlast;
        where[rlast] = ip;
      }
    }
    // a warp per live row: its multiplier, then the rank-1 update of the
    // columns after j, U columns a lane loaded before any is written
    for (int i = warp; i < m; i += NWARPS) {
      const int r = (i == ip) ? rlast : lrow[i];
      T* Or = O + static_cast<size_t>(r) * n;
      const T l = Or[j] / pivot;
      for (int c0 = j + 1 + lane; c0 < n; c0 += 32 * U) {
        T av[U], pv[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int c = c0 + 32 * u;
          if (c < n) {
            av[u] = Or[c];
            pv[u] = Op[c];
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int c = c0 + 32 * u;
          if (c < n) Or[c] = fma(-l, pv[u], av[u]);
        }
      }
      __syncwarp();  // every lane has read Or[j]
      if (lane == 0) Or[j] = l;
    }
    __syncthreads();
  }
}

template <typename T>
int launch(int batch, int n, const void* a, void* out, int* piv, const void* w, void* wa,
           cudaStream_t stream) {
  const size_t smem = NWARPS * sizeof(T) + (static_cast<size_t>(NWARPS) + 2 * n) * sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(batched_lu_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  batched_lu_kernel<T><<<batch, NT, smem, stream>>>(
      n, static_cast<const T*>(a), static_cast<T*>(out), piv, static_cast<const T*>(w),
      static_cast<T*>(wa));
  return cudaGetLastError();
}

}  // namespace

// dtype 0: float32, 1: float64. a, out: (batch, n, n) contiguous of that
// dtype; piv: (batch, n) int32; w: (n,) of that dtype or NULL (no probe
// row); wa: (batch, n) or NULL. out holds the factors in place (rows in
// their input order). Returns the cudaError_t of the launch.
extern "C" int conflux_batched_lu(int dtype, int device, int batch, int n, const void* a,
                                  void* out, int* piv, const void* w, void* wa,
                                  void* stream) {
  if (batch <= 0 || n <= 0) return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(batch, n, a, out, piv, w, wa, s);
  if (dtype == 1) return launch<double>(batch, n, a, out, piv, w, wa, s);
  return cudaErrorInvalidValue;
}
