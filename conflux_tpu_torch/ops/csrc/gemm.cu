// Trailing-update GEMM: out = alpha * (a @ b) + beta * c, f32 accumulation.
//
// Replaces the TPU kernel `_gemm` / `_matmul_kernel` in
// conflux_tpu/ops/pallas_kernels.py (public `gemm`), which carries ~2/3 N^3
// of the LU factorization's flops (the trailing update of every superstep).
//
// Bound on an H100: operations. The work is 2*M*N*K flops on
// M*K + K*N + 2*M*N elements, so at the factorization's shapes (K = v =
// 1024) it is ~250 flop per byte, far above the card's f32 ridge. The
// arithmetic must be IEEE f32 (the JAX package pins Precision.HIGHEST; TF32
// loses ~3 digits and the factor's residual with them), so the ceiling is
// the 67 TFLOP/s of the SIMT f32 pipes, not the tensor cores.
//
// Design: the classic shared-memory SGEMM. A CTA of 256 threads owns a
// 128x128 output tile and walks K in 16-deep slabs; each thread keeps an
// 8x8 register micro-tile (two 4-wide strips in each direction, so shared
// reads are 16-byte vectors without bank conflicts). The next slab is
// fetched into registers while the current one is multiplied, and shared
// memory is double-buffered, so there is one barrier per slab. Operands
// are read through leading dimensions, so the factorization passes views
// of its matrix (L10, A01) and updates the trailing block in place (out may
// alias c element for element). The alpha/beta epilogue of blas.gemm is
// folded into the store. bf16 operands are widened to f32 on their way to
// shared memory and the result is rounded to bf16 once, at the store.
// TMA and wgmma are later work: the tensor cores have no IEEE f32 mode.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 16, NT = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(uint16_t x) {
  return __uint_as_float(static_cast<uint32_t>(x) << 16);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ uint16_t from_f<uint16_t>(float x) {
  // float -> bfloat16, round to nearest even (NaN stays NaN)
  uint32_t u = __float_as_uint(x);
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0x7fc0;
  u += 0x7fffu + ((u >> 16) & 1u);
  return static_cast<uint16_t>(u >> 16);
}

// Four consecutive elements of row r, columns c0..c0+3, of an (R, C)
// row-major matrix with leading dimension ld, widened to f32; elements
// outside the matrix read as 0.
template <typename T>
__device__ __forceinline__ void load4(const T* __restrict__ p, int ld, int R,
                                      int C, int r, int c0, bool vec,
                                      float v[4]) {
  if (vec && r < R && c0 + 3 < C) {
    const T* q = p + static_cast<size_t>(r) * ld + c0;
    if constexpr (sizeof(T) == 4) {
      float4 x = *reinterpret_cast<const float4*>(q);
      v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
    } else {
      uint2 x = *reinterpret_cast<const uint2*>(q);
      v[0] = __uint_as_float(x.x << 16);
      v[1] = __uint_as_float(x.x & 0xffff0000u);
      v[2] = __uint_as_float(x.y << 16);
      v[3] = __uint_as_float(x.y & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = c0 + i;
      v[i] = (r < R && c < C) ? to_f(p[static_cast<size_t>(r) * ld + c]) : 0.f;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT, 2)
gemm_kernel(int M, int N, int K, const T* __restrict__ A, int lda,
            const T* __restrict__ B, int ldb, const T* C, int ldc, T* Out,
            int ldo, float alpha, float beta, bool vec_a, bool vec_b) {
  __shared__ __align__(16) float As[2][BK][BM];  // A slab, transposed
  __shared__ __align__(16) float Bs[2][BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;

  // slab loads: A (128 x 16) as rows tid/4 (+64) x k (tid%4)*4..+3;
  // B (16 x 128) as k tid/32 (+8) x columns (tid%32)*4..+3
  float ra[2][4], rb[2][4];
  auto gload = [&](int kt) {
    const int kb = kt * BK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      load4(A, lda, M, K, row0 + tid / 4 + 64 * i, kb + (tid % 4) * 4, vec_a, ra[i]);
      load4(B, ldb, K, N, kb + tid / 32 + 8 * i, col0 + (tid % 32) * 4, vec_b, rb[i]);
    }
  };
  auto sstore = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = tid / 4 + 64 * i, k0 = (tid % 4) * 4;
#pragma unroll
      for (int q = 0; q < 4; ++q) As[buf][k0 + q][r] = ra[i][q];
      const int k = tid / 32 + 8 * i, c0 = (tid % 32) * 4;
      *reinterpret_cast<float4*>(&Bs[buf][k][c0]) =
          make_float4(rb[i][0], rb[i][1], rb[i][2], rb[i][3]);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int nk = (K + BK - 1) / BK;
  gload(0);
  sstore(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) gload(kt + 1);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[cur][k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[cur][k][64 + tx * 4]);
      const float af[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bf[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(af[i], bf[j], acc[i][j]);
    }
    if (kt + 1 < nk) sstore(cur ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = col0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (c >= N) continue;
      float v = alpha * acc[i][j];
      if (C != nullptr) v += beta * to_f(C[static_cast<size_t>(r) * ldc + c]);
      Out[static_cast<size_t>(r) * ldo + c] = from_f<T>(v);
    }
  }
}

template <typename T>
cudaError_t launch(int M, int N, int K, const void* a, int lda, const void* b,
                   int ldb, const void* c, int ldc, void* out, int ldo,
                   float alpha, float beta, cudaStream_t stream) {
  const uintptr_t align = 4 * sizeof(T);
  const bool vec_a = reinterpret_cast<uintptr_t>(a) % align == 0 && lda % 4 == 0;
  const bool vec_b = reinterpret_cast<uintptr_t>(b) % align == 0 && ldb % 4 == 0;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_kernel<T><<<grid, NT, 0, stream>>>(
      M, N, K, static_cast<const T*>(a), lda, static_cast<const T*>(b), ldb,
      static_cast<const T*>(c), ldc, static_cast<T*>(out), ldo, alpha, beta,
      vec_a, vec_b);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. c may be NULL (no beta term). Returns
// the cudaError_t of the launch (0 on success).
extern "C" int conflux_gemm(int dtype, int device, int M, int N, int K,
                            const void* a, int lda, const void* b, int ldb,
                            const void* c, int ldc, void* out, int ldo,
                            float alpha, float beta, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (M <= 0 || N <= 0) return cudaSuccess;
  if ((M + BM - 1) / BM > 65535) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(M, N, K, a, lda, b, ldb, c, ldc, out, ldo, alpha, beta, s);
  if (dtype == 1)
    return launch<uint16_t>(M, N, K, a, lda, b, ldb, c, ldc, out, ldo, alpha, beta, s);
  return cudaErrorInvalidValue;
}
