// The TF32 library product: one cuBLAS call, not a kernel of this
// repository. It replaces no TPU kernel: the JAX package leaves a
// `jnp.matmul` at Precision DEFAULT or HIGH to XLA, which on a GPU of this
// class runs float32 products as one TensorFloat-32 tensor-core pass; this
// is the port's counterpart (`blas.tf32_gemm`). The compute type is the
// call's own (`CUBLAS_COMPUTE_32F_FAST_TF32`), so no process-wide math mode
// changes and an IEEE float32 product in another thread stays IEEE.
//
// Operands are row major. cuBLAS is column major, so it is asked for
// C^T = B^T A^T: a row-major (r x c) matrix with row pitch ld is the
// column-major (c x r) matrix with leading dimension ld, and A and B swap.
// Bound on the card: 495 TFLOP/s of dense TF32 (bytes for thin products).

#include <cublas_v2.h>
#include <cuComplex.h>
#include <cuda_runtime.h>

// C = alpha A B + beta C for `batch` row-major products: A (m x k, row
// pitch lda), B (k x n, ldb), C (m x n, ldc), each at its element stride
// between products (0: one matrix for every product). complex64 when
// `complex_` (alpha and beta real), else float32. Runs on `stream` with
// `handle`, torch's cuBLAS handle of the calling thread and the operands'
// card (its workspace from torch's allocator); returns the cuBLAS status
// (0 on success).
extern "C" int conflux_tf32_gemm(void* handle, int complex_, int batch,
                                 int m, int n, int k,
                                 const void* a, int lda, long long stride_a,
                                 const void* b, int ldb, long long stride_b,
                                 void* c, int ldc, long long stride_c,
                                 float alpha, float beta, void* stream) {
  auto h = static_cast<cublasHandle_t>(handle);
  cublasStatus_t st = cublasSetStream(h, static_cast<cudaStream_t>(stream));
  if (st != CUBLAS_STATUS_SUCCESS) return st;
  st = cublasSetPointerMode(h, CUBLAS_POINTER_MODE_HOST);
  if (st != CUBLAS_STATUS_SUCCESS) return st;
  const cudaDataType t = complex_ ? CUDA_C_32F : CUDA_R_32F;
  const cuComplex ca = make_cuComplex(alpha, 0.f), cb = make_cuComplex(beta, 0.f);
  const void* pa = complex_ ? static_cast<const void*>(&ca) : static_cast<const void*>(&alpha);
  const void* pb = complex_ ? static_cast<const void*>(&cb) : static_cast<const void*>(&beta);
  return cublasGemmStridedBatchedEx(h, CUBLAS_OP_N, CUBLAS_OP_N, n, m, k, pa,
                                    b, t, ldb, stride_b, a, t, lda, stride_a, pb,
                                    c, t, ldc, stride_c, batch,
                                    CUBLAS_COMPUTE_32F_FAST_TF32, CUBLAS_GEMM_DEFAULT);
}
