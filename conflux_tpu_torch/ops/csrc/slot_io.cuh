// Per-slot set-up shared by the batched factor kernels (batched_lu.cu,
// batched_chol.cu): one CTA copies its slot of the input into the output
// buffer, where the factorization then runs in place, and computes the
// slot's Freivalds probe row wA = w^T A off the untouched input.
//
// The probe row is a fixed FMA chain over the rows per column, whatever
// thread runs it, so its bits depend only on the slot's own input. The
// caller puts a block barrier after this before it reads the output.

#pragma once

#include <stddef.h>

namespace conflux {

template <typename T, int NT>
__device__ __forceinline__ void copy_slot_and_probe(int n, const T* __restrict__ A,
                                                    T* O, const T* __restrict__ w,
                                                    T* __restrict__ wa) {
  const int tid = threadIdx.x;
  const size_t nn = static_cast<size_t>(n) * n;
#pragma unroll 8
  for (size_t e = tid; e < nn; e += NT) O[e] = A[e];
  if (w != nullptr) {
    for (int c = tid; c < n; c += NT) {
      T s = T(0);
#pragma unroll 8
      for (int r = 0; r < n; ++r) s = fma(w[r], A[static_cast<size_t>(r) * n + c], s);
      wa[c] = s;
    }
  }
}

}  // namespace conflux
