// Trailing-update GEMM: out = alpha * (a @ b) + beta * c, f32 accumulation.
//
// Replaces the TPU kernel `_gemm` / `_matmul_kernel` in
// conflux_tpu/ops/pallas_kernels.py (public `gemm`), which carries ~2/3 N^3
// of the LU factorization's flops (the trailing update of every superstep)
// and ~1/3 N^3 of the Cholesky factorization's.
//
// Bound on an H100: operations. The work is 2*M*N*K flops on
// M*K + K*N + 2*M*N elements, so at the factorization's shapes (K = v =
// 1024) it is ~250 flop per byte, far above the card's f32 ridge. The
// arithmetic must be IEEE f32 (the JAX package pins Precision.HIGHEST; TF32
// loses ~3 digits and the factor's residual with them), so the ceiling is
// the 67 TFLOP/s of the SIMT f32 pipes, not the tensor cores: one fmaf per
// product term, no TF32 and no split into TF32 parts.
//
// Two instances of one function, chosen by the operands' alignment alone:
//
// - gemm_tma_kernel, for operands whose base addresses and row pitches are
//   multiples of 16 bytes (every call of the factorizations). Persistent:
//   one CTA per SM walks 128x256 output tiles in groups of 8 tile rows, so
//   the CTAs in flight share B's column tiles in L2. Warp-specialised: one
//   producer thread issues TMA loads (cp.async.bulk.tensor) of A's 128x32
//   and B's 32x256 f32 tiles into a ring of 4 stages of 48 KB, each stage
//   with a "full" mbarrier (the TMA's byte count) and an "empty" one (the
//   consumer warps' arrivals), and runs ahead across tile boundaries, so
//   the next tile's loads overlap this tile's epilogue. After a tile's k
//   stages it loads the tile's C block through the same ring (three
//   48x256 boxes, a stage each), so the epilogue reads C from shared
//   memory, its latency hidden behind the tile's last k stages. Two
//   consumer warpgroups, given 232 registers each by setmaxnreg (the
//   producer's warpgroup drops to 40), hold 16x8 register micro-tiles and
//   spend no registers or issue slots on the copies. A is read along k (a
//   TMA tile is k-contiguous); TMA's 128-byte swizzle puts the 16-byte
//   chunk c of row r at chunk c ^ (r % 8), and a thread's rows are r = tm +
//   8 i, so the four rows a warp reads at once fall in distinct banks. B's
//   rows are read as the warp's 8 consecutive 16-byte chunks. Ragged M, N
//   and K are the TMA's zero fill. The epilogue writes out in 16-byte
//   vectors, alpha/beta folded into the store.
// - gemm_simt_kernel, for every other operand (strided views with odd
//   leading dimensions): the classic shared-memory SGEMM. A CTA of 256
//   threads owns a 128x128 output tile and walks K in 16-deep slabs; each
//   thread keeps an 8x8 register micro-tile; the next slab is fetched into
//   registers while the current one is multiplied.
//
// Both read operands through leading dimensions, so the factorizations pass
// views of their matrix (L10, A01) and update the trailing block in place
// (out may alias c element for element: each thread reads an element of c
// before it writes the same element of out). bf16 operands arrive as bf16
// (by TMA, in 64-deep tiles of the same byte shape) and are widened to f32
// on the way from shared memory; the result is rounded to bf16 once, at the
// store.

#include <cuda.h>  // CUtensorMap and its enums (types only: no libcuda link)
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_DEVICES = 64;
constexpr long long WAIT_CYCLES = 20000000000LL;  // ~10 s: trap, never hang

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

// Four consecutive elements at p (16 bytes of f32, 8 of bf16), widened.
__device__ __forceinline__ void ld4(const float* p, float v[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}
__device__ __forceinline__ void ld4(const uint16_t* p, float v[4]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(x.x << 16);
  v[1] = __uint_as_float(x.x & 0xffff0000u);
  v[2] = __uint_as_float(x.y << 16);
  v[3] = __uint_as_float(x.y & 0xffff0000u);
}
__device__ __forceinline__ void st4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st4(uint16_t* p, const float v[4]) {
  const uint32_t lo = from_f<uint16_t>(v[0]) | (static_cast<uint32_t>(from_f<uint16_t>(v[1])) << 16);
  const uint32_t hi = from_f<uint16_t>(v[2]) | (static_cast<uint32_t>(from_f<uint16_t>(v[3])) << 16);
  *reinterpret_cast<uint2*>(p) = make_uint2(lo, hi);
}

// The device's SM count, and the current device set to `device` (a call
// only where it differs).
int sm_count[MAX_DEVICES];

cudaError_t use_device(int device) {
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  int cur = -1;
  cudaError_t e = cudaGetDevice(&cur);
  if (e == cudaSuccess && cur != device) e = cudaSetDevice(device);
  if (e == cudaSuccess && sm_count[device] == 0)
    e = cudaDeviceGetAttribute(&sm_count[device], cudaDevAttrMultiProcessorCount, device);
  return e;
}

// --------------------------------------------------------------------------
// The TMA instance
// --------------------------------------------------------------------------

namespace tma {

constexpr int BM = 128, BN = 256;    // CTA tile
constexpr int ROW_BYTES = 128;       // one A tile row: BK elements
constexpr int A_BYTES = BM * ROW_BYTES;           // 16 KB
constexpr int B_BYTES = ROW_BYTES * BN;           // BK rows of BN elements: 32 KB
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int STAGES = 4;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;  // + alignment slack
constexpr int CONSUMERS = 256;       // two warpgroups of 16x8 micro-tiles
constexpr int THREADS = 128 + CONSUMERS;  // a producer warpgroup
// 384 threads start with 168 registers each; setmaxnreg moves them to the
// consumers (the SM's 64K: 128 x 40 + 256 x 232), whose 128 accumulators
// and operands spill in 168 (scripts/torch_gemm_variants.py, variant
// no_setmaxnreg)
constexpr bool SETMAXNREG = true;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int C_ROWS = 48, C_BOXES = 3;  // the C tile's boxes, a stage each
static_assert(C_ROWS * BN * 4 <= STAGE_BYTES && C_ROWS * C_BOXES >= BM && C_ROWS % 8 == 0,
              "a C box fits a stage; the boxes cover the tile's rows, 8 a thread's stride");
constexpr int GROUP_M = 8;           // tile rows a group of CTAs shares B over

template <typename T> __host__ __device__ constexpr int bk() {
  return ROW_BYTES / static_cast<int>(sizeof(T));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "{\n\t.reg .b64 state;\n\t"
      "mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n\t}" ::"r"(smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n\t.reg .b64 state;\n\t"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n\t}" ::"r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the phase of parity `parity` to complete.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > WAIT_CYCLES) __trap();
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int inner, int outer) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(inner), "r"(outer)
      : "memory");
}

// Tile t of the grouped order: GROUP_M tile rows at a time, down each
// column of the group before the next column.
__device__ __forceinline__ void tile_origin(int t, int tiles_m, int tiles_n, int* m0, int* n0) {
  const int per_group = GROUP_M * tiles_n;
  const int g = t / per_group, first = g * GROUP_M;
  const int rows = min(tiles_m - first, GROUP_M);
  const int r = t - g * per_group;
  *m0 = (first + r % rows) * BM;
  *n0 = (r / rows) * BN;
}

// One stage: acc[i][j] += A[tm + 8 i][k] * B[k][col j] over the stage's BK
// k in order. Row r's 16-byte chunk c sits at chunk c ^ (r % 8) of its 128
// bytes (TMA's 128-byte swizzle), and r % 8 == tm.
template <typename T>
__device__ __forceinline__ void mma_stage(const uint8_t* sA, const uint8_t* sB, int tm, int tn,
                                          float (&acc)[16][8]) {
  constexpr int VB = 4 * sizeof(T);  // bytes of 4 consecutive k
  constexpr int GROUPS = bk<T>() / 4;
  const uint8_t* arow = sA + tm * ROW_BYTES;
  const T* bcol = reinterpret_cast<const T*>(sB) + tn * 4;
#pragma unroll 1  // k groups of a stage
  for (int g = 0; g < GROUPS; ++g) {
    float b[4][8];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const T* brow = bcol + (g * 4 + kk) * BN;
      ld4(brow, &b[kk][0]);
      ld4(brow + 128, &b[kk][4]);
    }
    const int off = ((((g * VB) >> 4) ^ tm) << 4) | ((g * VB) & 15);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      float a[4];
      ld4(reinterpret_cast<const T*>(arow + i * 8 * ROW_BYTES + off), a);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[kk], b[kk][j], acc[i][j]);
    }
  }
}

// out = alpha * acc + beta * c over the thread's elements, c from the C
// tile's three 48-row boxes in the ring (rows of BN elements), or none.
template <typename T>
__device__ __forceinline__ void epilogue(const float (&acc)[16][8], int m0, int n0, int tm,
                                         int tn, int M, int N, const uint8_t* const* cbox,
                                         T* Out, int ldo, float alpha, float beta) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int r = m0 + tm + 8 * i;
    if (r >= M) break;
    // row tm + 8 i of the tile is row tm + 8 (i % 6) of box i / 6
    constexpr int PER_BOX = C_ROWS / 8;
    const T* crow = cbox == nullptr ? nullptr
        : reinterpret_cast<const T*>(cbox[i / PER_BOX]) + (tm + 8 * (i % PER_BOX)) * BN;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int cl = h * 128 + tn * 4, c0 = n0 + cl;
      if (c0 >= N) continue;
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = alpha * acc[i][h * 4 + q];
      if (crow != nullptr) {
        float c[4];
        ld4(crow + cl, c);
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] += beta * c[q];
      }
      if (c0 + 3 < N) {
        st4(Out + static_cast<size_t>(r) * ldo + c0, v);
      } else {
        for (int q = 0; q < 4 && c0 + q < N; ++q)
          Out[static_cast<size_t>(r) * ldo + c0 + q] = from_f<T>(v[q]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
gemm_tma_kernel(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_b,
                const __grid_constant__ CUtensorMap map_c, bool has_c, int M, int N, int K,
                T* Out, int ldo, float alpha, float beta) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  // the ring at a 1024-byte boundary (the swizzle's period), reached by
  // indexing smem_raw so the compiler keeps to shared-memory loads
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  const int tiles = tiles_m * tiles_n;
  const int nk = (K + bk<T>() - 1) / bk<T>();

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: one thread issues every copy
    if constexpr (SETMAXNREG)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS) : "memory");
    if (threadIdx.x == 0) {
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&map_a)) : "memory");
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&map_b)) : "memory");
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int m0, n0;
        tile_origin(t, tiles_m, tiles_n, &m0, &n0);
        for (int kt = 0; kt < nk + (has_c ? C_BOXES : 0); ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);
          uint8_t* dst = smem + stage * STAGE_BYTES;
          if (kt < nk) {
            mbar_expect_tx(&full[stage], STAGE_BYTES);
            tma_load(dst, &map_a, &full[stage], kt * bk<T>(), m0);
            tma_load(dst + A_BYTES, &map_b, &full[stage], n0, kt * bk<T>());
          } else {  // after the tile's k stages, its C tile in 48-row boxes
            mbar_expect_tx(&full[stage], C_ROWS * BN * sizeof(T));
            tma_load(dst, &map_c, &full[stage], n0, m0 + (kt - nk) * C_ROWS);
          }
          if (++stage == STAGES) { stage = 0; phase ^= 1; }
        }
      }
    }
  } else {
    // consumer warpgroups
    if constexpr (SETMAXNREG)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS) : "memory");
    const int ct = threadIdx.x - 128, w = ct >> 5, lane = ct & 31;
    const int tm = (w & 1) * 4 + (lane & 3);    // rows tm + 8 i, i < 16
    const int tn = (w >> 1) * 8 + (lane >> 2);  // columns 4 tn + q and 128 + 4 tn + q
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int m0, n0;
      tile_origin(t, tiles_m, tiles_n, &m0, &n0);
      float acc[16][8];
#pragma unroll
      for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(&full[stage], phase);
        const uint8_t* sA = smem + stage * STAGE_BYTES;
        mma_stage<T>(sA, sA + A_BYTES, tm, tn, acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[stage]);
        if (++stage == STAGES) { stage = 0; phase ^= 1; }
      }
      const uint8_t* cbox[C_BOXES];
      int cstage[C_BOXES];
      if (has_c) {
#pragma unroll
        for (int q = 0; q < C_BOXES; ++q) {
          mbar_wait(&full[stage], phase);
          cstage[q] = stage;
          cbox[q] = smem + stage * STAGE_BYTES;
          if (++stage == STAGES) { stage = 0; phase ^= 1; }
        }
      }
      epilogue<T>(acc, m0, n0, tm, tn, M, N, has_c ? cbox : nullptr, Out, ldo, alpha, beta);
      __syncwarp();
      if (has_c && lane == 0) {
#pragma unroll
        for (int q = 0; q < C_BOXES; ++q) mbar_arrive(&empty[cstage[q]]);
      }
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime's driver entry point
// (the library links no libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 2D row-major (rows, cols) operand with leading dimension ld, read in
// (box_rows, box_cols) boxes; elements outside it read as zero.
template <typename T>
bool encode(EncodeTiled fn, CUtensorMap* map, const void* base, int rows, int cols, int ld,
            int box_rows, int box_cols, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * sizeof(T)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estrides[2] = {1, 1};
  const CUtensorMapDataType dt =
      sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return fn(map, dt, 2, const_cast<void*>(base), dims, strides, box, estrides,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool attr_set[2][MAX_DEVICES];  // the shared-memory attribute, per dtype and device

template <typename T>
cudaError_t launch(int device, int M, int N, int K, const void* a, int lda, const void* b,
                   int ldb, const void* c, int ldc, void* out, int ldo, float alpha, float beta,
                   cudaStream_t stream) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  bool& set = attr_set[sizeof(T) == 4 ? 0 : 1][device];
  if (!set) {
    const cudaError_t e = cudaFuncSetAttribute(
        gemm_tma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e != cudaSuccess) return e;
    set = true;
  }
  // K == 0 loads nothing; the maps still need a nonzero extent. Without c
  // the C map describes out and is never read.
  CUtensorMap map_a, map_b, map_c;
  if (!encode<T>(fn, &map_a, a, M, K > 0 ? K : 1, lda, BM, bk<T>(), CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode<T>(fn, &map_b, b, K > 0 ? K : 1, N, ldb, bk<T>(), BN, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !encode<T>(fn, &map_c, c != nullptr ? c : out, M, N, c != nullptr ? ldc : ldo, C_ROWS, BN,
                 CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  const long long tiles = static_cast<long long>((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int grid = static_cast<int>(tiles < sm_count[device] ? tiles : sm_count[device]);
  gemm_tma_kernel<T><<<grid, THREADS, SMEM_BYTES, stream>>>(
      map_a, map_b, map_c, c != nullptr, M, N, K, static_cast<T*>(out), ldo, alpha, beta);
  return cudaGetLastError();
}

}  // namespace tma

// --------------------------------------------------------------------------
// The SIMT instance
// --------------------------------------------------------------------------

namespace simt {

constexpr int BM = 128, BN = 128, BK = 16, NT = 256;

// Four consecutive elements of row r, columns c0..c0+3, of an (R, C)
// row-major matrix with leading dimension ld, widened to f32; elements
// outside the matrix read as 0.
template <typename T>
__device__ __forceinline__ void load4(const T* __restrict__ p, int ld, int R,
                                      int C, int r, int c0, bool vec,
                                      float v[4]) {
  if (vec && r < R && c0 + 3 < C) {
    ld4(p + static_cast<size_t>(r) * ld + c0, v);
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
gemm_simt_kernel(int M, int N, int K, const T* __restrict__ A, int lda,
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
  if ((M + BM - 1) / BM > 65535) return cudaErrorInvalidValue;
  const uintptr_t align = 4 * sizeof(T);
  const bool vec_a = reinterpret_cast<uintptr_t>(a) % align == 0 && lda % 4 == 0;
  const bool vec_b = reinterpret_cast<uintptr_t>(b) % align == 0 && ldb % 4 == 0;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_simt_kernel<T><<<grid, NT, 0, stream>>>(
      M, N, K, static_cast<const T*>(a), lda, static_cast<const T*>(b), ldb,
      static_cast<const T*>(c), ldc, static_cast<T*>(out), ldo, alpha, beta,
      vec_a, vec_b);
  return cudaGetLastError();
}

}  // namespace simt

bool tma_aligned(const void* p, int ld, int itemsize) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (static_cast<long long>(ld) * itemsize) % 16 == 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. c may be NULL (no beta term). Returns
// the cudaError_t of the launch (0 on success). The SIMT instance: any
// leading dimensions and alignment.
extern "C" int conflux_gemm(int dtype, int device, int M, int N, int K,
                            const void* a, int lda, const void* b, int ldb,
                            const void* c, int ldc, void* out, int ldo,
                            float alpha, float beta, void* stream) {
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return e;
  if (M <= 0 || N <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return simt::launch<float>(M, N, K, a, lda, b, ldb, c, ldc, out, ldo, alpha, beta, s);
  if (dtype == 1)
    return simt::launch<uint16_t>(M, N, K, a, lda, b, ldb, c, ldc, out, ldo, alpha, beta, s);
  return cudaErrorInvalidValue;
}

// The same function on the TMA instance: every operand's base address and
// row pitch (ld * itemsize) must be multiples of 16 bytes, else
// cudaErrorInvalidValue and no launch.
extern "C" int conflux_gemm_tma(int dtype, int device, int M, int N, int K,
                                const void* a, int lda, const void* b, int ldb,
                                const void* c, int ldc, void* out, int ldo,
                                float alpha, float beta, void* stream) {
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  const int itemsize = dtype == 0 ? 4 : 2;
  if (!tma_aligned(a, lda, itemsize) || !tma_aligned(b, ldb, itemsize) ||
      !tma_aligned(out, ldo, itemsize) || (c != nullptr && !tma_aligned(c, ldc, itemsize)))
    return cudaErrorInvalidValue;
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return e;
  if (M <= 0 || N <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return tma::launch<float>(device, M, N, K, a, lda, b, ldb, c, ldc, out, ldo, alpha, beta, s);
  return tma::launch<uint16_t>(device, M, N, K, a, lda, b, ldb, c, ldc, out, ldo, alpha, beta,
                               s);
}
