// Masked partial-pivot elimination of one (m, 128) column block, rows never
// moving.
//
// Replaces the TPU kernel `_lu_block` / `_lu_block_kernel` in
// conflux_tpu/ops/pallas_kernels.py (public `lu_block`): the panel kernel
// behind blas.panel_lu_pallas and the pivot tournament. For each column j:
// the pivot is the max |a| over live rows (dead rows score -1, so a live
// zero beats them; ties go to the lowest row); it is recorded in piv[j];
// every live non-pivot row gets its multiplier a[r, j] / a[p, j] in column
// j and a rank-1 update of the columns after j; the pivot row dies. The
// max is `jnp.max`'s: a NaN score beats every number, and a NaN winner
// ties no row, so p = m is recorded, the pivot row is read clamped to row
// m - 1 and no live row dies (every live row is updated).
//
// Bound on an H100: latency. A (4096, 128) block moves ~4 MB and does ~67
// Mflop, ~1.3 us of the card's bytes and ~1 us of its f32 rate, but its 128
// columns are a chain of argmax reductions over all m rows, each of which
// must finish before the next column can start. The TPU kept the whole 2
// MiB block in VMEM; one H100 CTA has 227 KB of shared memory.
//
// Design: a cooperative launch of ceil(m / 256) CTAs per block, each
// holding 256 rows of the block in shared memory for all 128 columns (135
// KB, rows padded to 132 floats so each thread sweeps its own row in
// 16-byte vectors without bank conflicts). A launch may eliminate a batch
// of independent blocks (the chunks of one tournament round): blockIdx.y
// is the slot, and each slot has its own words and candidate rows, so a
// slot's arithmetic and bits are those of a launch on that block alone.
// The batch runs in waves of whole slots that are resident together (one
// CTA per SM at this shared-memory size), one cooperative launch a wave.
// Per
// column, each CTA publishes its local argmax as one 64-bit word (value,
// row + 1; nonzero, so the word is its own ready flag) beside its
// candidate's current row. Every CTA waits for all words of the column,
// reduces them in one fixed order (so all CTAs agree on the pivot) and
// reads the winning row from L2 (after a NaN election, which is rare, the
// last CTA publishes row m - 1 as it holds it and raises the column's
// flag, a second exchange only for that column). Scores are compared as
// integers, in which a NaN is above +inf: the same compare per reduction
// step as a float max. Scratch is indexed by column, so no slot
// is reused within a launch and the word wait is the only grid-wide
// synchronisation. The exchange is pipelined one column ahead: after a
// pivot arrives, each row first eliminates column j+1 only, the CTA
// publishes column j+1's candidate (whose row it finishes on the fly), and
// the rank-1 update of the remaining columns runs while that exchange is
// in flight. The multiplier is an IEEE division and the update one fused
// multiply-add per element: the arithmetic of the JAX kernel as XLA
// compiles it, which the plain version reproduces exactly. A wait that
// outlives ~10 s of clock traps instead of hanging the card.

#include <cuda_runtime.h>
#include <math.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int W = 128;        // column-block width (one TPU lane tile)
constexpr int ROWS = 256;     // rows per CTA == threads per CTA
constexpr int LDS = W + 4;    // padded shared-memory row stride (16-byte rows)
constexpr long long WAIT_CYCLES = 20000000000LL;
constexpr size_t SMEM_BYTES = (static_cast<size_t>(ROWS) * LDS + W) * sizeof(float);

// A live row's score is the bits of |a| as an integer: they order as the
// floats do, with a (positive) NaN above +inf, as jnp.max ranks it. A dead
// row scores -1 and a thread without a row INT_MIN.
constexpr int INF_KEY = 0x7f800000;  // the score of |a| = +inf; above it: NaN
constexpr int DEAD_KEY = -1;

__device__ __forceinline__ bool better(int v, int r, int bv, int br) {
  return v > bv || (v == bv && r < br);
}

__device__ __forceinline__ unsigned long long pack(int key, int row) {
  return (static_cast<unsigned long long>(static_cast<unsigned int>(key)) << 32) |
         static_cast<unsigned int>(row + 1);
}

struct Block {
  float* s;      // ROWS x LDS rows of this CTA
  float* prow;   // the current pivot row
  int* wval;     // per-warp argmax partials (score keys)
  int* wrow;
  int* s_row;    // CTA-wide broadcast slots
  int* s_cta;
};

// Local argmax of column j over this CTA's rows; returns the winner's
// global row (the same value in every thread) and its score's key in *val.
__device__ int local_argmax(const Block& B, int j, int r0, bool mine,
                            bool live, int* val_out) {
  const int t = threadIdx.x;
  int val = mine ? (live ? __float_as_int(fabsf(B.s[t * LDS + j])) : DEAD_KEY) : INT_MIN;
  int row = mine ? r0 + t : INT_MAX;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int ov = __shfl_down_sync(0xffffffffu, val, off);
    const int orow = __shfl_down_sync(0xffffffffu, row, off);
    if (better(ov, orow, val, row)) { val = ov; row = orow; }
  }
  if ((t & 31) == 0) { B.wval[t >> 5] = val; B.wrow[t >> 5] = row; }
  __syncthreads();
  if (t == 0) {
    for (int w = 1; w < ROWS / 32; ++w)
      if (better(B.wval[w], B.wrow[w], val, row)) { val = B.wval[w]; row = B.wrow[w]; }
    B.wval[0] = val;
    *B.s_row = row;
  }
  __syncthreads();
  *val_out = B.wval[0];
  return *B.s_row;
}

__global__ void __launch_bounds__(ROWS, 1)
lu_block_kernel(int m, const float* __restrict__ a, int lda, long long sa,
                const int* __restrict__ alive_in, float* __restrict__ out,
                int* __restrict__ alive_out, int* __restrict__ piv,
                unsigned long long* words, float* cand_rows) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int wval[ROWS / 32];
  __shared__ int wrow[ROWS / 32];
  __shared__ int s_row, s_cta;
  const Block B{smem, smem + ROWS * LDS, wval, wrow, &s_row, &s_cta};

  const int G = gridDim.x, cta = blockIdx.x, t = threadIdx.x;
  // this CTA's slot of the batch: its block, mask, outputs and scratch
  const size_t slot = blockIdx.y;
  a += slot * sa;
  alive_in += slot * m;
  out += slot * m * W;
  alive_out += slot * m;
  piv += slot * W;
  words += slot * (W * G + W);  // per column: G election words, then a NaN flag
  volatile unsigned long long* nan_flags = words + W * G;
  cand_rows += slot * W * G * W;
  const int r0 = cta * ROWS;
  const int nrows = min(ROWS, m - r0);
  const bool last = cta == G - 1;  // holds row m - 1
  for (int idx = t; idx < nrows * W; idx += ROWS) {
    const int r = idx / W, c = idx % W;
    B.s[r * LDS + c] = a[static_cast<size_t>(r0 + r) * lda + c];
  }
  const bool mine = t < nrows;
  bool live = mine && alive_in[r0 + t] != 0;
  float* rw = B.s + t * LDS;
  __syncthreads();

  // column 0's candidate: the rows are as loaded
  {
    int val;
    const int lw = local_argmax(B, 0, r0, mine, live, &val) - r0;
    if (t < W) cand_rows[static_cast<size_t>(cta) * W + t] = B.s[lw * LDS + t];
    __syncthreads();
    if (t == 0) {
      __threadfence();
      reinterpret_cast<volatile unsigned long long*>(words)[cta] = pack(val, lw + r0);
    }
  }

  for (int j = 0; j < W; ++j) {
    // 1. all candidates of column j: reduce in one fixed order
    if (t < 32) {
      const long long t0 = clock64();
      int bv = INT_MIN;
      int br = INT_MAX, bc = 0;
      for (int g = t; g < G; g += 32) {
        volatile unsigned long long* wp = words + static_cast<size_t>(j) * G + g;
        unsigned long long wd;
        while ((wd = *wp) == 0ull)
          if (clock64() - t0 > WAIT_CYCLES) __trap();
        const int v = static_cast<int>(static_cast<unsigned int>(wd >> 32));
        const int r = static_cast<int>(wd & 0xffffffffull) - 1;
        if (better(v, r, bv, br)) { bv = v; br = r; bc = g; }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const int ov = __shfl_down_sync(0xffffffffu, bv, off);
        const int orow = __shfl_down_sync(0xffffffffu, br, off);
        const int oc = __shfl_down_sync(0xffffffffu, bc, off);
        if (better(ov, orow, bv, br)) { bv = ov; br = orow; bc = oc; }
      }
      if (t == 0) {
        __threadfence();  // the winner's row was published before its word
        // a NaN winner ties no row: p = m, its pivot row row m - 1
        s_row = bv > INF_KEY ? m : br;
        s_cta = bc;
        if (cta == 0) piv[j] = s_row;
      }
    }
    __syncthreads();
    const int p = s_row;
    if (p == m) {
      // row m - 1 as it stands, through the last CTA's candidate slot (no
      // CTA reads a candidate of this column)
      float* slot_row = cand_rows + (static_cast<size_t>(j) * G + G - 1) * W;
      if (last) {
        if (t < W) slot_row[t] = B.s[(m - 1 - r0) * LDS + t];
        __syncthreads();
        if (t == 0) {
          __threadfence();
          nan_flags[j] = 1ull;
        }
      }
      if (t == 0) {
        const long long t0 = clock64();
        while (nan_flags[j] == 0ull)
          if (clock64() - t0 > WAIT_CYCLES) __trap();
        __threadfence();
      }
      __syncthreads();
      if (t < W) B.prow[t] = __ldcg(slot_row + t);
    } else if (t < W) {
      B.prow[t] = __ldcg(cand_rows + (static_cast<size_t>(j) * G + s_cta) * W + t);
    }
    __syncthreads();

    // 2. multipliers, and column j+1 only
    const bool upd = live && r0 + t != p;
    float l = 0.f;
    if (upd) {
      l = __fdiv_rn(rw[j], B.prow[j]);
      rw[j] = l;
      if (j + 1 < W) rw[j + 1] = __fmaf_rn(-l, B.prow[j + 1], rw[j + 1]);
    }
    if (r0 + t == p) live = false;
    if (j + 1 == W) break;

    // 3. publish column j+1's candidate; its row is finished on the fly
    //    (the same FMAs its owner applies in step 4)
    int val;
    const int lw = local_argmax(B, j + 1, r0, mine, live, &val) - r0;
    if (t < W) {
      // a live winner (score >= 0; dead rows score -1) was eliminated in
      // step 2 and holds its multiplier in column j
      const float* wr = B.s + lw * LDS;
      float x = wr[t];
      if (t > j + 1 && val >= 0) x = __fmaf_rn(-wr[j], B.prow[t], x);
      cand_rows[(static_cast<size_t>(j + 1) * G + cta) * W + t] = x;
    }
    __syncthreads();
    if (t == 0) {
      __threadfence();
      reinterpret_cast<volatile unsigned long long*>(words)[static_cast<size_t>(j + 1) * G + cta] =
          pack(val, lw + r0);
    }

    // 4. rank-1 update of the remaining columns, overlapping the exchange
    if (upd) {
      int c = j + 2;
      for (; c < W && (c & 3); ++c) rw[c] = __fmaf_rn(-l, B.prow[c], rw[c]);
      for (; c < W; c += 4) {
        float4 x = *reinterpret_cast<float4*>(rw + c);
        const float4 q = *reinterpret_cast<const float4*>(B.prow + c);
        x.x = __fmaf_rn(-l, q.x, x.x);
        x.y = __fmaf_rn(-l, q.y, x.y);
        x.z = __fmaf_rn(-l, q.z, x.z);
        x.w = __fmaf_rn(-l, q.w, x.w);
        *reinterpret_cast<float4*>(rw + c) = x;
      }
    }
  }

  __syncthreads();
  for (int idx = t; idx < nrows * W; idx += ROWS) {
    const int r = idx / W, c = idx % W;
    out[static_cast<size_t>(r0 + r) * W + c] = B.s[r * LDS + c];
  }
  if (mine) alive_out[r0 + t] = live ? 1 : 0;
}

}  // namespace

// CTAs (and so scratch slots per column) a launch over m rows uses per slot.
extern "C" int conflux_lu_block_ctas(int m) { return (m + ROWS - 1) / ROWS; }

namespace {

// Per device: the kernel's shared-memory attribute set, and the CTAs the
// card holds at once (co-resident, as a cooperative launch needs). Set on
// a device's first launch, read after.
constexpr int MAX_DEVICES = 64;
int resident_ctas[MAX_DEVICES];  // 0 until the device is configured

cudaError_t configure(int device) {
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  int cur = -1;
  cudaError_t e = cudaGetDevice(&cur);
  if (e == cudaSuccess && cur != device) e = cudaSetDevice(device);
  if (e != cudaSuccess || resident_ctas[device] > 0) return e;
  e = cudaFuncSetAttribute(lu_block_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(SMEM_BYTES));
  if (e != cudaSuccess) return e;
  int per_sm = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lu_block_kernel,
                                                    ROWS, SMEM_BYTES);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  resident_ctas[device] = per_sm * sms;
  return cudaSuccess;
}

}  // namespace

// Whole slots of m rows that one cooperative launch holds on `device`
// (0 if one slot does not fit); negative: a cudaError_t.
extern "C" int conflux_lu_block_wave_slots(int device, int m) {
  if (m <= 0) return -static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = configure(device);
  if (e != cudaSuccess) return -static_cast<int>(e);
  return resident_ctas[device] / conflux_lu_block_ctas(m);
}

// One cooperative launch over `slots` blocks of (m, w) f32: slot s's block
// starts at a + s * sa (leading dimension lda); alive_in, alive_out: (slots,
// m) int32; out: (slots, m, w) f32 contiguous; piv: (slots, w) int32.
// Scratch per slot, G = ctas(m): words (w * G + w) uint64 zeroed, cand_rows
// (w * G * w) f32, slot-major. slots must not exceed wave_slots(m).
// Returns the cudaError_t of the launch.
extern "C" int conflux_lu_block(int device, int slots, int m, int w,
                                const float* a, int lda, long long sa,
                                const int* alive_in, float* out,
                                int* alive_out, int* piv,
                                unsigned long long* words, float* cand_rows,
                                void* stream) {
  if (w != W || m <= 0 || slots <= 0) return cudaErrorInvalidValue;
  cudaError_t e = configure(device);
  if (e != cudaSuccess) return e;
  void* args[] = {&m, &a, &lda, &sa, &alive_in, &out, &alive_out, &piv,
                  &words, &cand_rows};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(lu_block_kernel),
                                  dim3(conflux_lu_block_ctas(m), slots),
                                  dim3(ROWS), args, SMEM_BYTES,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}
