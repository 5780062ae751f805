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
// must finish before the next column can start: the time is the chain's,
// the exchange of each column's pivot between the CTAs that hold the rows
// and the on-SM work between two exchanges. The TPU kept the whole 2 MiB
// block in VMEM; one H100 CTA has 227 KB of shared memory.
//
// Design: G = ceil(m / 256) CTAs per block, each holding 256 rows of the
// block in shared memory for all 128 columns (rows padded to 132 floats so
// each thread sweeps its own row in 16-byte vectors without bank
// conflicts), a thread a row. A launch may eliminate a batch of
// independent blocks (the chunks of one tournament round): blockIdx.y is
// the slot, and each slot has its own candidates and scratch, so a slot's
// bits are those of a launch on that block alone. Per column, each CTA
// elects its local argmax (two warp reductions, `redux.sync`, and one
// barrier), finishes the winner's row on the fly and sends it with its
// (score key, row); every CTA reduces all candidates in one fixed order,
// so all agree on the pivot. Two routes, which the wrapper picks from G,
// the batch and the occupancy API (hopper_kernels.plan_lu_block):
//   - the cluster route (G <= 16): a slot is one thread-block cluster of cs
//     >= G CTAs (above 8, a non-portable size; CTAs past G hold no rows,
//     score INT_MIN and never win). Warp 0 of each CTA pushes its candidate
//     into every CTA's shared memory (`st.async`, 16 bytes a lane), each
//     store counted on the receiver's transaction barrier (`mbarrier`) of
//     the column's parity. Every warp of a CTA waits on its own barrier,
//     then elects from local shared memory and reads the pivot row there:
//     no cluster barrier, fence, global word or spin on the column's path.
//     Two buffers suffice: a CTA sends column j+2 only after every CTA's
//     candidate of column j+1 has reached it, which each CTA sends after its
//     last read of column j. Slots are independent: one launch takes any
//     batch, in hardware waves of the clusters the card holds at once (7 of
//     16 CTAs on an H100);
//   - the grid route (taller blocks, or a batch that fits in fewer waves
//     this way): each CTA writes its candidate row to L2, then, after a
//     fence, one 64-bit word (value, row + 1; nonzero, so the word is its
//     own ready flag); warp 0 of every CTA waits for the G words of the
//     column and the CTA reads the winning row from L2. The CTAs of a slot
//     wait on one another, so a batch runs in waves of whole slots resident
//     together, one cooperative launch a wave. (A two-level exchange,
//     clusters inside and L2 between them, measured slower than this one at
//     G = 32: it adds a cluster step to a chain that still waits on L2.)
// After a NaN election (rare) the CTA that holds row m - 1 finishes it as
// it stands and a second exchange brings it to all: a cluster barrier and
// a read of that CTA's shared memory, or a flag word in L2. Scores are
// compared as integers, in which a NaN is above +inf: the same order as a
// float max, and total, so the route changes which CTA compares which keys
// but never the winner.
//
// The updates are held back KB columns (the order K4 uses): a row takes its
// multiplier at column j and brings column j+1 alone up to date (the next
// election needs it), and every KB columns applies the block of KB pivots
// to the rest of its row in one pass, each element loaded and stored once
// (one pass a column read and wrote the whole block in shared memory, whose
// bandwidth then set the time). A candidate row, and row m - 1 after a NaN
// election, is finished on the fly with the pivots its owner still holds
// back. Each element still takes one fused multiply-add a pivot, in column
// order, and each multiplier is an IEEE division: the arithmetic of the JAX
// kernel as XLA compiles it, which the plain version reproduces exactly,
// whatever KB and the route. Between two local elections the warps of a
// CTA run unsynchronised on the cluster route; what they share is
// double-buffered by column parity (the warp partials) or fenced by the
// barriers around the held-back pass (the group's pivot rows, the rows
// warp 0 reads to send). A wait on L2 that outlives ~10 s of clock traps
// instead of hanging the card.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

#include "cluster_launch.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int W = 128;        // column-block width (one TPU lane tile)
constexpr int ROWS = 256;     // rows per CTA == threads per CTA
constexpr int NW = ROWS / 32;
constexpr int LDS = W + 4;    // padded shared-memory row stride (16-byte rows)
constexpr int KB = 4;         // columns whose updates are held back together
constexpr int MAX_CLUSTER = 16;
constexpr unsigned FULL = 0xffffffffu;
constexpr long long WAIT_CYCLES = 20000000000LL;
// the rows, the group's KB pivot rows, a row for a NaN election, and the
// cluster's candidate rows of the two column parities
constexpr size_t SMEM_BYTES =
    (static_cast<size_t>(ROWS) * LDS + KB * W + W + 2 * MAX_CLUSTER * W) * sizeof(float);
// the bytes one CTA's candidate of a column brings to each peer
constexpr unsigned CAND_BYTES = W * sizeof(float) + sizeof(int2);

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

// the warp's best (key, then the lowest row), in every lane
__device__ __forceinline__ void warp_argmax(int& key, int& row) {
  const int k = __reduce_max_sync(FULL, key);
  row = __reduce_min_sync(FULL, key == k ? row : INT_MAX);
  key = k;
}

__device__ __forceinline__ void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the same shared-memory offset in CTA `rank` of the cluster
__device__ __forceinline__ uint32_t peer(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// 16 bytes into a peer's shared memory, counted on its barrier `bar`
__device__ __forceinline__ void push(uint32_t addr, float4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];"
      :: "r"(addr), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar) : "memory");
}

__device__ __forceinline__ void push(uint32_t addr, int2 v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.s32 [%0], {%1, %2}, [%3];"
               :: "r"(addr), "r"(v.x), "r"(v.y), "r"(bar) : "memory");
}

// one arrival on the barrier, expecting `bytes` more of its current phase
__device__ __forceinline__ void expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// until the barrier's phase of this parity has completed
__device__ __forceinline__ void await(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

struct Block {
  float* s;      // ROWS x LDS rows of this CTA
  float* gp;     // KB x W: the pivot rows of the current group, finished
  float* nanrow; // W: row m - 1 after a NaN election
  float* recv;   // 2 x MAX_CLUSTER x W: the cluster's candidate rows by parity
  int* wval;     // 2 x NW per-warp argmax partials (score keys) by column
  int* wrow;     // parity: a warp may start the next column's reduction
                 // before a slower one has read this column's
};

// Local argmax of column j over this CTA's rows: the winner's global row
// (INT_MAX without rows) and, in *key_out, its score's key; the same in
// every thread.
__device__ int local_argmax(const Block& B, int j, int r0, bool mine, bool live,
                            int* key_out) {
  const int t = threadIdx.x, lane = t & 31;
  int* wval = B.wval + (j & 1) * NW;
  int* wrow = B.wrow + (j & 1) * NW;
  int key = mine ? (live ? __float_as_int(fabsf(B.s[t * LDS + j])) : DEAD_KEY) : INT_MIN;
  int row = mine ? r0 + t : INT_MAX;
  warp_argmax(key, row);
  if (lane == 0) { wval[t >> 5] = key; wrow[t >> 5] = row; }
  __syncthreads();
  key = lane < NW ? wval[lane] : INT_MIN;
  row = lane < NW ? wrow[lane] : INT_MAX;
  warp_argmax(key, row);
  *key_out = key;
  return row;
}

// GRID: the grid route; else the cluster route.
template <bool GRID>
__global__ void __launch_bounds__(ROWS, 1)
lu_block_kernel(int m, const float* __restrict__ a, int lda, long long sa,
                const int* __restrict__ alive_in, float* __restrict__ out,
                int* __restrict__ alive_out, int* __restrict__ piv,
                unsigned long long* words, float* cand_rows) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int wval[2 * NW];
  __shared__ int wrow[2 * NW];
  __shared__ int s_row, s_src, s_n, s_c;
  __shared__ int s_piv[W];  // stored at the end, off the column chain
  __shared__ int2 rkey[2][MAX_CLUSTER];      // the cluster's candidate keys by parity
  __shared__ __align__(8) uint64_t bar[2];   // their arrival, by parity
  float* const gp = smem + ROWS * LDS;
  const Block B{smem, gp, gp + KB * W, gp + (KB + 1) * W, wval, wrow};

  const int G = (m + ROWS - 1) / ROWS;  // CTAs that hold rows
  const int cta = blockIdx.x, t = threadIdx.x, lane = t & 31;
  // the cluster route's size (the CTA's rank is cta: one cluster a slot)
  const int ncs = GRID ? 1 : static_cast<int>(cg::this_cluster().num_blocks());
  // this CTA's slot of the batch: its block, mask, outputs and scratch
  const size_t slot = blockIdx.y;
  a += slot * sa;
  alive_in += slot * m;
  out += slot * m * W;
  alive_out += slot * m;
  piv += slot * W;
  volatile unsigned long long* nan_flags = nullptr;
  if constexpr (GRID) {
    words += slot * (W * G + W);  // per column: G election words, then a NaN flag
    nan_flags = words + W * G;
    cand_rows += slot * W * G * W;
  }
  const int r0 = cta * ROWS;
  const int nrows = max(0, min(ROWS, m - r0));
  const bool last = cta == G - 1;  // holds row m - 1
  for (int idx = t; idx < nrows * W; idx += ROWS) {
    const int r = idx / W, c = idx % W;
    B.s[r * LDS + c] = a[static_cast<size_t>(r0 + r) * lda + c];
  }
  const bool mine = t < nrows;
  bool live = mine && alive_in[r0 + t] != 0;
  float* rw = B.s + t * LDS;
  // this row's multipliers of the group's pivots, the first nupd of which
  // it still owes the columns after cdone (those up to cdone are current)
  float lg[KB];
  int nupd = 0, cdone = 0;
  if constexpr (!GRID) {
    if (t == 0) {
      for (int b = 0; b < 2; ++b) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(smem_addr(&bar[b])) : "memory");
        expect(&bar[b], ncs * CAND_BYTES);  // columns 0 and 1
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    cluster_sync_all();  // every barrier armed before any candidate arrives
  } else {
    __syncthreads();
  }

  // column c of local row lr, finished with the first n pivots of the
  // group at j0 if c is after c0 (the row's multipliers of those pivots
  // are in its columns j0...)
  auto finish = [&](int lr, int j0, int n, int c0, int c) -> float {
    const float* wr = B.s + lr * LDS;
    float x = wr[c];
    if (c > c0) {
#pragma unroll
      for (int q = 0; q < KB; ++q)
        if (q < n) x = __fmaf_rn(-wr[j0 + q], B.gp[q * W + c], x);
    }
    return x;
  };
  // lane l of warp 0: columns 4l..4l+3 of it
  auto finish4 = [&](int lr, int j0, int n, int c0) -> float4 {
    return make_float4(finish(lr, j0, n, c0, 4 * lane), finish(lr, j0, n, c0, 4 * lane + 1),
                       finish(lr, j0, n, c0, 4 * lane + 2), finish(lr, j0, n, c0, 4 * lane + 3));
  };

  // column c's candidate: this CTA's best row, finished with the n pivots
  // of the group at j0 that a live row still owes (a dead winner means no
  // live row is left to take its values), and its key, to every CTA that
  // elects column c
  auto publish = [&](int c, int j0, int n) {
    int key;
    const int lrow = local_argmax(B, c, r0, mine, live, &key);
    if constexpr (GRID) {
      if (t < W) {
        cand_rows[(static_cast<size_t>(c) * G + cta) * W + t] =
            finish(lrow - r0, j0, key >= 0 ? n : 0, c, t);
      }
    } else if (t < 32) {
      const float4 x = nrows > 0 ? finish4(lrow - r0, j0, key >= 0 ? n : 0, c)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
      const uint32_t b = smem_addr(&bar[c & 1]);
      const uint32_t row = smem_addr(B.recv + ((c & 1) * MAX_CLUSTER + cta) * W) + 16 * lane;
      const uint32_t k = smem_addr(&rkey[c & 1][cta]);
      for (int q = 0; q < ncs; ++q) {
        push(peer(row, q), x, peer(b, q));
        if (lane == 0) push(peer(k, q), make_int2(key, lrow), peer(b, q));
      }
    }
    if constexpr (GRID) {
      __syncthreads();
      if (t == 0) {
        __threadfence();  // the candidate row before its word
        reinterpret_cast<volatile unsigned long long*>(words)[static_cast<size_t>(c) * G + cta] =
            pack(key, lrow);
      }
    }
  };

  publish(0, 0, 0);
  for (int j0 = 0; j0 < W; j0 += KB) {
#pragma unroll
    for (int k = 0; k < KB; ++k) {
      const int j = j0 + k;
      // 1. every candidate of column j: reduce in one fixed order
      int p, src;
      if constexpr (GRID) {
        if (t < 32) {
          const long long t0 = clock64();
          int key = INT_MIN, row = INT_MAX;
          for (int g = t; g < G; g += 32) {
            volatile unsigned long long* wp = words + static_cast<size_t>(j) * G + g;
            unsigned long long wd;
            while ((wd = *wp) == 0ull)
              if (clock64() - t0 > WAIT_CYCLES) __trap();
            const int v = static_cast<int>(static_cast<unsigned int>(wd >> 32));
            const int r = static_cast<int>(wd & 0xffffffffull) - 1;
            if (better(v, r, key, row)) { key = v; row = r; }
          }
          warp_argmax(key, row);
          if (t == 0) {
            __threadfence();  // the winner's row was published before its word
            // a NaN winner ties no row: p = m, its pivot row row m - 1
            s_row = key > INF_KEY ? m : row;
            s_src = row / ROWS;
            s_piv[j] = s_row;
          }
        }
        __syncthreads();
        p = s_row;
        src = s_src;
      } else {
        // every warp elects from the keys that arrived, the same winner
        await(&bar[j & 1], (j >> 1) & 1);
        int key = INT_MIN, row = INT_MAX;
        if (lane < ncs) {
          const int2 w = rkey[j & 1][lane];
          key = w.x;
          row = w.y;
        }
        warp_argmax(key, row);
        p = key > INF_KEY ? m : row;
        src = row / ROWS;
        if (t == 0) {
          s_piv[j] = p;
          // column j + 2's candidates land in these buffers: every CTA
          // sends them after this CTA's candidate of column j + 1, which
          // follows every read of column j here
          if (j + 2 < W) expect(&bar[j & 1], ncs * CAND_BYTES);
        }
      }
      const float* pj = GRID ? B.gp + k * W : B.recv + ((j & 1) * MAX_CLUSTER + src) * W;
      if (p == m) {
        // row m - 1 as it stands, finished by the last CTA
        if (last) {
          if (t == m - 1 - r0) { s_n = nupd; s_c = cdone; }
          __syncthreads();
          if (t < W) {
            const float x = finish(m - 1 - r0, j0, s_n, s_c, t);
            if constexpr (GRID) cand_rows[(static_cast<size_t>(j) * G + cta) * W + t] = x;
            else B.nanrow[t] = x;
          }
        }
        if constexpr (GRID) {
          if (last) {
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
          src = G - 1;
        } else {
          // from the last CTA's shared memory; it writes that row again
          // only after every CTA's candidate of a later column arrived
          cluster_sync_all();
          if (!last && t < 32) {
            reinterpret_cast<float4*>(B.nanrow)[lane] = reinterpret_cast<const float4*>(
                cg::this_cluster().map_shared_rank(B.nanrow, G - 1))[lane];
          }
          __syncthreads();
          pj = B.nanrow;
        }
      }
      // the pivot row: its copy for the group's later columns (thread t
      // writes column t; others read it after a barrier)
      if constexpr (GRID) {
        if (t < W) B.gp[k * W + t] = __ldcg(cand_rows + (static_cast<size_t>(j) * G + src) * W + t);
        __syncthreads();
      } else {
        if (t < W) B.gp[k * W + t] = pj[t];
      }

      // 2. the multiplier, and column j+1 brought up to date
      if (live && r0 + t != p) {
        const float l = __fdiv_rn(rw[j], pj[j]);
        rw[j] = l;
        lg[k] = l;
        nupd = k + 1;
        if (j + 1 < W) {
          float x = rw[j + 1];
#pragma unroll
          for (int q = 0; q < k; ++q) x = __fmaf_rn(-lg[q], B.gp[q * W + j + 1], x);
          rw[j + 1] = __fmaf_rn(-l, pj[j + 1], x);
          cdone = j + 1;
        }
      }
      if (r0 + t == p) live = false;

      // 3. publish column j+1's candidate
      if (j + 1 < W) publish(j + 1, j0, k + 1);
    }

    // 4. the group's pivots on the rest of each row that owes them (every
    //    pivot row that died in the group included), while the exchange of
    //    the next column is in flight; the barriers keep it after warp 0
    //    has read the candidate row it sends, and before the next group's
    //    pivot rows replace these
    __syncthreads();
    if (nupd > 0) {
      int c = cdone + 1;
      for (; c < W && (c & 3); ++c) {
        float x = rw[c];
#pragma unroll
        for (int q = 0; q < KB; ++q)
          if (q < nupd) x = __fmaf_rn(-lg[q], B.gp[q * W + c], x);
        rw[c] = x;
      }
#pragma unroll 4
      for (; c < W; c += 4) {
        float4 x = *reinterpret_cast<float4*>(rw + c);
#pragma unroll
        for (int q = 0; q < KB; ++q) {
          if (q < nupd) {
            const float4 u = *reinterpret_cast<const float4*>(B.gp + q * W + c);
            x.x = __fmaf_rn(-lg[q], u.x, x.x);
            x.y = __fmaf_rn(-lg[q], u.y, x.y);
            x.z = __fmaf_rn(-lg[q], u.z, x.z);
            x.w = __fmaf_rn(-lg[q], u.w, x.w);
          }
        }
        *reinterpret_cast<float4*>(rw + c) = x;
      }
    }
    nupd = 0;
    __syncthreads();
  }

  // no CTA leaves while a peer may still read its shared memory
  if constexpr (!GRID) cluster_sync_all();
  __syncthreads();
  for (int idx = t; idx < nrows * W; idx += ROWS) {
    const int r = idx / W, c = idx % W;
    out[static_cast<size_t>(r0 + r) * W + c] = B.s[r * LDS + c];
  }
  if (mine) alive_out[r0 + t] = live ? 1 : 0;
  if (cta == 0 && t < W) piv[t] = s_piv[t];
}

// Per device: both instances' shared-memory attribute and the cluster
// instance's non-portable sizes, set on a device's first query or launch.
constexpr int MAX_DEVICES = 64;
std::mutex configure_mu;
bool configured[MAX_DEVICES];  // guarded-by: configure_mu

cudaError_t configure(int device) {
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  int cur = -1;
  cudaError_t e = cudaGetDevice(&cur);
  if (e == cudaSuccess && cur != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(configure_mu);
  if (configured[device]) return cudaSuccess;
  for (const void* k : {reinterpret_cast<const void*>(lu_block_kernel<false>),
                        reinterpret_cast<const void*>(lu_block_kernel<true>)}) {
    e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(SMEM_BYTES));
    if (e != cudaSuccess) return e;
  }
  e = cudaFuncSetAttribute(reinterpret_cast<const void*>(lu_block_kernel<false>),
                           cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  configured[device] = true;
  return cudaSuccess;
}

}  // namespace

// What `device` holds at once: cs in 1..16, clusters of cs CTAs of the
// cluster route (0 where such a cluster does not fit); cs = 0, CTAs of the
// grid route. Negative: a cudaError_t.
extern "C" int conflux_lu_block_resident(int device, int cs) {
  if (cs < 0 || cs > MAX_CLUSTER) return -static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = configure(device);
  if (e != cudaSuccess) return -static_cast<int>(e);
  if (cs > 0)
    return conflux::active_clusters(lu_block_kernel<false>, device, cs, ROWS, SMEM_BYTES);
  int per_sm = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lu_block_kernel<true>, ROWS,
                                                    SMEM_BYTES);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return -static_cast<int>(e);
  return per_sm * sms;
}

// One launch over `slots` blocks of (m, w) f32: slot s's block starts at a +
// s * sa (leading dimension lda); alive_in, alive_out: (slots, m) int32;
// out: (slots, m, w) f32 contiguous; piv: (slots, w) int32. cs > 0: the
// cluster route, one cluster of cs >= ceil(m / 256) CTAs a slot, any number
// of slots; words and cand_rows may be NULL. cs = 0: the grid route, one
// cooperative launch of G = ceil(m / 256) CTAs a slot, slots * G at most
// resident(0); scratch per slot: words (w * G + w) uint64 zeroed,
// cand_rows (w * G * w) f32, slot-major. Returns the cudaError_t of the
// launch.
extern "C" int conflux_lu_block(int device, int slots, int m, int w, int cs,
                                const float* a, int lda, long long sa,
                                const int* alive_in, float* out,
                                int* alive_out, int* piv,
                                unsigned long long* words, float* cand_rows,
                                void* stream) {
  const int g = (m + ROWS - 1) / ROWS;
  if (w != W || m <= 0 || slots <= 0 || cs < 0 || cs > MAX_CLUSTER || (cs > 0 && cs < g) ||
      (cs == 0 && (words == nullptr || cand_rows == nullptr)))
    return cudaErrorInvalidValue;
  cudaError_t e = configure(device);
  if (e != cudaSuccess) return e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cs == 0) {
    void* args[] = {&m, &a, &lda, &sa, &alive_in, &out, &alive_out, &piv, &words, &cand_rows};
    e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(lu_block_kernel<true>),
                                    dim3(g, slots), dim3(ROWS), args, SMEM_BYTES, st);
  } else {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(cs), static_cast<unsigned>(slots));
    cfg.blockDim = dim3(ROWS);
    cfg.dynamicSmemBytes = SMEM_BYTES;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, lu_block_kernel<false>, m, a, lda, sa, alive_in, out,
                           alive_out, piv, words, cand_rows);
  }
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}
