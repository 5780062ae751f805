// Batched blocked triangular solves through precomputed inverses of the
// (bs, bs) diagonal blocks: one substitution (lower or upper), or a whole
// solve round (forward, then back) in one launch.
//
// Replaces the TPU kernel `_pallas_btrsm` / `_btrsm_kernel` in
// conflux_tpu/ops/batched_trsm.py (public `pallas_blocked_trsm`), and the
// round the JAX serve programs build around it (`blocked_solve` forward on
// b[perm], `blocked_solve_probe` back). Per block step j (in order for a
// lower solve, in reverse for an upper one): x_j = Dinv_j r_j, then the rows
// not yet solved are downdated by T[rows, j-block] x_j. Only the
// strictly-lower (lower) or strictly-upper (upper) panels of T are read, so
// T may be a packed LU. A round (mode 2) solves T_fwd y = b[perm], then
// T_bwd x = y: the back solve reads T's strictly-upper panels and D2, or,
// with `trans`, T's strictly-lower panels transposed and D1 transposed (the
// SPD back solve through L^T, no copy). With the probe row wa, the final
// solve also yields per system xsum = sum(x) and wax = wa . x[:, 0], each
// block's partial added in block order by one thread, in the accumulation
// type, as the JAX `_blocked_core(..., wA=...)` accumulates them.
//
// Bound on an H100: latency. A (256, 256) round with one right-hand side
// moves ~150 KB of T per system and does ~0.3 Mflop, but its 2 nb block
// steps are a chain: step j needs x of every earlier step.
//
// Design: a thread-block cluster of cs CTAs per (system, column tile of the
// right-hand side): the largest cs up to 8 that keeps the batch in the
// fewest waves of clusters, by the card's occupancy (`cluster_launch.cuh`).
// The blocks of rows are dealt round-robin to the cluster's CTAs, and each
// CTA keeps the running right-hand side of its rows in shared memory for
// the whole round (y never leaves the cluster). Step j: the CTA that owns
// block j downdates block j by x_{j-1}, computes x_j = Dinv_j r_j and
// stores it into every CTA's shared memory (distributed shared memory) by
// st.async, each store completing its bytes on that CTA's mbarrier of
// block j; every CTA waits on its own mbarrier before it downdates its
// other rows by x_j. No cluster barrier stands in the chain: its release
// waited on each thread's cp.asyncs in flight, a memory latency a step (a
// first build of this design, measured on an H100). Each solve's x blocks
// have their own buffer and mbarrier, so nothing is overwritten within a
// pass; a pass ends with a cluster barrier. T's panel tiles and the Dinv
// blocks are brought into a shared-memory ring by cp.async, several steps
// ahead of the step that reads them: each (1 x bs) row segment of a tile is one
// coalesced 128-byte line (lane q holds T[r, j0 + q]; the transposed read
// of L^T is contiguous over rows instead). Each dot product of a step is
// split over QS = 4 lanes, whose partials meet in a fixed shuffle tree; the
// downdates of a row come in step order. So every output's chain of
// roundings is fixed, whatever the cluster size, the block split and the
// batch: a slot of a batch has the bits of a launch on that system alone.
// Where a round's x blocks and right-hand sides do not fit shared memory at
// any cluster size (n above ~19 000 f32 / ~8 500 f64 at k = 1), an instance
// keeps them in global memory (see the kernel), with the same bits; so any
// n runs. Diagonal blocks are up to 32 wide; the wrapper runs a wider one
// as its diagonal sub-blocks (`hopper_kernels._narrow_blocks`).
// A ragged n is handled in place, with the result of an identity-extended T:
// pad rows are zero and never downdated, pad columns of T never read. Sums
// are fused multiply-adds in the accumulation type (f32 for f32 operands,
// f64 for f64); no tensor cores (at one right-hand side the work is a
// latency chain, not a product). T may also be stored in bfloat16 with
// float32 accumulation (the factors of a bfloat16 factor plan): its panel
// tiles are copied into the ring as they are stored and each element is
// converted where a dot product reads it, an exact conversion, so the bits
// are those of the float32 instance on the upcast T.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

#include "cluster_launch.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;        // threads per CTA
constexpr int NWARPS = NT / 32;
constexpr int QS = 4;          // lanes splitting one dot product of a step
constexpr int MAX_BS = 32;     // widest diagonal block (wider ones the wrapper splits)
constexpr int MAX_CS = 8;      // largest cluster
// A tile's row pitch in elements: 16-byte rows for 16-byte copies, and with
// the dot products split over q = qs, qs + QS, ... (lane qs of a row's QS
// lanes), the QS x 8 lanes of a warp read 32 banks (float32)
template <typename T>
__host__ __device__ constexpr int pitch() { return sizeof(T) == 4 ? MAX_BS + 4 : MAX_BS + 2; }
// The pitch of a panel tile of T stored as TS: a bfloat16 row of 80 bytes
// keeps 16-byte pieces aligned, and the 8 rows a warp reads at once in 8
// distinct pairs of banks; a ring slot (bs rows of pitch<T>() elements of
// the accumulation type) holds it.
template <typename TS>
__host__ __device__ constexpr int pitch_s() { return sizeof(TS) == 2 ? MAX_BS + 8 : pitch<TS>(); }

__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ double to_acc(double v) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) { return __bfloat162float(v); }
constexpr int MAX_UNIT = 4;    // tiles per unit of the ring
constexpr int MAX_AHEAD = 7;   // units in flight past the one consumed
constexpr int KT_MAX = 16;     // right-hand-side columns per pass
constexpr size_t SMEM_MAX = 227 * 1024;  // dynamic shared memory of one H100 CTA

template <typename T, typename TS>
struct Args {
  int n, nb, bs, k, kt, as;  // as: odd row stride of the rhs tiles
  int ntiles, serial;        // column tiles; serial: one cluster walks them all
  int mode, trans, ring, nblm;  // ring: a power of two
  int vec;                   // T, D1, D2 rows copy in 16-byte pieces
  const TS* t;               // T as stored: T, or bfloat16 with T = float
  const T* d1;
  const T* d2;
  const T* b;
  const long long* perm;
  const T* wa;
  T* x;
  T* xsum;
  T* wax;
  T* gx;  // global-memory instance: each cluster's x blocks and right-hand sides
};

// The shapes a CTA indexes with: powers of two as shifts and masks where
// the launch makes them so (bs = BS = 32 at compile time, the cluster
// size, the column groups and the ring).
template <int BS>
struct Geo {
  int bs, csl, cs, rank, ncgl, ringm;
  __device__ int div_bs(int v) const { return BS ? v / BS : v / bs; }
  __device__ int mod_bs(int v) const { return BS ? v % BS : v % bs; }
};

// One block step of a pass, as CTA `rank` of a cluster of cs sees it.
template <typename T>
struct Step {
  int j, jp;           // the block solved; the block whose x is applied (-1: none)
  bool lower, tT;      // direction; T's panels and D read transposed
  bool own, fin;       // this CTA owns block j; the final solve (x goes out)
  int nbulk, bfirst, bstride;  // this CTA's other rows to downdate, by block
  const T* D;
  bool back;           // the round's back solve (its rhs is y)
};

template <typename T, typename TS, int BS>
__device__ Step<T> step_at(const Args<T, TS>& a, const Geo<BS>& g, int s) {
  Step<T> st;
  const bool back = a.mode == 2 && s >= a.nb;
  const int p = back ? s - a.nb : s;
  const int m = g.cs - 1;
  st.back = back;
  st.lower = a.mode == 0 || (a.mode == 2 && !back);
  st.j = st.lower ? p : a.nb - 1 - p;
  st.jp = p == 0 ? -1 : (st.lower ? st.j - 1 : st.j + 1);
  st.tT = back && a.trans;
  st.D = back ? (a.trans ? a.d1 : a.d2) : a.d1;
  st.fin = a.mode != 2 || back;
  st.own = (st.j & m) == g.rank;
  st.nbulk = 0;
  st.bfirst = 0;
  st.bstride = st.lower ? g.cs : -g.cs;
  if (st.jp >= 0) {
    if (st.lower) {  // this CTA's blocks after j
      const int f = st.j + 1 + ((g.rank - st.j - 1) & m);
      st.bfirst = f;
      st.nbulk = f < a.nb ? ((a.nb - 1 - f) >> g.csl) + 1 : 0;
    } else {  // this CTA's blocks before j
      const int f = st.j - 1 - ((st.j - 1 - g.rank) & m);
      st.bfirst = f;
      st.nbulk = f >= 0 ? (f >> g.csl) + 1 : 0;
    }
  }
  return st;
}

// Units of a step, in the order they are read: the owner's critical unit
// (the panel tile of block j, then Dinv_j), then the other rows' panel
// tiles, MAX_UNIT at a time.
template <typename T>
__device__ __forceinline__ int units_of(const Step<T>& st) {
  return (st.own ? 1 : 0) + (st.nbulk + MAX_UNIT - 1) / MAX_UNIT;
}

template <typename T>
__device__ __forceinline__ int tiles_of(const Step<T>& st, int u) {
  if (st.own) {
    if (u == 0) return st.jp >= 0 ? 2 : 1;
    --u;
  }
  return min(MAX_UNIT, st.nbulk - u * MAX_UNIT);
}

// Tile e of unit u: its row block, and whether it is Dinv_j.
template <typename T>
__device__ __forceinline__ int tile_block(const Step<T>& st, int u, int e, bool* isD) {
  *isD = false;
  if (st.own) {
    if (u == 0) {
      *isD = st.jp < 0 || e == 1;
      return st.j;
    }
    --u;
  }
  return st.bfirst + (u * MAX_UNIT + e) * st.bstride;
}

__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async(double* dst, const double* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Wait until at most `pending` committed groups of this thread are in flight.
__device__ __forceinline__ void cp_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The address of the same shared-memory offset in CTA `rank` of the cluster.
__device__ __forceinline__ uint32_t mapa(uint32_t a, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

__device__ __forceinline__ void mbar_init(uint64_t* m, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(m)), "r"(count)
               : "memory");
}

// This CTA's arrival on its mbarrier for one phase, which then completes
// when `bytes` have landed by st.async (possibly some already have).
__device__ __forceinline__ void mbar_expect(uint64_t* m, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(m)),
               "r"(bytes)
               : "memory");
}

// Acquire at CTA scope where the data is this CTA's shared memory, stored
// by st.async (a cluster-scope acquire would also invalidate the SM's L1,
// CCTL.IVALL, at each success); at cluster scope where it is global memory
// written by another CTA of the cluster (GM).
template <bool GM>
__device__ __forceinline__ void mbar_wait(const uint64_t* m, int parity) {
  const uint32_t a = smem_addr(m);
  uint32_t done = 0;
  while (!done) {
    if (GM)
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.test_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(a), "r"(parity)
          : "memory");
    else
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(a), "r"(parity)
          : "memory");
  }
}

// An arrival on the mbarrier of CTA-of-the-cluster address rm that
// releases, at cluster scope, what this CTA wrote before its last barrier.
__device__ __forceinline__ void mbar_arrive_remote(uint32_t rm) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(rm)
               : "memory");
}

// An x element: shared memory, or global memory past L1 (GM).
template <bool GM, typename T>
__device__ __forceinline__ T ldx(const T* p) {
  if constexpr (GM) return __ldcg(p);
  else return *p;
}

// A store into CTA-of-the-cluster shared memory that completes its bytes on
// that CTA's mbarrier: no fence, the reader waits on its mbarrier.
__device__ __forceinline__ void st_async(uint32_t ra, float v, uint32_t rm) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" ::"r"(ra),
               "r"(__float_as_uint(v)), "r"(rm)
               : "memory");
}

__device__ __forceinline__ void st_async(uint32_t ra, double v, uint32_t rm) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, [%2];\n" ::"r"(ra),
               "l"(__double_as_longlong(v)), "r"(rm)
               : "memory");
}

// Issue the cp.asyncs of one tile into ring slot `dst`: a panel tile (rows
// of block i, the columns of block st.jp), rows of pitch_s<TS>() elements
// of T's storage type, or Dinv_i, rows of pitch<T>(). Each tile row is a
// row of T or D in memory, copied in 16-byte pieces where a.vec (else
// element by element; a 2-byte element by a plain load and store, which
// the unit's barrier orders as it orders the cp.asyncs): a tile of T's
// panel is [r][q]; read transposed (st.tT), a tile holds L's rows, [q][r],
// and so does Dinv.
template <typename E>
__device__ __forceinline__ void copy_rows(int vec, E* dst, int pitch, const E* src, int ld,
                                          int rows, int cols, int bs) {
  constexpr int V = 16 / sizeof(E);
  const int tid = threadIdx.x;
  if (vec) {
    const int cpr = bs / V;  // pieces a row; cols is a multiple of V
    for (int e = tid; e < rows * cpr; e += NT) {
      const int r = e / cpr, c = (e % cpr) * V;
      if (c < cols) {
        const unsigned d = smem_addr(dst + r * pitch + c);
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                     "l"(src + static_cast<size_t>(r) * ld + c)
                     : "memory");
      }
    }
  } else {
    for (int e = tid; e < rows * bs; e += NT) {
      const int r = e / bs, c = e % bs;
      if (c < cols) {
        if constexpr (sizeof(E) >= 4)
          cp_async(dst + r * pitch + c, src + static_cast<size_t>(r) * ld + c);
        else
          dst[r * pitch + c] = src[static_cast<size_t>(r) * ld + c];
      }
    }
  }
}

template <typename T, typename TS, int BS>
__device__ __forceinline__ void load_tile(const Args<T, TS>& a, const Geo<BS>& g,
                                          const Step<T>& st, size_t sys, bool isD, int i,
                                          T* dst) {
  const int bs = g.bs, n = a.n;
  if (isD) {
    copy_rows<T>(a.vec, dst, pitch<T>(), st.D + (sys * a.nb + i) * bs * bs, bs, bs, bs, bs);
    return;
  }
  const int i0 = i * bs, c0 = st.jp * bs;
  const int ri = min(bs, n - i0), cq = min(bs, n - c0);
  TS* ds = reinterpret_cast<TS*>(dst);
  if (st.tT)  // L[c0 + q, i0 + r]
    copy_rows<TS>(a.vec, ds, pitch_s<TS>(), a.t + sys * n * n + static_cast<size_t>(c0) * n + i0,
                  n, cq, ri, bs);
  else  // T[i0 + r, c0 + q]
    copy_rows<TS>(a.vec, ds, pitch_s<TS>(), a.t + sys * n * n + static_cast<size_t>(i0) * n + c0,
                  n, ri, cq, bs);
}

// acc[rows of the unit's tiles] -= tile x xs: each (row, column group) a
// dot product split over QS lanes (lane qs takes q = qs, qs + QS, ...),
// partials met in a fixed shuffle tree.
template <typename T, typename TS, int KC, int BS, bool GM>
__device__ __forceinline__ void downdate(const Args<T, TS>& a, const Geo<BS>& g, const Step<T>& st,
                                         int u, int ntl, const T* ring, int g0, const T* xs,
                                         T* acc) {
  constexpr int P = pitch<T>(), PS = pitch_s<TS>();
  const int bs = g.bs, as = KC == 1 ? 1 : a.as;  // one column: as is 1
  const int qmax = min(bs, a.n - st.jp * bs);
  // a whole warp where blocks are 32 wide (the items fill whole warps),
  // else the QS lanes of the dot product
  const int lane = threadIdx.x & 31;
  const unsigned mask = BS ? 0xffffffffu : ((1u << QS) - 1) << (lane & ~(QS - 1));
  const int items = (ntl * bs << g.ncgl) * QS;
  for (int it = threadIdx.x; it < items; it += NT) {
    const int qs = it & (QS - 1), rest = it / QS;
    const int cg_ = rest & ((1 << g.ncgl) - 1), rr = rest >> g.ncgl;
    const int r = g.mod_bs(rr), e = g.div_bs(rr);
    bool isD;
    const int i = tile_block(st, u, e, &isD);
    const bool valid = i * bs + r < a.n;
    // element (r, q) at r * PS + q, or at q * PS + r in a transposed tile
    const TS* tile =
        reinterpret_cast<const TS*>(ring + static_cast<size_t>((g0 + e) & g.ringm) * bs * P) +
        (st.tT ? r : r * PS);
    const int qstep = st.tT ? PS : 1;  // q's stride in the tile
    T s[KC];
#pragma unroll
    for (int c = 0; c < KC; ++c) s[c] = T(0);
    if (valid) {
      // lane qs's terms q = qs + QS qq: strides fixed before the loop, and a
      // full block unrolled, so that the loads run ahead of the FMA chain
      const TS* tq = tile + qs * qstep;
      const T* xq = xs + qs * as + cg_ * KC;
      const int ts = QS * qstep, xst = QS * as;
      auto term = [&](int qq) {
        const T tv = to_acc(tq[qq * ts]);
#pragma unroll
        for (int c = 0; c < KC; ++c) s[c] = fma(tv, ldx<GM>(xq + qq * xst + c), s[c]);
      };
      if (BS && qmax == BS) {
#pragma unroll
        for (int qq = 0; qq < BS / QS; ++qq) term(qq);
      } else {
        for (int qq = 0; qs + qq * QS < qmax; ++qq) term(qq);
      }
    }
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      s[c] += __shfl_xor_sync(mask, s[c], 1);
      s[c] += __shfl_xor_sync(mask, s[c], 2);
    }
    if (valid && qs == 0) {
      T* ar = acc + ((i >> g.csl) * bs + r) * as + cg_ * KC;
#pragma unroll
      for (int c = 0; c < KC; ++c) ar[c] -= s[c];
    }
  }
}

// Bytes of the mbarriers at the head of shared memory, 16-byte aligned.
__host__ __device__ __forceinline__ size_t mbar_bytes(int nb, bool pair) {
  return (static_cast<size_t>(pair ? 2 : 1) * nb * 8 + 15) / 16 * 16;
}

// three CTAs an SM (float32): a batch of 32 systems then runs as clusters
// of 8 in one wave of the card. GM: the x blocks and the running
// right-hand sides live in global memory (a.gx), where they do not fit
// shared memory: the owner of block j stores x_j there once and, after a
// barrier of its CTA, arrives on every CTA's mbarrier of block j with a
// cluster-scope release; readers wait with a cluster-scope acquire and
// read x past L1. Same operations in the same order: same bits.
template <typename T, typename TS, int KC, int BS, bool GM>
__global__ void __launch_bounds__(NT, sizeof(T) == 4 ? 3 : 2)
btrsm_kernel(const Args<T, TS> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  Geo<BS> g;
  g.bs = BS ? BS : a.bs;
  g.cs = static_cast<int>(cluster.num_blocks());
  g.csl = __ffs(g.cs) - 1;
  g.rank = static_cast<int>(cluster.block_rank());
  g.ncgl = __ffs(a.kt / KC) - 1;
  g.ringm = a.ring - 1;
  constexpr int P = pitch<T>();
  const int bs = g.bs, as = a.as, tid = threadIdx.x, cs = g.cs, rank = g.rank;
  const bool pair = a.mode == 2, probe = a.wa != nullptr;

  // the x blocks of each solve and their mbarriers (forward, then back):
  // block j's arrives from its owner by st.async, once per pass
  const int nsol = pair ? 2 : 1;
  const int cid = blockIdx.x >> g.csl;
  const size_t xsize = static_cast<size_t>(nsol) * a.nb * bs * as;
  const size_t rsize = static_cast<size_t>(a.nblm) * bs * as;  // a CTA's rhs of one solve
  uint64_t* xready = reinterpret_cast<uint64_t*>(smem_raw);  // (nsol, nb)
  T* ring = reinterpret_cast<T*>(smem_raw + mbar_bytes(a.nb, pair));
  T* xbuf = ring + static_cast<size_t>(a.ring) * bs * P;  // (nsol, nb * bs, as)
  T* accF = xbuf + xsize;  // the forward (or only) rhs
  if constexpr (GM) {  // per cluster: the x blocks, then each CTA's right-hand sides
    xbuf = a.gx + static_cast<size_t>(cid) * (xsize + static_cast<size_t>(cs) * nsol * rsize);
    accF = xbuf + xsize + static_cast<size_t>(rank) * nsol * rsize;
  }
  T* accB = accF + rsize;  // the back solve's: y
  T* psum = GM ? ring + static_cast<size_t>(a.ring) * bs * P
               : accB + (pair ? rsize : 0);  // (nblm, 2)
  T* gath = psum + 2 * a.nblm;  // (nb, 2), rank 0's is read

  const int npar = a.serial ? 1 : a.ntiles;
  const size_t sys = cid / npar;
  const int S = pair ? 2 * a.nb : a.nb;
  const int nbl = (a.nb - rank + cs - 1) >> g.csl;  // blocks of this CTA

  for (int e = tid; e < nsol * a.nb; e += NT) mbar_init(xready + e, 1);
  for (int e = tid; e < 2 * a.nblm; e += NT) psum[e] = T(0);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  cluster.sync();  // every CTA of the cluster runs, its mbarriers set

  int parity = 0;  // phase of every mbarrier in this pass
  for (int tile = a.serial ? 0 : cid % npar; tile < a.ntiles; tile += npar) {
    const int c0 = tile * a.kt, kw = min(a.kt, a.k - c0);
    // the ring: units issued (ps, pu) ahead of the one consumed
    int ps = 0, pu = 0, issued = 0, consumed = 0, tp = 0, tc = 0;
    while (ps < S && units_of(step_at(a, g, ps)) == 0) ++ps;
    auto refill = [&](int in_use) {
      while (ps < S && issued - consumed < MAX_AHEAD) {
        const Step<T> st = step_at(a, g, ps);
        const int nt = tiles_of(st, pu);
        if (tp + nt - in_use > a.ring) break;
        for (int e = 0; e < nt; ++e) {
          bool isD;
          const int i = tile_block(st, pu, e, &isD);
          load_tile(a, g, st, sys, isD, i,
                    ring + static_cast<size_t>((tp + e) & g.ringm) * bs * P);
        }
        cp_commit();
        tp += nt;
        ++issued;
        if (++pu == units_of(st)) {
          pu = 0;
          do ++ps; while (ps < S && units_of(step_at(a, g, ps)) == 0);
        }
      }
    };
    // the next unit's tiles have landed and every thread may read them;
    // returns its first tile's index. A unit not issued yet (the ring was
    // full) is issued here, the ring drained.
    int cur0 = 0;  // first tile of the unit read last: no refill overwrites it
    auto begin_unit = [&](int nt, bool fill) {
      if (issued == consumed) {
        __syncthreads();
        refill(tc);
      }
      cp_wait(issued - consumed - 1);
      __syncthreads();
      cur0 = tc;
      tc += nt;
      ++consumed;
      if (fill) refill(cur0);
      return cur0;
    };
    refill(0);

    // while the first tiles load: the running right-hand side of this
    // CTA's rows, b[perm], pad zero
    for (int e = tid; e < nbl * bs * as; e += NT) {
      const int c = e % as, rr = e / as;
      const int row = (((g.div_bs(rr)) << g.csl) + rank) * bs + g.mod_bs(rr);
      T v = T(0);
      if (row < a.n && c < kw) {
        const size_t src = a.perm ? static_cast<size_t>(a.perm[sys * a.n + row]) : row;
        v = a.b[(sys * a.n + src) * a.k + c0 + c];
      }
      accF[e] = v;
      if (pair) accB[e] = T(0);
    }
    // this pass's phase of every x block: its bytes (real rows, kt columns)
    for (int e = tid; e < nsol * a.nb && !GM; e += NT) {
      const int j = e % a.nb;
      mbar_expect(xready + e, min(bs, a.n - j * bs) * a.kt * sizeof(T));
    }


    for (int s = 0; s < S; ++s) {
      const Step<T> st = step_at(a, g, s);
      T* acc = st.back ? accB : accF;
      uint64_t* xr = xready + (st.back ? a.nb : 0);
      T* xb = xbuf + (st.back ? static_cast<size_t>(a.nb) * bs * as : 0);
      const T* xprev = xb + static_cast<size_t>(max(st.jp, 0)) * bs * as;
      if (st.own) {
        // the critical unit: block j by x_jp, then x_j = Dinv_j r_j
        const int nt = tiles_of(st, 0);
        const int g0 = begin_unit(nt, false);
        if (st.jp >= 0) {
          mbar_wait<GM>(xr + st.jp, parity);
          downdate<T, TS, KC, BS, GM>(a, g, st, 0, 1, ring, g0, xprev, acc);
          __syncthreads();
        }
        const T* Dt = ring + static_cast<size_t>((g0 + nt - 1) & g.ringm) * bs * P;
        const int dstep = st.tT ? P : 1;  // Dinv_j's (i, q) at i * P + q, or q * P + i
        const int as1 = KC == 1 ? 1 : as;
        const int lbj = st.j >> g.csl, j0 = st.j * bs, real = min(bs, a.n - j0);
        const uint32_t xj = GM ? 0 : smem_addr(xb + static_cast<size_t>(st.j) * bs * as);
        const uint32_t mj = smem_addr(xr + st.j);
        const int lane = tid & 31;
        const unsigned mask = BS ? 0xffffffffu : ((1u << QS) - 1) << (lane & ~(QS - 1));
        const int items = (bs << g.ncgl) * QS;  // at most 2 NT
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int it = tid + h * NT;
          if (it >= items) break;
          const int qs = it & (QS - 1), cg_ = (it / QS) & ((1 << g.ncgl) - 1);
          const int i = (it / QS) >> g.ncgl;
          T v[KC];
#pragma unroll
          for (int c = 0; c < KC; ++c) v[c] = T(0);
          if (i < real) {
            const T* dq = Dt + (st.tT ? i : i * P) + qs * dstep;
            const T* aq = acc + (lbj * bs + qs) * as1 + cg_ * KC;
            const int ds = QS * dstep, ast = QS * as1;
            auto term = [&](int qq) {
              const T dv = dq[qq * ds];
#pragma unroll
              for (int c = 0; c < KC; ++c) v[c] = fma(dv, aq[qq * ast + c], v[c]);
            };
            if (BS) {
#pragma unroll
              for (int qq = 0; qq < (BS ? BS : QS) / QS; ++qq) term(qq);
            } else {
              for (int qq = 0; qs + qq * QS < bs; ++qq) term(qq);
            }
          }
#pragma unroll
          for (int c = 0; c < KC; ++c) {
            v[c] += __shfl_xor_sync(mask, v[c], 1);
            v[c] += __shfl_xor_sync(mask, v[c], 2);
          }
          if (i < real) {
            if constexpr (GM) {
              if (qs == 0) {
                T* xg = xb + (static_cast<size_t>(st.j) * bs + i) * as + cg_ * KC;
#pragma unroll
                for (int c = 0; c < KC; ++c) xg[c] = v[c];
              }
            } else {
              // the QS lanes share the stores into the cluster's CTAs
              const uint32_t off = ((i * as + cg_ * KC) * sizeof(T));
              for (int rk = qs; rk < cs; rk += QS) {
                const uint32_t ra = mapa(xj + off, rk), rm = mapa(mj, rk);
#pragma unroll
                for (int c = 0; c < KC; ++c) st_async(ra + c * sizeof(T), v[c], rm);
              }
            }
            if (qs == 0) {
              if (!st.fin) {  // y_j: the back solve's right-hand side
                T* yr = accB + (lbj * bs + i) * as + cg_ * KC;
#pragma unroll
                for (int c = 0; c < KC; ++c) yr[c] = v[c];
              } else {
                T* xo = a.x + (sys * a.n + j0 + i) * a.k + c0 + cg_ * KC;
#pragma unroll
                for (int c = 0; c < KC; ++c)
                  if (cg_ * KC + c < kw) xo[c] = v[c];
              }
            }
          }
        }
        if constexpr (GM) {  // x_j is out: every CTA's mbarrier of block j
          __syncthreads();
          if (tid < cs) mbar_arrive_remote(mapa(mj, tid));
        }
        refill(g0);
      }
      // this CTA's other rows by x_jp
      const int nu = units_of(st);
      for (int u = st.own ? 1 : 0; u < nu; ++u) {
        const int nt = tiles_of(st, u);
        const int g0 = begin_unit(nt, true);
        if (u == (st.own ? 1 : 0)) mbar_wait<GM>(xr + st.jp, parity);
        downdate<T, TS, KC, BS, GM>(a, g, st, u, nt, ring, g0, xprev, acc);
      }
    }
    // every x block of the pass has landed here, and everywhere: the
    // buffers are free and no store is in flight into this CTA
    for (int e = tid; e < nsol * a.nb; e += NT) mbar_wait<GM>(xready + e, parity);
    parity ^= 1;
    cluster.sync();

    if (probe) {  // each block's partials, a warp a block, this pass's columns
      const int warp = tid >> 5, lane = tid & 31;
      for (int lb = warp; lb < nbl; lb += NWARPS) {
        const int row = ((lb << g.csl) + rank) * bs + lane;
        T v = T(0), w = T(0);
        if (lane < bs && row < a.n) {
          const T* xo = a.x + (sys * a.n + row) * a.k + c0;
          for (int c = 0; c < kw; ++c) v += xo[c];
          if (tile == 0) w = a.wa[sys * a.n + row] * xo[0];
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          v += __shfl_xor_sync(0xffffffffu, v, off);
          w += __shfl_xor_sync(0xffffffffu, w, off);
        }
        if (lane == 0) {
          psum[2 * lb] += v;
          psum[2 * lb + 1] += w;
        }
      }
    }
  }

  if (probe) {
    __syncthreads();
    for (int lb = tid; lb < nbl; lb += NT) {
      T* dst = cluster.map_shared_rank(gath + 2 * ((lb << g.csl) + rank), 0);
      dst[0] = psum[2 * lb];
      dst[1] = psum[2 * lb + 1];
    }
    cluster.sync();
    if (rank == 0 && tid == 0) {  // in the final solve's block order
      T xs = T(0), wx = T(0);
      const bool up = a.mode != 0;
      for (int s = 0; s < a.nb; ++s) {
        const int j = up ? a.nb - 1 - s : s;
        xs += gath[2 * j];
        wx += gath[2 * j + 1];
      }
      a.xsum[sys] = xs;
      a.wax[sys] = wx;
    }
  }
}

// Shared memory of a launch, and (GM) the global scratch of one cluster.
template <typename T>
size_t smem_bytes(int ring, int bs, int as, int nblm, int nb, bool pair, bool gm) {
  const size_t sol = pair ? 2 : 1;
  const size_t xr = gm ? 0 : sol * nb * bs * as + sol * nblm * bs * as;
  return mbar_bytes(nb, pair) + sizeof(T) * (static_cast<size_t>(ring) * bs * pitch<T>() + xr +
                                             2 * nblm + 2 * static_cast<size_t>(nb));
}

template <typename T>
size_t scratch_elems(int cs, int bs, int as, int nblm, int nb, bool pair) {
  const size_t sol = pair ? 2 : 1;
  return sol * nb * bs * as + static_cast<size_t>(cs) * sol * nblm * bs * as;
}

// What one launch runs as: the kernel instance, the cluster size (0: no
// size fits), the column tile kt, the ring's tiles, and whether the x
// blocks live in global memory.
template <typename T, typename TS>
struct Geometry {
  void (*kernel)(const Args<T, TS>);
  int cs, kt, ring, ntiles, serial, gm;
  size_t smem;
};

template <typename T, typename TS, int KC, int BS, bool GM>
Geometry<T, TS> geometry_of(int device, int clusters, int nb, int bs, int kt, bool pair) {
  // a power of two, 2 MAX_UNIT or more; a deeper ring was slower on an H100
  // (`scripts/torch_btrsm_variants.py`) and a smaller CTA fits more a SM
  const int ring = 2 * MAX_UNIT;
  const int as = kt == 1 ? 1 : (kt | 1);
  // wider column tiles move kt times the bytes between the CTAs a step:
  // clusters of 4 at most (8 was slower at (32, 256) with k = 16)
  const int cap = max(1, min(kt > 1 ? min(4, MAX_CS) : MAX_CS, nb));
  auto smem_of = [&](int cs) {
    const size_t s = smem_bytes<T>(ring, bs, as, (nb + cs - 1) / cs, nb, pair, GM);
    return s > SMEM_MAX ? static_cast<size_t>(-1) : s;
  };
  auto kernel = btrsm_kernel<T, TS, KC, BS, GM>;
  // the attribute first: the occupancy query reads it
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(SMEM_MAX));
  // the fewest waves of clusters, then the largest cluster: a system's
  // chain of steps shortens with its CTAs, a second wave doubles it
  int cs = 0, waves = 0;
  for (int c = 1; c <= cap; c *= 2) {
    const size_t smem = smem_of(c);
    if (smem == static_cast<size_t>(-1)) continue;
    const int active = conflux::active_clusters(kernel, device, c, NT, smem);
    if (active <= 0) continue;
    const int w = (clusters + active - 1) / active;
    if (cs == 0 || w <= waves) {
      cs = c;
      waves = w;
    }
  }
  Geometry<T, TS> g{kernel, cs, kt, ring, 0, 0, GM, cs ? smem_of(cs) : 0};
  return g;
}

template <typename T, typename TS, int KC, bool GM>
Geometry<T, TS> geometry_bs(int device, int clusters, int nb, int bs, int kt, bool pair) {
  // blocks 32 wide at compile time, any narrower one (and GM) at run time
  if constexpr (!GM)
    if (bs == MAX_BS) return geometry_of<T, TS, KC, MAX_BS, GM>(device, clusters, nb, bs, kt, pair);
  return geometry_of<T, TS, KC, 0, GM>(device, clusters, nb, bs, kt, pair);
}

// The launch geometry, cached per (device, shape, mode, probe): the
// occupancy queries and the attribute run on a shape's first launch only.
template <typename T, typename TS>
Geometry<T, TS> geometry(int device, int batch, int n, int nb, int bs, int k, int mode, bool probe) {
  static std::mutex mu;
  static std::map<std::tuple<int, int, int, int, int, int, int, bool>, Geometry<T, TS>>
      cache;  // guarded-by: mu
  const auto key = std::make_tuple(device, batch, n, nb, bs, k, mode, probe);
  {
    std::lock_guard<std::mutex> lock(mu);
    auto it = cache.find(key);
    if (it != cache.end()) return it->second;
  }
  // k = 1 on its own instance; wider rhs in column tiles of 4, 8 or 16,
  // narrower where a wide tile's x blocks do not fit shared memory; where
  // none fits, the x blocks and right-hand sides go to global memory
  const bool pair = mode == 2;
  const int kt0 = k == 1 ? 1 : (k <= 4 ? 4 : (k <= 8 ? 8 : KT_MAX));
  Geometry<T, TS> g{nullptr, 0, 0, 0, 0, 0, 0, 0};
  for (int gm = 0; gm < 2 && g.cs == 0; ++gm) {
    for (int kt = kt0; kt >= 1 && g.cs == 0; kt = (kt == 4 || gm) ? 0 : kt / 2) {
      const int ntiles = (k + kt - 1) / kt;
      const int serial = probe || ntiles == 1;
      const int clusters = batch * (serial ? 1 : ntiles);
      if (gm)
        g = kt == 1 ? geometry_bs<T, TS, 1, true>(device, clusters, nb, bs, kt, pair)
                    : geometry_bs<T, TS, 4, true>(device, clusters, nb, bs, kt, pair);
      else
        g = kt == 1 ? geometry_bs<T, TS, 1, false>(device, clusters, nb, bs, kt, pair)
                    : geometry_bs<T, TS, 4, false>(device, clusters, nb, bs, kt, pair);
      g.ntiles = ntiles;
      g.serial = serial;
    }
  }
  std::lock_guard<std::mutex> lock(mu);
  cache[key] = g;
  return g;
}

template <typename T, typename TS>
int launch(int device, int batch, int n, int nb, int bs, int k, int mode, int trans,
           const void* t, const void* d1, const void* d2, const void* b,
           const long long* perm, const void* wa, void* x, void* xsum, void* wax,
           cudaStream_t stream) {
  const Geometry<T, TS> g = geometry<T, TS>(device, batch, n, nb, bs, k, mode, wa != nullptr);
  if (g.cs == 0) return cudaErrorInvalidValue;  // does not fit shared memory
  Args<T, TS> a;
  a.n = n;
  a.nb = nb;
  a.bs = bs;
  a.k = k;
  a.kt = g.kt;
  a.as = g.kt == 1 ? 1 : (g.kt | 1);
  a.ntiles = g.ntiles;
  a.serial = g.serial;
  a.mode = mode;
  a.trans = trans;
  a.ring = g.ring;
  a.nblm = (nb + g.cs - 1) / g.cs;
  constexpr int V = 16 / sizeof(T), VS = 16 / sizeof(TS);
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  a.vec = n % VS == 0 && bs % VS == 0 && bs % V == 0 && aligned(t) && aligned(d1) &&
          (!d2 || aligned(d2));
  a.t = static_cast<const TS*>(t);
  a.d1 = static_cast<const T*>(d1);
  a.d2 = static_cast<const T*>(d2);
  a.b = static_cast<const T*>(b);
  a.perm = perm;
  a.wa = static_cast<const T*>(wa);
  a.x = static_cast<T*>(x);
  a.xsum = static_cast<T*>(xsum);
  a.wax = static_cast<T*>(wax);
  a.gx = nullptr;
  const int clusters = batch * (g.serial ? 1 : g.ntiles);
  if (!g.gm) return conflux::launch_clusters(g.kernel, clusters, g.cs, NT, g.smem, stream, a);
  // the global scratch, stream-ordered around the launch
  const size_t bytes = sizeof(T) * clusters *
                       scratch_elems<T>(g.cs, bs, a.as, a.nblm, nb, mode == 2);
  cudaError_t e = cudaMallocAsync(reinterpret_cast<void**>(&a.gx), bytes, stream);
  if (e != cudaSuccess) return e;
  e = conflux::launch_clusters(g.kernel, clusters, g.cs, NT, g.smem, stream, a);
  const cudaError_t f = cudaFreeAsync(a.gx, stream);
  return e != cudaSuccess ? e : f;
}

bool bad_shape(int batch, int n, int nb, int bs, int k, int mode) {
  return batch <= 0 || n <= 0 || k <= 0 || bs <= 0 || bs > MAX_BS || nb * bs < n ||
         (nb - 1) * bs >= n || mode < 0 || mode > 2;
}

}  // namespace

// dtype 0: float32, 1: float64, 2: float32 with t stored in bfloat16. t:
// (batch, n, n); d1, d2: (batch, nb, bs, bs); b and x: (batch, n, k); all
// contiguous and of that dtype (t in bfloat16 for dtype 2), with
// bs <= 32 and nb = ceil(n / bs). mode 0: T x = b lower through d1; 1:
// upper through d1; 2: the round, lower through d1 on b[perm], then upper
// through d2 or, with trans, through T^T and d1^T. perm: (batch, n) int64 or
// NULL. wa: (batch, n) or NULL; with it, xsum and wax (batch,) get the probe
// stats of the final solve. Returns the cudaError_t of the launch.
extern "C" int conflux_btrsm(int dtype, int device, int batch, int n, int nb, int bs, int k,
                             int mode, int trans, const void* t, const void* d1,
                             const void* d2, const void* b, const long long* perm,
                             const void* wa, void* x, void* xsum, void* wax, void* stream) {
  if (bad_shape(batch, n, nb, bs, k, mode) || (mode == 2 && !trans && d2 == nullptr) ||
      (wa != nullptr && (xsum == nullptr || wax == nullptr)))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, float>(device, batch, n, nb, bs, k, mode, trans, t, d1, d2, b, perm, wa, x,
                         xsum, wax, s);
  if (dtype == 1)
    return launch<double, double>(device, batch, n, nb, bs, k, mode, trans, t, d1, d2, b, perm,
                                  wa, x, xsum, wax, s);
  if (dtype == 2)
    return launch<float, __nv_bfloat16>(device, batch, n, nb, bs, k, mode, trans, t, d1, d2, b,
                                        perm, wa, x, xsum, wax, s);
  return cudaErrorInvalidValue;
}
