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
// Bound on an H100: the chain of n pivot elections (each needs the column
// current), then the updates' traffic: 2/3 n^3 flops per slot, ~0.34 ms of
// the card's f32 rate for 32 slots at n = 1024, and a pass over the
// trailing rows per KB columns once the updates are blocked.
//
// Design: a thread-block cluster of `cs` CTAs per slot (cs from B, n and the
// card: `cluster_launch.cuh`), the running matrix
// in the output buffer, the live rows a list in each CTA's shared memory
// (the same list in all), and the updates held back KB columns. Per block
// J = [j0, j1):
//   1. the panel: each CTA holds its share of the live rows' KB panel
//      columns in shared memory (or, where a share does not fit even at
//      cluster size 8, n above 9784 in float32 and 4968 in float64,
//      works on them in the output: the `GP` instance). For j in J, each
//      warp publishes its best (score, row) in its shared memory; after a
//      cluster barrier warp 0 of every CTA reduces the cluster's partials
//      through distributed shared memory (the order is total, so every CTA
//      elects the same row) and copies the pivot row's panel values from
//      its owner; each live row takes its multiplier and the in-panel
//      updates at once, so the next column is current. The panel rows go
//      back to the output;
//   2. the row panel: the pivot rows p_j over the columns after J brought
//      up to step j, fma(-l[p_j, j'], u_j', .) for j' < j in order, in
//      groups of GR columns dealt to the cluster's warps (a lane per pivot
//      row, step j's operand broadcast from lane j); a cluster barrier;
//   3. the rows still live after J, in 64 x 64 tiles dealt round-robin to
//      the cluster's CTAs: each element is loaded once into a 4 x 4 register
//      micro-tile, takes its KB FMAs fma(-l_rj, u_jc, a) in column order from
//      the multipliers and the row panel staged in shared memory, and is
//      stored once; a cluster barrier.
// Two CTAs share an SM in float32 (128 registers, no spills) and hide each
// other's loads.
// Each element's value is the same chain of FMAs as in a column-at-a-time
// elimination, whatever KB, cs, the thread or the CTA, and the election is
// a total order (score, then row), so a slot's bits depend on nothing but
// its own input. The first block reads the input directly (no copy pass).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "cluster_launch.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;      // threads per CTA
constexpr int NW = NT / 32;  // warps per CTA
constexpr int KB = 32;       // columns per block
constexpr int PL = KB + 1;   // panel row stride
constexpr int TI = 64;       // trailing tile edge
constexpr int LD = TI + 4;   // staging row stride
constexpr int ST = KB * TI / NT;  // staged panel values per thread and panel
constexpr int GR = 8;        // row-panel columns per warp group
constexpr int SMEM_MAX = 227 * 1024;

template <typename T>
__device__ __forceinline__ bool better(T v, int r, T bv, int br) {
  return v > bv || (v == bv && r < br);
}

// Dynamic shared memory of one CTA: the panel rows, the pivot rows, the
// staging tiles, the published partial (double-buffered), the live list.
template <typename T>
struct Smem {
  T* ps;     // [rows][PL]: this CTA's share of the live rows' panel columns (not GP)
  T* pivr;   // [KB][PL]: the block's pivot rows' panel values
  T* cs;     // [KB][LD]: multipliers of a tile's rows, [j][i]
  T* rs;     // [KB][LD]: row panel of a tile's columns, [j][k]
  T* wval;   // [2][NW]: each warp's best score (double-buffered by column)
  int* wrow; // [2][NW]: its row
  int* wloc; // [2][NW]: its index in ps
  int* pr;   // [KB]: the block's pivot rows
  int* lst;  // [n]: the live rows
  unsigned char* dead;  // [n]: elected (the list drops them at the block's end)
};

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// Carves the layout out of `base` (when not NULL) and returns its bytes.
template <typename T>
__host__ __device__ inline size_t smem_layout(int n, int rows, unsigned char* base,
                                              Smem<T>* s) {
  const size_t sizes[10] = {
      sizeof(T) * rows * PL, sizeof(T) * KB * PL, sizeof(T) * KB * LD, sizeof(T) * KB * LD,
      sizeof(T) * 2 * NW,    sizeof(int) * 2 * NW, sizeof(int) * 2 * NW, sizeof(int) * KB,
      sizeof(int) * n,       static_cast<size_t>(n)};
  size_t offs[10], off = 0;
  for (int i = 0; i < 10; ++i) {
    offs[i] = off;
    off = align16(off + sizes[i]);
  }
  if (base != nullptr) {
    s->ps = reinterpret_cast<T*>(base + offs[0]);
    s->pivr = reinterpret_cast<T*>(base + offs[1]);
    s->cs = reinterpret_cast<T*>(base + offs[2]);
    s->rs = reinterpret_cast<T*>(base + offs[3]);
    s->wval = reinterpret_cast<T*>(base + offs[4]);
    s->wrow = reinterpret_cast<int*>(base + offs[5]);
    s->wloc = reinterpret_cast<int*>(base + offs[6]);
    s->pr = reinterpret_cast<int*>(base + offs[7]);
    s->lst = reinterpret_cast<int*>(base + offs[8]);
    s->dead = base + offs[9];
  }
  return off;
}

// GP: the panel rows stay in the output (global memory), for n whose
// panel share does not fit shared memory; the same arithmetic in the same
// order, so the same bits.
template <typename T, bool GP>
__global__ void __launch_bounds__(NT, sizeof(T) == 4 ? 2 : 1)
batched_lu_kernel(int n, const T* __restrict__ a, T* out, int* __restrict__ piv,
                  const T* __restrict__ w, T* __restrict__ wa) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int ncs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int rows_max = GP ? 0 : (n + ncs - 1) / ncs;
  Smem<T> S;
  smem_layout<T>(n, rows_max, smem_raw, &S);

  const size_t slot = blockIdx.x / ncs;
  const size_t nn = static_cast<size_t>(n) * n;
  const T* A = a + slot * nn;
  T* O = out + slot * nn;
  int* P = piv + slot * n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = rank * NT + tid, gs = ncs * NT;  // thread's index in the cluster
  const int tx = tid % 16, ty = tid / 16;        // micro-tile: rows 4ty+u, cols tx+16v

  // the probe row off the untouched input: a fixed FMA chain per column
  if (w != nullptr) {
    for (int c = g; c < n; c += gs) {
      T s = T(0);
#pragma unroll 8
      for (int r = 0; r < n; ++r) s = fma(w[r], A[static_cast<size_t>(r) * n + c], s);
      wa[slot * n + c] = s;
    }
  }
  for (int r = tid; r < n; r += NT) {
    S.lst[r] = r;
    S.dead[r] = 0;
  }
  __syncthreads();

  const T* src = A;  // the first block reads the input, the others the output
  int cnt = n;       // live rows
  for (int j0 = 0; j0 < n; j0 += KB) {
    const int j1 = min(j0 + KB, n), bw = j1 - j0;
    // 1. the panel: this CTA's list entries [lo, lo + nloc)
    const int ch = (cnt + ncs - 1) / ncs;
    const int lo = min(rank * ch, cnt), nloc = min(ch, cnt - lo);
    // local row li's panel values: shared memory, or (GP) the output,
    // read past L1 as every value a peer may have written
    auto prow = [&](int li) -> T* {
      if constexpr (GP) return O + static_cast<size_t>(S.lst[lo + li]) * n + j0;
      else return S.ps + li * PL;
    };
    auto pget = [](const T* q) -> T {
      if constexpr (GP) return __ldcg(q);
      else return *q;
    };
    if (!GP || src != O) {
      for (int e = tid; e < nloc * KB; e += NT) {
        const int li = e / KB, k = e % KB;
        if (k < bw) prow(li)[k] = __ldcg(src + static_cast<size_t>(S.lst[lo + li]) * n + j0 + k);
      }
    }
    __syncthreads();
    for (int j = 0; j < bw; ++j) {
      const int buf = j & 1;
      T bv = T(-2);
      int br = INT_MAX, bl = -1;
      for (int li = tid; li < nloc; li += NT) {
        const int r = S.lst[lo + li];
        if (S.dead[r]) continue;
        T v = fabs(pget(prow(li) + j));
        if (isnan(v)) v = T(-1);
        if (better(v, r, bv, br)) { bv = v; br = r; bl = li; }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const T ov = __shfl_down_sync(0xffffffffu, bv, off);
        const int orow = __shfl_down_sync(0xffffffffu, br, off);
        const int oloc = __shfl_down_sync(0xffffffffu, bl, off);
        if (better(ov, orow, bv, br)) { bv = ov; br = orow; bl = oloc; }
      }
      if (lane == 0) {  // this warp's partial, for the whole cluster
        S.wval[buf * NW + warp] = bv;
        S.wrow[buf * NW + warp] = br;
        S.wloc[buf * NW + warp] = bl;
      }
      cluster.sync();  // every warp's partial published
      // warp 0 of every CTA reduces the cluster's partials, a lane per
      // (rank, warp) (the order is total: every CTA elects the same row),
      // then copies the pivot row's panel values from its owner's ps (the
      // pivot row is not written again in this block)
      if (warp == 0) {
        T pv = T(-2);
        int p = INT_MAX, qw = 0, lw = -1;
        for (int q = lane; q < ncs * NW; q += 32) {
          const int qr = q / NW, qi = buf * NW + q % NW;
          const T v = *cluster.map_shared_rank(S.wval + qi, qr);
          const int r = *cluster.map_shared_rank(S.wrow + qi, qr);
          if (better(v, r, pv, p)) {
            pv = v;
            p = r;
            qw = qr;
            lw = *cluster.map_shared_rank(S.wloc + qi, qr);
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const T ov = __shfl_down_sync(0xffffffffu, pv, off);
          const int orow = __shfl_down_sync(0xffffffffu, p, off);
          const int oq = __shfl_down_sync(0xffffffffu, qw, off);
          const int ol = __shfl_down_sync(0xffffffffu, lw, off);
          if (better(ov, orow, pv, p)) { pv = ov; p = orow; qw = oq; lw = ol; }
        }
        p = __shfl_sync(0xffffffffu, p, 0);
        qw = __shfl_sync(0xffffffffu, qw, 0);
        lw = __shfl_sync(0xffffffffu, lw, 0);
        if constexpr (GP) {
          if (lane < bw) S.pivr[j * PL + lane] = __ldcg(O + static_cast<size_t>(p) * n + j0 + lane);
        } else {
          S.pivr[j * PL + lane] = *cluster.map_shared_rank(S.ps + lw * PL + lane, qw);
        }
        if (lane == 0) {
          S.pr[j] = p;
          S.dead[p] = 1;
          if (rank == 0) P[j0 + j] = p;
        }
      }
      __syncthreads();  // the pivot row copied
      const T* pj = S.pivr + j * PL;
      const T pivot = pj[j];
      for (int li = tid; li < nloc; li += NT) {
        if (S.dead[S.lst[lo + li]]) continue;  // the pivot and the block's earlier ones
        T* row = prow(li);
        const T l = pget(row + j) / pivot;
        row[j] = l;
        for (int k = j + 1; k < bw; ++k) row[k] = fma(-l, pj[k], pget(row + k));
      }
    }
    __syncthreads();  // the last column's updates done
    // the panel rows back to the output
    if constexpr (!GP) {
      for (int e = tid; e < nloc * KB; e += NT) {
        const int li = e / KB, k = e % KB;
        if (k < bw) O[static_cast<size_t>(S.lst[lo + li]) * n + j0 + k] = S.ps[li * PL + k];
      }
    }
    // 2. the row panel: groups of GR columns dealt to the cluster's warps,
    // lane i holding pivot row i; step j' broadcasts u_j' from lane j'
    for (int first = j1 + (rank * NW + warp) * GR; first < n; first += ncs * NW * GR) {
      T x[GR];
      const bool own = lane < bw;
      const size_t prow = static_cast<size_t>(S.pr[own ? lane : 0]) * n;
#pragma unroll
      for (int r = 0; r < GR; ++r)
        x[r] = (own && first + r < n) ? __ldcg(src + prow + first + r) : T(0);
      for (int jp = 0; jp + 1 < bw; ++jp) {
        const T coef = S.pivr[lane * PL + jp];
#pragma unroll
        for (int r = 0; r < GR; ++r) {
          const T b = __shfl_sync(0xffffffffu, x[r], jp);
          if (lane > jp && own) x[r] = fma(-coef, b, x[r]);
        }
      }
      if (own) {
#pragma unroll
        for (int r = 0; r < GR; ++r)
          if (first + r < n) O[prow + first + r] = x[r];
      }
    }
    // the live list without the block's pivots, in order (warp 0; the same
    // list in every CTA)
    __syncthreads();  // every read of the old list is done
    if (warp == 0) {
      int kept = 0;
      for (int base = 0; base < cnt; base += 32) {
        const int i = base + lane;
        const int r = i < cnt ? S.lst[i] : -1;
        const bool keep = r >= 0 && !S.dead[r];
        const unsigned m = __ballot_sync(0xffffffffu, keep);
        __syncwarp();
        if (keep) S.lst[kept + __popc(m & ((1u << lane) - 1u))] = r;
        kept += __popc(m);
        __syncwarp();
      }
    }
    cnt -= bw;
    // every panel row and the row panel visible to the whole cluster
    cluster.sync();
    // 3. the live rows' trailing columns, tiles round-robin over the cluster
    const int m = n - j1;
    const int tr = (cnt + TI - 1) / TI, tc = (m + TI - 1) / TI, nt = m > 0 ? tr * tc : 0;
    for (int t = rank; t < nt; t += ncs) {
      const int i0 = (t / tc) * TI, k0 = j1 + (t % tc) * TI;
      T cur[4][4], sc[ST], sr[ST];  // the tile and its panels, loaded
#pragma unroll
      for (int s = 0; s < ST; ++s) {
        const int e = tid + s * NT;
        const int ci = e / KB, cj = e % KB;  // multipliers: list entry ci, column cj
        sc[s] = (cj < bw && i0 + ci < cnt)
                    ? __ldcg(O + static_cast<size_t>(S.lst[i0 + ci]) * n + j0 + cj) : T(0);
        const int rj = e / TI, rk = e % TI;  // row panel: pivot row rj, column rk
        sr[s] = (rj < bw && k0 + rk < n)
                    ? __ldcg(O + static_cast<size_t>(S.pr[rj]) * n + k0 + rk) : T(0);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + 4 * ty + u;
        const size_t row = i < cnt ? static_cast<size_t>(S.lst[i]) * n : 0;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int k = k0 + tx + 16 * v;
          cur[u][v] = (i < cnt && k < n) ? __ldcg(src + row + k) : T(0);
        }
      }
      __syncthreads();  // the previous tile is done with the staging
#pragma unroll
      for (int s = 0; s < ST; ++s) {
        const int e = tid + s * NT;
        S.cs[(e % KB) * LD + e / KB] = sc[s];
        S.rs[(e / TI) * LD + e % TI] = sr[s];
      }
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < bw; ++j) {
        T c[4], r[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) c[u] = S.cs[j * LD + 4 * ty + u];
#pragma unroll
        for (int v = 0; v < 4; ++v) r[v] = S.rs[j * LD + tx + 16 * v];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) cur[u][v] = fma(-c[u], r[v], cur[u][v]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + 4 * ty + u;
        if (i >= cnt) continue;
        T* Or = O + static_cast<size_t>(S.lst[i]) * n;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int k = k0 + tx + 16 * v;
          if (k < n) Or[k] = cur[u][v];
        }
      }
    }
    // the trailing rows visible before the next block's panel
    cluster.sync();
    src = O;
  }
}

// The dynamic shared memory at cluster size cs, SIZE_MAX when it does not
// fit (a CTA's share of the panel rows; with GP, the live list alone).
template <typename T, bool GP>
size_t smem_at(int n, int cs) {
  const size_t bytes = smem_layout<T>(n, GP ? 0 : (n + cs - 1) / cs, nullptr, nullptr);
  return bytes <= SMEM_MAX ? bytes : static_cast<size_t>(-1);
}

template <typename T, bool GP>
int pick(int device, int batch, int n) {
  const int tr = (n - KB + TI - 1) / TI;
  const int tiles = n > KB ? tr * tr : 1;
  // the attribute first: the occupancy query reads it
  cudaFuncSetAttribute(batched_lu_kernel<T, GP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       SMEM_MAX);
  // the panel's n elections each wait on the whole cluster: a cluster pays
  // only with 16 or more trailing tiles a CTA, and at most 4 (a partial a
  // lane in the election)
  return conflux::pick_cluster(batched_lu_kernel<T, GP>, device, batch, min(tiles / 16, 4),
                               tiles, NT, [n](int cs) { return smem_at<T, GP>(n, cs); });
}

// The cluster size, and whether the panel rows stay in the output (GP):
// only where no cluster size fits them in shared memory. cs 0: n is too
// large even for the live list.
template <typename T>
int cluster_size(int device, int batch, int n, bool* gp) {
  const int cs = pick<T, false>(device, batch, n);
  *gp = cs == 0;
  return cs > 0 ? cs : pick<T, true>(device, batch, n);
}

template <typename T>
int launch(int device, int batch, int n, const void* a, void* out, int* piv, const void* w,
           void* wa, cudaStream_t stream) {
  bool gp = false;
  const int cs = cluster_size<T>(device, batch, n, &gp);
  if (cs == 0) return cudaErrorInvalidValue;  // n too large for the live list
  auto kernel = gp ? batched_lu_kernel<T, true> : batched_lu_kernel<T, false>;
  const size_t smem = gp ? smem_at<T, true>(n, cs) : smem_at<T, false>(n, cs);
  return conflux::launch_clusters(kernel, batch, cs, NT, smem, stream, n,
                                  static_cast<const T*>(a), static_cast<T*>(out), piv,
                                  static_cast<const T*>(w), static_cast<T*>(wa));
}

}  // namespace

// dtype 0: float32, 1: float64. a, out: (batch, n, n) contiguous of that
// dtype; piv: (batch, n) int32; w: (n,) of that dtype or NULL (no probe
// row); wa: (batch, n) or NULL. out holds the factors in place (rows in
// their input order). Returns the cudaError_t of the launch
// (cudaErrorInvalidValue when the live list of n rows does not fit a CTA's
// shared memory: n above 42096 in float32, 37760 in float64).
extern "C" int conflux_batched_lu(int dtype, int device, int batch, int n, const void* a,
                                  void* out, int* piv, const void* w, void* wa,
                                  void* stream) {
  if (batch <= 0 || n <= 0) return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(device, batch, n, a, out, piv, w, wa, s);
  if (dtype == 1) return launch<double>(device, batch, n, a, out, piv, w, wa, s);
  return cudaErrorInvalidValue;
}

// The launch geometry of conflux_batched_lu for (dtype, batch, n) on
// `device`: writes the block width, the cluster size and whether the
// panel rows stay in global memory (1) or shared memory (0). Returns a
// cudaError_t.
extern "C" int conflux_batched_lu_geometry(int dtype, int device, int batch, int n, int* kb,
                                           int* cs, int* global_panel) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  bool gp = false;
  *kb = KB;
  *cs = dtype == 0 ? cluster_size<float>(device, batch, n, &gp)
                   : cluster_size<double>(device, batch, n, &gp);
  *global_panel = gp ? 1 : 0;
  return *cs > 0 ? cudaSuccess : cudaErrorInvalidValue;
}
