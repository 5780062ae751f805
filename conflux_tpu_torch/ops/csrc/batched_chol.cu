// Batched lower Cholesky of (B, n, n) systems, with the probe row
// wA = w^T A of each untouched input.
//
// Replaces the TPU kernel `_pallas_bchol` / `_bchol_kernel` in
// conflux_tpu/ops/pallas_factor.py (public `pallas_cholesky_factor_batched`):
// the factor of every SPD serve plan and of its coalesced factor lane. Per
// slot and column j, with a_jj the running diagonal:
//   - every entry (i, k) with i > j and k > j becomes
//     A[i,k] - (A[i,j] * A[j,k]) / a_jj, three separately rounded steps.
//     The update covers BOTH triangles, as the TPU kernel's does: row j is
//     read from the upper triangle, which earlier columns kept current, so
//     an input whose upper triangle differs from its lower one gives the
//     TPU kernel's result and not that of its lower triangle alone;
//   - column j from the diagonal down becomes A[i,j] / sqrt(a_jj).
// The output is the lower triangle with the strict upper triangle zero.
//
// Bound on an H100: the updates' arithmetic. ~n^3/3 updates per slot
// (1.1e10 at 32 x 1024 x 1024), each a product, an IEEE division and a
// difference, rounded apart; an exact division costs a product by the
// column's reciprocal and two FMA corrections, so an update issues 7
// float32 instructions. Blocked, the traffic is one pass over the trailing
// square per KB columns.
//
// Design: a thread-block cluster of `cs` CTAs per slot (cs from B, n and
// the card: `cluster_launch.cuh`), the running matrix in the output
// buffer, and the updates held back KB columns. Per block J = [j0, j1):
//   1. every CTA of the cluster loads the diagonal block into shared memory
//      and factors it, unscaled, the same in each;
//   2. the column panel below it and the row panel right of it, in groups
//      of GR rows or columns dealt to the cluster's warps: a lane per
//      column (row) of the block, each member a chain over the block whose
//      step-j operand is broadcast from lane j; written back unscaled;
//   3. a cluster barrier (release/acquire: peers' panel writes visible,
//      and every CTA done reading the diagonal block); rank 0 then writes
//      the block out, scaled, with its upper part zero;
//   4. the trailing square in 64 x 64 tiles, dealt round-robin to the
//      cluster's CTAs: each element is loaded once into a 4 x 4 register
//      micro-tile, takes its KB updates in column order from the panels
//      staged in shared memory, and is stored once (in float32 two CTAs
//      share an SM and hide each other's loads; holding the next tile's
//      loads in registers meanwhile spilled at the 128-register cap and
//      was slower);
//   5. a cluster barrier; the next block first scales this block's column
//      panel by sqrt(a_jj) and zeroes its row panel.
// The division takes the fast exact form (`upd_fast`) wherever every
// operand of a tile or group is in its range, and __fdiv_rn elsewhere.
// Every element's value is the same chain of _rn operations as the plain
// version's, whatever KB, cs, the thread or the CTA: the _rn intrinsics
// are never contracted into FMAs, so the kernel and
// `hopper_kernels.batched_chol_plain` agree bit for bit, and a slot's bits
// depend only on its own input. The first block reads the input directly
// (no copy pass). a_jj <= 0 (a slot that is not positive definite) gives
// NaN from the square root in column j of that slot and nowhere else.
// Updating only the lower triangle (half the work) needs a stated
// symmetric-input contract first, and is later work.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cluster_launch.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;      // threads per CTA
constexpr int KB = 32;       // columns per block
constexpr int TI = 64;       // trailing tile edge
constexpr int LD = TI + 4;   // staging row stride
constexpr int ST = KB * TI / NT;  // staged panel values per thread and panel
constexpr int GR = 8;        // panel members per warp group

template <typename T>
struct Rn;

template <>
struct Rn<float> {
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float sqrt(float a) { return __fsqrt_rn(a); }
};

template <>
struct Rn<double> {
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double sqrt(double a) { return __dsqrt_rn(a); }
};

// a - (c * r) / d, each step rounded
template <typename T>
__device__ __forceinline__ T upd(T a, T c, T r, T d) {
  using R = Rn<T>;
  return R::sub(a, R::div(R::mul(c, r), d));
}

// The same value without __fdiv_rn's branch to its slow path, for float
// operands in the middle of the range: with y = RN(1/d) and x = RN(c * r),
// q0 = RN(x * y) and two FMA corrections q' = RN(q + RN(x - q d) y) give
// RN(x / d) (Markstein; the remainders are exact, nothing under- or
// overflows), so the bits are __fdiv_rn's. Many of these interleave where
// the divisions' branches would serialize them. `mid` is the range: c and
// r in [2^-30, 2^31), d in [2^-60, 2^61), so x / d stays far from the
// subnormals and the overflow threshold.
__device__ __forceinline__ bool mid(float v) {
  return ((__float_as_uint(v) >> 23) & 0xffu) - 97u <= 60u;
}
__device__ __forceinline__ bool mid_d(float v) {
  return ((__float_as_uint(v) >> 23) & 0xffu) - 67u <= 120u;
}
__device__ __forceinline__ float upd_fast(float a, float c, float r, float d, float y) {
  const float x = __fmul_rn(c, r);
  const float q0 = __fmul_rn(x, y);
  const float q1 = __fmaf_rn(__fmaf_rn(-q0, d, x), y, q0);
  return __fsub_rn(a, __fmaf_rn(__fmaf_rn(-q1, d, x), y, q1));
}
template <typename T>
constexpr bool kFast = sizeof(T) == sizeof(float);  // float only; double keeps __ddiv_rn

// Warp-level pieces of a block's panels. A lane owns one column (the
// diagonal block, the column panel) or one row (the row panel) of the
// block; the block's width is KB = 32 = the warp.

template <typename T>
__device__ __forceinline__ void load_diag(T (*D)[KB + 1], const T* src, int n, int j0, int bw,
                                          int lane, int warp) {
  for (int i = warp; i < bw; i += NT / 32)
    D[i][lane] = lane < bw ? __ldcg(src + static_cast<size_t>(j0 + i) * n + j0 + lane) : T(1);
  __syncthreads();
}

// The diagonal block factored unscaled: step j updates (i, k), i, k > j.
// Warp w owns rows i = w mod 8, lane k column k; the operands of step j
// (row j, column j, a_jj) are final at step j.
template <typename T, bool FAST>
__device__ __forceinline__ void factor_diag(T (*D)[KB + 1], int bw, int lane, int warp) {
  for (int j = 0; j < bw; ++j) {
    const T d = D[j][j], r = D[j][lane];
    T y = T(0);
    if constexpr (FAST) y = __frcp_rn(d);
    if (lane > j && lane < bw) {
      for (int i = j + 1 + (warp - (j + 1) % (NT / 32) + NT / 32) % (NT / 32); i < bw;
           i += NT / 32) {
        if constexpr (FAST) D[i][lane] = upd_fast(D[i][lane], D[i][j], r, d, y);
        else D[i][lane] = upd(D[i][lane], D[i][j], r, d);
      }
    }
    __syncthreads();
  }
}

// Whether every entry of the factored block is an operand the fast
// division takes: the off-diagonal entries `mid`, the diagonal `mid_d`.
// Each entry is an operand only in its final form, so if the final block
// passes, every step's operands were in range and the fast result is
// exact; otherwise the caller factors the block again the slow way.
__device__ __forceinline__ bool diag_in_range(float (*D)[KB + 1], int bw, int lane, int warp) {
  bool in = true;
  if (lane < bw)
    for (int i = warp; i < bw; i += NT / 32) in = in && (i == lane ? mid_d(D[i][i]) : mid(D[i][lane]));
  return __syncthreads_and(in);
}

// A panel group: GR rows of the column panel (x[r] = a[first + r, j0 +
// lane]) or GR columns of the row panel (x[r] = a[j0 + lane, first + r]);
// members past n hold 1.
template <typename T>
__device__ __forceinline__ void load_group(T (&x)[GR], const T* src, int n, int j0, int first,
                                           bool col, int lane) {
#pragma unroll
  for (int r = 0; r < GR; ++r) {
    if (first + r >= n) {
      x[r] = T(1);
    } else if (col) {
      x[r] = __ldcg(src + static_cast<size_t>(first + r) * n + j0 + lane);
    } else {
      x[r] = src[static_cast<size_t>(j0 + lane) * n + first + r];  // 8 values a lane: L1
    }
  }
}

// Step j of every member: lane l > j takes x = x - (b * coef) / a_jj with
// b the member's value at lane j (final at step j) and coef a_jl (column
// panel) or a_lj (row panel).
template <typename T, bool FAST>
__device__ __forceinline__ void chain_group(T (&x)[GR], const T (*D)[KB + 1], const T* yr,
                                            int bw, bool col, int lane) {
  for (int j = 0; j < bw; ++j) {
    const T d = D[j][j];
    const T coef = col ? D[j][lane] : D[lane][j];
    T y = T(0);
    if constexpr (FAST) y = yr[j];
    const bool act = lane > j && lane < bw;
#pragma unroll
    for (int r = 0; r < GR; ++r) {
      const T b = __shfl_sync(0xffffffffu, x[r], j);
      if (act) {
        if constexpr (FAST) x[r] = upd_fast(x[r], b, coef, d, y);
        else x[r] = upd(x[r], b, coef, d);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT, sizeof(T) == 4 ? 2 : 1)
batched_chol_kernel(int n, const T* __restrict__ a, T* out, const T* __restrict__ w,
                    T* __restrict__ wa) {
  __shared__ T D[KB][KB + 1];   // the diagonal block, factored unscaled
  __shared__ T sq[KB];          // sqrt(a_jj) of the block
  __shared__ T yr[KB];          // RN(1 / a_jj) of the block (float)
  __shared__ __align__(16) T Cs[KB][LD];  // column panel of a tile's rows, [j][i]
  __shared__ __align__(16) T Rs[KB][LD];  // row panel of a tile's columns, [j][k]
  using R = Rn<T>;

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const size_t slot = blockIdx.x / cs;
  const size_t nn = static_cast<size_t>(n) * n;
  const T* A = a + slot * nn;
  T* O = out + slot * nn;
  const int tid = threadIdx.x;
  const int g = rank * NT + tid, gs = cs * NT;  // thread's index in the cluster
  const int lane = tid & 31, warp = tid >> 5;
  const int cw = rank * (NT / 32) + warp, cws = cs * (NT / 32);  // warp's index in the cluster
  const int tx = tid % 16, ty = tid / 16;       // micro-tile: rows 4ty+u, cols tx+16v

  // the probe row off the untouched input: a fixed FMA chain per column
  if (w != nullptr) {
    for (int c = g; c < n; c += gs) {
      T s = T(0);
#pragma unroll 8
      for (int r = 0; r < n; ++r) s = fma(w[r], A[static_cast<size_t>(r) * n + c], s);
      wa[slot * n + c] = s;
    }
  }

  const T* src = A;  // the first block reads the input, the others the output
  for (int j0 = 0; j0 < n; j0 += KB) {
    const int j1 = min(j0 + KB, n), bw = j1 - j0, m = n - j1;
    if (j0 > 0) {
      // the previous block's deferred work: its column panel scaled (a
      // warp per group of rows, a lane per column), its row panel zeroed
      const int p0 = j0 - KB;
      for (int i = j0 + cw * GR; i < n; i += cws * GR) {
#pragma unroll
        for (int r = 0; r < GR; ++r) {
          if (i + r >= n) break;
          T* Oi = O + static_cast<size_t>(i + r) * n + p0 + lane;
          *Oi = R::div(__ldcg(Oi), sq[lane]);
        }
      }
      const int cols = n - j0;
      for (int e = g; e < KB * cols; e += gs)
        O[static_cast<size_t>(p0 + e / cols) * n + j0 + e % cols] = T(0);
    }
    __syncthreads();  // sq read above before it is rewritten below
    // 1. the diagonal block, unscaled (a warp per row mod 8, a lane per column)
    bool dok = false;  // the fast division exact for every operand of the block
    if constexpr (kFast<T>) {
      load_diag(D, src, n, j0, bw, lane, warp);
      factor_diag<T, true>(D, bw, lane, warp);
      dok = diag_in_range(D, bw, lane, warp);
    }
    if (!dok) {
      load_diag(D, src, n, j0, bw, lane, warp);
      factor_diag<T, false>(D, bw, lane, warp);
    }
    if (tid < bw) {
      sq[tid] = R::sqrt(D[tid][tid]);
      if constexpr (kFast<T>) yr[tid] = __frcp_rn(D[tid][tid]);
    }
    __syncthreads();
    // 2. the column panel (groups of GR rows, a lane per column j) and
    // the row panel (groups of GR columns, a lane per row i): each member a
    // chain over the block, the operand of step j broadcast from lane j
    const int groups = (m + GR - 1) / GR;
    for (int q = cw; q < 2 * groups; q += cws) {
      const bool col = q < groups;
      const int first = j1 + (col ? q : q - groups) * GR;
      T x[GR];
      bool ok = false;
      if constexpr (kFast<T>) {
        if (dok) {
          load_group(x, src, n, j0, first, col, lane);
          chain_group<T, true>(x, D, yr, bw, col, lane);
          bool in = true;
#pragma unroll
          for (int r = 0; r < GR; ++r) in = in && mid(x[r]);
          ok = __all_sync(0xffffffffu, in);
        }
      }
      if (!ok) {
        load_group(x, src, n, j0, first, col, lane);
        chain_group<T, false>(x, D, yr, bw, col, lane);
      }
#pragma unroll
      for (int r = 0; r < GR; ++r) {
        if (first + r >= n) break;
        if (col)
          O[static_cast<size_t>(first + r) * n + j0 + lane] = x[r];
        else
          O[static_cast<size_t>(j0 + lane) * n + first + r] = x[r];
      }
    }
    // 3. every panel visible to the whole cluster, and every CTA past its
    // reads of the diagonal block, which rank 0 now overwrites, scaled
    cluster.sync();
    if (rank == 0) {
      for (int e = tid; e < bw * bw; e += NT) {
        const int i = e / bw, k = e % bw;
        O[static_cast<size_t>(j0 + i) * n + j0 + k] =
            k < i ? R::div(D[i][k], sq[k]) : (k == i ? R::div(D[i][i], sq[i]) : T(0));
      }
    }
    // 4. the trailing square, tiles round-robin over the cluster
    const int tr = (m + TI - 1) / TI, nt = tr * tr;
    for (int t = rank; t < nt; t += cs) {
      const int i0 = j1 + (t / tr) * TI, k0 = j1 + (t % tr) * TI;
      T cur[4][4], sc[ST], sr[ST];  // the tile and its panels, loaded
#pragma unroll
      for (int s = 0; s < ST; ++s) {
        const int e = tid + s * NT;
        const int ci = e / KB, cj = e % KB;  // column panel: row ci, column cj
        sc[s] = (cj < bw && i0 + ci < n)
                    ? __ldcg(O + static_cast<size_t>(i0 + ci) * n + j0 + cj) : T(1);
        const int rj = e / TI, rk = e % TI;  // row panel: row rj, column rk
        sr[s] = (rj < bw && k0 + rk < n)
                    ? __ldcg(O + static_cast<size_t>(j0 + rj) * n + k0 + rk) : T(1);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + 4 * ty + u;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int k = k0 + tx + 16 * v;
          cur[u][v] = (i < n && k < n) ? __ldcg(src + static_cast<size_t>(i) * n + k) : T(0);
        }
      }
      __syncthreads();  // the previous tile is done with Cs and Rs
      bool sok = true;  // every staged panel value in range (the pad is 1)
#pragma unroll
      for (int s = 0; s < ST; ++s) {
        const int e = tid + s * NT;
        Cs[e % KB][e / KB] = sc[s];
        Rs[e / TI][e % TI] = sr[s];
        if constexpr (kFast<T>) sok = sok && mid(sc[s]) && mid(sr[s]);
      }
      // the whole tile takes the fast division, or none of it does
      const bool fast = __syncthreads_and(kFast<T> && dok && sok);
      if constexpr (kFast<T>) {
        if (fast) {
#pragma unroll 2
          for (int j = 0; j < bw; ++j) {
            const T d = D[j][j], y = yr[j];
            T c[4], r[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) c[u] = Cs[j][4 * ty + u];
#pragma unroll
            for (int v = 0; v < 4; ++v) r[v] = Rs[j][tx + 16 * v];
#pragma unroll
            for (int u = 0; u < 4; ++u)
#pragma unroll
              for (int v = 0; v < 4; ++v) cur[u][v] = upd_fast(cur[u][v], c[u], r[v], d, y);
          }
        }
      }
      if (!fast) {
#pragma unroll 2
        for (int j = 0; j < bw; ++j) {
          const T d = D[j][j];
          T c[4], r[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) c[u] = Cs[j][4 * ty + u];
#pragma unroll
          for (int v = 0; v < 4; ++v) r[v] = Rs[j][tx + 16 * v];
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int v = 0; v < 4; ++v) cur[u][v] = upd(cur[u][v], c[u], r[v], d);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + 4 * ty + u;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int k = k0 + tx + 16 * v;
          if (i < n && k < n) O[static_cast<size_t>(i) * n + k] = cur[u][v];
        }
      }
    }
    // 5. the trailing square visible before the next block's panels
    cluster.sync();
    src = O;
  }
}

// The first trailing square's tiles: more CTAs than that would idle.
int first_tiles(int n) {
  const int tr = (n - KB + TI - 1) / TI;
  return n > KB ? tr * tr : 1;
}

template <typename T>
int cluster_size(int device, int batch, int n) {
  const int tiles = first_tiles(n);
  return conflux::pick_cluster(batched_chol_kernel<T>, device, batch, tiles, tiles, NT,
                               [](int) { return size_t(0); });
}

template <typename T>
int launch(int device, int batch, int n, const void* a, void* out, const void* w, void* wa,
           cudaStream_t stream) {
  const int cs = cluster_size<T>(device, batch, n);
  if (cs == 0) return cudaErrorInvalidConfiguration;
  return conflux::launch_clusters(batched_chol_kernel<T>, batch, cs, NT, 0, stream, n,
                                  static_cast<const T*>(a), static_cast<T*>(out),
                                  static_cast<const T*>(w), static_cast<T*>(wa));
}

}  // namespace

// dtype 0: float32, 1: float64. a, out: (batch, n, n) contiguous of that
// dtype; w: (n,) of that dtype or NULL (no probe row); wa: (batch, n) or
// NULL. out receives the lower Cholesky factors, strict upper triangles
// zero. Returns the cudaError_t of the launch.
extern "C" int conflux_batched_chol(int dtype, int device, int batch, int n, const void* a,
                                    void* out, const void* w, void* wa, void* stream) {
  if (batch <= 0 || n <= 0) return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(device, batch, n, a, out, w, wa, s);
  if (dtype == 1) return launch<double>(device, batch, n, a, out, w, wa, s);
  return cudaErrorInvalidValue;
}

// The launch geometry of conflux_batched_chol for (dtype, batch, n) on
// `device`: writes the block width, the cluster size and 0 to
// global_panel (the panels are staged in shared memory at every n).
// Returns a cudaError_t.
extern "C" int conflux_batched_chol_geometry(int dtype, int device, int batch, int n, int* kb,
                                             int* cs, int* global_panel) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  *kb = KB;
  *global_panel = 0;
  *cs = dtype == 0 ? cluster_size<float>(device, batch, n) : cluster_size<double>(device, batch, n);
  return *cs > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}
