// Launch of a batched factor kernel as one thread-block cluster per slot
// (batched_lu.cu, batched_chol.cu).
//
// The cluster size cs splits a slot's work, never a chain of roundings, so
// it changes no bit; it only decides how the batch fills the card. A
// cluster's CTAs must be resident at once on the SMs of one GPC, so how
// many clusters run together depends on the kernel's registers and shared
// memory and on the card: the occupancy API says. cs is the size, of 1, 2,
// 4 and 8 up to the kernel's cap, whose waves of clusters ceil(B /
// active(cs)) over cs take the least time. On a tie the larger cs wins
// while each of its CTAs keeps 16 or more tiles of the slot's first
// trailing square (the trailing work, which splits, dominates), else the
// smaller (the per-block work, which does not split, dominates).

#pragma once

#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <tuple>

namespace conflux {

template <typename Kernel>
int active_clusters(Kernel kernel, int device, int cs, int nt, size_t smem) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int, size_t>, int> cache;  // guarded-by: mu
  const auto key = std::make_tuple(reinterpret_cast<const void*>(kernel), device, cs, smem);
  {
    std::lock_guard<std::mutex> lock(mu);
    auto it = cache.find(key);
    if (it != cache.end()) return it->second;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(cs));
  cfg.blockDim = dim3(nt);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int active = 0;
  if (cudaOccupancyMaxActiveClusters(&active, kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();  // a size the kernel cannot take: not a candidate
    active = 0;
  }
  std::lock_guard<std::mutex> lock(mu);
  cache[key] = active;
  return active;
}

// The cluster size for `batch` slots, up to `cap` (further only where a
// smaller size does not fit); `tiles` are the first trailing square's
// tiles; smem_of(cs) is the kernel's dynamic shared memory at that size
// (SIZE_MAX: does not fit). Returns 0 if no size can run.
template <typename Kernel, typename SmemOf>
int pick_cluster(Kernel kernel, int device, int batch, int cap, int tiles, int nt,
                 SmemOf smem_of) {
  int best = 0;
  double best_cost = 0.0;
  for (int cs = 1; cs <= 8; cs *= 2) {
    if (cs > 1 && cs > cap && best != 0) break;
    const size_t smem = smem_of(cs);
    if (smem == static_cast<size_t>(-1)) continue;
    const int active = active_clusters(kernel, device, cs, nt, smem);
    if (active <= 0) continue;
    const double cost = static_cast<double>((batch + active - 1) / active) / cs;
    if (best == 0 || cost < best_cost || (cost == best_cost && tiles >= 16 * cs)) {
      best = cs;
      best_cost = cost;
    }
  }
  return best;
}

template <typename Kernel, typename... Args>
cudaError_t launch_clusters(Kernel kernel, int batch, int cs, int nt, size_t smem,
                            cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(batch) * cs);
  cfg.blockDim = dim3(nt);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace conflux
