// CPU emulation of the cluster part of <cooperative_groups.h> that the
// port's kernels use, for tests/test_torch_kernel_emu.py: the CTAs of a
// cluster run at once (cuda_runtime.h, cudaLaunchKernelEx), meet at
// sync(), and reach each other's shared memory by rank.
#pragma once

#include "cuda_runtime.h"

namespace cooperative_groups {

struct cluster_group {
  void sync() const { emu_cluster_barrier->arrive_and_wait(); }
  unsigned block_rank() const { return emu_cluster_rank; }
  // the object at p in this CTA's shared memory, in CTA `rank`'s
  template <class T>
  T* map_shared_rank(T* p, unsigned rank) const {
    const auto off = reinterpret_cast<const unsigned char*>(p) - emu_smem;
    return reinterpret_cast<T*>(emu_cluster_smem[rank] + off);
  }
};

inline cluster_group this_cluster() { return {}; }

}  // namespace cooperative_groups
