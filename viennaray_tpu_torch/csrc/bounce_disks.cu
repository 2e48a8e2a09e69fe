// The bounce kernel's instantiations for disks under the neighbor flux
// model (DiskKind of disk_hit.cuh): both kFull values and every group size G
// that launch_group holds, each with the chunk search and with the grid search
// (bounce_kernel.cuh, bounce.cu).
#include "bounce_kernel.cuh"

int vr_bounce::launch_disks(bool full, int group, cudaStream_t s,
                            const BounceArgs& a) {
  return launch_kind<DiskKind>(full, group, s, a);
}
