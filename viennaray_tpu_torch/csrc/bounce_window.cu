// The bounce kernel's instantiations for disks under the window flux model
// (DiskWindowKind of disk_hit.cuh): both kFull values and every group size G
// that launch_group holds, each with the chunk search and with the grid search
// (bounce_kernel.cuh, bounce.cu).
#include "bounce_kernel.cuh"

int vr_bounce::launch_window(bool full, int group, cudaStream_t s,
                             const BounceArgs& a) {
  return launch_kind<DiskWindowKind>(full, group, s, a);
}
