// The bounce kernel's instantiations for 2D line segments (LineKind of
// line_hit.cuh): both kFull values and every group size G that launch_group
// holds (bounce_kernel.cuh, bounce.cu); the chunk search only, as lines have
// no grid.
#include "bounce_kernel.cuh"

int vr_bounce::launch_lines(bool full, int group, cudaStream_t s,
                            const BounceArgs& a) {
  return launch_kind<LineKind, false>(full, group, s, a);
}
