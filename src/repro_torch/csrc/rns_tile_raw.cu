// Instances of the tile kernel (rns_common.cuh) whose A operand is one
// raw signed int8 (M, K) plane shared by every channel: the broadcast form
// of rns_matmul (replaces src/repro/kernels/rns_matmul.py: rns_matmul
// with signed_a) and the raw-int8 forms of rns_fused_matmul and
// rns_fused_crt_partial (replaces src/repro/kernels/rns_fused.py:
// rns_fused_matmul and rns_fused_crt_partial with quantize=False on an
// int8 block), encoded or live weights, every slice width.
// Channel counts up to rns::SPLIT_C; the wider ones are in
// rns_tile_raw_wide.cu.
#include "rns_common.cuh"

int rns_launch_tile_raw(const TileArgs& a, const FusedPlan& plan,
                        cudaStream_t stream) {
  return rns::launch_tile<rns::TM, rns::A_SHARED, 1, rns::SPLIT_C>(
      a, plan, stream);
}
