// Instances of the tile kernel (rns_common.cuh) whose A operand is
// float32 activations quantized in the prologue: the quantize form
// of rns_fused_matmul (replaces src/repro/kernels/rns_fused.py:
// rns_fused_matmul with quantize=True), encoded or live weights.
#include "rns_common.cuh"

int rns_launch_tile_f32(const TileArgs& a, const FusedPlan& plan,
                        cudaStream_t stream) {
  return rns::launch_tile<rns::TM, rns::A_F32>(a, plan, stream);
}
