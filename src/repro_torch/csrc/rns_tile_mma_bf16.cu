// The 32-row tensor-core instances of the tile kernel (rns_common.cuh)
// whose A operand is bfloat16 activations quantized in the prologue: the
// quantize form of rns_fused_matmul and rns_fused_crt_partial at M > 16
// (replaces src/repro/kernels/rns_fused.py: rns_fused_matmul with
// quantize=True), encoded or live weights, C <= 7.
#include "rns_common.cuh"

int rns_launch_tile_mma_bf16(const TileArgs& a, const FusedPlan& plan,
                             cudaStream_t stream) {
  return rns::launch_tile<rns::TM_MMA, rns::A_BF16>(a, plan, stream);
}
