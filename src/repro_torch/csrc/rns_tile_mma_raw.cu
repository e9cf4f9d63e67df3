// The 32-row tensor-core instances of the tile kernel (rns_common.cuh)
// whose A operand is one raw signed int8 (M, K) plane shared by every
// channel: the broadcast form of rns_matmul and the raw-int8 forms of
// rns_fused_matmul and rns_fused_crt_partial at M > 16 (replaces
// src/repro/kernels/rns_matmul.py: rns_matmul with signed_a and
// src/repro/kernels/rns_fused.py: rns_fused_matmul with an int8 block),
// encoded or live weights, C <= 7.
#include "rns_common.cuh"

int rns_launch_tile_mma_raw(const TileArgs& a, const FusedPlan& plan,
                            cudaStream_t stream) {
  return rns::launch_tile<rns::TM_MMA, rns::A_SHARED>(a, plan, stream);
}
