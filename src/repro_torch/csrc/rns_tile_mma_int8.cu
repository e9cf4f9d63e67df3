// The 32-row tensor-core instances of the tile kernel (rns_common.cuh)
// whose A operand is the C canonical int8 residue planes of an
// activation: the canonical form of rns_matmul and the residue-in forms
// of rns_fused_matmul and rns_fused_crt_partial at M > 16 (replaces
// src/repro/kernels/rns_matmul.py: rns_matmul and the residue-in
// src/repro/kernels/rns_fused.py: rns_fused_matmul), C <= 7.
#include "rns_common.cuh"

int rns_launch_tile_mma_int8(const TileArgs& a, const FusedPlan& plan,
                             cudaStream_t stream) {
  return rns::launch_tile<rns::TM_MMA, rns::A_PLANES>(a, plan, stream);
}
