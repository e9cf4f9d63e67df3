// Instances of the tile kernel (rns_common.cuh) whose A operand is the C
// canonical int8 residue planes of an activation: the residue-in forms of
// rns_fused_matmul and rns_fused_crt_partial and the canonical form of
// rns_matmul (replaces src/repro/kernels/rns_matmul.py: rns_matmul and
// the residue-in src/repro/kernels/rns_fused.py: rns_fused_matmul).
// Weights are always encoded residues here.
// Channel counts up to rns::SPLIT_C; the wider ones are in
// rns_tile_int8_wide.cu.
#include "rns_common.cuh"

int rns_launch_tile_int8(const TileArgs& a, const FusedPlan& plan,
                         cudaStream_t stream) {
  return rns::launch_tile<rns::TM, rns::A_PLANES, 1, rns::SPLIT_C>(
      a, plan, stream);
}
