// Instances of the tile kernel (rns_common.cuh) whose A operand is int8:
// one raw signed plane shared by every channel (the broadcast form of
// rns_matmul, replacing src/repro/kernels/rns_matmul.py: rns_matmul with
// signed_a) or C canonical residue planes (the residue-in forms of
// rns_fused_matmul and the canonical form of rns_matmul).  Weights are
// always encoded residues here.
#include "rns_common.cuh"

int rns_launch_tile_int8(int amode, const TileArgs& a, const FusedPlan& plan,
                         cudaStream_t stream) {
  if (amode == rns::A_SHARED) {
    return rns::launch_tile<rns::TM, rns::A_SHARED>(a, plan, stream);
  }
  return rns::launch_tile<rns::TM, rns::A_PLANES>(a, plan, stream);
}
