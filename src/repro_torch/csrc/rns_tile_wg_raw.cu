// The 64-row wgmma + TMA instances of the tile kernel (rns_tile_wg.cuh)
// for the raw signed int8 A operand with encoded (C, K, N) weights, C <= 7:
// the broadcast rns_matmul and the raw-int8 rns_fused_matmul /
// rns_fused_crt_partial at M > 16 (replaces src/repro/kernels/rns_matmul.py:
// rns_matmul with signed_a and src/repro/kernels/rns_fused.py:
// rns_fused_matmul with an int8 block).
#include "rns_tile_wg.cuh"

int rns_launch_tile_wg_raw(const TileArgs& a, const FusedPlan& plan,
                           cudaStream_t stream) {
  return rns::launch_tile_wg<true>(a, plan, stream);
}
