// The 64-row wgmma + TMA instances of the tile kernel (rns_tile_wg.cuh)
// for the raw signed int8 A operand with a live (K, N) int8 weight, reduced
// to |w|_{m_c} per channel by the producer warpgroup, C <= 7 (replaces
// src/repro/kernels/rns_fused.py: rns_fused_matmul and
// rns_fused_crt_partial with an int8 block and a raw weight).
#include "rns_tile_wg.cuh"

int rns_launch_tile_wg_raw_live(const TileArgs& a, const FusedPlan& plan,
                                cudaStream_t stream) {
  return rns::launch_tile_wg<false>(a, plan, stream);
}
