// The 16-row instances of rns_tile_f32.cu's mode for channel counts
// above rns::SPLIT_C, in a file of their own so that they compile in
// parallel with the narrower ones.
#include "rns_common.cuh"

int rns_launch_tile_f32_wide(const TileArgs& a, const FusedPlan& plan,
                             cudaStream_t stream) {
  return rns::launch_tile<rns::TM, rns::A_F32, rns::SPLIT_C + 1, 11>(
      a, plan, stream);
}
