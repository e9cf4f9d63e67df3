// Shared parts of the four routes of flash attention (flash_attention.cu,
// flash_split.cu, flash_mma.cu, flash_wide.cu): the launch operands, the conversions and
// warp reductions, and each route's launcher.  The semantics are those of
// `kernels/ref.attention_ref`; flash_attention.cu's header gives them.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Operands of one launch (mirrors `FlashArgs` in kernels/_build.py).
struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  const int* pad;    // (B,) left-pad counts, or null
  const int* qpos;   // (B, Sq) explicit query positions, or null
  const int* kpos;   // (B, Sk) explicit key positions, or null
  int B, H, Sq, Sk, D;
  int causal, has_window, window, has_softcap, bf16;
  float scale, softcap;
  int route;         // flash::Route
  int splits;        // route SPLIT: cluster size S (1..8), the grid's x
};

namespace flash {

// The kernel a launch runs (`kernels/flash_attention.py::ROUTES`).
enum Route : int {
  SPLIT = 0,  // Sq <= 16, both types: keys split over a thread-block cluster
  MMA = 1,    // Sq > 16, bf16: mma.sync tensor cores
  FMA = 2,    // Sq > 16, float32: float32 FMAs on the CUDA cores
  WIDE = 3,   // D > 256, any Sq, both types: D in chunks of WIDE_CHUNK
};

constexpr float NEG_INF = -1e30f;
constexpr int MAX_SPLITS = 8;     // the portable cluster size
constexpr int SPLIT_TILE = 64;    // keys: the unit the key split shares out
constexpr int SPLIT_MAX_ROWS = 16;
constexpr int WIDE_CHUNK = 128;   // route WIDE: D is a multiple of it

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(~0u, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
  return x;
}

// The score of one (row, key) after the scale and the softcap, as the
// plain version computes it.
__device__ __forceinline__ float scaled(float s, const FlashArgs& a) {
  float x = __fmul_rn(s, a.scale);
  if (a.has_softcap) {
    x = __fmul_rn(tanhf(__fdiv_rn(x, a.softcap)), a.softcap);
  }
  return x;
}

// Whether a key at position kp (-1: invalid) is attended by a query at qp.
__device__ __forceinline__ bool attends(int qp, int kp, int pad,
                                        bool explicit_pos,
                                        const FlashArgs& a) {
  bool ok = kp >= pad;
  if (explicit_pos) ok = ok && kp >= 0 && qp >= 0;
  if (a.causal) ok = ok && kp <= qp;
  if (a.has_window) ok = ok && kp > qp - a.window;
  return ok;
}

}  // namespace flash

// One launch of a route; each returns 0, a cudaError_t, or -1 for a head
// size, type or query count the route does not take.
int flash_launch_split(const FlashArgs& a, cudaStream_t stream);
int flash_launch_mma(const FlashArgs& a, cudaStream_t stream);
int flash_launch_wide(const FlashArgs& a, cudaStream_t stream);
