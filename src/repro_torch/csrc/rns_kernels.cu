// Hand-written Hopper (sm_90a) kernels of the twit-RNS port: the elementwise
// kernels and the C interface of the library (`kernels/_build.py` loads it
// with ctypes).  The tile kernel behind rns_fused_matmul and rns_matmul is
// in rns_common.cuh, instantiated by the rns_tile_*.cu files.
//
//   rns_forward — replaces src/repro/kernels/rns_convert.py: rns_forward, the
//     floored x mod m_c per channel (weight encode, activation encode, the
//     staged path's per-call weight conversion).
//   rns_reverse — replaces src/repro/kernels/rns_convert.py: rns_reverse, the
//     standalone MRC reverse: digits, 15-bit limb Horner, signed fix,
//     float32, optional fused scale multiply.
//   rns_modmul — replaces src/repro/kernels/rns_modmul.py: rns_modmul, the
//     elementwise |a*b|_m: one int32 product and the plan's fold ladder.
//   rns_fold — replaces src/repro/kernels/fold.py: fold, the standalone
//     Stage-4 ladder that canonicalizes (C, S) int32 values in [0, bound)
//     per channel (ChannelPlan.build(moduli, bound), unsigned).
//
// All four read and write each element once and do a few dozen integer
// operations on it: device memory bounds them.  rns_forward, rns_reverse
// and rns_modmul are grid-stride loops over contiguous elements
// (neighbouring threads on neighbouring addresses).  rns_fold streams: a
// grid of a few waves, 16-byte loads and stores, several in flight per
// thread, and the channel's ladder in registers.  Every entry returns
// cudaGetLastError() after its launch.

#include "rns_common.cuh"

struct ForwardMods {
  int C;
  int m[rns::MAXC];
};

namespace {

using rns::floor_mod;

template <typename IT, typename OT>
__global__ void rns_forward_kernel(const IT* __restrict__ x,
                                   OT* __restrict__ out, long long S,
                                   ForwardMods mods) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < S; i += stride) {
    const int v = static_cast<int>(x[i]);
#pragma unroll
    for (int c = 0; c < rns::MAXC; ++c) {
      if (c < mods.C) out[c * S + i] = static_cast<OT>(floor_mod(v, mods.m[c]));
    }
  }
}

template <int C>
__global__ void rns_reverse_kernel(const int* __restrict__ res,
                                   const float* __restrict__ scale,
                                   float* __restrict__ out, long long S,
                                   FusedPlan plan) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < S; i += stride) {
    int r[C];
#pragma unroll
    for (int c = 0; c < C; ++c) r[c] = res[c * S + i];
    const float v = rns::mrc_value<C>(r, plan);
    out[i] = scale ? __fmul_rn(v, scale[i]) : v;
  }
}

// Unsigned plans only (canonical factors): fold_channel with is_signed = 0.
template <typename T>
__global__ void rns_modmul_kernel(const T* __restrict__ a,
                                  const T* __restrict__ b,
                                  int* __restrict__ out, long long S,
                                  FusedPlan plan) {
  const int c = blockIdx.y;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < S; i += stride) {
    const long long at = c * S + i;
    const int p = static_cast<int>(a[at]) * static_cast<int>(b[at]);
    out[at] = rns::fold_channel(p, c, plan);
  }
}

constexpr int FOLD_THREADS = 256;
constexpr int FOLD_UNROLL = 4;   // 16-byte loads in flight per thread

// Unsigned plans only: values in [0, bound), one channel per grid row.
// A row whose input and output share their offset within 16 bytes (any
// row of an aligned tensor) streams as int4 loads and stores,
// FOLD_UNROLL in flight per thread, its ragged head and tail (< 4
// elements each) folded one by one; any other row is folded one element
// at a time.  Index math is 32-bit within a channel (S < 2^31).
__global__ void __launch_bounds__(FOLD_THREADS)
rns_fold_kernel(const int* __restrict__ x, int* __restrict__ out, int S,
                FusedPlan plan) {
  const int ch = blockIdx.y;
  const rns::ChannelLadder fold(plan, ch);
  const int* xc = x + static_cast<size_t>(ch) * S;
  int* oc = out + static_cast<size_t>(ch) * S;
  const int tid = blockIdx.x * FOLD_THREADS + threadIdx.x;
  const int nthreads = gridDim.x * FOLD_THREADS;
  const unsigned mis = static_cast<unsigned>(
      reinterpret_cast<uintptr_t>(xc) & 15u);
  if (mis != (reinterpret_cast<uintptr_t>(oc) & 15u)) {
    for (int i = tid; i < S; i += nthreads) oc[i] = fold(xc[i]);
    return;
  }
  const int head = min(S, static_cast<int>(((16u - mis) & 15u) >> 2));
  const int n4 = (S - head) >> 2;
  const int tail = head + 4 * n4;
  if (tid < head) oc[tid] = fold(xc[tid]);
  if (tid < S - tail) oc[tail + tid] = fold(xc[tail + tid]);
  const int4* xv = reinterpret_cast<const int4*>(xc + head);
  int4* ov = reinterpret_cast<int4*>(oc + head);
  const int step = nthreads * FOLD_UNROLL;
  for (int i0 = blockIdx.x * FOLD_THREADS * FOLD_UNROLL + threadIdx.x;
       i0 < n4; i0 += step) {
    int4 v[FOLD_UNROLL];
#pragma unroll
    for (int u = 0; u < FOLD_UNROLL; ++u) {
      const int i = i0 + u * FOLD_THREADS;
      if (i < n4) v[u] = __ldcs(xv + i);
    }
#pragma unroll
    for (int u = 0; u < FOLD_UNROLL; ++u) {
      const int i = i0 + u * FOLD_THREADS;
      if (i < n4) {
        __stcs(ov + i, make_int4(fold(v[u].x), fold(v[u].y), fold(v[u].z),
                                 fold(v[u].w)));
      }
    }
  }
}

}  // namespace

extern "C" {

// One launch of the tile kernel.  amode is an rns::AMode, a and plan are
// the operand and plan structs, a->tm the tile height (rns::TM or
// rns::TM_MMA).  Returns 0, a cudaError_t, or -1 for an unsupported
// channel count, mode or height.
int rns_tile_launch(int amode, const TileArgs* a, const FusedPlan* plan,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->tm == rns::TM_MMA) {
    switch (amode) {
      case rns::A_F32:
        return rns_launch_tile_mma_f32(*a, *plan, s);
      case rns::A_BF16:
        return rns_launch_tile_mma_bf16(*a, *plan, s);
      case rns::A_SHARED:
      case rns::A_PLANES:
        return rns_launch_tile_mma_int8(amode, *a, *plan, s);
      default:
        return -1;
    }
  }
  if (a->tm != rns::TM) return -1;
  switch (amode) {
    case rns::A_F32:
      return rns_launch_tile_f32(*a, *plan, s);
    case rns::A_BF16:
      return rns_launch_tile_bf16(*a, *plan, s);
    case rns::A_SHARED:
    case rns::A_PLANES:
      return rns_launch_tile_int8(amode, *a, *plan, s);
    default:
      return -1;
  }
}

// Dynamic shared memory, in bytes, of the 16-row tile instance for mode
// amode, C channels and encoded (1) or live (0) weights; 0 if none.
int rns_tile16_smem(int amode, int C, int encoded) {
  switch (amode) {
    case rns::A_F32:
      return rns::tile16_smem_bytes<rns::A_F32>(C, encoded);
    case rns::A_BF16:
      return rns::tile16_smem_bytes<rns::A_BF16>(C, encoded);
    case rns::A_SHARED:
      return rns::tile16_smem_bytes<rns::A_SHARED>(C, encoded);
    case rns::A_PLANES:
      return rns::tile16_smem_bytes<rns::A_PLANES>(C, encoded);
    default:
      return 0;
  }
}

// x: S int8 (x_int32 = 0) or int32 values; out: (C, S) int8 (out_int32 = 0)
// or int32 canonical residues.
int rns_forward_launch(const void* x, int x_int32, void* out, int out_int32,
                       long long S, const ForwardMods* mods, int blocks,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_int32) {
    if (out_int32) {
      rns_forward_kernel<int32_t, int32_t><<<blocks, 256, 0, s>>>(
          static_cast<const int32_t*>(x), static_cast<int32_t*>(out), S, *mods);
    } else {
      rns_forward_kernel<int32_t, int8_t><<<blocks, 256, 0, s>>>(
          static_cast<const int32_t*>(x), static_cast<int8_t*>(out), S, *mods);
    }
  } else {
    if (out_int32) {
      rns_forward_kernel<int8_t, int32_t><<<blocks, 256, 0, s>>>(
          static_cast<const int8_t*>(x), static_cast<int32_t*>(out), S, *mods);
    } else {
      rns_forward_kernel<int8_t, int8_t><<<blocks, 256, 0, s>>>(
          static_cast<const int8_t*>(x), static_cast<int8_t*>(out), S, *mods);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// res: (C, S) int32 canonical residues; scale: (S,) f32 or null; out: (S,)
// f32.  plan carries the moduli, the MRC inverse table and the limb
// constants (its fold fields are unused).
int rns_reverse_launch(const int* res, const float* scale, float* out,
                       long long S, const FusedPlan* plan, int blocks,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RNS_REVERSE_CASE(CC)                                          \
  case CC:                                                            \
    rns_reverse_kernel<CC><<<blocks, 256, 0, s>>>(res, scale, out, S, \
                                                  *plan);             \
    break;
  switch (plan->C) {
    RNS_REVERSE_CASE(3)
    RNS_REVERSE_CASE(4)
    RNS_REVERSE_CASE(5)
    RNS_REVERSE_CASE(6)
    RNS_REVERSE_CASE(7)
    RNS_REVERSE_CASE(8)
    RNS_REVERSE_CASE(9)
    RNS_REVERSE_CASE(10)
    RNS_REVERSE_CASE(11)
    default:
      return -1;
  }
#undef RNS_REVERSE_CASE
  return static_cast<int>(cudaGetLastError());
}

// a, b: (C, S) int8 (is_int32 = 0) or int32 residues; out: (C, S) int32.
int rns_modmul_launch(const void* a, const void* b, int is_int32, int* out,
                      long long S, const FusedPlan* plan, int blocks,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(blocks, plan->C);
  if (is_int32) {
    rns_modmul_kernel<int32_t><<<grid, 256, 0, s>>>(
        static_cast<const int32_t*>(a), static_cast<const int32_t*>(b), out, S,
        *plan);
  } else {
    rns_modmul_kernel<int8_t><<<grid, 256, 0, s>>>(
        static_cast<const int8_t*>(a), static_cast<const int8_t*>(b), out, S,
        *plan);
  }
  return static_cast<int>(cudaGetLastError());
}

// x, out: (C, S) int32, S < 2^31; plan carries the moduli and the fold
// ladder.  blocks: the grid's blocks per channel.
int rns_fold_launch(const int* x, int* out, int S, const FusedPlan* plan,
                    int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  rns_fold_kernel<<<dim3(blocks, plan->C), FOLD_THREADS, 0, s>>>(x, out, S,
                                                                 *plan);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
