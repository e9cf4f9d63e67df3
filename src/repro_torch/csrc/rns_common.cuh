// Shared device code of the twit-RNS port's Hopper (sm_90a) kernels: the
// plan tables, the fold ladder, the MRC/limb-Horner reverse and the tiled
// channel-product kernel that the fused linear (`rns_fused_matmul`) and the
// staged channel matmul (`rns_matmul`) both instantiate.  Each .cu file of
// `csrc/` instantiates a share of the templates, so the files compile in
// parallel; `kernels/_build.py` links them into one library.
//
// The tile kernel replaces two Pallas kernels:
//   src/repro/kernels/rns_fused.py: rns_fused_matmul (body _kernel), with
//     the quantize prologue (float activations rounded/clipped by the row
//     scale) or the residue-in prologue (the (C, M, K) canonical residues of
//     an activation, optionally times |gate|_m), and the float-emit or
//     in-domain requantize (emit="residues") epilogue;
//   src/repro/kernels/rns_matmul.py: rns_matmul, the per-channel product of
//     a broadcast signed (1, M, K) or canonical (C, M, K) int8 operand with
//     (C, K, N) residues, written as (C, M, N) canonical int32 residues;
//   src/repro/kernels/rns_fused.py: rns_fused_crt_partial, the same
//     prologues on a channel slice of the basis (C = 1 and 2 included),
//     whose epilogue writes the CRT partial sum Σ_j |r_j·v_j|_{m_j}·(M/m_j)
//     as (L1, M, N) int32 15-bit limb planes (EMIT_CRT_LIMBS).
//
// What bounds it on an H100: at decode (M <= 64 rows) a launch reads C int8
// residues per weight, C*K*N bytes, and does C*M*K*N multiply-adds: far
// below the int8 rate, so device memory bounds it.  The design answers that
// with a grid wide enough to keep every SM streaming weights: when the
// (M/16)x(N/64) output tiles are fewer than the SMs, the K loop is split
// across blocks, each block adds its int32 partial sums into a zeroed
// workspace with atomics (integer sums, so the order is irrelevant and the
// result exact), and the last block of a tile runs the epilogue.
//
// Integer stages are exact.  The float stages replay the reference's op
// order with explicit round-to-nearest intrinsics, and every file is built
// without --use_fast_math, so no contraction or approximate divide changes
// a bit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace rns {

constexpr int MAXC = 12;   // channels (the paper's odd moduli give <= 11)
constexpr int MAXR = 8;    // fold-ladder rungs (plans are built with <= 6)
constexpr int MAXL = 6;    // 15-bit limbs of the dynamic range
constexpr int LIMB_BITS = 15;
constexpr int LIMB_MASK = (1 << LIMB_BITS) - 1;

constexpr int TM = 16;     // output rows per block
constexpr int TN = 64;     // output columns per block
constexpr int TK = 32;     // K step staged in shared memory
constexpr int KPAD = TK + 4;   // 36-byte rows: conflict-free int32 reads
constexpr int THREADS = 256;   // thread t owns column t%64, rows t/64 + 4i
static_assert(TM * TK % THREADS == 0 && TK * TN / 4 % THREADS == 0,
              "tile loads must divide evenly among the threads");

// How the A operand of the tile kernel arrives.
enum AMode : int {
  A_F32 = 0,    // (M, K) float32, quantized in the prologue
  A_BF16 = 1,   // (M, K) bfloat16, quantized in the prologue
  A_SHARED = 2, // (M, K) raw signed int8 shared by every channel
  A_PLANES = 3, // (C, M, K) int8 canonical residues, one plane per channel
};

// What the tile kernel writes.
enum Emit : int {
  EMIT_FLOAT = 0,     // (M, N) f32: MRC reverse, (y*s_row)*s_col
  EMIT_RESIDUES = 1,  // (C, M, N) int8: MRC, in-domain requantize, |q|_m
  EMIT_CANONICAL = 2, // (C, M, N) int32: the folded channel residues
  EMIT_CRT_LIMBS = 3, // (L1, M, N) int32: CRT partial sum of a slice
};

}  // namespace rns

// Plan tables, passed by value as a kernel argument (mirrors the ctypes
// Structure `_Plan` in kernels/_build.py field for field).
struct FusedPlan {
  int C, R, n_sub, L, is_signed;
  int mods[rns::MAXC];
  int sched_s[rns::MAXC][rns::MAXR];
  int sched_c[rns::MAXC][rns::MAXR];
  int inv[rns::MAXC][rns::MAXC];
  int M_limbs[rns::MAXL];
  int half_limbs[rns::MAXL];
  // CRT partial epilogue of a channel slice: limb count of the planes,
  // v_j = |(M/m_j)^-1|_{m_j} and the 15-bit limbs of M/m_j per channel.
  int L1;
  int crt_v[rns::MAXC];
  int crt_mc[rns::MAXC][rns::MAXL];
};

// Operands of one tile-kernel launch (mirrors `_TileArgs`).
struct TileArgs {
  const void* x;         // A operand, see AMode
  const float* srow;     // (M,) row scale: quantize divisor, float dequant
  const int8_t* gate;    // (M, K) raw int8 gate of A_PLANES, or null
  const int8_t* w;       // (C, K, N) residues, or (K, N) raw int8
  const float* scol;     // (N,) column scale (EMIT_FLOAT / EMIT_RESIDUES)
  const float* creq;     // 1 value: the requantize constant (EMIT_RESIDUES)
  void* out;
  int* ws;               // zeroed C*M*N int32 workspace when splits > 1
  int* counters;         // zeroed per-tile arrival counters when splits > 1
  int M, K, N, splits, k_per_split, vec, encoded, emit;
};

namespace rns {

__device__ __forceinline__ int floor_mod(int a, int m) {
  // CUDA % truncates toward zero; the reference's jnp.mod is floored.
  const int r = a % m;
  return r < 0 ? r + m : r;
}

// Stage 4 for one channel: the fold ladder on |a| (signed plans) or a, the
// n_sub conditional subtracts, and (-v) mod m = m - v for a negative a.
__device__ __forceinline__ int fold_channel(int a, int j, const FusedPlan& p) {
  const int m = p.mods[j];
  const bool neg = p.is_signed && a < 0;
  int v = neg ? -a : a;
#pragma unroll
  for (int r = 0; r < MAXR; ++r) {
    if (r < p.R) {
      const int s = p.sched_s[j][r];
      const int mask = static_cast<int>((1u << s) - 1u);  // s <= 30
      v = (v & mask) + (v >> s) * p.sched_c[j][r];
    }
  }
  for (int u = 0; u < p.n_sub; ++u) v = v >= m ? v - m : v;
  return (neg && v > 0) ? m - v : v;
}

// f32 Horner out = out*2^15 + limb, top limb first (multiword.limbs_to_float).
__device__ __forceinline__ float limbs_to_float(const int (&limb)[MAXL],
                                                int L) {
  float out = 0.f;
#pragma unroll
  for (int l = MAXL - 1; l >= 0; --l) {
    if (l < L) {
      out = __fadd_rn(__fmul_rn(out, 32768.f), static_cast<float>(limb[l]));
    }
  }
  return out;
}

// Stage 5: canonical residues -> MRC digits -> 15-bit limb Horner -> the
// signed fix against ceil(M/2) -> float32, in the reference's op order.
template <int C>
__device__ __forceinline__ float mrc_value(const int (&r)[C],
                                           const FusedPlan& p) {
  int d[C];
#pragma unroll
  for (int j = 0; j < C; ++j) {
    const int m = p.mods[j];
    int t = r[j];
#pragma unroll
    for (int i = 0; i < j; ++i) {
      t = t - d[i];
      t = t < 0 ? t + m : t;
      t = floor_mod(t * p.inv[j][i], m);  // t may still be negative here
    }
    d[j] = t;
  }
  int limb[MAXL];
  int top = d[C - 1];
#pragma unroll
  for (int l = 0; l < MAXL; ++l) {
    limb[l] = top & LIMB_MASK;
    top >>= LIMB_BITS;
  }
#pragma unroll
  for (int j = C - 2; j >= 0; --j) {
    const int m = p.mods[j];
    int carry = d[j];
#pragma unroll
    for (int l = 0; l < MAXL; ++l) {
      if (l < p.L) {
        const int v = limb[l] * m + carry;
        limb[l] = v & LIMB_MASK;
        carry = v >> LIMB_BITS;
      }
    }
  }
  bool ge = false, eq = true;
#pragma unroll
  for (int l = MAXL - 1; l >= 0; --l) {
    if (l < p.L) {
      ge = ge || (eq && limb[l] > p.half_limbs[l]);
      eq = eq && limb[l] == p.half_limbs[l];
    }
  }
  const bool is_neg = ge || eq;
  int nlimb[MAXL];
  int borrow = 0;
#pragma unroll
  for (int l = 0; l < MAXL; ++l) {
    if (l < p.L) {
      const int v = p.M_limbs[l] - limb[l] - borrow;
      borrow = v < 0 ? 1 : 0;
      nlimb[l] = v + borrow * (1 << LIMB_BITS);
    }
  }
  const float pos = limbs_to_float(limb, p.L);
  const float neg = limbs_to_float(nlimb, p.L);
  return is_neg ? -neg : pos;
}

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// The output element (gm, gn) from its C channel accumulators.
template <int C>
__device__ __forceinline__ void tile_epilogue(const int (&acc)[C], int gm,
                                              int gn, const TileArgs& a,
                                              const FusedPlan& p) {
  const size_t plane = static_cast<size_t>(a.M) * a.N;
  const size_t at = static_cast<size_t>(gm) * a.N + gn;
  int r[C];
#pragma unroll
  for (int j = 0; j < C; ++j) r[j] = fold_channel(acc[j], j, p);
  if (a.emit == EMIT_CANONICAL) {
    int* out = static_cast<int*>(a.out);
#pragma unroll
    for (int j = 0; j < C; ++j) out[j * plane + at] = r[j];
    return;
  }
  if (a.emit == EMIT_CRT_LIMBS) {
    // alpha_j = |r_j v_j|_{m_j}, then limb += mc_j[l]*alpha_j + carry with
    // the carry propagated after every channel: r*v and mc*alpha stay
    // below 2^30 (m <= 2^15), limb + carry below 2^16, so every value
    // stays below 2^31.
    int limb[MAXL];
#pragma unroll
    for (int l = 0; l < MAXL; ++l) limb[l] = 0;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int alpha = floor_mod(r[j] * p.crt_v[j], p.mods[j]);
      int carry = 0;
#pragma unroll
      for (int l = 0; l < MAXL; ++l) {
        if (l < p.L1) {
          const int v = limb[l] + p.crt_mc[j][l] * alpha + carry;
          limb[l] = v & LIMB_MASK;
          carry = v >> LIMB_BITS;
        }
      }
    }
    int* out = static_cast<int*>(a.out);
#pragma unroll
    for (int l = 0; l < MAXL; ++l) {
      if (l < p.L1) out[l * plane + at] = limb[l];
    }
    return;
  }
  const float val = mrc_value<C>(r, p);
  if (a.emit == EMIT_RESIDUES) {
    // clip(round(y*s_col / creq), +-127), then its canonical residues
    float q = rintf(__fdiv_rn(__fmul_rn(val, a.scol[gn]), *a.creq));
    q = fminf(fmaxf(q, -127.f), 127.f);
    const int qi = static_cast<int>(q);
    int8_t* out = static_cast<int8_t*>(a.out);
#pragma unroll
    for (int j = 0; j < C; ++j) {
      out[j * plane + at] = static_cast<int8_t>(floor_mod(qi, p.mods[j]));
    }
    return;
  }
  static_cast<float*>(a.out)[at] =
      __fmul_rn(__fmul_rn(val, a.srow[gm]), a.scol[gn]);
}

template <int C, int AM, bool ENCODED>
__global__ void __launch_bounds__(THREADS)
rns_tile_kernel(TileArgs a, FusedPlan plan) {
  constexpr int AP = AM == A_PLANES ? C : 1;   // A planes staged per step
  __shared__ __align__(16) int8_t xs[AP][TM][TK];
  __shared__ __align__(16) int8_t wsm[C][TN][KPAD];
  __shared__ int is_last;

  const int M = a.M, K = a.K, N = a.N;
  const int tid = threadIdx.x;
  const int tn = tid % TN;
  const int tr = tid / TN;
  const int n0 = blockIdx.x * TN;
  const int m0 = blockIdx.y * TM;
  const int kbeg = blockIdx.z * a.k_per_split;
  const int kend = min(K, kbeg + a.k_per_split);

  int acc[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0;

  for (int k0 = kbeg; k0 < kend; k0 += TK) {
    // Stage 2, activations.  Out-of-range slots are 0, the residue of 0.
#pragma unroll
    for (int it = 0; it < TM * TK / THREADS; ++it) {
      const int e = tid + it * THREADS;
      const int r = e / TK, kk = e % TK;
      const int gm = m0 + r, gk = k0 + kk;
      const bool in = gm < M && gk < kend;
      const size_t at = static_cast<size_t>(gm) * K + gk;
      if constexpr (AM == A_F32 || AM == A_BF16) {
        // the quantizer's round-half-even / clip, IEEE divide by the row
        // scale
        int q = 0;
        if (in) {
          using XT = typename std::conditional<AM == A_F32, float,
                                               __nv_bfloat16>::type;
          float v = __fdiv_rn(load_f32(static_cast<const XT*>(a.x) + at),
                              a.srow[gm]);
          v = fminf(fmaxf(rintf(v), -127.f), 127.f);
          q = static_cast<int>(v);
        }
        xs[0][r][kk] = static_cast<int8_t>(q);
      } else if constexpr (AM == A_SHARED) {
        xs[0][r][kk] = in ? static_cast<const int8_t*>(a.x)[at] : 0;
      } else {
        // canonical residues, times |gate|_m when gated: both factors are
        // below m, so one int32 product and a floored mod are exact
        const int g = (in && a.gate) ? a.gate[at] : 0;
#pragma unroll
        for (int c = 0; c < AP; ++c) {
          int v = 0;
          if (in) {
            v = static_cast<const int8_t*>(a.x)[c * static_cast<size_t>(M) * K
                                                + at];
            if (a.gate) {
              const int m = plan.mods[c];
              v = floor_mod(floor_mod(g, m) * v, m);
            }
          }
          xs[c][r][kk] = static_cast<int8_t>(v);
        }
      }
    }
    // Stage 2, weights: stored residues, or |w|_m of live int8 weights,
    // staged transposed (k fastest) so four k values pack into one int32.
    // Each thread reads four consecutive columns as one int32 when the
    // rows are 4-byte aligned (``vec``: every serving shape), byte by byte
    // otherwise.
#pragma unroll
    for (int it = 0; it < TK * TN / 4 / THREADS; ++it) {
      const int e = tid + it * THREADS;
      const int kk = e / (TN / 4), n4 = 4 * (e % (TN / 4));
      const int gk = k0 + kk, gn = n0 + n4;
#pragma unroll
      for (int c = 0; c < (ENCODED ? C : 1); ++c) {
        const int8_t* row = ENCODED
            ? a.w + (static_cast<size_t>(c) * K + gk) * N
            : a.w + static_cast<size_t>(gk) * N;
        int8_t b[4] = {0, 0, 0, 0};
        if (gk < kend && gn < N) {
          if (a.vec) {
            const int v = *reinterpret_cast<const int*>(row + gn);
#pragma unroll
            for (int j = 0; j < 4; ++j) b[j] = static_cast<int8_t>(v >> (8 * j));
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) b[j] = gn + j < N ? row[gn + j] : 0;
          }
        }
        if (ENCODED) {
#pragma unroll
          for (int j = 0; j < 4; ++j) wsm[c][n4 + j][kk] = b[j];
        } else {
#pragma unroll
          for (int cc = 0; cc < C; ++cc)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              wsm[cc][n4 + j][kk] = static_cast<int8_t>(
                  floor_mod(static_cast<int>(b[j]), plan.mods[cc]));
        }
      }
    }
    __syncthreads();
    // Stage 3: per-channel int8 dot products into int32, no reduction.
#pragma unroll
    for (int k4 = 0; k4 < TK / 4; ++k4) {
      int wv[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        wv[c] = *reinterpret_cast<const int*>(&wsm[c][tn][k4 * 4]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int xv = *reinterpret_cast<const int*>(
              &xs[AP == 1 ? 0 : c][tr + 4 * i][k4 * 4]);
          acc[i][c] = __dp4a(xv, wv[c], acc[i][c]);
        }
      }
    }
    __syncthreads();
  }

  const int gn = n0 + tn;
  if (gridDim.z > 1) {
    // Split K: add the partial sums into the zeroed workspace; the last
    // block to finish this tile reads the totals and runs the epilogue.
    if (gn < N) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int gm = m0 + tr + 4 * i;
        if (gm < M) {
#pragma unroll
          for (int c = 0; c < C; ++c) {
            atomicAdd(&a.ws[(static_cast<size_t>(c) * M + gm) * N + gn],
                      acc[i][c]);
          }
        }
      }
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      const int tile = blockIdx.y * gridDim.x + blockIdx.x;
      is_last = atomicAdd(&a.counters[tile], 1) ==
                static_cast<int>(gridDim.z) - 1;
    }
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    if (gn < N) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int gm = m0 + tr + 4 * i;
        if (gm < M) {
#pragma unroll
          for (int c = 0; c < C; ++c) {
            acc[i][c] =
                __ldcg(&a.ws[(static_cast<size_t>(c) * M + gm) * N + gn]);
          }
        }
      }
    }
  }
  if (gn >= N) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + tr + 4 * i;
    if (gm < M) tile_epilogue<C>(acc[i], gm, gn, a, plan);
  }
}

// Launch the tile kernel of mode AM for the plan's channel count; returns
// cudaGetLastError(), or -1 for a channel count not compiled in.
template <int AM>
int launch_tile(const TileArgs& a, const FusedPlan& plan,
                cudaStream_t stream) {
  const dim3 grid((a.N + TN - 1) / TN, (a.M + TM - 1) / TM, a.splits);
#define RNS_TILE_CASE(CC)                                                   \
  case CC:                                                                  \
    if (a.encoded) {                                                        \
      rns_tile_kernel<CC, AM, true><<<grid, THREADS, 0, stream>>>(a, plan); \
    } else {                                                                \
      if constexpr (AM == A_F32 || AM == A_BF16) {                          \
        rns_tile_kernel<CC, AM, false><<<grid, THREADS, 0, stream>>>(a,     \
                                                                     plan); \
      } else {                                                              \
        return -1;                                                          \
      }                                                                     \
    }                                                                       \
    break;
// Channel slices narrower than any basis (C = 1, 2) only occur in the CRT
// partial launch, which always takes encoded residues and never the
// shared signed operand: only those instances are built.
#define RNS_TILE_SLICE_CASE(CC)                                             \
  case CC:                                                                  \
    if constexpr (AM != A_SHARED) {                                         \
      if (a.encoded) {                                                      \
        rns_tile_kernel<CC, AM, true><<<grid, THREADS, 0, stream>>>(a,      \
                                                                    plan);  \
        break;                                                              \
      }                                                                     \
    }                                                                       \
    return -1;
  switch (plan.C) {
    RNS_TILE_SLICE_CASE(1)
    RNS_TILE_SLICE_CASE(2)
    RNS_TILE_CASE(3)
    RNS_TILE_CASE(4)
    RNS_TILE_CASE(5)
    RNS_TILE_CASE(6)
    RNS_TILE_CASE(7)
    RNS_TILE_CASE(8)
    RNS_TILE_CASE(9)
    RNS_TILE_CASE(10)
    RNS_TILE_CASE(11)
    default:
      return -1;
  }
#undef RNS_TILE_CASE
#undef RNS_TILE_SLICE_CASE
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rns

// Per-file entry points (each .cu instantiates one or two A modes).
int rns_launch_tile_f32(const TileArgs& a, const FusedPlan& plan,
                        cudaStream_t stream);
int rns_launch_tile_bf16(const TileArgs& a, const FusedPlan& plan,
                         cudaStream_t stream);
int rns_launch_tile_int8(int amode, const TileArgs& a, const FusedPlan& plan,
                         cudaStream_t stream);
