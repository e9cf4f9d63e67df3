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
// At prefill (M = 512: 8 lanes x a 64-token bucket) the int8 operations
// bound it: one smollm layer's seven fused launches are 18.1 G operations,
// 9.2 us at 1,979 TOP/s, against 3-4 us of bytes.  A 16-row tile on
// __dp4a leaves the tensor cores idle, stages every weight tile again for
// each 16 rows, and in A_PLANES mode issues more shared loads than dp4a.
// So launches with M > 16 and C <= 7 take a 32-row tile (TM_MMA) whose
// Stage 3 is mma.sync.m16n8k32.s8 on the tensor cores: 4 warps side by
// side, each owning a 32 x 16 output sub-tile per channel (2 A x 2 B
// fragments, 4 mma per channel per 32-deep step, C x 16 int32
// accumulators a thread).  32 rows, not 64: a block then needs 80-255
// registers a thread for 128 threads, so two fit an SM, M = 512 gives
// 144-384 tiles for 132 SMs, and one block's epilogue (fold and MRC of
// 16 elements a thread) overlaps another's K loop.  Stage 2 is split in a
// load half, issued a step ahead, and a store half that converts and
// transposes the weights in registers.  Shared rows are 32 bytes with the
// word index XORed by 4 in rows 4-7 of every 8, so fragment loads and the
// transposed stores hit 32 distinct banks.  Integer products and sums on
// the tensor cores are exact, so the epilogue and split-K are the 16-row
// tile's, per output element.  M <= 16 (decode) and C >= 8 keep the
// 16-row __dp4a tile.
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
constexpr int MAXSUB = 4;  // conditional subtracts (plans have <= 3)
constexpr int MAXL = 6;    // 15-bit limbs of the dynamic range
constexpr int LIMB_BITS = 15;
constexpr int LIMB_MASK = (1 << LIMB_BITS) - 1;

constexpr int TM = 16;     // output rows per block (__dp4a tile)
constexpr int TM_MMA = 32; // output rows per block (tensor-core tile)
constexpr int MMA_MAXC = 7;    // widest basis compiled for the 32-row tile
constexpr int TN = 64;     // output columns per block
constexpr int TK = 32;     // K step staged in shared memory
constexpr int KPAD = TK + 4;   // 36-byte rows: conflict-free int32 reads
constexpr int THREADS = 256;   // 16-row tile: thread t owns column t%64,
                               // rows t/64 + 4i
constexpr int MMA_THREADS = 128;   // 32-row tile: 4 warps side by side
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
  int tm;                // tile height: TM or TM_MMA (needs vec and avec)
  int avec;              // K % 4 == 0 and A, gate rows aligned for 4 values
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
  // unrolled and predicated, so folds of several values interleave
#pragma unroll
  for (int u = 0; u < MAXSUB; ++u) {
    if (u < p.n_sub) v = v >= m ? v - m : v;
  }
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

// The output element (gm, gn) from its C channel accumulators.  EMIT is
// a.emit, or -1 to read it at run time.  An element outside the output
// (``in`` false) is computed on clamped indices and not written, so the
// 32-row tile's elements run without branches and interleave.
template <int C, int EMIT = -1>
__device__ __forceinline__ void tile_epilogue(const int (&acc)[C], int gm,
                                              int gn, const TileArgs& a,
                                              const FusedPlan& p,
                                              bool in = true) {
  const int emit = EMIT < 0 ? a.emit : EMIT;
  gm = in ? gm : 0;
  gn = in ? gn : 0;
  const size_t plane = static_cast<size_t>(a.M) * a.N;
  const size_t at = static_cast<size_t>(gm) * a.N + gn;
  int r[C];
#pragma unroll
  for (int j = 0; j < C; ++j) r[j] = fold_channel(acc[j], j, p);
  if (emit == EMIT_CANONICAL) {
    int* out = static_cast<int*>(a.out);
#pragma unroll
    for (int j = 0; j < C; ++j) {
      if (in) out[j * plane + at] = r[j];
    }
    return;
  }
  if (emit == EMIT_CRT_LIMBS) {
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
      if (in && l < p.L1) out[l * plane + at] = limb[l];
    }
    return;
  }
  const float val = mrc_value<C>(r, p);
  if (emit == EMIT_RESIDUES) {
    // clip(round(y*s_col / creq), +-127), then its canonical residues
    float q = rintf(__fdiv_rn(__fmul_rn(val, a.scol[gn]), *a.creq));
    q = fminf(fmaxf(q, -127.f), 127.f);
    const int qi = static_cast<int>(q);
    int8_t* out = static_cast<int8_t*>(a.out);
#pragma unroll
    for (int j = 0; j < C; ++j) {
      if (in) {
        out[j * plane + at] = static_cast<int8_t>(floor_mod(qi, p.mods[j]));
      }
    }
    return;
  }
  const float y = __fmul_rn(__fmul_rn(val, a.srow[gm]), a.scol[gn]);
  if (in) static_cast<float*>(a.out)[at] = y;
}

// mma.sync.m16n8k32 with int8 operands and int32 accumulators, in place:
// d0..d3 are rows g, g, g+8, g+8 and columns 2t, 2t+1, 2t, 2t+1 of the
// 16 x 8 tile (g = lane/4, t = lane%4); a holds rows g / g+8 at k 4t..4t+3
// and 16+4t..16+4t+3, b column g at the same k.
__device__ __forceinline__ void mma_s8(int& d0, int& d1, int& d2, int& d3,
                                       const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d0), "+r"(d1), "+r"(d2), "+r"(d3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Row and column, within the block's tile, of a thread's accumulator i.
template <int TMR>
__device__ __forceinline__ void acc_elem(int tid, int i, int& r, int& col) {
  if constexpr (TMR == TM) {
    r = tid / TN + 4 * i;
    col = tid % TN;
  } else {
    // i = 8*mi + 4*ni + q: A fragment mi, B fragment ni, C register q
    const int lane = tid & 31, warp = tid >> 5;
    r = (i >> 3) * 16 + (lane >> 2) + ((i >> 1) & 1) * 8;
    col = warp * 16 + ((i >> 2) & 1) * 8 + 2 * (lane & 3) + (i & 1);
  }
}

// Word w of a 32-row tile's shared row r (32 bytes): the word index is
// XORed with 4 in rows 4-7 of every 8, so a fragment load (rows g, words
// t) and a store of 4 rows x 8 words both hit 32 distinct banks.
__device__ __forceinline__ uint32_t* mma_word(int8_t* rows, int r, int w) {
  return reinterpret_cast<uint32_t*>(rows) + r * (TK / 4) +
         (w ^ (((r >> 2) & 1) << 2));
}

// One K step of the 32-row tile's Stage 2, in two halves: `load_a` and
// `load_w` issue every global read of the step into registers (read-only,
// independent), `store` converts them as the 16-row prologue does and
// writes the shared tiles.  Where registers allow, the kernel reads step
// k+1 before running the mma of step k, so the reads are in flight while
// the tensor cores work.  A thread's place in the tile is the same at
// every step: A words (rows r0 and r0 + 16, k 4*kw..4*kw+3; planes one
// after another) and 4 x 4 weight blocks (k 4*kw.., columns 4*n16.., one
// in every channel), so its pointers and shared addresses are set once.
// Each load reads four k values of A or four columns of a weight row: the
// tile takes only launches with N and K multiples of 4 and aligned rows
// (``vec`` and ``avec``, every serving shape), so a word is wholly inside
// or outside the output and K.
template <int C, int AM, bool ENCODED>
struct MmaStage {
  static constexpr bool QUANT = AM == A_F32 || AM == A_BF16;
  static constexpr int AP = AM == A_PLANES ? C : 1;
  static constexpr int AW = TM_MMA * TK / 4 / MMA_THREADS;  // A words
  static constexpr int PER_C = TK / 4 * (TN / 4);   // 4x4 weight blocks
  static constexpr int WB = C;                      // one per channel
  static_assert(AW == 2 && MMA_THREADS == PER_C, "thread map");
  // Step k+1 is read during step k only where the registers it takes (4
  // a channel for the weights, 2 a plane and 2 for the gate for A_PLANES)
  // fit beside the C x 16 accumulators; otherwise a step reads its own
  // weights (and planes) at its start, and the other blocks on the SM
  // cover the wait.
  static constexpr bool EARLY_A = AM != A_PLANES || C <= 3;
  static constexpr bool EARLY_W = C <= 3;
  // geometry
  int kw, r0, n16;
  bool row_in[AW], col_in;
  // the step's reads
  uint32_t xraw[QUANT ? AW * (AM == A_F32 ? 4 : 2) : AP * AW];
  uint32_t gate[AW];
  uint32_t w[WB][4];

  __device__ __forceinline__ MmaStage(const TileArgs& a, int m0, int n0,
                                      int tid) {
    kw = tid % (TK / 4);
    r0 = tid / (TK / 4);
    n16 = tid / (TK / 4) % (TN / 4);
#pragma unroll
    for (int it = 0; it < AW; ++it) row_in[it] = m0 + r0 + 16 * it < a.M;
    col_in = n0 + 4 * n16 < a.N;
  }

  // Four int8 values at p (k = gk..gk+3), 0 outside the row or K.
  static __device__ __forceinline__ uint32_t bytes4(const int8_t* p,
                                                    bool in) {
    return in ? __ldg(reinterpret_cast<const unsigned int*>(p)) : 0u;
  }

  __device__ __forceinline__ void load_a(const TileArgs& a, int m0, int k0,
                                         int kend) {
    const int K = a.K;
    const int gk = k0 + 4 * kw;
#pragma unroll
    for (int it = 0; it < AW; ++it) {
      const size_t at = static_cast<size_t>(m0 + r0 + 16 * it) * K + gk;
      const bool in = row_in[it] && gk < kend;
      if constexpr (AM == A_F32) {
        const float* x = static_cast<const float*>(a.x) + at;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (in) v = __ldg(reinterpret_cast<const float4*>(x));
        xraw[4 * it] = __float_as_uint(v.x);
        xraw[4 * it + 1] = __float_as_uint(v.y);
        xraw[4 * it + 2] = __float_as_uint(v.z);
        xraw[4 * it + 3] = __float_as_uint(v.w);
      } else if constexpr (AM == A_BF16) {
        const unsigned short* x =
            static_cast<const unsigned short*>(a.x) + at;
        uint2 v = make_uint2(0u, 0u);
        if (in) v = __ldg(reinterpret_cast<const uint2*>(x));
        xraw[2 * it] = v.x;
        xraw[2 * it + 1] = v.y;
      } else {
        const int8_t* x = static_cast<const int8_t*>(a.x) + at;
        const size_t plane = static_cast<size_t>(a.M) * K;
#pragma unroll
        for (int c = 0; c < AP; ++c) {
          xraw[c * AW + it] = bytes4(x + c * plane, in);
        }
        gate[it] = a.gate ? bytes4(a.gate + at, in) : 0u;
      }
    }
  }

  __device__ __forceinline__ void load_w(const TileArgs& a, int n0, int k0,
                                         int kend) {
    const int K = a.K, N = a.N;
    const int gn = n0 + 4 * n16;
#pragma unroll
    for (int c = 0; c < WB; ++c) {
      const int8_t* base = a.w + (ENCODED ? static_cast<size_t>(c) * K * N
                                          : 0) + gn;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gk4 = k0 + 4 * kw + j;
        w[c][j] = bytes4(base + static_cast<size_t>(gk4) * N,
                         gk4 < kend && col_in);
      }
    }
  }

  __device__ __forceinline__ void store(const TileArgs& a,
                                        const FusedPlan& plan,
                                        int8_t (&xs)[AP][TM_MMA][TK],
                                        int8_t (&wsm)[C][TN][TK], int k0,
                                        int kend, const float (&srow)[AW])
      const {
#pragma unroll
    for (int it = 0; it < AW; ++it) {
      const int r = r0 + 16 * it;
      if constexpr (QUANT) {
        // the quantizer's round-half-even / clip, IEEE divide by the row
        // scale; slots outside M or K are 0, the residue of 0
        uint32_t word = 0;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float x;
          if constexpr (AM == A_F32) {
            x = __uint_as_float(xraw[4 * it + q]);
          } else {   // bf16 -> f32 is exact: the bits move up 16 places
            x = __uint_as_float((xraw[2 * it + q / 2] >> (16 * (q % 2)))
                                << 16);
          }
          if (row_in[it] && k0 + 4 * kw + q < kend) {
            float v = __fdiv_rn(x, srow[it]);
            v = fminf(fmaxf(rintf(v), -127.f), 127.f);
            word |= static_cast<uint32_t>(static_cast<uint8_t>(
                        static_cast<int8_t>(v))) << (8 * q);
          }
        }
        *mma_word(&xs[0][0][0], r, kw) = word;
      } else {
#pragma unroll
        for (int c = 0; c < AP; ++c) {
          uint32_t word = xraw[c * AW + it];
          if (a.gate) {
            // canonical residues times |gate|_m: both factors below m, so
            // one int32 product and a floored mod are exact
            const int m = plan.mods[c];
            const uint32_t x = word;
            word = 0;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int g = static_cast<int8_t>(gate[it] >> (8 * q));
              const int v = static_cast<int8_t>(x >> (8 * q));
              word |= static_cast<uint32_t>(floor_mod(floor_mod(g, m) * v,
                                                      m)) << (8 * q);
            }
          }
          *mma_word(&xs[c][0][0], r, kw) = word;
        }
      }
    }
    // weights: |w|_m of live weights byte by byte; each row word rotated
    // by d = n16 % 4 bytes, so the 4 x 4 transpose yields column d first:
    // the warp's four column groups then store to four different rows at
    // a time, and its 32 stores hit 32 banks
    const int d = n16 & 3;
#pragma unroll
    for (int c = 0; c < WB; ++c) {
      uint32_t rw[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t v = w[c][j];
        if (!ENCODED) {
          uint32_t u = 0;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            u |= static_cast<uint32_t>(floor_mod(
                     static_cast<int8_t>(v >> (8 * q)), plan.mods[c]))
                 << (8 * q);
          }
          v = u;
        }
        rw[j] = __funnelshift_r(v, v, 8 * d);
      }
      const uint32_t t0 = __byte_perm(rw[0], rw[1], 0x5140);
      const uint32_t t1 = __byte_perm(rw[0], rw[1], 0x7362);
      const uint32_t t2 = __byte_perm(rw[2], rw[3], 0x5140);
      const uint32_t t3 = __byte_perm(rw[2], rw[3], 0x7362);
      // colw[s]: k 4*kw .. 4*kw+3 of column 4*n16 + (s + d) % 4
      const uint32_t colw[4] = {
          __byte_perm(t0, t2, 0x5410), __byte_perm(t0, t2, 0x7632),
          __byte_perm(t1, t3, 0x5410), __byte_perm(t1, t3, 0x7632)};
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        *mma_word(&wsm[c][0][0], 4 * n16 + ((s + d) & 3), kw) = colw[s];
      }
    }
  }
};

// Stage 3 of one K step on the tensor cores: per channel, 2 A x 2 B
// fragments of the warp's 32 x 16 sub-tile (warp w: columns 16w..16w+15),
// one 32-bit shared load per register.
template <int C, int AP>
__device__ __forceinline__ void mma_step(int8_t (&xs)[AP][TM_MMA][TK],
                                         int8_t (&wsm)[C][TN][TK],
                                         int (&acc)[16][C], int tid) {
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ar = g;
  const int bc = warp * 16 + g;
  uint32_t af[2][4];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (c < AP) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        int8_t* rows = &xs[c < AP ? c : 0][0][0];
        af[mi][0] = *mma_word(rows, ar + 16 * mi, t);
        af[mi][1] = *mma_word(rows, ar + 16 * mi + 8, t);
        af[mi][2] = *mma_word(rows, ar + 16 * mi, t + 4);
        af[mi][3] = *mma_word(rows, ar + 16 * mi + 8, t + 4);
      }
    }
    uint32_t bf[2][2];
#pragma unroll
    for (int ni = 0; ni < 2; ++ni) {
      bf[ni][0] = *mma_word(&wsm[c][0][0], bc + 8 * ni, t);
      bf[ni][1] = *mma_word(&wsm[c][0][0], bc + 8 * ni, t + 4);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
        const int i = 8 * mi + 4 * ni;
        mma_s8(acc[i][c], acc[i + 1][c], acc[i + 2][c], acc[i + 3][c],
               af[mi], bf[ni]);
      }
  }
}

// The 32-row tile's K loop: step k+1 is read while step k multiplies,
// where registers allow (MmaStage::EARLY_A / EARLY_W).
template <int C, int AM, bool ENCODED>
__device__ __forceinline__ void mma_mainloop(
    const TileArgs& a, const FusedPlan& plan,
    int8_t (&xs)[AM == A_PLANES ? C : 1][TM_MMA][TK],
    int8_t (&wsm)[C][TN][TK], int (&acc)[16][C], int m0, int n0, int kbeg,
    int kend, int tid) {
  using Stage = MmaStage<C, AM, ENCODED>;
  Stage stage(a, m0, n0, tid);
  float srow[Stage::AW];
#pragma unroll
  for (int it = 0; it < Stage::AW; ++it) {
    srow[it] = Stage::QUANT && stage.row_in[it]
        ? __ldg(a.srow + m0 + stage.r0 + 16 * it) : 1.f;
  }
  if (kbeg < kend) {
    if (Stage::EARLY_A) stage.load_a(a, m0, kbeg, kend);
    if (Stage::EARLY_W) stage.load_w(a, n0, kbeg, kend);
  }
  for (int k0 = kbeg; k0 < kend; k0 += TK) {
    if (!Stage::EARLY_A) stage.load_a(a, m0, k0, kend);
    if (!Stage::EARLY_W) stage.load_w(a, n0, k0, kend);
    stage.store(a, plan, xs, wsm, k0, kend, srow);
    __syncthreads();
    if (k0 + TK < kend) {
      if (Stage::EARLY_A) stage.load_a(a, m0, k0 + TK, kend);
      if (Stage::EARLY_W) stage.load_w(a, n0, k0 + TK, kend);
    }
    mma_step<C, Stage::AP>(xs, wsm, acc, tid);
    __syncthreads();
  }
}

// The 32-row tile's epilogue: a thread's 16 elements G at a time
// (branch-free, so the G interleave; fewer as the C x 16 accumulators
// leave fewer registers), each element's C accumulators selected out of
// registers, with the emit fixed at compile time so the code a block runs
// stays small.
template <int C, int EMIT>
__device__ __forceinline__ void mma_epilogue(const int (&acc)[16][C], int m0,
                                             int n0, const TileArgs& a,
                                             const FusedPlan& plan,
                                             int tid) {
  constexpr int G = C <= 3 ? 4 : C == 4 ? 2 : 1;
#pragma unroll 1
  for (int i0 = 0; i0 < 16; i0 += G) {
#pragma unroll
    for (int u = 0; u < G; ++u) {
      int r, col;
      acc_elem<TM_MMA>(tid, i0 + u, r, col);
      int e[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        e[c] = acc[u][c];
#pragma unroll
        for (int q = u + G; q < 16; q += G) {
          e[c] = q == i0 + u ? acc[q][c] : e[c];
        }
      }
      tile_epilogue<C, EMIT>(e, m0 + r, n0 + col, a, plan,
                             m0 + r < a.M && n0 + col < a.N);
    }
  }
}

// Blocks per SM the 32-row tile is compiled for (registers a thread:
// 168 for three, 255 for two): its C x 16 accumulators allow three up to
// 5 channels, or 3 for A_PLANES, whose prologue holds C planes.
template <int TMR, int C, int AM>
constexpr int tile_min_blocks() {
  return TMR == TM ? 1 : C <= (AM == A_PLANES ? 3 : 5) ? 3 : 2;
}

template <int TMR, int C, int AM, bool ENCODED>
__global__ void __launch_bounds__(TMR == TM ? THREADS : MMA_THREADS,
                                  tile_min_blocks<TMR, C, AM>())
rns_tile_kernel(TileArgs a, FusedPlan plan) {
  constexpr bool MMA = TMR == TM_MMA;
  static_assert(TMR == TM || (MMA && C <= MMA_MAXC), "tile not compiled");
  constexpr int AP = AM == A_PLANES ? C : 1;   // A planes staged per step
  constexpr int EPT = TMR * TN / (MMA ? MMA_THREADS : THREADS);  // per c
  __shared__ __align__(16) int8_t xs[AP][TMR][TK];
  __shared__ __align__(16) int8_t wsm[C][TN][MMA ? TK : KPAD];
  __shared__ int is_last;

  const int M = a.M, N = a.N;
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * TN;
  const int m0 = blockIdx.y * TMR;
  const int kbeg = blockIdx.z * a.k_per_split;
  const int kend = min(a.K, kbeg + a.k_per_split);

  int acc[EPT][C];
#pragma unroll
  for (int i = 0; i < EPT; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0;

  if constexpr (MMA) {
    mma_mainloop<C, AM, ENCODED>(a, plan, xs, wsm, acc, m0, n0, kbeg, kend,
                                 tid);
  } else {
    const int K = a.K;
    const int tn = tid % TN;
    const int tr = tid / TN;
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
              v = static_cast<const int8_t*>(a.x)[c * static_cast<size_t>(M)
                                                      * K + at];
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
      // staged transposed (k fastest) so four k values pack into one
      // int32.  Each thread reads four consecutive columns as one int32
      // when the rows are 4-byte aligned (``vec``: every serving shape),
      // byte by byte otherwise.
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
              for (int j = 0; j < 4; ++j) {
                b[j] = static_cast<int8_t>(v >> (8 * j));
              }
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
  }

  if (gridDim.z > 1) {
    // Split K: add the partial sums into the zeroed workspace; the last
    // block to finish this tile reads the totals and runs the epilogue.
#pragma unroll
    for (int i = 0; i < EPT; ++i) {
      int r, col;
      acc_elem<TMR>(tid, i, r, col);
      const int gm = m0 + r, gn = n0 + col;
      if (gm < M && gn < N) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          atomicAdd(&a.ws[(static_cast<size_t>(c) * M + gm) * N + gn],
                    acc[i][c]);
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
#pragma unroll
    for (int i = 0; i < EPT; ++i) {
      int r, col;
      acc_elem<TMR>(tid, i, r, col);
      const int gm = m0 + r, gn = n0 + col;
      if (gm < M && gn < N) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          acc[i][c] =
              __ldcg(&a.ws[(static_cast<size_t>(c) * M + gm) * N + gn]);
        }
      }
    }
  }
  if constexpr (!MMA) {
#pragma unroll
    for (int i = 0; i < EPT; ++i) {
      int r, col;
      acc_elem<TMR>(tid, i, r, col);
      if (m0 + r < M && n0 + col < N) {
        tile_epilogue<C>(acc[i], m0 + r, n0 + col, a, plan);
      }
    }
  } else {
    switch (a.emit) {
      case EMIT_FLOAT:
        mma_epilogue<C, EMIT_FLOAT>(acc, m0, n0, a, plan, tid);
        break;
      case EMIT_RESIDUES:
        mma_epilogue<C, EMIT_RESIDUES>(acc, m0, n0, a, plan, tid);
        break;
      case EMIT_CANONICAL:
        mma_epilogue<C, EMIT_CANONICAL>(acc, m0, n0, a, plan, tid);
        break;
      default:
        mma_epilogue<C, EMIT_CRT_LIMBS>(acc, m0, n0, a, plan, tid);
    }
  }
}

// Launch the tile kernel of height TMR and mode AM for the plan's channel
// count; returns cudaGetLastError(), or -1 for a channel count not
// compiled in.
template <int TMR, int AM>
int launch_tile(const TileArgs& a, const FusedPlan& plan,
                cudaStream_t stream) {
  const dim3 grid((a.N + TN - 1) / TN, (a.M + TMR - 1) / TMR, a.splits);
  constexpr int NT = TMR == TM ? THREADS : MMA_THREADS;
  if (TMR == TM_MMA && !(a.vec && a.avec)) return -1;
#define RNS_TILE_CASE(CC)                                                   \
  case CC:                                                                  \
    if constexpr (TMR == TM || CC <= MMA_MAXC) {                            \
      if (a.encoded) {                                                      \
        rns_tile_kernel<TMR, CC, AM, true><<<grid, NT, 0, stream>>>(        \
            a, plan);                                                       \
        break;                                                              \
      }                                                                     \
      if constexpr (AM == A_F32 || AM == A_BF16) {                          \
        rns_tile_kernel<TMR, CC, AM, false><<<grid, NT, 0, stream>>>(       \
            a, plan);                                                       \
        break;                                                              \
      }                                                                     \
    }                                                                       \
    return -1;
// Channel slices narrower than any basis (C = 1, 2) only occur in the CRT
// partial launch, which always takes encoded residues and never the
// shared signed operand: only those instances are built.
#define RNS_TILE_SLICE_CASE(CC)                                             \
  case CC:                                                                  \
    if constexpr (AM != A_SHARED) {                                         \
      if (a.encoded) {                                                      \
        rns_tile_kernel<TMR, CC, AM, true><<<grid, NT, 0, stream>>>(        \
            a, plan);                                                       \
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
// The 32-row tensor-core instances, in files of their own so they compile
// in parallel with the 16-row ones.
int rns_launch_tile_mma_f32(const TileArgs& a, const FusedPlan& plan,
                            cudaStream_t stream);
int rns_launch_tile_mma_bf16(const TileArgs& a, const FusedPlan& plan,
                             cudaStream_t stream);
int rns_launch_tile_mma_int8(int amode, const TileArgs& a,
                             const FusedPlan& plan, cudaStream_t stream);
