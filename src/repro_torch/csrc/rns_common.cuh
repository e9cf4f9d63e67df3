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
// What bounds it on an H100: at decode (M <= 16 rows) a launch reads C int8
// residues per weight, C*K*N bytes, and does C*M*K*N multiply-adds: far
// below the int8 rate, so device memory bounds it, and at these sizes
// (0.2-4.4 MB a launch, under a microsecond of bytes) the fixed costs of a
// launch do: DRAM round trips in series, barriers, and the per-element
// epilogue's long dependent chain.  The 16-row tile's design answers that:
//   * Weights stream: each step's C x 32 x 64 encoded weight bytes arrive
//     by 16-byte cp.async.cg copies into a ring of STAGES = 3 shared
//     stages, so two K steps are in flight while one is multiplied.  The
//     thread that copies a 4-row x 16-byte block transposes it once it
//     lands (__byte_perm, 4 x 4 bytes) into k-fastest words, so __dp4a
//     reads one word per (column, 4 k) and no barrier stands between copy
//     and transpose.  A (and live or unaligned weights) are read a step
//     ahead into registers.  Step s + 1 is converted into one of two
//     buffers while step s's __dp4a read the other: one barrier a step.
//   * Split K through a thread-block cluster, with no workspace: when the
//     (M/16) x (N/64) tiles are fewer than the SMs, the K loop is split
//     over S <= 8 blocks launched as one cluster (grid z = cluster z = S).
//     Rank r owns 1/S of the tile's elements.  Each block gathers its
//     C x rows x 64 int32 partial sums by owner in its own shared memory
//     (over the retired staging buffers), one thread sends each other
//     rank its slice with one bulk copy into that rank's shared memory
//     (cp.async.bulk.shared::cluster), counted in by the owner's mbarrier,
//     and the owner adds its own slice, folds every (element, channel) on
//     a thread of its own and runs the rest of the epilogue per element.
//     The cluster barrier is split (relaxed arrive, wait later), so no
//     block waits on it in the common case and none fences device memory.
//     Integer sums in any order give the same totals, so the result is
//     exact, and a launch allocates nothing but its output.
//   * The epilogue's mods by a channel's modulus use the plan's reciprocal
//     (`mod_u`): an integer divide by a run-time divisor is a long
//     sequence on the critical path of every element.
//   * __dp4a, not mma.sync: at decode 8 of 16 rows are live and the
//     operations are far below any rate, so the tensor cores would buy
//     nothing; __dp4a keeps the thread map (column t%64, rows t/64 + 4i),
//     whose warps skip dead rows as a whole, and the per-element epilogue
//     of every emit.
// Shared memory is dynamic (up to 172 KB at C = 11), set once per instance
// with the co-scheduling of an 8-block cluster checked
// (cudaOccupancyMaxActiveClusters).  Shapes whose weight rows are not
// 16-byte multiples (N % 16 != 0, unaligned) read weights a step ahead in
// registers instead of streaming them.
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

#include "hopper_async.cuh"

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
constexpr int TM_WG = 64;  // output rows per block (wgmma tile, raw int8 A;
                           // rns_tile_wg.cuh)
constexpr int TN = 64;     // output columns per block
constexpr int TK = 32;     // K step staged in shared memory
constexpr int KPAD = TK + 4;   // 36-byte rows: conflict-free int32 reads
constexpr int THREADS = 256;   // 16-row tile: thread t owns column t%64,
                               // rows t/64 + 4i
constexpr int RSTEP = THREADS / TN;  // rows between a thread's accumulators
constexpr int NACC = TM / RSTEP;     // its accumulators per channel
constexpr int STAGES = 3;      // 16-row tile's weight ring (2 steps in flight)
constexpr int MAX_SPLITS = 8;  // K splits of a 16-row tile: the portable
                               // cluster size
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
  // Divide-free mods: mu_j = floor(2^32 / m_j), and madd_j, the least
  // multiple of m_j >= max(128, every modulus), which makes the operands
  // of the kernels' mods non-negative (`mod_u`, `mod_c`).
  unsigned mu[rns::MAXC];
  int madd[rns::MAXC];
};

// Operands of one tile-kernel launch (mirrors `_TileArgs`).
struct TileArgs {
  const void* x;         // A operand, see AMode
  const float* srow;     // (M,) row scale: quantize divisor, float dequant
  const int8_t* gate;    // (M, K) raw int8 gate of A_PLANES, or null
  const int8_t* w;       // (C, K, N) residues, or (K, N) raw int8
  const float* scol;     // (N,) column scale (EMIT_FLOAT / EMIT_RESIDUES)
  const float* creq;     // 1 value: the requantize constant (EMIT_RESIDUES)
  const float* scale;    // (M, N) full dequant scale (EMIT_FLOAT), or null
  void* out;
  int M, K, N;
  int splits;            // K splits = cluster size (16-row tile, <= 8)
  int k_per_split, vec, encoded, emit;
  int tm;                // tile height: TM or TM_MMA (needs vec and avec)
  int avec;              // K % 4 == 0 and A, gate rows aligned for 4 values
  int w16;               // N % 16 == 0 and w 16-byte aligned: cp.async rows
};

namespace rns {

// |u|_{m_c} of an unsigned u < 2^32 by the plan's reciprocal mu_c: the
// quotient estimate __umulhi(u, mu_c) is exact or one short (u < 2^32,
// mu_c * m_c > 2^32 - m_c), so one conditional subtract finishes it.  No
// integer divide, whose runtime-divisor sequence is many times longer.
__device__ __forceinline__ int mod_u(unsigned u, int c, const FusedPlan& p) {
  const unsigned m = static_cast<unsigned>(p.mods[c]);
  const unsigned r = u - __umulhi(u, p.mu[c]) * m;
  return static_cast<int>(r >= m ? r - m : r);
}

// The floored |x|_{m_c} for -madd_c <= x < 2^31 - madd_c (an int8 value,
// or a canonical residue minus one of another channel).
__device__ __forceinline__ int mod_c(int x, int c, const FusedPlan& p) {
  return mod_u(static_cast<unsigned>(x + p.madd[c]), c, p);
}

// The fold ladder of channel j on a value v >= 0: the plan's R
// shift/multiply rungs, then the n_sub conditional subtracts.  Built once,
// it holds the channel's steps in registers (rns_fold_kernel keeps one for
// a whole block).
struct ChannelLadder {
  int m, R, n_sub;
  int s[MAXR], c[MAXR];

  __device__ __forceinline__ ChannelLadder(const FusedPlan& p, int j)
      : m(p.mods[j]), R(p.R), n_sub(p.n_sub) {
#pragma unroll
    for (int r = 0; r < MAXR; ++r) {
      s[r] = r < R ? p.sched_s[j][r] : 0;
      c[r] = r < R ? p.sched_c[j][r] : 0;
    }
  }
  __device__ __forceinline__ int operator()(int v) const {
#pragma unroll
    for (int r = 0; r < MAXR; ++r) {
      if (r < R) {
        const int mask = static_cast<int>((1u << s[r]) - 1u);  // s <= 30
        v = (v & mask) + (v >> s[r]) * c[r];
      }
    }
    // unrolled and predicated, so folds of several values interleave
#pragma unroll
    for (int u = 0; u < MAXSUB; ++u) {
      if (u < n_sub) v = v >= m ? v - m : v;
    }
    return v;
  }
};

// Stage 4 for one channel: the ladder on |a| (signed plans) or a, and
// (-v) mod m = m - v for a negative a.
__device__ __forceinline__ int fold_channel(int a, int j, const FusedPlan& p) {
  const ChannelLadder fold(p, j);
  const bool neg = p.is_signed && a < 0;
  const int v = fold(neg ? -a : a);
  return (neg && v > 0) ? fold.m - v : v;
}

// f32 Horner out = out*2^15 + limb, top limb first (multiword.limbs_to_float).
// LL is the limb count when known at compile time (the loops then run no
// predicated-off iterations), or 0 to read L at run time.
template <int LL = 0>
__device__ __forceinline__ float limbs_to_float(const int (&limb)[MAXL],
                                                int L) {
  float out = 0.f;
#pragma unroll
  for (int l = (LL ? LL : MAXL) - 1; l >= 0; --l) {
    if (LL || l < L) {
      out = __fadd_rn(__fmul_rn(out, 32768.f), static_cast<float>(limb[l]));
    }
  }
  return out;
}

// Stage 5: canonical residues -> MRC digits -> 15-bit limb Horner -> the
// signed fix against ceil(M/2) -> float32, in the reference's op order.
// LL: p.L when known at compile time, else 0 (limbs_to_float).
template <int C, int LL = 0>
__device__ __forceinline__ float mrc_value(const int (&r)[C],
                                           const FusedPlan& p) {
  constexpr int NL = LL ? LL : MAXL;
  int d[C];
#pragma unroll
  for (int j = 0; j < C; ++j) {
    int t = r[j];
#pragma unroll
    for (int i = 0; i < j; ++i) {
      // |(t - d_i) * inv_ji|_{m_j}: t - d_i + madd_j is non-negative and
      // below 2*m_j + max(m), so its product with inv_ji < m_j fits 32 bits
      t = mod_u(static_cast<unsigned>(t - d[i] + p.madd[j]) *
                    static_cast<unsigned>(p.inv[j][i]),
                j, p);
    }
    d[j] = t;
  }
  int limb[MAXL];
  int top = d[C - 1];
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    limb[l] = top & LIMB_MASK;
    top >>= LIMB_BITS;
  }
#pragma unroll
  for (int j = C - 2; j >= 0; --j) {
    const int m = p.mods[j];
    int carry = d[j];
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      if (LL || l < p.L) {
        const int v = limb[l] * m + carry;
        limb[l] = v & LIMB_MASK;
        carry = v >> LIMB_BITS;
      }
    }
  }
  bool ge = false, eq = true;
#pragma unroll
  for (int l = NL - 1; l >= 0; --l) {
    if (LL || l < p.L) {
      ge = ge || (eq && limb[l] > p.half_limbs[l]);
      eq = eq && limb[l] == p.half_limbs[l];
    }
  }
  const bool is_neg = ge || eq;
  int nlimb[MAXL];
  int borrow = 0;
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    if (LL || l < p.L) {
      const int v = p.M_limbs[l] - limb[l] - borrow;
      borrow = v < 0 ? 1 : 0;
      nlimb[l] = v + borrow * (1 << LIMB_BITS);
    }
  }
  const float pos = limbs_to_float<LL>(limb, p.L);
  const float neg = limbs_to_float<LL>(nlimb, p.L);
  return is_neg ? -neg : pos;
}

// The output element (gm, gn) from its C folded channel residues.  EMIT
// is a.emit, or -1 to read it at run time; LL the limb count the emit
// reads (p.L, or p.L1 for the CRT limbs) when known at compile time, else
// 0.  An element outside the output (``in`` false) is computed on clamped
// indices and not written, so the 32-row tile's elements run without
// branches and interleave.
template <int C, int EMIT = -1, int LL = 0, bool RAW = false>
__device__ __forceinline__ void tile_emit(const int (&r)[C], int gm, int gn,
                                          const TileArgs& a,
                                          const FusedPlan& p,
                                          bool in = true) {
  const int emit = EMIT < 0 ? a.emit : EMIT;
  gm = in ? gm : 0;
  gn = in ? gn : 0;
  const size_t plane = static_cast<size_t>(a.M) * a.N;
  const size_t at = static_cast<size_t>(gm) * a.N + gn;
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
    constexpr int NL = LL ? LL : MAXL;
    int limb[MAXL];
#pragma unroll
    for (int l = 0; l < NL; ++l) limb[l] = 0;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int alpha = mod_u(static_cast<unsigned>(r[j]) *
                                  static_cast<unsigned>(p.crt_v[j]), j, p);
      int carry = 0;
#pragma unroll
      for (int l = 0; l < NL; ++l) {
        if (LL || l < p.L1) {
          const int v = limb[l] + p.crt_mc[j][l] * alpha + carry;
          limb[l] = v & LIMB_MASK;
          carry = v >> LIMB_BITS;
        }
      }
    }
    int* out = static_cast<int*>(a.out);
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      if (in && (LL || l < p.L1)) out[l * plane + at] = limb[l];
    }
    return;
  }
  const float val = mrc_value<C, LL>(r, p);
  if (emit == EMIT_RESIDUES) {
    // clip(round(y*s_col / creq), +-127), then its canonical residues
    float q = rintf(__fdiv_rn(__fmul_rn(val, a.scol[gn]), *a.creq));
    q = fminf(fmaxf(q, -127.f), 127.f);
    const int qi = static_cast<int>(q);
    int8_t* out = static_cast<int8_t*>(a.out);
#pragma unroll
    for (int j = 0; j < C; ++j) {
      if (in) {
        out[j * plane + at] = static_cast<int8_t>(mod_c(qi, j, p));
      }
    }
    return;
  }
  // the dequant epilogue (y*s_row)*s_col.  A quantized or residue-in A
  // operand always brings both factors; the raw int8 operand's (RAW, the
  // A_SHARED instances) are each optional, then *scale: a null operand
  // multiplies by nothing, so no scale at all writes the exact product
  float y;
  if constexpr (RAW) {
    y = val;
    if (a.srow) y = __fmul_rn(y, a.srow[gm]);
    if (a.scol) y = __fmul_rn(y, a.scol[gn]);
    if (a.scale) y = __fmul_rn(y, a.scale[at]);
  } else {
    y = __fmul_rn(__fmul_rn(val, a.srow[gm]), a.scol[gn]);
  }
  if (in) static_cast<float*>(a.out)[at] = y;
}

// `tile_emit` with the limb count fixed at compile time for the counts the
// repo's bases have (2 for the int8-matmul bases, 3 for the chain bases).
template <int C, bool RAW>
__device__ __forceinline__ void tile_emit_nl(const int (&r)[C], int gm,
                                             int gn, const TileArgs& a,
                                             const FusedPlan& p) {
  const int nl = a.emit == EMIT_CRT_LIMBS ? p.L1 : p.L;
  if (nl == 2) {
    tile_emit<C, -1, 2, RAW>(r, gm, gn, a, p);
  } else if (nl == 3) {
    tile_emit<C, -1, 3, RAW>(r, gm, gn, a, p);
  } else {
    tile_emit<C, -1, 0, RAW>(r, gm, gn, a, p);
  }
}

// The output element (gm, gn) from its C channel accumulators: the fold,
// then `tile_emit`.
template <int C, bool RAW, int EMIT = -1>
__device__ __forceinline__ void tile_epilogue(const int (&acc)[C], int gm,
                                              int gn, const TileArgs& a,
                                              const FusedPlan& p,
                                              bool in = true) {
  int r[C];
#pragma unroll
  for (int j = 0; j < C; ++j) r[j] = fold_channel(acc[j], j, p);
  tile_emit<C, EMIT, 0, RAW>(r, gm, gn, a, p, in);
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

// Row and column, within the 32-row tile, of a thread's accumulator i:
// i = 8*mi + 4*ni + q, A fragment mi, B fragment ni, C register q.
__device__ __forceinline__ void acc_elem(int tid, int i, int& r, int& col) {
  const int lane = tid & 31, warp = tid >> 5;
  r = (i >> 3) * 16 + (lane >> 2) + ((i >> 1) & 1) * 8;
  col = warp * 16 + ((i >> 2) & 1) * 8 + 2 * (lane & 3) + (i & 1);
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
            const uint32_t x = word;
            word = 0;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int g = static_cast<int8_t>(gate[it] >> (8 * q));
              const int v = static_cast<int8_t>(x >> (8 * q));
              word |= static_cast<uint32_t>(mod_u(
                          static_cast<unsigned>(mod_c(g, c, plan) * v), c,
                          plan)) << (8 * q);
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
            u |= static_cast<uint32_t>(
                     mod_c(static_cast<int8_t>(v >> (8 * q)), c, plan))
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
template <int C, bool RAW, int EMIT>
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
      acc_elem(tid, i0 + u, r, col);
      int e[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        e[c] = acc[u][c];
#pragma unroll
        for (int q = u + G; q < 16; q += G) {
          e[c] = q == i0 + u ? acc[q][c] : e[c];
        }
      }
      tile_epilogue<C, RAW, EMIT>(e, m0 + r, n0 + col, a, plan,
                             m0 + r < a.M && n0 + col < a.N);
    }
  }
}

// Blocks per SM each tile is compiled for.  32-row (registers a thread:
// 168 for three, 255 for two): its C x 16 accumulators allow three up to
// 5 channels, or 3 for A_PLANES, whose prologue holds C planes.  16-row:
// two (<= 128 registers), so a decode launch's clusters fit in one wave.
template <int TMR, int C, int AM>
constexpr int tile_min_blocks() {
  return TMR == TM ? 2 : C <= (AM == A_PLANES ? 3 : 5) ? 3 : 2;
}

// The 32-row tile: one block per output tile (K is never split), the
// tensor-core K loop, then the thread's 16 elements.
template <int C, int AM, bool ENCODED>
__device__ __forceinline__ void mma_tile(const TileArgs& a,
                                         const FusedPlan& plan) {
  __shared__ __align__(16) int8_t xs[AM == A_PLANES ? C : 1][TM_MMA][TK];
  __shared__ __align__(16) int8_t wsm[C][TN][TK];
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * TN;
  const int m0 = blockIdx.y * TM_MMA;
  int acc[16][C];
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0;
  mma_mainloop<C, AM, ENCODED>(a, plan, xs, wsm, acc, m0, n0, 0, a.K, tid);
  constexpr bool RAW = AM == A_SHARED;   // its epilogue factors optional
  switch (a.emit) {
    case EMIT_FLOAT:
      mma_epilogue<C, RAW, EMIT_FLOAT>(acc, m0, n0, a, plan, tid);
      break;
    case EMIT_RESIDUES:
      mma_epilogue<C, RAW, EMIT_RESIDUES>(acc, m0, n0, a, plan, tid);
      break;
    case EMIT_CANONICAL:
      mma_epilogue<C, RAW, EMIT_CANONICAL>(acc, m0, n0, a, plan, tid);
      break;
    default:
      mma_epilogue<C, RAW, EMIT_CRT_LIMBS>(acc, m0, n0, a, plan, tid);
  }
}

// Dynamic shared memory of a 16-row instance: the ring of raw weight
// rows (n fastest), two buffers of transposed weights (k fastest,
// KPAD-byte rows), two of the A tile, the split-K receive buffer (the
// partial sums the cluster's other ranks send for the elements this rank
// owns, [rank][channel][slot]; a region of its own, since a neighbour may
// send while this block is still in its K loop) and the mbarrier that
// counts them in.  After the K loop the block gathers its own partial
// sums, [owner][channel][slot], over the loop's buffers (SLOTS bounds
// S x slots a rank: slots are the rank's share rounded up to 4).
template <int C, int AM, bool ENCODED>
struct Tile16 {
  static constexpr int AP = AM == A_PLANES ? C : 1;
  static constexpr int WP = ENCODED ? C : 1;   // weight planes
  static constexpr int STAGE = WP * TK * TN;
  static constexpr int RING = ENCODED ? STAGES * STAGE : 0;
  static constexpr int WSM = C * TN * KPAD;
  static constexpr int XS = AP * TM * TK;
  static constexpr int SLOTS = TM * TN + 4 * MAX_SPLITS;
  static constexpr int RECV = C * SLOTS * 4;
  static constexpr int BYTES = RING + 2 * WSM + 2 * XS + RECV + 16;
  static_assert(STAGE % 16 == 0 && WSM % 16 == 0 && XS % 16 == 0,
                "16-byte aligned parts");
  static_assert(2 * WSM >= RECV, "the gather fits the K loop's buffers");
};

__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];\n" ::"l"(p));
}
using hopper::bulk_to_rank;
using hopper::cluster_arrive_relaxed;
using hopper::cluster_wait;
using hopper::cp_async16;
using hopper::cp_async_commit;
using hopper::cp_async_wait;
using hopper::fence_mbarrier_init;
using hopper::fence_proxy_async;
using hopper::map_rank;
using hopper::mbar_expect;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::smem_u32;

// The 16-row tile's A operand of one K step, read ahead into registers:
// thread tid holds the elements e = tid + i*THREADS (row e / TK, k
// e % TK), raw (residue planes four bytes to a register); `store`
// quantizes or gates them into an A buffer.  Its rows are the same at
// every step, so the row scales are read once.
template <int C, int AM>
struct Dp4aA {
  static constexpr bool QUANT = AM == A_F32 || AM == A_BF16;
  static constexpr int AP = AM == A_PLANES ? C : 1;
  static constexpr int PER = TM * TK / THREADS;
  uint32_t raw[PER][(AP + 3) / 4];
  int gate[PER];
  float srow[PER];

  __device__ __forceinline__ Dp4aA(const TileArgs& a, int m0, int tid) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int gm = m0 + (tid + i * THREADS) / TK;
      srow[i] = QUANT && gm < a.M ? __ldg(a.srow + gm) : 1.f;
      gate[i] = 0;
    }
  }

  __device__ __forceinline__ void load(const TileArgs& a, int m0, int k0,
                                       int kend, int tid) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = tid + i * THREADS;
      const int gm = m0 + e / TK, gk = k0 + e % TK;
      const bool in = gm < a.M && gk < kend;
      const size_t at = static_cast<size_t>(gm) * a.K + gk;
      if constexpr (AM == A_F32) {
        raw[i][0] = in ? __float_as_uint(
                             __ldg(static_cast<const float*>(a.x) + at))
                       : 0u;
      } else if constexpr (AM == A_BF16) {
        raw[i][0] =
            in ? __ldg(static_cast<const unsigned short*>(a.x) + at) : 0u;
      } else {
        const int8_t* x = static_cast<const int8_t*>(a.x) + at;
        const size_t plane = static_cast<size_t>(a.M) * a.K;
#pragma unroll
        for (int c = 0; c < AP; ++c) {
          const uint32_t b =
              in ? static_cast<uint8_t>(__ldg(x + c * plane)) : 0u;
          raw[i][c / 4] = c % 4 ? raw[i][c / 4] | b << (8 * (c % 4)) : b;
        }
        if constexpr (AM == A_PLANES) {
          gate[i] = in && a.gate ? __ldg(a.gate + at) : 0;
        }
      }
    }
  }

  // Slots outside M or K are 0, the residue of 0.
  __device__ __forceinline__ void store(const TileArgs& a,
                                        const FusedPlan& plan, int8_t* xs,
                                        int m0, int k0, int kend,
                                        int tid) const {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / TK, kk = e % TK;
      if constexpr (QUANT) {
        // the quantizer's round-half-even / clip, IEEE divide by the row
        // scale; bf16 -> f32 is exact: the bits move up 16 places
        int q = 0;
        if (m0 + r < a.M && k0 + kk < kend) {
          const float x = __uint_as_float(AM == A_F32 ? raw[i][0]
                                                      : raw[i][0] << 16);
          float v = __fdiv_rn(x, srow[i]);
          v = fminf(fmaxf(rintf(v), -127.f), 127.f);
          q = static_cast<int>(v);
        }
        xs[r * TK + kk] = static_cast<int8_t>(q);
      } else if constexpr (AM == A_SHARED) {
        xs[r * TK + kk] = static_cast<int8_t>(raw[i][0]);
      } else {
        // canonical residues, times |gate|_m when gated: both factors are
        // below m, so one int32 product and a floored mod are exact
#pragma unroll
        for (int c = 0; c < AP; ++c) {
          int v = static_cast<int8_t>(raw[i][c / 4] >> (8 * (c % 4)));
          if (a.gate) {
            v = mod_u(static_cast<unsigned>(mod_c(gate[i], c, plan) * v), c,
                      plan);
          }
          xs[(c * TM + r) * TK + kk] = static_cast<int8_t>(v);
        }
      }
    }
  }
};

// Encoded weights of one K step, streamed: block b (plane b / 32, k group
// kg = b / 4 % 8, 16-column chunk q = b % 4) is 4 rows x 16 bytes, copied
// by one thread with four cp.async (rows past kend, columns past N
// zero-filled) and transposed by the same thread once they land
// (`transpose_own`), so no barrier stands between the two.  Needs a.w16.
template <int C>
__device__ __forceinline__ void issue_w(const TileArgs& a, int8_t* stage,
                                        int n0, int k0, int kend,
                                        int tid) {
  constexpr int BLOCKS = C * (TK / 4) * (TN / 16);
#pragma unroll
  for (int i = 0; i < (BLOCKS + THREADS - 1) / THREADS; ++i) {
    const int b = tid + i * THREADS;
    if (b < BLOCKS) {
      const int p = b / ((TK / 4) * (TN / 16));
      const int kg = b / (TN / 16) % (TK / 4), q = b % (TN / 16);
      const int gn = n0 + 16 * q;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kk = 4 * kg + j, gk = k0 + kk;
        const bool in = gk < kend && gn < a.N;
        const int8_t* src =
            a.w + (static_cast<size_t>(p) * a.K + (in ? gk : 0)) * a.N +
            (in ? gn : 0);
        cp_async16(stage + (p * TK + kk) * TN + 16 * q, src, in);
      }
    }
  }
}

// A thread's own landed blocks into the transposed weights
// wsm[C][TN][KPAD]: 4 rows x 4 words, each 4 x 4 bytes transposed with
// __byte_perm into one k-fastest word per column.
template <int C>
__device__ __forceinline__ void transpose_own(const int8_t* stage,
                                              int8_t* wsm, int tid) {
  constexpr int BLOCKS = C * (TK / 4) * (TN / 16);
#pragma unroll
  for (int i = 0; i < (BLOCKS + THREADS - 1) / THREADS; ++i) {
    const int b = tid + i * THREADS;
    if (b < BLOCKS) {
      const int p = b / ((TK / 4) * (TN / 16));
      const int kg = b / (TN / 16) % (TK / 4), q = b % (TN / 16);
      uint4 row[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        row[j] = *reinterpret_cast<const uint4*>(
            stage + (p * TK + 4 * kg + j) * TN + 16 * q);
      }
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        uint32_t x[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          x[j] = w == 0 ? row[j].x : w == 1 ? row[j].y
                 : w == 2 ? row[j].z : row[j].w;
        }
        const uint32_t t0 = __byte_perm(x[0], x[1], 0x5140);
        const uint32_t t1 = __byte_perm(x[0], x[1], 0x7362);
        const uint32_t t2 = __byte_perm(x[2], x[3], 0x5140);
        const uint32_t t3 = __byte_perm(x[2], x[3], 0x7362);
        // colw[s]: k 4*kg .. 4*kg+3 of column 16*q + 4*w + s
        const uint32_t colw[4] = {
            __byte_perm(t0, t2, 0x5410), __byte_perm(t0, t2, 0x7632),
            __byte_perm(t1, t3, 0x5410), __byte_perm(t1, t3, 0x7632)};
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int col = 16 * q + 4 * w + s;
          *reinterpret_cast<uint32_t*>(wsm + (p * TN + col) * KPAD +
                                       4 * kg) = colw[s];
        }
      }
    }
  }
}

// Weights of one K step read ahead into registers, for live int8 weights
// and for rows that are not 16-byte multiples: thread tid holds words
// e = tid + i*THREADS (k e / 16, columns 4*(e % 16)..+3) of each plane,
// read as one int32 when the rows are 4-byte aligned (``vec``), byte by
// byte otherwise; `store` writes them transposed (k fastest), as |w|_m
// per channel for live weights.
template <int C, bool ENCODED>
struct Dp4aW {
  static constexpr int WP = ENCODED ? C : 1;
  static constexpr int PER = TK * TN / 4 / THREADS;
  uint32_t w[PER][WP];

  __device__ __forceinline__ void load(const TileArgs& a, int n0, int k0,
                                       int kend, int tid) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = tid + i * THREADS;
      const int gk = k0 + e / (TN / 4), gn = n0 + 4 * (e % (TN / 4));
      const bool in = gk < kend && gn < a.N;
#pragma unroll
      for (int p = 0; p < WP; ++p) {
        const int8_t* row =
            a.w + (static_cast<size_t>(p) * a.K + (in ? gk : 0)) * a.N;
        uint32_t v = 0;
        if (in) {
          if (a.vec) {
            v = __ldg(reinterpret_cast<const unsigned int*>(row + gn));
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (gn + j < a.N) {
                v |= static_cast<uint32_t>(static_cast<uint8_t>(
                         __ldg(row + gn + j))) << (8 * j);
              }
            }
          }
        }
        w[i][p] = v;
      }
    }
  }

  __device__ __forceinline__ void store(const FusedPlan& plan, int8_t* wsm,
                                        int tid) const {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = tid + i * THREADS;
      const int kk = e / (TN / 4), n4 = 4 * (e % (TN / 4));
#pragma unroll
      for (int cc = 0; cc < C; ++cc) {
        const uint32_t v = w[i][ENCODED ? cc : 0];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          int b = static_cast<int8_t>(v >> (8 * j));
          if (!ENCODED) b = mod_c(b, cc, plan);
          wsm[(cc * TN + n4 + j) * KPAD + kk] = static_cast<int8_t>(b);
        }
      }
    }
  }
};

// One K step of per-channel int8 dot products into int32 (no
// reduction) for a thread's NR live rows tr, tr+4, ...: the live count is
// the same across a warp, so the loop has no branch and its shared loads
// issue together.
template <int C, int AP, int NR>
__device__ __forceinline__ void dp4a_step(const int8_t* xs,
                                          const int8_t* wsm,
                                          int (&acc)[NACC][C], int tn,
                                          int tr) {
#pragma unroll
  for (int k4 = 0; k4 < TK / 4; ++k4) {
    int wv[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      wv[c] = *reinterpret_cast<const int*>(wsm + (c * TN + tn) * KPAD +
                                            4 * k4);
    }
#pragma unroll
    for (int i = 0; i < NR; ++i) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int xv = *reinterpret_cast<const int*>(
            xs + ((AP == 1 ? 0 : c) * TM + tr + RSTEP * i) * TK + 4 * k4);
        acc[i][c] = __dp4a(xv, wv[c], acc[i][c]);
      }
    }
  }
}

// The 16-row tile.  Step s + 1's weights and A are converted into one
// buffer while step s's __dp4a read the other, so a step takes one
// barrier; encoded weights stream through the ring (STAGES - 1 steps
// ahead), A and live or unaligned weights a step ahead in registers.
// Unsplit, each thread runs the epilogue of its 4 elements; split, the
// cluster reduces the partial sums through distributed shared memory
// (header).
template <int C, int AM, bool ENCODED>
__device__ __forceinline__ void dp4a_tile(const TileArgs& a,
                                          const FusedPlan& plan) {
  using L = Tile16<C, AM, ENCODED>;
  constexpr bool RAW = AM == A_SHARED;   // its epilogue factors optional
  extern __shared__ __align__(16) int8_t tile_smem[];
  int8_t* ring = tile_smem;
  int8_t* wsm = tile_smem + L::RING;        // buffer b at wsm + b * L::WSM
  int8_t* xs = wsm + 2 * L::WSM;            // buffer b at xs + b * L::XS
  int* recv = reinterpret_cast<int*>(xs + 2 * L::XS);
  const unsigned mbar = smem_u32(tile_smem + L::BYTES - 16);
  const int M = a.M, N = a.N;
  const int tid = threadIdx.x;
  const int tn = tid % TN, tr = tid / TN;
  const int n0 = blockIdx.x * TN;
  const int m0 = blockIdx.y * TM;
  const int kbeg = blockIdx.z * a.k_per_split;
  const int kend = min(a.K, kbeg + a.k_per_split);
  const int steps = (kend - kbeg + TK - 1) / TK;   // >= 1: the launcher's
                                                   // split leaves no block
                                                   // without K
  const int rows = min(TM, M - m0);
  // live rows of this thread, the same across a warp
  const int live = min(NACC, max(0, (rows - tr + RSTEP - 1) / RSTEP));
  const bool stream = ENCODED && a.w16;
  int acc[NACC][C];
#pragma unroll
  for (int i = 0; i < NACC; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0;

  // Split K: the S blocks of this output tile are one cluster, and rank r
  // owns elements [r*share, (r+1)*share) of the tile's rows x 64 (share a
  // multiple of 4, so every rank's slice is whole 16-byte pieces).  Its
  // mbarrier expects the other ranks' partial sums of them; the cluster
  // barrier begun here makes the mbarriers ready before the first copy.
  const bool split = gridDim.z > 1;
  const int S = static_cast<int>(gridDim.z);   // cluster (1, 1, S)
  const int rank = static_cast<int>(blockIdx.z);
  const int share = ((rows * TN + S - 1) / S + 3) / 4 * 4;
  const int e0 = rank * share;
  const int e1 = min(rows * TN, e0 + share);
  const unsigned slice = static_cast<unsigned>(C * share * 4);   // bytes
  if (split) {
    if (tid == 0) {
      mbar_init(mbar, 1);
      mbar_expect(mbar, static_cast<unsigned>(S - 1) * slice);
      fence_mbarrier_init();
    }
    cluster_arrive_relaxed();
  }
  Dp4aA<C, AM> areg(a, m0, tid);
  Dp4aW<C, ENCODED> wreg;
  if (stream) {
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < steps) issue_w<C>(a, ring + s * L::STAGE, n0, kbeg + s * TK,
                                kend, tid);
      cp_async_commit();
    }
  } else {
    wreg.load(a, n0, kbeg, kend, tid);
  }
  areg.load(a, m0, kbeg, kend, tid);
  // step 0 into buffer 0
  if (stream) {
    cp_async_wait<STAGES - 2>();   // this thread's copies of step 0
    transpose_own<C>(ring, wsm, tid);
  } else {
    wreg.store(plan, wsm, tid);
  }
  areg.store(a, plan, xs, m0, kbeg, kend, tid);
  if (steps > 1) {
    areg.load(a, m0, kbeg + TK, kend, tid);
    if (!stream) wreg.load(a, n0, kbeg + TK, kend, tid);
  }
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int8_t* wcur = wsm + (s & 1) * L::WSM;
    const int8_t* xcur = xs + (s & 1) * L::XS;
    int8_t* wnext = wsm + ((s + 1) & 1) * L::WSM;
    int8_t* xnext = xs + ((s + 1) & 1) * L::XS;
    if (stream) {
      // the ring slot refilled here held step s - 1, transposed by this
      // same thread in iteration s - 2
      const int ahead = s + STAGES - 1;
      if (ahead < steps) {
        issue_w<C>(a, ring + (ahead % STAGES) * L::STAGE, n0,
                   kbeg + ahead * TK, kend, tid);
      }
      cp_async_commit();
    }
    static_assert(NACC == 4, "one dp4a_step per live-row count");
    switch (live) {
      case 4: dp4a_step<C, L::AP, 4>(xcur, wcur, acc, tn, tr); break;
      case 3: dp4a_step<C, L::AP, 3>(xcur, wcur, acc, tn, tr); break;
      case 2: dp4a_step<C, L::AP, 2>(xcur, wcur, acc, tn, tr); break;
      case 1: dp4a_step<C, L::AP, 1>(xcur, wcur, acc, tn, tr); break;
      default: break;
    }
    if (s + 1 < steps) {
      const int k1 = kbeg + (s + 1) * TK;
      if (stream) {
        cp_async_wait<STAGES - 2>();   // this thread's copies of step s+1
        transpose_own<C>(ring + ((s + 1) % STAGES) * L::STAGE, wnext,
                         tid);
      } else {
        wreg.store(plan, wnext, tid);
      }
      areg.store(a, plan, xnext, m0, k1, kend, tid);
      if (s + 2 < steps) {
        areg.load(a, m0, k1 + TK, kend, tid);
        if (!stream) wreg.load(a, n0, k1 + TK, kend, tid);
      }
    }
    __syncthreads();   // buffer s+1 complete; buffer s free
  }

  if (gridDim.z == 1) {
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int r = tr + RSTEP * i;
      if (m0 + r < M && n0 + tn < N) {
        tile_epilogue<C, RAW>(acc[i], m0 + r, n0 + tn, a, plan);
      }
    }
    return;
  }

  // Split K: each rank gathers its partial sums by owner in its own
  // shared memory (over the loop's buffers, retired by the last barrier),
  // and one thread sends each other rank its slice with one bulk copy
  // (the copy engine moves it; nothing waits on it here).  The owner's
  // mbarrier counts the bytes in; the owner adds its own slice and runs
  // the epilogue.  A block's slices are read by the copy engine after it
  // may have finished, so the cluster barrier closed at the end keeps
  // every block until all have received theirs.
  int* gather = reinterpret_cast<int*>(tile_smem);   // [S][C][share]
#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    if (i < live) {
      const int e = (tr + RSTEP * i) * TN + tn;
      const int owner = e / share;
      int* dst = gather + owner * C * share + (e - owner * share);
#pragma unroll
      for (int c = 0; c < C; ++c) dst[c * share] = acc[i][c];
    }
  }
  fence_proxy_async();
  cluster_wait();   // every rank's mbarrier is initialized
  __syncthreads();  // the gather is complete
  if (tid < S && tid != rank) {
    bulk_to_rank(map_rank(smem_u32(recv) + rank * slice, tid),
                 smem_u32(gather) + tid * slice, slice, map_rank(mbar, tid));
  }
  // the epilogue's scales, fetched into L1 while the copies land
  for (int e = e0 + tid; e < e1; e += THREADS) {
    if (a.srow) prefetch_l1(a.srow + m0 + e / TN);
    if (a.scol && n0 + e % TN < N) prefetch_l1(a.scol + n0 + e % TN);
  }
  mbar_wait(mbar, 0);   // every other rank's sums of this rank's elements
  cluster_arrive_relaxed();
  // The fold of every (element, channel) of this rank's share, spread over
  // the block's threads (the channels' ladders are independent; one thread
  // an element would leave most of the block idle on a long chain): the
  // canonical emit stores the folded residues at once, the others write
  // them into this rank's own receive slot, which no copy fills, and run
  // the rest of the emit per element.  One or two channels are short
  // enough to fold and emit per element in one pass.
  const int cnt = max(0, e1 - e0);
  const int* own = gather + rank * C * share;
  int* folded = recv + rank * C * share;   // [C][share]
  const bool canonical = a.emit == EMIT_CANONICAL;
  const bool spread = canonical || C > 2;
  for (int w = tid; spread && w < C * cnt; w += THREADS) {
    const int c = w / cnt, j = w - c * cnt;
    int v = own[c * share + j];
#pragma unroll
    for (int q = 0; q < MAX_SPLITS; ++q) {
      if (q < S && q != rank) v += recv[(q * C + c) * share + j];
    }
    v = fold_channel(v, c, plan);
    const int e = e0 + j;
    if (!canonical) {
      folded[c * share + j] = v;
    } else if (n0 + e % TN < N) {
      static_cast<int*>(a.out)[static_cast<size_t>(c) * M * N +
                               static_cast<size_t>(m0 + e / TN) * N + n0 +
                               e % TN] = v;
    }
  }
  if (!canonical) {
    if (spread) __syncthreads();   // every channel of the share is folded
    for (int j = tid; j < cnt; j += THREADS) {
      const int e = e0 + j;
      int r[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (spread) {
          r[c] = folded[c * share + j];
        } else {
          int v = own[c * share + j];
#pragma unroll
          for (int q = 0; q < MAX_SPLITS; ++q) {
            if (q < S && q != rank) v += recv[(q * C + c) * share + j];
          }
          r[c] = fold_channel(v, c, plan);
        }
      }
      if (n0 + e % TN < N) {
        tile_emit_nl<C, RAW>(r, m0 + e / TN, n0 + e % TN, a, plan);
      }
    }
  }
  cluster_wait();   // every block has received its slices
}

template <int TMR, int C, int AM, bool ENCODED>
__global__ void __launch_bounds__(TMR == TM ? THREADS : MMA_THREADS,
                                  tile_min_blocks<TMR, C, AM>())
rns_tile_kernel(TileArgs a, FusedPlan plan) {
  static_assert(TMR == TM || (TMR == TM_MMA && C <= MMA_MAXC),
                "tile not compiled");
  if constexpr (TMR == TM_MMA) {
    mma_tile<C, AM, ENCODED>(a, plan);
  } else {
    dp4a_tile<C, AM, ENCODED>(a, plan);
  }
}

// Dynamic shared memory of the 16-row instance (C, AM, encoded), in bytes;
// 0 for one not compiled (launch_tile's cases).
template <int AM>
int tile16_smem_bytes(int C, bool encoded) {
  if (!encoded && AM == A_PLANES) return 0;
  switch (C) {
#define RNS_SMEM_CASE(CC)                                          \
  case CC:                                                         \
    return encoded ? Tile16<CC, AM, true>::BYTES                   \
                   : Tile16<CC, AM, false>::BYTES;
    RNS_SMEM_CASE(1) RNS_SMEM_CASE(2) RNS_SMEM_CASE(3) RNS_SMEM_CASE(4)
    RNS_SMEM_CASE(5) RNS_SMEM_CASE(6) RNS_SMEM_CASE(7) RNS_SMEM_CASE(8)
    RNS_SMEM_CASE(9) RNS_SMEM_CASE(10) RNS_SMEM_CASE(11)
#undef RNS_SMEM_CASE
    default:
      return 0;
  }
}

// Set a 16-row instance's dynamic shared memory limit and check that a
// cluster of MAX_SPLITS of its blocks can be co-scheduled on the card.
template <typename Kernel>
int prepare_tile16(Kernel kernel, int smem) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = MAX_SPLITS;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, 1, MAX_SPLITS);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (e != cudaSuccess) return static_cast<int>(e);
  return clusters > 0 ? 0 : static_cast<int>(cudaErrorLaunchOutOfResources);
}

// One launch of an instance.  The 16-row tile is launched with
// cudaLaunchKernelEx, as a cluster of a.splits blocks along z when K is
// split; its first launch sets its shared memory limit (once per
// instance and process).
template <int TMR, int C, int AM, bool ENCODED>
int launch_instance(const TileArgs& a, const FusedPlan& plan, dim3 grid,
                    cudaStream_t stream) {
  auto* kernel = rns_tile_kernel<TMR, C, AM, ENCODED>;
  if constexpr (TMR == TM_MMA) {
    kernel<<<grid, MMA_THREADS, 0, stream>>>(a, plan);
    return static_cast<int>(cudaGetLastError());
  } else {
    constexpr int smem = Tile16<C, AM, ENCODED>::BYTES;
    static const int ready = prepare_tile16(kernel, smem);
    if (ready != 0) return ready;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = 1;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = a.splits;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = &attr;
    cfg.numAttrs = a.splits > 1 ? 1 : 0;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, a, plan);
    const cudaError_t last = cudaGetLastError();   // cleared either way
    return static_cast<int>(e != cudaSuccess ? e : last);
  }
}

// The 16-row instances of a mode are split by channel count across two
// files, C <= SPLIT_C and C > SPLIT_C, so that they compile in parallel.
constexpr int SPLIT_C = 7;

// Launch the tile kernel of height TMR and mode AM for the plan's channel
// count, with the instances of CLO..CHI channels compiled in; returns a
// cudaError_t, or -1 for a channel count not compiled in.
template <int TMR, int AM, int CLO = 1, int CHI = 11>
int launch_tile(const TileArgs& a, const FusedPlan& plan,
                cudaStream_t stream) {
  const dim3 grid((a.N + TN - 1) / TN, (a.M + TMR - 1) / TMR, a.splits);
  if (TMR == TM_MMA && !(a.vec && a.avec)) return -1;
  if (a.splits < 1 || a.splits > (TMR == TM ? MAX_SPLITS : 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
// Every A mode takes encoded weights; all but the residue planes also
// take live (K, N) int8 weights, converted per tile.  Channel slices
// narrower than any basis (C = 1, 2) occur only in the CRT partial
// launch, which takes every mode and weight form the wider ones do.
#define RNS_TILE_CASE(CC)                                                   \
  case CC:                                                                  \
    if constexpr (CLO <= CC && CC <= CHI &&                                 \
                  (TMR == TM || CC <= MMA_MAXC)) {                          \
      if (a.encoded) return launch_instance<TMR, CC, AM, true>(a, plan,     \
                                                               grid,       \
                                                               stream);    \
      if constexpr (AM != A_PLANES) {                                       \
        return launch_instance<TMR, CC, AM, false>(a, plan, grid, stream);  \
      }                                                                     \
    }                                                                       \
    return -1;
  switch (plan.C) {
    RNS_TILE_CASE(1)
    RNS_TILE_CASE(2)
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
  return -1;
}

}  // namespace rns

// Per-file entry points (each .cu instantiates one A mode; the 16-row
// ones, the channel counts up to rns::SPLIT_C or, `_wide`, above it).
int rns_launch_tile_f32(const TileArgs& a, const FusedPlan& plan,
                        cudaStream_t stream);
int rns_launch_tile_bf16(const TileArgs& a, const FusedPlan& plan,
                         cudaStream_t stream);
int rns_launch_tile_raw(const TileArgs& a, const FusedPlan& plan,
                        cudaStream_t stream);
int rns_launch_tile_int8(const TileArgs& a, const FusedPlan& plan,
                         cudaStream_t stream);
int rns_launch_tile_f32_wide(const TileArgs& a, const FusedPlan& plan,
                             cudaStream_t stream);
int rns_launch_tile_bf16_wide(const TileArgs& a, const FusedPlan& plan,
                              cudaStream_t stream);
int rns_launch_tile_raw_wide(const TileArgs& a, const FusedPlan& plan,
                             cudaStream_t stream);
int rns_launch_tile_int8_wide(const TileArgs& a, const FusedPlan& plan,
                              cudaStream_t stream);
// The 32-row tensor-core instances, in files of their own so they compile
// in parallel with the 16-row ones.
int rns_launch_tile_mma_f32(const TileArgs& a, const FusedPlan& plan,
                            cudaStream_t stream);
int rns_launch_tile_mma_bf16(const TileArgs& a, const FusedPlan& plan,
                             cudaStream_t stream);
int rns_launch_tile_mma_raw(const TileArgs& a, const FusedPlan& plan,
                            cudaStream_t stream);
int rns_launch_tile_mma_int8(const TileArgs& a, const FusedPlan& plan,
                             cudaStream_t stream);
// The 64-row wgmma + TMA instances of the raw int8 A mode (rns_tile_wg.cuh),
// encoded and live weights in files of their own.
int rns_launch_tile_wg_raw(const TileArgs& a, const FusedPlan& plan,
                           cudaStream_t stream);
int rns_launch_tile_wg_raw_live(const TileArgs& a, const FusedPlan& plan,
                                cudaStream_t stream);
