// Hand-written Hopper (sm_90a) kernels of the twit-RNS port.
//
//   rns_fused_matmul — replaces the Pallas megakernel
//     src/repro/kernels/rns_fused.py: rns_fused_matmul (body _kernel), in its
//     quantize + float-emit variant: round/clip of the float activations by
//     the row scale, C per-channel int8 products accumulated in int32, the
//     signed fold ladder, MRC digits, 15-bit limb Horner, the signed-range
//     fix against ceil(M/2), the float32 recombination and (y*s_row)*s_col.
//   rns_forward — replaces src/repro/kernels/rns_convert.py: rns_forward, the
//     floored x mod m_c per channel that encodes the weights.
//
// What bounds them on an H100: at decode (M <= 64 rows) the fused kernel
// reads C int8 residues per weight, C*K*N bytes per launch, and does
// C*M*K*N multiply-adds: far below the int8 rate, so device memory bounds
// it.  Its design answers that with a grid wide enough to keep every SM
// streaming weights: when the (M/16)x(N/64) output tiles are fewer than the
// SMs, the K loop is split across blocks, each block adds its int32 partial
// sums into a zeroed workspace with atomics (integer sums, so the order is
// irrelevant and the result exact), and the last block of a tile runs the
// epilogue.  rns_forward reads each weight once and writes C residues: it is
// bound by bytes too.
//
// Integer stages are exact.  The float stages replay the reference's op
// order with explicit round-to-nearest intrinsics, and the file is built
// without --use_fast_math, so no contraction or approximate divide changes a
// bit.  The C interface returns cudaGetLastError() after each launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

}  // namespace

// Plan tables, passed by value as a kernel argument (mirrors the ctypes
// Structure in kernels/rns_fused.py field for field).
struct FusedPlan {
  int C, R, n_sub, L;
  int mods[MAXC];
  int sched_s[MAXC][MAXR];
  int sched_c[MAXC][MAXR];
  int inv[MAXC][MAXC];
  int M_limbs[MAXL];
  int half_limbs[MAXL];
};

struct ForwardMods {
  int C;
  int m[MAXC];
};

namespace {

__device__ __forceinline__ int floor_mod(int a, int m) {
  // CUDA % truncates toward zero; the reference's jnp.mod is floored.
  const int r = a % m;
  return r < 0 ? r + m : r;
}

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
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

// Stage 4 + Stage 5 for one output element: fold each channel's signed
// accumulator, MRC digits, limb Horner, signed fix, float, dequant.
template <int C>
__device__ __forceinline__ float epilogue(const int (&acc)[C],
                                          const FusedPlan& p, float s_row,
                                          float s_col) {
  int d[C];
#pragma unroll
  for (int j = 0; j < C; ++j) {
    const int m = p.mods[j];
    const int a = acc[j];
    int v = a < 0 ? -a : a;
#pragma unroll
    for (int r = 0; r < MAXR; ++r) {
      if (r < p.R) {
        const int s = p.sched_s[j][r];
        const int mask = static_cast<int>((1u << s) - 1u);  // s <= 30
        v = (v & mask) + (v >> s) * p.sched_c[j][r];
      }
    }
    for (int u = 0; u < p.n_sub; ++u) v = v >= m ? v - m : v;
    int t = (a < 0 && v > 0) ? m - v : v;
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
  float val = is_neg ? -neg : pos;
  val = __fmul_rn(val, s_row);
  return __fmul_rn(val, s_col);
}

template <int C, typename XT, bool ENCODED>
__global__ void __launch_bounds__(THREADS)
rns_fused_kernel(const XT* __restrict__ x, const float* __restrict__ srow,
                 const int8_t* __restrict__ w, const float* __restrict__ scol,
                 float* __restrict__ out, int* __restrict__ ws,
                 int* __restrict__ counters, int M, int K, int N,
                 int k_per_split, bool vec, FusedPlan plan) {
  __shared__ __align__(16) int8_t xs[TM][TK];
  __shared__ __align__(16) int8_t wsm[C][TN][KPAD];
  __shared__ int is_last;

  const int tid = threadIdx.x;
  const int tn = tid % TN;
  const int tr = tid / TN;
  const int n0 = blockIdx.x * TN;
  const int m0 = blockIdx.y * TM;
  const int kbeg = blockIdx.z * k_per_split;
  const int kend = min(K, kbeg + k_per_split);

  int acc[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0;

  for (int k0 = kbeg; k0 < kend; k0 += TK) {
    // Stage 2, activations: the quantizer's round-half-even / clip on the
    // raw tile, IEEE divide by the row scale.  Out-of-range slots are 0.
#pragma unroll
    for (int it = 0; it < TM * TK / THREADS; ++it) {
      const int e = tid + it * THREADS;
      const int r = e / TK, kk = e % TK;
      const int gm = m0 + r, gk = k0 + kk;
      int q = 0;
      if (gm < M && gk < kend) {
        float v = __fdiv_rn(load_f32(x + static_cast<size_t>(gm) * K + gk),
                            srow[gm]);
        v = fminf(fmaxf(rintf(v), -127.f), 127.f);
        q = static_cast<int>(v);
      }
      xs[r][kk] = static_cast<int8_t>(q);
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
            ? w + (static_cast<size_t>(c) * K + gk) * N
            : w + static_cast<size_t>(gk) * N;
        int8_t b[4] = {0, 0, 0, 0};
        if (gk < kend && gn < N) {
          if (vec) {
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
        const int xv = *reinterpret_cast<const int*>(&xs[tr + 4 * i][k4 * 4]);
#pragma unroll
        for (int c = 0; c < C; ++c) acc[i][c] = __dp4a(xv, wv[c], acc[i][c]);
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
            atomicAdd(&ws[(static_cast<size_t>(c) * M + gm) * N + gn],
                      acc[i][c]);
          }
        }
      }
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      const int tile = blockIdx.y * gridDim.x + blockIdx.x;
      is_last = atomicAdd(&counters[tile], 1) == static_cast<int>(gridDim.z) - 1;
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
            acc[i][c] = __ldcg(&ws[(static_cast<size_t>(c) * M + gm) * N + gn]);
          }
        }
      }
    }
  }
  if (gn >= N) return;
  const float s_col = scol[gn];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + tr + 4 * i;
    if (gm < M) {
      out[static_cast<size_t>(gm) * N + gn] =
          epilogue<C>(acc[i], plan, srow[gm], s_col);
    }
  }
}

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
    for (int c = 0; c < MAXC; ++c) {
      if (c < mods.C) out[c * S + i] = static_cast<OT>(floor_mod(v, mods.m[c]));
    }
  }
}

template <int C, typename XT>
void launch_fused_c(const void* x, const float* srow, const int8_t* w,
                    int encoded, const float* scol, float* out, int* ws,
                    int* counters, int M, int K, int N, int splits,
                    int k_per_split, int vec, const FusedPlan& plan,
                    cudaStream_t stream) {
  const dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM, splits);
  const XT* xp = static_cast<const XT*>(x);
  if (encoded) {
    rns_fused_kernel<C, XT, true><<<grid, THREADS, 0, stream>>>(
        xp, srow, w, scol, out, ws, counters, M, K, N, k_per_split, vec != 0,
        plan);
  } else {
    rns_fused_kernel<C, XT, false><<<grid, THREADS, 0, stream>>>(
        xp, srow, w, scol, out, ws, counters, M, K, N, k_per_split, vec != 0,
        plan);
  }
}

template <typename XT>
int launch_fused(const void* x, const float* srow, const int8_t* w,
                 int encoded, const float* scol, float* out, int* ws,
                 int* counters, int M, int K, int N, int splits,
                 int k_per_split, int vec, const FusedPlan& plan,
                 cudaStream_t stream) {
#define RNS_FUSED_CASE(CC)                                                   \
  case CC:                                                                   \
    launch_fused_c<CC, XT>(x, srow, w, encoded, scol, out, ws, counters, M,  \
                           K, N, splits, k_per_split, vec, plan, stream);    \
    break;
  switch (plan.C) {
    RNS_FUSED_CASE(3)
    RNS_FUSED_CASE(4)
    RNS_FUSED_CASE(5)
    RNS_FUSED_CASE(6)
    RNS_FUSED_CASE(7)
    RNS_FUSED_CASE(8)
    RNS_FUSED_CASE(9)
    RNS_FUSED_CASE(10)
    RNS_FUSED_CASE(11)
    default:
      return -1;
  }
#undef RNS_FUSED_CASE
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: (M, K) float32 (x_bf16 = 0) or bfloat16 (x_bf16 = 1), row-major.
// srow: (M,) f32; w: (C, K, N) residues (encoded = 1) or (K, N) int8;
// scol: (N,) f32; out: (M, N) f32; ws/counters: zeroed int32 workspace of
// C*M*N and (M/16)*(N/64) entries, read only when splits > 1.  vec = 1
// promises 4-byte aligned weight rows (N % 4 == 0, aligned base).
// Returns 0, a cudaError_t, or -1 for an unsupported channel count.
int rns_fused_matmul_launch(const void* x, int x_bf16, const float* srow,
                            const int8_t* w, int encoded, const float* scol,
                            float* out, int* ws, int* counters, int M, int K,
                            int N, int splits, int k_per_split, int vec,
                            const FusedPlan* plan, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    return launch_fused<__nv_bfloat16>(x, srow, w, encoded, scol, out, ws,
                                       counters, M, K, N, splits,
                                       k_per_split, vec, *plan, s);
  }
  return launch_fused<float>(x, srow, w, encoded, scol, out, ws, counters, M,
                             K, N, splits, k_per_split, vec, *plan, s);
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

}  // extern "C"
