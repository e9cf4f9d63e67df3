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
//     elementwise |a*b|_m of canonical residues: one int32 product and a
//     divide-free floored mod, into int32 or (moduli <= 128) int8.
//   rns_fold — replaces src/repro/kernels/fold.py: fold, the standalone
//     Stage-4 ladder that canonicalizes (C, S) int32 values in [0, bound)
//     per channel (ChannelPlan.build(moduli, bound), unsigned).
//
// All four read and write each element once and do a few dozen integer
// operations on it: device memory bounds them, and at the staged path's
// decode sizes (0.04-5 MB a launch) the fixed cost of a launch does.
// All four stream: 16-byte loads and stores, a grid of a few waves, and
// what a channel needs in registers or kernel parameters.
//
//   rns_forward: a thread takes 16 consecutive values (one int4 of int8,
//   four of int32) and writes each channel's 16 residues as one int4 of
//   int8 (or four of int32).  C is a template argument, so the channel
//   loop unrolls over exactly C moduli held in the parameter bank.  The
//   floored mod divides by no run-time divisor: with mu = floor(2^32/m)+1
//   the quotient estimate __umulhi(u, mu) of an unsigned u is exact or one
//   over (fwd_mod32), and an int8 value lifted by a multiple of m >= 128
//   (m <= 128 with int8 residues) has its remainder read directly from
//   the low word of its product with mu, in two multiplies (fwd_mod8).
//   A negative int32 v is u - 2^32, so |v|_m = ||u|_m + |-2^32|_m|_m: the
//   result is exact over the whole int32 range, INT32_MIN included.
//
//   rns_reverse: a thread takes 4 consecutive elements: one int4 from each
//   of the C residue planes, four independent MRC chains (rns::mrc_value,
//   divide-free mods by the plan's reciprocals) that the compiler
//   interleaves, and one float4 store.  (C, L) are template arguments, so
//   the digit, Horner and limb loops run no predicated-off iterations; the
//   float steps keep the reference's order (_rn intrinsics, no fast math).
//   Each (C, L) has a second instance without the vector loop for the
//   launches that take none.
//
//   rns_modmul: one plane a grid row, 16 products a thread (an int4 of
//   each int8 operand), the floored mod read from the low word of mu*p
//   (fwd_mod8's two multiplies) where that is exact for the basis, else
//   fwd_mod32's quotient estimate; the output in the caller's residue
//   type, so the staged chain needs no cast launch after it.
//
// A thread of a large launch takes several vectors (the wrappers cap the
// grid at 1,024 threads an SM for the forward and the multiply, 512 for
// the reverse, whose integer work is the larger) and reads its next
// vector while it converts one, so loads overlap the integer work.  The
// wrappers pass the count of 16-value (forward, multiply: a plane's) or
// 4-element (reverse) vectors: all of
// S when every output plane is 16-byte aligned and the vectors give each
// SM at least a warp, else none (a decode step's launches: one element a
// thread, as many threads as elements, each a shorter dependent chain),
// and whether the input is aligned alike (else it is read one value at a
// time).  The rest of S runs one element a thread.  Every entry returns
// cudaGetLastError() after its launch.

#include "rns_common.cuh"

struct ForwardMods {
  int C;
  int m[rns::MAXC];
  unsigned mu[rns::MAXC];    // floor(2^32 / m) + 1
  unsigned mlo[rns::MAXC];   // mu * (least multiple of m >= 128) mod 2^32
  unsigned neg[rns::MAXC];   // |-2^32|_m
};

// How rns_reverse reads its optional scale (mirrors `_ScaleMap`): mode 0
// none, 1 contiguous and 16-byte aligned (a float4 per vector), 2 the
// broadcast view of `kernels/rns_convert.py::scale_map`: element e reads
// scale[sum_d ((e / prod_{d' < d} size[d']) % size[d]) * stride[d]],
// dimension 0 innermost.
constexpr int SCALE_MAXD = 6;
struct ScaleMap {
  int mode, nd;
  long long size[SCALE_MAXD];
  long long stride[SCALE_MAXD];
};

namespace {

constexpr int CONV_THREADS = 256;  // most threads a block (64 and 128 too)
constexpr int FWD_V = 16;          // values a forward thread takes
constexpr int REV_V = 4;           // elements a reverse thread takes

// Floored |v|_m of any int32 v, 2 <= m < 2^31.  q = __umulhi(u, mu) is
// floor(u/m) or one more (mu*m - 2^32 is in (0, m], so u*mu/2^32 exceeds
// u/m by less than 1), so u - q*m is the remainder or that minus m,
// wrapped; min(r, r + m) unwraps it.  Adding |-2^32|_m to a negative v's
// remainder and one conditional subtract finish it.
__device__ __forceinline__ unsigned fwd_mod32(int v, unsigned m, unsigned mu,
                                              unsigned neg) {
  const unsigned u = static_cast<unsigned>(v);
  unsigned r = u - __umulhi(u, mu) * m;
  r = min(r, r + m);
  r += v < 0 ? neg : 0u;
  return min(r, r - m);
}

// Floored |v|_m of an int8 v, m <= 128, in two multiplies: for x = v +
// madd in [0, 383) and mu*m = 2^32 + e (0 < e <= m), the low word of
// mu*x is q*e + mu*r (x = q*m + r), so its high word times m is
// r + floor(e*x/2^32) = r (the remainder read directly, Lemire, Kaser
// and Kurz 2019).  mu*x = mu*v + mlo (mod 2^32), mlo = mu*madd.
__device__ __forceinline__ unsigned fwd_mod8(int v, unsigned m, unsigned mu,
                                             unsigned mlo) {
  return __umulhi(mu * static_cast<unsigned>(v) + mlo, m);
}

template <bool INT8_MOD>
__device__ __forceinline__ unsigned fwd_mod(int v, int c,
                                            const ForwardMods& p) {
  const unsigned m = static_cast<unsigned>(p.m[c]);
  return INT8_MOD ? fwd_mod8(v, m, p.mu[c], p.mlo[c])
                  : fwd_mod32(v, m, p.mu[c], p.neg[c]);
}

// 16 values of x as they arrive: 4 words of int8 or 16 of int32, read
// with int4 loads (aligned) or one value at a time (packed alike).  A
// thread reads its next vector into one while it converts another.
template <typename IT>
struct Raw16 {
  static constexpr int W = 4 * sizeof(IT);
  int w[W];

  __device__ __forceinline__ void load(const IT* x, bool aligned) {
    if (aligned) {
#pragma unroll
      for (int q = 0; q < W / 4; ++q) {
        const int4 t = __ldcs(reinterpret_cast<const int4*>(x) + q);
        w[4 * q] = t.x;
        w[4 * q + 1] = t.y;
        w[4 * q + 2] = t.z;
        w[4 * q + 3] = t.w;
      }
    } else if constexpr (sizeof(IT) == 1) {
#pragma unroll
      for (int q = 0; q < W; ++q) {
        w[q] = (x[4 * q] & 255) | (x[4 * q + 1] & 255) << 8 |
               (x[4 * q + 2] & 255) << 16 | (x[4 * q + 3] & 255) << 24;
      }
    } else {
#pragma unroll
      for (int k = 0; k < W; ++k) w[k] = x[k];
    }
  }
  // the same 16 values as 4 groups of 4 consecutive ones, group q at
  // x + q * stride: one word of int8 or one int4 of int32 a group
  __device__ __forceinline__ void load_groups(const IT* x, int stride,
                                              bool aligned) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const IT* g = x + q * stride;
      if constexpr (sizeof(IT) == 1) {
        w[q] = aligned ? __ldcs(reinterpret_cast<const int*>(g))
                       : (g[0] & 255) | (g[1] & 255) << 8 |
                             (g[2] & 255) << 16 | (g[3] & 255) << 24;
      } else if (aligned) {
        const int4 t = __ldcs(reinterpret_cast<const int4*>(g));
        w[4 * q] = t.x;
        w[4 * q + 1] = t.y;
        w[4 * q + 2] = t.z;
        w[4 * q + 3] = t.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) w[4 * q + j] = g[j];
      }
    }
  }
  // value k, sign-extended
  __device__ __forceinline__ int operator[](int k) const {
    if constexpr (sizeof(IT) == 1) {
      return static_cast<int8_t>(w[k / 4] >> (8 * (k % 4)));
    } else {
      return w[k];
    }
  }
};

// 16 residues (each < 2^7) packed into one aligned int4 of int8.  The
// forward's stores are streaming (evict-first): its outputs are 5/6 of
// the bytes it moves and are not read again by the launch.
__device__ __forceinline__ void store16(int8_t* out,
                                        const unsigned (&r)[FWD_V]) {
  unsigned w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    w[q] = __byte_perm(__byte_perm(r[4 * q], r[4 * q + 1], 0x0040),
                       __byte_perm(r[4 * q + 2], r[4 * q + 3], 0x0040),
                       0x5410);
  }
  __stcs(reinterpret_cast<int4*>(out), make_int4(w[0], w[1], w[2], w[3]));
}

__device__ __forceinline__ void store16(int32_t* out,
                                        const unsigned (&r)[FWD_V]) {
#pragma unroll
  for (int q = 0; q < FWD_V / 4; ++q) {
    __stcs(reinterpret_cast<int4*>(out) + q,
           make_int4(r[4 * q], r[4 * q + 1], r[4 * q + 2], r[4 * q + 3]));
  }
}

// x: S values; out: (C, S) residues.  Vectors [0, nvec) of FWD_V values,
// then the values from FWD_V*nvec one at a time, grid-stride.
template <int C, typename IT, typename OT>
__global__ void __launch_bounds__(CONV_THREADS)
rns_forward_kernel(const IT* __restrict__ x, OT* __restrict__ out,
                   long long S, long long nvec, int xvec, ForwardMods mods) {
  constexpr bool INT8_MOD = sizeof(IT) == 1 && sizeof(OT) == 1;
  const long long t0 = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
  const long long nt = static_cast<long long>(gridDim.x) * blockDim.x;
  Raw16<IT> v;
  if (t0 < nvec) v.load(x + t0 * FWD_V, xvec);
  for (long long i = t0; i < nvec; i += nt) {
    Raw16<IT> next = v;
    if (i + nt < nvec) next.load(x + (i + nt) * FWD_V, xvec);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      unsigned r[FWD_V];
#pragma unroll
      for (int k = 0; k < FWD_V; ++k) r[k] = fwd_mod<INT8_MOD>(v[k], c, mods);
      store16(out + c * S + i * FWD_V, r);
    }
    v = next;
  }
  for (long long e = nvec * FWD_V + t0; e < S; e += nt) {
    const int v = x[e];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      out[c * S + e] = static_cast<OT>(fwd_mod<INT8_MOD>(v, c, mods));
    }
  }
}

__device__ __forceinline__ float scale_at(const float* scale,
                                          const ScaleMap& sm, long long e) {
  long long off = 0;
#pragma unroll
  for (int d = 0; d < SCALE_MAXD; ++d) {
    if (d < sm.nd) {
      const long long q = e / sm.size[d];
      off += (e - q * sm.size[d]) * sm.stride[d];
      e = q;
    }
  }
  return scale[off];
}

// Residues e0..e0+3 of each of the C planes of res (int4 loads when the
// planes are 16-byte aligned).
template <int C>
__device__ __forceinline__ void load_planes(const int* res, long long S,
                                            long long e0, int rvec,
                                            int4 (&w)[C]) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int* p = res + c * S + e0;
    w[c] = rvec ? __ldcs(reinterpret_cast<const int4*>(p))
                : make_int4(p[0], p[1], p[2], p[3]);
  }
}

// res: (C, S) canonical residues; out: S float32.  VEC: vectors [0, nvec)
// of REV_V elements (rvec: the planes are 16-byte aligned), then the
// elements from REV_V*nvec one at a time, grid-stride.  Launches without
// vectors (nvec = 0, decode) take the instance compiled without the
// vector loop: its smaller code ran 0.05-0.45 us faster a decode launch
// on an H100 (`convert_bench.py`).
template <int C, int L, bool VEC>
__global__ void __launch_bounds__(CONV_THREADS)
rns_reverse_kernel(const int* __restrict__ res,
                   const float* __restrict__ scale, float* __restrict__ out,
                   long long S, long long nvec, int rvec, ScaleMap sm,
                   FusedPlan plan) {
  const long long t0 = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
  const long long nt = static_cast<long long>(gridDim.x) * blockDim.x;
  if constexpr (VEC) {
    int4 w[C];   // the thread's vector: 4 residues of each plane
    if (t0 < nvec) load_planes<C>(res, S, t0 * REV_V, rvec, w);
    for (long long i = t0; i < nvec; i += nt) {
      const long long e0 = i * REV_V;
      int4 next[C];
#pragma unroll
      for (int c = 0; c < C; ++c) next[c] = w[c];
      if (i + nt < nvec) {
        load_planes<C>(res, S, (i + nt) * REV_V, rvec, next);
      }
      int r[REV_V][C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        r[0][c] = w[c].x;
        r[1][c] = w[c].y;
        r[2][c] = w[c].z;
        r[3][c] = w[c].w;
      }
      float v[REV_V];
#pragma unroll
      for (int k = 0; k < REV_V; ++k) {
        v[k] = rns::mrc_value<C, L>(r[k], plan);
      }
      if (sm.mode == 1) {
        const float4 s = __ldcs(reinterpret_cast<const float4*>(scale + e0));
        v[0] = __fmul_rn(v[0], s.x);
        v[1] = __fmul_rn(v[1], s.y);
        v[2] = __fmul_rn(v[2], s.z);
        v[3] = __fmul_rn(v[3], s.w);
      } else if (sm.mode == 2) {
#pragma unroll
        for (int k = 0; k < REV_V; ++k) {
          v[k] = __fmul_rn(v[k], scale_at(scale, sm, e0 + k));
        }
      }
      *reinterpret_cast<float4*>(out + e0) = make_float4(v[0], v[1], v[2],
                                                         v[3]);
#pragma unroll
      for (int c = 0; c < C; ++c) w[c] = next[c];
    }
  }
  for (long long e = nvec * REV_V + t0; e < S; e += nt) {
    int r[C];
#pragma unroll
    for (int c = 0; c < C; ++c) r[c] = res[c * S + e];
    const float v = rns::mrc_value<C, L>(r, plan);
    out[e] = sm.mode ? __fmul_rn(v, scale_at(scale, sm, e)) : v;
  }
}

// a, b: (C, S) canonical residues (0 <= r < m_c); out: (C, S) floored
// products |a*b|_{m_c}.  Grid (blocks, C): the channel is the grid row,
// so a block's modulus and reciprocal are two registers read once and no
// thread loops over channels.  Vectors [0, nvec) of FWD_V values a plane,
// the next pair read ahead (avec: a and b 16-byte aligned, else read one
// value at a time into the same vector); then the elements from
// FWD_V*nvec one a thread, grid-stride.  An int8 output's vector is 16
// consecutive values (an int4 of each operand, one int4 store).  An
// int32 output's is 4 groups of 4, 128 values apart in its warp's run of
// 512 (lane l: 4l, 128 + 4l, ...; nvec a multiple of 32), so that each of
// the warp's four 16-byte stores writes 512 contiguous bytes (16
// consecutive int32 a thread strided a warp's stores 64 bytes apart and
// ran at 1.4 TB/s).  DIRECT: the remainder of the product p is read from
// the low word of mu*p (fwd_mod8 with no lift), exact when
// p*(mu*m - 2^32) < 2^32 for every product of the plane (the wrapper
// checks it per basis and operand type: every served basis passes); else
// the quotient estimate of fwd_mod32 (p >= 0, so no negative fix).
// Launches without vectors (decode) take the instance compiled without
// the vector loop (VEC = false), as the reverse's do.
template <typename IT, typename OT, bool DIRECT, bool VEC>
__global__ void __launch_bounds__(CONV_THREADS)
rns_modmul_kernel(const IT* __restrict__ a, const IT* __restrict__ b,
                  OT* __restrict__ out, long long S, long long nvec, int avec,
                  ForwardMods mods) {
  const int c = blockIdx.y;
  const unsigned m = static_cast<unsigned>(mods.m[c]), mu = mods.mu[c];
  const long long plane = c * S;
  a += plane;
  b += plane;
  out += plane;
  const auto mod = [m, mu](int p) {
    return DIRECT ? fwd_mod8(p, m, mu, 0u) : fwd_mod32(p, m, mu, 0u);
  };
  const long long t0 = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
  const long long nt = static_cast<long long>(gridDim.x) * blockDim.x;
  if constexpr (VEC) {
    constexpr bool SPREAD = sizeof(OT) == 4;
    constexpr int GAP = 128;   // values between a spread vector's groups
    // where vector i starts
    const auto at = [](long long i) {
      return SPREAD ? (i >> 5) * (32 * FWD_V) + (i & 31) * 4 : i * FWD_V;
    };
    const auto load = [avec](Raw16<IT>& v, const IT* x) {
      if constexpr (SPREAD) {
        v.load_groups(x, GAP, avec);
      } else {
        v.load(x, avec);
      }
    };
    Raw16<IT> va, vb;
    if (t0 < nvec) {
      load(va, a + at(t0));
      load(vb, b + at(t0));
    }
    for (long long i = t0; i < nvec; i += nt) {
      Raw16<IT> na = va, nb = vb;
      if (i + nt < nvec) {
        load(na, a + at(i + nt));
        load(nb, b + at(i + nt));
      }
      unsigned r[FWD_V];
#pragma unroll
      for (int k = 0; k < FWD_V; ++k) r[k] = mod(va[k] * vb[k]);
      if constexpr (SPREAD) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          __stcs(reinterpret_cast<int4*>(out + at(i) + q * GAP),
                 make_int4(r[4 * q], r[4 * q + 1], r[4 * q + 2],
                           r[4 * q + 3]));
        }
      } else {
        store16(out + at(i), r);
      }
      va = na;
      vb = nb;
    }
  }
  for (long long e = nvec * FWD_V + t0; e < S; e += nt) {
    out[e] = static_cast<OT>(mod(static_cast<int>(a[e]) *
                                 static_cast<int>(b[e])));
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
        return rns_launch_tile_mma_raw(*a, *plan, s);
      case rns::A_PLANES:
        return rns_launch_tile_mma_int8(*a, *plan, s);
      default:
        return -1;
    }
  }
  if (a->tm == rns::TM_WG) {
    if (amode != rns::A_SHARED) return -1;
    return a->encoded ? rns_launch_tile_wg_raw(*a, *plan, s)
                      : rns_launch_tile_wg_raw_live(*a, *plan, s);
  }
  if (a->tm != rns::TM) return -1;
  const bool wide = plan->C > rns::SPLIT_C;
  switch (amode) {
    case rns::A_F32:
      return wide ? rns_launch_tile_f32_wide(*a, *plan, s)
                  : rns_launch_tile_f32(*a, *plan, s);
    case rns::A_BF16:
      return wide ? rns_launch_tile_bf16_wide(*a, *plan, s)
                  : rns_launch_tile_bf16(*a, *plan, s);
    case rns::A_SHARED:
      return wide ? rns_launch_tile_raw_wide(*a, *plan, s)
                  : rns_launch_tile_raw(*a, *plan, s);
    case rns::A_PLANES:
      return wide ? rns_launch_tile_int8_wide(*a, *plan, s)
                  : rns_launch_tile_int8(*a, *plan, s);
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
// or int32 canonical residues.  nvec: 16-value vectors stored aligned in
// every plane; xvec: x is 16-byte aligned.  Returns -1 for C outside 1..12.
int rns_forward_launch(const void* x, int x_int32, void* out, int out_int32,
                       long long S, long long nvec, int xvec,
                       const ForwardMods* mods, int blocks, int threads,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RNS_FORWARD_TYPES(CC)                                              \
  case CC:                                                                 \
    if (x_int32 && out_int32) {                                            \
      rns_forward_kernel<CC, int32_t, int32_t><<<blocks, threads, 0, s>>>( \
          static_cast<const int32_t*>(x), static_cast<int32_t*>(out), S,  \
          nvec, xvec, *mods);                                              \
    } else if (x_int32) {                                                  \
      rns_forward_kernel<CC, int32_t, int8_t><<<blocks, threads, 0, s>>>(  \
          static_cast<const int32_t*>(x), static_cast<int8_t*>(out), S,   \
          nvec, xvec, *mods);                                              \
    } else if (out_int32) {                                                \
      rns_forward_kernel<CC, int8_t, int32_t><<<blocks, threads, 0, s>>>(  \
          static_cast<const int8_t*>(x), static_cast<int32_t*>(out), S,   \
          nvec, xvec, *mods);                                              \
    } else {                                                               \
      rns_forward_kernel<CC, int8_t, int8_t><<<blocks, threads, 0, s>>>(   \
          static_cast<const int8_t*>(x), static_cast<int8_t*>(out), S,    \
          nvec, xvec, *mods);                                              \
    }                                                                      \
    break;
  switch (mods->C) {
    RNS_FORWARD_TYPES(1)
    RNS_FORWARD_TYPES(2)
    RNS_FORWARD_TYPES(3)
    RNS_FORWARD_TYPES(4)
    RNS_FORWARD_TYPES(5)
    RNS_FORWARD_TYPES(6)
    RNS_FORWARD_TYPES(7)
    RNS_FORWARD_TYPES(8)
    RNS_FORWARD_TYPES(9)
    RNS_FORWARD_TYPES(10)
    RNS_FORWARD_TYPES(11)
    RNS_FORWARD_TYPES(12)
    default:
      return -1;
  }
#undef RNS_FORWARD_TYPES
  return static_cast<int>(cudaGetLastError());
}

// res: (C, S) int32 canonical residues; scale: read as sm says (null for
// mode 0); out: (S,) f32.  plan carries the moduli, the MRC inverse table,
// the reciprocals and the limb constants (its fold fields are unused).
// nvec: 4-element vectors (out 16-byte aligned); rvec: every residue plane
// 16-byte aligned.  Two instances (with and without the vector loop) per
// (C, L) a ConversionPlan of 3-11 channels can have
// (`rns_convert.REVERSE_INSTANCES`); -1 for any other.
int rns_reverse_launch(const int* res, const float* scale, const ScaleMap* sm,
                       float* out, long long S, long long nvec, int rvec,
                       const FusedPlan* plan, int blocks, int threads,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RNS_REVERSE_CASE(CC, LL)                                        \
  case CC * 8 + LL:                                                     \
    if (nvec) {                                                         \
      rns_reverse_kernel<CC, LL, true><<<blocks, threads, 0, s>>>(      \
          res, scale, out, S, nvec, rvec, *sm, *plan);                  \
    } else {                                                            \
      rns_reverse_kernel<CC, LL, false><<<blocks, threads, 0, s>>>(     \
          res, scale, out, S, nvec, rvec, *sm, *plan);                  \
    }                                                                   \
    break;
  switch (plan->C * 8 + plan->L) {
    RNS_REVERSE_CASE(3, 1) RNS_REVERSE_CASE(3, 2) RNS_REVERSE_CASE(3, 3)
    RNS_REVERSE_CASE(3, 4)
    RNS_REVERSE_CASE(4, 1) RNS_REVERSE_CASE(4, 2) RNS_REVERSE_CASE(4, 3)
    RNS_REVERSE_CASE(4, 4) RNS_REVERSE_CASE(4, 5)
    RNS_REVERSE_CASE(5, 1) RNS_REVERSE_CASE(5, 2) RNS_REVERSE_CASE(5, 3)
    RNS_REVERSE_CASE(5, 4) RNS_REVERSE_CASE(5, 5) RNS_REVERSE_CASE(5, 6)
    RNS_REVERSE_CASE(6, 2) RNS_REVERSE_CASE(6, 3) RNS_REVERSE_CASE(6, 4)
    RNS_REVERSE_CASE(6, 5) RNS_REVERSE_CASE(6, 6)
    RNS_REVERSE_CASE(7, 2) RNS_REVERSE_CASE(7, 3) RNS_REVERSE_CASE(7, 4)
    RNS_REVERSE_CASE(7, 5) RNS_REVERSE_CASE(7, 6)
    RNS_REVERSE_CASE(8, 2) RNS_REVERSE_CASE(8, 3) RNS_REVERSE_CASE(8, 4)
    RNS_REVERSE_CASE(8, 5) RNS_REVERSE_CASE(8, 6)
    RNS_REVERSE_CASE(9, 2) RNS_REVERSE_CASE(9, 3) RNS_REVERSE_CASE(9, 4)
    RNS_REVERSE_CASE(9, 5) RNS_REVERSE_CASE(9, 6)
    RNS_REVERSE_CASE(10, 3) RNS_REVERSE_CASE(10, 4) RNS_REVERSE_CASE(10, 5)
    RNS_REVERSE_CASE(10, 6)
    RNS_REVERSE_CASE(11, 3) RNS_REVERSE_CASE(11, 4) RNS_REVERSE_CASE(11, 5)
    RNS_REVERSE_CASE(11, 6)
    default:
      return -1;
  }
#undef RNS_REVERSE_CASE
  return static_cast<int>(cudaGetLastError());
}

// a, b: (C, S) int8 (a_int32 = 0) or int32 canonical residues; out: (C, S)
// int8 (out_int32 = 0) or int32.  nvec: 16-value vectors of every plane
// (each output plane 16-byte aligned; a multiple of 32 for an int32
// output); avec: a and b planes 16-byte aligned; direct: the DIRECT mod is exact for this basis and operand
// type (always so for an int8 output).  Returns -1 for an int8 output
// without it.
int rns_modmul_launch(const void* a, const void* b, int a_int32, void* out,
                      int out_int32, long long S, long long nvec, int avec,
                      int direct, const ForwardMods* mods, int blocks,
                      int threads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(blocks, mods->C);
#define RNS_MODMUL(IT, OT, D)                                           \
  if (nvec) {                                                           \
    rns_modmul_kernel<IT, OT, D, true><<<grid, threads, 0, s>>>(        \
        static_cast<const IT*>(a), static_cast<const IT*>(b),           \
        static_cast<OT*>(out), S, nvec, avec, *mods);                   \
  } else {                                                              \
    rns_modmul_kernel<IT, OT, D, false><<<grid, threads, 0, s>>>(       \
        static_cast<const IT*>(a), static_cast<const IT*>(b),           \
        static_cast<OT*>(out), S, nvec, avec, *mods);                   \
  }
  if (!out_int32 && !direct) return -1;
  if (!out_int32) {
    if (a_int32) {
      RNS_MODMUL(int32_t, int8_t, true);
    } else {
      RNS_MODMUL(int8_t, int8_t, true);
    }
  } else if (a_int32) {
    if (direct) {
      RNS_MODMUL(int32_t, int32_t, true);
    } else {
      RNS_MODMUL(int32_t, int32_t, false);
    }
  } else if (direct) {
    RNS_MODMUL(int8_t, int32_t, true);
  } else {
    RNS_MODMUL(int8_t, int32_t, false);
  }
#undef RNS_MODMUL
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
