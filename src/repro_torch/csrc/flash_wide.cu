// Flash attention above D = 256 for Hopper (sm_90a): the WIDE route of
// src/repro/kernels/flash_attention.py: flash_attention, which takes any
// head size.  The semantics are those of `kernels/ref.attention_ref`
// (flash_attention.cu's header gives them); q, k, v and out are
// (B, H, S, D) float32 or bfloat16, contiguous, with D a multiple of
// WIDE_CHUNK (the wrapper pads the true D with zero columns, which add an
// exact +0 to every score, and passes the true D's 1/sqrt(D) as the
// scale).  Every query count takes it: decode (Sq <= 16) and prefill.
//
// Layout: one block of 4 warps per (b*h, tile of BQ = 16 query rows,
// chunk of WIDE_CHUNK = 128 output columns); each warp owns 4 rows.  For
// each tile of 32 keys the block sums the scores over every D chunk (the
// chunk of q and of the keys staged in shared memory as float32; lane j
// scores key j, adding the columns in ascending order as the FMA route
// does), runs the online softmax of the other routes (the max and sum of
// a tile are warp shuffles, masked keys -1e30 and re-masked after the
// shift), then multiplies P by its own chunk of V.  So the accumulator
// stays at 4 columns a lane and row whatever D is, and the scores are
// computed once per output chunk: D / 128 times in all (4 at D = 512).
// Key tiles no row of the block attends are skipped as on the FMA route.
//
// What bounds it on an H100: the scores and the value products are
// 4*B*H*Sq*Sk*D flops (half under a causal mask), and the score recompute
// adds 2*B*H*Sq*Sk*D*(D/128 - 1); float32 FMAs on the CUDA cores, the
// rate the float32 tolerance needs, at 67 TFLOP/s.  Decode (Sq = 1) uses
// one row of a block's 16: reading K (D/128 times, from the L2 after the
// first) and V bounds it there.
#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int WARPS = 4;
constexpr int ROWS = 4;                  // query rows per warp
constexpr int BQ = WARPS * ROWS;         // query rows per block
constexpr int BK = 32;                   // keys per tile: one per lane
constexpr int DC = WIDE_CHUNK;           // columns per chunk
constexpr int NT = DC / 32;              // output columns per lane
constexpr int KS = DC + 4;               // key rows padded by 16 bytes

struct WideSmem {
  float q[BQ][DC];                       // this chunk of the block's rows
  float k[BK][KS];                       // this chunk of the key tile
  float v[BK][DC];                       // the block's chunk of the values
  float p[WARPS][BK][ROWS];              // each warp's p by [key][row]
};
static_assert(sizeof(WideSmem) <= 48 * 1024, "static shared memory");

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
flash_wide_kernel(FlashArgs a) {
  __shared__ __align__(16) WideSmem sm;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int bh = blockIdx.y, b = bh / a.H;
  const int q0 = blockIdx.x * BQ;
  const int c0 = blockIdx.z * DC;        // the block's output columns
  const int Sq = a.Sq, Sk = a.Sk, D = a.D;
  const T* q = static_cast<const T*>(a.q) + static_cast<size_t>(bh) * Sq * D;
  const T* k = static_cast<const T*>(a.k) + static_cast<size_t>(bh) * Sk * D;
  const T* v = static_cast<const T*>(a.v) + static_cast<size_t>(bh) * Sk * D;
  const bool explicit_pos = a.qpos != nullptr;
  const int pad = a.pad ? a.pad[b] : 0;

  int qp[ROWS];
  bool live[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int row = q0 + warp * ROWS + i;
    live[i] = row < Sq;
    qp[i] = !live[i] ? -1
            : explicit_pos ? a.qpos[static_cast<size_t>(b) * Sq + row]
                           : row + Sk - Sq;
  }

  // key tiles some row of the block can attend
  int k_lo = 0, k_hi = Sk;
  if (!explicit_pos) {
    const int qmin = q0 + Sk - Sq;
    const int qmax = min(q0 + BQ, Sq) - 1 + Sk - Sq;
    if (a.causal) k_hi = min(k_hi, qmax + 1);
    if (a.has_window) k_lo = max(k_lo, qmin - a.window + 1);
    k_lo = max(k_lo, pad);
  }
  const int t_lo = k_lo / BK;
  const int t_hi = k_hi > k_lo ? (k_hi + BK - 1) / BK : t_lo;

  float m_run[ROWS], l_run[ROWS], acc[ROWS][NT];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m_run[i] = NEG_INF;
    l_run[i] = 0.f;
#pragma unroll
    for (int t = 0; t < NT; ++t) acc[i][t] = 0.f;
  }

  for (int tile = t_lo; tile < t_hi; ++tile) {
    const int k0 = tile * BK;
    // scores of key k0 + lane against the warp's rows, over every chunk
    float s[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) s[i] = 0.f;
    for (int d0 = 0; d0 < D; d0 += DC) {
      __syncthreads();   // the previous chunk, tile and values are read
      for (int e = tid; e < BQ * DC; e += WARPS * 32) {
        const int r = e / DC, d = e % DC;
        sm.q[r][d] = q0 + r < Sq
            ? to_f32(q[static_cast<size_t>(q0 + r) * D + d0 + d]) : 0.f;
      }
      for (int e = tid; e < BK * DC; e += WARPS * 32) {
        const int j = e / DC, d = e % DC;
        sm.k[j][d] = k0 + j < Sk
            ? to_f32(k[static_cast<size_t>(k0 + j) * D + d0 + d]) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int d = 0; d < DC; d += 4) {
        const float4 kv = *reinterpret_cast<const float4*>(&sm.k[lane][d]);
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          const float4 qv =
              *reinterpret_cast<const float4*>(&sm.q[warp * ROWS + i][d]);
          s[i] = fmaf(qv.x, kv.x, s[i]);
          s[i] = fmaf(qv.y, kv.y, s[i]);
          s[i] = fmaf(qv.z, kv.z, s[i]);
          s[i] = fmaf(qv.w, kv.w, s[i]);
        }
      }
    }
    // the block's chunk of the values (read after the last chunk's sync)
    for (int e = tid; e < BK * DC; e += WARPS * 32) {
      const int j = e / DC, d = e % DC;
      sm.v[j][d] = k0 + j < Sk
          ? to_f32(v[static_cast<size_t>(k0 + j) * D + c0 + d]) : 0.f;
    }
    const int key = k0 + lane;
    const int kp = key >= Sk ? -1
                   : explicit_pos ? a.kpos[static_cast<size_t>(b) * Sk + key]
                                  : key;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const float x = scaled(s[i], a);
      const bool ok = live[i] && key < Sk &&
                      attends(qp[i], kp, pad, explicit_pos, a);
      const float sm_i = ok ? x : NEG_INF;
      const float m_new = fmaxf(m_run[i], warp_max(sm_i));
      // re-mask after the shift: on a fully masked row m_new is -1e30 and
      // exp(sm_i - m_new) would be 1
      const float p = ok ? expf(sm_i - m_new) : 0.f;
      const float alpha = expf(m_run[i] - m_new);
      l_run[i] = l_run[i] * alpha + warp_sum(p);
      m_run[i] = m_new;
#pragma unroll
      for (int t = 0; t < NT; ++t) acc[i][t] *= alpha;
      sm.p[warp][lane][i] = p;
    }
    __syncthreads();   // the values and each warp's p are written
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float4 p4 = *reinterpret_cast<const float4*>(&sm.p[warp][j][0]);
      const float pj[ROWS] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const float vv = sm.v[j][lane + 32 * t];
#pragma unroll
        for (int i = 0; i < ROWS; ++i) acc[i][t] = fmaf(pj[i], vv, acc[i][t]);
      }
    }
  }

  T* out = static_cast<T*>(a.out) + static_cast<size_t>(bh) * Sq * D;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    if (!live[i]) continue;
    const float l = l_run[i] == 0.f ? 1.f : l_run[i];
    const size_t row = static_cast<size_t>(q0 + warp * ROWS + i) * D + c0;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      store(out + row + lane + 32 * t, __fdiv_rn(acc[i][t], l));
    }
  }
}

template <typename T>
int launch_wide_type(const FlashArgs& a, cudaStream_t s) {
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.B * a.H, a.D / DC);
  flash_wide_kernel<T><<<grid, WARPS * 32, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One launch of the WIDE route; -1 unless D is a multiple of WIDE_CHUNK
// above 256.
int flash_launch_wide(const FlashArgs& a, cudaStream_t stream) {
  if (a.D <= 256 || a.D % DC != 0 || a.B * a.H > 65535) return -1;
  return a.bf16 ? launch_wide_type<__nv_bfloat16>(a, stream)
                : launch_wide_type<float>(a, stream);
}
