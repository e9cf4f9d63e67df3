// Blocked online-softmax attention for Hopper (sm_90a), replacing
// src/repro/kernels/flash_attention.py: flash_attention.
//
// q (B, H, Sq, D), k and v (B, H, Sk, D), float32 or bfloat16, contiguous;
// out (B, H, Sq, D) in q's type.  The semantics are those of
// `kernels/ref.attention_ref`: scores q.k / sqrt(D), tanh(s/c)*c under a
// softcap, masked scores set to -1e30, fully masked rows exactly 0.
// Masks: causal with query i at i + Sk - Sq, a sliding window
// (kpos > qpos - window), a per-sequence left pad (keys below pad[b]), or
// explicit (B, S) positions with -1 marking an invalid row.  Key slots at
// or beyond Sk are never attended (the Pallas kernel pads the keys to its
// block and attends to the padding when the query and key paddings
// differ; this kernel masks by the true Sk).
//
// Four routes, each one launch, picked by the wrapper
// (`kernels/flash_attention.py::flash_route`):
//   SPLIT (flash_split.cu): Sq <= 16, float32 or bf16 -- decode and short
//     query blocks.  Reading K and V bounds it; the keys of a (b, h) are
//     split over a thread-block cluster and streamed by cp.async.
//   MMA (flash_mma.cu): Sq > 16, bf16 -- prefill on the tensor cores
//     (mma.sync m16n8k16), FA2-style.
//   FMA (this file): Sq > 16, float32 -- the CUDA-core kernel below, kept
//     because TF32 tensor cores cannot meet the float32 tolerance; also
//     the pinned "before" that chip_smoke.py times bf16 prefill on.
//   WIDE (flash_wide.cu): D > 256, any Sq, both types -- D in chunks of
//     128 columns, float32 FMAs, one output chunk a block.
//
// FMA layout: one block of 4 warps per (b*h, tile of 4*ROWS query rows).
// Each warp owns ROWS query rows; a tile of 32 keys and values sits in
// shared memory as float32, and lane j scores key j against the warp's
// rows, so the softmax max and sum of a tile are warp shuffles.  The
// running max, sum and the float32 accumulator (lane owns output columns
// lane + 32t) stay in registers; no score matrix reaches device memory.
// Key tiles that no row of the block can attend (past the causal
// frontier, left of the window, inside the pad) are skipped when positions
// are implicit; with explicit positions reachability depends on the data,
// and every tile runs.
//
// What bounds it on an H100: the scores and the value products are
// 4*B*H*Sq*Sk*D flops (half under a causal mask), far above the bytes of
// q, k, v and out, so arithmetic bounds it, at the float32 CUDA-core rate
// of 67 TFLOP/s on this route (expf, tanhf and IEEE divides, no fast
// math).
#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int WARPS = 4;
constexpr int BK = 32;             // keys per tile: one per lane

// Shared memory of one instance, in floats: the q rows, a key tile (rows
// padded by 16 bytes, so lanes reading their own key's row hit distinct
// banks), a value tile and each warp's p by [key][row].  Dynamic: at
// D = 256 it is 83 KB, above the 48 KB of static shared memory.
template <int D>
struct FmaSmem {
  static constexpr int ROWS = D <= 64 ? 8 : 4;    // query rows per warp
  static constexpr int BQ = WARPS * ROWS;
  static constexpr int KS = D + 4;
  static constexpr int QS = BQ * D, KT = BK * KS, VT = BK * D;
  static constexpr int PS = WARPS * BK * ROWS;
  static constexpr int BYTES = 4 * (QS + KT + VT + PS);
  static_assert(D % 4 == 0, "float4 rows");
};

template <int D, typename T>
__global__ void __launch_bounds__(WARPS * 32)
flash_fma_kernel(FlashArgs a) {
  using L = FmaSmem<D>;
  constexpr int ROWS = L::ROWS;             // query rows per warp
  constexpr int BQ = L::BQ;
  constexpr int KS = L::KS;
  constexpr int NT = (D + 31) / 32;         // output columns per lane
  extern __shared__ __align__(16) float fma_smem[];
  float (*qs)[D] = reinterpret_cast<float (*)[D]>(fma_smem);
  float (*ks)[KS] = reinterpret_cast<float (*)[KS]>(fma_smem + L::QS);
  float (*vs)[D] = reinterpret_cast<float (*)[D]>(fma_smem + L::QS + L::KT);
  float (*ps)[BK][ROWS] = reinterpret_cast<float (*)[BK][ROWS]>(
      fma_smem + L::QS + L::KT + L::VT);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int bh = blockIdx.y, b = bh / a.H;
  const int q0 = blockIdx.x * BQ;
  const int Sq = a.Sq, Sk = a.Sk;
  const T* q = static_cast<const T*>(a.q) + static_cast<size_t>(bh) * Sq * D;
  const T* k = static_cast<const T*>(a.k) + static_cast<size_t>(bh) * Sk * D;
  const T* v = static_cast<const T*>(a.v) + static_cast<size_t>(bh) * Sk * D;
  const bool explicit_pos = a.qpos != nullptr;
  const int pad = a.pad ? a.pad[b] : 0;

  for (int e = tid; e < BQ * D; e += WARPS * 32) {
    const int r = e / D, d = e % D;
    qs[r][d] = q0 + r < Sq ? to_f32(q[static_cast<size_t>(q0 + r) * D + d])
                           : 0.f;
  }

  // this warp's rows: position (explicit, or i + Sk - Sq) and validity
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
    __syncthreads();   // the previous tile (and qs) are read
    for (int e = tid; e < BK * D; e += WARPS * 32) {
      const int j = e / D, d = e % D;
      const bool in = k0 + j < Sk;
      const size_t at = static_cast<size_t>(k0 + j) * D + d;
      ks[j][d] = in ? to_f32(k[at]) : 0.f;
      vs[j][d] = in ? to_f32(v[at]) : 0.f;
    }
    __syncthreads();

    // scores of key k0 + lane against the warp's rows
    float s[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) s[i] = 0.f;
#pragma unroll
    for (int d = 0; d < D; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(&ks[lane][d]);
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float4 qv =
            *reinterpret_cast<const float4*>(&qs[warp * ROWS + i][d]);
        s[i] = fmaf(qv.x, kv.x, s[i]);
        s[i] = fmaf(qv.y, kv.y, s[i]);
        s[i] = fmaf(qv.z, kv.z, s[i]);
        s[i] = fmaf(qv.w, kv.w, s[i]);
      }
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
      const float sm = ok ? x : NEG_INF;
      const float m_new = fmaxf(m_run[i], warp_max(sm));
      // re-mask after the shift: on a fully masked row m_new is -1e30 and
      // exp(sm - m_new) would be 1
      const float p = ok ? expf(sm - m_new) : 0.f;
      const float alpha = expf(m_run[i] - m_new);
      l_run[i] = l_run[i] * alpha + warp_sum(p);
      m_run[i] = m_new;
#pragma unroll
      for (int t = 0; t < NT; ++t) acc[i][t] *= alpha;
      ps[warp][lane][i] = p;
    }
    __syncwarp();
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pj[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; i += 4) {
        const float4 p4 = *reinterpret_cast<const float4*>(&ps[warp][j][i]);
        pj[i] = p4.x;
        pj[i + 1] = p4.y;
        pj[i + 2] = p4.z;
        pj[i + 3] = p4.w;
      }
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int d = lane + 32 * t;
        const float vv = d < D ? vs[j][d] : 0.f;
#pragma unroll
        for (int i = 0; i < ROWS; ++i) acc[i][t] = fmaf(pj[i], vv, acc[i][t]);
      }
    }
    __syncwarp();
  }

  T* out = static_cast<T*>(a.out) + static_cast<size_t>(bh) * Sq * D;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    if (!live[i]) continue;
    const float l = l_run[i] == 0.f ? 1.f : l_run[i];
    const size_t row = static_cast<size_t>(q0 + warp * ROWS + i) * D;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int d = lane + 32 * t;
      if (d < D) store(out + row + d, __fdiv_rn(acc[i][t], l));
    }
  }
}

// One launch; the first launch of an instance sets its shared memory
// limit (once per instance and process).
template <int D, typename T>
int launch_fma_type(const FlashArgs& a, cudaStream_t s) {
  constexpr int smem = FmaSmem<D>::BYTES;
  auto* kernel = flash_fma_kernel<D, T>;
  static const int ready = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  if (ready != 0) return ready;
  const dim3 grid((a.Sq + FmaSmem<D>::BQ - 1) / FmaSmem<D>::BQ, a.B * a.H);
  kernel<<<grid, WARPS * 32, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_fma(const FlashArgs& a, cudaStream_t s) {
  return a.bf16 ? launch_fma_type<D, __nv_bfloat16>(a, s)
                : launch_fma_type<D, float>(a, s);
}

}  // namespace

extern "C" {

// One launch on a->route; returns 0, a cudaError_t, or -1 for a head size
// not compiled in (D must be 16, 32, 64, 80, 96, 128 or 256 on the first
// three routes, a multiple of 128 above 256 on WIDE; the wrapper pads any
// other D with zero columns) or a route that does not take the call (MMA:
// bf16 only; SPLIT: Sq <= 16).
int flash_attention_launch(const FlashArgs* a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a->route) {
    case SPLIT:
      return flash_launch_split(*a, s);
    case MMA:
      return flash_launch_mma(*a, s);
    case WIDE:
      return flash_launch_wide(*a, s);
    case FMA:
      switch (a->D) {
        case 16: return launch_fma<16>(*a, s);
        case 32: return launch_fma<32>(*a, s);
        case 64: return launch_fma<64>(*a, s);
        case 80: return launch_fma<80>(*a, s);
        case 96: return launch_fma<96>(*a, s);
        case 128: return launch_fma<128>(*a, s);
        case 256: return launch_fma<256>(*a, s);
        default: return -1;
      }
    default:
      return -1;
  }
}

}  // extern "C"
