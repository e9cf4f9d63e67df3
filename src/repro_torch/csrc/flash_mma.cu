// Route MMA of flash attention (bf16, Sq > 16: prefill), replacing
// src/repro/kernels/flash_attention.py: flash_attention for those shapes.
// Semantics in flash_attention.cu's header.
//
// What bounds it on an H100: 4*D flops per attended (query, key) pair
// against bytes read once, so at prefill the arithmetic does; on the CUDA
// cores in float32 (67 TFLOP/s) the prefill case of chip_smoke.py could
// not beat scaled_dot_product_attention however it was tuned, so this
// route runs both products on the bf16 tensor cores with
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, FA2-style:
//   * A block owns 64 query rows, 4 warps x 16 rows.  The Q tile lands in
//     shared memory by cp.async and each warp loads its A fragments once
//     by ldmatrix into registers (at D = 256, whose output accumulator
//     takes 128 registers a thread, again at every k step instead).
//   * K and V tiles of 64 keys stream through an NST-stage cp.async ring
//     (3 stages; 2 from D = 128, whose stages are twice as large).  Rows
//     are padded by 16 bytes, so the 8 rows an ldmatrix reads hit 8
//     distinct bank groups; V's B fragments come by ldmatrix.trans.
//   * S = Q.K^T accumulates in float32 registers (the C fragment: a row
//     lives on the 4 lanes of a quad).  Softcap and mask are applied in
//     registers; the softmax keeps the running max and sum per row,
//     reduced over the quad by two shuffles, and takes the scale into the
//     exponent: p = 2^(s*scale*log2(e) - m), one FFMA and one EX2 a score.
//   * P becomes the A fragment of the P.V mma in registers, as two bf16
//     terms: hi = bf16(p) and lo = bf16(p - hi), two mma each.  One bf16
//     term rounds p by up to 2^-9 relative, and its error, summed over a
//     row with few keys, exceeds one bf16 ulp of the output, which is the
//     tolerance against the float32 plain version; hi + lo keeps p to
//     about 2^-17.  l sums the unrounded float32 p.
//   * Under a causal mask or a window a block walks only the key tiles its
//     rows can reach and masks only the tiles on the frontier (and those
//     crossing the pad or Sk); explicit positions walk and mask every
//     tile.  Blocks of the late query tiles, which have the most keys,
//     are launched first: grid (B*H, Sq/64), the tile index reversed.
#include "flash_common.cuh"
#include "hopper_async.cuh"

namespace {

using namespace flash;
using namespace hopper;

constexpr int MBQ = 64;        // query rows of a block
constexpr int MBK = 64;        // keys of a tile
constexpr int MTHREADS = 128;  // 4 warps x 16 rows
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory: the Q tile, NST stages of (K, V) and each stage's key
// positions (explicit positions only).
template <int D>
struct MmaSmem {
  static constexpr int PITCH = 2 * D + 16;     // bytes of a padded row
  static constexpr int TILE = 64 * PITCH;
  // 3 stages; 2 from D = 128, whose stages are twice as large or more
  static constexpr int NST = D >= 128 ? 2 : 3;
  static constexpr int RING = TILE * 2 * NST;
  static constexpr int KPOS = 4 * MBK * NST;
  static constexpr int BYTES = TILE + RING + KPOS;
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
// d += a . b for one 16 x 8 x 16 bf16 product, float32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// A 4-byte cp.async (through L1), zero-filled and reading nothing when
// !in.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}
// 2^x, flushing results below 2^-126 to 0 (one MUFU.EX2).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}
// (x, y) as two bf16 pairs hi + lo, lo = the rounding error of hi.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x - f.x, y - f.y);
}

// Rows [row0, row0 + 64) of a (rows, D) bf16 matrix into a padded shared
// tile; rows at or past `valid` are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(unsigned char* dst,
                                          const unsigned char* src,
                                          int row0, int valid, int tid) {
  constexpr int CH = D / 8;   // 16-byte chunks of a row
#pragma unroll
  for (int e = tid; e < 64 * CH; e += MTHREADS) {
    const int r = e / CH, c = e % CH;
    const bool in = row0 + r < valid;
    cp_async16(dst + r * (2 * D + 16) + c * 16,
               src + static_cast<size_t>(in ? row0 + r : 0) * (2 * D) +
                   c * 16,
               in);
  }
}

template <int D>
__global__ void __launch_bounds__(MTHREADS)
flash_mma_kernel(FlashArgs a) {
  using L = MmaSmem<D>;
  constexpr int KSTEPS = D / 16;   // k steps of Q.K^T
  constexpr int NT = D / 8;        // 8-column tiles of the output
  // Q's A fragments stay in registers up to D = 128; at D = 256 the
  // 16 x 256 float32 output already takes 128 registers a thread, so each
  // k step reads its fragment from the Q tile in shared memory
  constexpr bool QREG = D <= 128;
  static_assert(D % 16 == 0, "k steps of 16");
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* qsm = smem;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c4 = lane & 3;   // the mma fragments' row, pair
  const int bh = blockIdx.x, b = bh / a.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * MBQ;
  const int Sq = a.Sq, Sk = a.Sk;
  const bool explicit_pos = a.qpos != nullptr;
  const int pad = a.pad ? a.pad[b] : 0;
  const unsigned char* qg = static_cast<const unsigned char*>(a.q) +
                            static_cast<size_t>(bh) * Sq * (2 * D);
  const unsigned char* kg = static_cast<const unsigned char*>(a.k) +
                            static_cast<size_t>(bh) * Sk * (2 * D);
  const unsigned char* vg = static_cast<const unsigned char*>(a.v) +
                            static_cast<size_t>(bh) * Sk * (2 * D);

  // key tiles some row of the block can attend (implicit positions)
  const int qmin = q0 + Sk - Sq;         // the block's first row
  const int qlast = q0 + MBQ - 1 + Sk - Sq;
  int k_lo = 0, k_hi = Sk;
  if (!explicit_pos) {
    if (a.causal) k_hi = min(k_hi, min(q0 + MBQ, Sq) + Sk - Sq);
    if (a.has_window) k_lo = max(k_lo, qmin - a.window + 1);
    k_lo = max(k_lo, pad);
  }
  const int t_lo = k_lo / MBK;
  const int nt = k_hi > k_lo ? (k_hi + MBK - 1) / MBK - t_lo : 0;

  auto kst = [&](int st) { return smem + L::TILE * (1 + 2 * st); };
  auto vst = [&](int st) { return smem + L::TILE * (2 + 2 * st); };
  int* kps = reinterpret_cast<int*>(smem + L::TILE + L::RING);  // [NST][64]
  const int* kposb = explicit_pos ? a.kpos + static_cast<size_t>(b) * Sk
                                  : nullptr;
  // key tile i of this block into stage st: K, V and the key positions
  auto issue = [&](int st, int i) {
    const int k0 = (t_lo + i) * MBK;
    load_tile<D>(kst(st), kg, k0, Sk, tid);
    load_tile<D>(vst(st), vg, k0, Sk, tid);
    if (explicit_pos && tid < MBK) {
      const bool in = k0 + tid < Sk;
      cp_async4(kps + st * MBK + tid, kposb + (in ? k0 + tid : 0), in);
    }
  };
  load_tile<D>(qsm, qg, q0, Sq, tid);
#pragma unroll
  for (int st = 0; st < L::NST - 1; ++st) {
    if (st < nt) issue(st, st);
    cp_async_commit();   // Q goes with stage 0
  }

  // this thread's two rows: g and g + 8 of the warp's 16
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  int qp0, qp1;
  if (explicit_pos) {
    const int* qpos = a.qpos + static_cast<size_t>(b) * Sq;
    qp0 = row0 < Sq ? qpos[row0] : -1;
    qp1 = row1 < Sq ? qpos[row1] : -1;
  } else {
    qp0 = row0 + Sk - Sq;
    qp1 = row1 + Sk - Sq;
  }

  uint32_t qf[QREG ? KSTEPS : 1][4];
  auto q_frag = [&](uint32_t (&f)[4], int kk) {
    ldsm_x4(f, qsm + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8)
                         * L::PITCH +
                   (kk * 16 + (lane >> 4) * 8) * 2);
  };
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  // The softmax runs on the scores before the scale (after it under a
  // softcap, which needs it first); p = 2^(x*sl - m*sl), one FFMA and one
  // EX2 a score.
  const float sl = __fmul_rn(a.has_softcap ? 1.f : a.scale, LOG2E);

  for (int i = 0; i < nt; ++i) {
    cp_async_wait<L::NST - 2>();   // this thread's copies of tile i
    __syncthreads();               // everyone's; tile i - 1 is consumed
    if (QREG && i == 0) {
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) q_frag(qf[QREG ? kk : 0], kk);
    }
    {
      const int nx = i + L::NST - 1;
      if (nx < nt) issue(nx % L::NST, nx);
      cp_async_commit();
    }
    const unsigned char* ks = kst(i % L::NST);
    const unsigned char* vs = vst(i % L::NST);
    const int* kp_tile = kps + (i % L::NST) * MBK;
    const int k0 = (t_lo + i) * MBK;

    // S = Q.K^T, 8 column tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const int qk = QREG ? kk : 0;
      if (!QREG) q_frag(qf[0], kk);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t kb[4];
        ldsm_x4(kb, ks + (jp * 16 + (lane & 7) + (lane >> 4) * 8) * L::PITCH +
                        (kk * 16 + ((lane >> 3) & 1) * 8) * 2);
        mma_bf16(s[2 * jp], qf[qk], kb[0], kb[1]);
        mma_bf16(s[2 * jp + 1], qf[qk], kb[2], kb[3]);
      }
    }

    // softcap and mask
    const bool edge = explicit_pos || k0 + MBK > Sk || k0 < pad ||
                      (a.causal && k0 + MBK - 1 > qmin) ||
                      (a.has_window && k0 <= qlast - a.window);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = a.has_softcap ? scaled(s[j][e], a) : s[j][e];
        if (edge) {
          const int jk = j * 8 + 2 * c4 + (e & 1);
          const int key = k0 + jk;
          const int kp = key >= Sk ? -1 : explicit_pos ? kp_tile[jk] : key;
          if (!(key < Sk && attends(e < 2 ? qp0 : qp1, kp, pad,
                                    explicit_pos, a))) {
            x = NEG_INF;
          }
        }
        s[j][e] = x;
      }
    }

    // online softmax: the row max over the quad, the rescale, p
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int o_ = 1; o_ < 4; o_ <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(~0u, mx0, o_));
      mx1 = fmaxf(mx1, __shfl_xor_sync(~0u, mx1, o_));
    }
    // a row with no attended key yet keeps m = -1e30; shifting by 0 then
    // sends its masked scores to 2^(-1e30 sl) = 0
    const float mu0 = mx0 == NEG_INF ? 0.f : mx0 * sl;
    const float mu1 = mx1 == NEG_INF ? 0.f : mx1 * sl;
    const float al0 = ex2(fmaf(m0, sl, -mu0)), al1 = ex2(fmaf(m1, sl, -mu1));
    m0 = mx0;
    m1 = mx1;
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = ex2(fmaf(s[j][0], sl, -mu0));
      s[j][1] = ex2(fmaf(s[j][1], sl, -mu0));
      s[j][2] = ex2(fmaf(s[j][2], sl, -mu1));
      s[j][3] = ex2(fmaf(s[j][3], sl, -mu1));
      ls0 += s[j][0] + s[j][1];
      ls1 += s[j][2] + s[j][3];
    }
    l0 = l0 * al0 + ls0;   // this thread's share; the quad sums at the end
    l1 = l1 * al1 + ls1;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= al0;
      o[n][1] *= al0;
      o[n][2] *= al1;
      o[n][3] *= al1;
    }

    // O += P.V: k step kk takes keys 16kk..16kk+15, whose S column tiles
    // 2kk and 2kk+1 are the A fragment's layout
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8)
                                   * L::PITCH +
                              (np * 16 + (lane >> 4) * 8) * 2);
        mma_bf16(o[2 * np], ph, vb[0], vb[1]);
        mma_bf16(o[2 * np], pl, vb[0], vb[1]);
        mma_bf16(o[2 * np + 1], ph, vb[2], vb[3]);
        mma_bf16(o[2 * np + 1], pl, vb[2], vb[3]);
      }
    }
  }
  cp_async_wait<0>();   // no copy may land after the block has gone

#pragma unroll
  for (int o_ = 1; o_ < 4; o_ <<= 1) {
    l0 += __shfl_xor_sync(~0u, l0, o_);
    l1 += __shfl_xor_sync(~0u, l1, o_);
  }
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out) +
                       static_cast<size_t>(bh) * Sq * D;
  const float d0 = l0 == 0.f ? 1.f : l0, d1 = l1 == 0.f ? 1.f : l1;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = n * 8 + 2 * c4;
    if (row0 < Sq) {
      *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(row0) * D +
                                         col) =
          __floats2bfloat162_rn(__fdiv_rn(o[n][0], d0),
                                __fdiv_rn(o[n][1], d0));
    }
    if (row1 < Sq) {
      *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(row1) * D +
                                         col) =
          __floats2bfloat162_rn(__fdiv_rn(o[n][2], d1),
                                __fdiv_rn(o[n][3], d1));
    }
  }
}

// One launch; the first launch of an instance sets its shared memory
// limit (once per instance and process).
template <int D>
int launch_mma(const FlashArgs& a, cudaStream_t stream) {
  constexpr int smem = MmaSmem<D>::BYTES;
  auto* kernel = flash_mma_kernel<D>;
  static const int ready = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  if (ready != 0) return ready;
  const dim3 grid(a.B * a.H, (a.Sq + MBQ - 1) / MBQ);
  kernel<<<grid, MTHREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

int flash_launch_mma(const FlashArgs& a, cudaStream_t stream) {
  if (!a.bf16) return -1;
  switch (a.D) {
    case 16: return launch_mma<16>(a, stream);
    case 32: return launch_mma<32>(a, stream);
    case 64: return launch_mma<64>(a, stream);
    case 80: return launch_mma<80>(a, stream);
    case 96: return launch_mma<96>(a, stream);
    case 128: return launch_mma<128>(a, stream);
    case 256: return launch_mma<256>(a, stream);
    default: return -1;
  }
}
