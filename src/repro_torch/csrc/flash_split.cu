// Route SPLIT of flash attention (decode and query blocks of Sq <= 16 rows),
// replacing src/repro/kernels/flash_attention.py: flash_attention for those
// shapes.  Semantics in flash_attention.cu's header.
//
// What bounds it on an H100: each (b, h) reads Sk keys and values once and
// does 4*Sq*D flops a key, so at Sq <= 16 reading K and V from device
// memory bounds it (decode at 2048 keys, 72 heads, D 64, bf16: 37.7 MB,
// 11.3 us at 3.35 TB/s).  One block per (b, h) walking all keys alone
// leaves most SMs idle and every key tile a serial DRAM round trip.  So:
//   * The keys of a (b, h) are split over a thread-block cluster of S <= 8
//     blocks: grid (S, B*H), cluster (S, 1, 1).  Each rank takes a
//     contiguous run of the SPLIT_TILE-key tiles its rows can reach (pad,
//     window; `kernels/ref.py::split_key_ranges` is the same plan), so at
//     decode 72 heads make 576 blocks.
//   * Keys and values stream by 16-byte cp.async through a ring of shared
//     memory, one ring per warp (NST stages of a 32-key tile): a warp
//     waits only for its own copies and needs no block barrier.
//   * The block's 4 warps split its keys (warp w takes tiles w, w + 4,
//     ...).  Lane j scores key j against the rows in float32 FMAs (the
//     CUDA cores serve a bound set by bytes); each warp keeps a running
//     (m, l, acc[D]) per row, and the block merges its warps in shared
//     memory.
//   * The cluster merges without a workspace: every rank but 0 sends its
//     (acc, m, l) partial into rank 0's shared memory with one bulk copy
//     counted on rank 0's mbarrier; rank 0 merges the S partials and
//     writes the output.  A rank with no keys (all pad, past the frontier)
//     sends m = -1e30, l = 0 and reaches every cluster barrier; exp(m_i -
//     M) weighs it 0, or 1 against an all-empty merge whose sums are 0.
#include "flash_common.cuh"
#include "hopper_async.cuh"

namespace {

using namespace flash;
using namespace hopper;

constexpr int SBK = 32;    // keys of a warp tile: one a lane
constexpr int SMEM_MAX = 232448;   // shared memory a block can have

// Output columns of a lane: the power of two that lets 32 lanes cover D
// (lanes past D repeat and write nothing).
__host__ __device__ constexpr int split_cpl(int D) {
  return D <= 32 ? 1 : D <= 64 ? 2 : D <= 128 ? 4 : 8;
}

// Dynamic shared memory of one instance: the warps' rings of K and V
// tiles (K rows padded by 16 bytes, so lanes reading their own key's row
// hit distinct banks; a warp reads V one row at a time), the q rows as
// float32, a warp tile's p by [warp][key][row], the block's partial, and
// rank 0's receive buffer of the other ranks' partials and its mbarrier.
// After the key loop the warps' partials are merged over the rings.  A
// block has SW = 4 warps, 2 where four rings of one stage would not fit
// (float32 at D = 256), and clusters of at most MAXS blocks: the most
// whose receive buffer fits beside the rest (fewer than 8 only at D =
// 256 with 16 rows).
template <int D, int R, typename T>
struct SplitSmem {
  static constexpr int RB = D * static_cast<int>(sizeof(T));  // a key row
  static constexpr int CH = RB / 16;                          // its chunks
  static constexpr int KP = RB + 16;
  static constexpr int VP = RB;
  static constexpr int STAGE = SBK * (KP + VP);
  static constexpr int SW = 4 * STAGE <= 160 * 1024 ? 4 : 2;  // warps
  static constexpr int THREADS = SW * 32;
  static constexpr int NST = SW * 2 * STAGE <= 160 * 1024 ? 2 : 1;
  static constexpr int RING = SW * NST * STAGE;
  static constexpr int PARTF = (R * (D + 2) + 3) / 4 * 4;  // acc, m, l
  static constexpr int PART = 4 * PARTF;                   // bytes
  static constexpr int QS = 4 * R * D;
  static constexpr int PS = 4 * SW * SBK * R;
  static constexpr int BASE = RING + QS + PS + PART + 16;
  static constexpr int MAXS =
      (SMEM_MAX - BASE) / PART + 1 < MAX_SPLITS
          ? (SMEM_MAX - BASE) / PART + 1 : MAX_SPLITS;
  static constexpr int BYTES = BASE + (MAXS - 1) * PART;
  static_assert(RB % 16 == 0, "16-byte key rows");
  static_assert(SW * PART <= RING, "the warps' partials fit the rings");
  static_assert(MAXS >= 1 && BYTES <= SMEM_MAX, "an instance fits a block");
};

// N contiguous elements of a shared row as float32 (one or two loads of
// 2-16 bytes).
template <typename T, int N>
__device__ __forceinline__ void load_row(const unsigned char* p,
                                         float (&out)[N]) {
  if constexpr (sizeof(T) == 4) {
    if constexpr (N == 8) {
      const float4 v0 = *reinterpret_cast<const float4*>(p);
      const float4 v1 = *reinterpret_cast<const float4*>(p + 16);
      out[0] = v0.x; out[1] = v0.y; out[2] = v0.z; out[3] = v0.w;
      out[4] = v1.x; out[5] = v1.y; out[6] = v1.z; out[7] = v1.w;
    } else if constexpr (N == 4) {
      const float4 v = *reinterpret_cast<const float4*>(p);
      out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
    } else if constexpr (N == 2) {
      const float2 v = *reinterpret_cast<const float2*>(p);
      out[0] = v.x; out[1] = v.y;
    } else {
      out[0] = *reinterpret_cast<const float*>(p);
    }
  } else {
    if constexpr (N == 1) {
      out[0] = __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(p));
    } else {
      static_assert(N == 2 || N == 4 || N == 8, "bf16 row pieces");
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(p);
      if constexpr (N == 2) {
        const float2 f = __bfloat1622float2(*h);
        out[0] = f.x; out[1] = f.y;
      } else if constexpr (N == 4) {
        const uint2 u = *reinterpret_cast<const uint2*>(p);
        const float2 f0 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&u.x));
        const float2 f1 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&u.y));
        out[0] = f0.x; out[1] = f0.y; out[2] = f1.x; out[3] = f1.y;
      } else {
        const uint4 u = *reinterpret_cast<const uint4*>(p);
        const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
          out[2 * i] = f.x;
          out[2 * i + 1] = f.y;
        }
      }
    }
  }
}

// The keys of this rank: a contiguous run of the SPLIT_TILE-key tiles the
// rows can reach, [lo, hi), empty when hi <= lo
// (`kernels/ref.py::split_key_ranges`).
__device__ __forceinline__ void split_range(const FlashArgs& a, int pad,
                                            bool explicit_pos, int S,
                                            int rank, int& lo, int& hi) {
  int k_lo = 0;
  const int k_hi = a.Sk;
  if (!explicit_pos) {
    if (a.has_window) k_lo = max(k_lo, a.Sk - a.Sq - a.window + 1);
    k_lo = max(k_lo, pad);
  }
  lo = hi = k_lo;
  if (k_hi <= k_lo) return;
  const int t_lo = k_lo / SPLIT_TILE;
  const int n = (k_hi + SPLIT_TILE - 1) / SPLIT_TILE - t_lo;
  const int a0 = t_lo + n * rank / S;
  const int a1 = t_lo + n * (rank + 1) / S;
  lo = max(k_lo, a0 * SPLIT_TILE);
  hi = max(lo, min(k_hi, a1 * SPLIT_TILE));
}

template <int D, int R, typename T>
__global__ void __launch_bounds__(SplitSmem<D, R, T>::THREADS)
flash_split_kernel(FlashArgs a) {
  using L = SplitSmem<D, R, T>;
  constexpr int SW = L::SW;
  constexpr int STHREADS = L::THREADS;
  constexpr int EPC = 16 / static_cast<int>(sizeof(T));  // a chunk's values
  constexpr int CPL = split_cpl(D);          // output columns of a lane
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  float* qs = reinterpret_cast<float*>(smem + L::RING);   // [R][D]
  float* ps = qs + R * D;                                 // [SW][SBK][R]
  float* part = ps + SW * SBK * R;                        // acc, m, l
  float* recv = part + L::PARTF;                          // [S - 1][PARTF]
  const unsigned mbar = smem_u32(smem + L::BYTES - 16);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int S = static_cast<int>(gridDim.x);     // cluster (S, 1, 1)
  const int rank = static_cast<int>(blockIdx.x);
  const int bh = blockIdx.y, b = bh / a.H;
  const int Sq = a.Sq, Sk = a.Sk;
  const bool explicit_pos = a.qpos != nullptr;
  const int pad = a.pad ? a.pad[b] : 0;

  // Rank 0's mbarrier expects the other ranks' partials; the cluster
  // barrier begun here makes it ready before the first copy.
  if (S > 1) {
    if (rank == 0 && tid == 0) {
      mbar_init(mbar, 1);
      mbar_expect(mbar, static_cast<unsigned>((S - 1) * L::PART));
      fence_mbarrier_init();
    }
    cluster_arrive_relaxed();
  }

  int lo, hi;
  split_range(a, pad, explicit_pos, S, rank, lo, hi);
  const int kb0 = lo & ~(SBK - 1);
  const int ntiles = hi > lo ? (hi - kb0 + SBK - 1) / SBK : 0;
  const int mine = ntiles > warp ? (ntiles - warp + SW - 1) / SW : 0;
  const unsigned char* kg = static_cast<const unsigned char*>(a.k) +
                            static_cast<size_t>(bh) * Sk * L::RB;
  const unsigned char* vg = static_cast<const unsigned char*>(a.v) +
                            static_cast<size_t>(bh) * Sk * L::RB;
  unsigned char* wring = ring + warp * L::NST * L::STAGE;

  // the warp's i-th tile into its ring; keys at or past hi are zero-filled
  auto issue = [&](int i) {
    const int k0 = kb0 + (warp + i * SW) * SBK;
    unsigned char* kst = wring + (i % L::NST) * L::STAGE;
    unsigned char* vst = kst + SBK * L::KP;
#pragma unroll
    for (int e = lane; e < SBK * L::CH; e += 32) {
      const int j = e / L::CH, c = e % L::CH;
      const bool in = k0 + j < hi;
      const size_t at = static_cast<size_t>(in ? k0 + j : 0) * L::RB + c * 16;
      cp_async16(kst + j * L::KP + c * 16, kg + at, in);
      cp_async16(vst + j * L::VP + c * 16, vg + at, in);
    }
  };
#pragma unroll
  for (int i = 0; i < L::NST - 1; ++i) {
    if (i < mine) issue(i);
    cp_async_commit();
  }

  const T* q = static_cast<const T*>(a.q) + static_cast<size_t>(bh) * Sq * D;
  for (int e = tid; e < R * D; e += STHREADS) {
    qs[e] = e / D < Sq ? to_f32(q[e]) : 0.f;
  }
  int qp[R];
  bool live[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    live[r] = r < Sq;
    qp[r] = !live[r] ? -1
            : explicit_pos ? a.qpos[static_cast<size_t>(b) * Sq + r]
                           : r + Sk - Sq;
  }
  __syncthreads();   // qs

  float m_run[R], l_run[R], acc[R][CPL];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m_run[r] = NEG_INF;
    l_run[r] = 0.f;
#pragma unroll
    for (int t = 0; t < CPL; ++t) acc[r][t] = 0.f;
  }
  float* wps = ps + warp * SBK * R;
  // lanes past D (D = 16, 80, 96) repeat from column 0 and write nothing
  const int d0 = (lane * CPL) % D;

  for (int i = 0; i < mine; ++i) {
    if (i + L::NST - 1 < mine) issue(i + L::NST - 1);
    cp_async_commit();
    cp_async_wait<L::NST - 1>();   // this lane's copies of tile i
    __syncwarp();                  // and the other lanes'
    const unsigned char* kst = wring + (i % L::NST) * L::STAGE;
    const unsigned char* vst = kst + SBK * L::KP;
    const int key = kb0 + (warp + i * SW) * SBK + lane;

    // scores of this lane's key against the rows, d in order
    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = 0.f;
    const unsigned char* krow = kst + lane * L::KP;
#pragma unroll
    for (int c = 0; c < L::CH; ++c) {
      float kv[EPC];
      load_row<T, EPC>(krow + c * 16, kv);
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int e = 0; e < EPC; e += 4) {
          const float4 qv =
              *reinterpret_cast<const float4*>(qs + r * D + c * EPC + e);
          s[r] = fmaf(qv.x, kv[e], s[r]);
          s[r] = fmaf(qv.y, kv[e + 1], s[r]);
          s[r] = fmaf(qv.z, kv[e + 2], s[r]);
          s[r] = fmaf(qv.w, kv[e + 3], s[r]);
        }
      }
    }
    const bool kin = key >= lo && key < hi;
    const int kp = !kin ? -1
                   : explicit_pos ? a.kpos[static_cast<size_t>(b) * Sk + key]
                                  : key;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float x = scaled(s[r], a);
      const bool ok = live[r] && kin && attends(qp[r], kp, pad,
                                                explicit_pos, a);
      const float sm = ok ? x : NEG_INF;
      const float m_new = fmaxf(m_run[r], warp_max(sm));
      // re-mask after the shift: on a fully masked row m_new is -1e30 and
      // exp(sm - m_new) would be 1
      const float p = ok ? expf(sm - m_new) : 0.f;
      const float alpha = expf(m_run[r] - m_new);
      l_run[r] = l_run[r] * alpha + warp_sum(p);
      m_run[r] = m_new;
#pragma unroll
      for (int t = 0; t < CPL; ++t) acc[r][t] *= alpha;
      wps[lane * R + r] = p;
    }
    __syncwarp();
#pragma unroll 4
    for (int j = 0; j < SBK; ++j) {
      float pj[R];
      if constexpr (R % 4 == 0) {
#pragma unroll
        for (int r = 0; r < R; r += 4) {
          const float4 p4 = *reinterpret_cast<const float4*>(wps + j * R + r);
          pj[r] = p4.x;
          pj[r + 1] = p4.y;
          pj[r + 2] = p4.z;
          pj[r + 3] = p4.w;
        }
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) pj[r] = wps[j * R + r];
      }
      float vv[CPL];
      load_row<T, CPL>(vst + j * L::VP + d0 * sizeof(T), vv);
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int t = 0; t < CPL; ++t) acc[r][t] = fmaf(pj[r], vv[t], acc[r][t]);
    }
    __syncwarp();   // the stage and wps are free for the next tile
  }
  cp_async_wait<0>();

  // The block's warps merged into `part` (acc[R][D], m[R], l[R]).
  __syncthreads();   // every warp is done with its ring
  float* wpart = reinterpret_cast<float*>(ring);   // [SW][PARTF]
  float* own = wpart + warp * L::PARTF;
  if (lane * CPL < D) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int t = 0; t < CPL; ++t) own[r * D + d0 + t] = acc[r][t];
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      own[R * D + r] = m_run[r];
      own[R * D + R + r] = l_run[r];
    }
  }
  __syncthreads();
  for (int e = tid; e < R * D; e += STHREADS) {
    const int r = e / D;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < SW; ++w) M = fmaxf(M, wpart[w * L::PARTF + R * D + r]);
    float A = 0.f, Lsum = 0.f;
#pragma unroll
    for (int w = 0; w < SW; ++w) {
      const float* pw = wpart + w * L::PARTF;
      const float f = expf(pw[R * D + r] - M);
      A = fmaf(pw[e], f, A);
      Lsum = fmaf(pw[R * D + R + r], f, Lsum);
    }
    part[e] = A;
    if (e % D == 0) {
      part[R * D + r] = M;
      part[R * D + R + r] = Lsum;
    }
  }

  // The cluster: ranks 1..S-1 send their partials to rank 0, which
  // merges them with its own.  Every rank reaches both cluster barriers.
  int nparts = 1;
  if (S > 1) {
    fence_proxy_async();   // part, visible to the bulk copy engine
    cluster_wait();        // rank 0's mbarrier is initialized
    __syncthreads();       // part is complete
    if (rank != 0) {
      if (tid == 0) {
        bulk_to_rank(map_rank(smem_u32(recv) + (rank - 1) * L::PART, 0),
                     smem_u32(part), L::PART, map_rank(mbar, 0));
      }
      // rank 0 arrives once every partial has landed; until then this
      // block's shared memory must stay
      cluster_arrive_relaxed();
      cluster_wait();
      return;
    }
    mbar_wait(mbar, 0);
    cluster_arrive_relaxed();
    nparts = S;
  } else {
    __syncthreads();
  }

  T* out = static_cast<T*>(a.out) + static_cast<size_t>(bh) * Sq * D;
  for (int e = tid; e < R * D; e += STHREADS) {
    const int r = e / D;
    if (r >= Sq) continue;
    float M = part[R * D + r];
    for (int i = 1; i < nparts; ++i) {
      M = fmaxf(M, recv[(i - 1) * L::PARTF + R * D + r]);
    }
    float A = 0.f, Lsum = 0.f;
    for (int i = 0; i < nparts; ++i) {
      const float* pi = i == 0 ? part : recv + (i - 1) * L::PARTF;
      const float f = expf(pi[R * D + r] - M);
      A = fmaf(pi[e], f, A);
      Lsum = fmaf(pi[R * D + R + r], f, Lsum);
    }
    store(out + e, __fdiv_rn(A, Lsum == 0.f ? 1.f : Lsum));
  }
  if (S > 1) cluster_wait();
}

// Set an instance's dynamic shared memory limit and check that a cluster
// of its largest size (MAXS blocks) can be co-scheduled on the card.
template <typename Kernel>
int prepare_split(Kernel kernel, int smem, int threads, int maxs) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = maxs;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(maxs, 1, 1);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (e != cudaSuccess) return static_cast<int>(e);
  return clusters > 0 ? 0 : static_cast<int>(cudaErrorLaunchOutOfResources);
}

// One launch as a cluster of a.splits blocks along x; the first launch of
// an instance sets its shared memory limit (once per instance and
// process).
template <int D, int R, typename T>
int launch_split(const FlashArgs& a, cudaStream_t stream) {
  using L = SplitSmem<D, R, T>;
  constexpr int smem = L::BYTES;
  auto* kernel = flash_split_kernel<D, R, T>;
  static const int ready = prepare_split(kernel, smem, L::THREADS, L::MAXS);
  if (ready != 0) return ready;
  if (a.splits < 1 || a.splits > MAX_SPLITS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the cluster the instance's receive buffer holds (the kernel reads S
  // off its grid)
  const int S = a.splits < L::MAXS ? a.splits : L::MAXS;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = S;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, a.B * a.H);
  cfg.blockDim = dim3(L::THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = S > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, a);
  const cudaError_t last = cudaGetLastError();   // cleared either way
  return static_cast<int>(e != cudaSuccess ? e : last);
}

template <int R, typename T>
int launch_rows(const FlashArgs& a, cudaStream_t s) {
  switch (a.D) {
    case 16: return launch_split<16, R, T>(a, s);
    case 32: return launch_split<32, R, T>(a, s);
    case 64: return launch_split<64, R, T>(a, s);
    case 80: return launch_split<80, R, T>(a, s);
    case 96: return launch_split<96, R, T>(a, s);
    case 128: return launch_split<128, R, T>(a, s);
    case 256: return launch_split<256, R, T>(a, s);
    default: return -1;
  }
}

template <typename T>
int launch_type(const FlashArgs& a, cudaStream_t s) {
  if (a.Sq == 1) return launch_rows<1, T>(a, s);
  if (a.Sq <= 4) return launch_rows<4, T>(a, s);
  return launch_rows<SPLIT_MAX_ROWS, T>(a, s);
}

}  // namespace

// Row instances: 1 (decode), 4 and 16 query rows.
int flash_launch_split(const FlashArgs& a, cudaStream_t stream) {
  if (a.Sq < 1 || a.Sq > SPLIT_MAX_ROWS) return -1;
  return a.bf16 ? launch_type<__nv_bfloat16>(a, stream)
                : launch_type<float>(a, stream);
}
