// The 64-row tile of the tile kernel (rns_common.cuh) for the raw signed
// int8 A operand (A_SHARED) at M > 16, on wgmma and TMA (sm_90a).  It
// replaces, for those launches, the 32-row mma.sync instance of the same
// Pallas kernels: src/repro/kernels/rns_matmul.py: rns_matmul with
// signed_a (the broadcast form, EMIT_CANONICAL) and
// src/repro/kernels/rns_fused.py: rns_fused_matmul and rns_fused_crt_partial
// on an int8 block (EMIT_FLOAT with optional scales, EMIT_RESIDUES,
// EMIT_CRT_LIMBS), encoded (C, K, N) or live (K, N) weights, C <= 7.
//
// What bounds it: at prefill (M = 512) one smollm layer's seven launches
// are C x 2*M*K*N = 18.1 G int8 operations (9.2 us at 1,979 TOP/s) and
// 2.65 M output elements, each folded in C channels and reversed by MRC:
// some 250 integer instructions an element, ~20 us of the card's ALUs.  The
// 32-row tile spent its time elsewhere: each 32-deep K step read A and
// the weights through registers, transposed the weights in the consumers'
// own critical path and passed two __syncthreads.  This tile:
//   * A: the (M, K) int8 plane is K-major already, as wgmma wants it.  One
//     thread copies each 64 x 128-byte stage with one TMA load
//     (cp.async.bulk.tensor.2d, 128-byte swizzle, rows past M and k past K
//     zero-filled) into a ring of STAGES stages, counted in on the stage's
//     "full" mbarrier.
//   * B: wgmma takes s8 operands only K-major, and the weights are (C, K,
//     N) or (K, N) n-fastest; live ones need |w|_{m_c} per channel too.  A
//     producer warpgroup reads each stage's 128 x 32 weight bytes a channel
//     (16-byte loads, every channel of a thread at once), converts live
//     ones, transposes 4 x 4 byte blocks with __byte_perm and stores them
//     K-major in the 128-byte swizzle wgmma reads, then fences them for the
//     async proxy and arrives on the same "full" mbarrier: the byte
//     transpose runs beside the tensor cores.
//   * Math: one consumer warpgroup waits on the stage, runs
//     wgmma.mma_async m64n32k32.s32.s8.s8 for every channel on the same A
//     tile (4 x C a stage), waits for them and releases the stage on its
//     "empty" mbarrier.
//   * Accumulators: C x 16 int32 a thread (112 at C = 7) at a 32-column
//     tile.  Up to C = 5 two blocks fit an SM (256 threads at 128
//     registers, <= 112 KB), so one block's epilogue runs beside the
//     other's K loop; C = 6 and 7 run one block an SM.  No setmaxnreg:
//     ptxas compiles both warpgroups under the launch bound's cap, so
//     raising the consumers' count buys them nothing, and lowering the
//     producer's to 96 spilled its reads (measured slower).
//   * Epilogue: the consumers put their sums in shared memory over the
//     retired ring; then both warpgroups, the producer's done with its
//     loads, take the tile's elements row by row (a warp a row of 32
//     columns, so stores coalesce) through `tile_epilogue<C, RAW, EMIT>`:
//     the fold, MRC and emit of every other instance.  Integer sums are
//     exact in any order, so every output is bit-equal to the plain
//     version.
// Launches whose A rows cannot be read by TMA (K % 16 != 0, an unaligned
// plane) keep the 32-row instance: kernels/rns_fused.py routes them there
// (`wg_ok`); this launcher refuses them.  The tensor map is encoded on the
// host per launch (cuTensorMapEncodeTiled, reached through the runtime's
// cudaGetDriverEntryPoint*, so the library needs no -lcuda) and passed as
// a __grid_constant__ parameter.
#pragma once

#include <cuda.h>

#include "rns_common.cuh"

namespace rns {

constexpr int WG_TN = 32;       // output columns a block
constexpr int WG_TK = 128;      // K bytes a stage: one 128-byte swizzle row
constexpr int WG_THREADS = 256; // warpgroup 0 produces, warpgroup 1 computes
constexpr int WG_A_BYTES = TM_WG * WG_TK;   // 8 KB
constexpr int WG_B_BYTES = WG_TN * WG_TK;   // 4 KB a channel
constexpr int WG_XROW = WG_TN + 8;  // exchange row, in int32 (pad: no
                                    // bank conflicts on the 8-byte stores)

// Shared memory of the C-channel instance: 1 KB of alignment slack, the A
// stages, the B stages (C planes each), then the full and empty
// mbarriers.  Stages: as many as keep two blocks on an SM.
template <int C>
struct WgSmem {
  static constexpr int STAGES = C <= 4 ? 4 : 3;
  static constexpr int STAGE = WG_A_BYTES + C * WG_B_BYTES;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int BYTES = 1024 + RING + 2 * STAGES * 8;
  static_assert(C * TM_WG * WG_XROW * 4 <= RING,
                "the sums' exchange fits the retired ring");
};

__device__ __forceinline__ void mbar_arrive(unsigned mbar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(mbar)
               : "memory");
}

// One TMA tile load of the 2-D map at (x = k, y = row) into shared memory,
// its bytes counted on mbar.
__device__ __forceinline__ void tma_load_2d(unsigned dst,
                                            const CUtensorMap* map, int x,
                                            int y, unsigned mbar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(mbar)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile in the 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart (SBO); the leading
// offset is unused by this layout.  The tile starts 1024-byte aligned; a
// 32-deep K step within the row adds 32 bytes (2 in the address field).
__device__ __forceinline__ uint64_t sw128_desc(unsigned addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// Byte offset of (row, k byte) in a 128-byte-swizzled K-major tile: the
// 16-byte chunk index XORed with the row within its 8-row group, as TMA's
// CU_TENSOR_MAP_SWIZZLE_128B writes it.
__device__ __forceinline__ int sw128_at(int row, int kb) {
  return row * WG_TK + ((((kb >> 4) ^ row) & 7) << 4) + (kb & 15);
}

template <int N>
__device__ __forceinline__ void reg_fence(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d += A (64 x 32, K-major, shared) x B (32 x 32, K-major, shared), int8
// to int32, issued by the whole warpgroup.
__device__ __forceinline__ void wgmma_s8_n32(int (&d)[16], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

// The producer's share of one stage's weights: thread p owns the 4 k x 16
// column block (k 4*(p%32).., columns 16*((p/32)%2)..) of the channels
// c = p/64, p/64 + 2, ...: four 16-byte rows read (zero past K or N),
// converted to |w|_{m_c} for live weights, transposed to one k-fastest
// word a column and stored in the swizzle.  A warp stores the 32 words of
// one swizzled row at a time: 32 banks.  A thread's encoded planes are all
// read before any is stored, so their reads overlap.
template <int C, bool ENCODED>
__device__ __forceinline__ void wg_produce_w(const TileArgs& a,
                                             const FusedPlan& plan,
                                             unsigned char* bstage, int n0,
                                             int k0, int p) {
  const int k4 = p & 31, n16 = (p >> 5) & 1, c0 = p >> 6;
  const int gn = n0 + 16 * n16;
  uint4 row[4];
  auto load = [&](int plane) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gk = k0 + 4 * k4 + j;
      const int8_t* src =
          a.w + (static_cast<size_t>(plane) * a.K + gk) * a.N + gn;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (gk < a.K) {
        if (a.w16) {
          if (gn < a.N) v = __ldg(reinterpret_cast<const uint4*>(src));
        } else {    // N % 4 == 0, 4-byte aligned rows (the route's vec)
          uint32_t wv[4];
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            wv[g] = gn + 4 * g < a.N
                ? __ldg(reinterpret_cast<const unsigned int*>(src + 4 * g))
                : 0u;
          }
          v = make_uint4(wv[0], wv[1], wv[2], wv[3]);
        }
      }
      row[j] = v;
    }
  };
  auto store = [&](unsigned char* plane, int c) {
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      uint32_t x[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t v = g == 0 ? row[j].x : g == 1 ? row[j].y
                   : g == 2 ? row[j].z : row[j].w;
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
        x[j] = v;
      }
      const uint32_t t0 = __byte_perm(x[0], x[1], 0x5140);
      const uint32_t t1 = __byte_perm(x[0], x[1], 0x7362);
      const uint32_t t2 = __byte_perm(x[2], x[3], 0x5140);
      const uint32_t t3 = __byte_perm(x[2], x[3], 0x7362);
      // colw[s]: k 4*k4 .. 4*k4+3 of column 16*n16 + 4*g + s
      const uint32_t colw[4] = {
          __byte_perm(t0, t2, 0x5410), __byte_perm(t0, t2, 0x7632),
          __byte_perm(t1, t3, 0x5410), __byte_perm(t1, t3, 0x7632)};
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int n = 16 * n16 + 4 * g + s;
        *reinterpret_cast<uint32_t*>(plane + sw128_at(n, 4 * k4)) = colw[s];
      }
    }
  };
  if constexpr (ENCODED) {
    // every channel's rows in flight at once, then their stores
    constexpr int NCH = (C + 1) / 2;
    uint4 rows[NCH][4];
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      if (c0 + 2 * i < C) {
        load(c0 + 2 * i);
#pragma unroll
        for (int j = 0; j < 4; ++j) rows[i][j] = row[j];
      }
    }
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      if (c0 + 2 * i < C) {
#pragma unroll
        for (int j = 0; j < 4; ++j) row[j] = rows[i][j];
        store(bstage + (c0 + 2 * i) * WG_B_BYTES, c0 + 2 * i);
      }
    }
  } else {
    // live: one read, then |w|_{m_c} per channel; channel indices stay
    // compile-time (the plan's tables at fixed offsets), and a warp's
    // parity c0 is uniform
    load(0);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if ((c & 1) == c0) store(bstage + c * WG_B_BYTES, c);
    }
  }
}

// The tile's elements from the exchanged sums, element e = t + THR*i (row
// e/32, column e%32: a warp a row, so stores coalesce), G at a time,
// through `tile_epilogue` (the limb count read at run time: fixing it at
// compile time ran a smollm layer in 246.5 us against 328.2 on an H100,
// but built the two files in 296 / 320 s, past the build's budget).
template <int C, int EMIT, int THR>
__device__ __forceinline__ void wg_epilogue(const int* xch, int t, int m0,
                                            int n0, const TileArgs& a,
                                            const FusedPlan& plan) {
  constexpr int G = C <= 3 ? 4 : 2;
#pragma unroll 1
  for (int i0 = 0; i0 < TM_WG * WG_TN / THR; i0 += G) {
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int e = t + THR * (i0 + u);
      const int r = e >> 5, col = e & 31;
      int v[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        v[c] = xch[(c * TM_WG + r) * WG_XROW + col];
      }
      tile_epilogue<C, true, EMIT>(v, m0 + r, n0 + col, a, plan,
                                   m0 + r < a.M && n0 + col < a.N);
    }
  }
}

// Blocks an SM: two up to C = 5 (128 registers a thread at launch), one
// above, where the C x 16 accumulators and the epilogue's temporaries
// outgrow 128 registers.
template <int C>
constexpr int WG_MIN_BLOCKS = C <= 5 ? 2 : 1;

template <int C, bool ENCODED, int EMIT>
__global__ void __launch_bounds__(WG_THREADS, WG_MIN_BLOCKS<C>)
rns_tile_wg_kernel(const __grid_constant__ CUtensorMap amap, TileArgs a,
                   FusedPlan plan) {
  using Smem = WgSmem<C>;
  constexpr int S = Smem::STAGES;
  extern __shared__ unsigned char wg_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(wg_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* astage = smem;                      // [S][64][128]
  unsigned char* bstage = smem + S * WG_A_BYTES;     // [S][C][32][128]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + Smem::RING);
  const unsigned full0 = smem_u32(bars), empty0 = smem_u32(bars + S);
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * WG_TN, m0 = blockIdx.y * TM_WG;
  const int nk = (a.K + WG_TK - 1) / WG_TK;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 128 + 1);   // producers + the TMA's expect
      mbar_init(empty0 + 8 * s, 4);        // the consumer warps
    }
    fence_mbarrier_init();
  }
  __syncthreads();

  if (tid < 128) {
    // producer warpgroup: A by TMA, the weights by hand
    for (int ks = 0; ks < nk; ++ks) {
      const int s = ks % S;
      if (ks >= S) mbar_wait(empty0 + 8 * s, ((ks / S) - 1) & 1);
      if (tid == 0) {
        mbar_expect(full0 + 8 * s, WG_A_BYTES);
        tma_load_2d(smem_u32(astage + s * WG_A_BYTES), &amap, ks * WG_TK,
                    m0, full0 + 8 * s);
      }
      wg_produce_w<C, ENCODED>(a, plan, bstage + s * C * WG_B_BYTES, n0,
                               ks * WG_TK, tid);
      fence_proxy_async();     // the stores, visible to wgmma's reads
      mbar_arrive(full0 + 8 * s);
    }
    // then half the epilogue, once the consumers' sums are in
    asm volatile("bar.sync 2, 256;\n" ::: "memory");
    wg_epilogue<C, EMIT, WG_THREADS>(reinterpret_cast<const int*>(smem),
                                     tid, m0, n0, a, plan);
  } else {
    // consumer warpgroup
    const int ct = tid - 128, lane = ct & 31, warp = ct >> 5;
    int acc[C][16];
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[c][i] = 0;
    for (int ks = 0; ks < nk; ++ks) {
      const int s = ks % S;
      mbar_wait(full0 + 8 * s, (ks / S) & 1);
      const uint64_t da = sw128_desc(smem_u32(astage + s * WG_A_BYTES));
      const uint64_t db =
          sw128_desc(smem_u32(bstage + s * C * WG_B_BYTES));
#pragma unroll
      for (int c = 0; c < C; ++c) reg_fence(acc[c]);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < WG_TK / 32; ++kk) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          wgmma_s8_n32(acc[c], da + 2 * kk,
                       db + (c * WG_B_BYTES >> 4) + 2 * kk);
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
      for (int c = 0; c < C; ++c) reg_fence(acc[c]);
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
    }
    // every consumer warp is past its last wgmma: the ring is free
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
    // the sums into shared memory, [c][row][WG_XROW]: accumulator i of a
    // thread is row 16*warp + lane/4 + 8*((i/2)%2), column 8*(i/4) +
    // 2*(lane%4) + i%2 (the wgmma D fragment)
    int* xch = reinterpret_cast<int*>(smem);
    const int r0 = 16 * warp + (lane >> 2), c0 = 2 * (lane & 3);
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int i = 0; i < 16; i += 2) {
        const int r = r0 + 8 * ((i >> 1) & 1), col = c0 + 8 * (i >> 2);
        *reinterpret_cast<int2*>(xch + (c * TM_WG + r) * WG_XROW + col) =
            make_int2(acc[c][i], acc[c][i + 1]);
      }
    // both warpgroups take half the elements
    asm volatile("bar.sync 2, 256;\n" ::: "memory");
    wg_epilogue<C, EMIT, WG_THREADS>(xch, tid, m0, n0, a, plan);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (once).
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// The TMA map of the (M, K) int8 A plane: 64-row x 128-byte boxes in the
// 128-byte swizzle, zero fill outside.  Returns a cudaError_t.
inline int wg_amap(const TileArgs& a, CUtensorMap* map) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(a.K),
                              static_cast<cuuint64_t>(a.M)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(a.K)};
  const cuuint32_t box[2] = {WG_TK, TM_WG};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(a.x), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int C, bool ENCODED, int EMIT>
int wg_launch_instance(const TileArgs& a, const FusedPlan& plan,
                       const CUtensorMap& map, cudaStream_t stream) {
  auto* kernel = rns_tile_wg_kernel<C, ENCODED, EMIT>;
  constexpr int smem = WgSmem<C>::BYTES;
  static const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid((a.N + WG_TN - 1) / WG_TN, (a.M + TM_WG - 1) / TM_WG);
  kernel<<<grid, WG_THREADS, smem, stream>>>(map, a, plan);
  return static_cast<int>(cudaGetLastError());
}

template <int C, bool ENCODED>
int wg_launch_emit(const TileArgs& a, const FusedPlan& plan,
                   const CUtensorMap& map, cudaStream_t stream) {
  switch (a.emit) {
    case EMIT_FLOAT:
      return wg_launch_instance<C, ENCODED, EMIT_FLOAT>(a, plan, map,
                                                        stream);
    case EMIT_RESIDUES:
      return wg_launch_instance<C, ENCODED, EMIT_RESIDUES>(a, plan, map,
                                                           stream);
    case EMIT_CANONICAL:
      return wg_launch_instance<C, ENCODED, EMIT_CANONICAL>(a, plan, map,
                                                            stream);
    case EMIT_CRT_LIMBS:
      return wg_launch_instance<C, ENCODED, EMIT_CRT_LIMBS>(a, plan, map,
                                                            stream);
    default:
      return -1;
  }
}

// Launch the 64-row tile for the plan's channel count; -1 for a count or
// emit not compiled, cudaErrorInvalidValue for operands TMA cannot read
// (K % 16, an unaligned plane; rns_fused.wg_ok routes those away) or rows
// the weight loads cannot take (N % 4, unaligned: ``vec``).
template <bool ENCODED>
int launch_tile_wg(const TileArgs& a, const FusedPlan& plan,
                   cudaStream_t stream) {
  if (a.splits != 1 || a.K % 16 != 0 ||
      reinterpret_cast<uintptr_t>(a.x) % 16 != 0 || !a.vec) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap map;
  const int e = wg_amap(a, &map);
  if (e != 0) return e;
  switch (plan.C) {
#define RNS_WG_CASE(CC) \
  case CC:              \
    return wg_launch_emit<CC, ENCODED>(a, plan, map, stream);
    RNS_WG_CASE(1) RNS_WG_CASE(2) RNS_WG_CASE(3) RNS_WG_CASE(4)
    RNS_WG_CASE(5) RNS_WG_CASE(6) RNS_WG_CASE(7)
#undef RNS_WG_CASE
    default:
      return -1;
  }
}

}  // namespace rns
