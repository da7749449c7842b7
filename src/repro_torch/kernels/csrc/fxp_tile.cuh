// The integer tile shared by fxp_qmatmul and fxp_layer's wide route (N > 32,
// or a K x N whose weights do not fit the narrow kernel's shared memory;
// fxp_layer.cu): C = A @ B with an int32 accumulator that wraps at 32 bits,
// as the Pallas kernels' int32 dot does, handed output by output to the
// caller's epilogue.  A is (M, K) row-major and may start at any element (a
// row slice); B is (K, N) row-major (k-major for each output column).
//
// On the int8 tensor cores (mma.sync.m16n8k32, s32 accumulators, no
// .satfinite), for every container width.  A value of P bytes splits
// exactly into P byte planes, x = sum_i 2^(8i) x_i, the top plane signed
// (s8) and the others unsigned (u8), so
//     x . w = sum_{i,j} 2^(8(i+j)) x_i . w_j   (mod 2^32),
// and only the pairs with i + j <= 3 survive mod 2^32: one MMA at 8 bits,
// four at 16 bits (hh, hl, lh, ll), ten at 32 bits.  The partials of one
// shift i + j share an s32 accumulator and are recombined in uint32 as
// sum_s acc_s << 8s; multiplication mod 2^32 is a ring homomorphism, so a
// partial that wraps still gives the Pallas kernel's dot bit for bit.
// Zero padding of K (to the stage) and of N (to the tile) is exact.
//
// * Block tile BM x kTileBN, BM 32, 64 (kTileBM, the default) or 128, a
//   template parameter that the block-size tuner chooses between
//   (kernels/tune.py): 8 warps, 2 (m) x 4 (n), each a BM / 2 x 16 warp tile
//   (BM / 32 m16 tiles by one even and one odd n8 tile).  Every height
//   computes the same bits: each output's dot is the same sum mod 2^32.
// * K walks in stages of kTileRowBytes (128) bytes of each A row: 128 k at
//   8 bits, 64 at 16, 32 at 32.  A stage's rows are copied by 16-byte
//   cp.async from the 16-byte boundary at or below each row's start (K =
//   561 and N = 300 leave rows at any alignment) into a ring of three raw
//   buffers: two stages are in flight while the third is unpacked.  The
//   unpack realigns each row through funnel shifts and writes the P byte
//   planes of A and of B into one of two tile buffers, while the warps run
//   the MMAs of the other: one __syncthreads a stage.
// * Fragments: A by ldmatrix from each plane (k in natural order).  B stays
//   k-major in its planes, its rows stored so that (tile_b_row) the eight
//   rows of one ldmatrix.trans phase hold k {0,1,4,5,8,9,12,13} (+2, +16,
//   +18) and lie consecutive, in eight bank groups: each thread gets, in
//   two registers, the byte pairs of columns 2g and 2g+1 at k 4t..4t+3, and
//   two PRMTs split them into the B fragments of an even and an odd n8
//   tile.  One x4 load feeds 16 columns at k32, with no permutation of k
//   and no byte transpose.
// * Rows past M and k past K are zero-filled by the copy (k >= K in B, so
//   what A holds there multiplies zeros); columns past N are computed from
//   whatever the copy read and are not stored.
//
// Bound on the H100 (PERF.md): a 16-bit product is four int8 MMAs, so the
// SVM per-layer route's (3089, 561) x (561, 300) at fxp16 is 4.16 Gop of
// int8 MMA at 1,979 Top/s = 0.0021 ms, above its 5.66 MB of operands and
// output at 3.35 TB/s = 0.0017 ms; at 8 bits the bytes bound it; at 32 bits
// ten MMAs a product, 0.0053 ms.  wgmma was not taken: it wants its operands
// in shared memory in its own swizzled layouts, and here every stage is
// realigned through registers anyway.  On the card (PERF.md, Findings) the
// copy, the unpack and the MMAs each hold about a quarter of the time at
// 65536 rows.  Slower there, and not kept: a 128 x 64 tile of 16 warps, a
// persistent grid walking its tiles as one stream of stages, a lane map
// that realigns from whole 16-byte loads, and, at 32 bits, a 4 x 4
// register-blocked tile of int32 multiply-adds on the CUDA cores.
#pragma once

#include "fxp_common.cuh"
#include "fxp_mma.cuh"

namespace fxp {

// the block's output tile: kTileBM rows unless the tuner picks another
// height of TileLayout (32, 64 or 128)
constexpr int kTileBM = 64, kTileBN = 64;
constexpr int kTileThreads = 256;          // 8 warps: 2 (m) x 4 (n)
constexpr int kTileRowBytes = 128;         // bytes of an A row per stage
constexpr int kTileStages = 3;             // the raw cp.async ring
constexpr int kTileScrStride = kTileBN + 1;  // the epilogue's uint32 scratch

// Row strides in shared memory are odd multiples of 16 bytes, so that the
// eight rows of an ldmatrix phase fall in eight distinct bank groups.
FXP_HOST_DEVICE constexpr int tile_odd16(int bytes) {
  return ((bytes + 15) / 16) % 2 ? (bytes + 15) / 16 * 16
                                 : (bytes + 15) / 16 * 16 + 16;
}

// Where one block keeps what, for a container of P bytes and a tile of BM
// rows (byte offsets).
template <int P, int BM = kTileBM>
struct TileLayout {
  static_assert(BM == 32 || BM == 64 || BM == 128, "tile heights 32, 64, 128");
  static constexpr int kMT = BM / 32;                  // m16 tiles a warp
  // A rows a thread copies and unpacks a stage: 4 threads a row, 64 rows a
  // pass of the block (at BM 32 the threads of rows 32..63 copy no A)
  static constexpr int kARows = BM > 64 ? BM / 64 : 1;
  static constexpr int kBK = kTileRowBytes / P;        // k per stage
  static constexpr int kARaw = kTileRowBytes + 16;     // a raw A row
  static constexpr int kBRaw = kTileBN * P + 16;       // a raw B row
  static constexpr int kRawBytes = BM * kARaw + kBK * kBRaw;
  static constexpr int kAS = tile_odd16(kBK);          // an A plane row
  static constexpr int kBS = tile_odd16(kTileBN);      // a B plane row
  static constexpr int kAPlane = BM * kAS;
  static constexpr int kBPlane = kBK * kBS;
  static constexpr int kBufBytes = P * (kAPlane + kBPlane);
  static constexpr int kRawOff = 2 * kBufBytes;        // after two buffers
  static constexpr int kSmem = kRawOff + kTileStages * kRawBytes;
  // the shifts 8 (i + j) of the plane pairs that survive mod 2^32: 1 at 8
  // bits, 3 at 16, 4 at 32 (one s32 accumulator each)
  static constexpr int kShifts = 2 * P - 1 < 4 ? 2 * P - 1 : 4;
  // blocks an SM must hold (__launch_bounds__): two, but one at BM 128,
  // whose accumulators (up to 4 x 4 x 2 x 4 registers at 32 bits) and
  // shared memory (140-148 KB) leave room for one
  static constexpr int kMinBlocks = BM > 64 ? 1 : 2;
  static_assert(kBK % 32 == 0, "whole k32 steps per stage");
  static_assert(kRawBytes % 16 == 0 && kBufBytes % 16 == 0, "alignment");
  static_assert(BM * kTileScrStride * 4 <= 2 * kBufBytes,
                "the epilogue's scratch fits the two tile buffers");
};

// The blocks of a launch: one a bm x kTileBN output tile.
FXP_HOST_DEVICE long long tile_blocks(int M, int N, int bm = kTileBM) {
  return (long long)((M + bm - 1) / bm) * ((N + kTileBN - 1) / kTileBN);
}

#if defined(__CUDACC__)

// What one thread copies and unpacks at every stage: rows r, r + 64, ...
// of A below the tile's height (threads 4r .. 4r+3 share row r) and one row
// of B (2P threads a row).  A row's 16-byte floor moves by whole granules
// from stage to stage (kTileRowBytes bytes of A; kBK rows of N P bytes, 128
// N, of B), so each row's misalignment within its first granule stays put
// and is computed once; rows 64 apart start 64 K P bytes apart, a multiple
// of 16, so they share it.
template <int P>
struct TileCursor {
  static constexpr int kBT = kTileThreads / TileLayout<P>::kBK;  // a B row
  const unsigned char* a_src;  // the A row's first granule at stage 0
  const unsigned char* b_src;  // the B row's
  const unsigned char* a_end;  // one past each operand
  const unsigned char* b_end;
  const unsigned char* a_floor;  // a valid address for empty copies
  const unsigned char* b_floor;
  size_t b_step;  // bytes the B rows move a stage
  size_t a_pass;  // bytes between A rows 64 apart
  int a_row, a_lane, a_mis;
  int b_row, b_lane, b_mis;
  int K;

  __device__ __forceinline__ TileCursor(const unsigned char* a,
                                        const unsigned char* b, int M, int K_,
                                        int N, int row0, int col0) {
    K = K_;
    a_row = threadIdx.x >> 2;
    a_lane = threadIdx.x & 3;
    b_row = threadIdx.x / kBT;
    b_lane = threadIdx.x % kBT;
    const uintptr_t as = reinterpret_cast<uintptr_t>(
        a + (size_t)(row0 + a_row) * K * P);
    const uintptr_t bs = reinterpret_cast<uintptr_t>(
        b + ((size_t)b_row * N + col0) * P);
    a_mis = (int)(as & 15);
    b_mis = (int)(bs & 15);
    a_src = reinterpret_cast<const unsigned char*>(as & ~(uintptr_t)15);
    b_src = reinterpret_cast<const unsigned char*>(bs & ~(uintptr_t)15);
    a_end = a + (size_t)M * K * P;
    b_end = b + (size_t)K * N * P;
    a_floor = reinterpret_cast<const unsigned char*>(
        reinterpret_cast<uintptr_t>(a) & ~(uintptr_t)15);
    b_floor = reinterpret_cast<const unsigned char*>(
        reinterpret_cast<uintptr_t>(b) & ~(uintptr_t)15);
    b_step = (size_t)TileLayout<P>::kBK * N * P;
    a_pass = (size_t)64 * K * P;
  }
};

// Bytes of the 16-byte granule at src that lie before end (0..16).
__device__ __forceinline__ int tile_bytes(const unsigned char* src,
                                          const unsigned char* end) {
  const long long left = end - src;
  return left <= 0 ? 0 : (left < 16 ? (int)left : 16);
}

// Starts the copy of stage s (k from s * kBK) into the raw buffer `raw`: A
// rows row0 .. row0 + BM - 1, kTileRowBytes + 16 bytes each, and B rows k,
// kTileBN * P + 16 bytes from column col0 each, as whole 16-byte granules
// from the boundary at or below each row's start, the bytes past each
// operand's end (and B's rows k >= K) zero-filled and not read.
template <int P, int BM>
__device__ __forceinline__ void tile_issue(unsigned char* raw,
                                           const TileCursor<P>& c, int s) {
  using L = TileLayout<P, BM>;
  constexpr int kAG = kTileRowBytes / 16 + 1, kBG = kTileBN * P / 16 + 1;
#pragma unroll
  for (int rr = 0; rr < L::kARows; ++rr) {
    const int row = c.a_row + 64 * rr;
    if (row >= BM) break;
    const unsigned char* a =
        c.a_src + rr * c.a_pass + (size_t)s * kTileRowBytes;
    unsigned char* ar = raw + row * L::kARaw;
#pragma unroll
    for (int g = c.a_lane; g < kAG; g += 4) {
      const int n = tile_bytes(a + 16 * g, c.a_end);
      cp_async16(smem_u32(ar + 16 * g), n ? a + 16 * g : c.a_floor, n);
    }
  }
  const bool in_k = s * L::kBK + c.b_row < c.K;
  const unsigned char* b = c.b_src + s * c.b_step;
  unsigned char* br = raw + BM * L::kARaw + c.b_row * L::kBRaw;
#pragma unroll
  for (int g = c.b_lane; g < kBG; g += TileCursor<P>::kBT) {
    const int n = in_k ? tile_bytes(b + 16 * g, c.b_end) : 0;
    cp_async16(smem_u32(br + 16 * g), n ? b + 16 * g : c.b_floor, n);
  }
}

// 16 bytes of a raw row from its byte `off` on (the row is 16-byte aligned
// in shared memory and holds at least off + 20 bytes), through funnel
// shifts.
__device__ __forceinline__ uint4 tile_realign(const unsigned char* row,
                                              int off) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(row) + (off >> 2);
  const int sh = (off & 3) * 8;
  const uint32_t w0 = w[0], w1 = w[1], w2 = w[2], w3 = w[3], w4 = w[4];
  return make_uint4(__funnelshift_r(w0, w1, sh), __funnelshift_r(w1, w2, sh),
                    __funnelshift_r(w2, w3, sh), __funnelshift_r(w3, w4, sh));
}

// 16 realigned bytes (16 / P values) into the P byte planes at `dst` (plane
// p at dst + p * plane): 16 / P bytes a plane, plane 0 the low bytes.
template <int P>
__device__ __forceinline__ void tile_split(unsigned char* dst, int plane,
                                           uint4 v) {
  if constexpr (P == 1) {
    *reinterpret_cast<uint4*>(dst) = v;
  } else if constexpr (P == 2) {
    *reinterpret_cast<uint2*>(dst) =
        make_uint2(lo_bytes(make_uint2(v.x, v.y)), lo_bytes(make_uint2(v.z, v.w)));
    *reinterpret_cast<uint2*>(dst + plane) =
        make_uint2(hi_bytes(make_uint2(v.x, v.y)), hi_bytes(make_uint2(v.z, v.w)));
  } else {
    // a 4 x 4 byte transpose: plane j gets byte j of each of the 4 values
    const uint32_t lo01 = __byte_perm(v.x, v.y, 0x5140);  // x0 y0 x1 y1
    const uint32_t lo23 = __byte_perm(v.z, v.w, 0x5140);  // z0 w0 z1 w1
    const uint32_t hi01 = __byte_perm(v.x, v.y, 0x7362);  // x2 y2 x3 y3
    const uint32_t hi23 = __byte_perm(v.z, v.w, 0x7362);  // z2 w2 z3 w3
    *reinterpret_cast<uint32_t*>(dst) = __byte_perm(lo01, lo23, 0x5410);
    *reinterpret_cast<uint32_t*>(dst + plane) = __byte_perm(lo01, lo23, 0x7632);
    *reinterpret_cast<uint32_t*>(dst + 2 * plane) =
        __byte_perm(hi01, hi23, 0x5410);
    *reinterpret_cast<uint32_t*>(dst + 3 * plane) =
        __byte_perm(hi01, hi23, 0x7632);
  }
}

// Where a B plane keeps row k: within each group of 16, k 0 1 4 5 8 9 12
// 13 in rows 0-7 and k 2 3 6 7 10 11 14 15 in rows 8-15, so that the eight
// rows one ldmatrix.trans phase reads (below) are consecutive and fall in
// eight distinct bank groups.
__device__ __forceinline__ int tile_b_row(int k) {
  return (k & ~15) | (((k >> 1) & 1) << 3) | (((k >> 2) & 3) << 1) | (k & 1);
}

// The raw stage into the byte planes of one tile buffer: this thread's A
// rows and B row, from their misalignments on.
template <int P, int BM>
__device__ __forceinline__ void tile_unpack(unsigned char* buf,
                                            const unsigned char* raw,
                                            const TileCursor<P>& c) {
  using L = TileLayout<P, BM>;
  constexpr int kAC = kTileRowBytes / 16, kBC = kTileBN * P / 16;
#pragma unroll
  for (int rr = 0; rr < L::kARows; ++rr) {
    const int row = c.a_row + 64 * rr;
    if (row >= BM) break;
    const unsigned char* ar = raw + row * L::kARaw;
#pragma unroll
    for (int i = c.a_lane; i < kAC; i += 4)
      tile_split<P>(buf + row * L::kAS + i * (16 / P), L::kAPlane,
                    tile_realign(ar, c.a_mis + 16 * i));
  }
  const unsigned char* br = raw + BM * L::kARaw + c.b_row * L::kBRaw;
  unsigned char* bb = buf + P * L::kAPlane + tile_b_row(c.b_row) * L::kBS;
#pragma unroll
  for (int i = c.b_lane; i < kBC; i += TileCursor<P>::kBT)
    tile_split<P>(bb + i * (16 / P), L::kBPlane,
                  tile_realign(br, c.b_mis + 16 * i));
}

// The MMA of two planes: the top plane of each operand is signed.  Called
// from fully unrolled loops, where the branches fold away.
__device__ __forceinline__ void tile_mma_planes(uint32_t (&c)[4],
                                                const uint32_t (&a)[4],
                                                const uint32_t (&b)[2],
                                                bool signed_a, bool signed_b) {
  if (signed_a && signed_b) {
    mma_s8s8(c, a, b);
  } else if (signed_a) {
    mma_s8u8(c, a, b);
  } else if (signed_b) {
    mma_u8s8(c, a, b);
  } else {
    mma_u8u8(c, a, b);
  }
}

// A warp's accumulators: [shift][m16 tile][n8 tile][fragment register].
template <int P, int BM>
using TileAcc =
    uint32_t[TileLayout<P, BM>::kShifts][TileLayout<P, BM>::kMT][2][4];

// One k32 step of a warp's BM / 2 x 16 tile: acc[i + j][mt][nt] += A_i .
// B_j for each m16 tile mt and n8 tile nt (even, odd columns).
template <int P, int BM>
__device__ __forceinline__ void tile_k32(TileAcc<P, BM>& acc,
                                         const unsigned char* buf, int wm,
                                         int wn, int ks, int lane) {
  using L = TileLayout<P, BM>;
  const unsigned char* abuf = buf;
  const unsigned char* bbuf = buf + P * L::kAPlane;
  // B: lanes 8q .. 8q+7 address the rows of matrix q, which hold (see
  // tile_b_row) k = 16 (q >> 1) + 2 (q & 1) + 4 (r >> 1) + (r & 1) for
  // r = lane & 7, so that thread (g, t) gets k 4t, 4t+1 (q even) and
  // 4t+2, 4t+3 (q odd) of columns 2g and 2g+1
  const int q = lane >> 3;
  uint32_t be[P][2], bo[P][2];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    uint32_t t[4];
    ldsm_x4_trans(bbuf + j * L::kBPlane + (ks * 32 + lane) * L::kBS + wn * 16,
                  t);
    be[j][0] = __byte_perm(t[0], t[1], 0x6420);
    bo[j][0] = __byte_perm(t[0], t[1], 0x7531);
    be[j][1] = __byte_perm(t[2], t[3], 0x6420);
    bo[j][1] = __byte_perm(t[2], t[3], 0x7531);
  }
  // A: lanes 8q .. 8q+7 address rows (lane & 7) + 8 (q & 1) at byte 16 (q >> 1)
  const int arow = wm * (BM / 2) + (lane & 7) + 8 * (q & 1);
#pragma unroll
  for (int i = 0; i < P; ++i) {
    uint32_t fa[L::kMT][4];
#pragma unroll
    for (int mt = 0; mt < L::kMT; ++mt)
      ldsm_x4(abuf + i * L::kAPlane + (arow + 16 * mt) * L::kAS + ks * 32 +
                  16 * (q >> 1),
              fa[mt]);
#pragma unroll
    for (int j = 0; j < P; ++j) {
      if (i + j > 3) continue;
#pragma unroll
      for (int mt = 0; mt < L::kMT; ++mt) {
        tile_mma_planes(acc[i + j][mt][0], fa[mt], be[j], i == P - 1,
                        j == P - 1);
        tile_mma_planes(acc[i + j][mt][1], fa[mt], bo[j], i == P - 1,
                        j == P - 1);
      }
    }
  }
}

// C = A @ B for the BM x kTileBN output tile (row0, col0) of this block,
// then epi(row, col, dot) for every output in range, dot the int32 dot as
// uint32.  T is the container (int8_t, int16_t, int32_t); dynamic shared
// memory of TileLayout<sizeof(T), BM>::kSmem bytes.  Every thread of the
// block must call it (it synchronizes).
template <typename T, int BM, typename Epi>
__device__ __forceinline__ void tile_mma(const T* __restrict__ a,
                                         const T* __restrict__ b, int M,
                                         int K, int N, int row0, int col0,
                                         const Epi& epi) {
  constexpr int P = (int)sizeof(T);
  using L = TileLayout<P, BM>;
  extern __shared__ __align__(16) unsigned char tile_smem[];
  const unsigned char* ab = reinterpret_cast<const unsigned char*>(a);
  const unsigned char* bb = reinterpret_cast<const unsigned char*>(b);
  unsigned char* raw = tile_smem + L::kRawOff;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int stages = (K + L::kBK - 1) / L::kBK;

  const TileCursor<P> cur(ab, bb, M, K, N, row0, col0);
  TileAcc<P, BM> acc = {};
#pragma unroll
  for (int s = 0; s < kTileStages; ++s) {
    if (s < stages) tile_issue<P, BM>(raw + s * L::kRawBytes, cur, s);
    cp_async_commit();
  }
  cp_async_wait<kTileStages - 1>();
  __syncthreads();  // stage 0 has landed
  tile_unpack<P, BM>(tile_smem, raw, cur);
  for (int s = 0; s < stages; ++s) {
    cp_async_wait<kTileStages - 2>();
    // stage s is unpacked and stage s + 1 has landed; stage s - 1's MMAs
    // and unpack are done, so its tile buffer and raw buffer are free
    __syncthreads();
    if (s + 1 < stages)
      tile_unpack<P, BM>(tile_smem + ((s + 1) & 1) * L::kBufBytes,
                     raw + ((s + 1) % kTileStages) * L::kRawBytes, cur);
    if (s + kTileStages < stages)
      tile_issue<P, BM>(raw + (s % kTileStages) * L::kRawBytes, cur,
                    s + kTileStages);
    cp_async_commit();
    // k32 steps that hold some k < K (warp-uniform)
    const int left = K - s * L::kBK;
    const int ksteps = left >= L::kBK ? L::kBK / 32 : (left + 31) / 32;
    const unsigned char* buf = tile_smem + (s & 1) * L::kBufBytes;
    for (int ks = 0; ks < ksteps; ++ks)
      tile_k32<P, BM>(acc, buf, wm, wn, ks, lane);
  }

  // The dots meet in a BM x kTileBN scratch over the tile buffers, so that
  // the epilogue walks the outputs row-major and its stores coalesce.
  // C fragment of n8 tile nt: rows lane/4 and +8, MMA columns 2 (lane % 4)
  // and +1, which are the tile's columns 2 (2 (lane % 4) + (i & 1)) + nt.
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the tile buffers
  uint32_t* scr = reinterpret_cast<uint32_t*>(tile_smem);
#pragma unroll
  for (int mt = 0; mt < L::kMT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t v = 0u;
#pragma unroll
        for (int sh = 0; sh < L::kShifts; ++sh)
          v += acc[sh][mt][nt][i] << (8 * sh);
        const int r = wm * (BM / 2) + mt * 16 + (lane >> 2) + 8 * (i >> 1);
        const int c = wn * 16 + 4 * (lane & 3) + 2 * (i & 1) + nt;
        scr[r * kTileScrStride + c] = v;
      }
    }
  }
  __syncthreads();
  const int rows = min(BM, M - row0), cols = min(kTileBN, N - col0);
  for (int i = threadIdx.x; i < BM * kTileBN; i += kTileThreads) {
    const int r = i / kTileBN, c = i - r * kTileBN;
    if (r < rows && c < cols) epi(row0 + r, col0 + c, scr[r * kTileScrStride + c]);
  }
}

// The (row, column) tile of this block: column tiles run fastest, so the
// blocks that share a panel of A run together and A is read from device
// memory once even where it exceeds the L2 cache.
template <int BM>
__device__ __forceinline__ void tile_origin(int N, int* row0, int* col0) {
  const int n_tiles = (N + kTileBN - 1) / kTileBN;
  const int block = (int)blockIdx.x;
  *row0 = block / n_tiles * BM;
  *col0 = block % n_tiles * kTileBN;
}

// The shared memory of a kernel instance: raised once per device and
// instance above the 48 KB default (launch_slots caches the query).
template <typename T, int BM, typename Kernel>
cudaError_t tile_prepare(Kernel kernel) {
  int slots = 0;
  return launch_slots(kernel, kTileThreads, TileLayout<sizeof(T), BM>::kSmem,
                      &slots);
}

#endif  // __CUDACC__

}  // namespace fxp
