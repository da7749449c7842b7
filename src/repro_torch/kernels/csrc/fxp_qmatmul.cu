// fxp_qmatmul: the fixed-point matmul rshift_round_saturate(A @ B, m) in one
// launch, the first stage of the kernel SVM's per-layer route.
//
// Replaces the Pallas kernel
// repro/kernels/fxp_qmatmul.py::fxp_qmatmul_pallas (body _kernel), whose
// grid walks K sequentially into an int32 VMEM accumulator.  Here each block
// owns one BM x 64 output tile (BM 32, 64 or 128, the block-size tuner's
// choice, kernels/tune.py; 64 by default) and runs the integer tile shared with
// fxp_layer's wide route (fxp_tile.cuh): every container width on the int8
// tensor cores through byte planes (one MMA a product at 8 bits, four at
// 16, ten at 32), a three-stage cp.async ring of realigned rows, and a
// uint32 dot that wraps at 32 bits like the TPU's int32 accumulator.  The
// epilogue is one rounded shift by m and saturation into the container,
// stored row-major from a shared-memory scratch so that the stores
// coalesce.  Ragged M, N and K edges are masked here.
//
// Bound on the H100 at the SVM's shape, (M, 561) x (561, 300): the int8
// MMAs, 4 x 2 M 561 300 operations at 16 bits (0.0021 ms at M = 3089 and
// 1,979 Top/s), above the container bytes moved (M (561 + 300) + 561 x 300
// elements, 0.0017 ms); at 8 bits the bytes (0.00084 ms); at 32 bits the ten
// MMAs a product (0.0053 ms).  The first version ran this as 32 x 32 tiles
// of int32 multiply-adds on the CUDA cores, bound by its shared-memory loads
// at 3.5x the CUDA cores' multiply-add bound (PERF.md, Findings).  At small
// K (D5, K = 8) one stage of zero-padded k is exact and the output bytes
// bound the launch.
#include "fxp_tile.cuh"

namespace {

template <typename T>
struct QmatmulEpilogue {
  T* out;
  int N, shift;
  int32_t qmin, qmax;
  __device__ __forceinline__ void operator()(int r, int c, uint32_t v) const {
    out[(size_t)r * N + c] =
        (T)fxp::requant((int64_t)fxp::u2s32(v), shift, qmin, qmax);
  }
};

template <typename T, int BM>
__global__ void __launch_bounds__(fxp::kTileThreads,
                                  fxp::TileLayout<sizeof(T), BM>::kMinBlocks)
fxp_qmatmul_kernel(const T* __restrict__ a, const T* __restrict__ b,
                   T* __restrict__ out, int M, int K, int N, int shift,
                   int32_t qmin, int32_t qmax) {
  int row0, col0;
  fxp::tile_origin<BM>(N, &row0, &col0);
  const QmatmulEpilogue<T> e{out, N, shift, qmin, qmax};
  fxp::tile_mma<T, BM>(a, b, M, K, N, row0, col0, e);
}

template <typename T, int BM>
int launch_bm(const void* a, const void* b, void* out, int M, int K, int N,
              int shift, int32_t qmin, int32_t qmax, cudaStream_t stream) {
  const long long blocks = fxp::tile_blocks(M, N, BM);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  auto kernel = fxp_qmatmul_kernel<T, BM>;
  const cudaError_t err = fxp::tile_prepare<T, BM>(kernel);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, fxp::kTileThreads,
           fxp::TileLayout<sizeof(T), BM>::kSmem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(out),
      M, K, N, shift, qmin, qmax);
  return (int)cudaGetLastError();
}

// bm: the tile's rows, 32, 64 or 128 (0: fxp::kTileBM); any other value is
// refused, never replaced by another instance.
template <typename T>
int launch(const void* a, const void* b, void* out, int M, int K, int N,
           int shift, int32_t qmin, int32_t qmax, int bm,
           cudaStream_t stream) {
  switch (bm == 0 ? fxp::kTileBM : bm) {
    case 32:
      return launch_bm<T, 32>(a, b, out, M, K, N, shift, qmin, qmax, stream);
    case 64:
      return launch_bm<T, 64>(a, b, out, M, K, N, shift, qmin, qmax, stream);
    case 128:
      return launch_bm<T, 128>(a, b, out, M, K, N, shift, qmin, qmax, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// a: (M, K), b: (K, N), out: (M, N), all contiguous in the `bits`-wide
// container (a may start at any element); out = saturate(round_shift(a @ b,
// shift)) into [-2^(bits-1), 2^(bits-1) - 1], on tiles of bm rows (0: the
// default).  Returns the CUDA error code of the launch.
extern "C" int fxp_qmatmul_launch(const void* a, const void* b, void* out,
                                  int M, int K, int N, int bits, int shift,
                                  int bm, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || shift < 0 || shift > 31)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 8:
      return launch<int8_t>(a, b, out, M, K, N, shift, -128, 127, bm, s);
    case 16:
      return launch<int16_t>(a, b, out, M, K, N, shift, -32768, 32767, bm, s);
    case 32:
      return launch<int32_t>(a, b, out, M, K, N, shift, INT32_MIN, INT32_MAX,
                             bm, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
