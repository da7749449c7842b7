// fxp_layer: the fused fixed-point layer act(qadd(requantize(A @ B), bias))
// in one launch.
//
// Replaces the Pallas kernel repro/kernels/fxp_layer.py::fxp_layer_pallas.
// That kernel walks a sequential K grid axis with an int32 accumulator held
// in VMEM.  Here the launch picks one of two routes by the layer's shape
// alone (K, N: never the data, so the choice is deterministic):
//
// * Narrow (N <= 32 and the K x N weights fit the narrow plan's shared
//   memory; fxp_layer_narrow.cuh): every layer the main paths launch, the
//   logistic and linear-SVM heads (561 x 6), the SVM per-layer route's
//   decision stage (300 x 6, 300 x 10) and an MLP's last layer (64 x 6).
//   Bound on the H100: the bytes of A (at 3089 rows of 561 fxp16 features,
//   3.47 MB: 1.04 us at 3.35 TB/s; the products take less at the int32
//   rate).  The first version ran these as 32 x 32 tiles that walked K in
//   serial steps behind block barriers with 26 of 32 columns zeros, a
//   latency chain 30x its bound (PERF.md, Findings).  The narrow kernel
//   streams the rows instead: persistent blocks stage W once, each warp
//   keeps three chunks of its rows in flight (16-byte cp.async into a ring
//   in shared memory) while its lanes split K over the fourth, and a
//   reduce-scatter butterfly of uint32 partials leaves each full sum on one
//   lane, which runs the epilogue.
// * Wide (N > 32, e.g. the per-layer MLP route's 561 x 64, or weights past
//   the narrow plan's shared memory): each block owns one BM x 64 output
//   tile (BM 32, 64 or 128, 64 by default) of the integer tile shared with
//   fxp_qmatmul (fxp_tile.cuh): every
//   container width on the int8 tensor cores through byte planes, a
//   three-stage cp.async ring of realigned rows, the dots handed to this
//   file's epilogue from a shared-memory scratch so that the stores
//   coalesce.  Bound: the int8 MMAs (four a product at 16 bits; at 3089
//   rows of 561 x 64 fxp16, 0.00045 ms) under the bytes of A (1.04 us).
//   The first version ran 32 x 32 tiles of int32 multiply-adds on the CUDA
//   cores, bound by their shared-memory loads.
//
// The block-size tuner (kernels/tune.py) times the wide route's tile
// heights and the narrow route's persistent grid (today's narrow_blocks,
// one or two blocks an SM, or every slot the card holds) and passes its
// choice in `block`; every choice computes the same bits.
//
// Both wrap their sums at 32 bits through uint32_t, as the TPU's int32
// accumulator does, run the shared epilogue (fxp_common.cuh) and store in
// the output container.  Ragged M, N and K edges are masked here, so the
// host pads nothing, and A may start at any element (a row slice).
#include <type_traits>

#include "fxp_layer_narrow.cuh"
#include "fxp_tile.cuh"

namespace {

template <typename T>
struct LayerEpilogue {
  T* out;
  const T* bias;
  int N;
  fxp::Epilogue e;
  __device__ __forceinline__ void operator()(int r, int c, uint32_t v) const {
    out[(size_t)r * N + c] = (T)fxp::layer_epilogue(v, (int32_t)bias[c], e);
  }
};

template <typename T, int BM>
__global__ void __launch_bounds__(fxp::kTileThreads,
                                  fxp::TileLayout<sizeof(T), BM>::kMinBlocks)
fxp_layer_kernel(const T* __restrict__ a, const T* __restrict__ b,
                 const T* __restrict__ bias, T* __restrict__ out, int M, int K,
                 int N, const fxp::Epilogue e) {
  int row0, col0;
  fxp::tile_origin<BM>(N, &row0, &col0);
  const LayerEpilogue<T> epi{out, bias, N, e};
  fxp::tile_mma<T, BM>(a, b, M, K, N, row0, col0, epi);
}

template <typename T, int BM>
int launch_wide_bm(const void* a, const void* b, const void* bias, void* out,
                   int M, int K, int N, const fxp::Epilogue& e,
                   cudaStream_t stream) {
  const long long blocks = fxp::tile_blocks(M, N, BM);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  auto kernel = fxp_layer_kernel<T, BM>;
  const cudaError_t err = fxp::tile_prepare<T, BM>(kernel);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, fxp::kTileThreads,
           fxp::TileLayout<sizeof(T), BM>::kSmem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const T*>(bias), static_cast<T*>(out), M, K, N, e);
  return (int)cudaGetLastError();
}

// bm: the tile's rows, 32, 64 or 128 (0: fxp::kTileBM); any other value is
// refused.
template <typename T>
int launch_wide(const void* a, const void* b, const void* bias, void* out,
                int M, int K, int N, const fxp::Epilogue& e, int bm,
                cudaStream_t stream) {
  switch (bm == 0 ? fxp::kTileBM : bm) {
    case 32:
      return launch_wide_bm<T, 32>(a, b, bias, out, M, K, N, e, stream);
    case 64:
      return launch_wide_bm<T, 64>(a, b, bias, out, M, K, N, e, stream);
    case 128:
      return launch_wide_bm<T, 128>(a, b, bias, out, M, K, N, e, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The current device's SM count, queried once per device.
cudaError_t device_sms(int* sms) {
  static std::mutex mu;
  static std::map<int, int> cache;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  const auto hit = cache.find(dev);
  if (hit != cache.end()) {
    *sms = hit->second;
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) cache[dev] = *sms;
  return err;
}

// The narrow instance's SMs and slots (blocks the card holds at once).
template <typename T, int NB>
cudaError_t narrow_occupancy(const fxp::NarrowPlan& plan, int* sms,
                             int* slots) {
  auto kernel = fxp::fxp_layer_narrow_kernel<T, NB>;
  const int smem = fxp::narrow_block_smem(plan, (int)sizeof(T));
  cudaError_t err = fxp::launch_slots(kernel, fxp::kNarrowThreads, smem, slots);
  if (err == cudaSuccess) err = device_sms(sms);
  return err;
}

// grid: the persistent blocks, 0 for narrow_blocks' rule; any count of
// blocks computes the same outputs (the row groups go to the blocks in
// turn).
template <typename T, int NB>
int launch_narrow(const void* a, const void* b, const void* bias, void* out,
                  int M, int K, int N, const fxp::NarrowPlan& plan,
                  const fxp::Epilogue& e, int grid, cudaStream_t stream) {
  auto kernel = fxp::fxp_layer_narrow_kernel<T, NB>;
  const int smem = fxp::narrow_block_smem(plan, (int)sizeof(T));
  int slots = 0, sms = 0;
  const cudaError_t err = narrow_occupancy<T, NB>(plan, &sms, &slots);
  if (err != cudaSuccess) return (int)err;
  if (grid == 0)
    grid = fxp::narrow_blocks((M + plan.rows - 1) / plan.rows, sms, slots);
  kernel<<<grid, fxp::kNarrowThreads, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const T*>(bias), static_cast<T*>(out), M, K, N, plan.k_pad,
      (plan.smem + 15) / 16 * 16, e);
  return (int)cudaGetLastError();
}

// fn(std::integral_constant<int, NB>()) for the narrow route's instance NB,
// or cudaErrorInvalidValue for an NB it does not have.
template <typename Fn>
int by_narrow_bucket(int nb, Fn fn) {
  switch (nb) {
#define FXP_NARROW_CASE(v) \
  case v:                  \
    return fn(std::integral_constant<int, v>());
    FXP_NARROW_CASE(1)
    FXP_NARROW_CASE(2)
    FXP_NARROW_CASE(4)
    FXP_NARROW_CASE(6)
    FXP_NARROW_CASE(8)
    FXP_NARROW_CASE(10)
    FXP_NARROW_CASE(16)
    FXP_NARROW_CASE(32)
#undef FXP_NARROW_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch(const void* a, const void* b, const void* bias, void* out, int M,
           int K, int N, const fxp::Epilogue& e, int block,
           cudaStream_t stream) {
  fxp::NarrowPlan plan;
  if (!fxp::narrow_plan(K, N, &plan))
    return launch_wide<T>(a, b, bias, out, M, K, N, e, block, stream);
  if (block < 0) return (int)cudaErrorInvalidValue;
  return by_narrow_bucket(plan.nb, [&](auto nb) {
    return launch_narrow<T, decltype(nb)::value>(a, b, bias, out, M, K, N,
                                                 plan, e, block, stream);
  });
}

template <typename T>
int occupancy(int K, int N, int* sms, int* slots) {
  fxp::NarrowPlan plan;
  if (!fxp::narrow_plan(K, N, &plan)) return (int)cudaErrorInvalidValue;
  return by_narrow_bucket(plan.nb, [&](auto nb) {
    return (int)narrow_occupancy<T, decltype(nb)::value>(plan, sms, slots);
  });
}

}  // namespace

// a: (M, K), b: (K, N), bias: (N,), out: (M, N), all contiguous in the
// `bits`-wide container; `epi` holds fxp::kEpilogueFields int64 values.
// `block` is the tuner's choice: the wide route's tile rows (32, 64 or 128)
// or the narrow route's persistent grid (>= 1); 0 is today's rule for
// either.  Returns the CUDA error code of the launch (0 on success).
extern "C" int fxp_layer_launch(const void* a, const void* b, const void* bias,
                                void* out, int M, int K, int N, int bits,
                                const long long* epi, int block,
                                void* stream) {
  if (M <= 0 || K <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const fxp::Epilogue e = fxp::epilogue_from(epi);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 8: return launch<int8_t>(a, b, bias, out, M, K, N, e, block, s);
    case 16: return launch<int16_t>(a, b, bias, out, M, K, N, e, block, s);
    case 32: return launch<int32_t>(a, b, bias, out, M, K, N, e, block, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The narrow route's occupancy on the current device for a K x N layer in
// the `bits`-wide container: the SM count and the blocks of its instance
// the card holds at once (the tuner's grid candidates).  Returns the CUDA
// error code (cudaErrorInvalidValue for a layer of the wide route).
extern "C" int fxp_layer_narrow_occupancy(int K, int N, int bits, int* sms,
                                          int* slots) {
  switch (bits) {
    case 8: return occupancy<int8_t>(K, N, sms, slots);
    case 16: return occupancy<int16_t>(K, N, sms, slots);
    case 32: return occupancy<int32_t>(K, N, sms, slots);
    default: return (int)cudaErrorInvalidValue;
  }
}
