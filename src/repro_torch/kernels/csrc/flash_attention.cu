// flash_attention: causal or full softmax attention over (BH, S, dh) tensors,
// float32 or bfloat16, with the online (max, sum, acc) softmax in float32.
//
// Replaces the Pallas kernel
// repro/kernels/flash_attention.py::flash_attention_pallas (body _kernel),
// whose grid walks (BH, S/bq, S/bk) in order and carries the running max,
// sum and accumulator of one query block in VMEM scratch across the KV axis.
// Here one block owns one (bh, 64-query tile) and walks the key tiles itself,
// so the carry lives in registers.  What it computes is _kernel's function:
//   scores q.k^T in float32, then * float32(1/sqrt(dh)) (the caller's scale);
//   masked entries set to -1e30, not -inf;
//   online m, l, acc in float32: m' = max(m, rowmax(s)), alpha = exp(m - m'),
//   p = exp(s - m'), l = l*alpha + rowsum(p), acc = acc*alpha + p.v;
//   key tiles strictly above the diagonal skipped when causal;
//   output acc / max(l, 1e-30), cast to the input type.
// Unlike the TPU kernel it takes any S: key rows past S are zero-filled and
// masked (their p is exactly 0), query rows past S are computed and not
// written.  Every tile a row visits holds at least one unmasked key (tiles
// are 64 wide on both axes and aligned), so its max is finite and a masked
// entry's exp(-1e30 - m) is 0, as in the TPU kernel.
//
// Bound on the H100: operations.  4*S^2*dh/2 flops per causal head against
// 4*S*dh input and output elements: at S=2048 the work is ~1000x the bytes.
// This first version does its products on the CUDA cores in float32 (a
// 67 Tflop/s ceiling, against 989 for bf16 tensor cores): K/V tiles are
// staged in shared memory converted to float32, each thread keeps a 4x4
// (rows x keys) micro-tile of scores and a 4 x dh/16 slice of the
// accumulator in registers, and the 16 threads of a row group reduce max
// and sum with warp shuffles.  The heaviest (last) query tiles of a causal
// launch are scheduled first.  Tensor cores (mma.sync / wgmma on bf16 tiles)
// are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 row groups of 4 rows x 16 key lanes
constexpr int kRows = 4;       // query rows per thread
constexpr int kLanes = 16;     // threads sharing one row group
constexpr int kKeys = kBK / kLanes;  // keys per thread per tile
constexpr int kPStride = 68;   // P row stride: rows 4 apart land 16 banks apart
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch casts
}

template <int DH>
constexpr size_t smem_bytes() {
  // Q and K rows padded by one float (conflict-free column reads), V as is,
  // then the tile's probabilities.
  return sizeof(float) *
         (size_t)(kBQ * (DH + 1) + kBK * (DH + 1) + kBK * DH + kBQ * kPStride);
}

// rows [row0, row0 + n) of a (S, DH) slab into a float tile of row stride
// `stride`; rows at or past `s` become zeros.
template <typename T, int DH>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, int row0,
                                          int s, float* tile, int stride,
                                          int n) {
  for (int idx = threadIdx.x; idx < n * DH; idx += kThreads) {
    const int r = idx / DH, c = idx - r * DH;
    const int row = row0 + r;
    tile[r * stride + c] =
        row < s ? to_f32(src[(long long)row * DH + c]) : 0.0f;
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int s,
                       float scale, int causal) {
  constexpr int kQS = DH + 1, kKS = DH + 1, kDims = DH / kLanes;
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kBQ * kQS;
  float* vs = ks + kBK * kKS;
  float* ps = vs + kBK * DH;

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int q0 = qt * kBQ;
  const long long base = (long long)bh * s * DH;
  const int lane = threadIdx.x % kLanes;  // key lane / output-dim lane
  const int r0 = (threadIdx.x / kLanes) * kRows;  // first of my 4 rows

  load_tile<T, DH>(q + base, q0, s, qs, kQS, kBQ);

  float m[kRows], l[kRows], acc[kRows][kDims];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int e = 0; e < kDims; ++e) acc[i][e] = 0.0f;
  }

  const int k_tiles = (s + kBK - 1) / kBK;
  const int n_tiles = causal ? min(k_tiles, qt + 1) : k_tiles;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's K, V and P are consumed
    load_tile<T, DH>(k + base, k0, s, ks, kKS, kBK);
    load_tile<T, DH>(v + base, k0, s, vs, DH, kBK);
    __syncthreads();

    float sc[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) sc[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float qv[kRows], kv[kKeys];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = qs[(r0 + i) * kQS + d];
#pragma unroll
      for (int j = 0; j < kKeys; ++j) kv[j] = ks[(lane + kLanes * j) * kKS + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kKeys; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + r0 + i;
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int kpos = k0 + lane + kLanes * j;
        float x = sc[i][j] * scale;
        if (kpos >= s || (causal && kpos > qpos)) x = kNegInf;
        sc[i][j] = x;
        mt = fmaxf(mt, x);
      }
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float p = expf(sc[i][j] - m_new);
        ps[(r0 + i) * kPStride + lane + kLanes * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < kDims; ++e) acc[i][e] *= alpha;
    }
    // A row group's P is written and read by its own 16 lanes, which share
    // a warp.
    __syncwarp();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float vv[kDims];
#pragma unroll
      for (int e = 0; e < kDims; ++e) vv[e] = vs[kk * DH + lane + kLanes * e];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float p = ps[(r0 + i) * kPStride + kk];
#pragma unroll
        for (int e = 0; e < kDims; ++e) acc[i][e] = fmaf(p, vv[e], acc[i][e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qpos = q0 + r0 + i;
    if (qpos >= s) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* row = o + base + (long long)qpos * DH;
#pragma unroll
    for (int e = 0; e < kDims; ++e)
      row[lane + kLanes * e] = from_f32<T>(acc[i][e] / denom);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int s, float scale, int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)bh, (unsigned)((s + kBQ - 1) / kBQ));
  flash_attention_kernel<T, DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), s, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, void* o, int bh,
              int s, int dh, float scale, int causal, cudaStream_t stream) {
  switch (dh) {
    case 32: return launch<T, 32>(q, k, v, o, bh, s, scale, causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, bh, s, scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, bh, s, scale, causal, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o: contiguous (bh, s, dh) tensors of one type, o not overlapping
// the inputs.  dtype: 0 float32, 1 bfloat16.  dh: 32, 64 or 128.  scale:
// float32(1/sqrt(dh)).  causal: 0 or 1.  Launches on the calling thread's
// current device.  Returns the CUDA error code of the launch (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int bh, int s,
                                      int dh, int dtype, float scale,
                                      int causal, void* stream) {
  if (bh <= 0 || s <= 0 || (s + kBQ - 1) / kBQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dh<float>(q, k, v, o, bh, s, dh, scale, causal, st);
  if (dtype == 1)
    return launch_dh<__nv_bfloat16>(q, k, v, o, bh, s, dh, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}
