// RMSNorm and rotary position embedding of the model step, NVIDIA Hopper
// (sm_90a).
//
// Replaces no Pallas kernel: the JAX package writes both as jnp ops in
// repro/models/layers.py (apply_rmsnorm_heads, apply_rope), which XLA fuses
// on the TPU.  The port ran the same ops one PyTorch call at a time: 8 aten
// ops an RMSNorm and 18 a rotary embedding, 52 of a decoder layer's ~74, each
// a kernel launch on the card.  Here each function is one launch.
//
//   * rmsnorm_kernel: y = x * rsqrt(mean(x^2) + eps) * scale over the last
//     axis of a contiguous x (rows, width), in float32, written in x's type.
//     What bounds it: bytes (x read, y written, 3 flops an element).  A row
//     goes to `tpr` threads, a power of two from the row's width alone: one
//     thread a 16-byte chunk (8 bf16 or 4 float32 elements) up to 1,024
//     threads, so a 2,048-wide bf16 row is 256 threads with one 16-byte load
//     each, a 128-wide head row 16 threads (8 rows a 128-thread block), a
//     12,288-wide row 1,024 threads with two chunks each.  Squares are summed
//     in float32 in a fixed order -- each thread its chunks in turn, a xor
//     butterfly of warp shuffles, then the warps' sums in warp order through
//     shared memory -- that depends on the width and the type alone, so a row
//     gives the same bits alone or in any batch.  The second pass reads the
//     row again (from L1) and writes it.  Products and sums are rounded one
//     by one (__fmul_rn / __fadd_rn): no contraction into an FMA, as the op
//     chain computes them.  A width that is not a multiple of the chunk takes
//     single elements.
//   * rope_kernel: x (B, S, H, D) contiguous, positions (S,) or (B, S) int32
//     or int64, the float32 inverse frequencies inv (D/2,).  For pair i of a
//     head: a = float(pos) * inv[i], then
//       y[i]       = x[i] cos a - x[i + D/2] sin a
//       y[i + D/2] = x[i + D/2] cos a + x[i] sin a
//     each product and sum rounded on its own, cosf / sinf without fast math:
//     the op chain's arithmetic operation for operation.  What bounds it:
//     bytes, with a sincos a pair.  A block takes one token, its threads the
//     token's H * D/2 pairs.
//
// Plain C interface: each entry launches on the stream it is given,
// allocates nothing, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxThreads = 1024;
constexpr int kNormBlock = 128;        // at least this many threads a block

// element types by their storage: float32 as float, bf16 as its 16 bits
struct F32 {
  using raw = float;
  static __device__ __forceinline__ float in(float r) { return r; }
  static __device__ __forceinline__ float out(float f) { return f; }
};
struct BF16 {
  using raw = unsigned short;
  static __device__ __forceinline__ float in(unsigned short r) {
    return __bfloat162float(__ushort_as_bfloat16(r));
  }
  static __device__ __forceinline__ unsigned short out(float f) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(f));  // Tensor.to's rounding
  }
};

// N elements read or written as one aligned piece (16-byte loads at most)
template <typename R, int N>
struct alignas((N * sizeof(R)) < 16 ? (N * sizeof(R)) : 16) Chunk {
  R v[N];
};

template <typename T, int N>
__device__ __forceinline__ void load_chunk(const typename T::raw* p,
                                           float (&f)[N]) {
  const Chunk<typename T::raw, N> c =
      *reinterpret_cast<const Chunk<typename T::raw, N>*>(p);
#pragma unroll
  for (int j = 0; j < N; ++j) f[j] = T::in(c.v[j]);
}

template <typename T, int N>
__device__ __forceinline__ void store_chunk(typename T::raw* p,
                                            const float (&f)[N]) {
  Chunk<typename T::raw, N> c;
#pragma unroll
  for (int j = 0; j < N; ++j) c.v[j] = T::out(f[j]);
  *reinterpret_cast<Chunk<typename T::raw, N>*>(p) = c;
}

// ---------------------------------------------------------------------------
// RMSNorm: blockDim.x = max(tpr, kNormBlock) threads, blockDim.x / tpr rows a
// block; row r's chunk v (CH elements) belongs to lane v % tpr of the row.
// ---------------------------------------------------------------------------
template <typename TX, typename TS, int CH>
__global__ void __launch_bounds__(kMaxThreads)
    rmsnorm_kernel(const typename TX::raw* __restrict__ x,
                   const typename TS::raw* __restrict__ scale,
                   typename TX::raw* __restrict__ y, long long rows,
                   int width, int tpr, float eps) {
  __shared__ float part[kMaxThreads / 32];
  const int nchunk = width / CH;
  const int lane = threadIdx.x & (tpr - 1);
  const int r_in_block = threadIdx.x / tpr;
  const long long row = (long long)blockIdx.x * (blockDim.x / tpr) +
                        r_in_block;
  const bool live = row < rows;
  const typename TX::raw* xr = x + (live ? row : 0) * width;

  float ss = 0.f;
  if (live) {
    for (int v = lane; v < nchunk; v += tpr) {
      float f[CH];
      load_chunk<TX, CH>(xr + v * CH, f);
#pragma unroll
      for (int j = 0; j < CH; ++j) ss = __fadd_rn(ss, __fmul_rn(f[j], f[j]));
    }
  }
  // every lane of a row's group ends with the same sum (a + b == b + a)
  for (int off = (tpr < 32 ? tpr : 32) >> 1; off > 0; off >>= 1)
    ss = __fadd_rn(ss, __shfl_xor_sync(kFullMask, ss, off));
  if (tpr > 32) {
    const int nw = tpr >> 5;
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
    __syncthreads();
    ss = 0.f;
    for (int w = 0; w < nw; ++w) ss = __fadd_rn(ss, part[r_in_block * nw + w]);
  }
  if (!live) return;
  const float r = rsqrtf(__fadd_rn(__fdiv_rn(ss, (float)width), eps));
  typename TX::raw* yr = y + row * width;
  for (int v = lane; v < nchunk; v += tpr) {
    float f[CH], s[CH];
    load_chunk<TX, CH>(xr + v * CH, f);
    load_chunk<TS, CH>(scale + v * CH, s);
#pragma unroll
    for (int j = 0; j < CH; ++j) f[j] = __fmul_rn(__fmul_rn(f[j], r), s[j]);
    store_chunk<TX, CH>(yr + v * CH, f);
  }
}

template <typename TX, typename TS>
int launch_rmsnorm_t(const void* x, const void* scale, void* y,
                     long long rows, int width, float eps, cudaStream_t s) {
  constexpr int kChunk = (int)(16 / sizeof(typename TX::raw));
  const int ch = width % kChunk == 0 ? kChunk : 1;
  const int nchunk = width / ch;
  int tpr = 1;
  while (tpr < nchunk && tpr < kMaxThreads) tpr <<= 1;
  const int threads = tpr > kNormBlock ? tpr : kNormBlock;
  const long long per_block = threads / tpr;
  const long long blocks = (rows + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const auto* xs = static_cast<const typename TX::raw*>(x);
  const auto* sc = static_cast<const typename TS::raw*>(scale);
  auto* ys = static_cast<typename TX::raw*>(y);
  if (ch == kChunk)
    rmsnorm_kernel<TX, TS, kChunk><<<(unsigned)blocks, threads, 0, s>>>(
        xs, sc, ys, rows, width, tpr, eps);
  else
    rmsnorm_kernel<TX, TS, 1><<<(unsigned)blocks, threads, 0, s>>>(
        xs, sc, ys, rows, width, tpr, eps);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// RoPE: grid B * S blocks (one token each), pairs j = h * half + i strided
// over the block's threads.
// ---------------------------------------------------------------------------
template <typename TX, typename TP>
__global__ void __launch_bounds__(kMaxThreads)
    rope_kernel(const typename TX::raw* __restrict__ x,
                const TP* __restrict__ pos, const float* __restrict__ inv,
                typename TX::raw* __restrict__ y, int S, int H, int half,
                long long pos_batch_stride) {
  const long long t = blockIdx.x;               // b * S + s
  const long long b = t / S;
  const float p = (float)pos[b * pos_batch_stride + (t - b * S)];
  const long long base = t * H * 2 * half;
  for (int j = threadIdx.x; j < H * half; j += blockDim.x) {
    const int h = j / half, i = j - h * half;
    const float a = __fmul_rn(p, inv[i]);
    const float c = cosf(a), sn = sinf(a);
    const long long o = base + (long long)h * 2 * half + i;
    const float x1 = TX::in(x[o]), x2 = TX::in(x[o + half]);
    y[o] = TX::out(__fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, sn)));
    y[o + half] = TX::out(__fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, sn)));
  }
}

template <typename TX, typename TP>
int launch_rope_t(const void* x, const void* pos, const float* inv, void* y,
                  int B, int S, int H, int half, long long pos_batch_stride,
                  cudaStream_t s) {
  const long long tokens = (long long)B * S;
  const int pairs = H * half;
  int threads = ((pairs + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  rope_kernel<TX, TP><<<(unsigned)tokens, threads, 0, s>>>(
      static_cast<const typename TX::raw*>(x), static_cast<const TP*>(pos),
      inv, static_cast<typename TX::raw*>(y), S, H, half, pos_batch_stride);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x and y: (rows, width) contiguous, float32 (x_bf16 == 0) or bfloat16,
// 16-byte aligned when width is a multiple of 16 bytes' elements; scale:
// (width,) contiguous, float32 (scale_bf16 == 0) or bfloat16, as aligned.
int rmsnorm_launch(const void* x, const void* scale, void* y, int x_bf16,
                   int scale_bf16, long long rows, int width, float eps,
                   void* stream) {
  if (rows <= 0) return (int)cudaSuccess;
  if (width <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return scale_bf16
               ? launch_rmsnorm_t<BF16, BF16>(x, scale, y, rows, width, eps, s)
               : launch_rmsnorm_t<BF16, F32>(x, scale, y, rows, width, eps, s);
  return scale_bf16
             ? launch_rmsnorm_t<F32, BF16>(x, scale, y, rows, width, eps, s)
             : launch_rmsnorm_t<F32, F32>(x, scale, y, rows, width, eps, s);
}

// x and y: (B, S, H, D) contiguous, float32 (x_bf16 == 0) or bfloat16, D
// even; pos: int32 (pos_64 == 0) or int64, position of (b, s) at
// pos[b * pos_batch_stride + s] (stride 0: one row of S for every b); inv:
// (D / 2,) float32.
int rope_launch(const void* x, const void* pos, const void* inv, void* y,
                int x_bf16, int pos_64, int B, int S, int H, int D,
                long long pos_batch_stride, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaSuccess;
  if (D <= 0 || D % 2 || (long long)B * S > 0x7fffffffLL ||
      (long long)H * (D / 2) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* iv = static_cast<const float*>(inv);
  const int half = D / 2;
  if (x_bf16)
    return pos_64 ? launch_rope_t<BF16, long long>(x, pos, iv, y, B, S, H,
                                                   half, pos_batch_stride, s)
                  : launch_rope_t<BF16, int>(x, pos, iv, y, B, S, H, half,
                                             pos_batch_stride, s);
  return pos_64 ? launch_rope_t<F32, long long>(x, pos, iv, y, B, S, H, half,
                                                pos_batch_stride, s)
                : launch_rope_t<F32, int>(x, pos, iv, y, B, S, H, half,
                                          pos_batch_stride, s);
}

}  // extern "C"
