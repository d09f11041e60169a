// FlashAttention-2 forward for the prefill path, NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernel of the JAX package's
// repro/kernels/flash_attention.py (`_kernel`, entry flash_attention_pallas).
// For one (batch row b, query head h) and query rows q, with key/value head
// h / rep (grouped-query attention, rep = Hq / Hkv):
//
//   s[q, k] = (q_row . k_row) / sqrt(D)              float32, operands widened
//   s[q, k] = -1e30 where k > q (causal) or k <= q - window (sliding window)
//   o[q]    = sum_k softmax_k(s[q, :]) v[k]          online, in float32
//
// with query and key positions both counted from 0 (top-left causal
// alignment when Sq != Skv), the reference's additive -1e30 (never -inf: a
// row with no admissible key averages every key uniformly, as the
// reference's softmax does), the reference's l == 0 guard, and the output
// written in the inputs' type -- the contract of
// repro_torch.kernels.ref.flash_attention_ref.
//
// What bounds it on this card: operations.  At the olmoe prefill shape (8
// rows x 1024 tokens x 16 heads x 128) the causal half of Q.K^T and P.V is
// ~34 GFLOP against 67 MB of q, k, v and o.  This first version computes in
// plain float32 FMAs (67 TFLOP/s), not on the tensor cores: bf16 x bf16
// products are exact in float32, so Q.K^T could move to them later; P.V
// with a bf16 P would lose precision and needs a split operand.
//
// What the design does about it:
//   * A block computes a 64-row query tile of one (row, head) against the
//     key tiles its rows can see, 64 keys at a time, walking them in order
//     with the running max m, sum l and the 64 x D accumulator in registers
//     (the TPU grid's sequential kv axis becomes a loop inside the block).
//     Tiles are fixed at 64 x 64 whatever the sequence length; ragged edges
//     are masked inside the kernel (a key past Skv contributes exactly 0, a
//     query row past Sq is never written).
//   * Key tiles masked whole for every row of the query tile are skipped:
//     for a causal or windowed tile the loop runs only over the keys
//     [min lo, max hi] its rows admit.  Skipping is exact: a row's scores in
//     a tile before its first admissible key are all -1e30, give p = 1 while
//     m is still -1e30, and are wiped by alpha = exp(-1e30 - m) = 0 at the
//     first admissible key; tiles after its last admissible key give p = 0.
//     A query tile holding a row that admits no key at all visits every key
//     tile, so that row averages all keys as the reference does.
//   * 256 threads as a 16 x 16 grid; thread (ty, tx) owns rows ty + 16 i and
//     keys tx + 16 j (i, j < 4) of a score tile, and rows ty + 16 i and the
//     float4 column groups tx + 16 g of the accumulator.  A row's 16 owners
//     are 16 lanes of one warp: its max and sum reduce by shuffles, and the
//     probabilities go through shared memory within the warp only.
//   * q, k and v tiles are staged in shared memory as float32 rows of D + 4
//     floats (row stride an odd multiple of 16 bytes: the float4 reads of
//     the inner loops hit distinct banks), 16-byte global loads along D;
//     the three tiles and the probabilities take 118 KB at D 128 (dynamic
//     shared memory, cudaFuncSetAttribute), 82 KB at D 80.
//   * Query tiles are issued last-first, so the causal tiles with the most
//     keys start first and the tail of the grid is short ones.
//   * q, k and v are read through their (batch, seq, head) strides with the
//     head axis contiguous; the wrapper hands over 16-byte aligned views.
//     Inputs in float32 or bfloat16 (all three of one type), D a multiple of
//     8 up to 128; the output (B, Sq, Hq, D) contiguous in the inputs' type,
//     bfloat16 rounded to nearest even.
//
// Plain C interface: the entry launches on the stream it is given,
// allocates nothing, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;           // query rows of a tile
constexpr int kBK = 64;           // keys of a tile
constexpr int kGrid = 16;         // threads per side of the 16 x 16 grid
constexpr int kThreads = kGrid * kGrid;
constexpr int kMaxD = 128;        // head sizes the accumulator covers
constexpr int kMaxGroups = kMaxD / 4 / kGrid;   // float4 groups per thread
constexpr int kLdP = kBK + 4;     // row of the probability tile
constexpr float kNegInf = -1e30f; // the reference's mask value
constexpr size_t kMaxSmem = 232448;

struct Strides {                  // in elements; the head axis is contiguous
  long long qb, qs, qh;
  long long kb, ks, kh;
  long long vb, vs, vh;
};

size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)3 * kBQ * (D + 4) + (size_t)kBQ * kLdP);
}

// 16 bytes of the input as floats: 4 float32 or 8 bfloat16
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

// rows [r0, r0 + 64) of a (seq, D) slice with row stride `rs`, as float32
// rows of `ld` floats; rows at or past `n` are zeros
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          long long rs, int r0, int n,
                                          int D) {
  constexpr int kVec = 16 / sizeof(T);
  const int per_row = D / kVec;
  for (int e = threadIdx.x; e < kBQ * per_row; e += kThreads) {
    const int r = e / per_row, c = (e % per_row) * kVec;
    float v[kVec];
    if (r0 + r < n) {
      load16(src + (long long)(r0 + r) * rs + c, v);
    } else {
#pragma unroll
      for (int t = 0; t < kVec; ++t) v[t] = 0.0f;
    }
#pragma unroll
    for (int t = 0; t < kVec; t += 4)
      store4(dst + r * ld + c + t, make_float4(v[t], v[t + 1], v[t + 2],
                                               v[t + 3]));
  }
}

// grid (ceil(Sq / 64), Hq, B), kThreads threads
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, Strides sd,
                     int Sq, int Skv, int Hq, int rep, int D, float scale,
                     int causal, int has_window, int window) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int ld = D + 4;
  float* Qs = sm;                    // [kBQ][ld]
  float* Ks = Qs + kBQ * ld;         // [kBK][ld]
  float* Vs = Ks + kBK * ld;         // [kBK][ld]
  float* Ps = Vs + kBK * ld;         // [kBQ][kLdP]

  const int tid = threadIdx.x;
  const int tx = tid % kGrid, ty = tid / kGrid;
  const int qt = gridDim.x - 1 - blockIdx.x;   // the longest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / rep;
  const int q0 = qt * kBQ;
  const int D4 = D / 4;

  const T* qp = q + b * sd.qb + h * sd.qh;
  const T* kp = k + b * sd.kb + hk * sd.kh;
  const T* vp = v + b * sd.vb + hk * sd.vh;

  // the keys this tile's rows admit; rows only move the range right, so
  // the first row gives its start and the last its end
  const int q_last = min(q0 + kBQ, Sq) - 1;
  const int hi_last = causal ? min(q_last, Skv - 1) : Skv - 1;
  int k_lo = 0, k_hi = Skv - 1;
  if (!(has_window && q_last - window + 1 > hi_last)) {
    k_lo = has_window ? max(0, q0 - window + 1) : 0;
    k_hi = hi_last;
  }                                  // else a row admits no key: visit all
  const int t_lo = k_lo / kBK, t_hi = k_hi / kBK;

  load_tile(Qs, ld, qp, sd.qs, q0, Sq, D);

  float m[4], l[4];
  float4 acc[4][kMaxGroups];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g) acc[i][g] = make_float4(0, 0, 0, 0);
  }

  for (int t = t_lo; t <= t_hi; ++t) {
    const int k0 = t * kBK;
    __syncthreads();                 // the last tile's readers are done
    load_tile(Ks, ld, kp, sd.ks, k0, Skv, D);
    load_tile(Vs, ld, vp, sd.vs, k0, Skv, D);
    __syncthreads();

    // scores: rows ty + 16 i, keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + kGrid * i) * ld + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + kGrid * j) * ld + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }

    // masks, then the online softmax of each row over this tile
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + kGrid * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + kGrid * j;
        float x = s[i][j] * scale;
        bool ok = true;
        if (causal) ok = ok && kpos <= qpos;
        if (has_window) ok = ok && kpos > qpos - window;
        x = ok ? x : kNegInf;
        if (kpos >= Skv) x = -INFINITY;  // not a key: p is exactly 0
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = kGrid / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty + kGrid * i) * kLdP + tx + kGrid * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = kGrid / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int g = 0; g < kMaxGroups; ++g) {
        acc[i][g].x *= alpha; acc[i][g].y *= alpha;
        acc[i][g].z *= alpha; acc[i][g].w *= alpha;
      }
    }
    __syncwarp();                    // a row's probabilities: one warp's

    // acc[rows, groups] += P[rows, :] . V[:, groups]
    const int kn = min(kBK, Skv - k0);
    for (int kk = 0; kk < kn; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (ty + kGrid * i) * kLdP + kk);
#pragma unroll
      for (int g = 0; g < kMaxGroups; ++g) {
        const int grp = tx + kGrid * g;
        if (grp >= D4) continue;
        float4 vv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          vv[r] = *reinterpret_cast<const float4*>(Vs + (kk + r) * ld + 4 * grp);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pr[4] = {pv[i].x, pv[i].y, pv[i].z, pv[i].w};
          float4 a = acc[i][g];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            a.x = fmaf(pr[r], vv[r].x, a.x);
            a.y = fmaf(pr[r], vv[r].y, a.y);
            a.z = fmaf(pr[r], vv[r].z, a.z);
            a.w = fmaf(pr[r], vv[r].w, a.w);
          }
          acc[i][g] = a;
        }
      }
    }
  }

  // o = acc / l, with the reference's guard for l == 0
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + kGrid * i;
    if (qpos >= Sq) continue;
    const float ls = l[i] == 0.0f ? 1.0f : l[i];
    T* orow = o + (((long long)b * Sq + qpos) * Hq + h) * D;
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g) {
      const int grp = tx + kGrid * g;
      if (grp >= D4) continue;
      const float4 a = acc[i][g];
      store4(orow + 4 * grp,
             make_float4(a.x / ls, a.y / ls, a.z / ls, a.w / ls));
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Skv, int Hq, int Hkv, int D, float scale, int causal,
           int has_window, int window, const Strides& sd, cudaStream_t s) {
  const size_t smem = smem_bytes(D);
  auto kernel = flash_fwd_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((Sq + kBQ - 1) / kBQ), (unsigned)Hq,
                  (unsigned)B);
  kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sd, Sq, Skv, Hq,
      Hq / Hkv, D, scale, causal, has_window, window);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q: (B, Sq, Hq, D), k and v: (B, Skv, Hkv, D), all float32 (in_bf16 == 0)
// or all bfloat16, read through strides[9] = (batch, seq, head) element
// strides of q, k and v in that order, the last axis contiguous and every
// row 16-byte aligned; o: (B, Sq, Hq, D) contiguous, of the inputs' type.
// Needs Hq % Hkv == 0, D % 8 == 0, D <= 128, Skv >= 1.  has_window == 0
// ignores `window`.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int in_bf16, int B, int Sq, int Skv,
                           int Hq, int Hkv, int D, float scale, int causal,
                           int has_window, int window,
                           const long long* strides, void* stream) {
  if (B <= 0 || Sq <= 0 || Hq <= 0) return (int)cudaSuccess;
  if (Skv <= 0 || Hkv <= 0 || Hq % Hkv || D <= 0 || D % 8 || D > kMaxD ||
      Hq > 65535 || B > 65535 || smem_bytes(D) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const Strides sd = {strides[0], strides[1], strides[2],
                      strides[3], strides[4], strides[5],
                      strides[6], strides[7], strides[8]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16)
    return launch<__nv_bfloat16>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, scale,
                                 causal, has_window, window, sd, s);
  return launch<float>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, scale, causal,
                       has_window, window, sd, s);
}

}  // extern "C"
