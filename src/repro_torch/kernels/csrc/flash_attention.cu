// FlashAttention-2 forward for the prefill path, NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernel of the JAX package's
// repro/kernels/flash_attention.py (`_kernel`, entry flash_attention_pallas).
// For one (batch row b, query head h) and query rows q, with key/value head
// h / rep (grouped-query attention, rep = Hq / Hkv):
//
//   s[q, k] = (q_row . k_row) / sqrt(D)              float32
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
// Two kernels, picked by the inputs' type (nothing routes a failed launch
// to the other):
//
// * bfloat16 -- `flash_fwd_mma_kernel`, on the tensor cores.  What bounds
//   it: operations.  At the olmoe prefill shape (8 rows x 1024 tokens x 16
//   heads x 128) the causal half of Q.K^T and P.V is 34.4 GFLOP against
//   134 MB of q, k, v and o; at the bf16 tensor-core rate that is 0.035 ms,
//   at the float32 rate of plain FMAs 0.51 ms.  The design, FlashAttention-2
//   on `mma.sync.m16n8k16` (bf16 x bf16 -> f32):
//     - a block of 4 warps takes 64 rows of (query position, query head of
//       one kv head's group): with G heads of the group in a block (G =
//       min(rep, 16)), row r is position q0 + r / G of head r % G, so one
//       K/V tile serves every query head of the group; each warp owns 16
//       rows and keeps their Q fragments in registers for the whole walk;
//     - K/V tiles of 64 keys stream through a 2-stage `cp.async` ring in
//       bf16 (16-byte copies, zero-filled past Skv and past D), rows padded
//       to D + 8 elements (an odd multiple of 16 bytes) so every `ldmatrix`
//       is conflict-free; 87 KB at D 128, two blocks per SM;
//     - S = Q K^T from `ldmatrix` fragments (exact in f32: a product of two
//       bf16 is exact in f32); the online softmax runs on the accumulator
//       fragments in registers, a row's max and sum reducing over the 4
//       lanes of a quad; the C fragment of S is re-packed in registers as
//       the A fragment of P V (`ldmatrix.trans` for V), no shared memory;
//     - P is split, P = P_hi + P_lo with P_hi = bf16(P) and P_lo = bf16(P -
//       P_hi), and both products go into one f32 accumulator: 1.5x the
//       tensor-core work of a single bf16 P, and P then carries ~2^-17
//       relative error instead of 2^-9, which the bf16 hold needs where the
//       output is near zero;
//     - D a multiple of 8 up to 128 is padded to a multiple of 16 with zeros
//       in shared memory (D 8, 24, ...; h2o-danube's 80 needs none).
// * float32 -- `flash_fwd_kernel`, the SIMT kernel, plain float32 FMAs
//   (the reduced configs and the float32 holds run it): 256 threads as a
//   16 x 16 grid over a 64 x 64 score tile, q, k and v tiles as float32 rows
//   of D + 4 floats in shared memory (118 KB at D 128), a row's max and sum
//   reduced by shuffles over 16 lanes of one warp.
//
// Both kernels:
//   * fixed tiles of 64 query rows x 64 keys whatever the sequence length;
//     ragged edges are masked inside the kernel (a key past Skv is -inf, so
//     p is exactly 0; a query row past Sq is never written);
//   * key tiles masked whole for every row of the query tile are skipped:
//     the loop runs only over the keys [min lo, max hi] its rows admit.
//     Exact: a row's scores in a tile before its first admissible key are
//     -1e30, give p = 1 while m is still -1e30, and are wiped by alpha =
//     exp(-1e30 - m) = 0 at the first admissible key; tiles after its last
//     admissible key give p = 0.  A query tile holding a row that admits no
//     key at all visits every key tile, so that row averages all keys as
//     the reference does;
//   * query tiles are issued last-first, so the causal tiles with the most
//     keys start first and the tail of the grid is short ones;
//   * q, k and v are read through their (batch, seq, head) strides with the
//     head axis contiguous (the wrapper hands over 16-byte aligned views);
//     the output (B, Sq, Hq, D) is contiguous in the inputs' type, bfloat16
//     rounded to nearest even;
//   * given a pointer `lse`, each row's log-sum-exp of its scores, float32
//     (B, Sq, Hq), in natural-log units of s = q.k / sqrt(D): m + log(l) with
//     the l == 0 guard, m the row's largest admitted score, or -1e30 for a row
//     with no admissible key (the reference's `attn_fwd` residual, which its
//     backward reads as p = exp(s - lse)); nothing is written when it is null.
//     The tensor-core kernel keeps m in the base-2 domain of its exponentials
//     (m2 = m log2(e)) and writes m2 ln(2) + log(l).
//
// Plain C interface: the entry launches on the stream it is given,
// allocates nothing, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kBQ = 64;           // query rows of a tile
constexpr int kBK = 64;           // keys of a tile
constexpr int kMaxD = 128;        // head sizes both kernels cover
constexpr float kNegInf = -1e30f; // the reference's mask value
constexpr size_t kMaxSmem = 232448;

struct Strides {                  // in elements; the head axis is contiguous
  long long qb, qs, qh;
  long long kb, ks, kh;
  long long vb, vs, vh;
};

// the key tiles [t_lo, t_hi] the rows q0 .. q_last admit, or every tile if
// one of them admits no key
__device__ __forceinline__ void key_tiles(int q0, int q_last, int Skv,
                                          int causal, int has_window,
                                          int window, int& t_lo, int& t_hi) {
  const int hi_last = causal ? min(q_last, Skv - 1) : Skv - 1;
  int k_lo = 0, k_hi = Skv - 1;
  if (!(has_window && q_last - window + 1 > hi_last)) {
    k_lo = has_window ? max(0, q0 - window + 1) : 0;
    k_hi = hi_last;
  }
  t_lo = k_lo / kBK;
  t_hi = k_hi / kBK;
}

// ===========================================================================
// float32: the SIMT kernel
// ===========================================================================
constexpr int kGrid = 16;         // threads per side of the 16 x 16 grid
constexpr int kThreads = kGrid * kGrid;
constexpr int kMaxGroups = kMaxD / 4 / kGrid;   // float4 groups per thread
constexpr int kLdP = kBK + 4;     // row of the probability tile

size_t smem_bytes_f32(int D) {
  return sizeof(float) * ((size_t)3 * kBQ * (D + 4) + (size_t)kBQ * kLdP);
}

// rows [r0, r0 + 64) of a (seq, D) slice with row stride `rs`, as float32
// rows of `ld` floats; rows at or past `n` are zeros
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src,
                                          long long rs, int r0, int n,
                                          int D) {
  const int per_row = D / 4;
  for (int e = threadIdx.x; e < kBQ * per_row; e += kThreads) {
    const int r = e / per_row, c = (e % per_row) * 4;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r0 + r < n)
      v = *reinterpret_cast<const float4*>(src + (long long)(r0 + r) * rs + c);
    *reinterpret_cast<float4*>(dst + r * ld + c) = v;
  }
}

// grid (ceil(Sq / 64), Hq, B), kThreads threads
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, Strides sd, int Sq, int Skv,
                     int Hq, int rep, int D, float scale, int causal,
                     int has_window, int window) {
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

  const float* qp = q + b * sd.qb + h * sd.qh;
  const float* kp = k + b * sd.kb + hk * sd.kh;
  const float* vp = v + b * sd.vb + hk * sd.vh;

  int t_lo, t_hi;
  key_tiles(q0, min(q0 + kBQ, Sq) - 1, Skv, causal, has_window, window, t_lo,
            t_hi);

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
    if (lse != nullptr && tx == 0)   // m and l: the same in the row's 16 lanes
      lse[((long long)b * Sq + qpos) * Hq + h] = m[i] + logf(ls);
    float* orow = o + (((long long)b * Sq + qpos) * Hq + h) * D;
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g) {
      const int grp = tx + kGrid * g;
      if (grp >= D4) continue;
      const float4 a = acc[i][g];
      *reinterpret_cast<float4*>(orow + 4 * grp) =
          make_float4(a.x / ls, a.y / ls, a.z / ls, a.w / ls);
    }
  }
}

int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int Sq, int Skv, int Hq, int Hkv, int D,
               float scale, int causal, int has_window, int window,
               const Strides& sd, cudaStream_t s) {
  const size_t smem = smem_bytes_f32(D);
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((Sq + kBQ - 1) / kBQ), (unsigned)Hq,
                  (unsigned)B);
  flash_fwd_kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, sd, Sq, Skv,
      Hq, Hq / Hkv, D, scale, causal, has_window, window);
  return (int)cudaGetLastError();
}

// ===========================================================================
// bfloat16: the tensor-core kernel
// ===========================================================================
constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kRows = 16 * kMmaWarps;   // rows of a block: 16 a warp
constexpr int kStages = 2;              // K/V tiles in flight
constexpr int kMaxGroupRows = 16;       // query heads of a group in a block

using namespace mma_bf16;

constexpr size_t smem_bytes_mma(int DP) {
  return sizeof(__nv_bfloat16) * (size_t)(kRows + kStages * 2 * kBK) *
         (DP + 8);
}

// grid (ceil(Sq / (64 / G)), Hkv * nchunk, B), kMmaThreads threads.  DP is
// D padded to a multiple of 16.  Block row r is query position
// q0 + r / G of query head hk * rep + chunk * G + r % G.
template <int DP>
__global__ void __launch_bounds__(kMmaThreads, 2)
    flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         __nv_bfloat16* __restrict__ o,
                         float* __restrict__ lse, Strides sd, int Sq,
                         int Skv, int Hq, int rep, int G, int nchunk, int D,
                         float scale_log2, int causal, int has_window,
                         int window) {
  constexpr int LD = DP + 8;          // a shared row: an odd multiple of 16 B
  constexpr int CH = DP / 8;          // 16-byte chunks of a row
  constexpr int KSTEPS = DP / 16;     // k-steps of Q K^T
  constexpr int NO = DP / 8;          // n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [64][LD]
  __nv_bfloat16* KVs = Qs + kRows * LD;   // [kStages][K, V][64][LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;   // quad and lane in quad
  const int Pq = kRows / G;                  // query positions of a tile
  const int nrows = Pq * G;                  // rows in use
  const int qt = gridDim.x - 1 - blockIdx.x; // the longest tiles first
  const int hk = blockIdx.y / nchunk, chunk = blockIdx.y % nchunk;
  const int b = blockIdx.z;
  const int q0 = qt * Pq;
  const int g0 = chunk * G;                  // first head of the group here

  int t_lo, t_hi;
  key_tiles(q0, min(q0 + Pq, Sq) - 1, Skv, causal, has_window, window, t_lo,
            t_hi);
  const int q_last = min(q0 + Pq, Sq) - 1;

  // Q rows, zeros for rows not in use, past Sq, past the group, past D
  for (int e = tid; e < kRows * CH; e += kMmaThreads) {
    const int r = e / CH, c = e % CH;
    const int qp = q0 + r / G, hg = g0 + r % G;
    const bool ok = r < nrows && qp < Sq && hg < rep && c * 8 < D;
    const __nv_bfloat16* src =
        ok ? q + b * sd.qb + qp * sd.qs + (hk * rep + hg) * sd.qh + c * 8 : q;
    cp_async16(Qs + r * LD + c * 8, src, ok);
  }
  auto load_kv = [&](int t, int st) {
    const int k0 = t * kBK;
    __nv_bfloat16* Kd = KVs + st * 2 * kBK * LD;
    __nv_bfloat16* Vd = Kd + kBK * LD;
    for (int e = tid; e < kBK * CH; e += kMmaThreads) {
      const int r = e / CH, c = e % CH;
      const bool ok = k0 + r < Skv && c * 8 < D;
      const long long kr = (long long)(k0 + r);
      cp_async16(Kd + r * LD + c * 8,
                 ok ? k + b * sd.kb + kr * sd.ks + hk * sd.kh + c * 8 : k, ok);
      cp_async16(Vd + r * LD + c * 8,
                 ok ? v + b * sd.vb + kr * sd.vs + hk * sd.vh + c * 8 : v, ok);
    }
  };
  load_kv(t_lo, 0);                 // one group with Q
  cp_async_commit();
#pragma unroll
  for (int st = 1; st < kStages - 1; ++st) {
    if (t_lo + st <= t_hi) load_kv(t_lo + st, st);
    cp_async_commit();
  }

  // this thread's two rows of the warp's 16
  const int r0 = warp * 16 + gq, r1 = r0 + 8;
  const int qpos0 = q0 + r0 / G, qpos1 = q0 + r1 / G;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  uint32_t qf[KSTEPS][4];

  for (int t = t_lo; t <= t_hi; ++t) {
    const int i = t - t_lo;
    cp_async_wait<kStages - 2>();   // tile t (and Q) has landed
    __syncthreads();                // ... for every thread; tile t-1 is read
    if (t + kStages - 1 <= t_hi)
      load_kv(t + kStages - 1, (i + kStages - 1) % kStages);
    cp_async_commit();
    if (i == 0) {
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks)
        ldsm_x4(qf[ks], Qs + (warp * 16 + (lane & 15)) * LD + ks * 16 +
                            (lane >> 4) * 8);
    }
    const __nv_bfloat16* Ks = KVs + (i % kStages) * 2 * kBK * LD;
    const __nv_bfloat16* Vs = Ks + kBK * LD;
    const int k0 = t * kBK;

    // S = Q K^T: 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4];
        ldsm_x4(bk, Ks + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                        ks * 16 + ((lane >> 3) & 1) * 8);
        mma16816(s[2 * np], qf[ks], bk[0], bk[1]);
        mma16816(s[2 * np + 1], qf[ks], bk[2], bk[3]);
      }
    }

    // masks (only where the tile is not admitted whole), then the online
    // softmax, in the log2 domain
    const bool whole = (!causal || k0 + kBK - 1 <= q0) &&
                       (!has_window || k0 > q_last - window) &&
                       k0 + kBK <= Skv;
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (!whole) {
          const int kpos = k0 + 8 * j + 2 * tq + (e & 1);
          const int qpos = e < 2 ? qpos0 : qpos1;
          bool ok = true;
          if (causal) ok = ok && kpos <= qpos;
          if (has_window) ok = ok && kpos > qpos - window;
          x = ok ? x : kNegInf;
          if (kpos >= Skv) x = -INFINITY;   // not a key: p is exactly 0
        }
        s[j][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = fast_exp2(m0 - mn0), alpha1 = fast_exp2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = fast_exp2(s[j][0] - mn0);
      s[j][1] = fast_exp2(s[j][1] - mn0);
      s[j][2] = fast_exp2(s[j][2] - mn1);
      s[j][3] = fast_exp2(s[j][3] - mn1);
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
    l0 = l0 * alpha0 + sum0;        // this lane's part; summed over the quad
    l1 = l1 * alpha1 + sum1;        // at the end
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= alpha0; acc[n][1] *= alpha0;
      acc[n][2] *= alpha1; acc[n][3] *= alpha1;
    }

    // O += (P_hi + P_lo) V: the C fragments of S become A fragments
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int np = 0; np < DP / 16; ++np) {
        uint32_t bv[4];
        ldsm_x4_t(bv, Vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                              LD + np * 16 + (lane >> 4) * 8);
        mma16816(acc[2 * np], ph, bv[0], bv[1]);
        mma16816(acc[2 * np], pl, bv[0], bv[1]);
        mma16816(acc[2 * np + 1], ph, bv[2], bv[3]);
        mma16816(acc[2 * np + 1], pl, bv[2], bv[3]);
      }
    }
  }
  cp_async_wait<0>();               // no copy outlives the block

  // o = acc / l, with the reference's guard for l == 0
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float ls0 = l0 == 0.0f ? 1.0f : l0, ls1 = l1 == 0.0f ? 1.0f : l1;
  const bool ok0 = r0 < nrows && qpos0 < Sq && g0 + r0 % G < rep;
  const bool ok1 = r1 < nrows && qpos1 < Sq && g0 + r1 % G < rep;
  __nv_bfloat16* o0 =
      o + (((long long)b * Sq + qpos0) * Hq + hk * rep + g0 + r0 % G) * D;
  __nv_bfloat16* o1 =
      o + (((long long)b * Sq + qpos1) * Hq + hk * rep + g0 + r1 % G) * D;
  if (lse != nullptr && tq == 0) {  // m and l: the same in the quad's 4 lanes
    constexpr float kLn2 = 0.6931471805599453f;
    if (ok0)
      lse[((long long)b * Sq + qpos0) * Hq + hk * rep + g0 + r0 % G] =
          (m0 == kNegInf ? kNegInf : m0 * kLn2) + logf(ls0);
    if (ok1)
      lse[((long long)b * Sq + qpos1) * Hq + hk * rep + g0 + r1 % G] =
          (m1 == kNegInf ? kNegInf : m1 * kLn2) + logf(ls1);
  }
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int col = 8 * n + 2 * tq;
    if (col >= D) continue;
    if (ok0)
      *reinterpret_cast<uint32_t*>(o0 + col) =
          pack_bf16(acc[n][0] / ls0, acc[n][1] / ls0);
    if (ok1)
      *reinterpret_cast<uint32_t*>(o1 + col) =
          pack_bf16(acc[n][2] / ls1, acc[n][3] / ls1);
  }
}

template <int DP>
int launch_mma_dp(const void* q, const void* k, const void* v, void* o,
                  float* lse, int B, int Sq, int Skv, int Hq, int Hkv, int D,
                  float scale, int causal, int has_window, int window,
                  const Strides& sd, cudaStream_t s) {
  constexpr size_t smem = smem_bytes_mma(DP);
  auto kernel = flash_fwd_mma_kernel<DP>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int rep = Hq / Hkv;
  const int G = rep < kMaxGroupRows ? rep : kMaxGroupRows;
  const int nchunk = (rep + G - 1) / G;
  const int Pq = kRows / G;
  if ((long long)Hkv * nchunk > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((Sq + Pq - 1) / Pq), (unsigned)(Hkv * nchunk),
                  (unsigned)B);
  kernel<<<grid, kMmaThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      lse, sd, Sq, Skv, Hq, rep, G, nchunk, D, scale * 1.4426950408889634f,
      causal, has_window, window);
  return (int)cudaGetLastError();
}

int launch_mma(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int Sq, int Skv, int Hq, int Hkv, int D,
               float scale, int causal, int has_window, int window,
               const Strides& sd, cudaStream_t s) {
#define LAUNCH_MMA(DP)                                                      \
  return launch_mma_dp<DP>(q, k, v, o, lse, B, Sq, Skv, Hq, Hkv, D, scale,  \
                           causal, has_window, window, sd, s)
  switch ((D + 15) / 16) {          // D padded to a multiple of 16
    case 1: LAUNCH_MMA(16);
    case 2: LAUNCH_MMA(32);
    case 3: LAUNCH_MMA(48);
    case 4: LAUNCH_MMA(64);
    case 5: LAUNCH_MMA(80);
    case 6: LAUNCH_MMA(96);
    case 7: LAUNCH_MMA(112);
    default: LAUNCH_MMA(128);       // D <= 128, checked by the caller
  }
#undef LAUNCH_MMA
}

}  // namespace

extern "C" {

// q: (B, Sq, Hq, D), k and v: (B, Skv, Hkv, D), all float32 (in_bf16 == 0:
// the SIMT kernel) or all bfloat16 (the tensor-core kernel), read through
// strides[9] = (batch, seq, head) element strides of q, k and v in that
// order, the last axis contiguous and every row 16-byte aligned; o: (B, Sq,
// Hq, D) contiguous, of the inputs' type; lse: (B, Sq, Hq) float32
// contiguous, or null for none.  Needs Hq % Hkv == 0, D % 8 == 0, D <= 128,
// Skv >= 1.  has_window == 0 ignores `window`.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, void* lse, int in_bf16, int B, int Sq,
                           int Skv, int Hq, int Hkv, int D, float scale,
                           int causal, int has_window, int window,
                           const long long* strides, void* stream) {
  if (B <= 0 || Sq <= 0 || Hq <= 0) return (int)cudaSuccess;
  if (Skv <= 0 || Hkv <= 0 || Hq % Hkv || D <= 0 || D % 8 || D > kMaxD ||
      Hq > 65535 || B > 65535 || smem_bytes_f32(D) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const Strides sd = {strides[0], strides[1], strides[2],
                      strides[3], strides[4], strides[5],
                      strides[6], strides[7], strides[8]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16)
    return launch_mma(q, k, v, o, static_cast<float*>(lse), B, Sq, Skv, Hq,
                      Hkv, D, scale, causal, has_window, window, sd, s);
  return launch_f32(q, k, v, o, static_cast<float*>(lse), B, Sq, Skv, Hq,
                    Hkv, D, scale, causal, has_window, window, sd, s);
}

}  // extern "C"
