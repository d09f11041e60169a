// Paged attention for the serving path, NVIDIA Hopper (sm_90a).
//
// Replaces the two Pallas kernels of the JAX package's
// repro/kernels/paged_attention.py:
//
//   * `_decode_kernel` (entry paged_attention_decode_pallas): one-token GQA
//     decode read through a page table.  For row c and query head h (kv head
//     g = h / rep) it streams the NB pages page_table[c, :] names, scores each
//     cached key s = (q . k) / sqrt(D), adds -1e30 where the key's position
//     fails `kpos <= pos` (and `kpos > pos - window`), and folds the page into
//     an online softmax (running max m, sum l, f32 accumulator) -- the TPU
//     kernel's m/l/acc scratch, page by page.  Output acc / l (l == 0 -> 1).
//   * `_scatter_kernel` (entry paged_prefill_scatter_pallas): admission's
//     write of freshly prefilled K or V, pool[:, pages[j]] = values[:, j]
//     cast to bf16, in place; pages not named are never touched.
//
// decode -- what bounds it: bytes.  Per row and kv head it must read the K
//   and V tiles of every page the table names (2 * P * D bf16 each) and the
//   page's positions; the arithmetic (2 * rep * P * D multiply-adds per page)
//   is far below the card's byte/flop balance.  What the design does about
//   it: one block per (row, kv head) with one warp per query head of the
//   group, so each K/V tile is staged in shared memory once and read by all
//   `rep` query heads; tiles are copied 16 bytes at a time (the wrapper
//   requires D % 8 == 0 and aligned pools, which every config meets); page
//   ids are read from the table in the kernel (the TPU kernel's scalar
//   prefetch).  Like the TPU kernel it reads every page the
//   table names, SENTINEL padding included, and masks by an additive bias
//   rather than skipping keys, so an all-masked row averages its values
//   uniformly exactly as the full softmax of the oracle does.  A row's pages
//   are walked in order by one block, two shared-memory buffers deep: page
//   j+1's tiles and positions are in flight (cp.async) while page j is
//   scored, and page ids are read one page ahead, so the walk does not wait
//   out a memory latency per page.  No split over pages and no tensor cores
//   yet.
//
// scatter -- what bounds it: bytes (read values once, write the named pages
//   once).  A grid of (page block, 8-element chunk) threads: each reads 8
//   values (one or two 16-byte loads), converts with __floats2bfloat162_rn
//   (round to nearest even, the rounding of Tensor.to(torch.bfloat16)) and
//   stores 16 bytes.  No arithmetic beyond the cast: bit-exact with
//   index_copy_ of the cast values.
//
// Plain C interface: each entry launches on the stream it is given,
// allocates nothing, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kNegInf = -1e30f;      // the mask bias of the reference
constexpr int kScatterThreads = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// ---------------------------------------------------------------------------
// asynchronous global -> shared copies (sm_80+): a page is in flight while
// the previous one is being scored
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until every group but the most recent one has landed
__device__ __forceinline__ void cp_async_wait_all_but_last() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// decode: grid (Hkv, C), block rep warps.  Dynamic shared memory holds two
// buffers of a page's K tile and V tile (P x D bf16 each), the two pages'
// P positions, and each warp's P scores.  DPL = elements of a D-vector per
// lane (d = lane + 32 * i).
// ---------------------------------------------------------------------------
template <int DPL, typename QT>
__global__ void paged_decode_kernel(const QT* __restrict__ q,
                                    const __nv_bfloat16* __restrict__ k_pool,
                                    const __nv_bfloat16* __restrict__ v_pool,
                                    const int* __restrict__ pos_pool,
                                    const int* __restrict__ page_table,
                                    const int* __restrict__ positions,
                                    float* __restrict__ out, int NB, int P,
                                    int Hkv, int D, int rep, int window,
                                    float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile = P * D;               // bf16 elements of one K or V tile
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][K,V]
  int* kps = reinterpret_cast<int*>(tiles + 4 * tile);            // [2][P]
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  float* sc = reinterpret_cast<float*>(kps + 2 * P) + warp * P;

  const int g = blockIdx.x;
  const int c = blockIdx.y;
  const int H = Hkv * rep;
  const int h = g * rep + warp;
  const int pos = positions[c];
  const int* row = page_table + (size_t)c * NB;

  float qv[DPL], acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int d = lane + kWarp * i;
    qv[i] = d < D ? to_float(q[((size_t)c * H + h) * D + d]) : 0.0f;
    acc[i] = 0.0f;
  }
  float m = kNegInf, l = 0.0f;
  const size_t page_elems = (size_t)P * Hkv * D;
  const int chunks = D / 8;             // 16-byte chunks per K/V row

  // copy page `pid`'s K/V tiles of kv head g and its positions into
  // buffer b, asynchronously
  auto stage = [&](int pid, int b) {
    const size_t base = (size_t)pid * page_elems + (size_t)g * D;
    __nv_bfloat16* kd = tiles + 2 * b * tile;
    __nv_bfloat16* vd = kd + tile;
    for (int t = threadIdx.x; t < P * chunks; t += blockDim.x) {
      const int p = t / chunks, ch = t % chunks;
      const size_t src = base + (size_t)p * Hkv * D + ch * 8;
      cp_async16(kd + t * 8, k_pool + src);
      cp_async16(vd + t * 8, v_pool + src);
    }
    for (int p = threadIdx.x; p < P; p += blockDim.x)
      cp_async4(kps + b * P + p, pos_pool + (size_t)pid * P + p);
  };

  stage(row[0], 0);
  cp_async_commit();
  int pid_next = NB > 1 ? row[1] : 0;   // page ids are read one page ahead
  for (int j = 0; j < NB; ++j) {
    const int b = j & 1;
    if (j + 1 < NB) {
      stage(pid_next, b ^ 1);           // page j+1 flies while j is scored
      if (j + 2 < NB) pid_next = row[j + 2];
    }
    cp_async_commit();                  // one group per page, empty or not
    cp_async_wait_all_but_last();       // page j has landed
    __syncthreads();
    const __nv_bfloat16* ks = tiles + 2 * b * tile;
    const __nv_bfloat16* vs = ks + tile;
    const int* kp = kps + b * P;

    // scores of this warp's query head against the page's P keys
    for (int p = 0; p < P; ++p) {
      float part = 0.0f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + kWarp * i;
        if (d < D) part += qv[i] * __bfloat162float(ks[p * D + d]);
      }
#pragma unroll
      for (int o = kWarp / 2; o > 0; o >>= 1)
        part += __shfl_xor_sync(kFullMask, part, o);
      const int kpos = kp[p];
      const bool valid = kpos <= pos && (window < 0 || kpos > pos - window);
      if (lane == 0) sc[p] = part * scale + (valid ? 0.0f : kNegInf);
    }
    __syncwarp();

    // online softmax across pages
    float m_new = m;
    for (int p = 0; p < P; ++p) m_new = fmaxf(m_new, sc[p]);
    const float alpha = expf(m - m_new);
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] *= alpha;
    float psum = 0.0f;
    for (int p = 0; p < P; ++p) {
      const float e = expf(sc[p] - m_new);
      psum += e;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + kWarp * i;
        if (d < D) acc[i] += e * __bfloat162float(vs[p * D + d]);
      }
    }
    l = l * alpha + psum;
    m = m_new;
    __syncthreads();                    // buffer b is free for page j+2
  }

  const float l_safe = l == 0.0f ? 1.0f : l;
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int d = lane + kWarp * i;
    if (d < D) out[((size_t)c * H + h) * D + d] = acc[i] / l_safe;
  }
}

template <int DPL, typename QT>
int launch_decode(const void* q, const void* k_pool, const void* v_pool,
                  const void* pos_pool, const void* page_table,
                  const void* positions, void* out, int C, int NB, int P,
                  int Hkv, int D, int rep, int window, float scale,
                  cudaStream_t s) {
  const size_t smem = (size_t)4 * P * D * sizeof(__nv_bfloat16) +
                      (size_t)2 * P * sizeof(int) +
                      (size_t)rep * P * sizeof(float);
  auto kernel = paged_decode_kernel<DPL, QT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)Hkv, (unsigned)C);
  kernel<<<grid, rep * kWarp, smem, s>>>(
      static_cast<const QT*>(q), static_cast<const __nv_bfloat16*>(k_pool),
      static_cast<const __nv_bfloat16*>(v_pool),
      static_cast<const int*>(pos_pool), static_cast<const int*>(page_table),
      static_cast<const int*>(positions), static_cast<float*>(out), NB, P,
      Hkv, D, rep, window, scale);
  return (int)cudaGetLastError();
}

template <typename QT>
int dispatch_decode(const void* q, const void* k_pool, const void* v_pool,
                    const void* pos_pool, const void* page_table,
                    const void* positions, void* out, int C, int NB, int P,
                    int Hkv, int D, int rep, int window, float scale,
                    cudaStream_t s) {
#define LAUNCH_DECODE(DPL)                                                   \
  return launch_decode<DPL, QT>(q, k_pool, v_pool, pos_pool, page_table,     \
                                positions, out, C, NB, P, Hkv, D, rep,       \
                                window, scale, s)
  switch ((D + kWarp - 1) / kWarp) {
    case 1: LAUNCH_DECODE(1);
    case 2: LAUNCH_DECODE(2);
    case 3: LAUNCH_DECODE(3);
    case 4: LAUNCH_DECODE(4);
    default: LAUNCH_DECODE(8);          // D <= 256, checked by the caller
  }
#undef LAUNCH_DECODE
}

// ---------------------------------------------------------------------------
// scatter: grid (8-element chunks of a page block, S * nb).  A thread owns
// 8 elements of one page block.
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint4 pack8(const float* v) {
  uint4 r;
  __nv_bfloat162 b0 = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 b1 = __floats2bfloat162_rn(v[2], v[3]);
  __nv_bfloat162 b2 = __floats2bfloat162_rn(v[4], v[5]);
  __nv_bfloat162 b3 = __floats2bfloat162_rn(v[6], v[7]);
  r.x = *reinterpret_cast<unsigned*>(&b0);
  r.y = *reinterpret_cast<unsigned*>(&b1);
  r.z = *reinterpret_cast<unsigned*>(&b2);
  r.w = *reinterpret_cast<unsigned*>(&b3);
  return r;
}

template <typename VT>
__global__ void paged_scatter_kernel(__nv_bfloat16* __restrict__ pool,
                                     const int* __restrict__ pages,
                                     const VT* __restrict__ values,
                                     long long pool_stage_stride,
                                     long long val_stage_stride,
                                     long long E, int nb) {
  const int sj = blockIdx.y;
  const int s = sj / nb, j = sj % nb;
  __nv_bfloat16* dst = pool + s * pool_stage_stride + (long long)pages[j] * E;
  const VT* src = values + s * val_stage_stride + (long long)j * E;
  const long long e = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 8;
  if (e >= E) return;
  uint4 packed;
  if constexpr (sizeof(VT) == 4) {
    const float4 a = *reinterpret_cast<const float4*>(src + e);
    const float4 b = *reinterpret_cast<const float4*>(src + e + 4);
    const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    packed = pack8(v);
  } else {
    packed = *reinterpret_cast<const uint4*>(src + e);
  }
  *reinterpret_cast<uint4*>(dst + e) = packed;
}

}  // namespace

extern "C" {

// q: (C, H, D) float32 (q_bf16 == 0) or bfloat16, contiguous; k_pool/v_pool:
// (NP, P, Hkv, D) bfloat16, contiguous; pos_pool: (NP, P) int32; page_table:
// (C, NB) int32; positions: (C,) int32; out: (C, H, D) float32.  window < 0
// means no sliding window.  The caller guarantees D % 8 == 0 and 16-byte
// aligned pools.
int paged_attention_decode_launch(const void* q, int q_bf16,
                                  const void* k_pool, const void* v_pool,
                                  const void* pos_pool, const void* page_table,
                                  const void* positions, void* out, int C,
                                  int NB, int P, int Hkv, int D, int rep,
                                  int window, float scale, void* stream) {
  if (C <= 0 || Hkv <= 0) return (int)cudaSuccess;
  if (NB <= 0 || P <= 0 || D <= 0 || D > 256 || D % 8 || rep <= 0 ||
      rep * kWarp > 1024 || Hkv > 65535 || C > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_bf16)
    return dispatch_decode<__nv_bfloat16>(q, k_pool, v_pool, pos_pool,
                                          page_table, positions, out, C, NB,
                                          P, Hkv, D, rep, window, scale, s);
  return dispatch_decode<float>(q, k_pool, v_pool, pos_pool, page_table,
                                positions, out, C, NB, P, Hkv, D, rep, window,
                                scale, s);
}

// pool: S stages of (NP, P, Hkv, D) bfloat16 blocks, stage stride
// pool_stage_stride elements, each stage contiguous; pages: (nb,) int32;
// values: S stages of (nb, P, Hkv, D) float32 (values_bf16 == 0) or
// bfloat16, stage stride val_stage_stride, each stage contiguous.
// E = P * Hkv * D.  The caller guarantees E and both strides % 8 == 0 and
// 16-byte aligned pointers.
int paged_prefill_scatter_launch(void* pool, const void* pages,
                                 const void* values, int values_bf16, int S,
                                 int nb, long long E,
                                 long long pool_stage_stride,
                                 long long val_stage_stride, void* stream) {
  if (S <= 0 || nb <= 0 || E <= 0) return (int)cudaSuccess;
  if ((long long)S * nb > 65535 || E % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long work = E / 8;
  const dim3 grid((unsigned)((work + kScatterThreads - 1) / kScatterThreads),
                  (unsigned)(S * nb));
  if (values_bf16)
    paged_scatter_kernel<__nv_bfloat16><<<grid, kScatterThreads, 0, s>>>(
        static_cast<__nv_bfloat16*>(pool), static_cast<const int*>(pages),
        static_cast<const __nv_bfloat16*>(values), pool_stage_stride,
        val_stage_stride, E, nb);
  else
    paged_scatter_kernel<float><<<grid, kScatterThreads, 0, s>>>(
        static_cast<__nv_bfloat16*>(pool), static_cast<const int*>(pages),
        static_cast<const float*>(values), pool_stage_stride,
        val_stage_stride, E, nb);
  return (int)cudaGetLastError();
}

}  // extern "C"
