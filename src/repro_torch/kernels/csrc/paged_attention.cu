// Paged attention for the serving path, NVIDIA Hopper (sm_90a).
//
// Replaces the two Pallas kernels of the JAX package's
// repro/kernels/paged_attention.py:
//
//   * `_decode_kernel` (entry paged_attention_decode_pallas): one-token GQA
//     decode read through a page table.  For row c and query head h (kv head
//     g = h / rep) it reads the pages page_table[c, :] names, scores each
//     cached key s = (q . k) / sqrt(D), adds -1e30 where the key's position
//     fails `kpos <= pos` (and `kpos > pos - window`), and folds the page into
//     an online softmax (running max m, sum l, f32 accumulator) -- the TPU
//     kernel's m/l/acc scratch, page by page.  Output acc / l (l == 0 -> 1).
//   * `_scatter_kernel` (entry paged_prefill_scatter_pallas): admission's
//     write of freshly prefilled K or V, pool[:, pages[j]] = values[:, j]
//     cast to bf16, in place; pages not named are never touched.  Here one
//     kernel serves it and admission itself: a launch writes the K and the
//     V pages of every stage of one attention sub-layer from the dense
//     prefill cache (read through its stage stride, the ring's partial last
//     page completed with zeros) and the position pool's rows of the same
//     pages (POS_SENTINEL past the ring).

// decode -- what bounds it: bytes.  Per row and kv head it must read the K
//   and V tiles of every page whose keys the row can attend (2 * P * D bf16
//   each) and the pages' positions; the arithmetic (2 * rep * P * D
//   multiply-adds a page) is far below the card's byte/flop balance.  What
//   the design does about it:
//   - Pages that cannot count are not read.  A block first reads the P
//     positions of each page of its range (64 bytes a page) and fetches the
//     K/V tiles only of pages with at least one key that passes the mask:
//     SENTINEL padding (positions 2^30) and pages outside a sliding window
//     are skipped.  Exact for a row with an admissible key: a masked key's
//     score is exactly -1e30 in f32, so its weight exp(-1e30 - m) is exactly
//     0 once m is a real score.  A row with no admissible key at all must
//     return the reference's uniform average over every entry its table
//     names: a block whose range holds no admissible key scans the rest of
//     the row's positions, and if the row has none it walks every page of
//     its range unmasked-by-skipping (all scores -1e30, every weight 1).
//   - The walk is split across blocks (flash-decoding): grid (kv head, row,
//     split), each split a contiguous range of table entries, so a decode
//     of a few rows still fills the 132 SMs.  The wrapper sizes the splits
//     from a row's own shape (kv heads, table width), never from the row
//     count, so a row gives the same bits alone or in any batch.  Each
//     split writes its partial
//     (m, l, acc) in f32; the last block of a (row, kv head) to finish --
//     a per-(row, kv head) ticket, which that block resets -- combines the
//     partials in split order in the same launch.  No atomics in any sum:
//     two calls on the same inputs give the same bits, and the output
//     depends on page contents and table order, never on page ids.
//   - Inside a block (4 warps) keys go to lanes: a group of 8 lanes scores
//     one (query head, key) pair, 16-byte loads along D and a 3-step
//     shuffle, 16 pairs at once; the weighted sum of V gives each thread a
//     (head, column pair, key subset).  Each K/V tile is staged in shared
//     memory once for all `rep` query heads of the group.  Pages stream
//     through a ring of up to 4 shared-memory stages (cp.async), so 3 pages
//     are in flight while one is scored.
//   - Rows the caller masks are not read.  A decode round runs every
//     capacity row (64 in a chat deployment), and most hold no live
//     request: a retired row keeps its stale table and position, so it
//     walks its old pages in full, and a row that never held one names
//     SENTINEL everywhere, so each of its splits rescans the whole row and
//     then averages every entry.  That dead walk is most of an unmasked
//     call's pages.  With a row mask (row_live) every block of a masked
//     row returns after reading one flag, before any position or page; its
//     first split writes zeros for the group's heads, and no ticket moves.
//     Live rows take the same path, splits and combine order as with no
//     mask, so their bits do not depend on it.  What bounds a call is then
//     the live rows' pages, plus a position scan in each split of a live
//     row that holds no admissible key (its SENTINEL tail).
//
// scatter / admission -- what bounds it: bytes (read the values once, write
//   the named pages once).  A grid of (page, stage, K or V) blocks, each
//   moving one page block of P * Hkv * D elements, contiguous at both ends.
//   bf16 values and a page the ring fills: one thread moves the block with
//   Hopper's one-dimensional bulk copies (cp.async.bulk global -> shared,
//   completion on an mbarrier, then shared -> global in a bulk group), in
//   pieces of up to 32 KB; no thread spends a register on the bytes.  float32
//   values (they need the cast) and the ring's partial last page take the
//   plain path: each thread keeps eight 8-element pieces in flight (16 B
//   loads, sixteen for float32), converts with __floats2bfloat162_rn (round
//   to nearest even, the rounding of Tensor.to(torch.bfloat16)) and stores
//   16 bytes a piece, zeros past the ring.  No arithmetic beyond the cast:
//   bit-exact with index_copy_ of the cast values.

// Plain C interface: each entry launches on the stream it is given,
// allocates nothing, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kNegInf = -1e30f;      // the mask bias of the reference
constexpr int kAdmitThreads = 256;     // a block moves one page block
constexpr int kAdmitPieces = 8;        // 8-element pieces a thread holds
constexpr int kBulkBytes = 32768;      // one bulk copy's shared-memory stage
constexpr int kDecodeThreads = 128;    // 4 warps
constexpr int kLanesPerKey = 8;        // lanes that score one (head, key)
constexpr int kMaxStages = 4;          // pages in the shared-memory ring
constexpr size_t kMaxSmem = 232448;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// ---------------------------------------------------------------------------
// asynchronous global -> shared copies (sm_80+)
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most n of the most recent groups are in flight (n < 3)
__device__ __forceinline__ void cp_async_wait(int n) {
  if (n <= 0)
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  else if (n == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
}

struct DecodeSmem {                    // byte offsets into dynamic memory
  size_t q, acc, sc, stats, kpos, ids;
  size_t total;
};

// tiles [nst][K, V][P][D] bf16 | q [rep][D] f32 | acc [KS][rep][D] f32 |
// scores [rep][P] f32 | m, l, alpha [3][rep] f32 | positions [chunk][P] i32
// | page ids, flags, visit list [3][chunk] i32 | n_vis, last-block flag
__host__ __device__ inline DecodeSmem decode_smem(int P, int D, int rep,
                                                  int chunk, int nst,
                                                  int KS) {
  DecodeSmem s;
  s.q = (size_t)nst * 2 * P * D * 2;
  s.acc = s.q + (size_t)rep * D * 4;
  s.sc = s.acc + (size_t)KS * rep * D * 4;
  s.stats = s.sc + (size_t)rep * P * 4;
  s.kpos = s.stats + (size_t)3 * rep * 4;
  s.ids = s.kpos + (size_t)chunk * P * 4;
  s.total = s.ids + (size_t)(3 * chunk + 2) * 4;
  return s;
}

// ---------------------------------------------------------------------------
// decode: grid (Hkv, C, S), kDecodeThreads threads.  Split sp covers table
// entries [sp * chunk, min(NB, sp * chunk + chunk)).  With S == 1 the block
// writes out itself; else it writes its partial (m, l) to part_ml and acc to
// part_acc, and the last block of (c, g) combines them.
// ---------------------------------------------------------------------------
template <typename QT>
__global__ void __launch_bounds__(kDecodeThreads)
    paged_decode_kernel(const QT* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k_pool,
                        const __nv_bfloat16* __restrict__ v_pool,
                        const int* __restrict__ pos_pool,
                        const int* __restrict__ page_table,
                        const int* __restrict__ positions,
                        const bool* __restrict__ row_live,
                        float* __restrict__ out, float2* part_ml,
                        float* part_acc, int* tickets, int NB, int P,
                        int Hkv, int D, int rep, int window, float scale,
                        int chunk, int nst, int KS) {
  const int tid = threadIdx.x;
  const int g = blockIdx.x, c = blockIdx.y, sp = blockIdx.z;
  const int H = Hkv * rep;
  const size_t qbase = ((size_t)c * H + (size_t)g * rep) * D;
  if (row_live != nullptr && !row_live[c]) {
    // a masked row: its first split writes zeros for the group's heads;
    // no position scan, no page, no ticket
    if (sp == 0)
      for (int i = tid; i < rep * D; i += kDecodeThreads)
        out[qbase + i] = 0.0f;
    return;
  }
  extern __shared__ __align__(16) unsigned char smem[];
  const DecodeSmem L = decode_smem(P, D, rep, chunk, nst, KS);
  const int tile = P * D;              // bf16 elements of one K or V tile
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(smem);
  float* q_s = reinterpret_cast<float*>(smem + L.q);
  float* acc_s = reinterpret_cast<float*>(smem + L.acc);
  float* sc_s = reinterpret_cast<float*>(smem + L.sc);
  float* m_s = reinterpret_cast<float*>(smem + L.stats);
  float* l_s = m_s + rep;
  float* al_s = l_s + rep;
  int* kpos_s = reinterpret_cast<int*>(smem + L.kpos);
  int* pid_s = reinterpret_cast<int*>(smem + L.ids);
  int* flag_s = pid_s + chunk;
  int* vis_s = flag_s + chunk;
  int* misc = vis_s + chunk;

  const int S = gridDim.z;
  const int pos = positions[c];
  const int* row = page_table + (size_t)c * NB;
  const int e0 = sp * chunk;
  const int ne = min(NB, e0 + chunk) - e0;
  auto admits = [&](int kpos) {
    return kpos <= pos && (window < 0 || kpos > pos - window);
  };

  // the range's page ids; the group's queries as f32; the running state
  for (int e = tid; e < ne; e += kDecodeThreads) {
    pid_s[e] = row[e0 + e];
    flag_s[e] = 0;
  }
  for (int i = tid; i < rep * D; i += kDecodeThreads) {
    q_s[i] = to_float(q[qbase + i]);
  }
  for (int i = tid; i < KS * rep * D; i += kDecodeThreads) acc_s[i] = 0.0f;
  for (int h = tid; h < rep; h += kDecodeThreads) {
    m_s[h] = kNegInf;
    l_s[h] = 0.0f;
  }
  __syncthreads();

  // which pages of the range hold a key the row admits
  int mine = 0;
  for (int i = tid; i < ne * P; i += kDecodeThreads) {
    const int e = i / P;
    const int kp = pos_pool[(size_t)pid_s[e] * P + i % P];
    kpos_s[i] = kp;
    if (admits(kp)) {
      flag_s[e] = 1;
      mine = 1;
    }
  }
  int walk_all = 0, none = 0;
  if (!__syncthreads_or(mine)) {
    // nothing here: does any other entry of the row admit a key?
    int other = 0;
    for (int i = tid; i < (NB - ne) * P; i += kDecodeThreads) {
      const int e = i / P;
      const int j = e < e0 ? e : e + ne;
      other |= admits(pos_pool[(size_t)row[j] * P + i % P]) ? 1 : 0;
    }
    if (__syncthreads_or(other))
      none = 1;                        // this split carries no weight
    else
      walk_all = 1;                    // the row admits no key: average all
  }
  if (tid == 0) {
    int n = 0;
    if (!none)
      for (int e = 0; e < ne; ++e)
        if (walk_all || flag_s[e]) vis_s[n++] = e;
    misc[0] = n;
  }
  __syncthreads();
  const int n_vis = misc[0];

  const size_t page_elems = (size_t)P * Hkv * D;
  const int chunks = D / 8;            // 16-byte chunks per K/V row
  auto stage = [&](int j, int b) {     // the j-th visited page into buffer b
    const size_t base =
        (size_t)pid_s[vis_s[j]] * page_elems + (size_t)g * D;
    __nv_bfloat16* kd = tiles + 2 * b * tile;
    __nv_bfloat16* vd = kd + tile;
    for (int t = tid; t < P * chunks; t += kDecodeThreads) {
      const int p = t / chunks, ch = t % chunks;
      const size_t src = base + (size_t)p * Hkv * D + ch * 8;
      cp_async16(kd + t * 8, k_pool + src);
      cp_async16(vd + t * 8, v_pool + src);
    }
  };
  for (int st = 0; st < nst - 1; ++st) {
    if (st < n_vis) stage(st, st);
    cp_async_commit();
  }

  const int grp = tid / kLanesPerKey, sub = tid % kLanesPerKey;
  constexpr int kGroups = kDecodeThreads / kLanesPerKey;
  const int pairs = rep * P;
  const int half = D / 2, items = rep * half;
  float2* acc2 = reinterpret_cast<float2*>(acc_s);
  for (int j = 0; j < n_vis; ++j) {
    cp_async_wait(nst - 2);            // page j has landed
    __syncthreads();                   // for every thread; page j-1 is read
    if (j + nst - 1 < n_vis) stage(j + nst - 1, (j + nst - 1) % nst);
    cp_async_commit();
    const __nv_bfloat16* ks = tiles + 2 * (j % nst) * tile;
    const __nv_bfloat16* vs = ks + tile;
    const int* kp = kpos_s + vis_s[j] * P;

    // scores: 8 lanes a (head, key) pair, 16 pairs at once
    for (int base = 0; base < pairs; base += kGroups) {
      const int it = base + grp;
      float part = 0.0f;
      if (it < pairs) {
        const int h = it / P, p = it % P;
        for (int ch = sub; ch < chunks; ch += kLanesPerKey) {
          const uint4 kv =
              *reinterpret_cast<const uint4*>(ks + p * D + ch * 8);
          const float4 qa =
              *reinterpret_cast<const float4*>(q_s + h * D + ch * 8);
          const float4 qb =
              *reinterpret_cast<const float4*>(q_s + h * D + ch * 8 + 4);
          const uint32_t w[4] = {kv.x, kv.y, kv.z, kv.w};
          const float qq[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            part += qq[2 * u] * __uint_as_float(w[u] << 16);
            part += qq[2 * u + 1] * __uint_as_float(w[u] & 0xffff0000u);
          }
        }
      }
#pragma unroll
      for (int o = kLanesPerKey / 2; o > 0; o >>= 1)
        part += __shfl_xor_sync(kFullMask, part, o);
      if (it < pairs && sub == 0)
        sc_s[it] = part * scale + (admits(kp[it % P]) ? 0.0f : kNegInf);
    }
    __syncthreads();

    // online softmax across pages, one thread a head
    for (int h = tid; h < rep; h += kDecodeThreads) {
      float* sh = sc_s + h * P;
      float m_new = m_s[h];
      for (int p = 0; p < P; ++p) m_new = fmaxf(m_new, sh[p]);
      const float alpha = expf(m_s[h] - m_new);
      float psum = 0.0f;
      for (int p = 0; p < P; ++p) {
        const float e = expf(sh[p] - m_new);
        sh[p] = e;
        psum += e;
      }
      l_s[h] = l_s[h] * alpha + psum;
      m_s[h] = m_new;
      al_s[h] = alpha;
    }
    __syncthreads();

    // acc = acc * alpha + sum_p e_p v_p: a thread a (key subset, head,
    // column pair); key subset u takes keys u, u + KS, ...
    for (int it = tid; it < KS * items; it += kDecodeThreads) {
      const int u = it / items, r = it % items;
      const int h = r / half, d2 = r % half;
      const float alpha = al_s[h];
      float2 a = acc2[it];
      a.x *= alpha;
      a.y *= alpha;
      const float* eh = sc_s + h * P;
      for (int p = u; p < P; p += KS) {
        const float e = eh[p];
        const __nv_bfloat162 vv =
            *reinterpret_cast<const __nv_bfloat162*>(vs + p * D + 2 * d2);
        a.x += e * __low2float(vv);
        a.y += e * __high2float(vv);
      }
      acc2[it] = a;
    }
  }
  cp_async_wait(0);
  __syncthreads();

  // this split's (m, l, acc); the key subsets summed in order
  if (S == 1) {
    for (int i = tid; i < rep * D; i += kDecodeThreads) {
      const int h = i / D;
      float a = 0.0f;
      for (int u = 0; u < KS; ++u) a += acc_s[u * rep * D + i];
      const float l = l_s[h];
      out[qbase + i] = a / (l == 0.0f ? 1.0f : l);
    }
    return;
  }
  for (int i = tid; i < rep * D; i += kDecodeThreads) {
    const int h = i / D, d = i % D;
    float a = 0.0f;
    for (int u = 0; u < KS; ++u) a += acc_s[u * rep * D + i];
    part_acc[(((size_t)c * H + g * rep + h) * S + sp) * D + d] = a;
  }
  for (int h = tid; h < rep; h += kDecodeThreads)
    part_ml[((size_t)c * H + g * rep + h) * S + sp] =
        make_float2(m_s[h], l_s[h]);
  __threadfence();                     // the partial is visible device-wide
  __syncthreads();                     // ... before the ticket is taken
  if (tid == 0) {
    const int t = atomicAdd(tickets + (size_t)c * Hkv + g, 1);
    misc[1] = t == S - 1;
  }
  __syncthreads();
  if (!misc[1]) return;
  __threadfence();

  // the last block: combine the S partials in split order
  for (int i = tid; i < rep * D; i += kDecodeThreads) {
    const int h = i / D, d = i % D;
    const size_t hrow = (size_t)c * H + g * rep + h;
    const float2* ml = part_ml + hrow * S;
    float M = kNegInf;
    for (int s = 0; s < S; ++s) M = fmaxf(M, __ldcg(&ml[s].x));
    float Lsum = 0.0f, A = 0.0f;
    for (int s = 0; s < S; ++s) {
      const float2 v = __ldcg(ml + s);
      const float w = expf(v.x - M);
      Lsum += w * v.y;
      A += w * __ldcg(part_acc + (hrow * S + s) * D + d);
    }
    out[hrow * D + d] = A / (Lsum == 0.0f ? 1.0f : Lsum);
  }
  if (tid == 0) tickets[(size_t)c * Hkv + g] = 0;   // ready for the next call
}

template <typename QT>
int launch_decode(const void* q, const void* k_pool, const void* v_pool,
                  const void* pos_pool, const void* page_table,
                  const void* positions, const void* row_live, void* out,
                  void* part_ml, void* part_acc, void* tickets, int C, int NB,
                  int P, int Hkv, int D, int rep, int window, float scale,
                  int chunk, cudaStream_t s) {
  // key subsets of the weighted sum: enough (head, column pair, subset)
  // items for every thread of the block
  const int pairs = rep * D / 2;
  int KS = pairs < kDecodeThreads ? kDecodeThreads / pairs : 1;
  if (KS > P) KS = P;
  int nst = kMaxStages;
  while (nst > 2 && decode_smem(P, D, rep, chunk, nst, KS).total > kMaxSmem)
    --nst;
  const size_t smem = decode_smem(P, D, rep, chunk, nst, KS).total;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = paged_decode_kernel<QT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int S = (NB + chunk - 1) / chunk;
  const dim3 grid((unsigned)Hkv, (unsigned)C, (unsigned)S);
  kernel<<<grid, kDecodeThreads, smem, s>>>(
      static_cast<const QT*>(q), static_cast<const __nv_bfloat16*>(k_pool),
      static_cast<const __nv_bfloat16*>(v_pool),
      static_cast<const int*>(pos_pool), static_cast<const int*>(page_table),
      static_cast<const int*>(positions), static_cast<const bool*>(row_live),
      static_cast<float*>(out),
      static_cast<float2*>(part_ml), static_cast<float*>(part_acc),
      static_cast<int*>(tickets), NB, P, Hkv, D, rep, window, scale, chunk,
      nst, KS);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// scatter / admission: grid (page j, stage s, K or V).  Page j of the ring
// holds positions j * P .. j * P + P - 1; the first `live` of them are the
// ring's, the rest are written as zeros (positions as pos_fill).
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
__device__ __forceinline__ uint4 load8(const VT* p) {
  if constexpr (sizeof(VT) == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    return pack8(v);
  } else {
    return *reinterpret_cast<const uint4*>(p);
  }
}

// one thread: `bytes` from src to dst through the shared-memory stage, a
// bulk load completing on the mbarrier, then a bulk store; the stage is
// reused only once the store has read it
__device__ __forceinline__ void bulk_move(void* dst, const void* src,
                                          long long bytes, void* stage,
                                          unsigned long long* bar) {
  const uint32_t s_stage = (uint32_t)__cvta_generic_to_shared(stage);
  const uint32_t s_bar = (uint32_t)__cvta_generic_to_shared(bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(s_bar)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  uint32_t phase = 0;
  for (long long off = 0; off < bytes; off += kBulkBytes, phase ^= 1u) {
    const uint32_t n = (uint32_t)min((long long)kBulkBytes, bytes - off);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(s_bar), "r"(n) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];"
        :: "r"(s_stage), "l"(static_cast<const char*>(src) + off), "r"(n),
           "r"(s_bar) : "memory");
    asm volatile(
        "{\n"
        ".reg .pred ready;\n"
        "WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 ready, [%0], %1;\n"
        "@!ready bra WAIT;\n"
        "}\n" :: "r"(s_bar), "r"(phase) : "memory");
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                 :: "l"(static_cast<char*>(dst) + off), "r"(s_stage), "r"(n)
                 : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

template <typename VT>
__global__ void __launch_bounds__(kAdmitThreads)
paged_admit_kernel(__nv_bfloat16* __restrict__ pool_k,
                   __nv_bfloat16* __restrict__ pool_v,
                   long long pool_stage_stride, const VT* __restrict__ src_k,
                   const VT* __restrict__ src_v, long long src_stage_stride,
                   const int* __restrict__ pages, int P, long long row,
                   int ring, int* __restrict__ pos_pool,
                   const int* __restrict__ pos_src, int pos_fill) {
  extern __shared__ __align__(128) unsigned char s_stage[];
  __shared__ __align__(8) unsigned long long s_bar;
  const int j = blockIdx.x, s = blockIdx.y;
  const bool is_v = blockIdx.z != 0;
  const long long E = (long long)P * row;
  const int page = pages[j];
  const int live = min(P, ring - j * P);         // ring positions on the page
  __nv_bfloat16* dst = (is_v ? pool_v : pool_k) + s * pool_stage_stride +
                       (long long)page * E;
  const VT* src = (is_v ? src_v : src_k) + s * src_stage_stride +
                  (long long)j * E;

  if (pos_pool != nullptr && s == 0 && !is_v)
    for (int p = threadIdx.x; p < P; p += kAdmitThreads)
      pos_pool[(long long)page * P + p] = p < live ? pos_src[j * P + p]
                                                   : pos_fill;
  if constexpr (sizeof(VT) == 2) {
    if (live == P) {
      if (threadIdx.x == 0) bulk_move(dst, src, E * 2, s_stage, &s_bar);
      return;
    }
  }
  const long long n_live = (long long)live * row;    // the rest are zeros
  for (long long e0 = (long long)threadIdx.x * 8; e0 < E;
       e0 += (long long)kAdmitThreads * 8 * kAdmitPieces) {
    uint4 v[kAdmitPieces];
#pragma unroll
    for (int u = 0; u < kAdmitPieces; ++u) {
      const long long e = e0 + (long long)u * kAdmitThreads * 8;
      v[u] = e < n_live ? load8(src + e) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kAdmitPieces; ++u) {
      const long long e = e0 + (long long)u * kAdmitThreads * 8;
      if (e < E) *reinterpret_cast<uint4*>(dst + e) = v[u];
    }
  }
}

template <typename VT>
int launch_admit(void* pool_k, void* pool_v, int kinds,
                 long long pool_stage_stride, const void* src_k,
                 const void* src_v, long long src_stage_stride,
                 const void* pages, int S, int nb, int P, long long row,
                 int ring, void* pos_pool, const void* pos_src, int pos_fill,
                 cudaStream_t s) {
  const dim3 grid((unsigned)nb, (unsigned)S, (unsigned)kinds);
  const long long block_bytes = (long long)P * row * 2;
  const size_t smem = sizeof(VT) != 2 ? 0
      : (size_t)(block_bytes < kBulkBytes ? block_bytes : kBulkBytes);
  paged_admit_kernel<VT><<<grid, kAdmitThreads, smem, s>>>(
      static_cast<__nv_bfloat16*>(pool_k), static_cast<__nv_bfloat16*>(pool_v),
      pool_stage_stride, static_cast<const VT*>(src_k),
      static_cast<const VT*>(src_v), src_stage_stride,
      static_cast<const int*>(pages), P, row, ring,
      static_cast<int*>(pos_pool), static_cast<const int*>(pos_src), pos_fill);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q: (C, H, D) float32 (q_bf16 == 0) or bfloat16, contiguous; k_pool/v_pool:
// (NP, P, Hkv, D) bfloat16, contiguous; pos_pool: (NP, P) int32; page_table:
// (C, NB) int32; positions: (C,) int32; row_live: (C,) bool or null (every
// row live); out: (C, H, D) float32.  A row whose row_live is false is not
// read: its output is zeros.  window < 0 means no sliding window.  The walk
// is split into ceil(NB / chunk) ranges of `chunk` table entries; with more
// than one, part_ml (C * H * splits float2), part_acc (C * H * splits * D
// float32) and tickets (C * Hkv int32, all 0, and left 0) are the scratch
// the splits combine through.  The caller guarantees D % 8 == 0 and 16-byte
// aligned pools.
int paged_attention_decode_launch(const void* q, int q_bf16,
                                  const void* k_pool, const void* v_pool,
                                  const void* pos_pool, const void* page_table,
                                  const void* positions, const void* row_live,
                                  void* out, void* part_ml, void* part_acc,
                                  void* tickets, int C, int NB, int P,
                                  int Hkv, int D, int rep, int window,
                                  float scale, int chunk, void* stream) {
  if (C <= 0 || Hkv <= 0) return (int)cudaSuccess;
  if (NB <= 0 || P <= 0 || D <= 0 || D > 256 || D % 8 || rep <= 0 ||
      rep > 32 || Hkv > 65535 || C > 65535 || chunk <= 0 ||
      (NB + chunk - 1) / chunk > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_bf16)
    return launch_decode<__nv_bfloat16>(
        q, k_pool, v_pool, pos_pool, page_table, positions, row_live, out,
        part_ml, part_acc, tickets, C, NB, P, Hkv, D, rep, window, scale,
        chunk, s);
  return launch_decode<float>(q, k_pool, v_pool, pos_pool, page_table,
                              positions, row_live, out, part_ml, part_acc,
                              tickets, C, NB, P, Hkv, D, rep, window, scale,
                              chunk, s);
}


// Admission of one attention sub-layer, and the scatter.  k_pool / v_pool:
// S stages of (NP, P, Hkv, D) bfloat16 blocks, one stage stride for both,
// each stage contiguous; v_pool null writes k_pool alone (the scatter,
// v_src unused).  k_src / v_src: S stages of the dense (ring, Hkv, D)
// prefill cache, float32 (src_bf16 == 0) or bfloat16, one stage stride,
// each stage contiguous; pages: (nb,) int32 with (nb - 1) * P < ring <=
// nb * P (the scatter: ring = nb * P).  pos_pool: (NP, P) int32 or null
// (then no positions are written); pos_src: (ring,) int32.  row = Hkv * D.
// The caller guarantees row and both strides % 8 == 0 and 16-byte aligned
// pointers.
int paged_admit_kv_launch(void* k_pool, void* v_pool,
                          long long pool_stage_stride,
                          const void* k_src, const void* v_src, int src_bf16,
                          long long src_stage_stride, const void* pages,
                          int S, int nb, int P, long long row, int ring,
                          void* pos_pool, const void* pos_src, int pos_fill,
                          void* stream) {
  if (S <= 0 || nb <= 0) return (int)cudaSuccess;
  if (S > 65535 || P <= 0 || row <= 0 || row % 8 || ring > nb * P ||
      ring <= (nb - 1) * P)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kinds = v_pool == nullptr ? 1 : 2;
  if (src_bf16)
    return launch_admit<__nv_bfloat16>(k_pool, v_pool, kinds,
                                       pool_stage_stride, k_src, v_src,
                                       src_stage_stride, pages, S, nb, P, row,
                                       ring, pos_pool, pos_src, pos_fill, s);
  return launch_admit<float>(k_pool, v_pool, kinds, pool_stage_stride, k_src,
                             v_src, src_stage_stride, pages, S, nb, P, row,
                             ring, pos_pool, pos_src, pos_fill, s);
}

}  // extern "C"
