// Mamba-2 SSD chunked scan for the serving path, NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernel of the JAX package's repro/kernels/ssd_scan.py
// (`_kernel`, entry ssd_chunked_pallas).  For one (batch row, head) and a
// sequence cut into chunks of Q steps, per chunk:
//
//   a_cum = inclusive cumsum of a over the chunk, a_tot = a_cum[Q-1]
//   intra:  y[l]  = sum_{s <= l} (C[l].B[s]) exp(a_cum[l] - a_cum[s]) dt[s] x[s]
//   carry:  y[l] += exp(a_cum[l]) (C[l] . h)          (h: the state before)
//   state:  h     = exp(a_tot) h + sum_s x[s] (dt[s] exp(a_tot - a_cum[s])) B[s]
//
// with x (P per step), B and C (N per step), h (P x N), everything in float32
// -- the contract of kernels/ref.ssd_chunked_ref.
//
// What bounds it on this card: operations.  At the serving path's shape
// (8 rows x 80 heads, two chunks of 256 steps, P 64, N 128) the causal half
// of C.B^T, the product with x, the carried-state term and the state update
// are ~21 MFLOP per (head, chunk), ~27 GFLOP per launch, against ~0.1 GB of
// bytes: plain float32 FMAs, no tensor cores (TF32 keeps ~3 digits; the
// reference's tolerance is 1e-4).
//
// What the design does about it:
//   * The TPU grid's sequential chunk axis becomes a loop inside the block:
//     one block per (row, head) walks its chunks in order, the P x N state
//     staying in shared memory (h^T, 32 KB) from the first chunk to the last.
//     Blocks carry nothing between them.
//   * A chunk's Q x Q matrices (256 KB at Q 256) never exist: the output rows
//     l are cut into tiles of 64, and for each l-tile the source tiles s <= l
//     are walked, each giving a 64 x 64 tile of C.B^T (N-long dot products
//     from C and B tiles staged transposed in shared memory), masked and
//     scaled in registers, then multiplied into the l-tile's y, accumulated
//     in registers.  Tiles above the diagonal are skipped.
//   * The masked half is a select: exp(a_cum[l] - a_cum[s]) is computed only
//     where s <= l.  Above the diagonal the exponent is positive and can
//     overflow; a product with a 0/1 mask would give inf * 0 = NaN.
//   * a_cum is summed in order by one thread (Q adds per chunk): the order
//     differs from torch.cumsum's, and exp(a_cum[l] - a_cum[s]) amplifies
//     that difference, hence the 1e-4 tolerance of the reference.
//   * 256 threads as a 16 x 16 grid, each owning a 4 x 4 block of every
//     64 x 64 product (rows ty + 16 i, columns tx + 16 j); tiles that are
//     read along their other axis are stored transposed with a padded row of
//     65 floats, so the inner loops read shared memory without bank
//     conflicts.  ~134 KB of dynamic shared memory: one block per SM.
//   * x, B and C are read through the strides they are given: x may be a
//     view into the conv output, and B and C a stride-0 view over heads (one
//     group's projection shared by every head) -- no copy is made of them.
//     Inputs in float32 or bfloat16 (x, B and C of one type), dt and a in
//     float32, y written in x's type (round to nearest even), the state in
//     float32.
//   * Parallelism is (rows x heads) blocks: 640 at the serving path's
//     prefill width of 8, 80 for a single admission.  Splitting P across
//     blocks is left for a later version.
//
// Plain C interface: the entry launches on the stream it is given,
// allocates nothing, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;            // rows of an l-tile and of an s-tile
constexpr int kPMax = 64;         // head size P the thread grid covers
constexpr int kNMax = 128;        // state size N the thread grid covers
constexpr int kLd = kT + 1;       // padded row of a transposed tile
constexpr int kGrid = 16;         // threads per side of the 16 x 16 grid
constexpr int kThreads = kGrid * kGrid;
constexpr size_t kMaxSmem = 232448;   // what one block may have on sm_90

struct Strides {                  // in elements; the last axis is contiguous
  long long xb, xl, xh;           // x  (b, L, H, P)
  long long db, dl, dh;           // dt (b, L, H)
  long long ab, al, ah;           // a  (b, L, H)
  long long bb, bl, bh;           // B  (b, L, H, N); bh may be 0
  long long cb, cl, ch;           // C  (b, L, H, N); ch may be 0
};

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

size_t smem_bytes(int Q) {
  return sizeof(float) * ((size_t)3 * kNMax * kLd + (size_t)kT * kPMax +
                          (size_t)kT * kLd + (size_t)4 * Q);
}

// rows [r0, r0 + kT) of the chunk starting at sequence row l0, transposed:
// dst[n * kLd + r]; rows past the chunk's Q are zero
template <typename IT>
__device__ __forceinline__ void load_rows_t(float* dst, const IT* src,
                                            long long row_stride, int l0,
                                            int r0, int Q, int N) {
  for (int e = threadIdx.x; e < kT * N; e += kThreads) {
    const int r = e / N, n = e % N;
    const int q = r0 + r;
    dst[n * kLd + r] =
        q < Q ? ld(src + (long long)(l0 + q) * row_stride + n) : 0.0f;
  }
}

// the same rows of x, as they are: dst[r * kPMax + p]
template <typename IT>
__device__ __forceinline__ void load_rows(float* dst, const IT* src,
                                          long long row_stride, int l0,
                                          int r0, int Q, int P) {
  for (int e = threadIdx.x; e < kT * P; e += kThreads) {
    const int r = e / P, p = e % P;
    const int q = r0 + r;
    dst[r * kPMax + p] =
        q < Q ? ld(src + (long long)(l0 + q) * row_stride + p) : 0.0f;
  }
}

// grid (b * H): one block per (batch row, head), kThreads threads
template <typename IT>
__global__ void __launch_bounds__(kThreads)
    ssd_chunked_kernel(const IT* __restrict__ x, const float* __restrict__ dt,
                       const float* __restrict__ a,
                       const IT* __restrict__ Bm, const IT* __restrict__ Cm,
                       const float* __restrict__ h0, IT* __restrict__ y,
                       float* __restrict__ hout, Strides sd, int H, int L,
                       int Q, int P, int N) {
  extern __shared__ float sm[];
  float* hT = sm;                    // [kNMax][kLd] state, hT[n * kLd + p]
  float* Ct = hT + kNMax * kLd;      // [kNMax][kLd] C tile, Ct[n * kLd + l]
  float* Bt = Ct + kNMax * kLd;      // [kNMax][kLd] B tile, Bt[n * kLd + s]
  float* xs = Bt + kNMax * kLd;      // [kT][kPMax] x tile, xs[s * kPMax + p]
  float* Ms = xs + kT * kPMax;       // [kT][kLd] masked M, Ms[s * kLd + l]
  float* acum = Ms + kT * kLd;       // [Q] inclusive cumsum of a
  float* dts = acum + Q;             // [Q] dt
  float* eac = dts + Q;              // [Q] exp(a_cum)
  float* wst = eac + Q;              // [Q] dt * exp(a_tot - a_cum)

  const int tid = threadIdx.x;
  const int tx = tid % kGrid, ty = tid / kGrid;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const IT* xr = x + b * sd.xb + h * sd.xh;
  const float* dtr = dt + b * sd.db + h * sd.dh;
  const float* ar = a + b * sd.ab + h * sd.ah;
  const IT* Br = Bm + b * sd.bb + h * sd.bh;
  const IT* Cr = Cm + b * sd.cb + h * sd.ch;

  for (int e = tid; e < P * N; e += kThreads) {
    const int p = e / N, n = e % N;
    hT[n * kLd + p] = h0 ? h0[((long long)bh * P + p) * N + n] : 0.0f;
  }

  const int n_chunks = L / Q;
  const int n_tiles = (Q + kT - 1) / kT;
  for (int c = 0; c < n_chunks; ++c) {
    const int l0 = c * Q;
    __syncthreads();                 // the last chunk is done with its arrays
    for (int i = tid; i < Q; i += kThreads) {
      dts[i] = dtr[(long long)(l0 + i) * sd.dl];
      acum[i] = ar[(long long)(l0 + i) * sd.al];
    }
    __syncthreads();
    if (tid == 0) {                  // inclusive prefix sum, in order
      float run = 0.0f;
      for (int i = 0; i < Q; ++i) {
        run += acum[i];
        acum[i] = run;
      }
    }
    __syncthreads();
    const float a_tot = acum[Q - 1];
    for (int i = tid; i < Q; i += kThreads) {
      eac[i] = expf(acum[i]);
      wst[i] = expf(a_tot - acum[i]) * dts[i];
    }

    // ---- y, one l-tile at a time (read before the state moves on) -------
    for (int il = 0; il < n_tiles; ++il) {
      const int lt = il * kT;
      load_rows_t(Ct, Cr, sd.cl, l0, lt, Q, N);
      float yacc[4][4] = {};
      for (int js = 0; js <= il; ++js) {       // tiles above l are all zero
        const int stt = js * kT;
        __syncthreads();             // the last s-tile's readers are done
        load_rows_t(Bt, Br, sd.bl, l0, stt, Q, N);
        load_rows(xs, xr, sd.xl, l0, stt, Q, P);
        __syncthreads();
        float cb[4][4] = {};
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = Ct[n * kLd + ty + kGrid * i];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = Bt[n * kLd + tx + kGrid * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              cb[i][j] = fmaf(cv[i], bv[j], cb[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int l = lt + ty + kGrid * i, s = stt + tx + kGrid * j;
            float m = 0.0f;          // a select: exp only where s <= l
            if (s <= l && l < Q)
              m = cb[i][j] * expf(acum[l] - acum[s]) * dts[s];
            Ms[(tx + kGrid * j) * kLd + ty + kGrid * i] = m;
          }
        __syncthreads();
        for (int s = 0; s < kT; ++s) {
          float mv[4], xv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) mv[i] = Ms[s * kLd + ty + kGrid * i];
#pragma unroll
          for (int j = 0; j < 4; ++j) xv[j] = xs[s * kPMax + tx + kGrid * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              yacc[i][j] = fmaf(mv[i], xv[j], yacc[i][j]);
        }
      }
      // the carried state's term, exp(a_cum[l]) * (C[l] . h)
      float yo[4][4] = {};
      for (int n = 0; n < N; ++n) {
        float cv[4], hv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = Ct[n * kLd + ty + kGrid * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) hv[j] = hT[n * kLd + tx + kGrid * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) yo[i][j] = fmaf(cv[i], hv[j], yo[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int l = lt + ty + kGrid * i;
        if (l >= Q) continue;
        IT* yrow = y + (((long long)b * L + l0 + l) * H + h) * P;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tx + kGrid * j;
          if (p < P) st(yrow + p, yacc[i][j] + eac[l] * yo[i][j]);
        }
      }
      __syncthreads();               // Ct is read up to here
    }

    // ---- the state update over every s-tile of the chunk -----------------
    float sacc[4][8] = {};           // p = ty + 16 i, n = tx + 16 j
    for (int js = 0; js < n_tiles; ++js) {
      const int stt = js * kT;
      __syncthreads();
      load_rows_t(Bt, Br, sd.bl, l0, stt, Q, N);
      load_rows(xs, xr, sd.xl, l0, stt, Q, P);
      __syncthreads();
      const int s_end = min(kT, Q - stt);
      for (int s = 0; s < s_end; ++s) {
        const float w = wst[stt + s];
        float xv[4], bv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = xs[s * kPMax + ty + kGrid * i] * w;
#pragma unroll
        for (int j = 0; j < 8; ++j) bv[j] = Bt[(tx + kGrid * j) * kLd + s];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            sacc[i][j] = fmaf(xv[i], bv[j], sacc[i][j]);
      }
    }
    // every reader of the state (the carried-state term) passed the
    // barriers of the loop above
    const float decay = expf(a_tot);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int p = ty + kGrid * i, n = tx + kGrid * j;
        if (p < P && n < N)
          hT[n * kLd + p] = decay * hT[n * kLd + p] + sacc[i][j];
      }
  }

  __syncthreads();
  for (int e = tid; e < P * N; e += kThreads) {
    const int p = e / N, n = e % N;
    hout[((long long)bh * P + p) * N + n] = hT[n * kLd + p];
  }
}

template <typename IT>
int launch(const void* x, const void* dt, const void* a, const void* B,
           const void* C, const void* h0, void* y, void* hout, int b, int L,
           int H, int P, int N, int Q, const Strides& sd, cudaStream_t s) {
  const size_t smem = smem_bytes(Q);
  auto kernel = ssd_chunked_kernel<IT>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)(b * H), kThreads, smem, s>>>(
      static_cast<const IT*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const IT*>(B),
      static_cast<const IT*>(C), static_cast<const float*>(h0),
      static_cast<IT*>(y), static_cast<float*>(hout), sd, H, L, Q, P, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (b, L, H, P) float32 (in_bf16 == 0) or bfloat16; dt, a: (b, L, H)
// float32; B, C: (b, L, H, N) of x's type; h0: (b, H, P, N) float32,
// contiguous, or null for a zero initial state; y: (b, L, H, P) of x's type,
// contiguous; hout: (b, H, P, N) float32, contiguous.  strides: 15 element
// strides, (batch, step, head) of x, dt, a, B and C in that order; the last
// axis of x, B and C is contiguous.  Needs L % Q == 0, P <= 64, N <= 128.
int ssd_chunked_launch(const void* x, const void* dt, const void* a,
                       const void* B, const void* C, const void* h0, void* y,
                       void* hout, int in_bf16, int b, int L, int H, int P,
                       int N, int Q, const long long* strides, void* stream) {
  if (b <= 0 || H <= 0 || L <= 0) return (int)cudaSuccess;
  if (Q <= 0 || L % Q || P <= 0 || P > kPMax || N <= 0 || N > kNMax ||
      (long long)b * H > 0x7fffffffLL || smem_bytes(Q) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const Strides sd = {strides[0],  strides[1],  strides[2],  strides[3],
                      strides[4],  strides[5],  strides[6],  strides[7],
                      strides[8],  strides[9],  strides[10], strides[11],
                      strides[12], strides[13], strides[14]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16)
    return launch<__nv_bfloat16>(x, dt, a, B, C, h0, y, hout, b, L, H, P, N,
                                 Q, sd, s);
  return launch<float>(x, dt, a, B, C, h0, y, hout, b, L, H, P, N, Q, sd, s);
}

}  // extern "C"
