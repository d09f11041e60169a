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
// -- the contract of kernels/ref.ssd_chunked_ref.  Two kernels, picked by
// the inputs' type (nothing routes a failed launch to the other):
//
// * bfloat16 -- `ssd_chunked_mma_kernel`, on the tensor cores.  What bounds
//   it: bytes.  At the serving path's prefill (8 rows x 80 heads, two chunks
//   of 256, P 64, N 128, B and C one group viewed over the heads) the
//   function moves ~110 MB (x and y 84 MB, the state 21 MB) -- 0.033 ms at
//   3.35 TB/s -- against 27 GFLOP, 0.028 ms at the bf16 tensor rate.  The
//   design, on `mma.sync.m16n8k16` (bf16 x bf16 -> f32, mma_bf16.cuh):
//     - a block takes one row, a tile of HT heads (2 when B and C are one
//       group's stride-0 view and the grid still fills the card, else 1)
//       and 32 columns of P; it walks the chunks in order, its slice of the
//       state (HT x 32 x N float32) in the mma accumulators of its 4 warps
//       from the first chunk to the last.  Grid (P / 32, H / HT, rows): 640
//       blocks at the path's width 8 (HT 2), 160 at width 1 (HT 1);
//     - a chunk's rows are cut into 64-row l-tiles, 16 rows a warp; for each
//       l-tile the s-tiles s <= l stream through a 2-stage `cp.async` ring
//       (B and each head's x, bf16, 16-byte copies, zero-filled past Q, N
//       and P, rows padded to an odd multiple of 16 bytes so `ldmatrix` is
//       conflict-free).  C B^T of a (l-tile, s-tile) pair is formed once, in
//       f32 accumulators (exact: products of two bf16), and serves every
//       head of the tile; on the diagonal a warp skips the key columns past
//       its rows;
//     - M = C B^T . decay . dt is formed in registers from the accumulators
//       and re-packed as the A fragment of M x (`ldmatrix.trans` for x).
//       Off the diagonal the decay factors exactly, exp2(A[l] - A[m]) *
//       exp2(A[m] - A[s]) with m the s-tile's last step (both <= 1, no
//       overflow), and the column factor dt[s] exp2(A[m] - A[s]) is computed
//       once a chunk: ~Q exponentials a head where a per-pair exponential
//       would take Q^2 / 2.  On the diagonal exp2 is taken only where
//       s <= l (a select: above it the exponent is positive and may
//       overflow);
//     - the f32 operands of the three products -- M, the carried state h
//       and the weighted x^T of the state update -- go in split, v = hi + lo
//       with hi = bf16(v) and lo = bf16(v - hi), both products summed in the
//       f32 accumulator (~2^-17 relative error where one rounding leaves
//       2^-9).  x, B and C enter as they are;
//     - the state update of each s-tile rides on its diagonal pair (the tile
//       is in the ring then), into the accumulators that hold the state;
//       the state before the chunk, which the carried-state term reads, is
//       kept in shared memory as bf16 hi + lo rows;
//     - the chunk's cumulative sum is a warp scan per head (shuffles), in
//       the log2 domain; its order differs from torch.cumsum's (the float32
//       hold of 1e-4 allows for that).
//     ~109 KB of dynamic shared memory at Q 256 and HT 2: two blocks an SM.
// * float32 -- `ssd_chunked_kernel`, the SIMT kernel, plain float32 FMAs
//   (the reduced configs and the float32 holds run it; TF32 would miss the
//   reference's 1e-4): one block per (row, head) walks its chunks in order,
//   the P x N state in shared memory (h^T, 32 KB); a chunk's Q x Q matrices
//   never exist -- output rows and source columns are cut into 64-row tiles,
//   tiles above the diagonal skipped, each 64 x 64 tile of C B^T masked by a
//   select and multiplied into the output tile in registers; 256 threads as
//   a 16 x 16 grid, each owning a 4 x 4 block of every 64 x 64 product,
//   tiles read along their other axis stored transposed with a padded row
//   of 65 floats (~134 KB, one block an SM); a_cum summed in order by one
//   thread.
//
// Both kernels read x, B and C through the strides they are given: x may be
// a view into the conv output, and B and C a stride-0 view over heads (one
// group's projection shared by every head) -- no copy is made of them.  dt
// and a are float32, y is written in x's type (round to nearest even), the
// state in float32.
//
// Plain C interface: the entry launches on the stream it is given,
// allocates nothing, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

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
__device__ __forceinline__ void st(float* p, float v) { *p = v; }

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


// ===========================================================================
// bfloat16: the tensor-core kernel
// ===========================================================================
using namespace mma_bf16;
using bf16 = __nv_bfloat16;

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kPT = 32;                 // columns of P a block owns
constexpr int kLdN = kNMax + 8;         // a bf16 row of a B, C or h tile
constexpr int kLdX = kPT + 8;           // a bf16 row of an x tile
constexpr float kLog2e = 1.4426950408889634f;

size_t mma_smem_bytes(int HT, int Q) {
  const size_t qpad = (size_t)(Q + kT - 1) / kT * kT;
  return sizeof(float) * 3 * HT * qpad +              // A, dt, column factor
         sizeof(bf16) * ((size_t)3 * kT * kLdN +      // C tile, B ring
                         (size_t)2 * HT * kT * kLdX + // x ring
                         (size_t)2 * HT * kPT * kLdN);  // h before: hi, lo
}

// grid (ceil(P / 32), ceil(H / HT), b), kMmaThreads threads.  vec: every
// row of x, B and C starts on 16 bytes and P, N are multiples of 8 (the
// tiles are then copied 16 bytes at a time by cp.async).
template <int HT>
__global__ void __launch_bounds__(kMmaThreads, 2)
    ssd_chunked_mma_kernel(const bf16* __restrict__ x,
                           const float* __restrict__ dt,
                           const float* __restrict__ a,
                           const bf16* __restrict__ Bm,
                           const bf16* __restrict__ Cm,
                           const float* __restrict__ h0,
                           bf16* __restrict__ y, float* __restrict__ hout,
                           Strides sd, int H, int L, int Q, int P, int N,
                           int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Qpad = (Q + kT - 1) / kT * kT;
  float* A2 = reinterpret_cast<float*>(smem_raw);  // [HT][Qpad] log2 a_cum
  float* dts = A2 + HT * Qpad;                     // [HT][Qpad] dt
  float* colw = dts + HT * Qpad;                   // [HT][Qpad] column factor
  bf16* Cs = reinterpret_cast<bf16*>(colw + HT * Qpad);  // [64][kLdN]
  bf16* Bs = Cs + kT * kLdN;                       // [2][64][kLdN]
  bf16* Xs = Bs + 2 * kT * kLdN;                   // [2][HT][64][kLdX]
  bf16* Hhi = Xs + 2 * HT * kT * kLdX;             // [HT][32][kLdN]
  bf16* Hlo = Hhi + HT * kPT * kLdN;               // [HT][32][kLdN]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;     // quad and lane in quad
  const int p0 = blockIdx.x * kPT;
  const int hb = blockIdx.y * HT;
  const int b = blockIdx.z;
  const int nh = min(HT, H - hb);            // heads of this (ragged) tile
  const int nks = (N + 15) / 16;             // k-steps over the state
  const int nt = Qpad / kT;                  // l- and s-tiles of a chunk
  const int n_chunks = L / Q;
  const bf16* Bb = Bm + b * sd.bb + hb * sd.bh;   // HT > 1 only if bh == 0
  const bf16* Cb = Cm + b * sd.cb + hb * sd.ch;

  // rows [row0, row0 + 64) of a chunk's (steps, cols) slice: `cols` valid
  // columns, `chunks` 16-byte chunks a row written; rows at or past Q and
  // columns at or past `cols` are zeros
  auto load_tile = [&](bf16* dst, int ldd, const bf16* src, long long rs,
                       int row0, int cols, int chunks) {
    for (int e = tid; e < kT * chunks; e += kMmaThreads) {
      const int r = e / chunks, c = e % chunks;
      bf16* d = dst + r * ldd + c * 8;
      const bool rok = row0 + r < Q;
      const bf16* sp = src + (long long)(row0 + r) * rs + c * 8;
      if (vec) {
        const bool ok = rok && c * 8 < cols;
        cp_async16(d, ok ? sp : src, ok);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          d[i] = rok && c * 8 + i < cols ? sp[i] : __float2bfloat16(0.0f);
      }
    }
  };
  // the tiles of pair (l-tile i, s-tile j) into ring stage sg; C with j 0
  auto load_pair = [&](int l0, int i, int j, int sg) {
    if (j == 0)
      load_tile(Cs, kLdN, Cb + (long long)l0 * sd.cl, sd.cl, i * kT, N,
                2 * nks);
    load_tile(Bs + sg * kT * kLdN, kLdN, Bb + (long long)l0 * sd.bl, sd.bl,
              j * kT, N, 2 * nks);
#pragma unroll
    for (int hh = 0; hh < HT; ++hh)
      load_tile(Xs + (sg * HT + hh) * kT * kLdX, kLdX,
                x + b * sd.xb + (long long)l0 * sd.xl +
                    (long long)(hb + min(hh, nh - 1)) * sd.xh + p0,
                sd.xl, j * kT, hh < nh ? P - p0 : 0, kPT / 8);
  };

  // this block's state: head hh, rows p0 + 16 mt + g (+ 8), columns
  // 32 warp + 8 n + 2 t (+ 1) -- the accumulators of the state update
  float state[HT][2][4][4];
#pragma unroll
  for (int hh = 0; hh < HT; ++hh)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = p0 + mt * 16 + g + 8 * (e >> 1);
          const int col = warp * 32 + n * 8 + 2 * t + (e & 1);
          state[hh][mt][n][e] =
              h0 && hh < nh && p < P && col < N
                  ? h0[(((long long)b * H + hb + hh) * P + p) * N + col]
                  : 0.0f;
        }
  // the state before a chunk, as bf16 hi + lo rows for the carried term
  auto stash_state = [&]() {
#pragma unroll
    for (int hh = 0; hh < HT; ++hh)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = hh * kPT + mt * 16 + g + 8 * half;
            const int col = warp * 32 + n * 8 + 2 * t;
            uint32_t hi, lo;
            split_bf16(state[hh][mt][n][2 * half],
                       state[hh][mt][n][2 * half + 1], hi, lo);
            *reinterpret_cast<uint32_t*>(Hhi + r * kLdN + col) = hi;
            *reinterpret_cast<uint32_t*>(Hlo + r * kLdN + col) = lo;
          }
  };
  stash_state();

  for (int c = 0; c < n_chunks; ++c) {
    const int l0 = c * Q;
    load_pair(l0, 0, 0, 0);          // overlaps the scan
    cp_async_commit();

    // cumulative sum of a, one warp a head, in the log2 domain; past Q the
    // sum stands still (a read as 0) and dt is 0
    for (int hh = warp; hh < HT; hh += kMmaWarps) {
      const long long hoff = (long long)(hb + min(hh, nh - 1));
      const float* ar = a + b * sd.ab + hoff * sd.ah + (long long)l0 * sd.al;
      const float* dr = dt + b * sd.db + hoff * sd.dh + (long long)l0 * sd.dl;
      float run = 0.0f;
      for (int q0 = 0; q0 < Qpad; q0 += 32) {
        const int q = q0 + lane;
        const bool ok = hh < nh && q < Q;
        float v = ok ? ar[(long long)q * sd.al] : 0.0f;
        const float d = ok ? dr[(long long)q * sd.dl] : 0.0f;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, v, off);
          if (lane >= off) v += u;
        }
        v += run;
        run = __shfl_sync(0xffffffffu, v, 31);
        A2[hh * Qpad + q] = v * kLog2e;
        dts[hh * Qpad + q] = d;
      }
    }
    __syncthreads();
    // column factor dt[s] exp2(A[m] - A[s]), m the last step of s's tile
    for (int e = tid; e < HT * Qpad; e += kMmaThreads) {
      const int hh = e / Qpad, q = e % Qpad;
      const int m = min(q / kT * kT + kT, Q) - 1;
      colw[e] = q < Q ? dts[e] * fast_exp2(A2[hh * Qpad + m] - A2[e]) : 0.0f;
    }
    // the state decays over the chunk before the chunk's inputs add to it
#pragma unroll
    for (int hh = 0; hh < HT; ++hh) {
      const float dec = fast_exp2(A2[hh * Qpad + Q - 1]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) state[hh][mt][n][e] *= dec;
    }

    int pair = 0;                    // pairs so far in the chunk: the stage
    for (int i = 0; i < nt; ++i) {
      const int lr0 = i * kT + warp * 16 + g, lr1 = lr0 + 8;  // chunk rows
      const bool lok0 = lr0 < Q, lok1 = lr1 < Q;
      uint32_t cf[8][4];             // C fragments of the warp's 16 rows
      float yacc[HT][4][4];
#pragma unroll
      for (int hh = 0; hh < HT; ++hh)
#pragma unroll
        for (int n = 0; n < 4; ++n)
          yacc[hh][n][0] = yacc[hh][n][1] = yacc[hh][n][2] =
              yacc[hh][n][3] = 0.0f;

      for (int j = 0; j <= i; ++j, ++pair) {
        const int stage = pair & 1;
        cp_async_wait<0>();          // this pair's tiles have landed
        __syncthreads();             // ... for every thread; the last read
        if (j == 0) {
#pragma unroll
          for (int ks = 0; ks < 8; ++ks)
            if (ks < nks)
              ldsm_x4(cf[ks], Cs + (warp * 16 + (lane & 15)) * kLdN +
                                  ks * 16 + (lane >> 4) * 8);
          __syncthreads();           // C tile read: it may be refilled
        }
        {
          const int ni = j < i ? i : i + 1, nj = j < i ? j + 1 : 0;
          if (ni < nt) load_pair(l0, ni, nj, stage ^ 1);
          cp_async_commit();
        }
        const bf16* Bst = Bs + stage * kT * kLdN;
        const bf16* Xst = Xs + stage * HT * kT * kLdX;
        const bool diag = j == i;
        const int s0 = j * kT;
        // columns of the pair this warp needs: on the diagonal only those
        // up to its last row (n-tiles 0 .. 2 warp + 1)
        const int njn = diag ? 2 * warp + 2 : 8;

        // C B^T for the warp's 16 rows x 64 columns, once for all heads
        float cb[8][4];
#pragma unroll
        for (int n = 0; n < 8; ++n)
          cb[n][0] = cb[n][1] = cb[n][2] = cb[n][3] = 0.0f;
#pragma unroll
        for (int ks = 0; ks < 8; ++ks) {
          if (ks >= nks) break;
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            if (2 * np >= njn) break;
            uint32_t bk[4];
            ldsm_x4(bk, Bst + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                  kLdN + ks * 16 + ((lane >> 3) & 1) * 8);
            mma16816(cb[2 * np], cf[ks], bk[0], bk[1]);
            mma16816(cb[2 * np + 1], cf[ks], bk[2], bk[3]);
          }
        }

#pragma unroll
        for (int hh = 0; hh < HT; ++hh) {
          if (hh >= nh) break;
          const float* Ah = A2 + hh * Qpad;
          const float* dh = dts + hh * Qpad;
          const float* wh = colw + hh * Qpad;
          // off the diagonal: row factors exp2(A[l] - A[m])
          const float am = Ah[min(s0 + kT, Q) - 1];
          const float rf0 = !diag && lok0 ? fast_exp2(Ah[lr0] - am) : 0.0f;
          const float rf1 = !diag && lok1 ? fast_exp2(Ah[lr1] - am) : 0.0f;
          const float al0 = Ah[lr0], al1 = Ah[lr1];
          // y += M x, one k-step (16 columns of the pair) at a time
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            if (2 * kk >= njn) break;
            float m[2][4];
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2) {
              const int n = 2 * kk + h2;
              const int s = s0 + 8 * n + 2 * t;
              if (!diag) {
                const float2 w = *reinterpret_cast<const float2*>(wh + s);
                m[h2][0] = cb[n][0] * rf0 * w.x;
                m[h2][1] = cb[n][1] * rf0 * w.y;
                m[h2][2] = cb[n][2] * rf1 * w.x;
                m[h2][3] = cb[n][3] * rf1 * w.y;
              } else {             // a select: exp2 only where s <= l
                const float2 as = *reinterpret_cast<const float2*>(Ah + s);
                const float2 ds = *reinterpret_cast<const float2*>(dh + s);
                m[h2][0] = lok0 && s <= lr0
                               ? cb[n][0] * fast_exp2(al0 - as.x) * ds.x : 0.0f;
                m[h2][1] = lok0 && s + 1 <= lr0
                               ? cb[n][1] * fast_exp2(al0 - as.y) * ds.y : 0.0f;
                m[h2][2] = lok1 && s <= lr1
                               ? cb[n][2] * fast_exp2(al1 - as.x) * ds.x : 0.0f;
                m[h2][3] = lok1 && s + 1 <= lr1
                               ? cb[n][3] * fast_exp2(al1 - as.y) * ds.y : 0.0f;
              }
            }
            uint32_t ph[4], pl[4];
            split_bf16(m[0][0], m[0][1], ph[0], pl[0]);
            split_bf16(m[0][2], m[0][3], ph[1], pl[1]);
            split_bf16(m[1][0], m[1][1], ph[2], pl[2]);
            split_bf16(m[1][2], m[1][3], ph[3], pl[3]);
#pragma unroll
            for (int np = 0; np < kPT / 16; ++np) {
              uint32_t bv[4];
              ldsm_x4_t(bv, Xst + (hh * kT + kk * 16 + (lane & 7) +
                                   ((lane >> 3) & 1) * 8) * kLdX +
                                np * 16 + (lane >> 4) * 8);
              mma16816(yacc[hh][2 * np], ph, bv[0], bv[1]);
              mma16816(yacc[hh][2 * np], pl, bv[0], bv[1]);
              mma16816(yacc[hh][2 * np + 1], ph, bv[2], bv[3]);
              mma16816(yacc[hh][2 * np + 1], pl, bv[2], bv[3]);
            }
          }
        }
        if (!diag) continue;

        // ---- the s-tile's state update: state += (x w)^T B, w the weight
        // dt[s] exp2(A_tot - A[s]) = colw[s] exp2(A_tot - A[m]) ----------
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (s0 + kk * 16 >= Q) break;
          uint32_t bb[2][4];         // B fragments of the warp's columns
#pragma unroll
          for (int np = 0; np < 2; ++np)
            if (warp * 32 + np * 16 < N)
              ldsm_x4_t(bb[np], Bst + (kk * 16 + (lane & 7) +
                                       ((lane >> 3) & 1) * 8) * kLdN +
                                    warp * 32 + np * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int hh = 0; hh < HT; ++hh) {
            if (hh >= nh) break;
            const float* Ah = A2 + hh * Qpad;
            const float sc = fast_exp2(Ah[Q - 1] - Ah[min(s0 + kT, Q) - 1]);
            const float* wr = colw + hh * Qpad + s0 + kk * 16 + 2 * t;
            const float2 wa = *reinterpret_cast<const float2*>(wr);
            const float2 wb = *reinterpret_cast<const float2*>(wr + 8);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              if (p0 + mt * 16 >= P) break;
              uint32_t xa[4];        // x^T: rows p, columns s
              ldsm_x4_t(xa, Xst + (hh * kT + kk * 16 + (lane & 7) +
                                   ((lane >> 4) << 3)) * kLdX +
                                mt * 16 + ((lane >> 3) & 1) * 8);
              uint32_t ah[4], alo[4];
#pragma unroll
              for (int r = 0; r < 4; ++r) {
                const float2 v = unpack_bf16(xa[r]);
                const float2 w = r < 2 ? wa : wb;
                split_bf16(v.x * w.x * sc, v.y * w.y * sc, ah[r], alo[r]);
              }
#pragma unroll
              for (int np = 0; np < 2; ++np) {
                if (warp * 32 + np * 16 >= N) break;
                mma16816(state[hh][mt][2 * np], ah, bb[np][0], bb[np][1]);
                mma16816(state[hh][mt][2 * np], alo, bb[np][0], bb[np][1]);
                mma16816(state[hh][mt][2 * np + 1], ah, bb[np][2], bb[np][3]);
                mma16816(state[hh][mt][2 * np + 1], alo, bb[np][2], bb[np][3]);
              }
            }
          }
        }

        // ---- the carried term, exp2(A[l]) C[l] . h, and the l-tile's y --
#pragma unroll
        for (int hh = 0; hh < HT; ++hh) {
          if (hh >= nh) break;
          float tmp[4][4];
#pragma unroll
          for (int n = 0; n < 4; ++n)
            tmp[n][0] = tmp[n][1] = tmp[n][2] = tmp[n][3] = 0.0f;
#pragma unroll
          for (int ks = 0; ks < 8; ++ks) {
            if (ks >= nks) break;
#pragma unroll
            for (int pp = 0; pp < kPT / 16; ++pp) {
              const int off = (hh * kPT + pp * 16 + (lane & 7) +
                               ((lane >> 4) << 3)) * kLdN + ks * 16 +
                              ((lane >> 3) & 1) * 8;
              uint32_t bh[4], bl[4];
              ldsm_x4(bh, Hhi + off);
              ldsm_x4(bl, Hlo + off);
              mma16816(tmp[2 * pp], cf[ks], bh[0], bh[1]);
              mma16816(tmp[2 * pp], cf[ks], bl[0], bl[1]);
              mma16816(tmp[2 * pp + 1], cf[ks], bh[2], bh[3]);
              mma16816(tmp[2 * pp + 1], cf[ks], bl[2], bl[3]);
            }
          }
          const float* Ah = A2 + hh * Qpad;
          const float e0 = lok0 ? fast_exp2(Ah[lr0]) : 0.0f;
          const float e1 = lok1 ? fast_exp2(Ah[lr1]) : 0.0f;
          const long long hidx = hb + hh;
          bf16* y0 = y + (((long long)b * L + l0 + lr0) * H + hidx) * P;
          bf16* y1 = y + (((long long)b * L + l0 + lr1) * H + hidx) * P;
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const int p = p0 + n * 8 + 2 * t;
            const float v00 = yacc[hh][n][0] + e0 * tmp[n][0];
            const float v01 = yacc[hh][n][1] + e0 * tmp[n][1];
            const float v10 = yacc[hh][n][2] + e1 * tmp[n][2];
            const float v11 = yacc[hh][n][3] + e1 * tmp[n][3];
            if (vec) {               // P % 8 == 0: p and p + 1 both in
              if (p < P) {
                if (lok0)
                  *reinterpret_cast<uint32_t*>(y0 + p) = pack_bf16(v00, v01);
                if (lok1)
                  *reinterpret_cast<uint32_t*>(y1 + p) = pack_bf16(v10, v11);
              }
            } else {
              if (lok0 && p < P) y0[p] = __float2bfloat16(v00);
              if (lok0 && p + 1 < P) y0[p + 1] = __float2bfloat16(v01);
              if (lok1 && p < P) y1[p] = __float2bfloat16(v10);
              if (lok1 && p + 1 < P) y1[p + 1] = __float2bfloat16(v11);
            }
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();                 // every read of the chunk's h and tiles
    if (c + 1 < n_chunks) stash_state();
  }

#pragma unroll
  for (int hh = 0; hh < HT; ++hh)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = p0 + mt * 16 + g + 8 * (e >> 1);
          const int col = warp * 32 + n * 8 + 2 * t + (e & 1);
          if (hh < nh && p < P && col < N)
            hout[(((long long)b * H + hb + hh) * P + p) * N + col] =
                state[hh][mt][n][e];
        }
}

template <int HT>
int launch_mma(const void* x, const void* dt, const void* a, const void* B,
               const void* C, const void* h0, void* y, void* hout, int b,
               int L, int H, int P, int N, int Q, const Strides& sd, int vec,
               cudaStream_t s) {
  const size_t smem = mma_smem_bytes(HT, Q);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = ssd_chunked_mma_kernel<HT>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((P + kPT - 1) / kPT),
                  (unsigned)((H + HT - 1) / HT), (unsigned)b);
  kernel<<<grid, kMmaThreads, smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const bf16*>(B),
      static_cast<const bf16*>(C), static_cast<const float*>(h0),
      static_cast<bf16*>(y), static_cast<float*>(hout), sd, H, L, Q, P, N,
      vec);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// x: (b, L, H, P) float32 (in_bf16 == 0: the SIMT kernel) or bfloat16 (the
// tensor-core kernel); dt, a: (b, L, H) float32; B, C: (b, L, H, N) of x's
// type; h0: (b, H, P, N) float32, contiguous, or null for a zero initial
// state; y: (b, L, H, P) of x's type, contiguous; hout: (b, H, P, N)
// float32, contiguous.  strides: 15 element strides, (batch, step, head) of
// x, dt, a, B and C in that order; the last axis of x, B and C is
// contiguous.  head_tile: heads a block of the tensor-core kernel takes, 1
// or 2 (2 needs B and C of head stride 0); the SIMT kernel ignores it.
// Needs L % Q == 0, P <= 64, N <= 128.
int ssd_chunked_launch(const void* x, const void* dt, const void* a,
                       const void* B, const void* C, const void* h0, void* y,
                       void* hout, int in_bf16, int b, int L, int H, int P,
                       int N, int Q, const long long* strides, int head_tile,
                       void* stream) {
  if (b <= 0 || H <= 0 || L <= 0) return (int)cudaSuccess;
  if (Q <= 0 || L % Q || P <= 0 || P > kPMax || N <= 0 || N > kNMax)
    return (int)cudaErrorInvalidValue;
  const Strides sd = {strides[0],  strides[1],  strides[2],  strides[3],
                      strides[4],  strides[5],  strides[6],  strides[7],
                      strides[8],  strides[9],  strides[10], strides[11],
                      strides[12], strides[13], strides[14]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16) {
    if ((head_tile == 2 && (sd.bh != 0 || sd.ch != 0)) || b > 65535 ||
        H > 65535)
      return (int)cudaErrorInvalidValue;
    const long long str[] = {sd.xb, sd.xl, sd.xh, sd.bb, sd.bl, sd.bh,
                             sd.cb, sd.cl, sd.ch};
    int vec = P % 8 == 0 && N % 8 == 0 && aligned16(x) && aligned16(B) &&
              aligned16(C);
    for (long long v : str) vec = vec && v % 8 == 0;
    if (head_tile == 2)
      return launch_mma<2>(x, dt, a, B, C, h0, y, hout, b, L, H, P, N, Q, sd,
                           vec, s);
    if (head_tile == 1)
      return launch_mma<1>(x, dt, a, B, C, h0, y, hout, b, L, H, P, N, Q, sd,
                           vec, s);
    return (int)cudaErrorInvalidValue;
  }
  if ((long long)b * H > 0x7fffffffLL || smem_bytes(Q) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  return launch<float>(x, dt, a, B, C, h0, y, hout, b, L, H, P, N, Q, sd, s);
}

}  // extern "C"
