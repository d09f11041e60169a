// Aggregate Risk Analysis (paper Algorithm 3) for NVIDIA Hopper (sm_90a).
//
// Replaces the two bodies behind the one Pallas call of the JAX package,
// repro/kernels/aggregate_loss.py: `_kernel` (variant "gather") and
// `_kernel_onehot` (variant "onehot"), both with the shared epilogue
// `_accumulate`.  Each computes, for every trial t,
//
//     acc[t] = sum_k sum_m min(max(ELT[ids[t,k], m] - occ_ret[m], 0), occ_lim[m])
//     out[t] = min(max(acc[t] - agg_ret, 0), agg_lim)
//
// The Pallas kernel tiles the catalog through on-chip memory and revisits an
// accumulating output block over an ordered grid, because its target cannot
// gather from device memory.  Neither holds here: blocks run in any order and
// nothing carries between them, so a block (a warp, in fact) owns its trials
// from the first event to the aggregate terms, and the ordered grid axes
// became loops inside the kernel.
//
// gather -- what bounds it: memory traffic.  The function depends on an
//   event's row only through the row's clipped sum,
//       f[r] = sum_m min(max(ELT[r, m] - occ_ret[m], 0), occ_lim[m]),
//   so acc[t] = sum_k f[ids[t,k]] and the aggregate terms apply to acc[t].
//   A 64 B row per event from a 128 MB table that the 50 MB L2 cannot hold
//   (5*10^8 random rows, ~32 GB a call at the published size) becomes 4 B
//   of f from an 8 MB table that it can.  What the design does about it,
//   two kernels a call:
//   * a row pass writes f from the table (rows padded 15 -> 16 columns: one
//     aligned 64 B segment, read once, as float4): 128 MB read, 8 MB
//     written.  A row's columns are summed four at a time, in order;
//   * a trial pass: a warp owns a trial, lanes walk its ids coalesced with
//     streaming loads (`ld.global.cs`: the 2 GB of ids go through L2
//     evict-first and leave f resident) and gather f[id] from L2, eight
//     events in flight a lane; each lane adds its events in ascending order,
//     one shuffle reduction per trial, no atomics: deterministic.  Ragged T
//     and K are masked here, never padded by a copy.  An id outside
//     [0, rows) contributes 0 and is never dereferenced.
//   For M <= 16 the result equals, bit for bit, a single pass that fetches
//   each event's row and sums it the same way (a lane's events in the same
//   order); for M > 16 f sums a row's column groups of 16 first, so there
//   the order of the additions differs.  f is scratch of each call (the
//   wrapper allocates it on the stream): nothing is kept between calls, so
//   a changed table can never meet a stale f.
//
// onehot -- what bounds it: operations.  The lookup is a product of a one-hot
//   matrix with the ELT tile, T*K*rows*M multiply-adds, which dwarfs its bytes.
//   What the design does about it: the ELT tile sits in shared memory and is
//   read by broadcast, the one-hot operand is never stored (each lane forms
//   `local_id == r` in a register), and each lane carries four events so one
//   tile row read feeds 64 FMAs.  The product is plain float32 FMA, which is
//   exact for a one-hot operand; tensor cores would round the losses (10^4 to
//   10^7) to 10 or 8 mantissa bits.  An id outside the tile matches no row and
//   yields a zero loss vector, which contributes nothing because occ_ret >= 0
//   (the contract of the replaced kernel).
//
// Plain C interface: each entry launches on the stream it is given, allocates
// nothing, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kEventsPerLane = 8;   // events a lane keeps in flight per step
constexpr int kOnehotEvents = 4;    // events a lane carries, onehot
constexpr int kGatherWarps = 8;     // trials (= warps) per block, gather
constexpr int kRowThreads = 256;    // rows (= threads) per block, row pass
constexpr int kOnehotWarps = 4;     // trials (= warps) per block, onehot
constexpr int kTileCols = 16;       // ELT columns per shared-memory tile

__device__ __forceinline__ float occurrence(float loss, float ret, float lim) {
  return fminf(fmaxf(loss - ret, 0.0f), lim);
}

__device__ __forceinline__ float occurrence4(float4 l, float4 ret, float4 lim) {
  float s = occurrence(l.x, ret.x, lim.x);
  s += occurrence(l.y, ret.y, lim.y);
  s += occurrence(l.z, ret.z, lim.z);
  s += occurrence(l.w, ret.w, lim.w);
  return s;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = kWarp / 2; offset > 0; offset >>= 1)
    v += __shfl_down_sync(kFullMask, v, offset);
  return v;
}

__device__ __forceinline__ float aggregate(float acc, float ret, float lim) {
  return fminf(fmaxf(acc - ret, 0.0f), lim);
}

// ---------------------------------------------------------------------------
// row pass: f[r] for every row, one thread a row.  Rows are read as float4
// (row stride a multiple of 4 floats, base 16 B aligned, 4*ceil(M/4) floats
// readable per row); columns M .. 4*ceil(M/4)-1 are padding and get zero
// terms, so whatever they hold contributes 0.  Column groups of NV float4
// (NV = ceil(M/4) up to 4; wider rows are walked in groups of 4).
// ---------------------------------------------------------------------------
template <int NV>
__global__ void __launch_bounds__(kRowThreads)
row_loss_kernel(const float4* __restrict__ elt,
                const float* __restrict__ occ_ret,
                const float* __restrict__ occ_lim, float* __restrict__ f,
                int M, long long stride4, int rows) {
  const long long r = (long long)blockIdx.x * kRowThreads + threadIdx.x;
  if (r >= rows) return;
  const float4* __restrict__ row = elt + r * stride4;
  const int nv_all = (M + 3) / 4;    // float4 per row
  float total = 0.0f;
  for (int v0 = 0; v0 < nv_all; v0 += NV) {      // one group when M <= 16
    float s = 0.0f;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      float rt[4], lt[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int m = 4 * (v0 + v) + c;
        rt[c] = m < M ? __ldg(occ_ret + m) : 0.0f;
        lt[c] = m < M ? __ldg(occ_lim + m) : 0.0f;
      }
      const float4 l = v0 + v < nv_all ? __ldg(row + v0 + v)
                                       : make_float4(0.f, 0.f, 0.f, 0.f);
      s += occurrence4(l, make_float4(rt[0], rt[1], rt[2], rt[3]),
                       make_float4(lt[0], lt[1], lt[2], lt[3]));
    }
    total = v0 == 0 ? s : total + s;
  }
  f[r] = total;
}

// ---------------------------------------------------------------------------
// trial pass: a warp owns a trial; lane j adds the events k = c0 + j + 32 i
// of each chunk [c0, c0 + chunk) in ascending order, whatever the number of
// events in flight.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kGatherWarps * kWarp)
gather_kernel(const int* __restrict__ ids, const float* __restrict__ f,
              float agg_ret, float agg_lim, float* __restrict__ out,
              long long T, int K, int rows, int chunk) {
  const int lane = threadIdx.x & (kWarp - 1);
  const long long trial =
      (long long)blockIdx.x * kGatherWarps + (threadIdx.x >> 5);
  if (trial >= T) return;            // whole warps leave together

  const int* __restrict__ trial_ids = ids + trial * (long long)K;
  float acc = 0.0f;
  for (int c0 = 0; c0 < K; c0 += chunk) {          // the paper's chunking
    const int cend = min(c0 + chunk, K);
    for (int k0 = c0 + lane; k0 < cend; k0 += kWarp * kEventsPerLane) {
      int id[kEventsPerLane];
#pragma unroll
      for (int e = 0; e < kEventsPerLane; ++e) {
        const int k = k0 + e * kWarp;
        id[e] = k < cend ? __ldcs(trial_ids + k) : -1;
      }
      float loss[kEventsPerLane];
#pragma unroll
      for (int e = 0; e < kEventsPerLane; ++e)
        loss[e] = (unsigned)id[e] < (unsigned)rows ? __ldg(f + id[e]) : 0.0f;
#pragma unroll
      for (int e = 0; e < kEventsPerLane; ++e)
        if ((unsigned)id[e] < (unsigned)rows) acc += loss[e];
    }
  }
  acc = warp_sum(acc);
  if (lane == 0) out[trial] = aggregate(acc, agg_ret, agg_lim);
}

// ---------------------------------------------------------------------------
// onehot: a block owns kOnehotWarps trials (a warp each) and loops over
// column groups, catalog tiles and event chunks.  s_tile holds rows_tile rows
// of kTileCols columns, zero beyond the table's edge.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kOnehotWarps * kWarp)
onehot_kernel(const int* __restrict__ ids, const float* __restrict__ elt,
              const float* __restrict__ occ_ret,
              const float* __restrict__ occ_lim, float agg_ret, float agg_lim,
              float* __restrict__ out, long long T, int K, int M,
              long long stride, int rows, int chunk, int rows_tile) {
  extern __shared__ float4 s_tile[];               // [rows_tile][kTileCols / 4]
  float* s_flat = reinterpret_cast<float*>(s_tile);

  const int lane = threadIdx.x & (kWarp - 1);
  const long long trial =
      (long long)blockIdx.x * kOnehotWarps + (threadIdx.x >> 5);
  const bool live = trial < T;       // dead warps still serve the tile loads
  const int* __restrict__ trial_ids = ids + (live ? trial : 0) * (long long)K;

  float acc = 0.0f;
  for (int m0 = 0; m0 < M; m0 += kTileCols) {
    float ret[kTileCols], lim[kTileCols];
#pragma unroll
    for (int c = 0; c < kTileCols; ++c) {
      const int m = m0 + c;
      ret[c] = m < M ? __ldg(occ_ret + m) : 0.0f;
      lim[c] = m < M ? __ldg(occ_lim + m) : 0.0f;
    }
    for (int base = 0; base < rows; base += rows_tile) {
      __syncthreads();               // the previous tile is fully consumed
      for (int i = threadIdx.x; i < rows_tile * kTileCols; i += blockDim.x) {
        const int r = base + i / kTileCols;
        const int m = m0 + i % kTileCols;
        s_flat[i] = (r < rows && m < M)
                        ? __ldg(elt + (long long)r * stride + m) : 0.0f;
      }
      __syncthreads();
      if (!live) continue;

      for (int c0 = 0; c0 < K; c0 += chunk) {
        const int cend = min(c0 + chunk, K);
        for (int k0 = c0 + lane; k0 < cend; k0 += kWarp * kOnehotEvents) {
          int local[kOnehotEvents];
          float g[kOnehotEvents][kTileCols];
#pragma unroll
          for (int e = 0; e < kOnehotEvents; ++e) {
            const int k = k0 + e * kWarp;
            const int id = k < cend ? __ldg(trial_ids + k) : -1;
            // out-of-tile ids match no row of the tile: an all-zero one-hot
            local[e] = (id >= base && id - base < rows_tile) ? id - base : -1;
#pragma unroll
            for (int c = 0; c < kTileCols; ++c) g[e][c] = 0.0f;
          }
          for (int r = 0; r < rows_tile; ++r) {
            float t[kTileCols];
#pragma unroll
            for (int v = 0; v < kTileCols / 4; ++v) {
              const float4 q = s_tile[r * (kTileCols / 4) + v];
              t[4 * v + 0] = q.x; t[4 * v + 1] = q.y;
              t[4 * v + 2] = q.z; t[4 * v + 3] = q.w;
            }
#pragma unroll
            for (int e = 0; e < kOnehotEvents; ++e) {
              const float onehot = local[e] == r ? 1.0f : 0.0f;
#pragma unroll
              for (int c = 0; c < kTileCols; ++c)
                g[e][c] = fmaf(onehot, t[c], g[e][c]);
            }
          }
#pragma unroll
          for (int e = 0; e < kOnehotEvents; ++e) {
            float s = 0.0f;
#pragma unroll
            for (int c = 0; c < kTileCols; ++c)
              s += occurrence(g[e][c], ret[c], lim[c]);
            acc += s;
          }
        }
      }
    }
  }
  acc = warp_sum(acc);
  if (live && lane == 0) out[trial] = aggregate(acc, agg_ret, agg_lim);
}

}  // namespace

extern "C" {

// f: (rows,) float32 written from the table.  The caller guarantees the
// float4 layout: elt is 16 B aligned, elt_stride is a multiple of 4 floats
// with 4*ceil(M/4) <= elt_stride, and the allocation covers 4*ceil(M/4)
// floats of the last row.
int aggregate_row_losses_launch(const void* elt, const void* occ_ret,
                                const void* occ_lim, int M,
                                long long elt_stride, int rows, void* f,
                                void* stream) {
  if (M <= 0 || rows <= 0 || elt_stride % 4 != 0 ||
      elt_stride < 4 * ((M + 3) / 4))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)((rows + kRowThreads - 1) / kRowThreads));
#define LAUNCH_ROWS(NV)                                                     \
  row_loss_kernel<NV><<<grid, kRowThreads, 0, s>>>(                         \
      static_cast<const float4*>(elt), static_cast<const float*>(occ_ret),  \
      static_cast<const float*>(occ_lim), static_cast<float*>(f), M,        \
      elt_stride / 4, rows)
  switch ((M + 3) / 4) {
    case 1: LAUNCH_ROWS(1); break;
    case 2: LAUNCH_ROWS(2); break;
    case 3: LAUNCH_ROWS(3); break;
    default: LAUNCH_ROWS(4); break;  // wider rows: column groups of 16
  }
#undef LAUNCH_ROWS
  return (int)cudaGetLastError();
}

// ids: (T, K) int32 contiguous; f: (rows,) float32 from the row pass.
int aggregate_loss_gather_launch(const void* ids, const void* f,
                                 float agg_ret, float agg_lim, void* out,
                                 long long T, int K, int rows, int chunk,
                                 void* stream) {
  if (T <= 0) return (int)cudaSuccess;
  if (K < 0 || rows <= 0 || chunk <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)((T + kGatherWarps - 1) / kGatherWarps));
  gather_kernel<<<grid, kGatherWarps * kWarp, 0, s>>>(
      static_cast<const int*>(ids), static_cast<const float*>(f), agg_ret,
      agg_lim, static_cast<float*>(out), T, K, rows, chunk);
  return (int)cudaGetLastError();
}

int aggregate_loss_onehot_launch(const void* ids, const void* elt,
                                 const void* occ_ret, const void* occ_lim,
                                 float agg_ret, float agg_lim, void* out,
                                 long long T, int K, int M,
                                 long long elt_stride, int rows, int chunk,
                                 int rows_tile, void* stream) {
  if (T <= 0) return (int)cudaSuccess;
  if (K < 0 || M <= 0 || rows <= 0 || chunk <= 0 || rows_tile <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)rows_tile * kTileCols * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(kOnehotWarps * kWarp);
  const dim3 grid((unsigned)((T + kOnehotWarps - 1) / kOnehotWarps));
  onehot_kernel<<<grid, block, smem, s>>>(
      static_cast<const int*>(ids), static_cast<const float*>(elt),
      static_cast<const float*>(occ_ret), static_cast<const float*>(occ_lim),
      agg_ret, agg_lim, static_cast<float*>(out), T, K, M, elt_stride, rows,
      chunk, rows_tile);
  return (int)cudaGetLastError();
}

}  // extern "C"
