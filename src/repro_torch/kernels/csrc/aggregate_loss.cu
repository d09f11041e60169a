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
// onehot -- what bounds it: bytes, the ids read once per catalog tile.  The
//   Pallas body multiplies each event's one-hot row with the ELT tile,
//   T*K*rows*M multiply-adds.  Summed over a trial's events the one-hot rows
//   are the trial's event histogram, and because a one-hot row picks exactly
//   one table row and occ_ret >= 0 (a zero loss vector clips to 0), the
//   clipping commutes with the product:
//       acc[t] = sum_r counts[t, r] * f[r],
//   f the row losses of the gather's row pass.  What the design does about
//   it, two kernels a call (the row pass, then this one):
//   * a block owns 8 trials at a time and a catalog tile of up to 14,336
//     rows: counts[8][tile] as 16-bit counts, two to a 32-bit word, in up to
//     224 KB of dynamic shared memory (at the smoke run's 4,097-row catalog
//     one tile of 66 KB, three blocks an SM), zeroed once per block.  Blocks
//     are persistent (as many as the SMs hold) and walk the groups of 8
//     trials.  The 256 threads stream the group's ids once per tile,
//     coalesced, sixteen loads in flight each, evict-first on the last tile,
//     and add 1 (or 1 << 16) to the word of each in-tile id with one
//     shared-memory atomicAdd; the low count never carries into the high one
//     while K < 65,536.  An id outside the tile counts nothing, so one
//     outside [0, rows) contributes 0 and is never dereferenced.
//   * then counts . f over the tile: thread w takes word w of every trial,
//     one pair of f for 8 counts, and adds count * f in float32 FMAs (exact
//     products of an integer below 2^16 with f, one rounding each) to a
//     chain per trial, clearing the words for the next tile or group; per
//     trial a shuffle sum per warp, then the warps' sums in order.  No
//     atomics in any sum: two calls give the same bits.  (The tensor cores
//     were tried for this product -- mma.sync TF32 with f split into three
//     exact parts -- and were slower at every shape measured.)
//   * catalogs wider than the tile take more tiles: an outer loop inside the
//     block (no second pass), the ids read once per tile, counts . f added
//     tile after tile before the aggregate terms.

// Plain C interface: each entry launches on the stream it is given, allocates
// nothing, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kEventsPerLane = 8;   // events a lane keeps in flight per step
constexpr int kGatherWarps = 8;     // trials (= warps) per block, gather
constexpr int kRowThreads = 256;    // rows (= threads) per block, row pass
constexpr int kHistTrials = 8;      // trials (= warps) per group, onehot
constexpr int kHistThreads = kHistTrials * kWarp;
constexpr int kHistLoads = 16;      // ids a thread keeps in flight, onehot
constexpr int kHistMaxRows = 14336; // catalog rows of one onehot tile

// 32-bit words of one trial's counts in shared memory, two 16-bit counts a
// word; 8 rows of the widest tile take 229,376 bytes
__host__ __device__ constexpr int hist_words(int tile_rows) {
  return (tile_rows + 1) / 2;
}

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

// a 16-bit count as float32, exactly: its bits under the exponent of 2^23
__device__ __forceinline__ float count_f32(uint32_t c16) {
  return __uint_as_float(c16 | 0x4b000000u) - 8388608.0f;
}

// ---------------------------------------------------------------------------
// onehot: persistent blocks of kHistThreads walk the groups of kHistTrials
// trials; s_counts is [kHistTrials][hist_words(tile_rows)] words, zero
// between uses (the dot pass clears what the histogram wrote).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kHistThreads)
onehot_hist_kernel(const int* __restrict__ ids, const float* __restrict__ f,
                   float agg_ret, float agg_lim, float* __restrict__ out,
                   long long T, int K, int rows, int tile_rows) {
  extern __shared__ uint32_t s_counts[];
  __shared__ float s_part[kHistTrials][kHistTrials];   // [warp][trial]
  const int W = hist_words(tile_rows);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & (kWarp - 1);
  const float inv_k = 1.0f / (float)max(K, 1);
  for (int i = threadIdx.x; i < kHistTrials * W; i += kHistThreads)
    s_counts[i] = 0u;
  __syncthreads();

  const long long groups = (T + kHistTrials - 1) / kHistTrials;
  for (long long g = blockIdx.x; g < groups; g += gridDim.x) {
    const long long t0 = g * kHistTrials;
    const int nt = (int)min((long long)kHistTrials, T - t0);
    const int* __restrict__ gids = ids + t0 * K;    // nt * K ids, contiguous
    const int n = nt * K;
    float acc[kHistTrials];             // this thread's part per trial
#pragma unroll
    for (int t = 0; t < kHistTrials; ++t) acc[t] = 0.0f;
    for (int base = 0; base < rows; base += tile_rows) {
      const int rt = min(tile_rows, rows - base);
      const bool last = base + tile_rows >= rows;   // the ids' last read
      for (int i0 = threadIdx.x; i0 < n; i0 += kHistThreads * kHistLoads) {
        int id[kHistLoads];
#pragma unroll
        for (int u = 0; u < kHistLoads; ++u) {
          const int i = i0 + u * kHistThreads;
          id[u] = i < n ? (last ? __ldcs(gids + i) : __ldg(gids + i)) : -1;
        }
#pragma unroll
        for (int u = 0; u < kHistLoads; ++u) {
          const int local = id[u] - base;
          if ((unsigned)local < (unsigned)rt) {
            // the event's trial, i / K: a float estimate (i < 2^24), off by
            // at most one, corrected
            const int i = i0 + u * kHistThreads;
            int t = (int)((float)i * inv_k);
            t -= t * K > i;
            t += (t + 1) * K <= i;
            atomicAdd(s_counts + t * W + (local >> 1),
                      1u << ((local & 1) << 4));
          }
        }
      }
      __syncthreads();                  // the tile's histogram is complete

      const float* __restrict__ ft = f + base;
      // thread w takes word w (rows 2w, 2w + 1) of every trial: one f pair
      // for kHistTrials counts, a chain of FMAs per trial
      for (int w = threadIdx.x; w < (rt + 1) / 2; w += kHistThreads) {
        const float f_lo = __ldg(ft + 2 * w);
        const float f_hi = 2 * w + 1 < rt ? __ldg(ft + 2 * w + 1) : 0.0f;
#pragma unroll
        for (int t = 0; t < kHistTrials; ++t) {
          const uint32_t c = s_counts[t * W + w];
          s_counts[t * W + w] = 0u;
          acc[t] = fmaf(count_f32(c & 0xffffu), f_lo, acc[t]);
          acc[t] = fmaf(count_f32(c >> 16), f_hi, acc[t]);
        }
      }
      __syncthreads();                  // counts cleared for the next tile
    }

    // per trial, the warps' parts through shared memory, added in warp order
#pragma unroll
    for (int t = 0; t < kHistTrials; ++t) {
      const float v = warp_sum(acc[t]);
      if (lane == 0) s_part[warp][t] = v;
    }
    __syncthreads();
    if (warp < nt && lane == 0) {
      float total = 0.0f;
      for (int w = 0; w < kHistTrials; ++w) total += s_part[w][warp];
      out[t0 + warp] = aggregate(total, agg_ret, agg_lim);
    }
    // s_part is next written after the next group's histogram barrier
  }
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

// ids: (T, K) int32 contiguous; f: (rows,) float32 from the row pass.
// tile_rows in [1, kHistMaxRows]; K < 65,536 (a count fits 16 bits).
// Launches as many persistent blocks as the SMs hold at the tile's shared
// memory, at most one per group of trials.
int aggregate_loss_onehot_launch(const void* ids, const void* f,
                                 float agg_ret, float agg_lim, void* out,
                                 long long T, int K, int rows, int tile_rows,
                                 void* stream) {
  if (T <= 0) return (int)cudaSuccess;
  if (K < 0 || K >= 65536 || rows <= 0 || tile_rows <= 0 ||
      tile_rows > kHistMaxRows)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kHistTrials * hist_words(tile_rows) * 4;
  const void* kernel = reinterpret_cast<const void*>(&onehot_hist_kernel);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kHistThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long groups = (T + kHistTrials - 1) / kHistTrials;
  const long long resident = (long long)sms * per_sm;
  const dim3 grid((unsigned)(groups < resident ? groups : resident));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  onehot_hist_kernel<<<grid, kHistThreads, smem, s>>>(
      static_cast<const int*>(ids), static_cast<const float*>(f), agg_ret,
      agg_lim, static_cast<float*>(out), T, K, rows, tile_rows);
  return (int)cudaGetLastError();
}

}  // extern "C"
