// Nearest-vertex kernels for Hopper (sm_90a): the CUDA counterparts of the
// three Pallas TPU kernels in uuo_mocap_tpu/ops/chamfer_pallas.py.
//
//   uuo_rank_nearest        <- _rank_kernel / ranked_nearest_pallas (:195-284)
//   uuo_min_sqdist_fwd      <- _kernel / min_sqdist_pallas          (:33-122)
//     (few queries; uuo_min_sqdist_fwd_rev: the same function for many queries)
//   uuo_min_sqdist_bwd      <- _bwd_kernel / make_min_grad_y         (:125-189)
//
// The rank pass and the few-query forward are one kernel template
// (nearest_staged), the forward also writing each winner's value.
//
// Plain C interface (bound with ctypes from ops/chamfer_kernels.py): every
// kernel's entry point launches on the caller's stream, allocates nothing,
// and returns a CUDA error code (cudaGetLastError() after the launch) so a
// refused launch reaches the wrapper.
//
// Arithmetic (all FP32, no tensor cores — the contraction depth is 3):
// both clouds of a batch element are centered on the TARGET centroid, and
//   d2 = |q - c|^2 + ((|t - c|^2 + bias_t) - 2 (q - c).(t - c))
// which is the expansion the reference computes
// (uuo_mocap_tpu/ops/chamfer.py:62-86).  |q - c|^2 is the same for every
// target of a query, so the scan compares only the bracket, as three FMAs
// on the pre-scaled query -2 (q - c), and adds |q - c|^2 once to the
// winner's value.  Ties keep the lowest target index, as argmin does.
//
// What bounds them on an H100: the rank and forward passes read each
// target point once (12 B) and need 3 FP32 FMAs (6 FLOP) per (query,
// target) pair; at the main path's shapes (41 queries x 6890 targets per
// frame) the rank pass sits where the FP32 rate (67 TFLOP/s) and HBM
// (3.35 TB/s) bounds meet, and the instruction issue rate (3 FMAs plus the
// min per pair) is the practical floor.  The forward's reverse direction
// (6890 queries x 41 targets) has a bytes bound (12 B of query in and 8 B
// of (value, index) out per query), but its scan's instruction issue (3
// FMAs and a compare-and-select per pair) holds it.  The backward is bound
// by writing its [B, V, 3] + [B, V] outputs.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTargetTile = 1024;  // targets staged per pass, many-query forward
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

// Mean of the n points p[n, 3] (global or shared memory) into s_c[0..2];
// s_red holds 3 floats per warp.  The sum's order is fixed whatever the
// block size: thread i < kThreads adds points i, i + kThreads, ..., then
// the warps' shuffle trees, then thread 0 over the warps in order (warps
// past the kThreads-th thread add zeros).  So a launch repeats bit for bit,
// and the rank and forward kernels center a frame on the same bits.  Every
// thread of the block must call it; blockDim.x >= kThreads.
__device__ __forceinline__ void block_centroid(const float* __restrict__ p, int n,
                                               float* s_c, float* s_red) {
  float sx = 0.f, sy = 0.f, sz = 0.f;
  if (threadIdx.x < kThreads) {
    for (int i = threadIdx.x; i < n; i += kThreads) {
      sx += p[3 * i + 0];
      sy += p[3 * i + 1];
      sz += p[3 * i + 2];
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sx += __shfl_down_sync(kFull, sx, o);
    sy += __shfl_down_sync(kFull, sy, o);
    sz += __shfl_down_sync(kFull, sz, o);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    s_red[3 * warp + 0] = sx;
    s_red[3 * warp + 1] = sy;
    s_red[3 * warp + 2] = sz;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float ax = 0.f, ay = 0.f, az = 0.f;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
      ax += s_red[3 * w + 0];
      ay += s_red[3 * w + 1];
      az += s_red[3 * w + 2];
    }
    s_c[0] = ax / (float)n;
    s_c[1] = ay / (float)n;
    s_c[2] = az / (float)n;
  }
  __syncthreads();
}

// ------------------------------------------- rank pass and few-query forward
//
// One block per (lane, frame) problem, or per batch element of the forward:
// M queries against the element's V targets.  The design answers what
// bounds the pass on this card:
//  * HBM: the frame's 3V floats are read once, with 16-byte cp.async copies
//    into shared memory (scalar copies for the unaligned head and tail: a
//    frame of 6890 vertices starts 16-byte aligned only every other frame).
//    The centroid is summed from shared memory (block_centroid's order, so
//    its bits, and hence the picks, do not depend on the block size), and
//    the frame is rewritten in place as float4 (t - c, |t - c|^2 + bias):
//    110 KB at V = 6890, so two blocks fit on an SM.
//  * Issue rate: each lane holds Q pre-scaled queries -2 (q - c) in
//    registers and reads one staged target per step, shared by its Q
//    queries: 3 FMAs and one min per pair.  The argmin is lazy: a lane
//    keeps, per query, only the group of kRankRows targets where its
//    minimum first fell, and re-scans that one group at the end for the
//    first target that reaches the minimum (the same FMAs, so the same
//    bits).  No register array is indexed dynamically, nothing spills.
//  * Occupancy: M is cut into `groups` of Q <= kRankMaxQ queries with no
//    padding beyond Q * groups - M slots (41 = 6 x 7 - 1), and the targets
//    are split `splits` ways so that a block has up to kRankMaxWarps warps
//    (and at least kWarps, for block_centroid).
// A frame larger than the shared memory a block may have takes the
// kChunked instantiation: staged in chunks of `chunk` targets (a whole
// number of groups), its centroid summed from HBM in the same order, each
// chunk's per-query winners merged into the running ones with better().
// Its chunks fill the shared memory, so one block runs per SM and it may
// use twice the registers (no spills).  A frame that fits is staged once,
// by the kernel without the chunk loop.  Ties keep the lowest index:
// strict < across groups, the first equal target inside a group, then
// better() across lanes, chunks and splits.  With kVal (the forward) the
// kernel also writes max(min + |q - c|^2, 0).

constexpr int kRankRows = 8;                  // rows of 32 targets per lazy-argmin group
constexpr int kRankGroup = 32 * kRankRows;    // targets per group
// queries held by one lane: at most 7, since the 8-query rank instantiation
// spilled (4 B) at the 80 registers that two 384-thread blocks per SM
// leave; M = 41 takes 6 groups of 7 either way
constexpr int kRankMaxQ = 7;
constexpr int kRankMaxWarps = 12;             // 384 threads, 2 blocks per SM

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ float rank_key(float qx, float qy, float qz, float4 t) {
  return fmaf(qx, t.x, fmaf(qy, t.y, fmaf(qz, t.z, t.w)));
}

// Floats from p up to the next 16-byte boundary, at most n.
__device__ __forceinline__ int lead_to_16(const void* p, int n) {
  return min(n, (int)(((16u - ((unsigned)(uintptr_t)p & 15u)) & 15u) >> 2));
}

__host__ __device__ __forceinline__ int rank_target_groups(int V) {
  return (V + kRankGroup - 1) / kRankGroup;
}

// Dynamic shared memory: the staged chunk of n targets (4 floats per padded
// target, +4 for the raw copy's alignment shift), then the per-split
// partial (min, argmin) of every query slot.
__host__ __device__ __forceinline__ size_t rank_smem_floats(int n) {
  return (size_t)4 * rank_target_groups(n) * kRankGroup + 4;
}

template <int Q, bool kVal, bool kChunked>
__global__ void __launch_bounds__(kRankMaxWarps * 32, kChunked ? 1 : 2)
nearest_staged(const float* __restrict__ q, const float* __restrict__ t,
               const float* __restrict__ bias, int bias_div, float* __restrict__ out_val,
               int32_t* __restrict__ out_idx, int M, int V, int groups, int splits, int chunk) {
  extern __shared__ float4 s_t[];
  __shared__ float s_c[3];
  __shared__ float s_red[3 * kRankMaxWarps];

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  float* s_f = reinterpret_cast<float*>(s_t);
  float* s_pv = s_f + rank_smem_floats(kChunked ? chunk : V);       // [splits][groups * Q]
  int* s_pi = reinterpret_cast<int*>(s_pv + splits * groups * Q);  // [splits][groups * Q]
  const float* __restrict__ tb = t + (size_t)b * V * 3;
  const float* __restrict__ bb = bias ? bias + (size_t)(b / bias_div) * V : nullptr;
  const float* __restrict__ qb = q + (size_t)b * M * 3;

  float cx = 0.f, cy = 0.f, cz = 0.f;
  if (kChunked) {  // the frame is never in shared memory at once
    block_centroid(tb, V, s_c, s_red);
    cx = s_c[0], cy = s_c[1], cz = s_c[2];
  }
  for (int v0 = 0; v0 < V; v0 += chunk) {
    const int n = kChunked ? min(chunk, V - v0) : V;
    const float* __restrict__ tc = tb + (size_t)3 * v0;

    // 1. The chunk's 3n floats into s_f[R, R + 3n), R >= n chosen so that
    //    the 16-byte-aligned part of the source lands 16-byte aligned.
    const int n3 = 3 * n;
    const int head = lead_to_16(tc, n3);
    const int R = n + ((4 - ((n + head) & 3)) & 3);
    const int n4 = (n3 - head) >> 2;
    for (int i = tid; i < n4; i += blockDim.x) cp_async16(s_f + R + head + 4 * i, tc + head + 4 * i);
    for (int i = tid; i < head; i += blockDim.x) s_f[R + i] = tc[i];
    for (int i = head + 4 * n4 + tid; i < n3; i += blockDim.x) s_f[R + i] = tc[i];
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();

    // 2. The target centroid, from shared memory, in block_centroid's fixed
    //    order: the same bits whatever the block size.
    if (!kChunked) {
      block_centroid(s_f + R, V, s_c, s_red);
      cx = s_c[0], cy = s_c[1], cz = s_c[2];
    }

    // 3. Rewrite in place as float4 (t - c, |t - c|^2 + bias), one slice of
    //    blockDim targets at a time in ascending order: slice k's float4s end
    //    at 16 (k + 1) blockDim bytes, below the raw floats of any later
    //    slice (R >= n), so one barrier between reading and writing a slice
    //    suffices.  Padding targets (to whole groups) never win: w = +inf.
    const int n_tgroups = rank_target_groups(n);
    for (int i0 = 0; i0 < n; i0 += blockDim.x) {
      const int i = i0 + tid;
      float x = 0.f, y = 0.f, z = 0.f, w = 0.f;
      if (i < n) {
        x = s_f[R + 3 * i + 0] - cx;
        y = s_f[R + 3 * i + 1] - cy;
        z = s_f[R + 3 * i + 2] - cz;
        w = x * x + y * y + z * z;
        if (bb) w += bb[v0 + i];
      }
      __syncthreads();
      if (i < n) s_t[i] = make_float4(x, y, z, w);
    }
    __syncthreads();
    for (int i = n + tid; i < n_tgroups * kRankGroup; i += blockDim.x) {
      s_t[i] = make_float4(0.f, 0.f, 0.f, INFINITY);
    }
    __syncthreads();

    // 4. Scan: warp item = (query group g, target split s).
    for (int item = warp; item < groups * splits; item += nwarps) {
      const int g = item / splits, s = item % splits;
      float qx[Q], qy[Q], qz[Q], best[Q];
      int bgrp[Q];
#pragma unroll
      for (int i = 0; i < Q; ++i) {
        const int m = g * Q + i;
        qx[i] = qy[i] = qz[i] = 0.f;
        if (m < M) {
          qx[i] = -2.f * (qb[3 * m + 0] - cx);
          qy[i] = -2.f * (qb[3 * m + 1] - cy);
          qz[i] = -2.f * (qb[3 * m + 2] - cz);
        }
        best[i] = INFINITY;
        bgrp[i] = s;  // all-infinite rows still find their first target
      }
      for (int tg = s; tg < n_tgroups; tg += splits) {
        const float4* tp = s_t + tg * kRankGroup + lane;
        float gmin[Q];
#pragma unroll
        for (int i = 0; i < Q; ++i) gmin[i] = rank_key(qx[i], qy[i], qz[i], tp[0]);
#pragma unroll
        for (int r = 1; r < kRankRows; ++r) {
          const float4 tt = tp[32 * r];
#pragma unroll
          for (int i = 0; i < Q; ++i) gmin[i] = fminf(gmin[i], rank_key(qx[i], qy[i], qz[i], tt));
        }
#pragma unroll
        for (int i = 0; i < Q; ++i) {
          if (gmin[i] < best[i]) {
            best[i] = gmin[i];
            bgrp[i] = tg;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < Q; ++i) {
        int bi = INT_MAX;
        if (bgrp[i] < n_tgroups) {  // a split with no group in a short last chunk has none
          const float4* tp = s_t + bgrp[i] * kRankGroup + lane;
          for (int r = kRankRows - 1; r >= 0; --r) {
            if (rank_key(qx[i], qy[i], qz[i], tp[32 * r]) == best[i]) {
              bi = v0 + bgrp[i] * kRankGroup + 32 * r + lane;
            }
          }
        }
        float bv = best[i];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          const float ov = __shfl_down_sync(kFull, bv, o);
          const int oi = __shfl_down_sync(kFull, bi, o);
          if (better(ov, oi, bv, bi)) {
            bv = ov;
            bi = oi;
          }
        }
        const int slot = s * groups * Q + g * Q + i;
        if (lane == 0 && (v0 == 0 || better(bv, bi, s_pv[slot], s_pi[slot]))) {
          s_pv[slot] = bv;
          s_pi[slot] = bi;
        }
      }
    }
    __syncthreads();       // the partials are complete; the next chunk overwrites s_t
    if (!kChunked) break;  // one pass, v0 = 0: no loop in the single-staging kernel
  }

  // 5. Query m's winner over the splits.
  for (int m = tid; m < M; m += blockDim.x) {
    float bv = s_pv[m];
    int bi = s_pi[m];
    for (int s = 1; s < splits; ++s) {
      const float ov = s_pv[s * groups * Q + m];
      const int oi = s_pi[s * groups * Q + m];
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    out_idx[(size_t)b * M + m] = bi;
    if (kVal) {
      const float x = qb[3 * m + 0] - cx, y = qb[3 * m + 1] - cy, z = qb[3 * m + 2] - cz;
      out_val[(size_t)b * M + m] = fmaxf(bv + (x * x + y * y + z * z), 0.f);
    }
  }
}

// The launch shape of the staged pass for M queries against V targets.
struct StagedPlan {
  int groups, Q, splits, warps;
  int chunk;    // targets staged at a time: V, or a whole number of groups
  size_t smem;  // dynamic shared memory, bytes
};

// limit: the dynamic shared memory a block may have, bytes; < 0 stages the
// whole frame whatever it needs (the rank pass, whose wrapper checks).
StagedPlan staged_plan(int M, int V, long long limit) {
  StagedPlan p;
  p.groups = (M + kRankMaxQ - 1) / kRankMaxQ;
  p.Q = (M + p.groups - 1) / p.groups;
  const int max_splits = max(1, kRankMaxWarps / p.groups);
  long long chunk_groups = rank_target_groups(V);
  if (limit >= 0) {
    const long long partials = (long long)max_splits * p.groups * p.Q * 8;
    const long long fit = (limit - partials - 16) / (16LL * kRankGroup);
    chunk_groups = max(1LL, min(chunk_groups, fit));
  }
  p.chunk = (int)min((long long)V, chunk_groups * kRankGroup);
  p.splits = min(max_splits, rank_target_groups(p.chunk));
  p.warps = max(kWarps, min(p.groups * p.splits, kRankMaxWarps));
  p.smem = rank_smem_floats(p.chunk) * sizeof(float) + (size_t)p.splits * p.groups * p.Q * 8;
  return p;
}

template <int Q, bool kVal, bool kChunked>
cudaError_t launch_staged_q(const float* q, const float* t, const float* bias, int bias_div,
                            float* val, int32_t* idx, int B, int M, int V, const StagedPlan& p,
                            cudaStream_t s) {
  const cudaError_t err = cudaFuncSetAttribute(
      nearest_staged<Q, kVal, kChunked>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return err;
  nearest_staged<Q, kVal, kChunked><<<B, p.warps * 32, p.smem, s>>>(
      q, t, bias, bias_div, val, idx, M, V, p.groups, p.splits, p.chunk);
  return cudaGetLastError();
}

template <bool kVal>
cudaError_t launch_staged(const float* q, const float* t, const float* bias, int bias_div,
                          float* val, int32_t* idx, int B, int M, int V, long long limit,
                          cudaStream_t s) {
  const StagedPlan p = staged_plan(M, V, limit);
  // a frame beyond the limit takes the chunked kernel; the rank pass
  // (limit < 0) never does, so only the forward has chunked instantiations
#define UUO_STAGED_CASE(QQ)                                                              \
  case QQ:                                                                               \
    return p.chunk < V                                                                   \
               ? launch_staged_q<QQ, kVal, kVal>(q, t, bias, bias_div, val, idx, B, M, V, p, s) \
               : launch_staged_q<QQ, kVal, false>(q, t, bias, bias_div, val, idx, B, M, V, p, s);
  switch (p.Q) {
    UUO_STAGED_CASE(1)
    UUO_STAGED_CASE(2)
    UUO_STAGED_CASE(3)
    UUO_STAGED_CASE(4)
    UUO_STAGED_CASE(5)
    UUO_STAGED_CASE(6)
    UUO_STAGED_CASE(7)
  }
  static_assert(kRankMaxQ == 7, "one case per Q");
#undef UUO_STAGED_CASE
  return cudaErrorInvalidValue;
}

// --------------------------------------------------- many-query forward
//
// Many queries, few targets (the reverse direction of the bidirectional
// chamfer: 6890 vertices against 41 markers).  A block walks a contiguous
// run of (element, tile) items, so it stages an element's targets once
// (centroid, then float4 (t - c, |t - c|^2 + bias) in shared memory) and
// reuses them for every tile of that element it takes.  A thread owns
// kManyQ consecutive queries that start on a multiple of kManyQ of the flat
// query index b * M + m, so they are 3 kManyQ / 4 16-byte loads, and their
// values and indices kManyQ / 4 16-byte stores each; the first and last
// group of an element may hold fewer of its queries (scalar loads and
// stores, as for a base pointer that is not 16-byte aligned).  A target
// count beyond kTargetTile is staged tile by tile for every item.  Every
// target is one broadcast shared load for the thread's kManyQ queries; per
// pair 3 FMAs and a compare-and-select (FSETP, FSEL, SEL), in ascending
// target order with strict <, so ties keep the lowest index.
// What bounds it: the scan's instruction issue, not the bytes (at the main
// path's shape the kernel without its scan takes half its time, the scan
// without the query loads nearly all of it).  Measured slower on an H100:
// copying the next item's queries by cp.async while scanning the current
// one; a lazy argmin as in the staged kernel (a min per group of 4 or 8
// targets and a re-scan: 77-80 registers); 8 queries per thread.

constexpr int kManyQ = 4;                         // consecutive queries per thread
static_assert(kManyQ % 4 == 0, "whole 16-byte loads and stores");

__global__ void __launch_bounds__(kThreads)
nearest_many_queries(const float* __restrict__ q, const float* __restrict__ t,
                     const float* __restrict__ bias, float* __restrict__ out_val,
                     int32_t* __restrict__ out_idx, int M, int V, int n_tiles, int n_items,
                     int per_block, int aligned) {
  __shared__ float s_c[3];
  __shared__ float s_red[3 * kWarps];
  __shared__ float4 s_t[kTargetTile];

  const int it0 = blockIdx.x * per_block, it1 = min(n_items, it0 + per_block);
  int staged = -1;  // the element whose targets s_t holds (V <= kTargetTile)
  float cx = 0.f, cy = 0.f, cz = 0.f;
  for (int item = it0; item < it1; ++item) {
    const int b = item / n_tiles, k = item - b * n_tiles;
    const float* __restrict__ tb = t + (size_t)b * V * 3;
    const float* __restrict__ bb = bias + (size_t)b * V;
    const bool restage = b != staged || V > kTargetTile;
    if (b != staged) {
      block_centroid(tb, V, s_c, s_red);
      cx = s_c[0], cy = s_c[1], cz = s_c[2];
    }

    // this thread's queries: flat indices g .. g + kManyQ - 1, those in
    // [lo, hi) are element b's
    const long long lo = (long long)b * M, hi = lo + M;
    const long long g = kManyQ * (lo / kManyQ + (long long)kThreads * k + threadIdx.x);
    float f[3 * kManyQ];
    const bool full = aligned && g >= lo && g + kManyQ <= hi;
    if (full) {
      const float4* qp = reinterpret_cast<const float4*>(q + 3 * g);
#pragma unroll
      for (int i = 0; i < 3 * kManyQ / 4; ++i) {
        const float4 a = qp[i];
        f[4 * i + 0] = a.x, f[4 * i + 1] = a.y, f[4 * i + 2] = a.z, f[4 * i + 3] = a.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 3 * kManyQ; ++i) {
        const long long m = g + i / 3;
        f[i] = m >= lo && m < hi ? q[3 * g + i] : 0.f;
      }
    }
    float nx[kManyQ], ny[kManyQ], nz[kManyQ], x2[kManyQ], best[kManyQ];
    int bi[kManyQ];
#pragma unroll
    for (int j = 0; j < kManyQ; ++j) {
      const float x = f[3 * j] - cx, y = f[3 * j + 1] - cy, z = f[3 * j + 2] - cz;
      x2[j] = x * x + y * y + z * z;
      nx[j] = -2.f * x;
      ny[j] = -2.f * y;
      nz[j] = -2.f * z;
      best[j] = INFINITY;
      bi[j] = 0;
    }

    for (int v0 = 0; v0 < V; v0 += kTargetTile) {
      const int n = min(kTargetTile, V - v0);
      if (restage) {
        __syncthreads();  // every thread is done with the previous targets
        for (int i = threadIdx.x; i < n; i += kThreads) {
          const int v = v0 + i;
          const float yx = tb[3 * v + 0] - cx;
          const float yy = tb[3 * v + 1] - cy;
          const float yz = tb[3 * v + 2] - cz;
          s_t[i] = make_float4(yx, yy, yz, (yx * yx + yy * yy + yz * yz) + bb[v]);
        }
        __syncthreads();
      }
      for (int i = 0; i < n; ++i) {
        const float4 tt = s_t[i];
#pragma unroll
        for (int j = 0; j < kManyQ; ++j) {
          const float d = fmaf(nx[j], tt.x, fmaf(ny[j], tt.y, fmaf(nz[j], tt.z, tt.w)));
          if (d < best[j]) {
            best[j] = d;
            bi[j] = v0 + i;
          }
        }
      }
    }
    staged = b;

    float val[kManyQ];
#pragma unroll
    for (int j = 0; j < kManyQ; ++j) val[j] = fmaxf(best[j] + x2[j], 0.f);
    if (full) {
#pragma unroll
      for (int i = 0; i < kManyQ / 4; ++i) {
        reinterpret_cast<float4*>(out_val + g)[i] =
            make_float4(val[4 * i], val[4 * i + 1], val[4 * i + 2], val[4 * i + 3]);
        reinterpret_cast<int4*>(out_idx + g)[i] =
            make_int4(bi[4 * i], bi[4 * i + 1], bi[4 * i + 2], bi[4 * i + 3]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kManyQ; ++j) {
        if (g + j >= lo && g + j < hi) {
          out_val[g + j] = val[j];
          out_idx[g + j] = bi[j];
        }
      }
    }
  }
}

cudaError_t launch_many_queries(const float* q, const float* t, const float* bias, float* val,
                                int32_t* idx, int B, int M, int V, cudaStream_t s) {
  // resident blocks on the card, once per device
  static int cached_device = -1, resident = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess && device != cached_device) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, nearest_many_queries,
                                                          kThreads, 0);
    }
    if (err == cudaSuccess) {
      resident = max(1, sms * per_sm);
      cached_device = device;
    }
  }
  if (err != cudaSuccess) return err;
  // groups of kManyQ flat query indices touching an element: at most
  // (M - 1) / kManyQ + 2
  const int n_tiles = ((M - 1) / kManyQ + 2 + kThreads - 1) / kThreads;
  if ((long long)B * n_tiles > INT_MAX) return cudaErrorInvalidValue;
  const int n_items = B * n_tiles;
  const int per_block = (n_items + resident - 1) / resident;
  const int aligned = (((uintptr_t)q | (uintptr_t)val | (uintptr_t)idx) & 15u) == 0;
  nearest_many_queries<<<(n_items + per_block - 1) / per_block, kThreads, 0, s>>>(
      q, t, bias, val, idx, M, V, n_tiles, n_items, per_block, aligned);
  return cudaGetLastError();
}

// ----------------------------------------------------------- backward pass
//
// dy[b, v] = -sum_m diff[b, m] [idx[b, m] = v], dbias[b, v] = sum_m g[b, m]
// [idx[b, m] = v]: the TPU's one-hot matmul becomes a scatter with no
// atomics.  One block per (row b, tile of kBwdTile vertices), the tiles of
// a row on consecutive blocks, so that the blocks in flight write one
// contiguous stretch of the outputs (consecutive blocks on consecutive
// rows measured 14 % slower).  The tile is zeroed in shared memory while
// the row's (idx, diff, g) loads are in flight, they are staged there, one warp ballots which entries land in the tile (indices
// outside [0, V) never do), four of its lanes (dy's x, y, z and dbias) add
// those in ascending m, and the block stores the tile with 16-byte stores.
// Every output element is written once, and each sum is taken in the order
// m = 0, 1, ..., as the CPU's index_add_ takes it, so the result repeats
// bit for bit.  Bound by the output bytes: a block's own latency (the
// loads, ~M / tiles serial adds) is short beside its 16 KB of stores.

constexpr int kBwdTile = 1024;  // vertices per block

// n floats from shared src to global dst with 16-byte stores after the
// first `lead` = lead_to_16(dst, n) scalars; src + lead is 16-byte aligned.
__device__ __forceinline__ void store_from_shared(float* __restrict__ dst, const float* src,
                                                  int n, int lead) {
  for (int i = threadIdx.x; i < lead; i += blockDim.x) dst[i] = src[i];
  const int n4 = (n - lead) >> 2;
  float4* __restrict__ d4 = reinterpret_cast<float4*>(dst + lead);
  const float4* s4 = reinterpret_cast<const float4*>(src + lead);
  for (int i = threadIdx.x; i < n4; i += blockDim.x) d4[i] = s4[i];
  for (int i = lead + 4 * n4 + threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

__global__ void __launch_bounds__(kThreads)
min_sqdist_bwd_tiles(const int32_t* __restrict__ idx, const float* __restrict__ diff,
                     const float* __restrict__ g, float* __restrict__ dy,
                     float* __restrict__ dbias, int M, int V, int n_tiles) {
  // +4: each tile starts at the shift that makes its aligned stores aligned
  __shared__ __align__(16) float s_dy[3 * kBwdTile + 4];
  __shared__ __align__(16) float s_db[kBwdTile + 4];
  __shared__ int s_i[kThreads];
  __shared__ float s_g[kThreads];
  __shared__ float s_d[3 * kThreads];

  const int tid = threadIdx.x;
  const int b = blockIdx.x / n_tiles, v0 = (blockIdx.x % n_tiles) * kBwdTile;
  const int n = min(kBwdTile, V - v0);
  float* __restrict__ dy_t = dy + ((size_t)b * V + v0) * 3;
  float* __restrict__ db_t = dbias + (size_t)b * V + v0;
  const int lead_y = lead_to_16(dy_t, 3 * n), lead_b = lead_to_16(db_t, n);
  float* ty = s_dy + ((4 - lead_y) & 3);
  float* tbias = s_db + ((4 - lead_b) & 3);

  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int m0 = 0; m0 == 0 || m0 < M; m0 += kThreads) {  // M = 0: one pass, no entries
    const int cnt = min(kThreads, M - m0);
    const size_t r0 = (size_t)b * M + m0;
    int iv = 0;
    float gv = 0.f, dv[3] = {0.f, 0.f, 0.f};
    if (tid < cnt) {  // the loads are in flight while the tile is zeroed
      iv = idx[r0 + tid];
      gv = g[r0 + tid];
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (c * kThreads + tid < 3 * cnt) dv[c] = diff[3 * r0 + c * kThreads + tid];
    }
    if (m0 == 0) {
      for (int i = tid; i < (3 * kBwdTile + 4) / 4; i += kThreads) {
        reinterpret_cast<float4*>(s_dy)[i] = zero;
      }
      for (int i = tid; i < (kBwdTile + 4) / 4; i += kThreads) {
        reinterpret_cast<float4*>(s_db)[i] = zero;
      }
    }
    if (tid < cnt) {
      s_i[tid] = iv;
      s_g[tid] = gv;
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (c * kThreads + tid < 3 * cnt) s_d[c * kThreads + tid] = dv[c];
    }
    __syncthreads();
    // warp 0: a ballot per 32 entries picks those that land in the tile;
    // lanes 0-2 (dy's x, y, z) and 3 (dbias) add them in ascending m
    if (tid < 32) {
      for (int k0 = 0; k0 < cnt; k0 += 32) {
        const int v = k0 + tid < cnt ? s_i[k0 + tid] - v0 : -1;
        unsigned hit = __ballot_sync(kFull, v >= 0 && v < n);
        if (tid < 4) {
          while (hit) {
            const int k = k0 + __ffs(hit) - 1;
            hit &= hit - 1;
            const int vk = s_i[k] - v0;
            if (tid < 3) {
              ty[3 * vk + tid] -= s_d[3 * k + tid];
            } else {
              tbias[vk] += s_g[k];
            }
          }
        }
      }
    }
    __syncthreads();
  }

  store_from_shared(dy_t, ty, 3 * n, lead_y);
  store_from_shared(db_t, tbias, n, lead_b);
}

// A launch's error, cleared so that the next launch, ours or PyTorch's,
// does not report it again.
int launch_result(cudaError_t err) {
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}

}  // namespace

extern "C" {

// The dynamic shared memory the staged pass asks for at (M, V) when it
// stages the whole frame, and the most that `device` lets one of its blocks
// have beside the kernel's static arrays: the staged frame takes 16 bytes
// per target, so a whole frame is limited to about 14,000 targets on an
// H100 (the rank pass refuses more; the forward stages such a frame in
// chunks).
int uuo_staged_smem(int M, int V, int device, long long* need, long long* limit) {
  *need = (long long)staged_plan(M, V, -1).smem;
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, nearest_staged<1, false, false>);
  *limit = err == cudaSuccess ? (long long)optin - (long long)attr.sharedSizeBytes : 0;
  if (err != cudaSuccess) cudaGetLastError();  // not reported again by the next launch
  return (int)err;
}

// markers [B, M, 3], verts [B, V, 3], bias [B / bias_div, V] or NULL
// -> idx [B, M] int32 (B = lanes x frames, bias_div = frames).  A V whose
// frame does not fit in shared memory (uuo_staged_smem) returns the refused
// attribute's error.
int uuo_rank_nearest(const float* markers, const float* verts, const float* bias,
                     int32_t* idx, int B, int bias_div, int M, int V, void* stream) {
  if (B > 0 && M > 0 && V > 0) {
    return launch_result(launch_staged<false>(markers, verts, bias, bias_div, nullptr, idx, B, M,
                                              V, -1, (cudaStream_t)stream));
  }
  return (int)cudaGetLastError();
}

// Few queries (M <= V): x [B, M, 3], y [B, V, 3], bias [B, V] -> val [B, M]
// (min d2 + bias, clamped >= 0), idx [B, M] int32.  smem_limit is
// uuo_staged_smem's limit: a frame beyond it is staged in chunks.
int uuo_min_sqdist_fwd(const float* x, const float* y, const float* bias, float* val,
                       int32_t* idx, int B, int M, int V, long long smem_limit, void* stream) {
  if (B > 0 && M > 0 && V > 0) {
    return launch_result(launch_staged<true>(x, y, bias, 1, val, idx, B, M, V, smem_limit,
                                             (cudaStream_t)stream));
  }
  return (int)cudaGetLastError();
}

// Many queries (M > V, any V): the same function as uuo_min_sqdist_fwd.
int uuo_min_sqdist_fwd_rev(const float* x, const float* y, const float* bias, float* val,
                           int32_t* idx, int B, int M, int V, void* stream) {
  if (B > 0 && M > 0 && V > 0) {
    return launch_result(launch_many_queries(x, y, bias, val, idx, B, M, V, (cudaStream_t)stream));
  }
  return (int)cudaGetLastError();
}

// idx [B, M] int32, diff [B, M, 3], g [B, M] -> dy [B, V, 3], dbias [B, V],
// every element written (the caller need not clear them).
int uuo_min_sqdist_bwd(const int32_t* idx, const float* diff, const float* g, float* dy,
                       float* dbias, int B, int M, int V, void* stream) {
  if (B > 0 && V > 0) {
    const int n_tiles = (V + kBwdTile - 1) / kBwdTile;
    min_sqdist_bwd_tiles<<<(unsigned)((long long)B * n_tiles), kThreads, 0,
                           (cudaStream_t)stream>>>(idx, diff, g, dy, dbias, M, V, n_tiles);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
