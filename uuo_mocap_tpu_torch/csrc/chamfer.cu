// Nearest-vertex kernels for Hopper (sm_90a): the CUDA counterparts of the
// three Pallas TPU kernels in uuo_mocap_tpu/ops/chamfer_pallas.py.
//
//   uuo_rank_nearest    <- _rank_kernel / ranked_nearest_pallas (:195-284)
//   uuo_min_sqdist_fwd  <- _kernel / min_sqdist_pallas          (:33-122)
//   uuo_min_sqdist_bwd  <- _bwd_kernel / make_min_grad_y         (:125-189)
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
// min per pair) is the practical floor.  The backward is bound by writing
// its [B, V, 3] + [B, V] outputs.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTargetTile = 1024;  // targets staged per pass, thread-per-query
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

// One block per batch element b: queries q[b, M, 3] against targets
// t[b, V, 3] (+ bias row b / bias_div, or none).  Q queries per pass are
// held in registers; the block's threads split the targets.
template <int Q>
__global__ void __launch_bounds__(kThreads)
nearest_split_targets(const float* __restrict__ q, const float* __restrict__ t,
                      const float* __restrict__ bias, int bias_div,
                      float* __restrict__ out_val, int32_t* __restrict__ out_idx,
                      int M, int V) {
  __shared__ float s_c[3];
  __shared__ float s_red[3 * kWarps];
  __shared__ float4 s_q[Q];
  __shared__ float s_bv[kWarps * Q];
  __shared__ int s_bi[kWarps * Q];

  const int b = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float* __restrict__ tb = t + (size_t)b * V * 3;
  const float* __restrict__ qb = q + (size_t)b * M * 3;
  const float* __restrict__ bb = bias ? bias + (size_t)(b / bias_div) * V : nullptr;

  block_centroid(tb, V, s_c, s_red);
  const float cx = s_c[0], cy = s_c[1], cz = s_c[2];

  for (int m0 = 0; m0 < M; m0 += Q) {
    const int mc = min(Q, M - m0);
    if (tid < Q) {  // (-2 q, |q|^2), centered
      float x = 0.f, y = 0.f, z = 0.f;
      if (tid < mc) {
        x = qb[3 * (m0 + tid) + 0] - cx;
        y = qb[3 * (m0 + tid) + 1] - cy;
        z = qb[3 * (m0 + tid) + 2] - cz;
      }
      s_q[tid] = make_float4(-2.f * x, -2.f * y, -2.f * z, x * x + y * y + z * z);
    }
    __syncthreads();

    float best[Q];
    int bidx[Q];
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      best[j] = INFINITY;
      bidx[j] = 0;
    }
    for (int v = tid; v < V; v += kThreads) {
      const float yx = tb[3 * v + 0] - cx;
      const float yy = tb[3 * v + 1] - cy;
      const float yz = tb[3 * v + 2] - cz;
      float w = yx * yx + yy * yy + yz * yz;
      if (bb) w += bb[v];
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        const float4 qq = s_q[j];
        const float d = fmaf(qq.x, yx, fmaf(qq.y, yy, fmaf(qq.z, yz, w)));
        if (d < best[j]) {  // strict: a thread's lowest index wins its ties
          best[j] = d;
          bidx[j] = v;
        }
      }
    }

#pragma unroll
    for (int j = 0; j < Q; ++j) {
      float bv = best[j];
      int bi = bidx[j];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_down_sync(kFull, bv, o);
        const int oi = __shfl_down_sync(kFull, bi, o);
        if (better(ov, oi, bv, bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (lane == 0) {
        s_bv[warp * Q + j] = bv;
        s_bi[warp * Q + j] = bi;
      }
    }
    __syncthreads();
    if (tid < mc) {
      float bv = s_bv[tid];
      int bi = s_bi[tid];
      for (int w = 1; w < kWarps; ++w) {
        const float ov = s_bv[w * Q + tid];
        const int oi = s_bi[w * Q + tid];
        if (better(ov, oi, bv, bi)) {
          bv = ov;
          bi = oi;
        }
      }
      out_idx[(size_t)b * M + m0 + tid] = bi;
      out_val[(size_t)b * M + m0 + tid] = fmaxf(bv + s_q[tid].w, 0.f);
    }
    __syncthreads();
  }
}

// Many queries, few targets (the reverse direction of the bidirectional
// chamfer: 6890 vertices against 41 markers).  Each thread owns one query;
// the targets are staged through shared memory in tiles.
__global__ void __launch_bounds__(kThreads)
nearest_thread_per_query(const float* __restrict__ q, const float* __restrict__ t,
                         const float* __restrict__ bias,
                         float* __restrict__ out_val, int32_t* __restrict__ out_idx,
                         int M, int V, int q_blocks) {
  __shared__ float s_c[3];
  __shared__ float s_red[3 * kWarps];
  __shared__ float4 s_t[kTargetTile];

  const int b = blockIdx.x / q_blocks;
  const int m = (blockIdx.x % q_blocks) * kThreads + threadIdx.x;
  const float* __restrict__ tb = t + (size_t)b * V * 3;
  const float* __restrict__ bb = bias + (size_t)b * V;

  block_centroid(tb, V, s_c, s_red);
  const float cx = s_c[0], cy = s_c[1], cz = s_c[2];

  float x = 0.f, y = 0.f, z = 0.f;
  if (m < M) {
    const float* qm = q + ((size_t)b * M + m) * 3;
    x = qm[0] - cx;
    y = qm[1] - cy;
    z = qm[2] - cz;
  }
  const float x2 = x * x + y * y + z * z;
  const float nx = -2.f * x, ny = -2.f * y, nz = -2.f * z;
  float best = INFINITY;
  int bi = 0;
  for (int v0 = 0; v0 < V; v0 += kTargetTile) {
    const int n = min(kTargetTile, V - v0);
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int v = v0 + i;
      const float yx = tb[3 * v + 0] - cx;
      const float yy = tb[3 * v + 1] - cy;
      const float yz = tb[3 * v + 2] - cz;
      s_t[i] = make_float4(yx, yy, yz, (yx * yx + yy * yy + yz * yz) + bb[v]);
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      const float4 tt = s_t[i];
      const float d = fmaf(nx, tt.x, fmaf(ny, tt.y, fmaf(nz, tt.z, tt.w)));
      if (d < best) {
        best = d;
        bi = v0 + i;
      }
    }
    __syncthreads();
  }
  if (m < M) {
    out_idx[(size_t)b * M + m] = bi;
    out_val[(size_t)b * M + m] = fmaxf(best + x2, 0.f);
  }
}

void launch_split(const float* q, const float* t, const float* bias, int bias_div,
                  float* val, int32_t* idx, int B, int M, int V, cudaStream_t s) {
  if (M <= 16) {
    nearest_split_targets<16><<<B, kThreads, 0, s>>>(q, t, bias, bias_div, val, idx, M, V);
  } else if (M <= 32) {
    nearest_split_targets<32><<<B, kThreads, 0, s>>>(q, t, bias, bias_div, val, idx, M, V);
  } else if (M <= 48) {
    nearest_split_targets<48><<<B, kThreads, 0, s>>>(q, t, bias, bias_div, val, idx, M, V);
  } else {
    nearest_split_targets<64><<<B, kThreads, 0, s>>>(q, t, bias, bias_div, val, idx, M, V);
  }
}


// --------------------------------------------------------------- rank pass
//
// One block per (lane, frame) problem: M queries against the frame's V
// vertices.  The design answers what bounds the pass on this card:
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
// Ties keep the lowest index: strict < across groups, the first equal
// target inside a group, then better() across lanes and splits.

constexpr int kRankRows = 8;                  // rows of 32 targets per lazy-argmin group
constexpr int kRankGroup = 32 * kRankRows;    // targets per group
constexpr int kRankMaxQ = 8;                  // queries held by one lane
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

// Dynamic shared memory: the staged frame (4 floats per padded target, +4
// for the raw copy's alignment shift), then the per-split partial (min,
// argmin) of every query slot.
__host__ __device__ __forceinline__ size_t rank_smem_floats(int V) {
  return (size_t)4 * rank_target_groups(V) * kRankGroup + 4;
}

template <int Q>
__global__ void __launch_bounds__(kRankMaxWarps * 32, 2)
rank_nearest_staged(const float* __restrict__ q, const float* __restrict__ t,
                    const float* __restrict__ bias, int bias_div,
                    int32_t* __restrict__ out_idx, int M, int V, int groups, int splits) {
  extern __shared__ float4 s_t[];
  __shared__ float s_c[3];
  __shared__ float s_red[3 * kRankMaxWarps];

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int n_tgroups = rank_target_groups(V);
  float* s_f = reinterpret_cast<float*>(s_t);
  float* s_pv = s_f + rank_smem_floats(V);                          // [splits][groups * Q]
  int* s_pi = reinterpret_cast<int*>(s_pv + splits * groups * Q);  // [splits][groups * Q]
  const float* __restrict__ tb = t + (size_t)b * V * 3;

  // 1. The frame's 3V floats into s_f[R, R + 3V), R >= V chosen so that
  //    the 16-byte-aligned part of the source lands 16-byte aligned.
  const int n3 = 3 * V;
  const int head = lead_to_16(tb, n3);
  const int R = V + ((4 - ((V + head) & 3)) & 3);
  const int n4 = (n3 - head) >> 2;
  for (int i = tid; i < n4; i += blockDim.x) cp_async16(s_f + R + head + 4 * i, tb + head + 4 * i);
  for (int i = tid; i < head; i += blockDim.x) s_f[R + i] = tb[i];
  for (int i = head + 4 * n4 + tid; i < n3; i += blockDim.x) s_f[R + i] = tb[i];
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // 2. The target centroid, from shared memory, in block_centroid's fixed
  //    order: the same bits as the forward kernel's centroid of the frame.
  block_centroid(s_f + R, V, s_c, s_red);
  const float cx = s_c[0], cy = s_c[1], cz = s_c[2];

  // 3. Rewrite in place as float4 (t - c, |t - c|^2 + bias), one chunk of
  //    blockDim targets at a time in ascending order: chunk k's float4s end
  //    at 16 (k + 1) blockDim bytes, below the raw floats of any later
  //    chunk (R >= V), so one barrier between reading and writing a chunk
  //    suffices.  Padding targets (to whole groups) never win: w = +inf.
  const float* __restrict__ bb = bias ? bias + (size_t)(b / bias_div) * V : nullptr;
  for (int v0 = 0; v0 < V; v0 += blockDim.x) {
    const int v = v0 + tid;
    float x = 0.f, y = 0.f, z = 0.f, w = 0.f;
    if (v < V) {
      x = s_f[R + 3 * v + 0] - cx;
      y = s_f[R + 3 * v + 1] - cy;
      z = s_f[R + 3 * v + 2] - cz;
      w = x * x + y * y + z * z;
      if (bb) w += bb[v];
    }
    __syncthreads();
    if (v < V) s_t[v] = make_float4(x, y, z, w);
  }
  __syncthreads();
  for (int v = V + tid; v < n_tgroups * kRankGroup; v += blockDim.x) {
    s_t[v] = make_float4(0.f, 0.f, 0.f, INFINITY);
  }
  __syncthreads();

  // 4. Scan: warp item = (query group g, target split s).
  const float* __restrict__ qb = q + (size_t)b * M * 3;
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
      if (bgrp[i] < n_tgroups) {
        const float4* tp = s_t + bgrp[i] * kRankGroup + lane;
        for (int r = kRankRows - 1; r >= 0; --r) {
          if (rank_key(qx[i], qy[i], qz[i], tp[32 * r]) == best[i]) {
            bi = bgrp[i] * kRankGroup + 32 * r + lane;
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
      if (lane == 0) {
        s_pv[s * groups * Q + g * Q + i] = bv;
        s_pi[s * groups * Q + g * Q + i] = bi;
      }
    }
  }
  __syncthreads();

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
  }
}

// The launch shape of the rank pass for M queries against V targets.
struct RankPlan {
  int groups, Q, splits, warps;
  size_t smem;  // dynamic shared memory, bytes
};

RankPlan rank_plan(int M, int V) {
  RankPlan p;
  p.groups = (M + kRankMaxQ - 1) / kRankMaxQ;
  p.Q = (M + p.groups - 1) / p.groups;
  p.splits = max(1, min(kRankMaxWarps / p.groups, rank_target_groups(V)));
  p.warps = max(kWarps, min(p.groups * p.splits, kRankMaxWarps));
  p.smem = rank_smem_floats(V) * sizeof(float) + (size_t)p.splits * p.groups * p.Q * 8;
  return p;
}

template <int Q>
cudaError_t launch_rank_q(const float* q, const float* t, const float* bias, int bias_div,
                          int32_t* idx, int B, int M, int V, const RankPlan& p, cudaStream_t s) {
  const cudaError_t err = cudaFuncSetAttribute(
      rank_nearest_staged<Q>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return err;
  rank_nearest_staged<Q><<<B, p.warps * 32, p.smem, s>>>(q, t, bias, bias_div, idx, M, V,
                                                         p.groups, p.splits);
  return cudaGetLastError();
}

cudaError_t launch_rank(const float* q, const float* t, const float* bias, int bias_div,
                        int32_t* idx, int B, int M, int V, cudaStream_t s) {
  const RankPlan p = rank_plan(M, V);
#define UUO_RANK_CASE(QQ) \
  case QQ:                \
    return launch_rank_q<QQ>(q, t, bias, bias_div, idx, B, M, V, p, s);
  switch (p.Q) {
    UUO_RANK_CASE(1)
    UUO_RANK_CASE(2)
    UUO_RANK_CASE(3)
    UUO_RANK_CASE(4)
    UUO_RANK_CASE(5)
    UUO_RANK_CASE(6)
    UUO_RANK_CASE(7)
    UUO_RANK_CASE(8)
  }
#undef UUO_RANK_CASE
  return cudaErrorInvalidValue;
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

}  // namespace

extern "C" {

// The dynamic shared memory the rank pass asks for at (M, V), and the most
// that `device` lets one of its blocks have beside the kernel's static
// arrays: the staged frame takes 16 bytes per target, so V is limited to
// about 14,000 on an H100.
int uuo_rank_smem(int M, int V, int device, long long* need, long long* limit) {
  *need = (long long)rank_plan(M, V).smem;
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, rank_nearest_staged<1>);
  *limit = err == cudaSuccess ? (long long)optin - (long long)attr.sharedSizeBytes : 0;
  if (err != cudaSuccess) cudaGetLastError();  // not reported again by the next launch
  return (int)err;
}

// markers [B, M, 3], verts [B, V, 3], bias [B / bias_div, V] or NULL
// -> idx [B, M] int32 (B = lanes x frames, bias_div = frames).  A V whose
// frame does not fit in shared memory (uuo_rank_smem) returns the refused
// attribute's error.
int uuo_rank_nearest(const float* markers, const float* verts, const float* bias,
                     int32_t* idx, int B, int bias_div, int M, int V, void* stream) {
  if (B > 0 && M > 0 && V > 0) {
    const cudaError_t err =
        launch_rank(markers, verts, bias, bias_div, idx, B, M, V, (cudaStream_t)stream);
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it: the next launch, ours or PyTorch's, must not report it
      return (int)err;
    }
  }
  return (int)cudaGetLastError();
}

// x [B, M, 3], y [B, V, 3], bias [B, V] -> val [B, M] (min d2 + bias,
// clamped >= 0), idx [B, M] int32.  Any M: few-query problems split the
// targets across a block, many-query problems give each thread a query.
int uuo_min_sqdist_fwd(const float* x, const float* y, const float* bias, float* val,
                       int32_t* idx, int B, int M, int V, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B > 0 && M > 0 && V > 0) {
    if (M > V) {
      const int q_blocks = (M + kThreads - 1) / kThreads;
      nearest_thread_per_query<<<B * q_blocks, kThreads, 0, s>>>(x, y, bias, val, idx, M, V,
                                                                 q_blocks);
    } else {
      launch_split(x, y, bias, 1, val, idx, B, M, V, s);
    }
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
