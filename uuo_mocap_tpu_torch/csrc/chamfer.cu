// Nearest-vertex kernels for Hopper (sm_90a): the CUDA counterparts of the
// three Pallas TPU kernels in uuo_mocap_tpu/ops/chamfer_pallas.py.
//
//   uuo_rank_nearest    <- _rank_kernel / ranked_nearest_pallas (:195-284)
//   uuo_min_sqdist_fwd  <- _kernel / min_sqdist_pallas          (:33-122)
//   uuo_min_sqdist_bwd  <- _bwd_kernel / make_min_grad_y         (:125-189)
//
// Plain C interface (bound with ctypes from ops/chamfer_kernels.py): every
// entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() so a refused launch reaches the wrapper.
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
// frame) the pair count makes them FP32-rate bound (67 TFLOP/s) rather
// than HBM bound.
// The design keeps the whole [M, V] distance tile in registers: targets are
// split across the block's threads, each thread keeps a running
// (min, argmin) per query, and one warp-shuffle + shared-memory reduction
// per query finishes the block.  The backward is a scatter of B*M rows and
// is bound by the zeroed [B, V, 3] + [B, V] outputs it writes.

#include <cuda_runtime.h>
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

// Mean of the n points p[n, 3] into s_c[0..2]; every thread of the block
// must call it.
__device__ __forceinline__ void block_centroid(const float* __restrict__ p, int n,
                                               float* s_c, float* s_red) {
  float sx = 0.f, sy = 0.f, sz = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    sx += p[3 * i + 0];
    sy += p[3 * i + 1];
    sz += p[3 * i + 2];
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
    for (int w = 0; w < kWarps; ++w) {
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
template <int Q, bool kWriteVal>
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
      if (kWriteVal) out_val[(size_t)b * M + m0 + tid] = fmaxf(bv + s_q[tid].w, 0.f);
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

// dy[b, idx[b, m]] -= diff[b, m]; dbias[b, idx[b, m]] += g[b, m], with
// atomics into outputs the caller zeroed.
__global__ void __launch_bounds__(kThreads)
min_sqdist_bwd_scatter(const int32_t* __restrict__ idx, const float* __restrict__ diff,
                       const float* __restrict__ g, float* __restrict__ dy,
                       float* __restrict__ dbias, long long n, int M, int V) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int v = idx[i];
  if (v < 0 || v >= V) return;
  const long long row = (i / M) * V + v;
  atomicAdd(dy + 3 * row + 0, -diff[3 * i + 0]);
  atomicAdd(dy + 3 * row + 1, -diff[3 * i + 1]);
  atomicAdd(dy + 3 * row + 2, -diff[3 * i + 2]);
  atomicAdd(dbias + row, g[i]);
}

template <bool kWriteVal>
void launch_split(const float* q, const float* t, const float* bias, int bias_div,
                  float* val, int32_t* idx, int B, int M, int V, cudaStream_t s) {
  if (M <= 16) {
    nearest_split_targets<16, kWriteVal><<<B, kThreads, 0, s>>>(q, t, bias, bias_div, val, idx, M, V);
  } else if (M <= 32) {
    nearest_split_targets<32, kWriteVal><<<B, kThreads, 0, s>>>(q, t, bias, bias_div, val, idx, M, V);
  } else if (M <= 48) {
    nearest_split_targets<48, kWriteVal><<<B, kThreads, 0, s>>>(q, t, bias, bias_div, val, idx, M, V);
  } else {
    nearest_split_targets<64, kWriteVal><<<B, kThreads, 0, s>>>(q, t, bias, bias_div, val, idx, M, V);
  }
}

}  // namespace

extern "C" {

// markers [B, M, 3], verts [B, V, 3], bias [B / bias_div, V] or NULL
// -> idx [B, M] int32 (B = lanes x frames, bias_div = frames).
int uuo_rank_nearest(const float* markers, const float* verts, const float* bias,
                     int32_t* idx, int B, int bias_div, int M, int V, void* stream) {
  if (B > 0 && M > 0 && V > 0) {
    launch_split<false>(markers, verts, bias, bias_div, nullptr, idx, B, M, V,
                        (cudaStream_t)stream);
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
      launch_split<true>(x, y, bias, 1, val, idx, B, M, V, s);
    }
  }
  return (int)cudaGetLastError();
}

// idx [B, M] int32, diff [B, M, 3], g [B, M] -> dy [B, V, 3], dbias [B, V]
// (both zeroed by the caller).
int uuo_min_sqdist_bwd(const int32_t* idx, const float* diff, const float* g, float* dy,
                       float* dbias, int B, int M, int V, void* stream) {
  const long long n = (long long)B * M;
  if (n > 0 && V > 0) {
    const long long blocks = (n + kThreads - 1) / kThreads;
    min_sqdist_bwd_scatter<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        idx, diff, g, dy, dbias, n, M, V);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
