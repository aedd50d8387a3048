// The dense SMPL forward's vertices for Hopper (sm_90a), no gradient.
//
//   uuo_lbs_vertices: pose_feature [N, 207], betas [N, 10], A [N, 24, 12],
//   trans [N, 3] and the model's basis -> vertices [N, V, 3]
//
// It replaces no TPU kernel: the JAX package leaves the dense forward to
// XLA.  It was added because the port's no-grad dense forward, which every
// part-fit and chamfer-stage evaluation runs only to hand the rank kernel
// its vertices, ran as a chain of FP32 GEMMs and broadcasts with a
// [N, V, 3, 4] skinning tensor (9.5 GB at 28,800 rows) and five [N, V, 3]
// temporaries between them.
//
// Per row it computes, in FP32 throughout (no TF32, no tensor cores):
//   v_posed = v_template + shapedirs . betas + posedirs^T . pose_feature
//   T_v     = sum over the vertex's nonzero LBS weights w_j of w_j A_j
//   vertex  = T_v[:, :3] v_posed + T_v[:, 3] + trans
// The first line is one product of the row [pose_feature, betas, 1] (K =
// 218, padded to 224 with zeros) with the model's basis [posedirs;
// shapedirs; v_template] (built once per model, its columns padded to whole
// vertex tiles), so the shape term rides in the main loop.
//
// What bounds it on an H100: arithmetic.  A row needs 2 x 207 x 3V FLOP of
// pose correctives (8.56 MFLOP at V = 6890), 0.41 of shape, 0.66 of
// skinning over four weights and 0.17 of the 3x4 transform: 9.8 MFLOP, or
// 0.146 us at 67 TFLOP/s, against 82.7 KB of output (0.025 us at 3.35
// TB/s).  The design: a block of 4 warps owns 32 rows x 128 vertices (384
// columns); each warp 8 rows, each lane 8 rows x 4 whole vertices (96
// accumulators in registers).  The row tile and the basis tile stream
// through a two-stage ring of shared memory by cp.async; a k step is two
// broadcast and three conflict-free 16-byte shared loads per lane for 96
// FFMAs.  The row tile's 24 transforms (36 KB) and the vertex tile's weight
// list are staged once per block beside the ring, so the epilogue applies
// each vertex's transform from registers and shared memory and writes each
// vertex once.  Two blocks share an SM (92 KB of shared memory each), so
// one's epilogue runs beside the other's main loop (on an H100 SXM at 700
// W and 28,800 rows: 8.50 ms, against 8.85 ms for one block of 64 rows).
// Consecutive blocks take consecutive vertex tiles of one row tile, so the
// basis (18.6 MB) stays in L2 while the rows stream through once.
//
// Plain C interface (bound with ctypes from ops/lbs_kernels.py): launches on
// the caller's stream, allocates nothing, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 32;              // rows per block: 4 warps x 8
constexpr int kVerts = 128;            // vertices per block: 32 lanes x 4
constexpr int kCols = 3 * kVerts;      // basis columns per block
constexpr int kDepth = 224;            // 207 + 10 + 1, padded to kStep
constexpr int kStep = 16;              // k per stage
constexpr int kStages = 2;
constexpr int kPose = 207;
constexpr int kBetas = 10;
constexpr int kJoints = 24;
constexpr int kAff = kJoints * 12;     // one row's transforms, floats

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

size_t smem_bytes(int width) {
  return sizeof(float) * ((size_t)kStages * kStep * (kRows + kCols) + (size_t)kRows * kAff) +
         (size_t)width * kVerts * (sizeof(int) + sizeof(float));
}

// One stage of the ring: rows [row0, row0 + 64) of [pose_feature, betas, 1,
// 0...] at k in [k0, k0 + 16), stored [k][row]; the basis rows k0.. at the
// block's 384 columns, stored [k][col].  Rows past N read as zero.
__device__ __forceinline__ void load_stage(float* sA, float* sB, const float* __restrict__ pf,
                                           const float* __restrict__ betas,
                                           const float* __restrict__ basis, long long ldb,
                                           int row0, int col0, int N, int k0) {
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < kStep * kRows / kThreads; ++i) {
    const int e = t + kThreads * i;
    const int kk = e / kRows, m = e % kRows;
    const int k = k0 + kk, n = row0 + m;
    float* dst = sA + kk * kRows + m;
    if (k < kPose + kBetas) {
      const bool valid = n < N;
      const float* src = k < kPose ? pf + (size_t)n * kPose + k : betas + (size_t)n * kBetas + (k - kPose);
      cp_async4(dst, valid ? src : pf, valid);
    } else {
      *dst = (k == kPose + kBetas && n < N) ? 1.f : 0.f;
    }
  }
#pragma unroll
  for (int i = 0; i < kStep * kCols / 4 / kThreads; ++i) {
    const int c = t + kThreads * i;
    const int kk = c / (kCols / 4), c4 = c % (kCols / 4);
    cp_async16(sB + kk * kCols + 4 * c4, basis + (size_t)(k0 + kk) * ldb + col0 + 4 * c4, true);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
lbs_vertices(const float* __restrict__ pf, const float* __restrict__ betas,
             const float* __restrict__ aff, const float* __restrict__ trans,
             const float* __restrict__ basis, const int32_t* __restrict__ joints,
             const float* __restrict__ weights, float* __restrict__ out, int N, int V,
             int width, long long ldb, int vertex_tiles) {
  extern __shared__ float4 smem4[];
  float* sA = reinterpret_cast<float*>(smem4);        // [stage][k][row]
  float* sB = sA + kStages * kStep * kRows;           // [stage][k][col]
  float* sT = sB + kStages * kStep * kCols;           // [row][joint][12]
  int* sJ = reinterpret_cast<int*>(sT + kRows * kAff);  // [slot][u][lane]
  float* sW = reinterpret_cast<float*>(sJ + width * kVerts);

  const int vt = blockIdx.x % vertex_tiles, rt = blockIdx.x / vertex_tiles;
  const int row0 = rt * kRows, v0 = vt * kVerts, col0 = 3 * v0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // the row tile's transforms and the vertex tile's weight list, in the
  // first stage's group; vertex 4 l + u of the tile at [slot][u][l]
  for (int c = threadIdx.x; c < kRows * kAff / 4; c += kThreads) {
    const int m = c / (kAff / 4);
    const bool valid = row0 + m < N;
    cp_async16(sT + 4 * c, valid ? aff + (size_t)row0 * kAff + 4 * c : aff, valid);
  }
  for (int e = threadIdx.x; e < width * kVerts; e += kThreads) {
    const int v = e / width, s = e % width;
    const int at = (s * 4 + (v & 3)) * 32 + (v >> 2);
    const bool valid = v0 + v < V;
    sJ[at] = valid ? joints[(size_t)(v0 + v) * width + s] : 0;
    sW[at] = valid ? weights[(size_t)(v0 + v) * width + s] : 0.f;
  }
  constexpr int kTiles = kDepth / kStep;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    load_stage(sA + s * kStep * kRows, sB + s * kStep * kCols, pf, betas, basis, ldb, row0, col0, N,
               s * kStep);
    cp_async_commit();
  }

  float acc[8][12];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 12; ++j) acc[i][j] = 0.f;

  for (int kt = 0; kt < kTiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt landed for every thread; tile kt - 1 no longer read
    const int next = kt + kStages - 1;
    if (next < kTiles) {
      const int s = next % kStages;
      load_stage(sA + s * kStep * kRows, sB + s * kStep * kCols, pf, betas, basis, ldb, row0, col0,
                 N, next * kStep);
    }
    cp_async_commit();
    const float* a = sA + (kt % kStages) * kStep * kRows + 8 * warp;
    const float* b = sB + (kt % kStages) * kStep * kCols + 12 * lane;
#pragma unroll
    for (int kk = 0; kk < kStep; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(a + kk * kRows);
      const float4 a1 = *reinterpret_cast<const float4*>(a + kk * kRows + 4);
      const float4 b0 = *reinterpret_cast<const float4*>(b + kk * kCols);
      const float4 b1 = *reinterpret_cast<const float4*>(b + kk * kCols + 4);
      const float4 b2 = *reinterpret_cast<const float4*>(b + kk * kCols + 8);
      const float ar[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float br[12] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w, b2.x, b2.y, b2.z, b2.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 12; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // epilogue, one row a pass: acc[0][3 u + d] is v_posed of row 8 warp + i,
  // vertex 4 lane + u, and the rows shift down after each pass.  A rolled
  // loop keeps the code small: unrolled over the 8 rows, the epilogue ran
  // once per block from a cold instruction cache and took longer than the
  // main loop.  Each weight slot's four vertices are four independent
  // chains of shared loads.
#pragma unroll 1
  for (int i = 0; i < 8; ++i) {
    const int m = 8 * warp + i;
    const int n = row0 + m;
    const float* Tm = sT + m * kAff;
    float T[4][12];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int c = 0; c < 12; ++c) T[u][c] = 0.f;
    for (int s = 0; s < width; ++s) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int at = (s * 4 + u) * 32 + lane;
        const float w = sW[at];
        const float4* Aj = reinterpret_cast<const float4*>(Tm + 12 * sJ[at]);
        const float4 r0 = Aj[0], r1 = Aj[1], r2 = Aj[2];
        const float r[12] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w, r2.x, r2.y, r2.z, r2.w};
#pragma unroll
        for (int c = 0; c < 12; ++c) T[u][c] = fmaf(w, r[c], T[u][c]);
      }
    }
    float tr[3] = {0.f, 0.f, 0.f};
    if (n < N) {
      tr[0] = trans[(size_t)n * 3 + 0];
      tr[1] = trans[(size_t)n * 3 + 1];
      tr[2] = trans[(size_t)n * 3 + 2];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float x = acc[0][3 * u], y = acc[0][3 * u + 1], z = acc[0][3 * u + 2];
#pragma unroll
      for (int d = 0; d < 3; ++d)
        acc[0][3 * u + d] =
            (T[u][4 * d] * x + T[u][4 * d + 1] * y + T[u][4 * d + 2] * z + T[u][4 * d + 3]) + tr[d];
    }
    if (n < N) {
      const int v = v0 + 4 * lane;
      float* o = out + ((size_t)n * V + v) * 3;
      // 4 whole vertices as six 8-byte stores where the offset 3 (n V + v)
      // is even (v is a multiple of 4, so where n V is); staging the row
      // through shared memory for wider, coalesced stores was slower
      if (v + 4 <= V && ((static_cast<size_t>(n) * V) & 1) == 0) {
#pragma unroll
        for (int c = 0; c < 6; ++c)
          *reinterpret_cast<float2*>(o + 2 * c) = make_float2(acc[0][2 * c], acc[0][2 * c + 1]);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (v + u < V) {
            o[3 * u] = acc[0][3 * u];
            o[3 * u + 1] = acc[0][3 * u + 1];
            o[3 * u + 2] = acc[0][3 * u + 2];
          }
      }
    }
#pragma unroll
    for (int r = 0; r < 7; ++r)
#pragma unroll
      for (int c = 0; c < 12; ++c) acc[r][c] = acc[r + 1][c];
  }
}

}  // namespace

extern "C" {

// The columns of the basis the kernel reads: 3 x V rounded up to whole
// vertex tiles (the caller pads the basis [224, basis_ld] with zeros).
int uuo_lbs_basis_ld(int V) { return 3 * ((V + kVerts - 1) / kVerts) * kVerts; }

// The basis's depth: rows [0, 207) posedirs, [207, 217) shapedirs, 217
// v_template, the rest zeros.
int uuo_lbs_depth() { return kDepth; }

// pf [N, 207], betas [N, 10], aff [N, 24, 12], trans [N, 3], basis [224,
// uuo_lbs_basis_ld(V)], joints / weights [V, width] (each vertex's nonzero
// LBS weights, padded with weight 0) -> out [N, V, 3].  All float32 but
// joints (int32), contiguous; out 8-byte aligned (as every allocation is).
int uuo_lbs_vertices(const float* pf, const float* betas, const float* aff, const float* trans,
                     const float* basis, const int32_t* joints, const float* weights, float* out,
                     int N, int V, int width, void* stream) {
  if (N > 0 && V > 0) {
    const size_t smem = smem_bytes(width);
    cudaError_t err =
        cudaFuncSetAttribute(lbs_vertices, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int vertex_tiles = (V + kVerts - 1) / kVerts;
    const long long blocks = (long long)vertex_tiles * ((N + kRows - 1) / kRows);
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    lbs_vertices<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
        pf, betas, aff, trans, basis, joints, weights, out, N, V, width,
        (long long)uuo_lbs_basis_ld(V), vertex_tiles);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
