// 1x1 conv as a GEMM with the BatchNorm statistics fused into its epilogue,
// for Hopper (sm_90a):
//
//   y  = cast(x @ w^T)              x (M, K), w (N, K), y (M, N)
//   s1 = sum over rows of y         (N,) f32, of the CAST y
//   s2 = sum over rows of y * y     (N,) f32
//
// Replaces the Pallas TPU kernel uda_poseestimation_tpu/ops/bn_fuse.py::
// _mm_stats_kernel (launched by _mm_stats_pallas). x is a channels_last
// activation viewed as (B*H*W, C_in) and w the conv weight (C_out, C_in), so
// both operands are K-contiguous (a "TN" product) and need no transpose.
//
// What bounds it on an H100: for most of pose_resnet101's 70 fused calls at
// b=32 the bytes. A call with large M does about KN/(K+N) flops per byte:
// 32-205 for 62 of the 70 calls, below the card's ~295 bf16 flops per byte;
// only the 8 calls with K and N both >= 512 sit above it. The design keeps y's
// statistics out of device memory: each block reduces its rounded output
// tile while it is still in registers, so the separate BatchNorm statistics
// pass (a full re-read of y) disappears, and only a (M/128, N) f32 partial
// goes out.
//
// Design, and where it departs from the TPU kernel:
// - The TPU kernel carries its sums in VMEM across a sequential grid axis.
//   Blocks here run in parallel and in no order, so each block owns one
//   (M-tile, N-tile) output tile and writes the column sums of its tile to a
//   per-M-tile partial; a second small kernel (stats_reduce_kernel) adds the
//   partials in a fixed order. Nothing is atomic: a run repeats bit for bit.
// - Epilogue: the f32 accumulators are rounded to the output type FIRST; the
//   rounded values are stored and their sums and sums of squares are taken
//   (warp shuffles over the rows a warp holds, then shared memory across the
//   two warp rows), as the TPU kernel sums the cast y.
// - bf16 (the training path): tensor cores through mma.sync m16n8k16 with f32
//   accumulation. 128x128x32 block tiles, 8 warps of 64x32, operands staged
//   in shared memory with cp.async double buffering; smem rows are padded to
//   80 bytes so the fragment loads are free of bank conflicts. wgmma and TMA
//   are later work.
// - f32: a plain SIMT FFMA kernel (64x64 tiles, 4x4 outputs a thread), NOT
//   TF32, so the card's f32 result can be held against a CPU f32 GEMM.
// - Ragged edges (M, N, K) are masked in the kernel; nothing is padded or
//   copied. The cp.async path needs K % 8 == 0 and 16-byte aligned operands
//   (every pose_resnet shape); otherwise the loads go element by element.
//   Rows and columns outside the matrix load as zeros, so they add nothing to
//   the sums, and their outputs are not stored.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// ---------------------------------------------------------------- bf16 path
constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 32;
constexpr int kLds = kBK + 8;  // padded smem row: 40 bf16 = 80 bytes = 20 words

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  // src_bytes == 0 writes 16 zero bytes and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage rows [row0, row0 + 128) x cols [k0, k0 + 32) of a K-contiguous bf16
// matrix (raw 16-bit values) into dst; zeros outside the matrix.
template <bool kVec>
__device__ __forceinline__ void load_tile(uint16_t (*dst)[kLds],
                                          const uint16_t* __restrict__ src,
                                          int rows, int k, int row0, int k0,
                                          int tid) {
  if (kVec) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads;  // 512 chunks of 8 values
      const int r = c >> 2;
      const int kc = (c & 3) * 8;
      const int gr = row0 + r;
      const int gk = k0 + kc;
      const bool ok = gr < rows && gk < k;  // K % 8 == 0: all in or all out
      cp_async16(&dst[r][kc], ok ? src + static_cast<size_t>(gr) * k + gk : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < 128 * kBK; i += kThreads) {
      const int r = i / kBK;
      const int kc = i % kBK;
      const int gr = row0 + r;
      const int gk = k0 + kc;
      dst[r][kc] =
          (gr < rows && gk < k) ? src[static_cast<size_t>(gr) * k + gk] : 0;
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
mm_stats_bf16_kernel(const uint16_t* __restrict__ x,
                     const uint16_t* __restrict__ w,
                     __nv_bfloat16* __restrict__ y, float* __restrict__ part1,
                     float* __restrict__ part2, int m, int k, int n) {
  __shared__ __align__(16) uint16_t as[2][kBM][kLds];
  __shared__ __align__(16) uint16_t bs[2][kBN][kLds];
  __shared__ float red[2][2][kBN];  // [s1 | s2][warp row][column]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 2;  // warp row: tile rows wm*64 .. +64
  const int wn = warp & 3;   // warp col: tile cols wn*32 .. +32
  const int g = lane >> 2;   // mma groupID
  const int t = lane & 3;    // mma threadID_in_group
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;

  const int nk = (k + kBK - 1) / kBK;
  load_tile<kVec>(as[0], x, m, k, m0, 0, tid);
  load_tile<kVec>(bs[0], w, n, k, n0, 0, tid);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) {
      load_tile<kVec>(as[cur ^ 1], x, m, k, m0, (kt + 1) * kBK, tid);
      load_tile<kVec>(bs[cur ^ 1], w, n, k, n0, (kt + 1) * kBK, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[4][4];
      uint32_t b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const uint16_t* p0 = &as[cur][wm * 64 + mi * 16 + g][kk + 2 * t];
        const uint16_t* p1 = p0 + 8 * kLds;  // row + 8
        a[mi][0] = *reinterpret_cast<const uint32_t*>(p0);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(p1);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(p0 + 8);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(p1 + 8);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const uint16_t* p = &bs[cur][wn * 32 + ni * 8 + g][kk + 2 * t];
        b[ni][0] = *reinterpret_cast<const uint32_t*>(p);
        b[ni][1] = *reinterpret_cast<const uint32_t*>(p + 8);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }
    __syncthreads();
  }

  // Epilogue: round, store, and sum the rounded values per column. A thread
  // holds columns 2t, 2t+1 of each 8-column fragment, in rows g and g+8.
  float c1[4][2], c2[4][2];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    c1[ni][0] = c1[ni][1] = c2[ni][0] = c2[ni][1] = 0.0f;
  }
  const bool pairs = (n & 1) == 0;  // a column pair is one aligned 4-byte store
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * 64 + mi * 16 + g + half * 8;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn * 32 + ni * 8 + 2 * t;
        const __nv_bfloat162 v = __floats2bfloat162_rn(acc[mi][ni][2 * half],
                                                       acc[mi][ni][2 * half + 1]);
        const float2 f = __bfloat1622float2(v);
        c1[ni][0] += f.x;
        c1[ni][1] += f.y;
        c2[ni][0] += f.x * f.x;
        c2[ni][1] += f.y * f.y;
        if (row < m) {
          __nv_bfloat16* out = y + static_cast<size_t>(row) * n + col;
          if (pairs && col + 1 < n) {
            *reinterpret_cast<__nv_bfloat162*>(out) = v;
          } else {
            if (col < n) out[0] = __low2bfloat16(v);
            if (col + 1 < n) out[1] = __high2bfloat16(v);
          }
        }
      }
    }
  }
  // sum over the 8 row groups of the warp (lanes with the same t)
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        c1[ni][j] += __shfl_xor_sync(0xffffffffu, c1[ni][j], off);
        c2[ni][j] += __shfl_xor_sync(0xffffffffu, c2[ni][j], off);
      }
    }
  }
  if (g == 0) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = wn * 32 + ni * 8 + 2 * t + j;
        red[0][wm][c] = c1[ni][j];
        red[1][wm][c] = c2[ni][j];
      }
    }
  }
  __syncthreads();
  if (tid < kBN && n0 + tid < n) {
    const size_t o = static_cast<size_t>(blockIdx.y) * n + n0 + tid;
    part1[o] = red[0][0][tid] + red[0][1][tid];
    part2[o] = red[1][0][tid] + red[1][1][tid];
  }
}

// ----------------------------------------------------------------- f32 path
constexpr int kFBM = 64;
constexpr int kFBN = 64;
constexpr int kFBK = 16;

// 16 x 16 threads; thread (ty, tx) owns rows ty + 16i and columns tx + 16j.
__global__ void __launch_bounds__(kThreads)
mm_stats_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    float* __restrict__ y, float* __restrict__ part1,
                    float* __restrict__ part2, int m, int k, int n) {
  __shared__ float as[kFBK][kFBM + 1];
  __shared__ float bs[kFBK][kFBN + 1];
  __shared__ float red[2][16][kFBN];

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int n0 = blockIdx.x * kFBN;
  const int m0 = blockIdx.y * kFBM;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < k; k0 += kFBK) {
    for (int i = tid; i < kFBM * kFBK; i += kThreads) {
      const int r = i / kFBK;
      const int kc = i % kFBK;
      const int gk = k0 + kc;
      const int gm = m0 + r;
      const int gn = n0 + r;
      as[kc][r] = (gm < m && gk < k) ? x[static_cast<size_t>(gm) * k + gk] : 0.0f;
      bs[kc][r] = (gn < n && gk < k) ? w[static_cast<size_t>(gn) * k + gk] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kc = 0; kc < kFBK; ++kc) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[kc][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = bs[kc][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float s1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float s2[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      const float v = acc[i][j];
      s1[j] += v;
      s2[j] += v * v;
      if (row < m && col < n) y[static_cast<size_t>(row) * n + col] = v;
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    red[0][ty][tx + 16 * j] = s1[j];
    red[1][ty][tx + 16 * j] = s2[j];
  }
  __syncthreads();
  if (tid < kFBN && n0 + tid < n) {
    float a = 0.0f, b = 0.0f;
    for (int r = 0; r < 16; ++r) {
      a += red[0][r][tid];
      b += red[1][r][tid];
    }
    const size_t o = static_cast<size_t>(blockIdx.y) * n + n0 + tid;
    part1[o] = a;
    part2[o] = b;
  }
}

// ---------------------------------------------------- partials -> s1, s2
constexpr int kRedCols = 32;
constexpr int kRedPhases = 32;

// Column c of block x sums partial rows p, p + 32, p + 64, ... in thread
// (c, p), then thread (c, 0) adds the 32 phases in order: a fixed order.
__global__ void __launch_bounds__(kRedCols * kRedPhases)
stats_reduce_kernel(const float* __restrict__ part1,
                    const float* __restrict__ part2, float* __restrict__ s1,
                    float* __restrict__ s2, int tiles, int n) {
  __shared__ float r1[kRedPhases][kRedCols + 1];
  __shared__ float r2[kRedPhases][kRedCols + 1];
  const int c = threadIdx.x;
  const int p = threadIdx.y;
  const int col = blockIdx.x * kRedCols + c;
  float a = 0.0f, b = 0.0f;
  if (col < n) {
    for (int t = p; t < tiles; t += kRedPhases) {
      a += part1[static_cast<size_t>(t) * n + col];
      b += part2[static_cast<size_t>(t) * n + col];
    }
  }
  r1[p][c] = a;
  r2[p][c] = b;
  __syncthreads();
  if (p == 0 && col < n) {
    float sa = 0.0f, sb = 0.0f;
    for (int q = 0; q < kRedPhases; ++q) {
      sa += r1[q][c];
      sb += r2[q][c];
    }
    s1[col] = sa;
    s2[col] = sb;
  }
}

}  // namespace

// Rows of one M-tile, i.e. of one partial row: the wrapper allocates
// partials of (ceil(m / rows), n) f32.
extern "C" int matmul_stats_tile_rows(int bf16) { return bf16 ? kBM : kFBM; }

// x (m, k) and w (n, k) row-major, both bf16 (bf16 != 0) or both f32;
// y (m, n) of the same type; part1/part2 (ceil(m / tile rows), n) f32
// scratch; s1/s2 (n,) f32. m, n, k > 0 and ceil(m / tile rows) <= 65535.
// Launches the GEMM and the reduction on `stream`; returns the first
// non-zero cudaGetLastError() as an int, else 0.
extern "C" int matmul_stats_launch(const void* x, const void* w, void* y,
                                   float* part1, float* part2, float* s1,
                                   float* s2, int m, int k, int n, int bf16,
                                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int tiles;
  if (bf16) {
    tiles = (m + kBM - 1) / kBM;
    const dim3 grid((n + kBN - 1) / kBN, tiles);
    const bool vec = k % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(w) % 16 == 0;
    const uint16_t* xa = static_cast<const uint16_t*>(x);
    const uint16_t* wa = static_cast<const uint16_t*>(w);
    __nv_bfloat16* ya = static_cast<__nv_bfloat16*>(y);
    if (vec) {
      mm_stats_bf16_kernel<true><<<grid, kThreads, 0, st>>>(xa, wa, ya, part1,
                                                            part2, m, k, n);
    } else {
      mm_stats_bf16_kernel<false><<<grid, kThreads, 0, st>>>(xa, wa, ya, part1,
                                                             part2, m, k, n);
    }
  } else {
    tiles = (m + kFBM - 1) / kFBM;
    const dim3 grid((n + kFBN - 1) / kFBN, tiles);
    mm_stats_f32_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(y), part1, part2, m, k, n);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  stats_reduce_kernel<<<(n + kRedCols - 1) / kRedCols, dim3(kRedCols, kRedPhases),
                        0, st>>>(part1, part2, s1, s2, tiles, n);
  return static_cast<int>(cudaGetLastError());
}
