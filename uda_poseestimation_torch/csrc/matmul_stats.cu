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
// pass (a full re-read of y) disappears, and only a small f32 partial of the
// sums goes out. Byte-bound calls need many bytes in flight (a deep TMA
// ring, the next tile's loads overlapping this tile's stores) and stores of
// whole lines; operation-bound calls need wgmma, the only way to the
// tensor cores' full rate, and enough blocks to fill the 132 SMs.
//
// Design, and where it departs from the TPU kernel:
// - The TPU kernel carries its sums in VMEM across a sequential grid axis.
//   Blocks here run in parallel and in no order, so each block writes the
//   column sums of the rows it owns to a partial row, and the partial rows
//   are added in a fixed order afterwards. Nothing is a float atomic: a call
//   repeats bit for bit.
// - Epilogue: the f32 accumulators are rounded to the output type FIRST; the
//   rounded values are stored and their sums and sums of squares are taken
//   from registers (warp shuffles over the rows a warp holds, then shared
//   memory across warps), as the TPU kernel sums the cast y.
// - bf16 (the training path), variant "tma": wgmma + TMA, planned per shape
//   by ops/bn_fuse.py::_plan (tile width BN 64 or 128, row groups G). A
//   block is a producer warpgroup (one thread issues TMA; setmaxnreg
//   hands its registers to the consumers) and two consumer warpgroups (384
//   threads, one block per SM). The producer loads 128x64 tiles of x and
//   BNx64 tiles of w by TMA (128-byte swizzle, x evict-first and w
//   evict-last in L2) into a ring of 4-8 stages with full and empty
//   mbarriers. TMA fills rows and columns outside
//   the matrices with zeros, so ragged M, N and K need no masking and add
//   nothing to the sums. Each consumer warpgroup runs wgmma.mma_async
//   m64nBNk16 on its 64 rows, keeps one k-step in flight, and frees a stage
//   once the wgmma that read it has retired.
//   Block (column tile, group g) walks the row tiles g, g + G, ...,
//   so the producer loads the next tile while the consumers finish this
//   one, and the column sums of all its tiles stay in registers: a call
//   writes a (G, N) partial, not one row per 128 rows of M. The epilogue
//   writes the rounded tile to shared memory in the 128-byte swizzled
//   layout (4-byte writes without bank conflicts) and stores it with TMA,
//   64x64 per box, which clips the ragged edges. After the last tile a
//   butterfly reduce-scatter (7/8 of a shuffle per value, not 3) sums each
//   warp's rows. K is not split: every block sums the whole of K before it
//   rounds, so the statistics are of the rounded full sum.
//   The partials' reduction is folded into the launch: each block, once its
//   partial row is written, takes an integer ticket for its column tile
//   (one acquire-release atomic); the last one stages the G rows in shared
//   memory with batched 16-byte loads, adds them in index order and resets
//   the ticket. What stays between a call and its byte bound is mostly
//   fixed cost per launch: the first loads, the last tile's epilogue, the
//   ticket and this reduction.
//   Tensor maps are encoded on the host by cuTensorMapEncodeTiled, reached
//   through cudaGetDriverEntryPoint, so the library needs no -lcuda.
// - bf16, variant "mma_sync": where TMA cannot describe an operand (K or N
//   not a multiple of 8, a base address not 16-byte aligned) the plan takes
//   the earlier kernel: mma.sync m16n8k16, 128x128x32 tiles, 8 warps of
//   64x32, two cp.async stages, smem rows padded to 80 bytes, edges masked
//   in the kernel (element by element where K % 8 != 0 or an operand is
//   unaligned), a per-128-row partial and a second reduction kernel.
// - f32: a plain SIMT FFMA kernel (64x64 tiles, 4x4 outputs a thread), NOT
//   TF32, so the card's f32 result can be held against a CPU f32 GEMM.

#include <cuda.h>  // CUtensorMap and its enums; no driver call is linked
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

// ------------------------------------------------------ bf16 wgmma + TMA path
namespace wg {

constexpr int kBM = 128;                // two consumer warpgroups of 64 rows
constexpr int kBK = 64;                 // 64 bf16: one 128-byte swizzle row
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup
constexpr int kPanel = 64 * 128;        // 64 rows x 64 bf16 columns, bytes

// Shared memory, from a 1024-byte aligned base (the 128-byte swizzle repeats
// every 8 rows of 128 bytes): the ring's x tiles, its w tiles, the output
// tile (bf16), the per-warp column sums, the mbarriers and the last-block
// flag.
template <int BN>
struct Cfg {
  static constexpr int kStages = BN == 128 ? 4 : 8;
  static constexpr int kABytes = kBM * kBK * 2;
  static constexpr int kBBytes = BN * kBK * 2;
  static constexpr int kBOff = kStages * kABytes;
  static constexpr int kOutOff = kBOff + kStages * kBBytes;
  static constexpr int kOutBytes = kBM * BN * 2;
  static constexpr int kRedOff = kOutOff + kOutBytes;
  static constexpr int kBarOff = kRedOff + 2 * 8 * BN * 4;
  static constexpr int kFlagOff = kBarOff + 2 * kStages * 8;
  // partial rows (both sums) the last block stages at once in the idle ring
  static constexpr int kTailRows = kOutOff / (2 * BN * 4) < 256 ? kOutOff / (2 * BN * 4) : 256;
  static constexpr int kSmemBytes = kFlagOff + 16 + 1024;  // + alignment slack
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the barrier's phase differs from `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// TMA load of the box at (c0, c1) into dst, completing on mbarrier bar,
// with an L2 eviction policy (createpolicy).
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0,
                                         int c1, uint32_t bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar), "l"(policy)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0,
                                          int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], [%3];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(src)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// the bulk stores issued by this thread have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// The ticket of a column tile: returns its count before this block's
// arrival; releases the block's partial row and acquires the others'.
__device__ __forceinline__ int ticket_acq_rel(int* ticket) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;\n"
               : "=r"(old)
               : "l"(ticket)
               : "memory");
  return old;
}

// generic-proxy writes to shared memory become visible to TMA
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Sums v over the 8 lanes of a warp that share lane % 4 (the rows of an
// mma fragment) and scatters the result: afterwards v[r], r < N / 8, of the
// lane with row group g holds the sum of entry g * N / 8 + r. Three
// butterfly rounds (7N/8 shuffles, not 3N); each sum has one fixed order.
template <int N>
__device__ __forceinline__ void reduce_scatter8(float (&v)[N], int g) {
#pragma unroll
  for (int round = 0; round < 3; ++round) {
    const int h = N >> (round + 1);  // entries kept
    const bool upper = (g >> (2 - round)) & 1;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      if (i < h) {
        const float send = upper ? v[i] : v[i + h];
        const float keep = upper ? v[i + h] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, 16 >> round);
      }
    }
  }
}

// Keeps the compiler from moving reads or writes of an accumulator register
// across the asynchronous wgmma that owns it.
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// wgmma shared-memory descriptor of a K-major tile in the 128-byte swizzled
// layout TMA writes: 8-row groups 1024 bytes apart (stride byte offset 64 in
// 16-byte units; the leading byte offset is unused for this layout and set
// to 1), layout type 1 (128B swizzle). A k16 step inside the 64-wide row
// advances the start address by 32 bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// D (64 x N, f32 fragments) (+)= A (64 x 16) * B (N x 16)^T, both from shared
// memory; `accumulate` 0 overwrites D.
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db,
                                          uint32_t accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db,
                                           uint32_t accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t da, uint64_t db,
                                           uint32_t accumulate) {
  if constexpr (BN == 64) {
    wgmma_n64(d, da, db, accumulate);
  } else {
    wgmma_n128(d, da, db, accumulate);
  }
}

// Grid (column tiles, G). Block (column tile, group g) computes the row
// tiles g, g + G, ... of its column tile; part1/part2 are (G, n) f32,
// tickets one int per column tile, zero before the launch and zero after it.
template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
mm_stats_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                      const __grid_constant__ CUtensorMap map_w,
                      const __grid_constant__ CUtensorMap map_y, float* __restrict__ part1,
                      float* __restrict__ part2, float* __restrict__ s1,
                      float* __restrict__ s2, int* __restrict__ tickets, int m, int k,
                      int n) {
  using C = Cfg<BN>;
  constexpr int kStages = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const sm = smem_raw + (base - raw);
  const uint32_t full_bar = base + C::kBarOff;  // stage s: + 8 s
  const uint32_t empty_bar = full_bar + 8 * kStages;
  float* const red = reinterpret_cast<float*>(sm + C::kRedOff);
  volatile int* const last_flag = reinterpret_cast<volatile int*>(sm + C::kFlagOff);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int tiles_m = (m + kBM - 1) / kBM;
  const int groups = gridDim.y;
  const int n_tile = blockIdx.x;
  const int n0 = n_tile * BN;
  const int ksteps = (k + kBK - 1) / kBK;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, kConsumers / 32);  // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // One branch per role to the end of the kernel (no reconvergence), so
  // setmaxnreg can move registers from the producer to the consumers.
  if (warp >= kConsumers / 32) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == kConsumers / 32 && lane == 0) {
      // x streams through L2 once (its tiles' other readers run at the same
      // time); w's tiles are read again by every row group
      uint64_t x_policy, w_policy;
      asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(x_policy));
      asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(w_policy));
      int it = 0;
      for (int mt = blockIdx.y; mt < tiles_m; mt += groups) {
        for (int ks = 0; ks < ksteps; ++ks, ++it) {
          const int s = it % kStages;
          mbar_wait(empty_bar + 8 * s, ((it / kStages) & 1) ^ 1);
          mbar_expect_tx(full_bar + 8 * s, C::kABytes + C::kBBytes);
          const int kc = ks * kBK;
          tma_load(base + s * C::kABytes, &map_x, kc, mt * kBM, full_bar + 8 * s, x_policy);
          tma_load(base + C::kBOff + s * C::kBBytes, &map_w, kc, n0, full_bar + 8 * s,
                   w_policy);
        }
      }
    }
    __syncwarp();
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wgi = warp >> 2;  // warpgroup: rows wgi * 64 .. + 64 of the tile
    const int g = lane >> 2;
    const int t = lane & 3;
    // this thread's rows in its warpgroup's 64: row and row + 8; its columns
    // in each 8-column group j: 8 j + 2 t and + 1 (acc[4 j .. 4 j + 3] holds
    // (row, c), (row, c + 1), (row + 8, c), (row + 8, c + 1))
    const int row = (warp & 3) * 16 + g;
    float acc[BN / 2];
    float c1[BN / 4], c2[BN / 4];  // i: column 8 (i / 2) + 2 t + i % 2
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < BN / 4; ++i) c1[i] = c2[i] = 0.0f;
    uint8_t* const out = sm + C::kOutOff;
    int it = 0;
    for (int mt = blockIdx.y; mt < tiles_m; mt += groups) {
      for (int ks = 0; ks < ksteps; ++ks, ++it) {
        const int s = it % kStages;
        mbar_wait(full_bar + 8 * s, (it / kStages) & 1);
        const uint32_t a = base + s * C::kABytes + wgi * 64 * 128;
        const uint32_t b = base + C::kBOff + s * C::kBBytes;
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          wgmma_tile<BN>(acc, sw128_desc(a + 32 * kk), sw128_desc(b + 32 * kk),
                         ks > 0 || kk > 0);
        }
        wgmma_commit();
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);
        if (ks > 0) {  // the previous k-step's wgmma has retired: free its stage
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(empty_bar + 8 * ((it - 1) % kStages));
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);
      if (lane == 0) mbar_arrive(empty_bar + 8 * ((it - 1) % kStages));

      // epilogue: round, sum the rounded values, stage the tile, TMA store
      uint8_t* const tile = out + wgi * (64 * BN * 2);  // BN / 64 panels
      if (tid % 128 == 0) bulk_wait_read();  // the last store has left `tile`
      named_sync(2 + wgi, 128);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const __nv_bfloat162 lo = __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
        const float2 fl = __bfloat1622float2(lo);
        const float2 fh = __bfloat1622float2(hi);
        c1[2 * j] += fl.x + fh.x;
        c1[2 * j + 1] += fl.y + fh.y;
        c2[2 * j] += fl.x * fl.x + fh.x * fh.x;
        c2[2 * j + 1] += fl.y * fl.y + fh.y * fh.y;
        // 16-byte chunk j % 8 of a 128-byte row sits at chunk (j % 8) ^ (row % 8);
        // row % 8 == (row + 8) % 8 == g
        uint8_t* const panel = tile + (j >> 3) * kPanel + (((j & 7) ^ g) << 4) + 4 * t;
        *reinterpret_cast<__nv_bfloat162*>(panel + row * 128) = lo;
        *reinterpret_cast<__nv_bfloat162*>(panel + (row + 8) * 128) = hi;
      }
      fence_proxy_async();
      named_sync(2 + wgi, 128);
      if (tid % 128 == 0) {
        const int r0 = mt * kBM + wgi * 64;
        if (r0 < m) {
          for (int p = 0; p < BN / 64; ++p) {
            if (n0 + 64 * p < n) tma_store(&map_y, smem_u32(tile + p * kPanel), n0 + 64 * p, r0);
          }
          bulk_commit();
        }
      }
    }

    // column sums over the 8 row groups of each warp (after which lane
    // (g, t) holds entries g * BN / 32 + r), then over the 8 warps
    reduce_scatter8(c1, g);
    reduce_scatter8(c2, g);
#pragma unroll
    for (int r = 0; r < BN / 32; ++r) {
      const int i = g * (BN / 32) + r;
      const int c = 8 * (i >> 1) + 2 * t + (i & 1);
      red[warp * BN + c] = c1[r];
      red[(8 + warp) * BN + c] = c2[r];
    }
    named_sync(1, kConsumers);
    // thread tid < 2 BN owns statistic tid / BN (s1, s2) of column tid % BN
    const int stat = tid / BN;
    const int col = n0 + tid % BN;
    float* const part = stat == 0 ? part1 : part2;
    const bool mine = tid < 2 * BN && col < n;
    if (mine) {
      float sum = 0.0f;
      for (int w = 0; w < 8; ++w) sum += red[(stat * 8 + w) * BN + tid % BN];
      part[static_cast<size_t>(blockIdx.y) * n + col] = sum;
    }
    // The barrier orders the block's partial writes before thread 0's
    // release; its acquire, and the barrier after it, order the other
    // blocks' partials before the last block's loads.
    named_sync(1, kConsumers);
    if (tid == 0) *last_flag = ticket_acq_rel(tickets + n_tile) == groups - 1;
    named_sync(1, kConsumers);
    if (*last_flag) {  // every partial row of this column tile is written
      // All threads stage C::kTailRows partial rows of both sums at a time
      // in the (now idle) ring, buf[row][sum][column], with 16-byte loads,
      // 16 a thread in flight before their stores (the compiler cannot
      // move a load past a store that might alias it; all divisors are
      // constants); then each owner adds its column's rows in row order.
      constexpr int kRows = C::kTailRows;
      constexpr int kRowVecs = 2 * (BN / 4);  // float4 per staged row
      float* const buf = reinterpret_cast<float*>(sm);
      float sum = 0.0f;
      for (int g0 = 0; g0 < groups; g0 += kRows) {
        const int rows = min(kRows, groups - g0);
        const int vecs = rows * kRowVecs;
        for (int i0 = tid; i0 < vecs; i0 += 16 * kConsumers) {
          float4 v[16];
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int i = i0 + j * kConsumers;
            const int c4 = i % (BN / 4) * 4;
            v[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            if (i < vecs && n0 + c4 < n) {
              const float* const src = (i / (BN / 4)) % 2 == 0 ? part1 : part2;
              v[j] = __ldcg(reinterpret_cast<const float4*>(
                  src + static_cast<size_t>(g0 + i / kRowVecs) * n + n0 + c4));
            }
          }
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int i = i0 + j * kConsumers;
            if (i < vecs) reinterpret_cast<float4*>(buf)[i] = v[j];
          }
        }
        named_sync(1, kConsumers);
        if (mine) {
          const float* const mine_rows = buf + stat * BN + tid % BN;
#pragma unroll 16
          for (int r = 0; r < rows; ++r) sum += mine_rows[r * 2 * BN];
        }
        named_sync(1, kConsumers);
      }
      if (mine) (stat == 0 ? s1 : s2)[col] = sum;
      if (tid == 0) tickets[n_tile] = 0;
    }
    if (tid % 128 == 0) bulk_wait_read();  // the stores finish with the grid
  }
}

}  // namespace wg

}  // namespace

// failures of the launchers that are not a cudaError_t
constexpr int kNoEncoder = -1;  // cuTensorMapEncodeTiled not found
constexpr int kBadMap = -2;     // an operand the tensor map cannot describe
constexpr int kBadPlan = -3;    // a plan the kernel cannot run

// x (m, k) and w (n, k) row-major, both bf16 (bf16 != 0) or both f32;
// y (m, n) of the same type; part1/part2 (groups, n) f32 scratch, where
// groups must be ceil(m / tile rows), tile rows 128 (bf16) or 64 (f32);
// s1/s2 (n,) f32. m, n, k > 0 and groups <= 65535. Launches the GEMM and
// the reduction on `stream`; returns -3 (kBadPlan) if groups is not the
// kernel's tile count, else the first non-zero cudaGetLastError() as an
// int, else 0.
extern "C" int matmul_stats_launch(const void* x, const void* w, void* y,
                                   float* part1, float* part2, float* s1,
                                   float* s2, int m, int k, int n, int groups,
                                   int bf16, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = bf16 ? (m + kBM - 1) / kBM : (m + kFBM - 1) / kFBM;
  if (groups != tiles || tiles > 65535) return kBadPlan;
  if (bf16) {
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

namespace {

// cuTensorMapEncodeTiled's signature (CUDA 12.0)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// The map of a row-major bf16 (rows, cols) matrix read or written in boxes
// of box_rows x 64 columns (128 bytes) with the 128-byte swizzle; outside
// the matrix, loads give zeros and stores are clipped.
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int rows, int cols,
            int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(wg::kBK),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// Launches the instance of tile width BN on a (column tiles, groups) grid,
// setting its dynamic shared memory limit above 48 KB on first use.
template <int BN>
cudaError_t launch_wgmma(const CUtensorMap& mx, const CUtensorMap& mw, const CUtensorMap& my,
                         float* part1, float* part2, float* s1, float* s2, int* tickets,
                         int m, int k, int n, int groups, cudaStream_t st) {
  constexpr int smem = wg::Cfg<BN>::kSmemBytes;
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        wg::mm_stats_wgmma_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  wg::mm_stats_wgmma_kernel<BN><<<dim3((n + BN - 1) / BN, groups), wg::kThreads, smem, st>>>(
      mx, mw, my, part1, part2, s1, s2, tickets, m, k, n);
  return cudaGetLastError();
}

}  // namespace

// The wgmma variant, bf16 only. x (m, k), w (n, k), y (m, n) row-major,
// 16-byte aligned, k and n multiples of 8; part1/part2 (groups, n) f32
// scratch; tickets >= ceil(n / bn) ints, zero (the kernel leaves them zero);
// s1/s2 (n,) f32. bn is 64 or 128, 1 <= groups <= ceil(m / 128). Encodes
// the three tensor maps and launches on `stream`; returns 0, a cudaError_t,
// or -1 (no cuTensorMapEncodeTiled), -2 (an operand the tensor map cannot
// describe), -3 (a plan it cannot run).
extern "C" int matmul_stats_wgmma_launch(const void* x, const void* w, void* y, float* part1,
                                         float* part2, float* s1, float* s2, int* tickets,
                                         int m, int k, int n, int bn, int groups,
                                         void* stream) {
  if ((bn != 64 && bn != 128) || groups < 1 || groups > (m + wg::kBM - 1) / wg::kBM ||
      groups > 65535) {
    return kBadPlan;
  }
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kNoEncoder;
  CUtensorMap mx, mw, my;
  if (!encode(fn, &mx, x, m, k, wg::kBM) || !encode(fn, &mw, w, n, k, bn) ||
      !encode(fn, &my, y, m, n, 64)) {
    return kBadMap;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bn == 64 ? launch_wgmma<64>(mx, mw, my, part1, part2, s1, s2, tickets, m, k, n, groups, st)
               : launch_wgmma<128>(mx, mw, my, part1, part2, s1, s2, tickets, m, k, n, groups,
                                   st));
}
