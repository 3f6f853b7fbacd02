// Fused occlusion warp for Hopper (sm_90a): a staged nearest index chain
// followed by a gather of every channel.
//
// Replaces the Pallas TPU kernel occlusion_warp_onehot
// (uda_poseestimation_tpu/ops/pallas_warp.py: _warp_chain_kernel and its
// index math _chain_indices). The TPU kernel gathers through a one-hot MXU
// matmul only because the TPU's gather is slow; here each thread computes the
// source index of eight output pixels in registers and gathers their C
// channels with plain loads.
//
// Per output pixel p = (row, col) of sample b, in centered coordinates:
//   1. the backward affine cb (coeffs row 0);
//   2. the paste-rectangle remap: rows [left, right) x cols [upper, bottom)
//      are read from (left_src, upper_src) on;
//   3. the forward chain c3 -> c2 -> c1 (coeffs rows 3, 2, 1).
// Every affine stage computes ((m0*x + m1*y) + m2) + half, rounds half to
// even, ANDs an in-bounds flag into `valid` and clips. The stages use
// __fmul_rn/__fadd_rn so nvcc cannot contract them into FMAs: a fused
// multiply-add rounds once where the reference rounds twice and can flip a
// .5 tie, and the index maps must be bit-equal to the JAX and plain PyTorch
// versions. Invalid pixels are 0; exact == 0 returns bf16-rounded values
// (the TPU kernel's single bf16 dot gathers bf16(x) exactly).
//
// Bound on an H100: memory. At (32, 3, 256, 256) f32 it reads at most and
// writes 25.2 MB each (~15 us at 3.35 TB/s). The index math is not free:
// ~100 f32 operations a pixel, which is what holds this kernel, and a first
// version also made ~27 float<->int conversions a pixel, which run at 16 per
// clock per SM, a quarter of the f32 rate. So the chain stays in float:
//   - round half to even is (v + 1.5*2^23) - 1.5*2^23, exact for |v| < 2^22;
//     beyond that the result keeps the sign and stays >= 2^22 in magnitude,
//     so it is out of bounds and clips as the integer chain's saturated
//     value does; +-inf stay +-inf;
//   - `valid` is !(max over the stages of |r - half| > half), the max
//     taken with fmaxf, so a NaN stays valid, as cvt maps NaN to the
//     integer 0;
//   - the clip is fminf(fmaxf(r - half, -half), half) on the centered
//     coordinate (fmaxf(NaN, -half) = -half);
//   - the rectangle remap compares centered coordinates with bounds clamped
//     to [-1, size] and adds the shifts, exact while they are below 2^22
//     (checked once a block; larger shifts take the int32 remap);
//   - integers in [0, 2^23) enter and leave float through the bits of
//     c + 2^23.
// Only exact == 0's bf16 rounding stays a conversion (C a pixel).
//
// Layout of the work: one block of 128 threads covers a 32x32 output tile,
// each warp an 8x4 pixel patch per step (8 steps, 8 pixels a thread: the
// block's fixed work is spread over more pixels), so the source footprint
// of a warp's gather is compact under rotation and scale and L1 lines are
// reused. All gathers of a thread are issued before any store. The tile is
// staged in shared memory in the output's layout and written with 16-byte
// stores: a contiguous NCHW tile row is 32 floats a channel, a
// channels_last tile row is 32 * C floats.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 32;    // output tile kTile x kTile pixels
constexpr int kSteps = 8;    // pixels a thread: kTile * kTile / kThreads
constexpr int kMinBlocks = 8;  // blocks an SM holds: at most 64 registers a thread
constexpr int kMaxChunk = 4;  // channels staged at a time
constexpr int kRowPad = 8;   // floats after each staged row (bank spread)
constexpr int kPlaneStride = kTile * (kTile + kRowPad);  // NCHW staging
constexpr float kRound = 12582912.0f;  // 1.5 * 2^23
constexpr float kTwo23 = 8388608.0f;
constexpr int kTwo23Bits = 0x4B000000;  // the bits of 2^23

// rint(v), exact for |v| < 2^22 (see the header for larger |v|)
__device__ __forceinline__ float round_even(float v) {
  return __fadd_rn(__fadd_rn(v, kRound), -kRound);
}

// an integral float in [0, 2^23) as an int, and back
__device__ __forceinline__ int to_int(float c) {
  return __float_as_int(__fadd_rn(c, kTwo23)) - kTwo23Bits;
}
__device__ __forceinline__ float to_float(int i) {
  return __fsub_rn(__int_as_float(kTwo23Bits | i), kTwo23);
}

// one affine stage on centered coordinates: round, clip to [-half, half],
// and keep in `worst` the largest |r - half| of the stages: the pixel is
// valid while worst <= half. A NaN stays valid (fmaxf ignores it) and clips
// to the centered 0 (fmaxf(NaN, -half) = -half), as cvt converts it to 0.
// Tracking a float keeps the 8 pixels' flags out of the 7 predicate
// registers and the chain free of branches.
__device__ __forceinline__ void affine_stage(const float* m, float half, float& xs,
                                             float& ys, float& worst) {
  const float x_in = __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(m[0], xs), __fmul_rn(m[1], ys)), m[2]),
      half);
  const float y_in = __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(m[3], xs), __fmul_rn(m[4], ys)), m[5]),
      half);
  const float dx = __fsub_rn(round_even(x_in), half);
  const float dy = __fsub_rn(round_even(y_in), half);
  worst = fmaxf(worst, fmaxf(fabsf(dx), fabsf(dy)));
  xs = fminf(fmaxf(dx, -half), half);
  ys = fminf(fmaxf(dy, -half), half);
}

// the paste rectangle of one sample, ready for centered coordinates:
// rows [lo_y, hi_y) x cols [lo_x, hi_x) move by (dy, dx) = (left_src -
// left, upper_src - upper), wrapping as int32 sums do. The bounds are
// clamped to [-1, size], which decides every pixel of the map as the int32
// bounds do, and shifted by -half.
struct Rect {
  float lo_y, hi_y, lo_x, hi_x, dyf, dxf;
  int32_t dy, dx;
  int small;  // |dy|, |dx| < 2^22: the shifts are exact in float
};

// the remap of one pixel (SMALL: in float; else through int32, for shifts
// beyond 2^22)
template <bool SMALL>
__device__ __forceinline__ void remap(const Rect& r, float half, float& xs, float& ys) {
  const bool inside = (ys >= r.lo_y) & (ys < r.hi_y) & (xs >= r.lo_x) & (xs < r.hi_x);
  if (SMALL) {
    ys = __fadd_rn(ys, inside ? r.dyf : 0.0f);
    xs = __fadd_rn(xs, inside ? r.dxf : 0.0f);
  } else {
    const uint32_t qr = static_cast<uint32_t>(to_int(__fadd_rn(ys, half)));
    const uint32_t qc = static_cast<uint32_t>(to_int(__fadd_rn(xs, half)));
    const int32_t rr = static_cast<int32_t>(inside ? qr + static_cast<uint32_t>(r.dy) : qr);
    const int32_t rc = static_cast<int32_t>(inside ? qc + static_cast<uint32_t>(r.dx) : qc);
    ys = __fsub_rn(static_cast<float>(rr), half);
    xs = __fsub_rn(static_cast<float>(rc), half);
  }
}

__device__ __forceinline__ float maybe_bf16(float v, int exact) {
  return exact ? v : __bfloat162float(__float2bfloat16_rn(v));
}

// a full tile's staged chunk of C channels (all of them) to the output:
// 16-byte stores, loop bounds known at compile time
template <int C, bool NHWC>
__device__ __forceinline__ void store_full_tile(const float* stage, float* out_b, int x0,
                                                int y0, int log2_size) {
  const int size = 1 << log2_size;
  if (NHWC) {
    // tile row r: kTile pixels x C channels, contiguous in the output
    constexpr int kRowVecs = kTile * C / 4;
    float* base = out_b + ((static_cast<int64_t>(y0) << log2_size) + x0) * C;
#pragma unroll
    for (int i = threadIdx.x; i < kTile * kRowVecs; i += kThreads) {
      const int r = i / kRowVecs;
      const int j = i - r * kRowVecs;
      *reinterpret_cast<float4*>(base + r * (size * C) + 4 * j) =
          *reinterpret_cast<const float4*>(stage + r * (kTile * C + kRowPad) + 4 * j);
    }
  } else {
    // segment (c, r): kTile floats of channel c, image row y0 + r
    const int64_t plane = static_cast<int64_t>(size) << log2_size;
    float* base = out_b + (static_cast<int64_t>(y0) << log2_size) + x0;
#pragma unroll
    for (int i = threadIdx.x; i < C * kTile * kTile / 4; i += kThreads) {
      const int j = 4 * (i & (kTile / 4 - 1));
      const int r = (i / (kTile / 4)) & (kTile - 1);
      const int c = i / (kTile * kTile / 4);
      *reinterpret_cast<float4*>(base + c * plane + (r << log2_size) + j) =
          *reinterpret_cast<const float4*>(stage + c * kPlaneStride + r * (kTile + kRowPad) + j);
    }
  }
}

// any tile's staged chunk [c0, c0 + cc) of the output's channels: 16-byte
// stores where tile rows are whole vectors, else scalar ones
template <int CHUNK, bool NHWC>
__device__ __forceinline__ void store_any_tile(const float* stage, float* out_b, int x0,
                                               int y0, int log2_size, int log2_tw,
                                               int channels, int c0, int cc) {
  const int tid = threadIdx.x;
  const int size = 1 << log2_size;
  const int tw = 1 << log2_tw;
  const bool vec = log2_tw >= 2;
  if (NHWC) {
    float* row0 = out_b + ((static_cast<int64_t>(y0) << log2_size) + x0) * channels;
    const int row_stride = kTile * CHUNK + kRowPad;
    // tile rows of tw * channels floats, contiguous in the output and, where
    // the chunk holds every channel and fills its staged pixel, in the stage
    if (vec && cc == channels && cc == CHUNK) {
      const int n = (tw * tw * CHUNK) >> 2;
      for (int i = tid; i < n; i += kThreads) {
        const int r = (i / CHUNK) >> (log2_tw - 2);
        const int j = i - r * ((tw >> 2) * CHUNK);
        *reinterpret_cast<float4*>(row0 + (static_cast<int64_t>(r) << log2_size) * channels +
                                   4 * j) =
            *reinterpret_cast<const float4*>(stage + r * row_stride + 4 * j);
      }
    } else {
      for (int i = tid; i < tw * tw * cc; i += kThreads) {
        const int px = i / cc;
        const int c = i - px * cc;
        const int r = px >> log2_tw;
        const int col = px & (tw - 1);
        row0[((static_cast<int64_t>(r) << log2_size) + col) * channels + c0 + c] =
            stage[r * row_stride + col * CHUNK + c];
      }
    }
  } else {
    // segment (c, r): tw floats of channel c0 + c, image row y0 + r
    const int64_t plane = static_cast<int64_t>(size) << log2_size;
    float* base = out_b + (static_cast<int64_t>(y0) << log2_size) + x0;
    const int log2_v = vec ? 2 : 0;  // floats a store
    const int log2_n = log2_tw - log2_v;  // stores a segment
    for (int i = tid; i < (cc << (2 * log2_tw)) >> log2_v; i += kThreads) {
      const int seg = i >> log2_n;
      const int j = (i & ((1 << log2_n) - 1)) << log2_v;
      const int c = seg >> log2_tw;
      const int r = seg & (tw - 1);
      const float* s = stage + c * kPlaneStride + r * (kTile + kRowPad) + j;
      float* d = base + (c0 + c) * plane + (static_cast<int64_t>(r) << log2_size) + j;
      if (vec) {
        *reinterpret_cast<float4*>(d) = *reinterpret_cast<const float4*>(s);
      } else {
        *d = *s;
      }
    }
  }
}

// the tile of one block, after its prologue. C: the channel count where it
// is instantiated, 1 or 3 (one pass), or 0 for any count (passes of
// kMaxChunk channels);
// NHWC: channels_last (else contiguous NCHW); SMALL: the rectangle's shifts
// are exact in float.
template <int C, bool NHWC, bool SMALL>
__device__ __forceinline__ void warp_tile(const float* __restrict__ imgs, const float* m,
                                          const Rect& rect, float* __restrict__ out,
                                          float* stage, int channels_arg, int log2_size,
                                          int exact) {
  constexpr int kChunk = C ? C : kMaxChunk;
  const int channels = C ? C : channels_arg;
  const int b = blockIdx.y;
  const int size = 1 << log2_size;
  const int log2_tw = min(log2_size, 5);  // tile side, log2
  const bool full = log2_tw == 5;
  const int log2_tiles = log2_size - log2_tw;  // tiles per side, log2
  const int x0 = (blockIdx.x & ((1 << log2_tiles) - 1)) << log2_tw;
  const int y0 = (blockIdx.x >> log2_tiles) << log2_tw;
  const float half = 0.5f * static_cast<float>(size - 1);
  float cf[24];
#pragma unroll
  for (int i = 0; i < 24; ++i) cf[i] = m[i];

  // pixel k of this thread: tile column 8 * (k % 4) + lane % 8, tile row
  // 8 * warp + 4 * (k / 4) + lane / 8: each step of a warp is an 8x4 patch
  const int lane = threadIdx.x & 31;
  const int col0 = lane & 7;
  const int row0 = 8 * (threadIdx.x >> 5) + (lane >> 3);
  const float xs0 = __fsub_rn(to_float(x0 + col0), half);
  const float ys0 = __fsub_rn(to_float(y0 + row0), half);
  // the source pixel's index from centered coordinates, through the bits
  // of c + 2^23 (unsigned: the shifted terms wrap, their sum does not)
  const uint32_t bias = (static_cast<uint32_t>(kTwo23Bits) << log2_size) + kTwo23Bits;

  uint32_t src[kSteps];  // the source pixel's first element in image b
  bool valid[kSteps];
#pragma unroll
  for (int k = 0; k < kSteps; ++k) {
    const int dcol = 8 * (k & 3);
    const int drow = 4 * (k >> 2);
    float xs = __fadd_rn(xs0, static_cast<float>(dcol));
    float ys = __fadd_rn(ys0, static_cast<float>(drow));
    float worst = (full | ((row0 + drow < size) & (col0 + dcol < size))) ? 0.0f : INFINITY;
    affine_stage(cf, half, xs, ys, worst);  // backward warp
    remap<SMALL>(rect, half, xs, ys);
    affine_stage(cf + 18, half, xs, ys, worst);  // c3
    affine_stage(cf + 12, half, xs, ys, worst);  // c2
    affine_stage(cf + 6, half, xs, ys, worst);   // c1
    const uint32_t iy = __float_as_uint(__fadd_rn(__fadd_rn(ys, half), kTwo23));
    const uint32_t ix = __float_as_uint(__fadd_rn(__fadd_rn(xs, half), kTwo23));
    const uint32_t s = (iy << log2_size) + ix - bias;
    src[k] = NHWC ? s * channels : s;
    valid[k] = !(worst > half);
  }

  const int64_t plane = static_cast<int64_t>(size) << log2_size;
  const float* img = imgs + b * plane * channels;
  float* out_b = out + b * plane * channels;
  for (int c0 = 0; c0 < channels; c0 += kChunk) {
    const int cc = C ? C : min(kChunk, channels - c0);
    float v[kSteps][kChunk];
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      const float* p = img + src[k] + (NHWC ? c0 : c0 * plane);
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        v[k][c] = (valid[k] && (C || c < cc)) ? __ldg(p + (NHWC ? c : c * plane)) : 0.0f;
      }
    }
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      const int col = col0 + 8 * (k & 3);
      const int row = row0 + 4 * (k >> 2);
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const float x = maybe_bf16(v[k][c], exact);
        if (NHWC) {
          stage[row * (kTile * kChunk + kRowPad) + col * kChunk + c] = x;
        } else {
          stage[c * kPlaneStride + row * (kTile + kRowPad) + col] = x;
        }
      }
    }
    __syncthreads();
    if (C && full) {
      store_full_tile<kChunk, NHWC>(stage, out_b, x0, y0, log2_size);
    } else {
      store_any_tile<kChunk, NHWC>(stage, out_b, x0, y0, log2_size, log2_tw, channels, c0,
                                   cc);
    }
    if (c0 + kChunk < channels) __syncthreads();
  }
}

template <int C, bool NHWC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
occlusion_warp_kernel(const float* __restrict__ imgs,
                      const float* __restrict__ coeffs,
                      const int32_t* __restrict__ rect,
                      float* __restrict__ out, int channels, int log2_size,
                      int exact) {
  __shared__ float m[24];
  __shared__ Rect r;
  __shared__ __align__(16) float stage[kMaxChunk * kPlaneStride];

  const int b = blockIdx.y;
  if (threadIdx.x < 24) {
    m[threadIdx.x] = coeffs[b * 24 + threadIdx.x];
  } else if (threadIdx.x == 32) {
    // rect = [left, right, upper, bottom, left_src, upper_src]: left/right
    // bound rows, upper/bottom cols
    const int32_t* q = rect + b * 6;
    const int size = 1 << log2_size;
    const float half = 0.5f * static_cast<float>(size - 1);
    const auto bound = [&](int32_t v) {
      return __fsub_rn(static_cast<float>(min(max(v, -1), size)), half);
    };
    r.lo_y = bound(q[0]);
    r.hi_y = bound(q[1]);
    r.lo_x = bound(q[2]);
    r.hi_x = bound(q[3]);
    r.dy = static_cast<int32_t>(static_cast<uint32_t>(q[4]) - static_cast<uint32_t>(q[0]));
    r.dx = static_cast<int32_t>(static_cast<uint32_t>(q[5]) - static_cast<uint32_t>(q[2]));
    r.dyf = static_cast<float>(r.dy);
    r.dxf = static_cast<float>(r.dx);
    r.small = r.dy > -(1 << 22) && r.dy < (1 << 22) && r.dx > -(1 << 22) && r.dx < (1 << 22);
  }
  __syncthreads();
  if (r.small) {
    warp_tile<C, NHWC, true>(imgs, m, r, out, stage, channels, log2_size, exact);
  } else {
    warp_tile<C, NHWC, false>(imgs, m, r, out, stage, channels, log2_size, exact);
  }
}

template <int C, bool NHWC>
void launch(const dim3& grid, cudaStream_t stream, const float* imgs, const float* coeffs,
            const int32_t* rect, float* out, int channels, int log2_size, int exact) {
  occlusion_warp_kernel<C, NHWC><<<grid, kThreads, 0, stream>>>(imgs, coeffs, rect, out,
                                                                 channels, log2_size, exact);
}

template <bool NHWC>
void launch_layout(const dim3& grid, cudaStream_t stream, const float* imgs,
                   const float* coeffs, const int32_t* rect, float* out, int channels,
                   int log2_size, int exact) {
  if (channels == 3) {  // the main path's RGB images
    launch<3, NHWC>(grid, stream, imgs, coeffs, rect, out, channels, log2_size, exact);
  } else {
    launch<0, NHWC>(grid, stream, imgs, coeffs, rect, out, channels, log2_size, exact);
  }
}

}  // namespace

// imgs/out: (batch, channels, size, size) f32, both contiguous NCHW
// (channels_last == 0) or both channels_last, i.e. an NHWC buffer
// (channels_last != 0); out 16-byte aligned; channels * size^2 < 2^31;
// coeffs: (batch, 4, 6) f32 contiguous; rect: (batch, 6) int32 contiguous;
// batch <= 65535. Launches on `stream` and returns cudaGetLastError() as an
// int.
extern "C" int occlusion_warp_launch(const float* imgs, const float* coeffs,
                                     const int32_t* rect, float* out,
                                     int batch, int channels, int log2_size,
                                     int channels_last, int exact,
                                     void* stream) {
  const int log2_tiles = log2_size > 5 ? log2_size - 5 : 0;
  const dim3 grid(1u << (2 * log2_tiles), batch);
  const auto s = static_cast<cudaStream_t>(stream);
  if (channels == 1) {  // one channel: both layouts are the same buffer
    launch<1, false>(grid, s, imgs, coeffs, rect, out, channels, log2_size, exact);
  } else if (channels_last) {
    launch_layout<true>(grid, s, imgs, coeffs, rect, out, channels, log2_size, exact);
  } else {
    launch_layout<false>(grid, s, imgs, coeffs, rect, out, channels, log2_size, exact);
  }
  return static_cast<int>(cudaGetLastError());
}
