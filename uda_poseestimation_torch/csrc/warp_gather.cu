// Nearest-warp gather of heatmaps from precomputed indices, for Hopper
// (sm_90a):
//
//   out[b, k, p] = hms[b, k, iy[b, p], ix[b, p]]   where valid[b, p] and the
//                                                   index lies in the map,
//                  0                                elsewhere.
//
// Replaces the Pallas TPU kernel warp_gather_onehot
// (uda_poseestimation_tpu/ops/pallas_warp.py: _warp_kernel). The TPU kernel
// gathers through two one-hot MXU contractions only because the TPU's gather
// is slow; an index outside the map matches no one-hot row or column and
// reads 0, which this kernel reproduces. exact == 0 returns bf16-rounded
// values (the TPU kernel's single bf16 dot gathers bf16(hms) exactly).
//
// Bound on an H100: memory. At (32, 21, 64, 64) f32 it reads at most 11 MB
// of maps and 1.2 MB of indices and mask, and writes 11 MB (~7 us at
// 3.35 TB/s); there is no arithmetic. A gather from device memory moves
// whole 32-byte sectors: index maps with an affine map's locality (the
// heatmap reconstruction's) touch few sectors per warp, uniformly random
// ones a sector per 4-byte read.
//
// Layout of the work: a thread gathers 4 consecutive output pixels for a
// compile-time chunk of 8 channels, all 32 loads issued into registers
// before the first store, so enough bytes are in flight; the channel chunks
// run over blockIdx.z. The indices and mask of the 4 pixels are read as one
// int4, int4 and 4-byte load and each channel's 4 outputs written as one
// float4 where H*W and the buffers' alignment allow it (the wrapper's `vec`);
// else scalar loads and stores, masked in the kernel.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 8;  // channels a thread gathers

__device__ __forceinline__ float maybe_bf16(float v, int exact) {
  return exact ? v : __bfloat162float(__float2bfloat16_rn(v));
}

// the source offset of one pixel and whether it is read
__device__ __forceinline__ bool source(int sx, int sy, bool v, int h, int w,
                                       int& off) {
  const bool ok = v && sx >= 0 && sx < w && sy >= 0 && sy < h;
  off = ok ? sy * w + sx : 0;
  return ok;
}

// four consecutive output pixels: their source offsets and whether each
// is read
struct Group {
  int off[4];
  bool ok[4];
};

// pixels p .. p + 3 of sample row q (vec: one vector load each, else
// masked scalar loads)
__device__ __forceinline__ Group load_indices(const int32_t* ix, const int32_t* iy,
                                              const uint8_t* valid, int64_t q, int p,
                                              int hw, int h, int w, bool vec) {
  Group g;
  if (vec) {
    const int4 x = __ldg(reinterpret_cast<const int4*>(ix + q));
    const int4 y = __ldg(reinterpret_cast<const int4*>(iy + q));
    const uint32_t v = __ldg(reinterpret_cast<const unsigned int*>(valid + q));
    g.ok[0] = source(x.x, y.x, v & 0xff, h, w, g.off[0]);
    g.ok[1] = source(x.y, y.y, (v >> 8) & 0xff, h, w, g.off[1]);
    g.ok[2] = source(x.z, y.z, (v >> 16) & 0xff, h, w, g.off[2]);
    g.ok[3] = source(x.w, y.w, v >> 24, h, w, g.off[3]);
    return g;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool in = p + i < hw;
    g.ok[i] = source(in ? __ldg(ix + q + i) : -1, in ? __ldg(iy + q + i) : -1,
                     in && __ldg(valid + q + i) != 0, h, w, g.off[i]);
  }
  return g;
}

// grid (pixel groups of 4 * kThreads, batch, channel chunks of kChunk)
__global__ void __launch_bounds__(kThreads)
warp_gather_kernel(const float* __restrict__ hms, const int32_t* __restrict__ ix,
                   const int32_t* __restrict__ iy, const uint8_t* __restrict__ valid,
                   float* __restrict__ out, int channels, int h, int w, int vec,
                   int exact) {
  const int hw = h * w;
  const int p = 4 * (blockIdx.x * kThreads + threadIdx.x);
  if (p >= hw) return;
  const int b = blockIdx.y;
  const int c0 = blockIdx.z * kChunk;
  const Group g =
      load_indices(ix, iy, valid, static_cast<int64_t>(b) * hw + p, p, hw, h, w, vec != 0);
  const int64_t first = (static_cast<int64_t>(b) * channels + c0) * hw;
  float v[kChunk][4];
#pragma unroll
  for (int c = 0; c < kChunk; ++c) {
    const float* plane = hms + first + static_cast<int64_t>(c) * hw;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[c][i] = (g.ok[i] && c0 + c < channels) ? __ldg(plane + g.off[i]) : 0.0f;
    }
  }
#pragma unroll
  for (int c = 0; c < kChunk; ++c) {
    if (c0 + c >= channels) break;
    float* dst = out + first + static_cast<int64_t>(c) * hw + p;
#pragma unroll
    for (int i = 0; i < 4; ++i) v[c][i] = maybe_bf16(v[c][i], exact);
    if (vec) {
      *reinterpret_cast<float4*>(dst) = make_float4(v[c][0], v[c][1], v[c][2], v[c][3]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (p + i < hw) dst[i] = v[c][i];
      }
    }
  }
}

}  // namespace

// hms/out: (batch, channels, h, w) f32 contiguous; ix/iy: (batch, h*w) int32
// contiguous; valid: (batch, h*w) bytes (torch.bool) contiguous. batch <=
// 65535. vec != 0 only where h*w is a multiple of 4, hms, ix, iy and out are
// 16-byte aligned and valid 4-byte aligned. Launches on `stream` and returns
// cudaGetLastError() as an int.
extern "C" int warp_gather_launch(const float* hms, const int32_t* ix,
                                  const int32_t* iy, const uint8_t* valid,
                                  float* out, int batch, int channels, int h,
                                  int w, int vec, int exact, void* stream) {
  const int hw = h * w;
  const dim3 grid((hw + 4 * kThreads - 1) / (4 * kThreads), batch,
                  (channels + kChunk - 1) / kChunk);
  warp_gather_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      hms, ix, iy, valid, out, channels, h, w, vec, exact);
  return static_cast<int>(cudaGetLastError());
}
