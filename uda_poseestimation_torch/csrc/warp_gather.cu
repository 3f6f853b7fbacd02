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
// reads 0, which this kernel reproduces. Here one thread reads one output
// pixel's index pair and mask once and copies the K channels with plain
// loads. exact == 0 returns bf16-rounded values (the TPU kernel's single
// bf16 dot gathers bf16(hms) exactly).
//
// Bound on an H100: memory. At (32, 21, 64, 64) f32 it reads at most 11 MB
// of maps and 1.2 MB of indices and mask, and writes 11 MB (~7 us at
// 3.35 TB/s); there is no arithmetic. Writes and index reads are coalesced
// (neighbouring threads, neighbouring pixels); map reads are gathers with
// the locality of the warp.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
warp_gather_kernel(const float* __restrict__ hms, const int32_t* __restrict__ ix,
                   const int32_t* __restrict__ iy,
                   const uint8_t* __restrict__ valid, float* __restrict__ out,
                   int channels, int h, int w, int exact) {
  const int b = blockIdx.y;
  const int hw = h * w;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= hw) return;
  const int64_t q = static_cast<int64_t>(b) * hw + p;
  const int sx = ix[q];
  const int sy = iy[q];
  const bool ok = valid[q] != 0 && sx >= 0 && sx < w && sy >= 0 && sy < h;
  const int64_t plane = static_cast<int64_t>(b) * channels * hw;
  const float* src = hms + plane + (ok ? sy * w + sx : 0);
  float* dst = out + plane + p;
  for (int c = 0; c < channels; ++c) {
    float v = 0.0f;
    if (ok) {
      v = __ldg(src + static_cast<int64_t>(c) * hw);
      if (!exact) v = __bfloat162float(__float2bfloat16_rn(v));
    }
    dst[static_cast<int64_t>(c) * hw] = v;
  }
}

}  // namespace

// hms/out: (batch, channels, h, w) f32 contiguous; ix/iy: (batch, h*w) int32
// contiguous; valid: (batch, h*w) bytes (torch.bool) contiguous. batch <=
// 65535. Launches on `stream` and returns cudaGetLastError() as an int.
extern "C" int warp_gather_launch(const float* hms, const int32_t* ix,
                                  const int32_t* iy, const uint8_t* valid,
                                  float* out, int batch, int channels, int h,
                                  int w, int exact, void* stream) {
  const int hw = h * w;
  const dim3 grid((hw + kThreads - 1) / kThreads, batch);
  warp_gather_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      hms, ix, iy, valid, out, channels, h, w, exact);
  return static_cast<int>(cudaGetLastError());
}
