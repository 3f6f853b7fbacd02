// Fused occlusion warp for Hopper (sm_90a): a staged nearest index chain
// followed by a direct gather of every channel.
//
// Replaces the Pallas TPU kernel occlusion_warp_onehot
// (uda_poseestimation_tpu/ops/pallas_warp.py: _warp_chain_kernel and its
// index math _chain_indices). The TPU kernel gathers through a one-hot MXU
// matmul only because the TPU's gather is slow; here each thread computes one
// output pixel's source index once, in registers, and copies the C channels
// with plain loads.
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
// writes 25.2 MB each, ~15 us at 3.35 TB/s; the index math is ~60 flops a
// pixel. Reads are gathers with the locality of a rotation/scale, writes
// are coalesced (neighbouring threads write neighbouring pixels).
//
// Layout: images are addressed through (batch, channel, pixel) strides, so
// contiguous NCHW and channels_last (an NHWC buffer viewed as NCHW) both
// work without a copy; the output uses the same strides.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void affine_stage(const float* m, int size,
                                             float half, float& xs, float& ys,
                                             bool& valid) {
  const float x_in = __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(m[0], xs), __fmul_rn(m[1], ys)), m[2]),
      half);
  const float y_in = __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(m[3], xs), __fmul_rn(m[4], ys)), m[5]),
      half);
  int ix = __float2int_rn(x_in);  // round half to even, as jnp.round
  int iy = __float2int_rn(y_in);
  valid = valid && ix >= 0 && ix < size && iy >= 0 && iy < size;
  ix = min(max(ix, 0), size - 1);
  iy = min(max(iy, 0), size - 1);
  xs = __fsub_rn(static_cast<float>(ix), half);
  ys = __fsub_rn(static_cast<float>(iy), half);
}

__global__ void __launch_bounds__(kThreads)
occlusion_warp_kernel(const float* __restrict__ imgs,
                      const float* __restrict__ coeffs,
                      const int32_t* __restrict__ rect,
                      float* __restrict__ out, int channels, int log2_size,
                      int64_t stride_b, int64_t stride_c, int64_t stride_p,
                      int exact) {
  __shared__ float m[24];
  __shared__ int32_t r[6];
  const int b = blockIdx.y;
  if (threadIdx.x < 24) {
    m[threadIdx.x] = coeffs[b * 24 + threadIdx.x];
  } else if (threadIdx.x < 30) {
    r[threadIdx.x - 24] = rect[b * 6 + threadIdx.x - 24];
  }
  __syncthreads();

  const int size = 1 << log2_size;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= (size << log2_size)) return;
  const float half = 0.5f * static_cast<float>(size - 1);

  float xs = __fsub_rn(static_cast<float>(p & (size - 1)), half);
  float ys = __fsub_rn(static_cast<float>(p >> log2_size), half);
  bool valid = true;
  affine_stage(m, size, half, xs, ys, valid);  // backward warp (last applied)

  // rectangle remap on absolute integer coords; r = [left, right, upper,
  // bottom, left_src, upper_src], left/right bound rows, upper/bottom cols
  const int qr = static_cast<int>(__fadd_rn(ys, half));
  const int qc = static_cast<int>(__fadd_rn(xs, half));
  const bool inside = qr >= r[0] && qr < r[1] && qc >= r[2] && qc < r[3];
  const int rr = inside ? qr - r[0] + r[4] : qr;
  const int rc = inside ? qc - r[2] + r[5] : qc;
  xs = __fsub_rn(static_cast<float>(rc), half);
  ys = __fsub_rn(static_cast<float>(rr), half);

  affine_stage(m + 18, size, half, xs, ys, valid);  // c3
  affine_stage(m + 12, size, half, xs, ys, valid);  // c2
  affine_stage(m + 6, size, half, xs, ys, valid);   // c1 (first applied)

  const int64_t src = (static_cast<int64_t>(__fadd_rn(ys, half)) << log2_size) +
                      static_cast<int64_t>(__fadd_rn(xs, half));
  const float* in = imgs + b * stride_b + src * stride_p;
  float* o = out + b * stride_b + static_cast<int64_t>(p) * stride_p;
  for (int c = 0; c < channels; ++c) {
    float v = 0.0f;
    if (valid) {
      v = __ldg(in + c * stride_c);
      if (!exact) v = __bfloat162float(__float2bfloat16_rn(v));
    }
    o[c * stride_c] = v;
  }
}

}  // namespace

// imgs/out: (batch, channels, size, size) f32 with the given element
// strides (pixel stride for the flattened size*size plane); coeffs:
// (batch, 4, 6) f32 contiguous; rect: (batch, 6) int32 contiguous.
// Launches on `stream` and returns cudaGetLastError() as an int.
extern "C" int occlusion_warp_launch(const float* imgs, const float* coeffs,
                                     const int32_t* rect, float* out,
                                     int batch, int channels, int log2_size,
                                     int64_t stride_b, int64_t stride_c,
                                     int64_t stride_p, int exact,
                                     void* stream) {
  const int pixels = 1 << (2 * log2_size);
  const dim3 grid((pixels + kThreads - 1) / kThreads, batch);
  occlusion_warp_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      imgs, coeffs, rect, out, channels, log2_size, stride_b, stride_c,
      stride_p, exact);
  return static_cast<int>(cudaGetLastError());
}
