// Fused uint8 -> normalized f32 image pass for Hopper (sm_90a): per-image
// horizontal flip, brightness gain, clip, ImageNet normalization.
//
// Replaces the TPU kernel mpmc_tpu/ops/image_ops.py:_kernel (launched by
// fused_normalize_flip_brightness) together with the XLA flip in front of
// it (Mosaic could not lower `rev` inside the TPU kernel; here the flip is
// an index, so it costs nothing).  Same function and the same rounding:
//
//   out[b,h,w,c] = (clip(u8[b,h,w',c] * f32(1/255) * bright[b], 0, 1)
//                   - mean[c]) * inv_std[c]
//   w' = W-1-w if flip[b] else w
//
// with mean and inv_std = f32(1) / f32(std) computed by the caller in f32;
// it multiplies and never divides, as the TPU kernel does.
//
// What bounds it on this card: one read of the uint8 input and one write
// of the f32 output, 5 bytes per element, and 5 operations per element.
// At the training path's shape [16,224,224,3] that is 12.04 MB, 3.59 us at
// 3.35 TB/s: memory bound by far.  The design reads and writes each byte
// once.  It is the simple first version: one thread per pixel (its three
// channels), which reads 3 bytes and writes 12, so a warp's accesses are
// contiguous but not 16-byte vectors; PERF.md has its measured time.
//
// Built by mpmc_tpu_torch/ops/build.py with nvcc and called through ctypes
// by mpmc_tpu_torch/ops/image_ops.py; the C entry point returns
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Stats {
  float mean[3];
  float inv_std[3];
};

__global__ void __launch_bounds__(kThreads)
image_normalize_kernel(const uint8_t* __restrict__ img,
                       const uint8_t* __restrict__ flip,
                       const float* __restrict__ bright,
                       float* __restrict__ out, long long pixels, int H,
                       int W, float inv255, Stats stats) {
  const long long pix =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (pix >= pixels) return;
  const int w = static_cast<int>(pix % W);
  const long long bh = pix / W;            // b * H + h
  const int b = static_cast<int>(bh / H);
  const int src_w = flip[b] ? W - 1 - w : w;
  const uint8_t* src = img + (bh * W + src_w) * 3;
  const float gain = bright[b];
  float* dst = out + pix * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float x = static_cast<float>(src[c]) * inv255;
    x = fminf(fmaxf(x * gain, 0.f), 1.f);
    dst[c] = (x - stats.mean[c]) * stats.inv_std[c];
  }
}

}  // namespace

// img: contiguous uint8 [B, H, W, 3]; flip: uint8 [B] (0 or 1); bright: f32
// [B]; out: contiguous f32 [B, H, W, 3]; mean and inv_std: 3 floats each.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int mpmc_image_normalize(const void* img, const void* flip,
                                    const float* bright, float* out, int B,
                                    int H, int W, float inv255,
                                    const float* mean, const float* inv_std,
                                    void* stream) {
  if (B < 1 || H < 1 || W < 1 || mean == nullptr || inv_std == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Stats stats;
  for (int c = 0; c < 3; ++c) {
    stats.mean[c] = mean[c];
    stats.inv_std[c] = inv_std[c];
  }
  const long long pixels = static_cast<long long>(B) * H * W;
  const long long blocks = (pixels + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  image_normalize_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(img), static_cast<const uint8_t*>(flip),
      bright, out, pixels, H, W, inv255, stats);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mpmc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
