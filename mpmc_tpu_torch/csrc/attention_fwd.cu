// Exact softmax attention forward for Hopper (sm_90a), bf16 or f32.
//
// Replaces the TPU kernel mpmc_tpu/ops/attention.py:_fwd_kernel (launched
// by _fwd_pallas).  Same function: scores in f32, plus the additive -1e9
// bias of one of three modes (0 none, 1 padding: [B,Sk] 0/1 key mask,
// 2 segments: token i sees token j iff both carry the same non-zero id),
// softmax left unnormalized with e = exp(s - m) rounded to the input type
// before the e.V product, output divided once by the f32 row sum, and
// lse = m + log(sum) written in f32.  Fully masked query rows therefore
// give the uniform average of V and lse = -1e9, exactly as the reference.
//
// What bounds it on this card: at the serving path's text shape
// (q,k,v [16,128,12,64] bf16) the kernel must move 12.7 MB (q, k, v, out,
// lse) for 0.81 GFLOP, which is 3.8 us at 3.35 TB/s and 0.8 us at the
// 989 TFLOP/s bf16 tensor-core rate: memory bound.  The design keeps every
// byte it must move to one pass: q, k, v and out are read and written in
// place in the [B,S,H,D] layout through strides (the TPU path transposes
// to [B,H,S,D] first, which is a full extra copy of each tensor), and
// nothing of size S x S ever leaves the block.  It is a simple first
// kernel: the products run on the CUDA cores in f32, one shared-memory
// load per multiply-add, not on the tensor cores, so it runs far above
// the memory bound (PERF.md has its measured times).  wgmma, TMA and
// tuning are later work.
//
// Design: one block of 256 threads per (64-query tile, head, batch).  Four
// adjacent threads own one query row; each holds a quarter of the row's q
// and of its output accumulator (dims d = i*4 + part, so the four threads
// read four consecutive shared-memory words and the eight rows of a warp
// read the same words: no bank conflicts).  Keys stream through shared
// memory in tiles of 32 with an online (running max, running sum) softmax
// in f32 registers.  The scale 1/sqrt(D) is applied in f32 to the q.k dot
// product (the TPU kernel pre-scales q in the input type, which is exact
// for D = 16 and D = 64 and not for D = 8).  e is rounded to the input
// type relative to the running max rather than the final row max, so in
// bf16 a rescaled e can differ from the reference's by half a bf16 ulp.
//
// Built by mpmc_tpu_torch/ops/build.py with nvcc and called through ctypes
// by mpmc_tpu_torch/ops/attention.py; the C entry point returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 64;                  // query rows per block
constexpr int kParts = 4;                  // threads per query row
constexpr int kThreads = kRows * kParts;   // 256
constexpr int kKeys = 32;                  // keys per shared-memory tile
constexpr float kNegInf = -1e9f;           // the reference's additive mask

struct Strides {                           // element strides, D contiguous
  long long b, s, h;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);              // round to nearest even
}

template <typename T, int DPAD>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ mask,
                     T* __restrict__ out, float* __restrict__ lse,
                     Strides qs, Strides ks, Strides vs, Strides os,
                     int H, int Sq, int Sk, int D, int mode, float scale) {
  constexpr int DPT = DPAD / kParts;       // dims per thread
  __shared__ float k_tile[kKeys][DPAD];
  __shared__ float v_tile[kKeys][DPAD];
  __shared__ float key_info[kKeys];        // padding: bias; segments: id

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row = blockIdx.x * kRows + threadIdx.x / kParts;
  const int part = threadIdx.x % kParts;
  const bool valid_row = row < Sq;

  float qr[DPT];
  float acc[DPT];
  const T* q_row = q + b * qs.b + (long long)(valid_row ? row : 0) * qs.s
                   + h * qs.h;
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    const int d = i * kParts + part;
    qr[i] = (valid_row && d < D) ? to_f32(q_row[d]) : 0.f;
    acc[i] = 0.f;
  }
  // In segments mode Sq == Sk and mask holds the [B, S] segment ids.
  const float q_seg =
      (mode == 2 && valid_row) ? mask[(long long)b * Sk + row] : 0.f;
  float m = -INFINITY;
  float l = 0.f;

  for (int k0 = 0; k0 < Sk; k0 += kKeys) {
    const int nk = min(kKeys, Sk - k0);
    for (int idx = threadIdx.x; idx < kKeys * DPAD; idx += kThreads) {
      const int j = idx / DPAD;
      const int d = idx % DPAD;
      float kv = 0.f, vv = 0.f;
      if (j < nk && d < D) {
        const long long s = k0 + j;
        kv = to_f32(k[b * ks.b + s * ks.s + h * ks.h + d]);
        vv = to_f32(v[b * vs.b + s * vs.s + h * vs.h + d]);
      }
      k_tile[j][d] = kv;
      v_tile[j][d] = vv;
    }
    if (threadIdx.x < kKeys) {
      const int j = threadIdx.x;
      float info = 0.f;
      if (j < nk && mode != 0) {
        const float mv = mask[(long long)b * Sk + k0 + j];
        info = (mode == 1) ? (1.f - mv) * kNegInf : mv;
      }
      key_info[j] = info;
    }
    __syncthreads();

    float s[kKeys];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) {
        dot = fmaf(qr[i], k_tile[j][i * kParts + part], dot);
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      float sj = dot * scale;
      if (mode == 1) {
        sj += key_info[j];
      } else if (mode == 2) {
        const float kseg = key_info[j];
        sj += (kseg == q_seg && kseg > 0.f) ? 0.f : kNegInf;
      }
      if (j >= nk) sj = -INFINITY;        // past the last key: no key at all
      s[j] = sj;
      tile_max = fmaxf(tile_max, sj);
    }
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);   // 0 on the first tile
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
    float tile_sum = 0.f;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const float e = expf(s[j] - m_new);
      tile_sum += e;
      const float e_lo = to_f32(from_f32<T>(e));
#pragma unroll
      for (int i = 0; i < DPT; ++i) {
        acc[i] = fmaf(e_lo, v_tile[j][i * kParts + part], acc[i]);
      }
    }
    l = l * alpha + tile_sum;
    m = m_new;
    __syncthreads();
  }

  if (valid_row) {
    T* o_row = out + b * os.b + (long long)row * os.s + h * os.h;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int d = i * kParts + part;
      if (d < D) o_row[d] = from_f32<T>(acc[i] / l);
    }
    if (part == 0) lse[((long long)b * H + h) * Sq + row] = m + logf(l);
  }
}

template <typename T>
void launch(const void* q, const void* k, const void* v, const float* mask,
            void* out, float* lse, Strides qs, Strides ks, Strides vs,
            Strides os, int B, int H, int Sq, int Sk, int D, int mode,
            float scale, cudaStream_t stream) {
  const dim3 grid((Sq + kRows - 1) / kRows, H, B);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
#define MPMC_LAUNCH(DPAD)                                                   \
  attention_fwd_kernel<T, DPAD><<<grid, kThreads, 0, stream>>>(             \
      qt, kt, vt, mask, ot, lse, qs, ks, vs, os, H, Sq, Sk, D, mode, scale)
  if (D <= 16) {
    MPMC_LAUNCH(16);
  } else if (D <= 32) {
    MPMC_LAUNCH(32);
  } else if (D <= 64) {
    MPMC_LAUNCH(64);
  } else {
    MPMC_LAUNCH(128);
  }
#undef MPMC_LAUNCH
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  mode: 0 none, 1 padding, 2 segments.
// Strides are in elements, for [B, S, H, D] tensors whose last dim is
// contiguous.  mask is f32 [B, Sk] (unused in mode 0).  Returns the CUDA
// error code of the launch (0 on success).
extern "C" int mpmc_attention_fwd(
    const void* q, const void* k, const void* v, const float* mask,
    void* out, float* lse, int dtype, int mode, int B, int H, int Sq, int Sk,
    int D, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    float scale, void* stream) {
  if (B < 1 || H < 1 || Sq < 1 || Sk < 1 || D < 1 || D > 128 || mode < 0 ||
      mode > 2 || (mode != 0 && mask == nullptr) || dtype < 0 || dtype > 1 ||
      B > 65535 || H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, os{o_sb, o_ss, o_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(q, k, v, mask, out, lse, qs, ks, vs, os, B, H, Sq, Sk, D,
                  mode, scale, st);
  } else {
    launch<__nv_bfloat16>(q, k, v, mask, out, lse, qs, ks, vs, os, B, H, Sq,
                          Sk, D, mode, scale, st);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mpmc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
