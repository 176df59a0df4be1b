// Exact softmax attention backward for Hopper (sm_90a), bf16 or f32.
//
// Replaces the TPU kernel mpmc_tpu/ops/attention.py:_bwd_kernel (launched
// by _bwd_pallas, wired by the _attention_pallas custom VJP).  Same
// function and the same rounding points: from q, k, v, the mask or segment
// ids, the forward's saved out (input type) and f32 lse, and dO, it writes
// dq, dk, dv in the input type, with
//
//   qs = round_T(q * round_T(1/sqrt(D)))            (exact for D = 16, 64)
//   s  = qs.k^T in f32, plus the additive -1e9 bias of the mode
//   P  = exp(s - lse)                 padding (1) and none (0) modes
//   P  = exp(s - m) / l               segments mode (2), m and l the exact
//                                     row max and row sum, kept apart
//   dV = round_T(P)^T . dO            f32 sums
//   dP = dO . V^T, delta = sum_d dO * out   (f32, out as saved)
//   dS = round_T(P * (dP - delta))
//   dQ = (dS . K) * (1/sqrt(D)),  dK = dS^T . qs      (f32 sums)
//
// Segments mode does not rebuild P from lse: a packed row's padding queries
// (segment 0) have a row max of about -1e9, and the stored lse = -1e9 +
// O(1) has lost the O(1) part to f32 absorption.  A pre-pass recomputes
// each query row's max m and sum l and keeps them as two numbers, as the
// TPU kernel recomputes the softmax of its whole row.
//
// What bounds it on this card: at the training path's text shape (q, k, v
// [16,128,12,64] bf16) the function must move 25.3 MB (q, k, v, out, dO
// read, dq, dk, dv written, the f32 lse and the mask) for 1.0 GFLOP of
// products, which is 7.5 us at 3.35 TB/s and 1.0 us at the 989 TFLOP/s
// bf16 tensor-core rate: memory bound.  The design reads and writes the
// [B,S,H,D] tensors in place (the TPU path transposes all five inputs and
// the three outputs to [B,H,S,D]), keeps nothing of size S x S in device
// memory, and uses no atomics, so the result is deterministic.  It is a
// simple first kernel: the products run on the CUDA cores in f32 and the
// score tile is computed three times (pre-pass in segments mode, dK/dV,
// dQ), so it runs far above the bound; PERF.md has its measured times.
// Tensor cores, TMA and one fused pass are later work.
//
// Design: three launches on the caller's stream.
//   1. prep, one block per (64-query tile, head, batch): delta per query
//      and, in segments mode, the row statistics m and l (online over key
//      tiles of 32 in shared memory, as in attention_fwd.cu).
//   2. dkdv, one block per (64-key tile, head, batch): four threads own one
//      key row (its k and v in registers, a quarter each), query tiles of
//      32 stream through shared memory (qs and dO), and each thread sums
//      its quarter of dK_j and dV_j in f32 registers.
//   3. dq, one block per (64-query tile, head, batch): four threads own one
//      query row (qs and dO in registers), key tiles of 32 stream through
//      shared memory, and each thread sums its quarter of dQ_i.
// The four threads of a row read four consecutive shared-memory words and
// the eight rows of a warp read the same words, so there are no bank
// conflicts; dot products finish with two warp shuffles.
//
// Built by mpmc_tpu_torch/ops/build.py with nvcc and called through ctypes
// by mpmc_tpu_torch/ops/attention.py; the C entry point returns the CUDA
// error of the first launch that fails (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 64;                  // rows owned per block
constexpr int kParts = 4;                  // threads per row
constexpr int kThreads = kRows * kParts;   // 256
constexpr int kTile = 32;                  // rows per shared-memory tile
constexpr float kNegInf = -1e9f;           // the reference's additive mask

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

// Round an f32 value to the input type and widen it back.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// Sum over the four threads of a row (all 32 lanes take part).
__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

// Offset of row s of head h of sample b in a contiguous [B, S, H, D] tensor.
__device__ __forceinline__ long long row_offset(int b, int s, int h, int S,
                                                int H, int D) {
  return ((static_cast<long long>(b) * S + s) * H + h) * D;
}

// Additive bias of key j for a query: padding mode reads the key's own
// bias, segments mode compares the key's and the query's segment ids.
__device__ __forceinline__ float key_bias(int mode, float key_info,
                                          float q_seg) {
  if (mode == 1) return key_info;
  if (mode == 2) return (key_info == q_seg && key_info > 0.f) ? 0.f : kNegInf;
  return 0.f;
}

template <typename T, int DPAD>
__global__ void __launch_bounds__(kThreads)
attention_bwd_prep_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ out,
                          const T* __restrict__ dout,
                          const float* __restrict__ mask,
                          float* __restrict__ delta, float* __restrict__ row_m,
                          float* __restrict__ row_l, int H, int Sq, int Sk,
                          int D, int mode, float scale) {
  constexpr int DPT = DPAD / kParts;
  __shared__ float k_tile[kTile][DPAD];
  __shared__ float key_info[kTile];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row = blockIdx.x * kRows + threadIdx.x / kParts;
  const int part = threadIdx.x % kParts;
  const bool valid_row = row < Sq;
  const long long q_off = row_offset(b, valid_row ? row : 0, h, Sq, H, D);

  float dsum = 0.f;
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    const int d = i * kParts + part;
    if (valid_row && d < D) {
      dsum = fmaf(to_f32(dout[q_off + d]), to_f32(out[q_off + d]), dsum);
    }
  }
  dsum = row_sum(dsum);

  if (mode == 2) {                         // uniform over the block
    const float scale_t = round_to<T>(scale);
    float qr[DPT];
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int d = i * kParts + part;
      qr[i] = (valid_row && d < D) ? round_to<T>(to_f32(q[q_off + d]) * scale_t)
                                   : 0.f;
    }
    const float q_seg = valid_row ? mask[(long long)b * Sk + row] : 0.f;
    float m = -INFINITY;
    float l = 0.f;
    for (int k0 = 0; k0 < Sk; k0 += kTile) {
      const int nk = min(kTile, Sk - k0);
      for (int idx = threadIdx.x; idx < kTile * DPAD; idx += kThreads) {
        const int j = idx / DPAD;
        const int d = idx % DPAD;
        k_tile[j][d] = (j < nk && d < D)
                           ? to_f32(k[row_offset(b, k0 + j, h, Sk, H, D) + d])
                           : 0.f;
      }
      if (threadIdx.x < kTile) {
        const int j = threadIdx.x;
        key_info[j] = j < nk ? mask[(long long)b * Sk + k0 + j] : 0.f;
      }
      __syncthreads();
      float s[kTile];
      float tile_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < DPT; ++i) {
          dot = fmaf(qr[i], k_tile[j][i * kParts + part], dot);
        }
        dot = row_sum(dot);
        s[j] = j < nk ? dot + key_bias(2, key_info[j], q_seg) : -INFINITY;
        tile_max = fmaxf(tile_max, s[j]);
      }
      const float m_new = fmaxf(m, tile_max);
      float tile_sum = 0.f;
#pragma unroll
      for (int j = 0; j < kTile; ++j) tile_sum += expf(s[j] - m_new);
      l = l * expf(m - m_new) + tile_sum;  // expf(-inf) = 0 on the first tile
      m = m_new;
      __syncthreads();
    }
    if (valid_row && part == 0) {
      row_m[((long long)b * H + h) * Sq + row] = m;
      row_l[((long long)b * H + h) * Sq + row] = l;
    }
  }
  if (valid_row && part == 0) delta[((long long)b * H + h) * Sq + row] = dsum;
}

template <typename T, int DPAD>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ mask,
                          const float* __restrict__ delta,
                          const float* __restrict__ row_m,
                          const float* __restrict__ row_l,
                          T* __restrict__ dk, T* __restrict__ dv, int H,
                          int Sq, int Sk, int D, int mode, float scale) {
  constexpr int DPT = DPAD / kParts;
  __shared__ float qs_tile[kTile][DPAD];
  __shared__ float do_tile[kTile][DPAD];
  __shared__ float q_m[kTile];
  __shared__ float q_l[kTile];
  __shared__ float q_delta[kTile];
  __shared__ float q_seg[kTile];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int key = blockIdx.x * kRows + threadIdx.x / kParts;
  const int part = threadIdx.x % kParts;
  const bool valid_key = key < Sk;
  const long long k_off = row_offset(b, valid_key ? key : 0, h, Sk, H, D);
  const float scale_t = round_to<T>(scale);

  float kr[DPT], vr[DPT], dk_acc[DPT], dv_acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    const int d = i * kParts + part;
    const bool in = valid_key && d < D;
    kr[i] = in ? to_f32(k[k_off + d]) : 0.f;
    vr[i] = in ? to_f32(v[k_off + d]) : 0.f;
    dk_acc[i] = 0.f;
    dv_acc[i] = 0.f;
  }
  float info = 0.f;                        // padding: bias; segments: id
  if (valid_key && mode != 0) {
    const float mv = mask[(long long)b * Sk + key];
    info = (mode == 1) ? (1.f - mv) * kNegInf : mv;
  }

  for (int q0 = 0; q0 < Sq; q0 += kTile) {
    const int nq = min(kTile, Sq - q0);
    for (int idx = threadIdx.x; idx < kTile * DPAD; idx += kThreads) {
      const int i = idx / DPAD;
      const int d = idx % DPAD;
      float qv = 0.f, dov = 0.f;
      if (i < nq && d < D) {
        const long long off = row_offset(b, q0 + i, h, Sq, H, D) + d;
        qv = round_to<T>(to_f32(q[off]) * scale_t);
        dov = to_f32(dout[off]);
      }
      qs_tile[i][d] = qv;
      do_tile[i][d] = dov;
    }
    if (threadIdx.x < kTile) {
      const int i = threadIdx.x;
      const long long stat = ((long long)b * H + h) * Sq + q0 + i;
      const bool in = i < nq;
      q_m[i] = in ? row_m[stat] : 0.f;
      q_l[i] = (in && mode == 2) ? row_l[stat] : 1.f;
      q_delta[i] = in ? delta[stat] : 0.f;
      q_seg[i] = (in && mode == 2) ? mask[(long long)b * Sk + q0 + i] : 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int i = 0; i < kTile; ++i) {
      float dot_s = 0.f, dot_p = 0.f;
#pragma unroll
      for (int t = 0; t < DPT; ++t) {
        dot_s = fmaf(qs_tile[i][t * kParts + part], kr[t], dot_s);
        dot_p = fmaf(do_tile[i][t * kParts + part], vr[t], dot_p);
      }
      dot_s = row_sum(dot_s);
      dot_p = row_sum(dot_p);
      float p = 0.f;
      if (i < nq) {
        const float s = dot_s + key_bias(mode, info, q_seg[i]);
        p = expf(s - q_m[i]);
        if (mode == 2) p = p / q_l[i];
      }
      const float p_lo = round_to<T>(p);
      const float ds = round_to<T>(p * (dot_p - q_delta[i]));
#pragma unroll
      for (int t = 0; t < DPT; ++t) {
        dv_acc[t] = fmaf(p_lo, do_tile[i][t * kParts + part], dv_acc[t]);
        dk_acc[t] = fmaf(ds, qs_tile[i][t * kParts + part], dk_acc[t]);
      }
    }
    __syncthreads();
  }

  if (valid_key) {
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int d = i * kParts + part;
      if (d < D) {
        dk[k_off + d] = from_f32<T>(dk_acc[i]);
        dv[k_off + d] = from_f32<T>(dv_acc[i]);
      }
    }
  }
}

template <typename T, int DPAD>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ mask,
                        const float* __restrict__ delta,
                        const float* __restrict__ row_m,
                        const float* __restrict__ row_l, T* __restrict__ dq,
                        int H, int Sq, int Sk, int D, int mode, float scale) {
  constexpr int DPT = DPAD / kParts;
  __shared__ float k_tile[kTile][DPAD];
  __shared__ float v_tile[kTile][DPAD];
  __shared__ float key_info[kTile];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row = blockIdx.x * kRows + threadIdx.x / kParts;
  const int part = threadIdx.x % kParts;
  const bool valid_row = row < Sq;
  const long long q_off = row_offset(b, valid_row ? row : 0, h, Sq, H, D);
  const float scale_t = round_to<T>(scale);

  float qr[DPT], dor[DPT], dq_acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    const int d = i * kParts + part;
    const bool in = valid_row && d < D;
    qr[i] = in ? round_to<T>(to_f32(q[q_off + d]) * scale_t) : 0.f;
    dor[i] = in ? to_f32(dout[q_off + d]) : 0.f;
    dq_acc[i] = 0.f;
  }
  const long long stat = ((long long)b * H + h) * Sq + (valid_row ? row : 0);
  const float m = valid_row ? row_m[stat] : 0.f;
  const float l = (valid_row && mode == 2) ? row_l[stat] : 1.f;
  const float dlt = valid_row ? delta[stat] : 0.f;
  const float q_seg =
      (valid_row && mode == 2) ? mask[(long long)b * Sk + row] : 0.f;

  for (int k0 = 0; k0 < Sk; k0 += kTile) {
    const int nk = min(kTile, Sk - k0);
    for (int idx = threadIdx.x; idx < kTile * DPAD; idx += kThreads) {
      const int j = idx / DPAD;
      const int d = idx % DPAD;
      float kv = 0.f, vv = 0.f;
      if (j < nk && d < D) {
        const long long off = row_offset(b, k0 + j, h, Sk, H, D) + d;
        kv = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      k_tile[j][d] = kv;
      v_tile[j][d] = vv;
    }
    if (threadIdx.x < kTile) {
      const int j = threadIdx.x;
      float info = 0.f;
      if (j < nk && mode != 0) {
        const float mv = mask[(long long)b * Sk + k0 + j];
        info = (mode == 1) ? (1.f - mv) * kNegInf : mv;
      }
      key_info[j] = info;
    }
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < kTile; ++j) {
      float dot_s = 0.f, dot_p = 0.f;
#pragma unroll
      for (int t = 0; t < DPT; ++t) {
        dot_s = fmaf(qr[t], k_tile[j][t * kParts + part], dot_s);
        dot_p = fmaf(dor[t], v_tile[j][t * kParts + part], dot_p);
      }
      dot_s = row_sum(dot_s);
      dot_p = row_sum(dot_p);
      float p = 0.f;
      if (j < nk) {
        p = expf(dot_s + key_bias(mode, key_info[j], q_seg) - m);
        if (mode == 2) p = p / l;
      }
      const float ds = round_to<T>(p * (dot_p - dlt));
#pragma unroll
      for (int t = 0; t < DPT; ++t) {
        dq_acc[t] = fmaf(ds, k_tile[j][t * kParts + part], dq_acc[t]);
      }
    }
    __syncthreads();
  }

  if (valid_row) {
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int d = i * kParts + part;
      if (d < D) dq[q_off + d] = from_f32<T>(dq_acc[i] * scale);
    }
  }
}

template <typename T, int DPAD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* mask, const void* out, const float* lse,
                   const void* dout, void* dq, void* dk, void* dv,
                   float* delta, float* row_m, float* row_l, int B, int H,
                   int Sq, int Sk, int D, int mode, float scale,
                   cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* ot = static_cast<const T*>(out);
  const T* dot = static_cast<const T*>(dout);
  const dim3 grid_q((Sq + kRows - 1) / kRows, H, B);
  const dim3 grid_k((Sk + kRows - 1) / kRows, H, B);
  attention_bwd_prep_kernel<T, DPAD><<<grid_q, kThreads, 0, stream>>>(
      qt, kt, ot, dot, mask, delta, row_m, row_l, H, Sq, Sk, D, mode, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // Outside segments mode the row statistic is the forward's lse.
  const float* stat_m = mode == 2 ? row_m : lse;
  attention_bwd_dkdv_kernel<T, DPAD><<<grid_k, kThreads, 0, stream>>>(
      qt, kt, vt, dot, mask, delta, stat_m, row_l, static_cast<T*>(dk),
      static_cast<T*>(dv), H, Sq, Sk, D, mode, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_dq_kernel<T, DPAD><<<grid_q, kThreads, 0, stream>>>(
      qt, kt, vt, dot, mask, delta, stat_m, row_l, static_cast<T*>(dq), H,
      Sq, Sk, D, mode, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const float* mask, const void* out, const float* lse,
                     const void* dout, void* dq, void* dk, void* dv,
                     float* delta, float* row_m, float* row_l, int B, int H,
                     int Sq, int Sk, int D, int mode, float scale,
                     cudaStream_t stream) {
#define MPMC_LAUNCH(DPAD)                                                   \
  return launch<T, DPAD>(q, k, v, mask, out, lse, dout, dq, dk, dv, delta, \
                         row_m, row_l, B, H, Sq, Sk, D, mode, scale, stream)
  if (D <= 16) MPMC_LAUNCH(16);
  if (D <= 32) MPMC_LAUNCH(32);
  if (D <= 64) MPMC_LAUNCH(64);
  MPMC_LAUNCH(128);
#undef MPMC_LAUNCH
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  mode: 0 none, 1 padding, 2 segments.
// q, out, dout, dq are contiguous [B, Sq, H, D]; k, v, dk, dv contiguous
// [B, Sk, H, D]; lse, delta, row_m, row_l are f32 [B, H, Sq] (delta, row_m
// and row_l are scratch, row_m and row_l written only in segments mode);
// mask is f32 [B, Sk] (unused in mode 0).  Returns the CUDA error code of
// the first launch that fails (0 on success).
extern "C" int mpmc_attention_bwd(const void* q, const void* k, const void* v,
                                  const float* mask, const void* out,
                                  const float* lse, const void* dout,
                                  void* dq, void* dk, void* dv, float* delta,
                                  float* row_m, float* row_l, int dtype,
                                  int mode, int B, int H, int Sq, int Sk,
                                  int D, float scale, void* stream) {
  if (B < 1 || H < 1 || Sq < 1 || Sk < 1 || D < 1 || D > 128 || mode < 0 ||
      mode > 2 || (mode != 0 && mask == nullptr) ||
      (mode == 2 && Sq != Sk) || dtype < 0 || dtype > 1 || B > 65535 ||
      H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0
          ? launch_d<float>(q, k, v, mask, out, lse, dout, dq, dk, dv, delta,
                            row_m, row_l, B, H, Sq, Sk, D, mode, scale, st)
          : launch_d<__nv_bfloat16>(q, k, v, mask, out, lse, dout, dq, dk, dv,
                                    delta, row_m, row_l, B, H, Sq, Sk, D,
                                    mode, scale, st);
  return static_cast<int>(err);
}

extern "C" const char* mpmc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
