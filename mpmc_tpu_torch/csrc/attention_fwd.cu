// Exact softmax attention forward for Hopper (sm_90a): bf16 on the tensor
// cores, f32 on the CUDA cores.
//
// Replaces the TPU kernel mpmc_tpu/ops/attention.py:_fwd_kernel (launched
// by _fwd_pallas).  Same function: scores in f32, plus the additive -1e9
// bias of one of three modes (0 none, 1 padding: [B,Sk] 0/1 key mask,
// 2 segments: token i sees token j iff both carry the same non-zero id),
// the exact row max m, e = exp(s - m) rounded to the input type before the
// e.V product, the output divided once by the f32 row sum of the unrounded
// e, and lse = m + log(sum) written in f32.  Fully masked query rows give
// the uniform average of V and lse = -1e9, exactly as the reference.
//
// What bounds it on this card: at the serving path's text shape
// (q,k,v [16,128,12,64] bf16) the kernel must move 12.7 MB (q, k, v, out,
// lse) for 0.81 GFLOP, which is 3.8 us at 3.35 TB/s and 0.8 us at the
// 989 TFLOP/s bf16 tensor-core rate: memory bound, plus launch latency.
// q, k, v and out are read and written in place in the [B,S,H,D] layout
// (the TPU path transposes to [B,H,S,D] first, a full extra copy of each),
// and nothing of size S x S leaves the block.
//
// bf16 design (attention_fwd_tc_kernel): one block of 4 warps per
// (64-query tile, head, batch); each warp owns 16 query rows.  cp.async
// copies q and a block of up to 128 keys of k and v, 16 bytes at a time,
// straight from [B,S,H,D] (a 64-wide head row is 128 contiguous bytes) into
// XOR-swizzled shared memory (mma_bf16.cuh), with v in a second group that
// lands while q.k^T runs.  ldmatrix feeds mma.sync m16n8k16 (bf16 in, f32
// accumulate).  At Sk <= 128 (the text paths, ViT-B/32's 50) a warp's
// whole score row sits in its accumulators (64 f32 per thread), so the
// kernel takes the exact row max before any exponent, as the TPU kernel
// does, and the rounded e goes from the accumulators to the e.V product in
// registers.  For 128 < Sk <= 1024 (ViT-B/16 and L/16: 197 at 224 pixels,
// 577 at 384) it goes over the key blocks twice, computing q.k^T in both:
// first for the max, then for exp, sum and e.V.  The last key block may be
// ragged (577 = 4 x 128 + 65): cp.async zero-fills its rows past Sk up to
// the next multiple of 16, and no product reads a row past that multiple.
// The scale multiplies the f32 score, as in the
// plain version (bit-equal to the TPU's pre-scaled q for D = 64).  Keys
// past Sk get -inf; masked keys get the -1e9 bias, never -inf.  At D <= 64
// three blocks share an SM (at most 168 registers), so the text shape's 384
// blocks run in one wave.  bf16 needs D % 8 == 0 and 16-byte aligned rows
// (the wrapper checks).
//
// f32 design (attention_fwd_f32_kernel, kept on the CUDA cores: TF32 tensor
// cores would break the 1e-5 card-vs-CPU checks): one block of 256
// threads per (64-query tile, head, batch), four threads per query row, key
// tiles of 32 in shared memory with an online softmax in f32 registers.
//
// Times at [16,128,12,64] bf16 padding (NVIDIA H100 80GB HBM3, 700 W;
// PERF.md names the runs): the CUDA-core kernel this design replaced took
// 0.08559 ms, SDPA 0.011648 ms; the bound is 0.003788 ms.
//
// Built by mpmc_tpu_torch/ops/build.py with nvcc and called through ctypes
// by mpmc_tpu_torch/ops/attention.py; the C entry point returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "mma_bf16.cuh"

namespace {

using mma::bf16;
using mma::kNegInf;

struct Strides {                           // element strides, D contiguous
  long long b, s, h;
};

// ---------------------------------------------------------------- bf16 --

constexpr int kTcRows = 64;                // query rows per block
constexpr int kTcThreads = 128;            // 4 warps x 16 query rows
constexpr int kTcKeys = 128;               // keys per shared-memory block

template <int DP>
constexpr size_t tc_smem_bytes() {
  return (kTcRows + 2 * kTcKeys) * DP * sizeof(bf16) + kTcKeys * sizeof(float);
}

// D <= 64: at most 168 registers, so three blocks share an SM and the
// text shape's 384 blocks run in one wave on 132 SMs.
template <int DP>
__global__ void __launch_bounds__(kTcThreads, DP == 64 ? 3 : 1)
attention_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const float* __restrict__ mask, bf16* __restrict__ out,
                        float* __restrict__ lse, Strides qs, Strides ks,
                        Strides vs, Strides os, int H, int Sq, int Sk, int D,
                        int mode, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = q_s + kTcRows * DP;
  bf16* v_s = k_s + kTcKeys * DP;
  float* key_info = reinterpret_cast<float*>(v_s + kTcKeys * DP);

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kTcRows;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int t = lane & 3;
  const int d_chunks = D / 8;
  const int n_blocks = (Sk + kTcKeys - 1) / kTcKeys;
  const bf16* k_bh = k + b * ks.b + h * ks.h;
  const bf16* v_bh = v + b * vs.b + h * vs.h;

  // This thread's two rows of the C fragments: g and g + 8 of the warp.
  const int row[2] = {q0 + warp * 16 + (lane >> 2),
                      q0 + warp * 16 + (lane >> 2) + 8};
  float q_seg[2] = {0.f, 0.f};             // segments mode: Sq == Sk
  if (mode == 2) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row[r] < Sq) q_seg[r] = mask[(long long)b * Sk + row[r]];
    }
  }

  mma::load_tile<DP>(q_s, q + b * qs.b + h * qs.h + (long long)q0 * qs.s,
                     qs.s, kTcRows, Sq - q0, d_chunks, tid, kTcThreads);

  uint32_t qa[DP / 16][4];
  float s[16][4];
  float m[2] = {-INFINITY, -INFINITY};

  // Pass 1, only when the keys span several blocks: the exact row max.
  if (n_blocks > 1) {
    for (int blk = 0; blk < n_blocks; ++blk) {
      const int k0 = blk * kTcKeys;
      const int nk = min(kTcKeys, Sk - k0);
      mma::load_tile<DP>(k_s, k_bh + (long long)k0 * ks.s, ks.s,
                         (nk + 15) & ~15, nk, d_chunks, tid, kTcThreads);
      mma::cp_async_commit();
      mma::store_key_info(key_info, mask, b, Sk, k0, nk, mode, tid,
                          kTcThreads);
      mma::cp_async_wait<0>();
      __syncthreads();
      if (blk == 0) {
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          mma::load_a<DP>(qa[kk], q_s, warp * 16, kk, lane);
        }
      }
      mma::attn_scores<DP, 16>(s, qa, k_s, key_info, q_seg, nk, mode, scale,
                               lane);
      m[0] = fmaxf(m[0], mma::row_max<16>(s, 0));
      m[1] = fmaxf(m[1], mma::row_max<16>(s, 1));
      __syncthreads();
    }
  }

  // Pass 2: e = exp(s - m), the row sums and e.V.
  float l[2] = {0.f, 0.f};
  float o[DP / 8][4];
#pragma unroll
  for (int dt = 0; dt < DP / 8; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  }
  for (int blk = 0; blk < n_blocks; ++blk) {
    const int k0 = blk * kTcKeys;
    const int nk = min(kTcKeys, Sk - k0);
    const int rows = (nk + 15) & ~15;
    mma::load_tile<DP>(k_s, k_bh + (long long)k0 * ks.s, ks.s, rows, nk,
                       d_chunks, tid, kTcThreads);
    mma::cp_async_commit();
    mma::load_tile<DP>(v_s, v_bh + (long long)k0 * vs.s, vs.s, rows, nk,
                       d_chunks, tid, kTcThreads);
    mma::cp_async_commit();
    mma::store_key_info(key_info, mask, b, Sk, k0, nk, mode, tid, kTcThreads);
    mma::cp_async_wait<1>();               // q and k have landed
    __syncthreads();
    if (blk == 0) {
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        mma::load_a<DP>(qa[kk], q_s, warp * 16, kk, lane);
      }
    }
    mma::attn_scores<DP, 16>(s, qa, k_s, key_info, q_seg, nk, mode, scale,
                               lane);
    if (n_blocks == 1) {
      m[0] = mma::row_max<16>(s, 0);
      m[1] = mma::row_max<16>(s, 1);
    }
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nt][e] - m[e >> 1]);
        l[e >> 1] += p;
        s[nt][e] = p;
      }
    }
    mma::cp_async_wait<0>();               // v has landed
    __syncthreads();
#pragma unroll
    for (int kc = 0; kc < 8; ++kc) {
      if (kc * 16 < rows) {
        const uint32_t a[4] = {
            mma::pack_bf16(s[2 * kc][0], s[2 * kc][1]),
            mma::pack_bf16(s[2 * kc][2], s[2 * kc][3]),
            mma::pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
            mma::pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
        for (int c = 0; c < DP / 16; ++c) {
          uint32_t bv[4];
          mma::load_b_t<DP>(bv, v_s, kc * 16, c, lane);
          mma::mma16816(o[2 * c], a, bv[0], bv[1]);
          mma::mma16816(o[2 * c + 1], a, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();                       // before the next block's copies
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lr = mma::quad_sum(l[r]);
    if (row[r] < Sq) {
      bf16* o_row = out + b * os.b + (long long)row[r] * os.s + h * os.h;
#pragma unroll
      for (int dt = 0; dt < DP / 8; ++dt) {
        const int d = dt * 8 + 2 * t;
        if (d < D) {
          *reinterpret_cast<uint32_t*>(o_row + d) =
              mma::pack_bf16(o[dt][2 * r] / lr, o[dt][2 * r + 1] / lr);
        }
      }
      if (t == 0) lse[((long long)b * H + h) * Sq + row[r]] = m[r] + logf(lr);
    }
  }
}

template <int DP>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const float* mask, void* out, float* lse, Strides qs,
                      Strides ks, Strides vs, Strides os, int B, int H,
                      int Sq, int Sk, int D, int mode, float scale,
                      cudaStream_t stream) {
  static bool done[64];
  const size_t smem = tc_smem_bytes<DP>();
  cudaError_t err = mma::allow_smem(attention_fwd_tc_kernel<DP>, smem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kTcRows - 1) / kTcRows, H, B);
  attention_fwd_tc_kernel<DP><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), mask, static_cast<bf16*>(out), lse, qs,
      ks, vs, os, H, Sq, Sk, D, mode, scale);
  return cudaGetLastError();
}

// ----------------------------------------------------------------- f32 --

constexpr int kRows = 64;                  // query rows per block
constexpr int kParts = 4;                  // threads per query row
constexpr int kThreads = kRows * kParts;   // 256
constexpr int kKeys = 32;                  // keys per shared-memory tile

// Four adjacent threads own one query row; each holds a quarter of the
// row's q and of its output accumulator (dims d = i*4 + part, so the four
// threads read four consecutive shared-memory words and the eight rows of a
// warp read the same words: no bank conflicts).  Keys stream through shared
// memory in tiles of 32 with an online (running max, running sum) softmax.
template <int DPAD>
__global__ void __launch_bounds__(kThreads)
attention_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ mask,
                         float* __restrict__ out, float* __restrict__ lse,
                         Strides qs, Strides ks, Strides vs, Strides os,
                         int H, int Sq, int Sk, int D, int mode,
                         float scale) {
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
  const float* q_row = q + b * qs.b + (long long)(valid_row ? row : 0) * qs.s
                       + h * qs.h;
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    const int d = i * kParts + part;
    qr[i] = (valid_row && d < D) ? q_row[d] : 0.f;
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
        kv = k[b * ks.b + s * ks.s + h * ks.h + d];
        vv = v[b * vs.b + s * vs.s + h * vs.h + d];
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
#pragma unroll
      for (int i = 0; i < DPT; ++i) {
        acc[i] = fmaf(e, v_tile[j][i * kParts + part], acc[i]);
      }
    }
    l = l * alpha + tile_sum;
    m = m_new;
    __syncthreads();
  }

  if (valid_row) {
    float* o_row = out + b * os.b + (long long)row * os.s + h * os.h;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int d = i * kParts + part;
      if (d < D) o_row[d] = acc[i] / l;
    }
    if (part == 0) lse[((long long)b * H + h) * Sq + row] = m + logf(l);
  }
}

cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const float* mask, void* out, float* lse, Strides qs,
                       Strides ks, Strides vs, Strides os, int B, int H,
                       int Sq, int Sk, int D, int mode, float scale,
                       cudaStream_t stream) {
  const dim3 grid((Sq + kRows - 1) / kRows, H, B);
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  float* ot = static_cast<float*>(out);
#define MPMC_LAUNCH(DPAD)                                                   \
  attention_fwd_f32_kernel<DPAD><<<grid, kThreads, 0, stream>>>(            \
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
  return cudaGetLastError();
}

bool aligned16(const void* p, long long sb, long long ss, long long sh) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % 8 == 0 &&
         ss % 8 == 0 && sh % 8 == 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  mode: 0 none, 1 padding, 2 segments.
// Strides are in elements, for [B, S, H, D] tensors whose last dim is
// contiguous; bf16 needs D % 8 == 0 and 16-byte aligned q, k, v rows.
// mask is f32 [B, Sk] (unused in mode 0).  Sq, Sk <= mma::kMaxSeq.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int mpmc_attention_fwd(
    const void* q, const void* k, const void* v, const float* mask,
    void* out, float* lse, int dtype, int mode, int B, int H, int Sq, int Sk,
    int D, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    float scale, void* stream) {
  if (B < 1 || H < 1 || Sq < 1 || Sk < 1 || Sq > mma::kMaxSeq ||
      Sk > mma::kMaxSeq || D < 1 || D > 128 || mode < 0 || mode > 2 ||
      (mode != 0 && mask == nullptr) || dtype < 0 || dtype > 1 ||
      B > 65535 || H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 1 &&
      (D % 8 != 0 || !aligned16(q, q_sb, q_ss, q_sh) ||
       !aligned16(k, k_sb, k_ss, k_sh) || !aligned16(v, v_sb, v_ss, v_sh) ||
       reinterpret_cast<uintptr_t>(out) % 4 != 0 || o_sb % 2 != 0 ||
       o_ss % 2 != 0 || o_sh % 2 != 0)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, os{o_sb, o_ss, o_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_f32(q, k, v, mask, out, lse, qs, ks, vs, os, B, H, Sq, Sk,
                     D, mode, scale, st);
  } else if (D <= 64) {
    err = launch_tc<64>(q, k, v, mask, out, lse, qs, ks, vs, os, B, H, Sq,
                        Sk, D, mode, scale, st);
  } else {
    err = launch_tc<128>(q, k, v, mask, out, lse, qs, ks, vs, os, B, H, Sq,
                         Sk, D, mode, scale, st);
  }
  return static_cast<int>(err);
}

extern "C" const char* mpmc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
