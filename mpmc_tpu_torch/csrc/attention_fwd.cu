// Exact softmax attention forward for Hopper (sm_90a): bf16 on the tensor
// cores, IEEE f32 register-tiled on the CUDA cores.
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
// f32 design (attention_fwd_f32_kernel, IEEE f32 on the CUDA cores: TF32
// tensor cores would break the 1e-5 card-vs-CPU checks).  At the corpus
// MLM shape ([64,128,12,64]) the forward does 3.2 GFLOP for 101 MB, so its
// bound is the operations: 0.048 ms at the 67 TFLOP/s f32 FFMA rate.  One
// block of 256 threads per (128-query tile, head, batch), two blocks an SM
// (102.5 KB of shared memory, 128 registers).  q stays in shared memory;
// k and v stream through in 64-key tiles by cp.async (16-byte copies where
// D % 4 == 0 and the rows are 16-byte aligned, else 4-byte copies: a
// template parameter of the same kernel), the next tile's k landing during
// this tile's P.V and its v during the next scores.  s = q.k^T and out +=
// P.V are register-tiled (simt_f32.cuh): each thread owns an 8 x 4
// micro-tile, and each 128-bit shared-memory load feeds 10.7 FFMAs, where
// the CUDA-core kernel this replaced paid one load and two shuffles per
// FFMA and per key.  The online softmax takes the row max and sum once per
// key tile over the half-warp of a row.  Key groups of 16 wholly past Sk
// and warps whose rows all lie past Sq skip their products, so S = 197
// costs about 208 x 208 of work, not 256 x 256.  What holds it at about a
// third of the FFMA rate: shared-memory bandwidth (32 words a cycle for 128
// FFMA lanes, and 0.375 words an FFMA), the register cap of two blocks an
// SM (a little spilled), and the softmax between the two products.
//
// Times (NVIDIA H100 80GB HBM3, 700 W; PERF.md names the runs): at
// [16,128,12,64] bf16 padding the CUDA-core kernel the tensor-core design
// replaced took 0.08559 ms, SDPA 0.011648 ms; the bound is 0.003788 ms.
// In f32 at [64,128,12,64] padding this kernel takes 0.134 ms (the kernel it
// replaced 0.318, SDPA 0.140), at [128,197,12,64] none 0.711 ms (1.915,
// SDPA 0.807).
//
// Built by mpmc_tpu_torch/ops/build.py with nvcc and called through ctypes
// by mpmc_tpu_torch/ops/attention.py; the C entry point returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "mma_bf16.cuh"
#include "simt_f32.cuh"

namespace {

using mma::bf16;

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

constexpr int kF32Rows = 8;                // rows of a thread's micro-tile
constexpr int kF32Queries = 16 * kF32Rows;  // 128 queries a block

template <int DP>
constexpr size_t f32_smem_bytes() {
  // q and P (128 rows each), k and v (64 rows), per-key mask info and
  // per-query segment ids.
  return ((kF32Queries + 2 * simt::kTile) * (DP + 4) +
          kF32Queries * simt::kLdP + simt::kTile + kF32Queries) *
         sizeof(float);
}

// One block of 256 threads per (128-query tile, head, batch); each thread
// owns 8 query rows (the query segment ids wait in shared memory, which
// keeps the kernel near 128 registers).  The q tile stays in shared
// memory; the keys stream through in 64-key tiles of k and v, each copy in
// flight while the block works on the other operand: the next tile's k
// lands during this tile's P.V, its v during its own scores.  For each key
// tile: s = q.k^T as 8 x 4 register micro-tiles (simt::dot_tile), times
// scale plus the bias, -inf past Sk; the online softmax (row max and row
// sum over the half-warp of a row, the running output rescaled once per
// tile); P to shared memory; out += P.V (simt::pv_tile).  Key groups of 16
// wholly past Sk and warps whose 16 rows lie past Sq skip their products
// (S = 197 = 128 + 69).
template <int DP, bool VEC>
__global__ void __launch_bounds__(simt::kThreads, DP == 64 ? 2 : 1)
attention_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ mask,
                         float* __restrict__ out, float* __restrict__ lse,
                         Strides qs, Strides ks, Strides vs, Strides os,
                         int H, int Sq, int Sk, int D, int mode,
                         float scale) {
  constexpr int T = simt::kTile;
  constexpr int R = kF32Rows;
  constexpr int QT = kF32Queries;
  constexpr int LD = DP + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  float* k_s = q_s + QT * LD;
  float* v_s = k_s + T * LD;
  float* p_s = v_s + T * LD;
  float* info_s = p_s + QT * simt::kLdP;
  float* qseg_s = info_s + T;              // segments mode: Sq == Sk

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * QT;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int r0 = simt::first_row<R>(tid);
  const int nq = min(QT, Sq - q0);
  const bool rows_here = simt::warp_first_row<R>(tid) < nq;
  const int n_tiles = (Sk + T - 1) / T;
  const float* k_bh = k + b * ks.b + h * ks.h;
  const float* v_bh = v + b * vs.b + h * vs.h;

  auto issue_k = [&](int t) {
    const int k0 = t * T;
    const int nk = min(T, Sk - k0);
    simt::load_tile<DP, VEC>(k_s, k_bh + (long long)k0 * ks.s, ks.s, nk, D,
                             tid);
    mma::cp_async_commit();
    mma::store_key_info(info_s, mask, b, Sk, k0, nk, mode, tid,
                        simt::kThreads);
  };
  auto issue_v = [&](int t) {
    const int k0 = t * T;
    simt::load_tile<DP, VEC>(v_s, v_bh + (long long)k0 * vs.s, vs.s,
                             min(T, Sk - k0), D, tid);
    mma::cp_async_commit();
  };

  simt::load_tile<DP, VEC, QT>(
      q_s, q + b * qs.b + h * qs.h + (long long)q0 * qs.s, qs.s, nq, D, tid);
  issue_k(0);                              // one group with q
  issue_v(0);

  float m[R], l[R], o[R][DP / 16];
  for (int i = tid; i < QT; i += simt::kThreads) {
    qseg_s[i] =
        (mode == 2 && i < nq) ? mask[(long long)b * Sk + q0 + i] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  simt::zero<DP, R>(o);

  for (int t = 0; t < n_tiles; ++t) {
    const int nk = min(T, Sk - t * T);
    mma::cp_async_wait<1>();               // k of tile t (and q) landed
    __syncthreads();
    if (rows_here) {
      const int nj = (nk + 15) >> 4;
      float s[R][4];
      simt::dot_tile<DP, R>(s, q_s, r0, k_s, tx, nj);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        float tile_max = -INFINITY;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = tx + 16 * j;
          s[i][j] = (j < nj && key < nk)
                        ? s[i][j] * scale + mma::key_bias(mode, info_s[key],
                                                          qseg_s[r0 + i])
                        : -INFINITY;       // past the last key: no key at all
          tile_max = fmaxf(tile_max, s[i][j]);
        }
        const float m_new = fmaxf(m[i], simt::max16(tile_max));
        const float alpha = expf(m[i] - m_new);   // 0 on the first tile
        m[i] = m_new;
#pragma unroll
        for (int c = 0; c < DP / 16; ++c) o[i][c] *= alpha;
        float tile_sum = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j < nj) {
            const float p = expf(s[i][j] - m_new);
            tile_sum += p;
            p_s[(r0 + i) * simt::kLdP + tx + 16 * j] = p;
          }
        }
        l[i] = l[i] * alpha + simt::sum16(tile_sum);
      }
    }
    __syncthreads();                       // P complete; k free
    if (t + 1 < n_tiles) {
      issue_k(t + 1);
      mma::cp_async_wait<1>();             // v of tile t landed
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    if (rows_here) simt::pv_tile<DP, R>(o, p_s, r0, v_s, tx, nk);
    __syncthreads();                       // v free
    if (t + 1 < n_tiles) issue_v(t + 1);
  }

  if (rows_here) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = q0 + r0 + i;
      if (row >= Sq) continue;
      float* o_row = out + b * os.b + (long long)row * os.s + h * os.h;
#pragma unroll
      for (int c = 0; c < DP / 16; ++c) {
        const int d = (c / 4) * 64 + tx * 4 + c % 4;
        if (d < D) o_row[d] = o[i][c] / l[i];
      }
      if (tx == 0) lse[((long long)b * H + h) * Sq + row] = m[i] + logf(l[i]);
    }
  }
}

template <int DP, bool VEC>
cudaError_t launch_f32_dp(const float* q, const float* k, const float* v,
                          const float* mask, float* out, float* lse,
                          Strides qs, Strides ks, Strides vs, Strides os,
                          int B, int H, int Sq, int Sk, int D, int mode,
                          float scale, cudaStream_t stream) {
  static bool done[64];
  const size_t smem = f32_smem_bytes<DP>();
  cudaError_t err =
      mma::allow_smem(attention_fwd_f32_kernel<DP, VEC>, smem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kF32Queries - 1) / kF32Queries, H, B);
  attention_fwd_f32_kernel<DP, VEC><<<grid, simt::kThreads, smem, stream>>>(
      q, k, v, mask, out, lse, qs, ks, vs, os, H, Sq, Sk, D, mode, scale);
  return cudaGetLastError();
}

// 16-byte copies where every row of q, k and v allows them, else the same
// kernel with 4-byte copies; DP = 64 up to D = 64, else 128.
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const float* mask, void* out, float* lse, Strides qs,
                       Strides ks, Strides vs, Strides os, int B, int H,
                       int Sq, int Sk, int D, int mode, float scale,
                       cudaStream_t stream) {
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  float* ot = static_cast<float*>(out);
  const bool vec = simt::vec_ok(q, D, qs.b, qs.s, qs.h) &&
                   simt::vec_ok(k, D, ks.b, ks.s, ks.h) &&
                   simt::vec_ok(v, D, vs.b, vs.s, vs.h);
#define MPMC_LAUNCH(DP, VEC)                                                \
  return launch_f32_dp<DP, VEC>(qt, kt, vt, mask, ot, lse, qs, ks, vs, os,  \
                                B, H, Sq, Sk, D, mode, scale, stream)
  if (D <= 64) {
    if (vec) MPMC_LAUNCH(64, true);
    MPMC_LAUNCH(64, false);
  }
  if (vec) MPMC_LAUNCH(128, true);
  MPMC_LAUNCH(128, false);
#undef MPMC_LAUNCH
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
