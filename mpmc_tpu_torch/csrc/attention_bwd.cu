// Exact softmax attention backward for Hopper (sm_90a): bf16 on the tensor
// cores, IEEE f32 register-tiled on the CUDA cores.
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
// O(1) has lost the O(1) part to f32 absorption.  Each query row's max m
// and sum l are recomputed and kept as two numbers, as the TPU kernel
// recomputes the softmax of its whole row.
//
// What bounds it on this card: at the training path's text shape (q, k, v
// [16,128,12,64] bf16) the function must move 25.3 MB (q, k, v, out, dO
// read, dq, dk, dv written, the f32 lse and the mask) for 1.0 GFLOP of
// products, which is 7.5 us at 3.35 TB/s and 1.0 us at the 989 TFLOP/s
// bf16 tensor-core rate: memory bound, plus launch latency.  The tensors
// are read and written in place in [B,S,H,D] (the TPU path transposes all
// five inputs and the three outputs to [B,H,S,D]), nothing of size S x S
// reaches device memory, and no atomics are used, so two runs are
// bit-equal.
//
// bf16 design, Sq, Sk <= 128 (every main-path shape): ONE launch,
// attention_bwd_fused_kernel, one block of 8 warps per (head, batch) with
// qs, k, v, dO and out of the pair in about 150 KB of XOR-swizzled dynamic
// shared memory (cp.async, 16-byte copies straight from [B,S,H,D]).  Each
// warp owns 16 query rows: s = qs.k^T and dP = dO.v^T on the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 accumulate, fed by ldmatrix), P from the
// saved lse or from the exact row max and sum (no pre-pass), delta over the
// saved out, and dS; it stages round(P) and dS in shared memory as bf16.
// After one barrier, warps split over key rows compute dV = P^T.dO and
// dK = dS^T.qs (ldmatrix.trans gives the transposed operands), and warps
// over query rows compute dQ = (dS.K) * scale.  The bf16 operands are the
// reference's rounding points, so they fall out of the design; dP is summed
// one 16-wide chunk per mma and the chunks in IEEE f32 (chunked_product),
// so that dS rounds to bf16 as near the reference as an f32 dot product.
//
// bf16 design, 128 < S <= 1024 (real manifests; ViT-B/16 and L/16, S =
// 197 at 224 pixels and 577 at 384): two tensor-core launches, each
// recomputing s and P, no atomics.  attention_bwd_dq_tc_kernel, one
// block per (64-query tile, head, batch), walks the key tiles (twice more
// first in segments mode, for the exact max and then the sum) and writes
// dQ plus each row's delta, m and l; attention_bwd_dkdv_tc_kernel, one
// block per (64-key tile, head, batch), walks the query tiles in the
// transposed form (s^T = k.qs^T, so P^T and dS^T go from the accumulators
// to the dV and dK products in registers).  A ragged last tile (577 = 9 x
// 64 + 1 holds one row) is zero-filled by cp.async past Sq or Sk, and
// only rows below Sq or Sk are written.
//
// f32 design (IEEE f32 on the CUDA cores: TF32 tensor cores would break
// the 1e-4 + 1e-5|x| card-vs-CPU checks).  At the corpus MLM shape
// ([64,128,12,64]) the function is 8.1 GFLOP of products for 201 MB, so
// its bound is the operations: 0.120 ms at the 67 TFLOP/s FFMA rate.  TWO
// launches a call, no atomics, the shape of the bf16 long path on the
// CUDA cores: attention_bwd_dq_f32_kernel, one block of 256 threads per
// (64-query tile, head, batch), sums delta itself, in segments mode first
// takes each row's exact max and sum in one online pass over the key tiles
// (double-buffered in the k and v tiles), then walks the key tiles for s,
// dP, dS and dQ += dS.K, and writes dQ, delta and (segments) m and l;
// attention_bwd_dkdv_f32_kernel, one block per 64-key tile, walks the
// query tiles in the transposed form (s^T = k.qs^T, dP^T = v.dO^T, dV +=
// P^T.dO, dK += dS^T.qs).  That is 7 products of S x S x D where the
// function needs 5 (8 in segments mode), a floor of 0.168 ms at the MLM
// shape.  Every product is register-tiled as in the forward (simt_f32.cuh:
// 4 x 4 micro-tiles, one 128-bit shared-memory load per 8 FFMAs, 64-row
// tiles copied by cp.async, 16 or 4 bytes at a time); qs = q * scale is
// formed in shared memory by the threads that copied q.  Two blocks an SM
// (86 and 103 KB, 128 registers with a few bytes spilled).  The earlier
// kernels this replaced took three launches, paid one shared-memory load
// and two shuffles per FFMA, and recomputed s and dP in both the dQ and
// the dK/dV kernels plus s once more for the row statistics.
//
// Times (NVIDIA H100 80GB HBM3, 700 W; PERF.md names the runs): the three
// CUDA-core launches the bf16 design replaced took 0.26569 ms at
// [16,128,12,64] padding and 0.22486 ms at the packed [6,128,12,64]
// segments shape; the bound is 0.007544 ms at the first.  In f32 this
// design takes 0.437 ms at [64,128,12,64] padding (the kernels it
// replaced 1.004, SDPA's backward alone 0.308), 0.552 ms in segments mode
// (1.291, 0.313) and 2.288 ms at [128,197,12,64] none (6.202, 1.939).
//
// Built by mpmc_tpu_torch/ops/build.py with nvcc and called through ctypes
// by mpmc_tpu_torch/ops/attention.py; the C entry point returns the CUDA
// error of the first launch that fails (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "mma_bf16.cuh"
#include "simt_f32.cuh"

namespace {

using mma::bf16;
using mma::kNegInf;
using mma::key_bias;

// Offset of row s of head h of sample b in a contiguous [B, S, H, D] tensor.
__device__ __forceinline__ long long row_offset(int b, int s, int h, int S,
                                                int H, int D) {
  return ((static_cast<long long>(b) * S + s) * H + h) * D;
}

// ---------------------------------------------------------------- bf16 --

// A fragments of a warp's 16 rows of a tile, each bf16 times s rounded
// back to bf16 (qs = round(q * round(scale)) in the reference).
template <int DP>
__device__ __forceinline__ void load_a_scaled(uint32_t (&a)[DP / 16][4],
                                              const bf16* tile, int r0,
                                              float s, int lane) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    mma::load_a<DP>(a[kk], tile, r0, kk, lane);
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = mma::scale_pair(a[kk][i], s);
  }
}

// Rows [0, rows) of a swizzled tile times s, each value rounded back to
// bf16 (qs = round(q * round(scale)) in the reference), in place.
template <int DP>
__device__ __forceinline__ void scale_tile(bf16* tile, int rows, float s,
                                           int tid, int nthreads) {
  for (int i = tid; i < rows * DP / 8; i += nthreads) {
    uint4* chunk = reinterpret_cast<uint4*>(tile + i * 8);
    uint4 x = *chunk;
    x.x = mma::scale_pair(x.x, s);
    x.y = mma::scale_pair(x.y, s);
    x.z = mma::scale_pair(x.z, s);
    x.w = mma::scale_pair(x.w, s);
    *chunk = x;
  }
}

// delta = sum_d dO * out of local tile row r (f32), summed over the quad:
// lane t of the quad takes the 16-byte chunks c with c % 4 == t.
template <int DP>
__device__ __forceinline__ float row_delta(const bf16* do_s,
                                           const bf16* o_s, int r, int t) {
  float acc = 0.f;
#pragma unroll
  for (int c = t; c < DP / 8; c += 4) {
    const uint4 x = *reinterpret_cast<const uint4*>(do_s + mma::swz<DP>(r, c));
    const uint4 y = *reinterpret_cast<const uint4*>(o_s + mma::swz<DP>(r, c));
    const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
    const uint32_t ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = mma::unpack_bf16(xs[i]);
      const float2 b = mma::unpack_bf16(ys[i]);
      acc = fmaf(a.x, b.x, acc);
      acc = fmaf(a.y, b.y, acc);
    }
  }
  return mma::quad_sum(acc);
}

// Store a warp's 16 x DP f32 C fragments as bf16 rows (row r0 + g, + 8) of
// a contiguous [B, S, H, D] tensor; rows at or past n_rows are skipped.
template <int DP>
__device__ __forceinline__ void store_rows(bf16* dst_bh, long long stride,
                                           const float (&acc)[DP / 8][4],
                                           int r0, int n_rows, int D,
                                           float mul, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + (lane >> 2) + 8 * r;
    if (row >= n_rows) continue;
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt) {
      const int d = dt * 8 + 2 * t;
      if (d < D) {
        *reinterpret_cast<uint32_t*>(dst_bh + row * stride + d) =
            mma::pack_bf16(acc[dt][2 * r] * mul, acc[dt][2 * r + 1] * mul);
      }
    }
  }
}

template <int DP>
__device__ __forceinline__ void zero(float (&acc)[DP / 8][4]) {
#pragma unroll
  for (int dt = 0; dt < DP / 8; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
  }
}

// The bf16 A fragment of k-chunk kc from the C fragments of n-tiles 2 kc
// and 2 kc + 1.
template <int NT>
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4],
                                       const float (&c)[NT][4], int kc) {
  a[0] = mma::pack_bf16(c[2 * kc][0], c[2 * kc][1]);
  a[1] = mma::pack_bf16(c[2 * kc][2], c[2 * kc][3]);
  a[2] = mma::pack_bf16(c[2 * kc + 1][0], c[2 * kc + 1][1]);
  a[3] = mma::pack_bf16(c[2 * kc + 1][2], c[2 * kc + 1][3]);
}

// dP for the key n-tiles 2 np and 2 np + 1: A (16 rows of dO) times the
// rows of v_s.  Each 16-wide k-chunk is one mma from a zero accumulator and
// the chunks are summed in IEEE f32: the tensor core truncates inside a
// product chain, and dS = round(P (dP - delta)) must round as near the
// reference's f32 sums as an f32 dot product does (a fully masked padding
// sample has |dS| up to ~30, where one bf16 ulp is 0.125).
template <int DP>
__device__ __forceinline__ void chunked_product(float (&dp)[2][4],
                                                const uint32_t (&a)[DP / 16][4],
                                                const bf16* v_s, int np,
                                                int lane) {
#pragma unroll
  for (int e = 0; e < 4; ++e) dp[0][e] = dp[1][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t b[4];
    mma::load_b_nt<DP>(b, v_s, np * 16, kk, lane);
    float part[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    mma::mma16816(part[0], a[kk], b[0], b[1]);
    mma::mma16816(part[1], a[kk], b[2], b[3]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dp[0][e] += part[0][e];
      dp[1][e] += part[1][e];
    }
  }
}

constexpr int kFusedThreads = 256;         // 8 warps
constexpr int kFusedMax = 128;             // Sq, Sk of the one-launch path

template <int DP>
constexpr size_t fused_smem_bytes() {
  return (5 * kFusedMax * DP + 2 * kFusedMax * kFusedMax) * sizeof(bf16) +
         kFusedMax * sizeof(float);
}

template <int DP>
__global__ void __launch_bounds__(kFusedThreads, 1)
attention_bwd_fused_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v,
                           const float* __restrict__ mask,
                           const bf16* __restrict__ out,
                           const float* __restrict__ lse,
                           const bf16* __restrict__ dout,
                           bf16* __restrict__ dq, bf16* __restrict__ dk,
                           bf16* __restrict__ dv, int H, int Sq, int Sk,
                           int D, int mode, float scale) {
  constexpr int W = kFusedMax;             // width of the P and dS tiles
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = q_s + W * DP;
  bf16* v_s = k_s + W * DP;
  bf16* do_s = v_s + W * DP;
  bf16* o_s = do_s + W * DP;
  bf16* p_s = o_s + W * DP;                // round(P), [query][key]
  bf16* ds_s = p_s + W * W;                // dS, [query][key]
  float* key_info = reinterpret_cast<float*>(ds_s + W * W);

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int t = lane & 3;
  const int d_chunks = D / 8;
  const long long stride = static_cast<long long>(H) * D;
  const long long q_off = row_offset(b, 0, h, Sq, H, D);
  const long long k_off = row_offset(b, 0, h, Sk, H, D);
  const int sq_pad = (Sq + 15) & ~15;
  const int sk_pad = (Sk + 15) & ~15;
  const float scale_t = __bfloat162float(__float2bfloat16(scale));

  mma::load_tile<DP>(q_s, q + q_off, stride, sq_pad, Sq, d_chunks, tid,
                     kFusedThreads);
  mma::load_tile<DP>(k_s, k + k_off, stride, sk_pad, Sk, d_chunks, tid,
                     kFusedThreads);
  mma::cp_async_commit();
  mma::load_tile<DP>(v_s, v + k_off, stride, sk_pad, Sk, d_chunks, tid,
                     kFusedThreads);
  mma::load_tile<DP>(do_s, dout + q_off, stride, sq_pad, Sq, d_chunks, tid,
                     kFusedThreads);
  mma::load_tile<DP>(o_s, out + q_off, stride, sq_pad, Sq, d_chunks, tid,
                     kFusedThreads);
  mma::cp_async_commit();
  mma::store_key_info(key_info, mask, b, Sk, 0, Sk, mode, tid,
                      kFusedThreads);
  mma::cp_async_wait<1>();                 // q and k have landed
  __syncthreads();
  scale_tile<DP>(q_s, sq_pad, scale_t, tid, kFusedThreads);
  __syncthreads();                         // q_s now holds qs

  // Row phase: this warp's 16 query rows.
  const int r0 = warp * 16;
  const bool rows_here = r0 < sq_pad;
  int row[2];
  bool valid[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row[r] = r0 + (lane >> 2) + 8 * r;
    valid[r] = row[r] < Sq;
  }
  float p[16][4];
  if (rows_here) {
    float q_seg[2] = {0.f, 0.f};
    if (mode == 2) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (valid[r]) q_seg[r] = mask[(long long)b * Sk + row[r]];
      }
    }
    uint32_t qa[DP / 16][4];
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      mma::load_a<DP>(qa[kk], q_s, r0, kk, lane);
    }
    mma::attn_scores<DP, 16>(p, qa, k_s, key_info, q_seg, Sk, mode, 1.f,
                             lane);
    // e = exp(s - m) with m the saved lse (padding, none) or the exact row
    // max (segments, where P = e / sum(e)).
    float m[2], l[2] = {1.f, 1.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = mode == 2 ? mma::row_max<16>(p, r)
             : valid[r] ? lse[((long long)b * H + h) * Sq + row[r]] : 0.f;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[nt][e] = expf(p[nt][e] - m[e >> 1]);
        sum[e >> 1] += p[nt][e];
      }
    }
    if (mode == 2) {
      l[0] = mma::quad_sum(sum[0]);
      l[1] = mma::quad_sum(sum[1]);
    }
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float x = p[nt][e];
        if (mode == 2 && x != 0.f) x = x / l[r];   // zeros skip the slow path
        p[nt][e] = valid[r] ? x : 0.f;
      }
    }
  }
  mma::cp_async_wait<0>();                 // v, dO and out have landed
  __syncthreads();
  if (rows_here) {
    const float delta[2] = {row_delta<DP>(do_s, o_s, row[0], t),
                            row_delta<DP>(do_s, o_s, row[1], t)};
    uint32_t doa[DP / 16][4];
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      mma::load_a<DP>(doa[kk], do_s, r0, kk, lane);
    }
#pragma unroll
    for (int np = 0; np < 8; ++np) {
      if (np * 16 < sk_pad) {
        float dp[2][4];
        chunked_product<DP>(dp, doa, v_s, np, lane);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int nt = 2 * np + i;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float p0 = p[nt][2 * r], p1 = p[nt][2 * r + 1];
            const int at = mma::swz<W>(row[r], nt) + 2 * t;
            *reinterpret_cast<uint32_t*>(p_s + at) = mma::pack_bf16(p0, p1);
            *reinterpret_cast<uint32_t*>(ds_s + at) = mma::pack_bf16(
                p0 * (dp[i][2 * r] - delta[r]),
                p1 * (dp[i][2 * r + 1] - delta[r]));
          }
        }
      }
    }
  }
  __syncthreads();

  // Key phase: this warp's 16 key rows of dV = P^T.dO and dK = dS^T.qs.
  const int c0 = warp * 16;
  if (c0 < sk_pad) {
    float dva[DP / 8][4], dka[DP / 8][4];
    zero<DP>(dva);
    zero<DP>(dka);
#pragma unroll
    for (int kc = 0; kc < 8; ++kc) {
      if (kc * 16 < sq_pad) {
        uint32_t ap[4], ad[4];
        mma::load_a_t<W>(ap, p_s, c0, kc * 16, lane);
        mma::load_a_t<W>(ad, ds_s, c0, kc * 16, lane);
#pragma unroll
        for (int c = 0; c < DP / 16; ++c) {
          uint32_t bo[4], bq[4];
          mma::load_b_t<DP>(bo, do_s, kc * 16, c, lane);
          mma::mma16816(dva[2 * c], ap, bo[0], bo[1]);
          mma::mma16816(dva[2 * c + 1], ap, bo[2], bo[3]);
          mma::load_b_t<DP>(bq, q_s, kc * 16, c, lane);
          mma::mma16816(dka[2 * c], ad, bq[0], bq[1]);
          mma::mma16816(dka[2 * c + 1], ad, bq[2], bq[3]);
        }
      }
    }
    store_rows<DP>(dv + k_off, stride, dva, c0, Sk, D, 1.f, lane);
    store_rows<DP>(dk + k_off, stride, dka, c0, Sk, D, 1.f, lane);
  }

  // dQ = (dS . K) * scale for this warp's query rows.
  if (rows_here) {
    float dqa[DP / 8][4];
    zero<DP>(dqa);
#pragma unroll
    for (int kc = 0; kc < 8; ++kc) {
      if (kc * 16 < sk_pad) {
        uint32_t a[4];
        mma::load_a<W>(a, ds_s, r0, kc, lane);
#pragma unroll
        for (int c = 0; c < DP / 16; ++c) {
          uint32_t bk[4];
          mma::load_b_t<DP>(bk, k_s, kc * 16, c, lane);
          mma::mma16816(dqa[2 * c], a, bk[0], bk[1]);
          mma::mma16816(dqa[2 * c + 1], a, bk[2], bk[3]);
        }
      }
    }
    store_rows<DP>(dq + q_off, stride, dqa, r0, Sq, D, scale, lane);
  }
}

constexpr int kLongTile = 64;              // rows per block and per tile
constexpr int kLongThreads = 128;          // 4 warps x 16 rows

template <int DP>
constexpr size_t long_dq_smem_bytes() {
  return 5 * kLongTile * DP * sizeof(bf16) + kLongTile * sizeof(float);
}

template <int DP>
constexpr size_t long_dkdv_smem_bytes() {
  return 4 * kLongTile * DP * sizeof(bf16) + 4 * kLongTile * sizeof(float);
}

// 128 < S: dQ of one 64-query tile, and each row's delta (and m, l in
// segments mode) for attention_bwd_dkdv_tc_kernel.
template <int DP>
__global__ void __launch_bounds__(kLongThreads)
attention_bwd_dq_tc_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v,
                           const float* __restrict__ mask,
                           const bf16* __restrict__ out,
                           const float* __restrict__ lse,
                           const bf16* __restrict__ dout,
                           bf16* __restrict__ dq, float* __restrict__ delta,
                           float* __restrict__ row_m,
                           float* __restrict__ row_l, int H, int Sq, int Sk,
                           int D, int mode, float scale) {
  constexpr int T = kLongTile;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* do_s = q_s + T * DP;
  bf16* o_s = do_s + T * DP;
  bf16* k_s = o_s + T * DP;
  bf16* v_s = k_s + T * DP;
  float* key_info = reinterpret_cast<float*>(v_s + T * DP);

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * T;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int t = lane & 3;
  const int d_chunks = D / 8;
  const long long stride = static_cast<long long>(H) * D;
  const long long q_off = row_offset(b, q0, h, Sq, H, D);
  const long long k_off = row_offset(b, 0, h, Sk, H, D);
  const int nq = min(T, Sq - q0);
  const float scale_t = __bfloat162float(__float2bfloat16(scale));

  mma::load_tile<DP>(q_s, q + q_off, stride, T, nq, d_chunks, tid,
                     kLongThreads);
  mma::load_tile<DP>(do_s, dout + q_off, stride, T, nq, d_chunks, tid,
                     kLongThreads);
  mma::load_tile<DP>(o_s, out + q_off, stride, T, nq, d_chunks, tid,
                     kLongThreads);
  mma::cp_async_commit();
  mma::cp_async_wait<0>();
  __syncthreads();

  const int r0 = warp * 16;
  int row[2];
  bool valid[2];
  float q_seg[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row[r] = r0 + (lane >> 2) + 8 * r;     // in the tile
    valid[r] = row[r] < nq;
    if (mode == 2 && valid[r]) q_seg[r] = mask[(long long)b * Sk + q0 + row[r]];
  }
  uint32_t qa[DP / 16][4], doa[DP / 16][4];
  load_a_scaled<DP>(qa, q_s, r0, scale_t, lane);
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    mma::load_a<DP>(doa[kk], do_s, r0, kk, lane);
  }
  const float dl[2] = {row_delta<DP>(do_s, o_s, row[0], t),
                       row_delta<DP>(do_s, o_s, row[1], t)};
  const long long stat = ((long long)b * H + h) * Sq + q0;

  float m[2], l[2] = {1.f, 1.f};
  float s[8][4];
  if (mode == 2) {                         // the exact row max, then sum
    float sum[2] = {0.f, 0.f};
    m[0] = m[1] = -INFINITY;
    for (int pass = 0; pass < 2; ++pass) {
      for (int k0 = 0; k0 < Sk; k0 += T) {
        const int nk = min(T, Sk - k0);
        mma::load_tile<DP>(k_s, k + k_off + k0 * stride, stride,
                           (nk + 15) & ~15, nk, d_chunks, tid, kLongThreads);
        mma::cp_async_commit();
        mma::store_key_info(key_info, mask, b, Sk, k0, nk, mode, tid,
                            kLongThreads);
        mma::cp_async_wait<0>();
        __syncthreads();
        mma::attn_scores<DP, 8>(s, qa, k_s, key_info, q_seg, nk, mode, 1.f,
                                lane);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (pass == 0) {
            m[r] = fmaxf(m[r], mma::row_max<8>(s, r));
          } else {
#pragma unroll
            for (int nt = 0; nt < 8; ++nt) {
              sum[r] += expf(s[nt][2 * r] - m[r]) +
                        expf(s[nt][2 * r + 1] - m[r]);
            }
          }
        }
        __syncthreads();
      }
    }
    l[0] = mma::quad_sum(sum[0]);
    l[1] = mma::quad_sum(sum[1]);
  } else {
#pragma unroll
    for (int r = 0; r < 2; ++r) m[r] = valid[r] ? lse[stat + row[r]] : 0.f;
  }

  float dqa[DP / 8][4];
  zero<DP>(dqa);
  for (int k0 = 0; k0 < Sk; k0 += T) {
    const int nk = min(T, Sk - k0);
    const int rows = (nk + 15) & ~15;
    mma::load_tile<DP>(k_s, k + k_off + k0 * stride, stride, rows, nk,
                       d_chunks, tid, kLongThreads);
    mma::load_tile<DP>(v_s, v + k_off + k0 * stride, stride, rows, nk,
                       d_chunks, tid, kLongThreads);
    mma::cp_async_commit();
    mma::store_key_info(key_info, mask, b, Sk, k0, nk, mode, tid,
                        kLongThreads);
    mma::cp_async_wait<0>();
    __syncthreads();
    mma::attn_scores<DP, 8>(s, qa, k_s, key_info, q_seg, nk, mode, 1.f,
                            lane);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float x = expf(s[nt][e] - m[r]);
        if (mode == 2 && x != 0.f) x = x / l[r];
        s[nt][e] = valid[r] ? x : 0.f;
      }
    }
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      if (np * 16 < rows) {
        float ds[2][4];
        chunked_product<DP>(ds, doa, v_s, np, lane);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ds[i][e] = s[2 * np + i][e] * (ds[i][e] - dl[e >> 1]);
          }
        }
        uint32_t a[4];
        c_to_a<2>(a, ds, 0);
#pragma unroll
        for (int c = 0; c < DP / 16; ++c) {
          uint32_t bk[4];
          mma::load_b_t<DP>(bk, k_s, np * 16, c, lane);
          mma::mma16816(dqa[2 * c], a, bk[0], bk[1]);
          mma::mma16816(dqa[2 * c + 1], a, bk[2], bk[3]);
        }
      }
    }
    __syncthreads();                       // before the next tile's copies
  }
  store_rows<DP>(dq + q_off, stride, dqa, r0, nq, D, scale, lane);
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!valid[r]) continue;
      delta[stat + row[r]] = dl[r];
      if (mode == 2) {
        row_m[stat + row[r]] = m[r];
        row_l[stat + row[r]] = l[r];
      }
    }
  }
}

// 128 < S: dK and dV of one 64-key tile, in the transposed form: each warp
// owns 16 keys, s^T = k . qs^T and dP^T = v . dO^T, so P^T and dS^T go from
// the accumulators to dV += P^T . dO and dK += dS^T . qs in registers.
template <int DP>
__global__ void __launch_bounds__(kLongThreads)
attention_bwd_dkdv_tc_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const float* __restrict__ mask,
                             const float* __restrict__ lse,
                             const bf16* __restrict__ dout,
                             const float* __restrict__ delta,
                             const float* __restrict__ row_m,
                             const float* __restrict__ row_l,
                             bf16* __restrict__ dk, bf16* __restrict__ dv,
                             int H, int Sq, int Sk, int D, int mode,
                             float scale) {
  constexpr int T = kLongTile;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);
  bf16* v_s = k_s + T * DP;
  bf16* q_s = v_s + T * DP;
  bf16* do_s = q_s + T * DP;
  float* q_m = reinterpret_cast<float*>(do_s + T * DP);
  float* q_l = q_m + T;
  float* q_delta = q_l + T;
  float* q_seg = q_delta + T;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int k0 = blockIdx.x * T;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int t = lane & 3;
  const int d_chunks = D / 8;
  const long long stride = static_cast<long long>(H) * D;
  const long long k_off = row_offset(b, k0, h, Sk, H, D);
  const long long q_base = row_offset(b, 0, h, Sq, H, D);
  const int nk = min(T, Sk - k0);
  const float scale_t = __bfloat162float(__float2bfloat16(scale));

  mma::load_tile<DP>(k_s, k + k_off, stride, T, nk, d_chunks, tid,
                     kLongThreads);
  mma::load_tile<DP>(v_s, v + k_off, stride, T, nk, d_chunks, tid,
                     kLongThreads);
  mma::cp_async_commit();

  const int c0 = warp * 16;
  bool key_valid[2];
  float info[2] = {0.f, 0.f};              // padding: bias; segments: id
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = c0 + (lane >> 2) + 8 * r;
    key_valid[r] = key < nk;
    if (key_valid[r] && mode != 0) {
      const float mv = mask[(long long)b * Sk + k0 + key];
      info[r] = mode == 1 ? (1.f - mv) * kNegInf : mv;
    }
  }

  float dva[DP / 8][4], dka[DP / 8][4];
  zero<DP>(dva);
  zero<DP>(dka);
  for (int q0 = 0; q0 < Sq; q0 += T) {
    const int nq = min(T, Sq - q0);
    const int rows = (nq + 15) & ~15;
    mma::load_tile<DP>(q_s, q + q_base + q0 * stride, stride, rows, nq,
                       d_chunks, tid, kLongThreads);
    mma::load_tile<DP>(do_s, dout + q_base + q0 * stride, stride, rows, nq,
                       d_chunks, tid, kLongThreads);
    mma::cp_async_commit();
    for (int i = tid; i < T; i += kLongThreads) {
      const bool in = i < nq;
      const long long idx = ((long long)b * H + h) * Sq + q0 + i;
      q_m[i] = in ? (mode == 2 ? row_m[idx] : lse[idx]) : 0.f;
      q_l[i] = (in && mode == 2) ? row_l[idx] : 1.f;
      q_delta[i] = in ? delta[idx] : 0.f;
      q_seg[i] = (in && mode == 2) ? mask[(long long)b * Sk + q0 + i] : 0.f;
    }
    mma::cp_async_wait<0>();
    __syncthreads();

    float st[8][4], dpt[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t ka[4], va[4];
      mma::load_a<DP>(ka, k_s, c0, kk, lane);
      mma::load_a<DP>(va, v_s, c0, kk, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (np * 16 < rows) {
          uint32_t bq[4], bo[4];
          mma::load_b_nt<DP>(bq, q_s, np * 16, kk, lane);
#pragma unroll
          for (int i = 0; i < 4; ++i) bq[i] = mma::scale_pair(bq[i], scale_t);
          mma::mma16816(st[2 * np], ka, bq[0], bq[1]);
          mma::mma16816(st[2 * np + 1], ka, bq[2], bq[3]);
          mma::load_b_nt<DP>(bo, do_s, np * 16, kk, lane);
          float part[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
          mma::mma16816(part[0], va, bo[0], bo[1]);
          mma::mma16816(part[1], va, bo[2], bo[3]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            dpt[2 * np][e] += part[0][e];
            dpt[2 * np + 1][e] += part[1][e];
          }
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = nt * 8 + 2 * t + (e & 1);   // query in the tile
        const int r = e >> 1;
        float p = 0.f, ds = 0.f;
        if (j < nq && key_valid[r]) {
          p = expf(st[nt][e] + key_bias(mode, info[r], q_seg[j]) - q_m[j]);
          if (mode == 2 && p != 0.f) p = p / q_l[j];
          ds = p * (dpt[nt][e] - q_delta[j]);
        }
        st[nt][e] = p;
        dpt[nt][e] = ds;
      }
    }
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      if (kc * 16 < rows) {
        uint32_t ap[4], ad[4];
        c_to_a<8>(ap, st, kc);
        c_to_a<8>(ad, dpt, kc);
#pragma unroll
        for (int c = 0; c < DP / 16; ++c) {
          uint32_t bo[4], bq[4];
          mma::load_b_t<DP>(bo, do_s, kc * 16, c, lane);
          mma::mma16816(dva[2 * c], ap, bo[0], bo[1]);
          mma::mma16816(dva[2 * c + 1], ap, bo[2], bo[3]);
          mma::load_b_t<DP>(bq, q_s, kc * 16, c, lane);
#pragma unroll
          for (int i = 0; i < 4; ++i) bq[i] = mma::scale_pair(bq[i], scale_t);
          mma::mma16816(dka[2 * c], ad, bq[0], bq[1]);
          mma::mma16816(dka[2 * c + 1], ad, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();                       // before the next tile's copies
  }
  store_rows<DP>(dv + k_off, stride, dva, c0, nk, D, 1.f, lane);
  store_rows<DP>(dk + k_off, stride, dka, c0, nk, D, 1.f, lane);
}

template <int DP>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const float* mask, const void* out, const float* lse,
                      const void* dout, void* dq, void* dk, void* dv,
                      float* delta, float* row_m, float* row_l, int B, int H,
                      int Sq, int Sk, int D, int mode, float scale,
                      cudaStream_t stream) {
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* ot = static_cast<const bf16*>(out);
  const bf16* dot = static_cast<const bf16*>(dout);
  cudaError_t err;
  if (Sq <= kFusedMax && Sk <= kFusedMax) {
    static bool done[64];
    const size_t smem = fused_smem_bytes<DP>();
    err = mma::allow_smem(attention_bwd_fused_kernel<DP>, smem, done);
    if (err != cudaSuccess) return err;
    attention_bwd_fused_kernel<DP><<<dim3(H, B), kFusedThreads, smem,
                                     stream>>>(
        qt, kt, vt, mask, ot, lse, dot, static_cast<bf16*>(dq),
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, Sq, Sk, D, mode,
        scale);
    return cudaGetLastError();
  }
  static bool done_dq[64], done_kv[64];
  const size_t smem_dq = long_dq_smem_bytes<DP>();
  const size_t smem_kv = long_dkdv_smem_bytes<DP>();
  err = mma::allow_smem(attention_bwd_dq_tc_kernel<DP>, smem_dq, done_dq);
  if (err != cudaSuccess) return err;
  err = mma::allow_smem(attention_bwd_dkdv_tc_kernel<DP>, smem_kv, done_kv);
  if (err != cudaSuccess) return err;
  const dim3 grid_q((Sq + kLongTile - 1) / kLongTile, H, B);
  const dim3 grid_k((Sk + kLongTile - 1) / kLongTile, H, B);
  attention_bwd_dq_tc_kernel<DP><<<grid_q, kLongThreads, smem_dq, stream>>>(
      qt, kt, vt, mask, ot, lse, dot, static_cast<bf16*>(dq), delta, row_m,
      row_l, H, Sq, Sk, D, mode, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_dkdv_tc_kernel<DP><<<grid_k, kLongThreads, smem_kv,
                                     stream>>>(
      qt, kt, vt, mask, lse, dot, delta, row_m, row_l,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, Sq, Sk, D, mode,
      scale);
  return cudaGetLastError();
}

// ----------------------------------------------------------------- f32 --

template <int DP>
constexpr size_t dq_f32_smem_bytes() {
  // qs, dO, k, v tiles, dS, two buffers of per-key mask info, per-row
  // delta.
  return (4 * simt::tile_floats<DP>() + simt::score_floats() +
          3 * simt::kTile) * sizeof(float);
}

template <int DP>
constexpr size_t dkdv_f32_smem_bytes() {
  // k, v, qs, dO tiles, P^T and dS^T, per-query m, l, delta, segment id.
  return (4 * simt::tile_floats<DP>() + 2 * simt::score_floats() +
          4 * simt::kTile) * sizeof(float);
}

// Launch 1 of 2: dQ of one 64-query tile, and each row's delta (and m, l
// in segments mode) for attention_bwd_dkdv_f32_kernel.  qs = q * scale and
// dO stay in shared memory; delta = sum_d dO * out is summed by four
// threads a row.  In segments mode one pass over the key tiles first takes
// each row's exact max m and sum l (online, s only).  Then per key tile:
// s = qs.k^T and dP = dO.v^T as 4 x 4 register micro-tiles, P, dS = P (dP -
// delta) to shared memory, dQ += dS.K in registers; dQ * scale at the end.
template <int DP, bool VEC>
__global__ void __launch_bounds__(simt::kThreads, DP == 64 ? 2 : 1)
attention_bwd_dq_f32_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ mask,
                            const float* __restrict__ out,
                            const float* __restrict__ lse,
                            const float* __restrict__ dout,
                            float* __restrict__ dq, float* __restrict__ delta,
                            float* __restrict__ row_m,
                            float* __restrict__ row_l, int H, int Sq, int Sk,
                            int D, int mode, float scale) {
  constexpr int T = simt::kTile;
  constexpr int R = 4;                     // rows of a thread's micro-tile
  constexpr int TF = simt::tile_floats<DP>();
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs_s = reinterpret_cast<float*>(smem);
  float* do_s = qs_s + TF;
  float* k_s = do_s + TF;
  float* v_s = k_s + TF;
  float* ds_s = v_s + TF;
  float* info_s = ds_s + simt::score_floats();   // two buffers
  float* delta_s = info_s + 2 * T;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * T;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int r0 = simt::first_row<R>(tid);
  const int nq = min(T, Sq - q0);
  // Uniform over the warp.
  const bool rows_here = simt::warp_first_row<R>(tid) < nq;
  const long long stride = static_cast<long long>(H) * D;
  const long long q_off = row_offset(b, q0, h, Sq, H, D);
  const long long k_off = row_offset(b, 0, h, Sk, H, D);
  const long long stat = ((long long)b * H + h) * Sq + q0;

  simt::load_tile<DP, VEC>(qs_s, q + q_off, stride, nq, D, tid);
  simt::load_tile<DP, VEC>(do_s, dout + q_off, stride, nq, D, tid);
  mma::cp_async_commit();
  {
    // delta of row tid / 4, four threads a row.
    const int r = tid >> 2;
    const int part = tid & 3;
    float acc = 0.f;
    if (r < nq) {
      const float* o_row = out + q_off + r * stride;
      const float* d_row = dout + q_off + r * stride;
      for (int d = part; d < D; d += 4) acc = fmaf(d_row[d], o_row[d], acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0) delta_s[r] = acc;
  }
  mma::cp_async_wait<0>();
  simt::scale_own<DP, VEC>(qs_s, scale, tid);
  __syncthreads();

  float q_seg[R], m[R], l[R], dl[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const bool in = r0 + i < nq;
    q_seg[i] = (mode == 2 && in) ? mask[(long long)b * Sk + q0 + r0 + i] : 0.f;
    m[i] = mode == 2 ? -INFINITY : in ? lse[stat + r0 + i] : 0.f;
    l[i] = mode == 2 ? 0.f : 1.f;
    dl[i] = delta_s[r0 + i];
  }

  if (mode == 2) {
    // The exact row max and sum, the key tiles double-buffered in k_s and
    // v_s (v is not needed yet).
    const int n_tiles = (Sk + T - 1) / T;
    auto issue = [&](int t) {
      const int k0 = t * T;
      const int nk = min(T, Sk - k0);
      simt::load_tile<DP, VEC>((t & 1) ? v_s : k_s, k + k_off + k0 * stride,
                               stride, nk, D, tid);
      mma::cp_async_commit();
      mma::store_key_info(info_s + (t & 1) * T, mask, b, Sk, k0, nk, mode,
                          tid, simt::kThreads);
    };
    issue(0);
    for (int t = 0; t < n_tiles; ++t) {
      const int nk = min(T, Sk - t * T);
      if (t + 1 < n_tiles) {
        issue(t + 1);
        mma::cp_async_wait<1>();
      } else {
        mma::cp_async_wait<0>();
      }
      __syncthreads();
      if (rows_here) {
        const float* info = info_s + (t & 1) * T;
        const int nj = (nk + 15) >> 4;
        float s[R][4];
        simt::dot_tile<DP, R>(s, qs_s, r0, (t & 1) ? v_s : k_s, tx, nj);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          float tile_max = -INFINITY;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int key = tx + 16 * j;
            s[i][j] = (j < nj && key < nk)
                          ? s[i][j] + key_bias(mode, info[key], q_seg[i])
                          : -INFINITY;
            tile_max = fmaxf(tile_max, s[i][j]);
          }
          const float m_new = fmaxf(m[i], simt::max16(tile_max));
          float tile_sum = 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) tile_sum += expf(s[i][j] - m_new);
          l[i] = l[i] * expf(m[i] - m_new) + simt::sum16(tile_sum);
          m[i] = m_new;
        }
      }
      __syncthreads();                     // before this buffer is refilled
    }
  }

  float dqa[R][DP / 16];
  simt::zero<DP, R>(dqa);
  for (int k0 = 0; k0 < Sk; k0 += T) {
    const int nk = min(T, Sk - k0);
    simt::load_tile<DP, VEC>(k_s, k + k_off + k0 * stride, stride, nk, D,
                             tid);
    simt::load_tile<DP, VEC>(v_s, v + k_off + k0 * stride, stride, nk, D,
                             tid);
    mma::cp_async_commit();
    mma::store_key_info(info_s, mask, b, Sk, k0, nk, mode, tid,
                        simt::kThreads);
    mma::cp_async_wait<0>();
    __syncthreads();
    if (rows_here) {
      const int nj = (nk + 15) >> 4;
      float s[R][4], dp[R][4];
      simt::dot_tile<DP, R>(s, qs_s, r0, k_s, tx, nj);
      simt::dot_tile<DP, R>(dp, do_s, r0, v_s, tx, nj);
#pragma unroll
      for (int i = 0; i < R; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = tx + 16 * j;
          if (j >= nj) continue;
          float p = 0.f;
          if (key < nk) {
            p = expf(s[i][j] + key_bias(mode, info_s[key], q_seg[i]) - m[i]);
            if (mode == 2) p = p / l[i];
          }
          ds_s[(r0 + i) * simt::kLdP + key] = p * (dp[i][j] - dl[i]);
        }
      }
    }
    __syncthreads();                       // dS complete
    if (rows_here) simt::pv_tile<DP, R>(dqa, ds_s, r0, k_s, tx, nk);
    __syncthreads();                       // before the next tile's copies
  }
  if (rows_here) {
    simt::store_rows<DP, R>(dq + q_off, stride, dqa, r0, nq, D, scale, tx);
    if (tx == 0) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        if (r0 + i >= nq) continue;
        delta[stat + r0 + i] = dl[i];
        if (mode == 2) {
          row_m[stat + r0 + i] = m[i];
          row_l[stat + r0 + i] = l[i];
        }
      }
    }
  }
}

// Launch 2 of 2: dK and dV of one 64-key tile, in the transposed form.  k
// and v stay in shared memory; per query tile, s^T = k.qs^T and dP^T =
// v.dO^T as 4 x 4 register micro-tiles, P^T and dS^T to shared memory
// (each query's m, l and delta from launch 1, or lse), then dV += P^T.dO
// and dK += dS^T.qs in registers.
template <int DP, bool VEC>
__global__ void __launch_bounds__(simt::kThreads, DP == 64 ? 2 : 1)
attention_bwd_dkdv_f32_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ mask,
                              const float* __restrict__ lse,
                              const float* __restrict__ dout,
                              const float* __restrict__ delta,
                              const float* __restrict__ row_m,
                              const float* __restrict__ row_l,
                              float* __restrict__ dk, float* __restrict__ dv,
                              int H, int Sq, int Sk, int D, int mode,
                              float scale) {
  constexpr int T = simt::kTile;
  constexpr int R = 4;                     // rows of a thread's micro-tile
  constexpr int TF = simt::tile_floats<DP>();
  extern __shared__ __align__(128) unsigned char smem[];
  float* k_s = reinterpret_cast<float*>(smem);
  float* v_s = k_s + TF;
  float* qs_s = v_s + TF;
  float* do_s = qs_s + TF;
  float* pt_s = do_s + TF;
  float* dst_s = pt_s + simt::score_floats();
  float* qm_s = dst_s + simt::score_floats();
  float* ql_s = qm_s + T;
  float* qd_s = ql_s + T;
  float* qseg_s = qd_s + T;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int k0 = blockIdx.x * T;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int r0 = simt::first_row<R>(tid);   // this thread's R keys
  const int nk = min(T, Sk - k0);
  // Uniform over the warp.
  const bool keys_here = simt::warp_first_row<R>(tid) < nk;
  const long long stride = static_cast<long long>(H) * D;
  const long long k_off = row_offset(b, k0, h, Sk, H, D);
  const long long q_base = row_offset(b, 0, h, Sq, H, D);
  const float* stat_m = mode == 2 ? row_m : lse;

  simt::load_tile<DP, VEC>(k_s, k + k_off, stride, nk, D, tid);
  simt::load_tile<DP, VEC>(v_s, v + k_off, stride, nk, D, tid);
  mma::cp_async_commit();
  float info[R];                           // padding: bias; segments: id
#pragma unroll
  for (int i = 0; i < R; ++i) {
    info[i] = 0.f;
    if (r0 + i < nk && mode != 0) {
      const float mv = mask[(long long)b * Sk + k0 + r0 + i];
      info[i] = mode == 1 ? (1.f - mv) * kNegInf : mv;
    }
  }

  float dva[R][DP / 16], dka[R][DP / 16];
  simt::zero<DP, R>(dva);
  simt::zero<DP, R>(dka);
  for (int q0 = 0; q0 < Sq; q0 += T) {
    const int nq = min(T, Sq - q0);
    simt::load_tile<DP, VEC>(qs_s, q + q_base + q0 * stride, stride, nq, D,
                             tid);
    simt::load_tile<DP, VEC>(do_s, dout + q_base + q0 * stride, stride, nq,
                             D, tid);
    mma::cp_async_commit();
    if (tid < T) {
      const bool in = tid < nq;
      const long long idx = ((long long)b * H + h) * Sq + q0 + tid;
      qm_s[tid] = in ? stat_m[idx] : 0.f;
      ql_s[tid] = (in && mode == 2) ? row_l[idx] : 1.f;
      qd_s[tid] = in ? delta[idx] : 0.f;
      qseg_s[tid] = (in && mode == 2) ? mask[(long long)b * Sk + q0 + tid]
                                      : 0.f;
    }
    mma::cp_async_wait<0>();
    simt::scale_own<DP, VEC>(qs_s, scale, tid);
    __syncthreads();
    if (keys_here) {
      const int nj = (nq + 15) >> 4;
      float st[R][4], dpt[R][4];
      simt::dot_tile<DP, R>(st, k_s, r0, qs_s, tx, nj);
      simt::dot_tile<DP, R>(dpt, v_s, r0, do_s, tx, nj);
#pragma unroll
      for (int i = 0; i < R; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qi = tx + 16 * j;
          if (j >= nj) continue;
          float p = 0.f, ds = 0.f;
          if (qi < nq) {
            p = expf(st[i][j] + key_bias(mode, info[i], qseg_s[qi]) -
                     qm_s[qi]);
            if (mode == 2) p = p / ql_s[qi];
            ds = p * (dpt[i][j] - qd_s[qi]);
          }
          pt_s[(r0 + i) * simt::kLdP + qi] = p;
          dst_s[(r0 + i) * simt::kLdP + qi] = ds;
        }
      }
    }
    __syncthreads();                       // P^T and dS^T complete
    if (keys_here) {
      simt::pv_tile<DP, R>(dva, pt_s, r0, do_s, tx, nq);
      simt::pv_tile<DP, R>(dka, dst_s, r0, qs_s, tx, nq);
    }
    __syncthreads();                       // before the next tile's copies
  }
  if (keys_here) {
    simt::store_rows<DP, R>(dv + k_off, stride, dva, r0, nk, D, 1.f, tx);
    simt::store_rows<DP, R>(dk + k_off, stride, dka, r0, nk, D, 1.f, tx);
  }
}

template <int DP, bool VEC>
cudaError_t launch_f32_dp(const float* q, const float* k, const float* v,
                          const float* mask, const float* out,
                          const float* lse, const float* dout, float* dq,
                          float* dk, float* dv, float* delta, float* row_m,
                          float* row_l, int B, int H, int Sq, int Sk, int D,
                          int mode, float scale, cudaStream_t stream) {
  static bool done_dq[64], done_kv[64];
  const size_t smem_dq = dq_f32_smem_bytes<DP>();
  const size_t smem_kv = dkdv_f32_smem_bytes<DP>();
  cudaError_t err = mma::allow_smem(attention_bwd_dq_f32_kernel<DP, VEC>,
                                    smem_dq, done_dq);
  if (err != cudaSuccess) return err;
  err = mma::allow_smem(attention_bwd_dkdv_f32_kernel<DP, VEC>, smem_kv,
                        done_kv);
  if (err != cudaSuccess) return err;
  const dim3 grid_q((Sq + simt::kTile - 1) / simt::kTile, H, B);
  const dim3 grid_k((Sk + simt::kTile - 1) / simt::kTile, H, B);
  attention_bwd_dq_f32_kernel<DP, VEC>
      <<<grid_q, simt::kThreads, smem_dq, stream>>>(
          q, k, v, mask, out, lse, dout, dq, delta, row_m, row_l, H, Sq, Sk,
          D, mode, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_dkdv_f32_kernel<DP, VEC>
      <<<grid_k, simt::kThreads, smem_kv, stream>>>(
          q, k, v, mask, lse, dout, delta, row_m, row_l, dk, dv, H, Sq, Sk,
          D, mode, scale);
  return cudaGetLastError();
}

// Two launches, dQ first (it writes delta, and m and l in segments mode,
// which the dK/dV launch reads).  16-byte copies where q, k, v and dO
// allow them, else the same kernels with 4-byte copies; DP = 64 up to
// D = 64, else 128.
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const float* mask, const void* out, const float* lse,
                       const void* dout, void* dq, void* dk, void* dv,
                       float* delta, float* row_m, float* row_l, int B, int H,
                       int Sq, int Sk, int D, int mode, float scale,
                       cudaStream_t stream) {
  const long long sq = static_cast<long long>(Sq) * H * D;
  const long long sk = static_cast<long long>(Sk) * H * D;
  const long long hd = static_cast<long long>(H) * D;
  const bool vec = simt::vec_ok(q, D, sq, hd, D) &&
                   simt::vec_ok(k, D, sk, hd, D) &&
                   simt::vec_ok(v, D, sk, hd, D) &&
                   simt::vec_ok(dout, D, sq, hd, D);
#define MPMC_LAUNCH(DP, VEC)                                                \
  return launch_f32_dp<DP, VEC>(                                            \
      static_cast<const float*>(q), static_cast<const float*>(k),           \
      static_cast<const float*>(v), mask, static_cast<const float*>(out),   \
      lse, static_cast<const float*>(dout), static_cast<float*>(dq),        \
      static_cast<float*>(dk), static_cast<float*>(dv), delta, row_m,       \
      row_l, B, H, Sq, Sk, D, mode, scale, stream)
  if (D <= 64) {
    if (vec) MPMC_LAUNCH(64, true);
    MPMC_LAUNCH(64, false);
  }
  if (vec) MPMC_LAUNCH(128, true);
  MPMC_LAUNCH(128, false);
#undef MPMC_LAUNCH
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  mode: 0 none, 1 padding, 2 segments.
// q, out, dout, dq are contiguous [B, Sq, H, D]; k, v, dk, dv contiguous
// [B, Sk, H, D] (bf16: D % 8 == 0 and 16-byte aligned); lse, delta, row_m,
// row_l are f32 [B, H, Sq] (delta, row_m and row_l are scratch, used by the
// f32 path and the bf16 path at S > 128; row_m and row_l written only in
// segments mode); mask is f32 [B, Sk] (unused in mode 0); Sq, Sk <=
// mma::kMaxSeq.  Returns the CUDA error code of the first launch that
// fails (0 on success).
extern "C" int mpmc_attention_bwd(const void* q, const void* k, const void* v,
                                  const float* mask, const void* out,
                                  const float* lse, const void* dout,
                                  void* dq, void* dk, void* dv, float* delta,
                                  float* row_m, float* row_l, int dtype,
                                  int mode, int B, int H, int Sq, int Sk,
                                  int D, float scale, void* stream) {
  if (B < 1 || H < 1 || Sq < 1 || Sk < 1 || Sq > mma::kMaxSeq ||
      Sk > mma::kMaxSeq || D < 1 || D > 128 || mode < 0 || mode > 2 ||
      (mode != 0 && mask == nullptr) ||
      (mode == 2 && Sq != Sk) || dtype < 0 || dtype > 1 || B > 65535 ||
      H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 1 &&
      (D % 8 != 0 || !aligned16(q) || !aligned16(k) || !aligned16(v) ||
       !aligned16(out) || !aligned16(dout) || !aligned16(dq) ||
       !aligned16(dk) || !aligned16(dv))) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_f32(q, k, v, mask, out, lse, dout, dq, dk, dv, delta, row_m,
                     row_l, B, H, Sq, Sk, D, mode, scale, st);
  } else if (D <= 64) {
    err = launch_tc<64>(q, k, v, mask, out, lse, dout, dq, dk, dv, delta,
                        row_m, row_l, B, H, Sq, Sk, D, mode, scale, st);
  } else {
    err = launch_tc<128>(q, k, v, mask, out, lse, dout, dq, dk, dv, delta,
                         row_m, row_l, B, H, Sq, Sk, D, mode, scale, st);
  }
  return static_cast<int>(err);
}

extern "C" const char* mpmc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
