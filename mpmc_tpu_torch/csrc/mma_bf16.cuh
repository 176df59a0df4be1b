// Tensor-core building blocks shared by attention_fwd.cu and
// attention_bwd.cu (sm_90a): cp.async tile loads into XOR-swizzled shared
// memory, ldmatrix fragment loads, and the bf16 mma.sync.m16n8k16 product
// with f32 accumulation.
//
// Shared-memory tiles hold rows of W bf16 values (W = 64 or 128, so a row
// is 8 or 16 chunks of 16 bytes).  Chunk c of row r is stored at chunk
// c ^ (r & 7): the eight rows that one ldmatrix 8x8 matrix reads then sit
// in eight different 16-byte bank groups, so the loads are free of bank
// conflicts, and a cp.async of one 16-byte chunk stays contiguous.
//
// Fragment layouts of mma.m16n8k16 (PTX ISA), with g = lane / 4 and
// t = lane % 4:
//   A (16 x 16, row major): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                           a3 (g+8, 2t+8..)
//   B (16 x 8, k x n):      b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g)
//   C (16 x 8, f32):        c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..)
// so the C fragments of two adjacent n-tiles, rounded to bf16 pairs, are the
// A fragment of one 16-wide k-chunk (the softmax P feeds P.V in registers).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma {

using bf16 = __nv_bfloat16;

// Element offset of chunk c (8 values) of row r in a swizzled tile of
// width W.
template <int W>
__device__ __forceinline__ int swz(int r, int c) {
  return r * W + ((c ^ (r & 7)) << 3);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy; zero-fills the destination when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy rows [0, rows) of a [.., S, H, D] tensor (row stride `stride`
// elements, `src` at the tile's first row) into a swizzled tile of width W.
// Rows at or past n_valid and chunks at or past D / 8 are zero-filled.
template <int W>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* src,
                                          long long stride, int rows,
                                          int n_valid, int d_chunks, int tid,
                                          int nthreads) {
  constexpr int kChunks = W / 8;
  for (int i = tid; i < rows * kChunks; i += nthreads) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    const bool ok = r < n_valid && c < d_chunks;
    const bf16* from = ok ? src + r * stride + c * 8 : src;
    cp_async16(tile + swz<W>(r, c), from, ok);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a . b on the tensor cores, bf16 inputs, f32 accumulator.
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values rounded to nearest even bf16, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t x) {
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&x);
  return __bfloat1622float2(v);
}

// Each bf16 of a packed pair times s, rounded back to bf16.
__device__ __forceinline__ uint32_t scale_pair(uint32_t x, float s) {
  const float2 f = unpack_bf16(x);
  return pack_bf16(f.x * s, f.y * s);
}

// The A fragment of rows [r0, r0 + 16) and k-chunk kk (columns 16 kk ..)
// of a row-major swizzled tile.
template <int W>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int r0, int kk, int lane) {
  ldsm_x4(a, tile + swz<W>(r0 + (lane & 15), 2 * kk + (lane >> 4)));
}

// The A fragment of X^T for X a row-major swizzled tile: A rows are X's
// columns [m0, m0 + 16), A's k-chunk is X's rows [k0, k0 + 16).
template <int W>
__device__ __forceinline__ void load_a_t(uint32_t (&a)[4], const bf16* tile,
                                         int m0, int k0, int lane) {
  ldsm_x4_t(a, tile + swz<W>(k0 + (lane & 7) + ((lane >> 4) << 3),
                             (m0 >> 3) + ((lane >> 3) & 1)));
}

// B fragments of B = X^T for X a row-major swizzled tile ([n][k]): n-tiles
// X rows [n0, n0 + 8) and [n0 + 8, n0 + 16), k-chunk kk.  b[0], b[1] are
// the first n-tile's b0, b1, and b[2], b[3] the second's.
template <int W>
__device__ __forceinline__ void load_b_nt(uint32_t (&b)[4], const bf16* tile,
                                          int n0, int kk, int lane) {
  ldsm_x4(b, tile + swz<W>(n0 + (lane & 7) + ((lane >> 4) << 3),
                           2 * kk + ((lane >> 3) & 1)));
}

// B fragments of B = X for X a row-major swizzled tile ([k][n]): k rows
// [k0, k0 + 16), n-tiles of columns 16 c .. 16 c + 7 and 16 c + 8 .. + 15.
template <int W>
__device__ __forceinline__ void load_b_t(uint32_t (&b)[4], const bf16* tile,
                                         int k0, int c, int lane) {
  ldsm_x4_t(b, tile + swz<W>(k0 + (lane & 7) + (((lane >> 3) & 1) << 3),
                             2 * c + (lane >> 4)));
}

// Sum over the four lanes of a quad (one row of a C fragment).
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return x;
}

// Host side: dynamic shared memory above 48 KB needs the attribute, set
// once per device (done[] remembers it for one kernel).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, bool (&done)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

// ------------------------------------------------ attention's score tile --

constexpr float kNegInf = -1e9f;           // the reference's additive mask
// Longest Sq and Sk the entry points take (ops/attention.py MAX_SEQ): the
// card tests and chip_smoke.py cover the tile loops up to here, ragged
// tails (S = 17, 50, 197, 577) included.
constexpr int kMaxSeq = 1024;

// Per-key mask information of keys [k0, k0 + nk) into shared memory: the
// additive bias in padding mode (1), the segment id in segments mode (2).
__device__ __forceinline__ void store_key_info(float* key_info,
                                               const float* mask, int b,
                                               int Sk, int k0, int nk,
                                               int mode, int tid,
                                               int nthreads) {
  for (int j = tid; j < nk; j += nthreads) {
    const float mv = mode == 0 ? 0.f : mask[(long long)b * Sk + k0 + j];
    key_info[j] = mode == 1 ? (1.f - mv) * kNegInf : mv;
  }
}

// Bias of a key for a query: padding mode reads the key's own bias,
// segments mode compares the key's and the query's segment ids.
__device__ __forceinline__ float key_bias(int mode, float info, float q_seg) {
  if (mode == 1) return info;
  if (mode == 2) return (info == q_seg && info > 0.f) ? 0.f : kNegInf;
  return 0.f;
}

// Scores of one block of nk <= 8 NT keys (rows of the swizzled tile k_s)
// for a warp's 16 query rows, whose A fragments are qa: s = (q . k^T) *
// scale plus the bias of the mode, -inf past the nk keys.  q_seg holds the
// segment ids of the thread's rows g and g + 8.
template <int DP, int NT>
__device__ __forceinline__ void attn_scores(
    float (&s)[NT][4], const uint32_t (&qa)[DP / 16][4], const bf16* k_s,
    const float* key_info, const float (&q_seg)[2], int nk, int mode,
    float scale, int lane) {
  const int rows = (nk + 15) & ~15;
  const int t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
  }
#pragma unroll
  for (int np = 0; np < NT / 2; ++np) {
    if (np * 16 < rows) {
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        uint32_t b[4];
        load_b_nt<DP>(b, k_s, np * 16, kk, lane);
        mma16816(s[2 * np], qa[kk], b[0], b[1]);
        mma16816(s[2 * np + 1], qa[kk], b[2], b[3]);
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = nt * 8 + 2 * t + (e & 1);
      s[nt][e] = j < nk ? s[nt][e] * scale +
                              key_bias(mode, key_info[j], q_seg[e >> 1])
                        : -INFINITY;       // past the last key: no key at all
    }
  }
}

// Row max over the quad of C-fragment rows g (r = 0) and g + 8 (r = 1).
template <int NT>
__device__ __forceinline__ float row_max(const float (&s)[NT][4], int r) {
  float m = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    m = fmaxf(m, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
  }
  return quad_max(m);
}

}  // namespace mma
