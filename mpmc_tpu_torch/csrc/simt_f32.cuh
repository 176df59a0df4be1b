// IEEE-f32 building blocks on the CUDA cores shared by attention_fwd.cu and
// attention_bwd.cu (sm_90a): tile copies with cp.async, and the two
// register-tiled products every f32 attention kernel is made of.
//
// Every tile holds 64 rows (queries or keys; the forward's query tile 128)
// of DP floats (DP = 64 or 128, zero-filled past D), one row every DP + 4
// floats.  The 4-float pad puts
// row r + 1 16 bytes after row r modulo 128, so the eight rows that a
// quarter-warp reads with one 128-bit load each sit in eight different
// 16-byte bank groups: no bank conflicts.  The 64 x 64 score tiles (P, dS)
// are rows of 64 + 4 floats.
//
// A block is 256 threads, 16 x 16: thread (ty, tx) = (tid / 16, tid % 16)
// owns the R x 4 micro-tile of rows R ty .. R ty + R - 1 and columns tx,
// tx + 16, tx + 32, tx + 48 of a 16 R x 64 product (R = 4 in the backward,
// 8 in the forward).  The 16 threads of a row share one half-warp, so a
// row max or sum is 4 shuffles; warp w owns rows 2 R w .. 2 R w + 2 R - 1,
// so a warp whose rows lie past the tile's last valid row skips its work
// as a whole.
//
//   dot_tile: acc[i][j] = sum_d A[R ty + i][d] . B[tx + 16 j][d]     (s, dP)
//   pv_tile:  acc[i][c] += sum_j P[R ty + i][j] . V[j][dim c]         (P.V)
//
// In dot_tile each step over 4 dims loads R A rows (one address per
// half-warp: a broadcast) and 4 B rows with 128-bit loads for 16 R FFMAs;
// in pv_tile each step over 4 keys loads R P rows (broadcast) and
// 4 x DP / 64 V rows for 4 R x DP / 16 FFMAs.  The thread's dims c in
// pv_tile are 64 g + 4 tx + e (g < DP / 64, e < 4), so a quarter-warp's V
// loads are 128 contiguous bytes.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace simt {

constexpr int kTile = 64;                  // rows of every tile
constexpr int kThreads = 256;              // 16 x 16 threads
constexpr int kLdP = kTile + 4;            // row stride of a score tile

template <int DP>
__host__ __device__ constexpr int tile_floats() {
  return kTile * (DP + 4);
}

__host__ __device__ constexpr int score_floats() { return kTile * kLdP; }

// The first of this thread's R rows, and of its warp's 2 R rows.
template <int R>
__device__ __forceinline__ int first_row(int tid) {
  return (tid >> 4) * R;
}

template <int R>
__device__ __forceinline__ int warp_first_row(int tid) {
  return (tid >> 5) * 2 * R;
}

// 4-byte asynchronous copy; zero-fills the destination when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   mma::smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

// Copy rows [0, ROWS) of a [.., S, H, D] f32 tensor (`src` at the tile's
// first row, `stride` elements between rows) into a padded tile.  Rows at
// or past n_valid and dims at or past D are zero-filled.  VEC: 16-byte
// copies (D % 4 == 0 and 16-byte aligned rows); else 4-byte copies.
template <int DP, bool VEC, int ROWS = kTile>
__device__ __forceinline__ void load_tile(float* tile, const float* src,
                                          long long stride, int n_valid,
                                          int D, int tid) {
  constexpr int LD = DP + 4;
  if (VEC) {
    constexpr int kChunks = DP / 4;
    for (int i = tid; i < ROWS * kChunks; i += kThreads) {
      const int r = i / kChunks;
      const int c = (i % kChunks) * 4;
      const bool ok = r < n_valid && c < D;
      mma::cp_async16(tile + r * LD + c, ok ? src + r * stride + c : src, ok);
    }
  } else {
    for (int i = tid; i < ROWS * DP; i += kThreads) {
      const int r = i / DP;
      const int d = i % DP;
      const bool ok = r < n_valid && d < D;
      cp_async4(tile + r * LD + d, ok ? src + r * stride + d : src, ok);
    }
  }
}

// Multiply by s the elements of a tile that this thread copied with
// load_tile (the same index walk), once its copies have landed
// (cp_async_wait) and before the barrier that shows them to the block.
template <int DP, bool VEC>
__device__ __forceinline__ void scale_own(float* tile, float s, int tid) {
  constexpr int LD = DP + 4;
  if (VEC) {
    constexpr int kChunks = DP / 4;
    for (int i = tid; i < kTile * kChunks; i += kThreads) {
      float4* p = reinterpret_cast<float4*>(tile + (i / kChunks) * LD +
                                            (i % kChunks) * 4);
      float4 x = *p;
      x.x *= s;
      x.y *= s;
      x.z *= s;
      x.w *= s;
      *p = x;
    }
  } else {
    for (int i = tid; i < kTile * DP; i += kThreads) {
      tile[(i / DP) * LD + i % DP] *= s;
    }
  }
}

__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  }
  return x;
}

__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int DP, int R, int NJ>
__device__ __forceinline__ void dot_tile_n(float (&acc)[R][4], const float* a,
                                           int r0, const float* bm, int tx) {
  constexpr int LD = DP + 4;
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
#pragma unroll 2
  for (int c = 0; c < DP; c += 4) {
    float4 x[R], y[NJ];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      x[i] = *reinterpret_cast<const float4*>(a + (r0 + i) * LD + c);
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      y[j] = *reinterpret_cast<const float4*>(bm + (tx + 16 * j) * LD + c);
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        acc[i][j] = fmaf(x[i].x, y[j].x, acc[i][j]);
        acc[i][j] = fmaf(x[i].y, y[j].y, acc[i][j]);
        acc[i][j] = fmaf(x[i].z, y[j].z, acc[i][j]);
        acc[i][j] = fmaf(x[i].w, y[j].w, acc[i][j]);
      }
    }
  }
}

// acc[i][j] = A[r0 + i] . B[tx + 16 j] over DP dims, for the column groups
// j < nj (1 to 4, uniform over the block); the others are left at 0.  A
// group at or past nj lies wholly past the tile's valid rows of B.
template <int DP, int R>
__device__ __forceinline__ void dot_tile(float (&acc)[R][4], const float* a,
                                         int r0, const float* bm, int tx,
                                         int nj) {
  switch (nj) {
    case 4: dot_tile_n<DP, R, 4>(acc, a, r0, bm, tx); break;
    case 3: dot_tile_n<DP, R, 3>(acc, a, r0, bm, tx); break;
    case 2: dot_tile_n<DP, R, 2>(acc, a, r0, bm, tx); break;
    default: dot_tile_n<DP, R, 1>(acc, a, r0, bm, tx); break;
  }
}

__device__ __forceinline__ float lane_of(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

template <int DP, int R>
__device__ __forceinline__ void pv_step(float (&acc)[R][DP / 16],
                                        const float* p, int r0,
                                        const float* v, int tx, int j0) {
  constexpr int LD = DP + 4;
  constexpr int G = DP / 64;
  float4 pr[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    pr[i] = *reinterpret_cast<const float4*>(p + (r0 + i) * kLdP + j0);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float4 vv[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      vv[g] = *reinterpret_cast<const float4*>(v + (j0 + e) * LD + g * 64 +
                                               tx * 4);
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float w = lane_of(pr[i], e);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        acc[i][4 * g] = fmaf(w, vv[g].x, acc[i][4 * g]);
        acc[i][4 * g + 1] = fmaf(w, vv[g].y, acc[i][4 * g + 1]);
        acc[i][4 * g + 2] = fmaf(w, vv[g].z, acc[i][4 * g + 2]);
        acc[i][4 * g + 3] = fmaf(w, vv[g].w, acc[i][4 * g + 3]);
      }
    }
  }
}

// acc[i][c] += sum_{j < n} P[r0 + i][j] . V[j][dim c] for the n valid rows
// of V (rounded up to 4: P is 0 and V zero-filled past n).
template <int DP, int R>
__device__ __forceinline__ void pv_tile(float (&acc)[R][DP / 16],
                                        const float* p, int r0,
                                        const float* v, int tx, int n) {
  if (n == kTile) {
#pragma unroll 2
    for (int j0 = 0; j0 < kTile; j0 += 4) pv_step<DP, R>(acc, p, r0, v, tx, j0);
  } else {
#pragma unroll 1
    for (int j0 = 0; j0 < n; j0 += 4) pv_step<DP, R>(acc, p, r0, v, tx, j0);
  }
}

template <int DP, int R>
__device__ __forceinline__ void zero(float (&acc)[R][DP / 16]) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int c = 0; c < DP / 16; ++c) acc[i][c] = 0.f;
  }
}

// Rows r0 .. r0 + 3 of a pv_tile accumulator, times mul, to `dst` (the
// tile's first row, `stride` elements between rows); rows at or past
// n_rows and dims at or past D are not written.
template <int DP, int R>
__device__ __forceinline__ void store_rows(float* dst, long long stride,
                                           const float (&acc)[R][DP / 16],
                                           int r0, int n_rows, int D,
                                           float mul, int tx) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (r0 + i >= n_rows) continue;
    float* row = dst + (r0 + i) * stride;
#pragma unroll
    for (int c = 0; c < DP / 16; ++c) {
      const int d = (c / 4) * 64 + tx * 4 + c % 4;
      if (d < D) row[d] = acc[i][c] * mul;
    }
  }
}

// A [.., S, H, D] f32 tensor's rows can take 16-byte copies.
__host__ __forceinline__ bool vec_ok(const void* p, int D, long long sb,
                                     long long ss, long long sh) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && D % 4 == 0 &&
         sb % 4 == 0 && ss % 4 == 0 && sh % 4 == 0;
}

}  // namespace simt
