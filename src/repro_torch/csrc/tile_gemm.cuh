// The f32 CUDA-core main loop of the port's matmul kernels
// (masked_matmul.cu's f32 and unaligned-bf16 route, codebook_matmul.cu):
// one block computes a 128 x 128 tile of out = A @ B, with A (M, K) read
// through its strides and B produced by a loader functor (w * mask, or
// codebook[idx]) as it is staged into shared memory. f32 FMA, no tensor
// cores (so no TF32), f32 accumulation.
//
// - 256 threads, at most 128 registers each (two blocks per SM); each
//   keeps an 8 x 8 register micro-tile of accumulators.
// - K is walked in steps of 16 through two shared-memory buffers: the next
//   step's global loads go to registers while the current step computes,
//   so one __syncthreads per step.
// - The operands' orientations are template parameters (A_KC: A's unit
//   stride is along K; B_NC: B's is along N), so the backward reads
//   transposed views in place. Each thread stages 4 consecutive elements
//   along the unit stride: one 16-byte (f32) or 8-byte (bf16) load where
//   the tile lies inside the matrix and the address is aligned, 4 checked
//   scalar loads elsewhere (ragged M, N and K read 0 outside).
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tile_gemm {

constexpr int BM = 128, BN = 128, BK = 16, THREADS = 256;
constexpr int TM = 8, TN = 8;           // micro-tile per thread
constexpr int PAD = 4;                  // keeps rows 16-byte aligned

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}

// Four consecutive elements from an address aligned to 4 of them.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// Whether a pointer of element size `size`, with `ld` between its rows
// along the unit stride, can be read 4 elements at a time.
__host__ __forceinline__ bool vec4_ok(const void* p, long long ld,
                                      int size) {
  return ld % 4 == 0 && reinterpret_cast<uintptr_t>(p) % (4 * size) == 0;
}

struct Smem {
  float a[2][BK][BM + PAD];   // A staged k-major: a[k][m]
  float b[2][BK][BN + PAD];   // B staged k-major: b[k][n]
};

// Global row of micro-tile row i and column of micro-tile column j (two
// 4-wide halves, 64 apart, so each half is one float4 read from smem).
__device__ __forceinline__ int tile_row(int ty, int i) {
  return (i < 4) ? ty * 4 + i : 64 + ty * 4 + (i - 4);
}
__device__ __forceinline__ int tile_col(int tx, int j) {
  return (j < 4) ? tx * 4 + j : 64 + tx * 4 + (j - 4);
}

// acc[i][j] = sum_k A[m0 + tile_row(i), k] * B(k, n0 + tile_col(j)).
// A: element (m, k) at a[m * lda + k] (A_KC) or a[k * lda + m]; a_vec: a
// and lda allow 4-wide loads. LoadB (B_NC fixed by the caller):
//   float operator()(int k, int n) const      -- one element, in range;
//   template <bool NC> float4 load4(k, n) const -- 4 elements along N (NC)
//                                                 or K, all in range;
//   bool vec                                  -- load4 is allowed.
template <bool A_KC, bool B_NC, typename TA, typename LoadB>
__device__ __forceinline__ void run(const TA* __restrict__ a, long long lda,
                                    bool a_vec, const LoadB& load_b, int M,
                                    int N, int K, int m0, int n0, Smem& s,
                                    float (&acc)[TM][TN]) {
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  float4 ra[2], rb[2];
  const bool a_rows_in = m0 + BM <= M, b_cols_in = n0 + BN <= N;

  // slot i of this thread: 4 consecutive elements along the unit stride
  auto a_slot = [&](int i, int& mm, int& kk) {
    const int e = tid + i * THREADS;
    mm = A_KC ? e >> 2 : (e & 31) * 4;
    kk = A_KC ? (e & 3) * 4 : e >> 5;
  };
  auto b_slot = [&](int i, int& kk, int& nn) {
    const int e = tid + i * THREADS;
    kk = B_NC ? e >> 5 : (e & 3) * 4;
    nn = B_NC ? (e & 31) * 4 : e >> 2;
  };
  auto load = [&](int k0) {
    const bool k_in = k0 + BK <= K;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      int mm, kk;
      a_slot(i, mm, kk);
      const int gm = m0 + mm, gk = k0 + kk;
      if (a_vec && a_rows_in && k_in) {
        ra[i] = load4(A_KC ? a + (long long)gm * lda + gk
                           : a + (long long)gk * lda + gm);
      } else {
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int m = A_KC ? gm : gm + j, k = A_KC ? gk + j : gk;
          v[j] = (m < M && k < K)
                     ? to_f32(A_KC ? a[(long long)m * lda + k]
                                   : a[(long long)k * lda + m])
                     : 0.0f;
        }
        ra[i] = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      int kk, nn;
      b_slot(i, kk, nn);
      const int gk = k0 + kk, gn = n0 + nn;
      if (load_b.vec && b_cols_in && k_in) {
        rb[i] = load_b.template load4<B_NC>(gk, gn);
      } else {
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = B_NC ? gk : gk + j, n = B_NC ? gn + j : gn;
          v[j] = (k < K && n < N) ? load_b(k, n) : 0.0f;
        }
        rb[i] = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      int mm, kk;
      a_slot(i, mm, kk);
      if (A_KC) {
        s.a[buf][kk + 0][mm] = ra[i].x;
        s.a[buf][kk + 1][mm] = ra[i].y;
        s.a[buf][kk + 2][mm] = ra[i].z;
        s.a[buf][kk + 3][mm] = ra[i].w;
      } else {
        *reinterpret_cast<float4*>(&s.a[buf][kk][mm]) = ra[i];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      int kk, nn;
      b_slot(i, kk, nn);
      if (B_NC) {
        *reinterpret_cast<float4*>(&s.b[buf][kk][nn]) = rb[i];
      } else {
        s.b[buf][kk + 0][nn] = rb[i].x;
        s.b[buf][kk + 1][nn] = rb[i].y;
        s.b[buf][kk + 2][nn] = rb[i].z;
        s.b[buf][kk + 3][nn] = rb[i].w;
      }
    }
  };

#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  const int nk = (K + BK - 1) / BK;
  load(0);
  store(0);
  __syncthreads();
  for (int t = 0; t < nk; ++t) {
    const int cur = t & 1;
    if (t + 1 < nk) load((t + 1) * BK);       // in flight during the FMAs
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&s.a[cur][kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&s.a[cur][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&s.b[cur][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&s.b[cur][kk][64 + tx * 4]);
      const float fa[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float fb[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(fa[i], fb[j], acc[i][j]);
    }
    // the other buffer was last read in step t - 1, before the barrier
    // that ended it, so it can be overwritten now
    if (t + 1 < nk) store(cur ^ 1);
    __syncthreads();
  }
}

}  // namespace tile_gemm
