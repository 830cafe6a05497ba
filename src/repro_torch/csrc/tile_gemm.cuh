// The shared main loop of the port's two matmul kernels (masked_matmul.cu,
// codebook_matmul.cu): one block computes a 128 x 128 tile of
// out = A @ B, with A (M, K) read through element strides and B produced
// element by element by a loader functor (w * mask, or codebook[idx]) as
// it is staged into shared memory. f32 FMA on the CUDA cores, no tensor
// cores (so no TF32), f32 accumulation.
//
// - 256 threads; each keeps an 8 x 8 register micro-tile of accumulators.
// - K is walked in steps of 16 through two shared-memory buffers: the next
//   step's global loads go to registers while the current step computes,
//   so one __syncthreads per step.
// - Operands are read through strides: the thread that loads an element is
//   chosen so that neighbouring threads read along the operand's unit
//   stride (row- or column-major), which is how the backward reads
//   transposed views without a copy.
// - Ragged M, N and K are masked at the loads (0 outside) and the stores.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tile_gemm {

constexpr int BM = 128, BN = 128, BK = 16, THREADS = 256;
constexpr int TM = 8, TN = 8;           // micro-tile per thread
constexpr int A_PER = BM * BK / THREADS;  // A elements each thread stages
constexpr int B_PER = BK * BN / THREADS;  // B elements each thread stages
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

// acc[i][j] += sum_k A[m0 + tile_row(i), k] * B(k, n0 + tile_col(j)).
// a_k_contig: A's unit stride is along K (row-major) rather than M.
// b_n_contig: B's unit stride is along N (row-major) rather than K.
// LoadB: float operator()(int k, int n) const, called in range only.
template <typename TA, typename LoadB>
__device__ __forceinline__ void run(const TA* __restrict__ a, long long sam,
                                    long long sak, int a_k_contig,
                                    const LoadB& load_b, int b_n_contig,
                                    int M, int N, int K, int m0, int n0,
                                    Smem& s, float (&acc)[TM][TN]) {
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  float ra[A_PER], rb[B_PER];

  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int e = tid + i * THREADS;
      const int mm = a_k_contig ? e / BK : e % BM;
      const int kk = a_k_contig ? e % BK : e / BM;
      const int gm = m0 + mm, gk = k0 + kk;
      ra[i] = (gm < M && gk < K) ? to_f32(a[gm * sam + gk * sak]) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int e = tid + i * THREADS;
      const int kk = b_n_contig ? e / BN : e % BK;
      const int nn = b_n_contig ? e % BN : e / BK;
      const int gk = k0 + kk, gn = n0 + nn;
      rb[i] = (gk < K && gn < N) ? load_b(gk, gn) : 0.0f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int e = tid + i * THREADS;
      const int mm = a_k_contig ? e / BK : e % BM;
      const int kk = a_k_contig ? e % BK : e / BM;
      s.a[buf][kk][mm] = ra[i];
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int e = tid + i * THREADS;
      const int kk = b_n_contig ? e / BN : e % BK;
      const int nn = b_n_contig ? e % BN : e / BK;
      s.b[buf][kk][nn] = rb[i];
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
