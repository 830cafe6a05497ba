// Pruned-weight matmul for Hopper (sm_90a):
//   out = (a @ (b * b_mask)) * out_mask
// with f32 accumulation and the output in the operands' dtype (f32 or
// bf16). b_mask and out_mask are optional (null). The forward is
// y = x @ (w * mask); the backward reuses the same kernel on strided
// (transposed) views, dx = g @ (w * mask)^T and dw = (x^T @ g) * mask.
//
// Replaces the TPU kernel src/repro/kernels/masked_matmul/kernel.py
// (masked_matmul_raw, body _mm_kernel) and its custom-VJP wrapper
// (ops.py:masked_matmul): the public kernel API's pruned matmul.
//
// Bound: operations at the shapes the port uses (llama3.2-3b's MLP,
// K = 3072 or 8192): 2*M*K*N f32 FMAs against one read of x, w and mask.
// This first kernel runs them on the CUDA cores (67 TFLOP/s f32 on the
// H100 SXM), not the tensor cores, so TF32 never enters. The design
// keeps the FMA units fed: 128 x 128 output tiles, an 8 x 8 register
// micro-tile per thread (64 FMAs per 16 shared-memory words read),
// double-buffered shared-memory tiles with the next tile's loads in
// flight during the FMAs (tile_gemm.cuh). The mask multiplies each w
// element as the tile is staged, so w * mask is never written to device
// memory. wgmma and TMA are later work.
#include "tile_gemm.cuh"

namespace {

using tile_gemm::BM;
using tile_gemm::BN;
using tile_gemm::THREADS;
using tile_gemm::from_f32;
using tile_gemm::to_f32;

template <typename T>
struct MaskedB {
  const T* w;
  long long swk, swn;
  const T* m;                 // null: no mask
  long long smk, smn;
  __device__ __forceinline__ float operator()(int k, int n) const {
    float v = to_f32(w[k * swk + n * swn]);
    if (m != nullptr) v *= to_f32(m[k * smk + n * smn]);
    return v;
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
masked_matmul_kernel(const T* __restrict__ a, long long sam, long long sak,
                     MaskedB<T> b, const T* __restrict__ om, long long som,
                     long long son, T* __restrict__ out, int M, int N, int K,
                     int a_k_contig, int b_n_contig) {
  __shared__ __align__(16) tile_gemm::Smem smem;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[tile_gemm::TM][tile_gemm::TN];
  tile_gemm::run(a, sam, sak, a_k_contig, b, b_n_contig, M, N, K, m0, n0,
                 smem, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < tile_gemm::TM; ++i) {
    const int r = m0 + tile_gemm::tile_row(ty, i);
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < tile_gemm::TN; ++j) {
      const int c = n0 + tile_gemm::tile_col(tx, j);
      if (c >= N) continue;
      // the reference rounds x^T @ g to the dtype, then masks: for a 0/1
      // mask that is the rounding of acc * mask
      const float v =
          om != nullptr ? acc[i][j] * to_f32(om[r * som + c * son]) : acc[i][j];
      out[(long long)r * N + c] = from_f32<T>(v);
    }
  }
}

template <typename T>
int launch(const void* a, long long sam, long long sak, const void* w,
           long long swk, long long swn, const void* m, long long smk,
           long long smn, const void* om, long long som, long long son,
           void* out, int M, int N, int K, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  MaskedB<T> b{(const T*)w, swk, swn, (const T*)m, smk, smn};
  masked_matmul_kernel<T><<<grid, THREADS, 0, stream>>>(
      (const T*)a, sam, sak, b, (const T*)om, som, son, (T*)out, M, N, K,
      sak == 1 ? 1 : 0, swn == 1 ? 1 : 0);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 f32, 1 bf16 (a, w, masks and out share it). Strides are in
// elements; out is (M, N) row-major. Returns the launch's cudaError_t.
extern "C" int masked_matmul_launch(int dtype, const void* a, long long sam,
                                    long long sak, const void* w,
                                    long long swk, long long swn,
                                    const void* m, long long smk,
                                    long long smn, const void* om,
                                    long long som, long long son, void* out,
                                    int M, int N, int K, void* stream) {
  if (M < 0 || N < 0 || K < 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  if ((M + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(a, sam, sak, w, swk, swn, m, smk, smn, om, som, son,
                         out, M, N, K, s);
  return launch<__nv_bfloat16>(a, sam, sak, w, swk, swn, m, smk, smn, om, som,
                               son, out, M, N, K, s);
}
