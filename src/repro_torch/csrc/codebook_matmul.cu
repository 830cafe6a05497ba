// Clustered-weight matmul for Hopper (sm_90a):
//   out = x @ codebook[idx]
// x (M, K) f32 or bf16, idx (K, N) int8 or int32 codeword ids, codebook
// (n_codes <= 256,) f32; f32 accumulation, output in x's dtype.
//
// Replaces the TPU kernel src/repro/kernels/codebook_matmul/kernel.py
// (codebook_matmul_raw, body _cb_kernel): the public kernel API's
// clustered matmul.
//
// Bound: operations at the shapes the port uses (llama3.2-3b's MLP):
// 2*M*K*N f32 FMAs on the CUDA cores (67 TFLOP/s f32 on the H100 SXM, no
// tensor cores, so no TF32) against one read of x and of the 1- or
// 4-byte indices. Each block copies the codebook into shared memory once
// (at most 1 KB) and decodes every idx element of its tile by a
// shared-memory gather as the tile is staged, so the f32 weight matrix is
// never written to device memory. The TPU kernel decoded by an unrolled
// select chain over the codewords because its VMEM had no fast gather;
// here one indexed load replaces it. Main loop and tiling as
// masked_matmul (tile_gemm.cuh).
//
// Indices are meant to lie in [0, n_codes). One outside follows the JAX
// oracle's gather (codebook_matmul_ref): a negative index counts from the
// end, then the result is clamped into range. The TPU kernel gives 0.0
// there instead; tests/test_torch_matmul_kernels.py pins both.
#include "tile_gemm.cuh"

namespace {

using tile_gemm::BM;
using tile_gemm::BN;
using tile_gemm::THREADS;
using tile_gemm::from_f32;

constexpr int MAX_CODES = 256;

template <typename TI>
struct CodebookB {
  const TI* idx;
  long long si_k, si_n;
  const float* cb;            // the block's shared-memory copy
  int n_codes;
  __device__ __forceinline__ float operator()(int k, int n) const {
    int c = (int)idx[k * si_k + n * si_n];
    if (c < 0) c += n_codes;
    c = c < 0 ? 0 : (c >= n_codes ? n_codes - 1 : c);
    return cb[c];
  }
};

template <typename TX, typename TI>
__global__ void __launch_bounds__(THREADS)
codebook_matmul_kernel(const TX* __restrict__ x, long long sxm, long long sxk,
                       const TI* __restrict__ idx, long long si_k,
                       long long si_n, const float* __restrict__ codebook,
                       int n_codes, TX* __restrict__ out, int M, int N, int K,
                       int x_k_contig, int idx_n_contig) {
  __shared__ __align__(16) tile_gemm::Smem smem;
  __shared__ float cb[MAX_CODES];
  for (int i = threadIdx.x; i < n_codes; i += THREADS) cb[i] = codebook[i];
  __syncthreads();
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const CodebookB<TI> b{idx, si_k, si_n, cb, n_codes};
  float acc[tile_gemm::TM][tile_gemm::TN];
  tile_gemm::run(x, sxm, sxk, x_k_contig, b, idx_n_contig, M, N, K, m0, n0,
                 smem, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < tile_gemm::TM; ++i) {
    const int r = m0 + tile_gemm::tile_row(ty, i);
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < tile_gemm::TN; ++j) {
      const int c = n0 + tile_gemm::tile_col(tx, j);
      if (c < N) out[(long long)r * N + c] = from_f32<TX>(acc[i][j]);
    }
  }
}

template <typename TX, typename TI>
int launch(const void* x, long long sxm, long long sxk, const void* idx,
           long long si_k, long long si_n, const void* codebook, int n_codes,
           void* out, int M, int N, int K, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  codebook_matmul_kernel<TX, TI><<<grid, THREADS, 0, stream>>>(
      (const TX*)x, sxm, sxk, (const TI*)idx, si_k, si_n,
      (const float*)codebook, n_codes, (TX*)out, M, N, K, sxk == 1 ? 1 : 0,
      si_n == 1 ? 1 : 0);
  return (int)cudaGetLastError();
}

}  // namespace

// x_dtype: 0 f32, 1 bf16; idx_dtype: 0 int8, 1 int32. Strides are in
// elements; out is (M, N) row-major in x's dtype. Returns the launch's
// cudaError_t.
extern "C" int codebook_matmul_launch(int x_dtype, int idx_dtype,
                                      const void* x, long long sxm,
                                      long long sxk, const void* idx,
                                      long long si_k, long long si_n,
                                      const void* codebook, int n_codes,
                                      void* out, int M, int N, int K,
                                      void* stream) {
  if (M < 0 || N < 0 || K < 0 || n_codes < 1 || n_codes > MAX_CODES ||
      (x_dtype != 0 && x_dtype != 1) || (idx_dtype != 0 && idx_dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  if ((M + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (x_dtype == 0) {
    if (idx_dtype == 0)
      return launch<float, int8_t>(x, sxm, sxk, idx, si_k, si_n, codebook,
                                   n_codes, out, M, N, K, s);
    return launch<float, int32_t>(x, sxm, sxk, idx, si_k, si_n, codebook,
                                  n_codes, out, M, N, K, s);
  }
  if (idx_dtype == 0)
    return launch<__nv_bfloat16, int8_t>(x, sxm, sxk, idx, si_k, si_n, codebook,
                                         n_codes, out, M, N, K, s);
  return launch<__nv_bfloat16, int32_t>(x, sxm, sxk, idx, si_k, si_n, codebook,
                                        n_codes, out, M, N, K, s);
}
