// Fused mask-aware heterogeneous gradient aggregation for Hopper (sm_90a):
//
//     out[i] = sum_t m[t,i] * (wn[t] * g[t,i]) / max(sum_t m[t,i] * wd[t], eps)
//
// Replaces the TPU kernel src/repro/kernels/grad_aggregate/kernel.py
// (grad_aggregate_raw, body _agg_kernel): the server's aggregation of a
// masked fleet, once per >=2-D parameter leaf per round.
//
// Bound: bytes. Each element is read once per tier (g and m, 4 + 4 bytes;
// a scalar mask is one stride-0 read) and written once (4 bytes), against
// 3 flops per tier, so the card's memory rate is the limit. The design
// does one pass with no padding traffic: one thread per output element,
// a bounds check for the ragged tail instead of padding N to a block
// multiple, the tier weights passed by value in the launch arguments.
//
// Numerics: the tiers are folded in cohort order as num + m*(wn*g) and
// den + m*wd with explicitly rounded intrinsics, so nvcc's FMA
// contraction cannot change a bit. Because m is exactly 0 or 1 this
// equals the reference kernel's wn*m*g product and is bitwise the port's
// accumulate_cohort -> finalize chain (src/repro_torch/core/aggregation.py).
#include <cuda_runtime.h>

#define MAX_TIERS 8

struct AggArgs {
  const float* g;          // (T, n) contiguous
  const float* m;          // element (t, i) at m[t * m_tstride + i * m_estride]
  long long m_tstride;
  long long m_estride;     // 1: full mask; 0: one scalar mask per tier
  float wn[MAX_TIERS];
  float wd[MAX_TIERS];
  int n_tiers;
  long long n;
  float eps;
};

__global__ void grad_aggregate_kernel(const AggArgs a, float* __restrict__ out) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  float num = 0.0f, den = 0.0f;
#pragma unroll
  for (int t = 0; t < MAX_TIERS; ++t) {
    if (t >= a.n_tiers) break;
    const float g = a.g[t * a.n + i];
    const float m = a.m[t * a.m_tstride + i * a.m_estride];
    num = __fadd_rn(num, __fmul_rn(m, __fmul_rn(a.wn[t], g)));
    den = __fadd_rn(den, __fmul_rn(m, a.wd[t]));
  }
  out[i] = __fdiv_rn(num, fmaxf(den, a.eps));
}

// Returns the launch's cudaError_t (0 on success).
extern "C" int grad_aggregate_launch(const void* g, const void* m,
                                     long long m_tstride, long long m_estride,
                                     const float* wn, const float* wd,
                                     int n_tiers, long long n, float eps,
                                     void* out, void* stream) {
  if (n_tiers < 1 || n_tiers > MAX_TIERS || n < 0) return (int)cudaErrorInvalidValue;
  AggArgs a;
  a.g = (const float*)g;
  a.m = (const float*)m;
  a.m_tstride = m_tstride;
  a.m_estride = m_estride;
  for (int t = 0; t < MAX_TIERS; ++t) {
    a.wn[t] = t < n_tiers ? wn[t] : 0.0f;
    a.wd[t] = t < n_tiers ? wd[t] : 0.0f;
  }
  a.n_tiers = n_tiers;
  a.n = n;
  a.eps = eps;
  if (n == 0) return 0;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  grad_aggregate_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      a, (float*)out);
  return (int)cudaGetLastError();
}
