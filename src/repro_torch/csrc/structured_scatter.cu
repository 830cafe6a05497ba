// Fused prefix-block structured-scatter aggregation for Hopper (sm_90a):
// the coverage-counted accumulators of width-sliced (structured) fleets
// for L same-signature parameter leaves at once,
//
//     out[l,i,j] = sum_{t: i<r_t, j<c_t} m_t[l,i,j] * (wn_t * g_t[l,i,j])
//                / max(sum_{t: i<r_t, j<c_t} m_t[l,i,j] * wd_t, eps)
//
// over each leaf's row-major 2-D view (rows = prod(shape[:-1]), cols =
// shape[-1]); tier t's update covers the prefix block [0,r_t) x [0,c_t).
// Replaces both TPU kernels in src/repro/kernels/structured_scatter/
// kernel.py — structured_scatter_raw (gridded, body _scatter_kernel) and
// structured_scatter_whole (gridless and batched, body
// _scatter_kernel_whole) — which compute the same function; here L = 1
// for a single leaf.
//
// Bound: bytes. Tier t reads L*r_t*c_t*(4+4) bytes (4 for a scalar mask)
// and the output is written once, L*rows*cols*4 bytes, against 3 flops
// per covered tier. One pass, one thread per output element; a tier
// contributes only where i < r_t && j < c_t — the reference's
// .at[:r, :c].add — so no tier is padded to the global shape and no
// uncovered element is read.
//
// Numerics: tiers fold in cohort order as num + m*(wn*g), den + m*wd with
// explicitly rounded intrinsics (no FMA contraction), then
// num / max(den, eps): bitwise the sequential scatter_accumulate ->
// finalize chain.
#include <cuda_runtime.h>

#define MAX_TIERS 8

struct ScatterArgs {
  const float* g[MAX_TIERS];   // (L, r_t, c_t) contiguous
  const float* m[MAX_TIERS];   // (L, r_t, c_t), or (L,) when m_scalar[t]
  int rows[MAX_TIERS];
  int cols[MAX_TIERS];
  int m_scalar[MAX_TIERS];
  float wn[MAX_TIERS];
  float wd[MAX_TIERS];
  int n_tiers;
  long long L;
  int R, C;                    // output (L, R, C)
  float eps;
};

__global__ void structured_scatter_kernel(const ScatterArgs a,
                                          float* __restrict__ out) {
  const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (idx >= a.L * a.R * a.C) return;
  const int j = (int)(idx % a.C);
  const long long q = idx / a.C;
  const int i = (int)(q % a.R);
  const long long l = q / a.R;
  float num = 0.0f, den = 0.0f;
#pragma unroll
  for (int t = 0; t < MAX_TIERS; ++t) {
    if (t >= a.n_tiers) break;
    const int r = a.rows[t], c = a.cols[t];
    if (i < r && j < c) {
      const long long li = (l * r + i) * (long long)c + j;
      const float g = a.g[t][li];
      const float m = a.m_scalar[t] ? a.m[t][l] : a.m[t][li];
      num = __fadd_rn(num, __fmul_rn(m, __fmul_rn(a.wn[t], g)));
      den = __fadd_rn(den, __fmul_rn(m, a.wd[t]));
    }
  }
  out[idx] = __fdiv_rn(num, fmaxf(den, a.eps));
}

// Returns the launch's cudaError_t (0 on success).
extern "C" int structured_scatter_launch(
    const void* const* g, const void* const* m, const int* rows,
    const int* cols, const int* m_scalar, const float* wn, const float* wd,
    int n_tiers, long long L, int R, int C, float eps, void* out,
    void* stream) {
  if (n_tiers < 1 || n_tiers > MAX_TIERS || L < 0 || R < 0 || C < 0)
    return (int)cudaErrorInvalidValue;
  ScatterArgs a;
  for (int t = 0; t < MAX_TIERS; ++t) {
    const bool live = t < n_tiers;
    a.g[t] = live ? (const float*)g[t] : nullptr;
    a.m[t] = live ? (const float*)m[t] : nullptr;
    a.rows[t] = live ? rows[t] : 0;
    a.cols[t] = live ? cols[t] : 0;
    a.m_scalar[t] = live ? m_scalar[t] : 0;
    a.wn[t] = live ? wn[t] : 0.0f;
    a.wd[t] = live ? wd[t] : 0.0f;
    if (live && (a.rows[t] > R || a.cols[t] > C)) return (int)cudaErrorInvalidValue;
  }
  a.n_tiers = n_tiers;
  a.L = L;
  a.R = R;
  a.C = C;
  a.eps = eps;
  const long long total = L * R * (long long)C;
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  structured_scatter_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      a, (float*)out);
  return (int)cudaGetLastError();
}
