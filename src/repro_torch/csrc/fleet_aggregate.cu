// Grouped heterogeneous aggregation of a whole FL round for Hopper
// (sm_90a): every parameter leaf of the round in ONE launch,
//
//     out[i,j] = sum_{t: i<r_t, j<c_t} m_t[i,j] * (wn_t * g_t[i,j])
//              / max(sum_{t: i<r_t, j<c_t} m_t[i,j] * wd_t, eps)
//
// over each leaf's row-major 2-D view (rows = prod(shape[:-1]), cols =
// shape[-1]); tier t's update covers the prefix block [0,r_t) x [0,c_t)
// of it (a width-sliced tier) or the whole leaf (a masked tier).
// Replaces the three TPU kernels of the aggregation:
// src/repro/kernels/grad_aggregate/kernel.py grad_aggregate_raw
// (_agg_kernel: every tier covers the whole leaf) and
// src/repro/kernels/structured_scatter/kernel.py structured_scatter_raw
// and structured_scatter_whole (_scatter_kernel, _scatter_kernel_whole).
//
// Bound: on the FL round, the launch. The paper MLP's round aggregates
// 12 leaves of 522 floats; one launch per leaf, with its host-side
// argument marshalling, cost ~50x the device time. So one launch takes
// every leaf: a by-value descriptor (FleetArgs, under the 4 KB kernel
// parameter limit) holds per leaf the output offset into one f32 slab
// and per tier the update and mask pointers, read where they lie. No
// stacking, no host->device copy: the launch can be captured in a CUDA
// graph. Blocks map to (leaf, tile) through a block-prefix table; a
// block finds its leaf by a scan over at most MAX_LEAVES entries.
// On a large leaf the bound is bytes: each covered element is read once
// per tier (g, and m unless the tier's mask is one scalar) and written
// once. A leaf whose cols are a multiple of 4 runs over quads of columns
// with 16-byte loads wherever a tier's base and c_t allow, element loads
// where they do not (the scalar tail at c_t); other leaves run one
// element per thread. A leaf larger than one wave of resident blocks
// takes one wave and a grid-stride loop. Uncovered elements are never
// read.
//
// Numerics: tiers fold in cohort order as num + m*(wn*g), den + m*wd
// with explicitly rounded intrinsics (no FMA contraction), then
// num / max(den, eps): bitwise the port's accumulate_cohort /
// scatter_accumulate -> finalize chain (src/repro_torch/core/
// aggregation.py), 1-D leaves included (a scalar-mask denominator has
// the same f32 value at every element).
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_TIERS 8
#define MAX_LEAVES 16
#define THREADS 256

struct FleetArgs {
  const float* g[MAX_LEAVES][MAX_TIERS];  // (r_t, c_t) contiguous
  const float* m[MAX_LEAVES][MAX_TIERS];  // as g, or one value (scalar bit)
  float* out;                             // the slab
  long long out_off[MAX_LEAVES];          // leaf's offset in floats (x4)
  int rows[MAX_LEAVES][MAX_TIERS];        // r_t
  int cols[MAX_LEAVES][MAX_TIERS];        // c_t
  int R[MAX_LEAVES];
  int C[MAX_LEAVES];
  int scalar_bits[MAX_LEAVES];            // bit t: tier t's mask is a scalar
  int block_start[MAX_LEAVES + 1];        // leaf k owns [start[k], start[k+1])
  float wn[MAX_TIERS];
  float wd[MAX_TIERS];
  float eps;
  int n_tiers;
  int n_leaves;
};
static_assert(sizeof(FleetArgs) <= 4096,
              "FleetArgs must fit the 4 KB kernel parameter limit");

__device__ __forceinline__ void fold(float& num, float& den, float m, float g,
                                     float wn, float wd) {
  num = __fadd_rn(num, __fmul_rn(m, __fmul_rn(wn, g)));
  den = __fadd_rn(den, __fmul_rn(m, wd));
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15u) == 0;
}

__global__ void __launch_bounds__(THREADS)
fleet_aggregate_kernel(const __grid_constant__ FleetArgs a) {
  int leaf = 0;
#pragma unroll 1
  for (int k = 1; k < a.n_leaves; ++k)
    if ((int)blockIdx.x >= a.block_start[k]) leaf = k;
  const int b0 = a.block_start[leaf];
  const unsigned stride = (unsigned)(a.block_start[leaf + 1] - b0) * THREADS;
  const unsigned first = (unsigned)((int)blockIdx.x - b0) * THREADS + threadIdx.x;
  const int R = a.R[leaf], C = a.C[leaf], T = a.n_tiers;
  const int sbits = a.scalar_bits[leaf];
  const float eps = a.eps;
  float* out = a.out + a.out_off[leaf];

  // per-tier constants of this leaf, hoisted out of the element loop
  float msc[MAX_TIERS];
  unsigned vec = 0;                     // bit t: tier t loads 16 bytes
#pragma unroll
  for (int t = 0; t < MAX_TIERS; ++t) {
    msc[t] = 0.0f;
    if (t >= T) continue;
    const bool sc = (sbits >> t) & 1;
    if (sc && a.rows[leaf][t] > 0 && a.cols[leaf][t] > 0) msc[t] = *a.m[leaf][t];
    if ((a.cols[leaf][t] & 3) == 0 && aligned16(a.g[leaf][t]) &&
        (sc || aligned16(a.m[leaf][t])))
      vec |= 1u << t;
  }

  if ((C & 3) == 0 && aligned16(out)) {
    const unsigned Q = (unsigned)C >> 2;
    const unsigned items = (unsigned)R * Q;
    for (unsigned it = first; it < items; it += stride) {
      const int i = (int)(it / Q);
      const int j = (int)(it - (unsigned)i * Q) << 2;
      float n[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int t = 0; t < MAX_TIERS; ++t) {
        if (t >= T) break;
        const int r = a.rows[leaf][t], c = a.cols[leaf][t];
        if (i >= r || j >= c) continue;
        const size_t row = (size_t)i * c + j;
        const float* g = a.g[leaf][t] + row;
        const bool sc = (sbits >> t) & 1;
        const float wn = a.wn[t], wd = a.wd[t];
        if ((vec >> t) & 1) {           // c % 4 == 0: the quad is covered
          const float4 gv = *reinterpret_cast<const float4*>(g);
          const float4 mv = sc ? make_float4(msc[t], msc[t], msc[t], msc[t])
                               : *reinterpret_cast<const float4*>(a.m[leaf][t] + row);
          fold(n[0], d[0], mv.x, gv.x, wn, wd);
          fold(n[1], d[1], mv.y, gv.y, wn, wd);
          fold(n[2], d[2], mv.z, gv.z, wn, wd);
          fold(n[3], d[3], mv.w, gv.w, wn, wd);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (j + e < c)
              fold(n[e], d[e], sc ? msc[t] : a.m[leaf][t][row + e], g[e], wn, wd);
        }
      }
      float4 o;
      o.x = __fdiv_rn(n[0], fmaxf(d[0], eps));
      o.y = __fdiv_rn(n[1], fmaxf(d[1], eps));
      o.z = __fdiv_rn(n[2], fmaxf(d[2], eps));
      o.w = __fdiv_rn(n[3], fmaxf(d[3], eps));
      reinterpret_cast<float4*>(out)[it] = o;
    }
    return;
  }

  const unsigned items = (unsigned)R * (unsigned)C;
  for (unsigned it = first; it < items; it += stride) {
    const int i = (int)(it / (unsigned)C);
    const int j = (int)(it - (unsigned)i * (unsigned)C);
    float num = 0.0f, den = 0.0f;
#pragma unroll
    for (int t = 0; t < MAX_TIERS; ++t) {
      if (t >= T) break;
      const int r = a.rows[leaf][t], c = a.cols[leaf][t];
      if (i >= r || j >= c) continue;
      const size_t e = (size_t)i * c + j;
      const float m = ((sbits >> t) & 1) ? msc[t] : a.m[leaf][t][e];
      fold(num, den, m, a.g[leaf][t][e], a.wn[t], a.wd[t]);
    }
    out[it] = __fdiv_rn(num, fmaxf(den, eps));
  }
}

// Launches the kernel over `grid` blocks (block_start[n_leaves]) on
// `stream`; returns the launch's cudaError_t (0 on success).
extern "C" int fleet_aggregate_launch(const FleetArgs* a, int grid,
                                      void* stream) {
  if (a->n_tiers < 1 || a->n_tiers > MAX_TIERS || a->n_leaves < 1 ||
      a->n_leaves > MAX_LEAVES || grid != a->block_start[a->n_leaves])
    return (int)cudaErrorInvalidValue;
  if (grid == 0) return 0;
  fleet_aggregate_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

// Blocks of the kernel resident on the whole card at once: a large leaf
// takes this many, one wave of a grid-stride loop, with no tail wave.
extern "C" int fleet_aggregate_resident_blocks() {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, fleet_aggregate_kernel, THREADS, 0) != cudaSuccess)
    return -1;
  return sms * per_sm;
}

// sizeof(FleetArgs), so the host can check its mirror of the layout.
extern "C" int fleet_aggregate_args_size() { return (int)sizeof(FleetArgs); }
