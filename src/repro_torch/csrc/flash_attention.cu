// Flash attention forward for Hopper (sm_90a): online-softmax attention
// with causal, sliding-window and q_offset masks, key padding, and
// grouped-query attention (GQA).
//
//     o[b,t,h] = softmax_s(q[b,t,h] . k[b,s,h/n_rep] * scale | mask) . v[b,s,h/n_rep]
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_raw, body _flash_kernel): attn_forward's attention
// when cfg.use_flash is set, once per layer per tier in the tier-scanned
// train step. Forward only: the backward is the plain version's VJP, as
// in the reference (ops.py there, _bwd).
//
// Bound: operations. 4*T*S*hd flops per (batch, head) (about half of that
// under the causal mask) against reading q, k, v and writing o once, so
// at the train shapes the card's arithmetic rate is the limit, and the
// design keeps the (T, S) scores out of device memory: one block per
// (query tile of 64 rows, batch*head); K/V tiles of 64 rows are staged in
// shared memory as f32; each warp owns 8 query rows and keeps their
// running max, running sum and (8 x hd) accumulator in f32 registers.
// Key tiles wholly outside the causal / window band are skipped. The
// products run on the CUDA cores in f32 (no tensor cores yet: wgmma, TMA
// and pipelining are later work), so this kernel sits far above its bound.
//
// Semantics kept from the TPU kernel:
//   - masks: kpos < S, causal kpos <= qpos, window kpos > qpos - window,
//     with qpos = q_offset + t;
//   - masked scores are NEG = -1e30 with a zero guard on exp, so a fully
//     masked row returns exactly 0;
//   - GQA: query head h reads K/V head h / n_rep in place, never a
//     repeated copy;
//   - the (B, T, H, hd) layout is read directly (no head-major copy), and
//     the ragged edges of T and S are masked instead of padded to 128.
// Inputs are f32 or bf16 and are accumulated in f32; the output has the
// input's type (bf16 by round-to-nearest-even). hd <= 128.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;              // query rows per block
constexpr int BK = 64;              // keys per tile
constexpr int NWARPS = 8;
constexpr int THREADS = NWARPS * 32;
constexpr int ROWS = BQ / NWARPS;   // query rows per warp
constexpr int KPL = BK / 32;        // keys per lane in the score phase
constexpr int HD_MAX = 128;
constexpr int CPL = HD_MAX / 32;    // output columns per lane
constexpr float NEG = -1e30f;

struct FlashArgs {
  const void* q;   // (B, T, H, hd)
  const void* k;   // (B, S, Hkv, hd)
  const void* v;   // (B, S, Hkv, hd)
  void* o;         // (B, T, H, hd)
  int T, S, H, Hkv, hd, n_rep;
  int causal, window, q_offset;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const FlashArgs a) {
  extern __shared__ float smem[];
  const int hd = a.hd;
  float* Qs = smem;                    // [BQ][hd]
  float* Ks = Qs + BQ * hd;            // [BK][hd + 1]: conflict-free column reads
  float* Vs = Ks + BK * (hd + 1);      // [BK][hd]
  float* Ps = Vs + BK * hd;            // [BQ][BK]

  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / a.H;
  const int h = blockIdx.y % a.H;
  const int hk = h / a.n_rep;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const long long q_row = (long long)a.H * hd;      // stride between t
  const long long kv_row = (long long)a.Hkv * hd;   // stride between s
  const T* qb = (const T*)a.q + ((long long)b * a.T * a.H + h) * hd;
  const T* kb = (const T*)a.k + ((long long)b * a.S * a.Hkv + hk) * hd;
  const T* vb = (const T*)a.v + ((long long)b * a.S * a.Hkv + hk) * hd;
  T* ob = (T*)a.o + ((long long)b * a.T * a.H + h) * hd;

  for (int idx = tid; idx < BQ * hd; idx += THREADS) {
    const int r = idx / hd, c = idx % hd;
    const int t = q0 + r;
    Qs[idx] = t < a.T ? to_f32(qb[t * q_row + c]) : 0.0f;
  }

  // the band of keys any row of this tile can see
  const int qpos_lo = a.q_offset + q0;
  const int qpos_hi = a.q_offset + min(q0 + BQ, a.T) - 1;
  int k_end = a.S;
  if (a.causal) k_end = min(k_end, qpos_hi + 1);
  int k_begin = 0;
  if (a.window > 0) k_begin = max(0, qpos_lo - a.window + 1);

  float m_i[ROWS], l_i[ROWS], acc[ROWS][CPL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m_i[r] = NEG;
    l_i[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[r][c] = 0.0f;
  }

  for (int k0 = (k_begin / BK) * BK; k0 < k_end; k0 += BK) {
    __syncthreads();   // the previous tile is consumed (and Qs is written)
    for (int idx = tid; idx < BK * hd; idx += THREADS) {
      const int r = idx / hd, c = idx % hd;
      const int s = k0 + r;
      float kv = 0.0f, vv = 0.0f;
      if (s < a.S) {
        kv = to_f32(kb[s * kv_row + c]);
        vv = to_f32(vb[s * kv_row + c]);
      }
      Ks[r * (hd + 1) + c] = kv;
      Vs[r * hd + c] = vv;
    }
    __syncthreads();

    float sc[ROWS][KPL];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int j = 0; j < KPL; ++j) sc[r][j] = 0.0f;
    for (int d = 0; d < hd; ++d) {
      float kd[KPL];
#pragma unroll
      for (int j = 0; j < KPL; ++j) kd[j] = Ks[(lane + 32 * j) * (hd + 1) + d];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float qd = Qs[(warp * ROWS + r) * hd + d];
#pragma unroll
        for (int j = 0; j < KPL; ++j) sc[r][j] = fmaf(qd, kd[j], sc[r][j]);
      }
    }

#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int row = warp * ROWS + r;
      const int qpos = a.q_offset + q0 + row;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        const int kpos = k0 + lane + 32 * j;
        bool ok = kpos < a.S;
        if (a.causal) ok = ok && kpos <= qpos;
        if (a.window > 0) ok = ok && kpos > qpos - a.window;
        sc[r][j] = ok ? sc[r][j] * a.scale : NEG;
        mx = fmaxf(mx, sc[r][j]);
      }
      const float m_new = fmaxf(m_i[r], warp_max(mx));
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        // zero guard: a fully masked row keeps m == NEG, and exp(0) must
        // not count for it
        const float p = sc[r][j] > NEG / 2 ? expf(sc[r][j] - m_new) : 0.0f;
        Ps[row * BK + lane + 32 * j] = p;
        psum += p;
      }
      psum = warp_sum(psum);
      const float corr = m_i[r] > NEG / 2 ? expf(m_i[r] - m_new) : 0.0f;
      l_i[r] = l_i[r] * corr + psum;
#pragma unroll
      for (int c = 0; c < CPL; ++c) acc[r][c] *= corr;
      m_i[r] = m_new;
    }
    __syncwarp();      // this warp's rows of Ps are written

    for (int j = 0; j < BK; ++j) {
      float vj[CPL];
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int d = lane + 32 * c;
        vj[c] = d < hd ? Vs[j * hd + d] : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float p = Ps[(warp * ROWS + r) * BK + j];
#pragma unroll
        for (int c = 0; c < CPL; ++c) acc[r][c] = fmaf(p, vj[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int t = q0 + warp * ROWS + r;
    if (t >= a.T) continue;
    const float l = fmaxf(l_i[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int d = lane + 32 * c;
      if (d < hd) ob[t * q_row + d] = from_f32<T>(__fdiv_rn(acc[r][c], l));
    }
  }
}

template <typename T>
int launch(const FlashArgs& a, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      ((size_t)BQ * a.hd + (size_t)BK * (a.hd + 1) + (size_t)BK * a.hd +
       (size_t)BQ * BK);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.T + BQ - 1) / BQ, B * a.H);
  flash_attention_kernel<T><<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the launch's cudaError_t
// (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int dtype,
                                      int B, int T, int S, int H, int Hkv,
                                      int hd, int causal, int window,
                                      int q_offset, float scale,
                                      void* stream) {
  if (B < 0 || T < 0 || S < 0 || H < 1 || Hkv < 1 || H % Hkv != 0 ||
      hd < 1 || hd > HD_MAX || (long long)B * H > 65535 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return 0;
  FlashArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.T = T;
  a.S = S;
  a.H = H;
  a.Hkv = Hkv;
  a.hd = hd;
  a.n_rep = H / Hkv;
  a.causal = causal;
  a.window = window;
  a.q_offset = q_offset;
  a.scale = scale;
  return dtype == 0 ? launch<float>(a, B, (cudaStream_t)stream)
                    : launch<__nv_bfloat16>(a, B, (cudaStream_t)stream);
}
