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
// under the causal mask) against reading q, k, v and writing o once. At
// the train shape (B 2, T = S 1024, 24 / 8 heads, hd 128, causal) that is
// 12.9 GFLOP of useful work: 0.013 ms at 989 TFLOP/s (bf16 tensor cores),
// 0.19 ms at 67 TFLOP/s (f32 CUDA cores). The (T, S) scores never reach
// device memory. Two routes, chosen by the wrapper (ops.py:route):
//
// - wgmma (bf16, hd 64 or 128, inputs TMA can describe): one block of
//   three warpgroups per (128-query tile, batch*head), the heaviest
//   causal tiles first. A producer warpgroup (one thread) loads the Q
//   tile once and keeps a ring of 4 K/V stages of 64 keys in flight by
//   TMA, through 4-D tensor maps over the (B, T, H, hd) and (B, S, Hkv,
//   hd) layouts: GQA is a coordinate (head h reads K/V head h / n_rep),
//   and the ragged T and S edges read as 0 within their batch. Two
//   consumer warpgroups own 64 query rows each: S = Q K^T by wgmma
//   m64n64k16 from shared memory; scale, masks (only on tiles that cross
//   the causal diagonal, the window edge or S) and the online softmax on
//   the f32 accumulator fragment in registers (row max and sum over the
//   four lanes of a row); then O += P V by wgmma m64n{hd}k16 with P as
//   the A operand straight from registers (the accumulator's layout is
//   the A fragment's, thread for thread) and V MN-major from shared
//   memory. setmaxnreg moves registers from the producer to the
//   consumers.
//   P is carried as two bf16 fragments, hi = bf16(p) and lo = bf16(p -
//   hi) (p to about 2^-17), and O += P V is two wgmma into the same f32
//   accumulator. The reference computes p @ v in f32; P rounded once to
//   bf16 puts ~14% of the train shape's outputs more than one bf16
//   quantum (+ 2e-5) from it, hi + lo none (tests/test_torch_flash_
//   route.py emulates both). So the tensor cores issue 1.5x the useful
//   work: one Q K^T and two P V products per tile.
//   What sets the pace is the consumers' instruction issue (expf, the
//   masks, the rescale and the hi / lo split, between products), not the
//   tensor cores: kernels/flash_attention/ablation.py times the kernel
//   against copies with __expf and with one P V product. Issuing tile
//   i's Q K^T before tile i-1's P V, so that the softmax runs under the
//   P V (FA3's intra-warpgroup overlap), measured slower, so the loop
//   runs each tile's products and softmax in turn and leaves the overlap
//   to the two consumer warpgroups.
// - simt (f32, other head widths, anything TMA refuses): one block per
//   (query tile of 64 rows, batch*head); K/V tiles of 64 rows are staged
//   in shared memory as f32; each warp owns 8 query rows and keeps their
//   running max, running sum and (8 x hd) accumulator in f32 registers.
//   The products run on the CUDA cores in f32, so this route sits far
//   above its bound.
// Key tiles wholly outside the causal / window band are skipped by both.
//
// Semantics kept from the TPU kernel (both routes):
//   - masks: kpos < S, causal kpos <= qpos, window kpos > qpos - window,
//     with qpos = q_offset + t;
//   - masked scores are NEG = -1e30 with a zero guard on exp, so a fully
//     masked row returns exactly 0;
//   - GQA: query head h reads K/V head h / n_rep in place, never a
//     repeated copy;
//   - the (B, T, H, hd) layout is read directly (no head-major copy), and
//     the ragged edges of T and S are masked instead of padded to 128.
// Scores and sums are f32; the output has the input's type (bf16 by
// round-to-nearest-even of acc / l). simt: f32 or bf16, hd <= 128.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "wgmma_gemm.cuh"

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

// ----------------------------------------------------------- wgmma route

using bf16 = __nv_bfloat16;

constexpr int WG_BQ = 128;             // query rows per block
constexpr int WG_BK = 64;              // keys per stage
constexpr int WG_STAGES = 4;
constexpr int WG_THREADS = 384;        // producer + two consumer warpgroups
constexpr int CONSUMER_THREADS = 256;
constexpr int BOX_BYTES_K = WG_BK * 64 * 2;   // one 64-key x 64-hd box
constexpr int BOX_BYTES_Q = WG_BQ * 64 * 2;   // one 128-row x 64-hd box
// setmaxnreg: the block starts with 168 registers a thread (65536 / 384,
// rounded down to 8); the producer keeps 40, the consumers take 232.
constexpr int ENTRY_REGS = 168, PRODUCER_REGS = 40, CONSUMER_REGS = 232;
static_assert(4 * 32 * PRODUCER_REGS + CONSUMER_THREADS * CONSUMER_REGS <=
                  WG_THREADS * ENTRY_REGS,
              "register pool");
// Error code beyond cudaError_t: 300000 + the registers a thread the
// compiler gave the kernel, when fewer than ENTRY_REGS (the consumers'
// setmaxnreg.inc would then wait forever).
constexpr int FEW_REGISTERS = 300000;

template <int HD>
struct WgCfg {
  static constexpr int BOXES = HD / 64;
  static constexpr int Q_BYTES = BOXES * BOX_BYTES_Q;
  static constexpr int KV_BYTES = BOXES * BOX_BYTES_K;   // K or V, one stage
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  // 1024 bytes of slack to align the tiles, then Q, the ring, barriers
  static constexpr int SMEM =
      1024 + Q_BYTES + WG_STAGES * STAGE_BYTES + 8 * (2 * WG_STAGES + 1);
};

using wgmma_gemm::wait_or_trap;

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Fragment layout (wgmma f32 accumulator, m64nN): thread `lane` of warp
// `w` in the warpgroup holds d[4j + 2h + e] = (row 16w + lane/4 + 8h,
// column 8j + 2(lane%4) + e).
template <int HD>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_attention_kernel_wgmma(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             bf16* __restrict__ o, int T, int S, int H,
                             int n_rep, int causal, int window, int q_offset,
                             float scale) {
  using Cfg = WgCfg<HD>;
  namespace wg = wgmma_gemm;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = wg::smem_u32(smem_raw);
  const uint32_t sq = (raw + 1023u) & ~1023u;
  const uint32_t ring = sq + Cfg::Q_BYTES;
  const uint32_t bars = ring + WG_STAGES * Cfg::STAGE_BYTES;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (WG_STAGES + s); };
  const uint32_t qbar = bars + 16 * WG_STAGES;

  const int b = blockIdx.x / H, head = blockIdx.x % H, hk = head / n_rep;
  // blockIdx.y counts from the last query tile: under the causal mask the
  // longest tiles of every head start in the first wave
  const int q0 = (gridDim.y - 1 - blockIdx.y) * WG_BQ;
  // the band of keys any row of this tile can see
  int k_end = S;
  if (causal) k_end = min(k_end, q_offset + min(q0 + WG_BQ, T));
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q_offset + q0 - window + 1);
  const int kt0 = k_begin / WG_BK;
  const int n_tiles =
      k_end > k_begin ? (k_end + WG_BK - 1) / WG_BK - kt0 : 0;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      wg::mbar_init(full(s), 1);
      wg::mbar_init(empty(s), CONSUMER_THREADS);
    }
    wg::mbar_init(qbar, 1);
    wg::mbar_init_fence();
  }
  __syncthreads();

  if (warp < 4) {
    // ---- producer: one thread loads Q, then keeps the K/V ring full
    wg::reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == 0 && n_tiles > 0) {
      wg::mbar_arrive_expect_tx(qbar, Cfg::Q_BYTES);
#pragma unroll
      for (int j = 0; j < Cfg::BOXES; ++j)
        wg::tma_load_4d(sq + j * BOX_BYTES_Q, &tq, qbar, 64 * j, head, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % WG_STAGES;
        wait_or_trap(empty(s), ((i / WG_STAGES) & 1) ^ 1);
        wg::mbar_arrive_expect_tx(full(s), Cfg::STAGE_BYTES);
        const uint32_t sk = ring + s * Cfg::STAGE_BYTES;
        const uint32_t sv = sk + Cfg::KV_BYTES;
        const int k0 = (kt0 + i) * WG_BK;
#pragma unroll
        for (int j = 0; j < Cfg::BOXES; ++j) {
          wg::tma_load_4d(sk + j * BOX_BYTES_K, &tk, full(s), 64 * j, hk, k0,
                          b);
          wg::tma_load_4d(sv + j * BOX_BYTES_K, &tv, full(s), 64 * j, hk, k0,
                          b);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup c owns rows [64c, 64c + 64) of the tile
  wg::reg_alloc<CONSUMER_REGS>();
  const int c = warp / 4 - 1;
  const int row = 64 * c + 16 * (warp % 4) + lane / 4;   // +8 for h = 1
  const int t_first = q0 + 64 * c;
  const bool has_rows = t_first < T;
  // this warpgroup's band, over its rows t < T
  const int cq_lo = q_offset + t_first;
  const int cq_hi = q_offset + min(t_first + 64, T) - 1;
  int ck_end = S;
  if (causal) ck_end = min(ck_end, cq_hi + 1);
  int ck_begin = 0;
  if (window > 0) ck_begin = max(0, cq_lo - window + 1);

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.0f;
  float m_i[2] = {NEG, NEG}, l_i[2] = {0.0f, 0.0f};

  if (n_tiles > 0) wait_or_trap(qbar, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % WG_STAGES;
    const int k0 = (kt0 + i) * WG_BK;
    wait_or_trap(full(s), (i / WG_STAGES) & 1);
    // a tile outside this warpgroup's band is only released
    if (has_rows && k0 < ck_end && k0 + WG_BK > ck_begin) {
      const uint32_t sk = ring + s * Cfg::STAGE_BYTES;
      const uint32_t sv = sk + Cfg::KV_BYTES;

      // S = Q K^T: both K-major (hd is the unit stride of each)
      float sc[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) sc[j] = 0.0f;
      wg::fence_operands(sc);
      wg::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint64_t da = wg::desc(
            sq + (kk / 4) * BOX_BYTES_Q + c * (BOX_BYTES_Q / 2) + 32 * (kk % 4),
            16, 1024);
        const uint64_t db =
            wg::desc(sk + (kk / 4) * BOX_BYTES_K + 32 * (kk % 4), 16, 1024);
        wg::mma_m64n64k16<0, 0>(sc, da, db);
      }
      wg::wgmma_commit();
      wg::wgmma_wait<0>();
      wg::fence_operands(sc);

      // scale, mask where the tile crosses an edge, row max
      const bool edge = k0 + WG_BK > S || (causal && k0 + WG_BK - 1 > cq_lo) ||
                        (window > 0 && k0 <= cq_hi - window);
      float mx[2] = {NEG, NEG};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float x = sc[4 * j + 2 * h + e] * scale;
            if (edge) {
              const int kpos = k0 + 8 * j + 2 * (lane % 4) + e;
              const int qpos = q_offset + q0 + row + 8 * h;
              bool ok = kpos < S;
              if (causal) ok = ok && kpos <= qpos;
              if (window > 0) ok = ok && kpos > qpos - window;
              x = ok ? x : NEG;
            }
            sc[4 * j + 2 * h + e] = x;
            mx[h] = fmaxf(mx[h], x);
          }
      float corr[2], psum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m_new = fmaxf(m_i[h], quad_max(mx[h]));
        // zero guard: a fully masked row keeps m == NEG, and exp(0) must
        // not count for it
        corr[h] = m_i[h] > NEG / 2 ? expf(m_i[h] - m_new) : 0.0f;
        m_i[h] = m_new;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float x = sc[4 * j + 2 * h + e];
            const float p = x > NEG / 2 ? expf(x - m_i[h]) : 0.0f;
            sc[4 * j + 2 * h + e] = p;
            psum[h] += p;
          }
#pragma unroll
      for (int h = 0; h < 2; ++h) l_i[h] = l_i[h] * corr[h] + quad_sum(psum[h]);
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          acc[4 * j + 2 * h] *= corr[h];
          acc[4 * j + 2 * h + 1] *= corr[h];
        }

      // P as bf16 A fragments, hi + lo: keys [16kk, 16kk + 16) are
      // sc[8kk .. 8kk + 7], register r the pair sc[8kk + 2r], +1
      uint32_t phi[16], plo[16];
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float p0 = sc[2 * r], p1 = sc[2 * r + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(
            p0 - __low2float(hi), p1 - __high2float(hi));
        phi[r] = bf16x2_bits(hi);
        plo[r] = bf16x2_bits(lo);
      }

      // O += P V: V MN-major (hd is its unit stride), 64-wide boxes LBO
      // apart, a k16 step 16 key rows
      wg::fence_operands(phi);
      wg::fence_operands(plo);
      wg::fence_operands(acc);
      wg::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WG_BK / 16; ++kk) {
        const uint64_t dv = wg::desc(sv + 2048 * kk, BOX_BYTES_K, 1024);
        if constexpr (HD == 128) {
          wg::mma_m64n128k16_rs<1>(acc, phi + 4 * kk, dv);
          wg::mma_m64n128k16_rs<1>(acc, plo + 4 * kk, dv);
        } else {
          wg::mma_m64n64k16_rs<1>(acc, phi + 4 * kk, dv);
          wg::mma_m64n64k16_rs<1>(acc, plo + 4 * kk, dv);
        }
      }
      wg::wgmma_commit();
      wg::wgmma_wait<0>();
      wg::fence_operands(acc);
      wg::fence_operands(phi);
      wg::fence_operands(plo);
    }
    wg::mbar_arrive(empty(s));   // this warpgroup's products on s are done
  }

  if (!has_rows) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = q0 + row + 8 * h;
    if (t >= T) continue;
    const float l = fmaxf(l_i[h], 1e-30f);
    bf16* const orow = o + (((long long)b * T + t) * H + head) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * (lane % 4)) =
          __floats2bfloat162_rn(__fdiv_rn(acc[4 * j + 2 * h], l),
                                __fdiv_rn(acc[4 * j + 2 * h + 1], l));
  }
}

// A 4-D bf16 map over a contiguous (B, rows, heads, HD) tensor, dims
// innermost first {HD, heads, rows, B}, read in boxes of {64, 1,
// box_rows, 1} with the 128-byte swizzle; rows past the end (within a
// batch) read as 0.
template <int HD>
int encode_4d(CUtensorMap* map, const void* p, int B, int rows, int heads,
              int box_rows) {
  const wgmma_gemm::EncodeTiled fn = wgmma_gemm::encoder();
  if (fn == nullptr) return wgmma_gemm::NO_ENCODER;
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)heads,
                              (cuuint64_t)rows, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)HD * 2,
                                 (cuuint64_t)heads * HD * 2,
                                 (cuuint64_t)rows * heads * HD * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(p), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : wgmma_gemm::ENCODE_FAILED + (int)r;
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B,
                 int T, int S, int H, int Hkv, int causal, int window,
                 int q_offset, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int rc = encode_4d<HD>(&tq, q, B, T, H, WG_BQ);
  if (rc == 0) rc = encode_4d<HD>(&tk, k, B, S, Hkv, WG_BK);
  if (rc == 0) rc = encode_4d<HD>(&tv, v, B, S, Hkv, WG_BK);
  if (rc != 0) return rc;
  auto kernel = flash_attention_kernel_wgmma<HD>;
  constexpr int smem = WgCfg<HD>::SMEM;
  static uint64_t ready = 0;    // devices checked and given the smem
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64 || !(ready >> dev & 1)) {
    cudaFuncAttributes fa;
    e = cudaFuncGetAttributes(&fa, kernel);
    if (e != cudaSuccess) return (int)e;
    if (fa.numRegs < ENTRY_REGS) return FEW_REGISTERS + fa.numRegs;
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) ready |= (uint64_t)1 << dev;
  }
  const dim3 grid(B * H, (T + WG_BQ - 1) / WG_BQ);
  kernel<<<grid, WG_THREADS, smem, stream>>>(tq, tk, tv, (bf16*)o, T, S, H,
                                             H / Hkv, causal, window,
                                             q_offset, scale);
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

// The wgmma route: bf16 q, k, v, o, hd 64 or 128, contiguous with bases
// aligned to 16 bytes. Returns 0, a cudaError_t, an encode failure
// (ENCODE_FAILED + CUresult, NO_ENCODER of wgmma_gemm.cuh) or
// FEW_REGISTERS + the kernel's registers a thread.
extern "C" int flash_attention_wgmma_launch(const void* q, const void* k,
                                            const void* v, void* o, int B,
                                            int T, int S, int H, int Hkv,
                                            int hd, int causal, int window,
                                            int q_offset, float scale,
                                            void* stream) {
  if (B < 1 || T < 1 || S < 1 || H < 1 || Hkv < 1 || H % Hkv != 0 ||
      (hd != 64 && hd != 128) || (long long)B * H > 65535 ||
      (T + WG_BQ - 1) / WG_BQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (hd == 64)
    return launch_wgmma<64>(q, k, v, o, B, T, S, H, Hkv, causal, window,
                            q_offset, scale, s);
  return launch_wgmma<128>(q, k, v, o, B, T, S, H, Hkv, causal, window,
                           q_offset, scale, s);
}
