// Pruned-weight matmul for Hopper (sm_90a):
//   out = (a @ (b * b_mask)) * out_mask
// with f32 accumulation and the output in the operands' dtype (f32 or
// bf16). b_mask and out_mask are optional (null). The forward is
// y = x @ (w * mask); the backward reuses the kernels on strided
// (transposed) views, dx = g @ (w * mask)^T and dw = (x^T @ g) * mask.
// Rounding is the reference's for any mask values: b * b_mask is formed
// in the operands' dtype, and out_mask multiplies the result after it is
// rounded to the dtype, with one more rounding.
//
// Replaces the TPU kernel src/repro/kernels/masked_matmul/kernel.py
// (masked_matmul_raw, body _mm_kernel) and its custom-VJP wrapper
// (ops.py:masked_matmul): the public kernel API's pruned matmul.
//
// Bound: operations at llama3.2-3b's MLP shapes with M = 8192 (2*M*K*N
// against one read of x, w and mask: 989 TFLOP/s bf16 on the tensor
// cores, 67 TFLOP/s f32 on the CUDA cores), bytes at M = 256 (w and mask
// outweigh the products). Two routes, chosen by the wrapper (ops.py:route):
//
// - wgmma (bf16 operands that TMA can describe: 16-byte aligned bases,
//   row strides a multiple of 16 bytes). A producer warp keeps TMA loads
//   of the a, b and b_mask tiles (128 x 64, 64 x BN, 64 x BN, 128-byte
//   swizzle) in flight through a ring of shared-memory stages; three
//   mask warps multiply each landed b tile by its mask tile in place
//   (__hmul2, so w * mask is rounded to bf16 as in the reference and is
//   never written to device memory), fence the writes for the async
//   proxy and release the stage; two consumer warpgroups run
//   wgmma.mma_async m64nBNk16 over it (64 rows of the 128-row tile
//   each). Operands are K- or MN-major through wgmma's transpose bits, so
//   the three products of the autograd pass read their views in place.
//   TMA zero-fills ragged M, N and K; the epilogue masks its stores.
//   Small M x N takes BN = 64 and, if the tiles still do not fill the
//   SMs, a split-K pass: f32 partials, then an ordered sum.
// - simt (f32, and bf16 that TMA refuses): the CUDA-core main loop of
//   tile_gemm.cuh, templated on the operands' orientations, with w * mask
//   formed in the dtype as each tile is staged. f32 stays f32 throughout
//   (no TF32).
#include "tile_gemm.cuh"
#include "wgmma_gemm.cuh"

namespace {

using bf16 = __nv_bfloat16;
using tile_gemm::from_f32;
using tile_gemm::to_f32;

// v rounded to T and back (exact for T = float).
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// ------------------------------------------------------------ simt route

// B(k, n) = w(k, n) * mask(k, n), the product rounded to T: both factors
// are exact in f32, so their f32 product is exact and one rounding gives
// T's own multiply.
template <typename T>
struct MaskedB {
  const T* w;
  long long swk, swn;
  const T* m;                 // null: no mask
  long long smk, smn;
  bool vec;
  __device__ __forceinline__ float operator()(int k, int n) const {
    const float v = to_f32(w[k * swk + n * swn]);
    return m == nullptr ? v : round_to<T>(v * to_f32(m[k * smk + n * smn]));
  }
  template <bool NC>
  __device__ __forceinline__ float4 load4(int k, int n) const {
    float4 v = tile_gemm::load4(w + k * swk + n * swn);
    if (m != nullptr) {
      const float4 q = tile_gemm::load4(m + k * smk + n * smn);
      v = make_float4(round_to<T>(v.x * q.x), round_to<T>(v.y * q.y),
                      round_to<T>(v.z * q.z), round_to<T>(v.w * q.w));
    }
    return v;
  }
};

template <typename T, bool A_KC, bool B_NC>
__global__ void __launch_bounds__(tile_gemm::THREADS, 2)
masked_matmul_kernel_simt(const T* __restrict__ a, long long lda, bool a_vec,
                          MaskedB<T> b, const T* __restrict__ om,
                          long long som, long long son, T* __restrict__ out,
                          int M, int N, int K) {
  __shared__ __align__(16) tile_gemm::Smem smem;
  const int m0 = blockIdx.y * tile_gemm::BM, n0 = blockIdx.x * tile_gemm::BN;
  float acc[tile_gemm::TM][tile_gemm::TN];
  tile_gemm::run<A_KC, B_NC>(a, lda, a_vec, b, M, N, K, m0, n0, smem, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < tile_gemm::TM; ++i) {
    const int r = m0 + tile_gemm::tile_row(ty, i);
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < tile_gemm::TN; ++j) {
      const int c = n0 + tile_gemm::tile_col(tx, j);
      if (c >= N) continue;
      // the reference rounds x^T @ g to the dtype, then masks in it
      const float v =
          om != nullptr
              ? round_to<T>(acc[i][j]) * to_f32(om[r * som + c * son])
              : acc[i][j];
      out[(long long)r * N + c] = from_f32<T>(v);
    }
  }
}

template <typename T>
int launch_simt(const void* a, long long sam, long long sak, const void* w,
                long long swk, long long swn, const void* m, long long smk,
                long long smn, const void* om, long long som, long long son,
                void* out, int M, int N, int K, cudaStream_t stream) {
  if ((sak != 1 && sam != 1) || (swn != 1 && swk != 1))
    return (int)cudaErrorInvalidValue;
  const bool a_kc = sak == 1, b_nc = swn == 1;
  const long long lda = a_kc ? sam : sak;
  const bool m_same = m == nullptr || (b_nc ? smn == 1 : smk == 1);
  const bool b_vec =
      tile_gemm::vec4_ok(w, b_nc ? swk : swn, sizeof(T)) && m_same &&
      (m == nullptr || tile_gemm::vec4_ok(m, b_nc ? smk : smn, sizeof(T)));
  const MaskedB<T> b{(const T*)w, swk, swn, (const T*)m, smk, smn, b_vec};
  const bool a_vec = tile_gemm::vec4_ok(a, lda, sizeof(T));
  const dim3 grid((N + tile_gemm::BN - 1) / tile_gemm::BN,
                  (M + tile_gemm::BM - 1) / tile_gemm::BM);
  auto go = [&](auto kernel) {
    kernel<<<grid, tile_gemm::THREADS, 0, stream>>>(
        (const T*)a, lda, a_vec, b, (const T*)om, som, son, (T*)out, M, N,
        K);
  };
  if (a_kc && b_nc) go(masked_matmul_kernel_simt<T, true, true>);
  else if (a_kc) go(masked_matmul_kernel_simt<T, true, false>);
  else if (b_nc) go(masked_matmul_kernel_simt<T, false, true>);
  else go(masked_matmul_kernel_simt<T, false, false>);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------- wgmma route

constexpr int WG_BM = 128, WG_BK = 64, WG_THREADS = 384;
constexpr int MASK_THREADS = 96;        // warps 1-3
constexpr int CONSUMER_THREADS = 256;   // warps 4-11
constexpr int BOX_BYTES = 64 * 64 * 2;  // one 64 x 64 bf16 box

template <int BN>
struct WgCfg {
  static constexpr int STAGES = BN == 128 ? 4 : 6;
  static constexpr int A_BYTES = WG_BM * WG_BK * 2;
  static constexpr int B_BYTES = WG_BK * BN * 2;
  static constexpr int STAGE_BYTES = A_BYTES + 2 * B_BYTES;
  // stages, 1024 bytes of slack to align them, three barriers per stage
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024 + 3 * STAGES * 8;
};

__device__ __forceinline__ void store_bf16(bf16* out, const bf16* om,
                                           long long som, long long son,
                                           int r, int c, int N, float v) {
  bf16 o = __float2bfloat16_rn(v);
  if (om != nullptr) o = __hmul(o, om[r * som + c * son]);
  out[(long long)r * N + c] = o;
}

// A_KM / B_KM: the operand's unit stride is along K. ws non-null: write
// this split's f32 partial sums to ws[blockIdx.z] instead of out.
template <bool A_KM, bool B_KM, int BN>
__global__ void __launch_bounds__(WG_THREADS, 1)
masked_matmul_kernel_wgmma(const __grid_constant__ CUtensorMap ta,
                           const __grid_constant__ CUtensorMap tb,
                           const __grid_constant__ CUtensorMap tm,
                           int has_mask, const bf16* __restrict__ om,
                           long long som, long long son,
                           bf16* __restrict__ out, float* __restrict__ ws,
                           int M, int N, int K, int kb_per_split) {
  using Cfg = WgCfg<BN>;
  constexpr int S = Cfg::STAGES;
  namespace wg = wgmma_gemm;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = wg::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t bars = base + S * Cfg::STAGE_BYTES;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (S + s); };
  auto loaded = [&](int s) { return bars + 8 * (2 * S + s); };

  const int kb_total = (K + WG_BK - 1) / WG_BK;
  const int kb0 = blockIdx.z * kb_per_split;
  const int nkb = max(0, min(kb_total - kb0, kb_per_split));
  const int m0 = blockIdx.x * WG_BM, n0 = blockIdx.y * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      wg::mbar_init(full(s), has_mask ? MASK_THREADS : 1);
      wg::mbar_init(empty(s), CONSUMER_THREADS);
      wg::mbar_init(loaded(s), 1);
    }
    wg::mbar_init_fence();
  }
  __syncthreads();

  if (warp == 0) {
    // ---- producer: one thread keeps the ring's TMA loads in flight
    if (lane == 0) {
      const uint32_t bytes = Cfg::A_BYTES + (has_mask ? 2 : 1) * Cfg::B_BYTES;
      for (int i = 0; i < nkb; ++i) {
        const int s = i % S;
        wg::mbar_wait(empty(s), ((i / S) & 1) ^ 1);
        const uint32_t bar = has_mask ? loaded(s) : full(s);
        wg::mbar_arrive_expect_tx(bar, bytes);
        const uint32_t sa = base + s * Cfg::STAGE_BYTES;
        const uint32_t sb = sa + Cfg::A_BYTES, sm = sb + Cfg::B_BYTES;
        const int k0 = (kb0 + i) * WG_BK;
        if (A_KM) {
          wg::tma_load_2d(sa, &ta, bar, k0, m0);
        } else {
          wg::tma_load_2d(sa, &ta, bar, m0, k0);
          wg::tma_load_2d(sa + BOX_BYTES, &ta, bar, m0 + 64, k0);
        }
        if (B_KM) {
          wg::tma_load_2d(sb, &tb, bar, k0, n0);
          if (has_mask) wg::tma_load_2d(sm, &tm, bar, k0, n0);
        } else {
#pragma unroll
          for (int j = 0; j < BN / 64; ++j) {
            wg::tma_load_2d(sb + j * BOX_BYTES, &tb, bar, n0 + 64 * j, k0);
            if (has_mask)
              wg::tma_load_2d(sm + j * BOX_BYTES, &tm, bar, n0 + 64 * j, k0);
          }
        }
      }
    }
  } else if (warp < 4) {
    // ---- mask warps: b *= b_mask in place, in bf16, stage by stage. b
    // and its mask share the box and the swizzle, so equal offsets hold
    // equal (k, n).
    if (has_mask) {
      const int t = threadIdx.x - 32;
      constexpr int VECS = Cfg::B_BYTES / 16;
      for (int i = 0; i < nkb; ++i) {
        const int s = i % S;
        wg::mbar_wait(loaded(s), (i / S) & 1);
        uint8_t* const gb = gbase + s * Cfg::STAGE_BYTES + Cfg::A_BYTES;
        const uint8_t* const gm = gb + Cfg::B_BYTES;
        for (int v = t; v < VECS; v += MASK_THREADS) {
          uint4 w4 = *reinterpret_cast<const uint4*>(gb + 16 * v);
          const uint4 m4 = *reinterpret_cast<const uint4*>(gm + 16 * v);
          __nv_bfloat162* w2 = reinterpret_cast<__nv_bfloat162*>(&w4);
          const __nv_bfloat162* m2 =
              reinterpret_cast<const __nv_bfloat162*>(&m4);
#pragma unroll
          for (int j = 0; j < 4; ++j) w2[j] = __hmul2(w2[j], m2[j]);
          *reinterpret_cast<uint4*>(gb + 16 * v) = w4;
        }
        wg::fence_proxy_async();
        wg::mbar_arrive(full(s));
      }
    }
  } else {
    // ---- consumers: warpgroup c owns rows [64c, 64c + 64) of the tile
    const int c = warp / 4 - 1;
    float acc[BN / 2];
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) acc[j] = 0.0f;
    for (int i = 0; i < nkb; ++i) {
      const int s = i % S;
      wg::mbar_wait(full(s), (i / S) & 1);
      const uint32_t sa = base + s * Cfg::STAGE_BYTES + c * BOX_BYTES;
      const uint32_t sb = base + s * Cfg::STAGE_BYTES + Cfg::A_BYTES;
      wg::fence_operands(acc);
      wg::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WG_BK / 16; ++kk) {
        const uint64_t da = A_KM ? wg::desc(sa + 32 * kk, 16, 1024)
                                 : wg::desc(sa + 2048 * kk, BOX_BYTES, 1024);
        const uint64_t db = B_KM ? wg::desc(sb + 32 * kk, 16, 1024)
                                 : wg::desc(sb + 2048 * kk, BOX_BYTES, 1024);
        if constexpr (BN == 128)
          wg::mma_m64n128k16<A_KM ? 0 : 1, B_KM ? 0 : 1>(acc, da, db);
        else
          wg::mma_m64n64k16<A_KM ? 0 : 1, B_KM ? 0 : 1>(acc, da, db);
      }
      wg::wgmma_commit();
      wg::fence_operands(acc);
      // the previous stage's products are done: release it
      wg::wgmma_wait<1>();
      wg::fence_operands(acc);
      if (i > 0) wg::mbar_arrive(empty((i - 1) % S));
    }
    wg::wgmma_wait<0>();
    wg::fence_operands(acc);

    // accumulator fragment: d[4j + 2h + e] is (row + 8h, col + 8j + e)
    const int row = m0 + 64 * c + 16 * (warp % 4) + lane / 4;
    const int col = n0 + 2 * (lane % 4);
    const bool pair = N % 2 == 0;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row + 8 * h, cc = col + 8 * j;
        if (r >= M || cc >= N) continue;
        const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        if (ws != nullptr) {
          float* p = ws + ((long long)blockIdx.z * M + r) * N + cc;
          if (pair) {
            *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
          } else {
            p[0] = v0;
            if (cc + 1 < N) p[1] = v1;
          }
        } else if (pair && om == nullptr) {
          *reinterpret_cast<__nv_bfloat162*>(out + (long long)r * N + cc) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          store_bf16(out, om, som, son, r, cc, N, v0);
          if (cc + 1 < N) store_bf16(out, om, som, son, r, cc + 1, N, v1);
        }
      }
    }
  }
}

// out = round(sum of the splits' partials, in split order) * out_mask.
__global__ void masked_matmul_kernel_splitk_sum(
    const float* __restrict__ ws, int splits, const bf16* __restrict__ om,
    long long som, long long son, bf16* __restrict__ out, int M, int N) {
  const long long total = (long long)M * N;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    float v = 0.0f;
    for (int s = 0; s < splits; ++s) v += ws[s * total + e];
    store_bf16(out, om, som, son, (int)(e / N), (int)(e % N), N, v);
  }
}

using wgmma_gemm::encode_bf16;

template <bool A_KM, bool B_KM, int BN>
int launch_wgmma_as(const CUtensorMap& ta, const CUtensorMap& tb,
                    const CUtensorMap& tm, int has_mask, const void* om,
                    long long som, long long son, void* out, void* ws,
                    int M, int N, int K, int splits, cudaStream_t stream) {
  auto kernel = masked_matmul_kernel_wgmma<A_KM, B_KM, BN>;
  constexpr int smem = WgCfg<BN>::SMEM;
  static uint64_t attr_set = 0;     // devices that allow this instance smem
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64 || !(attr_set >> dev & 1)) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) attr_set |= (uint64_t)1 << dev;
  }
  const int kb_total = (K + WG_BK - 1) / WG_BK;
  const int per = (kb_total + splits - 1) / splits;
  const dim3 grid((M + WG_BM - 1) / WG_BM, (N + BN - 1) / BN, splits);
  kernel<<<grid, WG_THREADS, smem, stream>>>(
      ta, tb, tm, has_mask, (const bf16*)om, som, son, (bf16*)out,
      splits > 1 ? (float*)ws : nullptr, M, N, K, per);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const long long total = (long long)M * N;
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256
                                                       : 4096);
  masked_matmul_kernel_splitk_sum<<<blocks, 256, 0, stream>>>(
      (const float*)ws, splits, (const bf16*)om, som, son, (bf16*)out, M, N);
  return (int)cudaGetLastError();
}

int launch_wgmma(const void* a, long long sam, long long sak, const void* w,
                 long long swk, long long swn, const void* m, long long smk,
                 long long smn, const void* om, long long som, long long son,
                 void* out, void* ws, int M, int N, int K, int bn, int splits,
                 cudaStream_t stream) {
  const bool a_km = sak == 1, b_km = swk == 1;
  if ((!a_km && sam != 1) || (!b_km && swn != 1) || (bn != 64 && bn != 128) ||
      splits < 1 || splits > 65535 || K < 1 || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  if (m != nullptr && (smk != swk || smn != swn))
    return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb, tm;
  int rc = a_km ? encode_bf16(&ta, a, K, M, sam, WG_BM)
                : encode_bf16(&ta, a, M, K, sak, 64);
  if (rc == 0)
    rc = b_km ? encode_bf16(&tb, w, K, N, swn, bn)
              : encode_bf16(&tb, w, N, K, swk, 64);
  if (rc == 0 && m != nullptr)
    rc = b_km ? encode_bf16(&tm, m, K, N, smn, bn)
              : encode_bf16(&tm, m, N, K, smk, 64);
  if (rc != 0) return rc;
  if (m == nullptr) tm = tb;
  const int hm = m != nullptr;
#define MM_GO(AK, BK, BNV)                                                   \
  return launch_wgmma_as<AK, BK, BNV>(ta, tb, tm, hm, om, som, son, out, ws, \
                                      M, N, K, splits, stream)
  if (bn == 128) {
    if (a_km && b_km) MM_GO(true, true, 128);
    if (a_km) MM_GO(true, false, 128);
    if (b_km) MM_GO(false, true, 128);
    MM_GO(false, false, 128);
  }
  if (a_km && b_km) MM_GO(true, true, 64);
  if (a_km) MM_GO(true, false, 64);
  if (b_km) MM_GO(false, true, 64);
  MM_GO(false, false, 64);
#undef MM_GO
}

}  // namespace

// dtype: 0 f32, 1 bf16 (a, w, masks and out share it); route: 0 simt,
// 1 wgmma (bf16 only; bn 64 or 128 and `splits` K-splits, ws an f32
// (splits, M, N) scratch when splits > 1). Strides are in elements, one
// of each operand's two is 1; out is (M, N) row-major. Returns 0, a
// cudaError_t, or an encode failure (ENCODE_FAILED + CUresult,
// NO_ENCODER).
extern "C" int masked_matmul_launch(int dtype, int route, const void* a,
                                    long long sam, long long sak,
                                    const void* w, long long swk,
                                    long long swn, const void* m,
                                    long long smk, long long smn,
                                    const void* om, long long som,
                                    long long son, void* out, void* ws,
                                    int M, int N, int K, int bn, int splits,
                                    void* stream) {
  if (M < 0 || N < 0 || K < 0 || (dtype != 0 && dtype != 1) ||
      (route != 0 && route != 1) || (route == 1 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (route == 1)
    return launch_wgmma(a, sam, sak, w, swk, swn, m, smk, smn, om, som, son,
                        out, ws, M, N, K, bn, splits, s);
  if ((M + tile_gemm::BM - 1) / tile_gemm::BM > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_simt<float>(a, sam, sak, w, swk, swn, m, smk, smn, om, som,
                              son, out, M, N, K, s);
  return launch_simt<bf16>(a, sam, sak, w, swk, swn, m, smk, smn, om, som,
                           son, out, M, N, K, s);
}
