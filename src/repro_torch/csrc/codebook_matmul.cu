// Clustered-weight matmul for Hopper (sm_90a):
//   out = x @ codebook[idx]
// x (M, K) f32 or bf16, idx (K, N) int8 or int32 codeword ids, codebook
// (n_codes <= 256,) f32; f32 accumulation, output in x's dtype. The f32
// weight matrix codebook[idx] is never written to device memory.
//
// Replaces the TPU kernel src/repro/kernels/codebook_matmul/kernel.py
// (codebook_matmul_raw, body _cb_kernel): the public kernel API's
// clustered matmul. The TPU kernel decoded by an unrolled select chain
// over the codewords because its VMEM had no fast gather; here a
// shared-memory table lookup replaces it.
//
// Bound: operations at the shapes the port uses (llama3.2-3b's MLP) with
// M = 8192, bytes (x and the 1- or 4-byte indices) with M = 256. Two
// routes, chosen by the wrapper (ops.py:route):
//
// - wgmma (x and idx that TMA can describe): exact products on the bf16
//   tensor cores. Each codeword c is split into three bf16 terms, c = c1
//   + c2 + c3, each the bf16 of what is left (c1 truncated where it would
//   round up to inf). The three give c back exactly for |c| >= 2^-110
//   (below it c3 loses bits under bf16's subnormal floor, 2^-133). A
//   bf16 x times a term is exact in f32, so bf16 x takes three products,
//   x.B1 + x.B2 + x.B3, into one f32 accumulator: only the summation
//   differs from the reference's f32 product. f32 x is split the same
//   way into three bf16 planes by a prepass (a (3, M, K) bf16 workspace)
//   and takes the six products x1c1, x1c2, x1c3, x2c1, x2c2, x3c1 (|x2|,
//   |c2| <= ~2^-8 and |x3|, |c3| <= ~2^-16 of |x|, |c|); the three left
//   out are each at most about 2^-24 of |x||c|, with either sign.
//   One block computes a 128 x BN tile: a producer warp keeps TMA loads
//   of x (or its planes, 128 x 64 each, 128-byte swizzle) and of the
//   64 x BN index bytes in flight through a ring of shared-memory stages;
//   eight decode warps look each index up in a 256-entry table of split
//   codewords (8 bytes an entry: one load serves one index) and write the
//   three bf16 B tiles into a second ring (two or three stages) in the
//   swizzled N-major layout the wgmma descriptors read, fenced for the
//   async proxy; two consumer warpgroups run wgmma.mma_async m64nBNk16
//   over both and release them. The table is indexed by the raw index
//   byte, with the oracle's index rules built into it; int32 indices, and
//   int8 ones that are not row-major, are first narrowed to row-major
//   codeword-id bytes by a prepass (an int32 tile would take 32 KB of
//   every stage). Small M x N takes BN = 64 and split-K, as
//   masked_matmul's wgmma route does; blocks walk the tiles in groups of
//   8 row tiles so that a wave's x and index tiles stay in L2.
// - simt (everything else): the f32 CUDA-core main loop of tile_gemm.cuh
//   (masked_matmul's f32 route), bf16 x widened to f32 as it is staged.
//   Each block copies the codebook into shared memory and decodes every
//   idx element of its tile by a gather as the tile is staged. int8
//   indices are read four at a time (one 4-byte load), int32 as one
//   16-byte load.
//
// Indices are meant to lie in [0, n_codes). One outside follows the JAX
// oracle's gather (codebook_matmul_ref): a negative index counts from the
// end, then the result is clamped into range. The TPU kernel gives 0.0
// there instead; tests/test_torch_matmul_kernels.py pins both.
#include <type_traits>

#include "tile_gemm.cuh"
#include "wgmma_gemm.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ------------------------------------------------------------ simt route

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
  bool vec;                   // idx rows allow 4-wide loads
  __device__ __forceinline__ float decode(int c) const {
    if (c < 0) c += n_codes;
    c = c < 0 ? 0 : (c >= n_codes ? n_codes - 1 : c);
    return cb[c];
  }
  __device__ __forceinline__ float operator()(int k, int n) const {
    return decode((int)idx[k * si_k + n * si_n]);
  }
  template <bool NC>
  __device__ __forceinline__ float4 load4(int k, int n) const {
    const TI* p = idx + (long long)k * si_k + (long long)n * si_n;
    int c[4];
    if constexpr (sizeof(TI) == 1) {
      const char4 v = *reinterpret_cast<const char4*>(p);
      c[0] = v.x, c[1] = v.y, c[2] = v.z, c[3] = v.w;
    } else {
      const int4 v = *reinterpret_cast<const int4*>(p);
      c[0] = v.x, c[1] = v.y, c[2] = v.z, c[3] = v.w;
    }
    return make_float4(decode(c[0]), decode(c[1]), decode(c[2]),
                       decode(c[3]));
  }
};

template <typename TX, typename TI, bool X_KC, bool I_NC>
__global__ void __launch_bounds__(THREADS, 2)
codebook_matmul_kernel(const TX* __restrict__ x, long long ldx, bool x_vec,
                       CodebookB<TI> b, const float* __restrict__ codebook,
                       TX* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) tile_gemm::Smem smem;
  __shared__ float cb[MAX_CODES];
  for (int i = threadIdx.x; i < b.n_codes; i += THREADS) cb[i] = codebook[i];
  __syncthreads();
  b.cb = cb;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[tile_gemm::TM][tile_gemm::TN];
  tile_gemm::run<X_KC, I_NC>(x, ldx, x_vec, b, M, N, K, m0, n0, smem, acc);
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
  if (sxk != 1 && sxm != 1) return (int)cudaErrorInvalidValue;
  if (si_n != 1 && si_k != 1) return (int)cudaErrorInvalidValue;
  const bool x_kc = sxk == 1, i_nc = si_n == 1;
  const long long ldx = x_kc ? sxm : sxk, ldi = i_nc ? si_k : si_n;
  const bool x_vec = tile_gemm::vec4_ok(x, ldx, sizeof(TX));
  const CodebookB<TI> b{(const TI*)idx, si_k, si_n, nullptr, n_codes,
                        tile_gemm::vec4_ok(idx, ldi, sizeof(TI))};
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  auto go = [&](auto kernel) {
    kernel<<<grid, THREADS, 0, stream>>>((const TX*)x, ldx, x_vec, b,
                                         (const float*)codebook, (TX*)out, M,
                                         N, K);
  };
  if (x_kc && i_nc) go(codebook_matmul_kernel<TX, TI, true, true>);
  else if (x_kc) go(codebook_matmul_kernel<TX, TI, true, false>);
  else if (i_nc) go(codebook_matmul_kernel<TX, TI, false, true>);
  else go(codebook_matmul_kernel<TX, TI, false, false>);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------- wgmma route

constexpr int WG_BM = 128, WG_BK = 64, WG_THREADS = 544;
constexpr int DECODE_THREADS = 256;     // warps 1-3 and 12-16
constexpr int CONSUMER_THREADS = 256;   // warps 4-11
constexpr int BOX_BYTES = 64 * 64 * 2;  // one 64 x 64 bf16 box
constexpr int PLANE_BYTES = WG_BM * WG_BK * 2;   // one x tile (or plane)
constexpr int TABLE = 256;              // one entry per index byte
constexpr int SMEM_MAX = 232448;        // a block's shared memory (H100)
constexpr int MAX_STAGES = 6;
constexpr int GROUP_M = 8;              // row tiles per raster group

// P: bf16 planes of x (1: bf16 x; 3: the f32 x split). Two rings: TMA
// stages, each the x tile (P planes) and the index bytes, and decoded
// stages, each the three B term tiles. bf16 x decodes about as fast as
// it multiplies, so its decode warps run two steps ahead (three decoded
// stages); f32 x's six products leave the decode warps time, so two
// decoded stages do and the rest deepens its TMA ring, whose stages are
// over twice a bf16 x one.
template <int P, int BN>
struct CbCfg {
  static constexpr int A_BYTES = P * PLANE_BYTES;
  static constexpr int I_BYTES = WG_BK * BN;
  static constexpr int LD_BYTES = A_BYTES + I_BYTES;
  static constexpr int B_TILE = WG_BK * BN * 2;
  static constexpr int B_BYTES = 3 * B_TILE;
  static constexpr int B_STAGES = P == 1 ? 3 : 2;
  static constexpr int FIT =
      (SMEM_MAX - TABLE * 8 - 1024 - 16 * (MAX_STAGES + B_STAGES) -
       B_STAGES * B_BYTES) / LD_BYTES;
  static constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  // 1024 bytes of slack to align the tiles, the two rings, two barriers
  // per stage of each
  static constexpr int SMEM = 1024 + STAGES * LD_BYTES + B_STAGES * B_BYTES +
                              16 * (STAGES + B_STAGES);
  static_assert(STAGES >= 2, "a codebook wgmma TMA stage does not fit twice");
};

// The bf16 bits of v, rounded to nearest even.
__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// v as three bf16 terms, v = t1 + t2 + t3, each the bf16 of what is left
// (rounded to nearest even; both differences are exact in f32), except
// that t1 is truncated where rounding would give inf (|v| >= 0x7F7F8000,
// within 2^-9 of the largest f32). Packed as x = t1 | t2 << 16, y = t3.
// A non-finite v is t1 alone (a NaN kept a NaN).
__device__ __forceinline__ uint2 split3(float v) {
  const uint32_t b = __float_as_uint(v);
  if (!isfinite(v)) return make_uint2(isnan(v) ? 0x7FC0u : b >> 16, 0u);
  const uint32_t t1 = (b & 0x7FFFFFFFu) >= 0x7F7F8000u ? b >> 16
                                                       : bf16_bits(v);
  const float r1 = v - __uint_as_float(t1 << 16);
  const uint32_t t2 = bf16_bits(r1);
  const float r2 = r1 - __uint_as_float(t2 << 16);
  return make_uint2(t1 | t2 << 16, bf16_bits(r2));
}

// The codeword id the oracle's gather reads for index c.
__device__ __forceinline__ int clamp_index(int c, int n_codes) {
  if (c < 0) c += n_codes;
  return c < 0 ? 0 : (c >= n_codes ? n_codes - 1 : c);
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float v0, float v1);
template <>
__device__ __forceinline__ void store2<float>(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
template <>
__device__ __forceinline__ void store2<bf16>(bf16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// ta: x (P = 1; A_KM: its unit stride is along K) or its three planes
// stacked as (3M, K) rows (P = 3). ti: the (K, N) index bytes, read as
// they are (idx_signed: int8 ids under the oracle's rules) or narrowed by
// the prepass (codeword ids). ws non-null: write this split's f32
// partial sums to ws[blockIdx.z] instead of out.
template <int P, bool A_KM, int BN>
__global__ void __launch_bounds__(WG_THREADS, 1)
codebook_matmul_kernel_wgmma(const __grid_constant__ CUtensorMap ta,
                             const __grid_constant__ CUtensorMap ti,
                             const float* __restrict__ codebook,
                             int n_codes, int idx_signed,
                             void* __restrict__ out, float* __restrict__ ws,
                             int M, int N, int K, int kb_per_split) {
  using Cfg = CbCfg<P, BN>;
  using TO = typename std::conditional<P == 1, bf16, float>::type;
  constexpr int S = Cfg::STAGES, SB = Cfg::B_STAGES;
  namespace wg = wgmma_gemm;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint2 table[TABLE];
  const uint32_t raw = wg::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t bbase = base + S * Cfg::LD_BYTES;   // the decoded ring
  const uint32_t bars = bbase + SB * Cfg::B_BYTES;
  // TMA stage s: loaded (the transfer landed), freed (the products that
  // read it are done); decoded stage b: decoded, consumed
  auto loaded = [&](int s) { return bars + 8 * s; };
  auto freed = [&](int s) { return bars + 8 * (S + s); };
  auto decoded = [&](int b) { return bars + 8 * (2 * S + b); };
  auto consumed = [&](int b) { return bars + 8 * (2 * S + SB + b); };

  // tiles in groups of GROUP_M row tiles, column tiles walked within one
  const int tiles_m = (M + WG_BM - 1) / WG_BM, tiles_n = (N + BN - 1) / BN;
  const int group = blockIdx.x / (GROUP_M * tiles_n);
  const int first_m = group * GROUP_M;
  const int rows = min(tiles_m - first_m, GROUP_M);
  const int in_group = blockIdx.x % (GROUP_M * tiles_n);
  const int m0 = (first_m + in_group % rows) * WG_BM;
  const int n0 = (in_group / rows) * BN;
  const int kb_total = (K + WG_BK - 1) / WG_BK;
  const int kb0 = blockIdx.z * kb_per_split;
  const int nkb = max(0, min(kb_total - kb0, kb_per_split));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      wg::mbar_init(loaded(s), 1);
      wg::mbar_init(freed(s), CONSUMER_THREADS);
    }
    for (int b = 0; b < SB; ++b) {
      wg::mbar_init(decoded(b), DECODE_THREADS);
      wg::mbar_init(consumed(b), CONSUMER_THREADS);
    }
    wg::mbar_init_fence();
  }
  for (int e = threadIdx.x; e < TABLE; e += WG_THREADS)
    table[e] = split3(codebook[clamp_index(
        idx_signed ? (int)(int8_t)(uint8_t)e : e, n_codes)]);
  __syncthreads();

  if (warp == 0) {
    // ---- producer: one thread keeps the ring's TMA loads in flight
    if (lane == 0) {
      for (int i = 0; i < nkb; ++i) {
        const int s = i % S;
        wg::wait_or_trap(freed(s), ((i / S) & 1) ^ 1);
        wg::mbar_arrive_expect_tx(loaded(s), Cfg::LD_BYTES);
        const uint32_t sa = base + s * Cfg::LD_BYTES;
        const int k0 = (kb0 + i) * WG_BK;
        if (A_KM) {
#pragma unroll
          for (int p = 0; p < P; ++p)
            wg::tma_load_2d(sa + p * PLANE_BYTES, &ta, loaded(s), k0,
                            p * M + m0);
        } else {
          wg::tma_load_2d(sa, &ta, loaded(s), m0, k0);
          wg::tma_load_2d(sa + BOX_BYTES, &ta, loaded(s), m0 + 64, k0);
        }
        wg::tma_load_2d(sa + Cfg::A_BYTES, &ti, loaded(s), n0, k0);
      }
    }
  } else if (warp < 4 || warp >= 12) {
    // ---- decode warps (1-3, 12-16): index bytes -> the three bf16 B
    // tiles. Chunk q is row k's 16-byte chunk c (8 columns) of each tile,
    // stored at chunk c ^ (k % 8) of its 64-column box (the 128-byte
    // swizzle): eight neighbouring threads fill one 128-byte row, no
    // conflicts. A thread takes PER chunks, DECODE_THREADS apart, and
    // issues all their loads before its first store.
    constexpr int CPR = BN / 8, PER = WG_BK * CPR / DECODE_THREADS;
    static_assert(PER * DECODE_THREADS == WG_BK * CPR, "chunks per thread");
    const int t = threadIdx.x - (warp < 4 ? 32 : 288);
    for (int i = 0; i < nkb; ++i) {
      const int s = i % S, b = i % SB;
      wg::wait_or_trap(loaded(s), (i / S) & 1);
      wg::wait_or_trap(consumed(b), ((i / SB) & 1) ^ 1);
      const uint8_t* const gi = gbase + s * Cfg::LD_BYTES + Cfg::A_BYTES;
      uint8_t* const gb = gbase + (bbase - base) + b * Cfg::B_BYTES;
      const int k_left = K - (kb0 + i) * WG_BK;   // rows past K stay 0
      uint2 ids[PER], e[PER][8];
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        const int q = t + u * DECODE_THREADS;
        ids[u] = *reinterpret_cast<const uint2*>(gi + (q / CPR) * BN +
                                                 8 * (q % CPR));
      }
#pragma unroll
      for (int u = 0; u < PER; ++u)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          e[u][j] = table[((j < 4 ? ids[u].x : ids[u].y) >> (8 * (j % 4))) &
                          0xFF];
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        const int q = t + u * DECODE_THREADS, k = q / CPR, c = q % CPR;
        const bool live = k < k_left;
        uint32_t w[3][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint2 e0 = e[u][2 * j], e1 = e[u][2 * j + 1];
          w[0][j] = live ? __byte_perm(e0.x, e1.x, 0x5410) : 0u;
          w[1][j] = live ? __byte_perm(e0.x, e1.x, 0x7632) : 0u;
          w[2][j] = live ? __byte_perm(e0.y, e1.y, 0x5410) : 0u;
        }
        const int off =
            (c / 8) * BOX_BYTES + k * 128 + (((c % 8) ^ (k % 8)) << 4);
#pragma unroll
        for (int tt = 0; tt < 3; ++tt)
          *reinterpret_cast<uint4*>(gb + tt * Cfg::B_TILE + off) =
              make_uint4(w[tt][0], w[tt][1], w[tt][2], w[tt][3]);
      }
      wg::fence_proxy_async();
      wg::mbar_arrive(decoded(b));
    }
  } else {
    // ---- consumers: warpgroup c owns rows [64c, 64c + 64) of the tile
    const int c = warp / 4 - 1;
    float acc[BN / 2];
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) acc[j] = 0.0f;
    for (int i = 0; i < nkb; ++i) {
      const int s = i % S, b = i % SB;
      wg::wait_or_trap(loaded(s), (i / S) & 1);
      wg::wait_or_trap(decoded(b), (i / SB) & 1);
      const uint32_t sa = base + s * Cfg::LD_BYTES + c * BOX_BYTES;
      const uint32_t sb = bbase + b * Cfg::B_BYTES;
      wg::fence_operands(acc);
      wg::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WG_BK / 16; ++kk) {
        // x plane pa times codeword term tb, for pa + tb < 3
#pragma unroll
        for (int pa = 0; pa < P; ++pa) {
#pragma unroll
          for (int tb = 0; pa + tb < 3; ++tb) {
            const uint64_t da =
                A_KM ? wg::desc(sa + pa * PLANE_BYTES + 32 * kk, 16, 1024)
                     : wg::desc(sa + 2048 * kk, BOX_BYTES, 1024);
            const uint64_t db =
                wg::desc(sb + tb * Cfg::B_TILE + 2048 * kk, BOX_BYTES, 1024);
            if constexpr (BN == 128)
              wg::mma_m64n128k16<A_KM ? 0 : 1, 1>(acc, da, db);
            else
              wg::mma_m64n64k16<A_KM ? 0 : 1, 1>(acc, da, db);
          }
        }
      }
      wg::wgmma_commit();
      wg::fence_operands(acc);
      // the previous step's products are done: release its stages
      wg::wgmma_wait<1>();
      wg::fence_operands(acc);
      if (i > 0) {
        wg::mbar_arrive(freed((i - 1) % S));
        wg::mbar_arrive(consumed((i - 1) % SB));
      }
    }
    wg::wgmma_wait<0>();
    wg::fence_operands(acc);

    // accumulator fragment: d[4j + 2h + e] is (row + 8h, col + 8j + e)
    const int row = m0 + 64 * c + 16 * (warp % 4) + lane / 4;
    const int col = n0 + 2 * (lane % 4);
    const bool pair = N % 2 == 0;
    TO* const o = static_cast<TO*>(out);
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
            store2<float>(p, v0, v1);
          } else {
            p[0] = v0;
            if (cc + 1 < N) p[1] = v1;
          }
        } else {
          TO* p = o + (long long)r * N + cc;
          if (pair) {
            store2<TO>(p, v0, v1);
          } else {
            p[0] = from_f32<TO>(v0);
            if (cc + 1 < N) p[1] = from_f32<TO>(v1);
          }
        }
      }
    }
  }
}

// out = the sum of the splits' partials, in split order, in out's dtype.
template <typename TO>
__global__ void codebook_matmul_kernel_splitk_sum(const float* __restrict__ ws,
                                                  int splits,
                                                  TO* __restrict__ out,
                                                  long long total) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    float v = 0.0f;
    for (int s = 0; s < splits; ++s) v += ws[s * total + e];
    out[e] = from_f32<TO>(v);
  }
}

// f32 x (M, K), read through its strides, as three bf16 planes of a
// (3, M, ldk) workspace: x = x1 + x2 + x3, split as the codewords are.
// Row-major x with K a multiple of 4 (aligned) goes four elements a
// thread: one 16-byte load, one 8-byte store a plane.
__global__ void codebook_matmul_kernel_split_x(const float* __restrict__ x,
                                               long long sxm, long long sxk,
                                               uint16_t* __restrict__ xs,
                                               long long ldk, int M, int K) {
  const long long plane = (long long)M * ldk;
  const long long step = (long long)gridDim.x * blockDim.x;
  const long long first = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (sxk == 1 && K % 4 == 0 && sxm % 4 == 0 &&
      reinterpret_cast<uintptr_t>(x) % 16 == 0) {
    const int q = K / 4;
    for (long long e = first; e < (long long)M * q; e += step) {
      const long long m = e / q, k = 4 * (e % q);
      const float4 v = *reinterpret_cast<const float4*>(x + m * sxm + k);
      const uint2 t0 = split3(v.x), t1 = split3(v.y), t2 = split3(v.z),
                  t3 = split3(v.w);
      uint2* const p = reinterpret_cast<uint2*>(xs + m * ldk + k);
      p[0] = make_uint2(__byte_perm(t0.x, t1.x, 0x5410),
                        __byte_perm(t2.x, t3.x, 0x5410));
      p[plane / 4] = make_uint2(__byte_perm(t0.x, t1.x, 0x7632),
                                __byte_perm(t2.x, t3.x, 0x7632));
      p[plane / 2] = make_uint2(__byte_perm(t0.y, t1.y, 0x5410),
                                __byte_perm(t2.y, t3.y, 0x5410));
    }
    return;
  }
  const bool k_unit = sxk == 1;     // walk along x's unit stride
  for (long long e = first; e < (long long)M * K; e += step) {
    const long long m = k_unit ? e / K : e % M, k = k_unit ? e % K : e / M;
    const uint2 t = split3(x[m * sxm + k * sxk]);
    uint16_t* const p = xs + m * ldk + k;
    p[0] = (uint16_t)(t.x & 0xFFFF);
    p[plane] = (uint16_t)(t.x >> 16);
    p[2 * plane] = (uint16_t)t.y;
  }
}

// idx (K, N), read through its strides, as row-major bytes (K, ldn): the
// codeword id the oracle's gather reads for each index. Row-major idx
// with N a multiple of 4 (aligned) goes four indices a thread.
template <typename TI>
__global__ void codebook_matmul_kernel_narrow(const TI* __restrict__ idx,
                                              long long si_k, long long si_n,
                                              uint8_t* __restrict__ ids,
                                              long long ldn, int K, int N,
                                              int n_codes) {
  const long long step = (long long)gridDim.x * blockDim.x;
  const long long first = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (si_n == 1 && N % 4 == 0 && si_k % 4 == 0 &&
      reinterpret_cast<uintptr_t>(idx) % (4 * sizeof(TI)) == 0) {
    using V = typename std::conditional<sizeof(TI) == 1, char4, int4>::type;
    const int q = N / 4;
    for (long long e = first; e < (long long)K * q; e += step) {
      const long long k = e / q, n = 4 * (e % q);
      const V v = *reinterpret_cast<const V*>(idx + k * si_k + n);
      *reinterpret_cast<uint32_t*>(ids + k * ldn + n) =
          (uint32_t)clamp_index((int)v.x, n_codes) |
          (uint32_t)clamp_index((int)v.y, n_codes) << 8 |
          (uint32_t)clamp_index((int)v.z, n_codes) << 16 |
          (uint32_t)clamp_index((int)v.w, n_codes) << 24;
    }
    return;
  }
  const bool n_unit = si_n == 1;
  for (long long e = first; e < (long long)K * N; e += step) {
    const long long k = n_unit ? e / N : e % K, n = n_unit ? e % N : e / K;
    ids[k * ldn + n] =
        (uint8_t)clamp_index((int)idx[k * si_k + n * si_n], n_codes);
  }
}

int grid_for(long long total) {
  const long long blocks = (total + 255) / 256;
  return (int)(blocks < 4096 ? blocks : 4096);
}

template <int P, bool A_KM, int BN>
int launch_wgmma_as(const CUtensorMap& ta, const CUtensorMap& ti,
                    const float* codebook, int n_codes, int idx_signed,
                    void* out, float* ws, int M, int N, int K, int splits,
                    cudaStream_t stream) {
  auto kernel = codebook_matmul_kernel_wgmma<P, A_KM, BN>;
  constexpr int smem = CbCfg<P, BN>::SMEM;
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
  const long long tiles =
      (long long)((M + WG_BM - 1) / WG_BM) * ((N + BN - 1) / BN);
  if (tiles > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, 1, splits);
  kernel<<<grid, WG_THREADS, smem, stream>>>(ta, ti, codebook, n_codes,
                                             idx_signed, out,
                                             splits > 1 ? ws : nullptr, M, N,
                                             K, per);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  using TO = typename std::conditional<P == 1, bf16, float>::type;
  const long long total = (long long)M * N;
  codebook_matmul_kernel_splitk_sum<TO><<<grid_for(total), 256, 0, stream>>>(
      ws, splits, (TO*)out, total);
  return (int)cudaGetLastError();
}

int launch_wgmma(int x_dtype, const void* x, long long sxm, long long sxk,
                 int idx_dtype, const void* idx, long long si_k,
                 long long si_n, const void* codebook, int n_codes,
                 void* out, void* xs, long long ldk, void* ids,
                 long long ldn, void* ws, int M, int N, int K, int bn,
                 int splits, cudaStream_t stream) {
  using wgmma_gemm::encode_bf16;
  const bool a_km = sxk == 1;
  const bool direct = idx_dtype == 0 && si_n == 1;   // bytes read in place
  if ((!a_km && sxm != 1) || (si_n != 1 && si_k != 1) ||
      (bn != 64 && bn != 128) || splits < 1 || splits > 65535 || K < 1 ||
      (splits > 1 && ws == nullptr) ||
      (x_dtype == 0 && (xs == nullptr || ldk < K || ldk % 8 != 0)) ||
      (!direct && (ids == nullptr || ldn < N || ldn % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  CUtensorMap ta, ti;
  int rc = x_dtype == 0 ? encode_bf16(&ta, xs, K, 3LL * M, ldk, WG_BM)
           : a_km       ? encode_bf16(&ta, x, K, M, sxm, WG_BM)
                        : encode_bf16(&ta, x, M, K, sxk, 64);
  if (rc == 0)
    rc = wgmma_gemm::encode_2d(&ti, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                               direct ? idx : ids, N, K,
                               direct ? si_k : ldn, bn, WG_BK,
                               CU_TENSOR_MAP_SWIZZLE_NONE);
  if (rc != 0) return rc;
  if (x_dtype == 0) {
    codebook_matmul_kernel_split_x<<<grid_for((long long)M * K), 256, 0,
                                     stream>>>((const float*)x, sxm, sxk,
                                               (uint16_t*)xs, ldk, M, K);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (!direct) {
    const int blocks = grid_for((long long)K * N);
    if (idx_dtype == 0)
      codebook_matmul_kernel_narrow<int8_t><<<blocks, 256, 0, stream>>>(
          (const int8_t*)idx, si_k, si_n, (uint8_t*)ids, ldn, K, N, n_codes);
    else
      codebook_matmul_kernel_narrow<int32_t><<<blocks, 256, 0, stream>>>(
          (const int32_t*)idx, si_k, si_n, (uint8_t*)ids, ldn, K, N, n_codes);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const float* cb = (const float*)codebook;
  const int sg = direct;
#define CB_GO(P, AK, BNV)                                                    \
  return launch_wgmma_as<P, AK, BNV>(ta, ti, cb, n_codes, sg, out,           \
                                     (float*)ws, M, N, K, splits, stream)
  if (bn == 128) {
    if (x_dtype == 0) CB_GO(3, true, 128);
    if (a_km) CB_GO(1, true, 128);
    CB_GO(1, false, 128);
  }
  if (x_dtype == 0) CB_GO(3, true, 64);
  if (a_km) CB_GO(1, true, 64);
  CB_GO(1, false, 64);
#undef CB_GO
}

}  // namespace

// x_dtype: 0 f32, 1 bf16; idx_dtype: 0 int8, 1 int32. Strides are in
// elements, one of each operand's two is 1; out is (M, N) row-major in
// x's dtype. Returns the launch's cudaError_t.
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

// The wgmma route: x_dtype 0 f32 (xs: a (3, M, ldk) bf16 workspace for
// its planes, ldk >= K a multiple of 8), 1 bf16; idx_dtype 0 int8, 1
// int32. int8 idx with unit stride along N is read in place; any other
// idx is narrowed into `ids`, a (K, ldn) byte workspace (ldn >= N a
// multiple of 16). x and idx as TMA reads them: 16-byte aligned bases,
// the other stride a multiple of 16 bytes. bn 64 or 128 and `splits`
// K-splits (ws an f32 (splits, M, N) scratch when splits > 1), as
// masked_matmul's wgmma route plans them. out is (M, N) row-major in x's
// dtype. Returns 0, a cudaError_t, or an encode failure (ENCODE_FAILED +
// CUresult, NO_ENCODER of wgmma_gemm.cuh).
extern "C" int codebook_matmul_wgmma_launch(
    int x_dtype, const void* x, long long sxm, long long sxk, int idx_dtype,
    const void* idx, long long si_k, long long si_n, const void* codebook,
    int n_codes, void* out, void* xs, long long ldk, void* ids,
    long long ldn, void* ws, int M, int N, int K, int bn, int splits,
    void* stream) {
  if (M < 1 || N < 1 || K < 1 || n_codes < 1 || n_codes > MAX_CODES ||
      (x_dtype != 0 && x_dtype != 1) || (idx_dtype != 0 && idx_dtype != 1))
    return (int)cudaErrorInvalidValue;
  return launch_wgmma(x_dtype, x, sxm, sxk, idx_dtype, idx, si_k, si_n,
                      codebook, n_codes, out, xs, ldk, ids, ldn, ws, M, N, K,
                      bn, splits, (cudaStream_t)stream);
}
