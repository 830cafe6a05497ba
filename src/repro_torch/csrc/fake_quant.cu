// Fake quantization onto a (1, e, m) float format for Hopper (sm_90a):
// round-to-nearest-even onto the format's representable set (normals, the
// subnormal grid below emin, saturation at the largest finite value, no
// inf/nan codes), stored as f32. Non-finite inputs pass through.
//
// Replaces the TPU kernel src/repro/kernels/fake_quant/kernel.py
// (fake_quant_2d, body _fake_quant_kernel): the rounding of every
// quantized compressible leaf in compress_with_masks / compress_params
// and of the FL round's upload quantization.
//
// Bound: bytes. 4 bytes read and 4 written per element against a handful
// of ALU operations, so the card's memory rate is the limit. One thread
// per element over the flattened contiguous tensor, grid-stride, no
// padding (the TPU wrapper padded to (256, 512) tiles).
//
// Numerics: bitwise the port's plain quantize_em
// (src/repro_torch/numerics/float_formats.py) on every f32 input,
// subnormals, +-0, +-inf, NaN and values past saturation included:
//   - the exponent comes from frexpf, which is exact for f32 subnormals,
//     floored at emin;
//   - the quantum 2^(ex-m) is built from its bit pattern, normal or
//     subnormal, as numerics.pow2 builds it;
//   - x / quantum and r * quantum are __fdiv_rn / __fmul_rn, rintf rounds
//     half to even.
// Build without -ftz=true and without --use_fast_math: a flushed
// subnormal would change the result.
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ float pow2_exact(int e) {
  // normals for e in [-126, 127], the subnormal grid down to 2^-149, 0 below
  if (e >= -126) {
    const int c = e > 127 ? 127 : e;
    return __int_as_float((c + 127) << 23);
  }
  if (e >= -149) return __int_as_float(1 << (e + 149));
  return 0.0f;
}

__global__ void fake_quant_kernel(const float* __restrict__ x,
                                  float* __restrict__ out, long long n,
                                  int emin, int m_bits, float maxv) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float v = x[i];
    // clamp that keeps NaN (fminf/fmaxf would drop it)
    const float xc = v > maxv ? maxv : (v < -maxv ? -maxv : v);
    int e2;
    frexpf(fabsf(xc), &e2);
    const int ex = (e2 - 1) > emin ? (e2 - 1) : emin;
    const float quantum = pow2_exact(ex - m_bits);
    const float q = __fmul_rn(rintf(__fdiv_rn(xc, quantum)), quantum);
    out[i] = isfinite(v) ? q : v;
  }
}

// Returns the launch's cudaError_t (0 on success). maxv is +inf for the
// e = 8 formats, whose largest finite value overflows f32.
extern "C" int fake_quant_launch(const void* x, void* out, long long n,
                                 int emin, int m_bits, float maxv,
                                 void* stream) {
  if (n < 0 || m_bits < 0 || m_bits > 23) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;    // grid-stride beyond 32 per SM
  fake_quant_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, n, emin, m_bits, maxv);
  return (int)cudaGetLastError();
}
