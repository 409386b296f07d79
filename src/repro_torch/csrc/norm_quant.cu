// RMSNorm / LayerNorm fused with quantization, for Hopper (sm_90a).
//
// Replaces the four TPU kernels of src/repro/kernels/fused_ln_quant.py, one
// Pallas body (_norm_quant_kernel) with two switches, kept here as template
// flags:
//   LN = false, RMSNorm:   y = x * rsqrt(mean(x^2) + eps) * (1 + gamma)
//   LN = true,  LayerNorm: y = (x - mu) * rsqrt(mean((x - mu)^2) + eps)
//                              * gamma + beta,  mu = mean(x)
// then q = clip(rint(y / s_g) + z_g, qmin, qmax) with (G,) scales /
// zero-points over contiguous d/G column spans, and
//   EMIT = true:  q as int8            (rms_quantize, ln_quantize)
//   EMIT = false: (q - z_g) * s_g in x's dtype, bf16 rounded to nearest
//                 even at the store    (rms_fake_quant, ln_fake_quant).
//
// Bound on the H100: bytes. A row is read once (f32 or bf16) and written
// once; the arithmetic is a handful of flops per element. Design: one block
// per row, so each row statistic is a block reduction (warp shuffles, then
// one shared-memory step) and the normalized f32 row never leaves the SM:
// each thread re-reads its own strided elements (an L1/L2 hit) for the next
// pass. LayerNorm keeps the reference's two reductions (the mean, then the
// mean of (x - mu)^2), not a one-pass Welford update, which would change
// the float order. Float order follows the reference: ((x - mu) * r) * g +
// b or (x * r) * (1 + g), true division by s_g, half-to-even rint, + z_g,
// clamp. Built without fast math and without FMA contraction, so only the
// reduction order and rsqrtf's last bit can differ from the plain version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load_f(const float* p, int i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, int i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f(float* p, size_t i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store_f(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum of v over the block (every thread gets it). partial: 32 floats.
__device__ __forceinline__ float block_sum(float v, float* partial) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = warp_sum(v);
  __syncthreads();                 // partial[0] of an earlier call is read
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < nwarps ? partial[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) partial[0] = t;
  }
  __syncthreads();
  return partial[0];
}

template <typename T, bool LN, bool EMIT>
__global__ void norm_quant_kernel(const T* __restrict__ x,
                                  const float* __restrict__ gamma,
                                  const float* __restrict__ beta,
                                  const float* __restrict__ scale,
                                  const float* __restrict__ zp,
                                  void* __restrict__ out, int d,
                                  int group_size, float eps, float qmin,
                                  float qmax) {
  __shared__ float partial[32];
  const T* xr = x + (size_t)blockIdx.x * d;

  float mu = 0.f;
  if (LN) {
    float s = 0.f;
    for (int j = threadIdx.x; j < d; j += blockDim.x) s += load_f(xr, j);
    mu = block_sum(s, partial) / (float)d;
  }
  float ss = 0.f;
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    const float v = LN ? load_f(xr, j) - mu : load_f(xr, j);
    ss += v * v;
  }
  const float r = rsqrtf(block_sum(ss, partial) / (float)d + eps);

  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    const int g = j / group_size;
    const float y = LN ? (load_f(xr, j) - mu) * r * gamma[j] + beta[j]
                       : load_f(xr, j) * r * (1.f + gamma[j]);
    float q = rintf(y / scale[g]) + zp[g];
    q = fminf(fmaxf(q, qmin), qmax);
    const size_t o = (size_t)blockIdx.x * d + j;
    if (EMIT)
      ((int8_t*)out)[o] = (int8_t)q;
    else
      store_f((T*)out, o, (q - zp[g]) * scale[g]);
  }
}

template <typename T, bool LN>
void launch(const void* x, const void* gamma, const void* beta,
            const void* scale, const void* zp, void* out, int rows, int d,
            int gs, float eps, float qmin, float qmax, int threads, int emit,
            cudaStream_t s) {
  if (emit)
    norm_quant_kernel<T, LN, true><<<rows, threads, 0, s>>>(
        (const T*)x, (const float*)gamma, (const float*)beta,
        (const float*)scale, (const float*)zp, out, d, gs, eps, qmin, qmax);
  else
    norm_quant_kernel<T, LN, false><<<rows, threads, 0, s>>>(
        (const T*)x, (const float*)gamma, (const float*)beta,
        (const float*)scale, (const float*)zp, out, d, gs, eps, qmin, qmax);
}

}  // namespace

// x: (rows, d) f32 (x_is_bf16 = 0) or bf16 (x_is_bf16 = 1), contiguous;
// gamma (d,) f32; beta (d,) f32 (LayerNorm only, else may be null);
// scale/zp (G,) f32 with d % G == 0; out (rows, d): int8 when emit = 1,
// x's dtype when emit = 0. ln = 1: LayerNorm, 0: RMSNorm. threads: a
// multiple of 32, at most 1024. Returns cudaGetLastError().
extern "C" int norm_quant(const void* x, int x_is_bf16, const void* gamma,
                          const void* beta, const void* scale, const void* zp,
                          void* out, int rows, int d, int groups, float eps,
                          int qmin, int qmax, int threads, int ln, int emit,
                          void* stream) {
  if (rows > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    const int gs = d / groups;
    const float lo = (float)qmin, hi = (float)qmax;
    if (x_is_bf16 && ln)
      launch<__nv_bfloat16, true>(x, gamma, beta, scale, zp, out, rows, d, gs,
                                  eps, lo, hi, threads, emit, s);
    else if (x_is_bf16)
      launch<__nv_bfloat16, false>(x, gamma, beta, scale, zp, out, rows, d,
                                   gs, eps, lo, hi, threads, emit, s);
    else if (ln)
      launch<float, true>(x, gamma, beta, scale, zp, out, rows, d, gs, eps,
                          lo, hi, threads, emit, s);
    else
      launch<float, false>(x, gamma, beta, scale, zp, out, rows, d, gs, eps,
                           lo, hi, threads, emit, s);
  }
  return (int)cudaGetLastError();
}
