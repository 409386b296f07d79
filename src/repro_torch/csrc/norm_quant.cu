// RMSNorm fused with the int8 emit, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/fused_ln_quant.py::rms_quantize
// (body _norm_quant_kernel, kind="rms", emit=True): per token row,
//   q = clip(rint(x * rsqrt(mean(x^2) + eps) * (1 + gamma) / s_g) + z_g)
// with (G,) scales / zero-points over contiguous d/G column spans.
//
// Bound on the H100: bytes. A row is read once (f32 or bf16) and written
// once as int8; the arithmetic is a handful of flops per element. Design:
// one block per row, so the row's sum of squares is a block reduction
// (warp shuffles, then one shared-memory step) and the normalized f32 row
// never leaves registers: each thread re-reads its own strided elements
// (an L1/L2 hit) for the emit pass. Float order follows the reference:
// (x * r) * (1 + g), then true division by s_g, half-to-even rint, + z_g,
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

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void rms_quantize_kernel(const T* __restrict__ x,
                                    const float* __restrict__ gamma,
                                    const float* __restrict__ scale,
                                    const float* __restrict__ zp,
                                    int8_t* __restrict__ out, int d,
                                    int group_size, float eps, float qmin,
                                    float qmax) {
  __shared__ float partial[32];
  const T* xr = x + (size_t)blockIdx.x * d;
  int8_t* orow = out + (size_t)blockIdx.x * d;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  float ss = 0.f;
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    float v = load_f(xr, j);
    ss += v * v;
  }
  ss = warp_sum(ss);
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float v = lane < nwarps ? partial[lane] : 0.f;
    v = warp_sum(v);
    if (lane == 0) partial[0] = v;
  }
  __syncthreads();
  const float r = rsqrtf(partial[0] / (float)d + eps);

  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    const int g = j / group_size;
    float y = load_f(xr, j) * r * (1.f + gamma[j]);
    float q = rintf(y / scale[g]) + zp[g];
    q = fminf(fmaxf(q, qmin), qmax);
    orow[j] = (int8_t)q;
  }
}

}  // namespace

// x: (rows, d) f32 (x_is_bf16 = 0) or bf16 (x_is_bf16 = 1), contiguous;
// gamma (d,) f32; scale/zp (G,) f32 with d % G == 0; out (rows, d) int8.
// threads: a multiple of 32, at most 1024. Returns cudaGetLastError().
extern "C" int rms_quantize(const void* x, int x_is_bf16, const void* gamma,
                            const void* scale, const void* zp, void* out,
                            int rows, int d, int groups, float eps, int qmin,
                            int qmax, int threads, void* stream) {
  if (rows > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    const int gs = d / groups;
    if (x_is_bf16)
      rms_quantize_kernel<__nv_bfloat16><<<rows, threads, 0, s>>>(
          (const __nv_bfloat16*)x, (const float*)gamma, (const float*)scale,
          (const float*)zp, (int8_t*)out, d, gs, eps, (float)qmin, (float)qmax);
    else
      rms_quantize_kernel<float><<<rows, threads, 0, s>>>(
          (const float*)x, (const float*)gamma, (const float*)scale,
          (const float*)zp, (int8_t*)out, d, gs, eps, (float)qmin, (float)qmax);
  }
  return (int)cudaGetLastError();
}
