// Per-embedding-group quantize (the int8 emit of paper eq. 5), for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/peg_quant.py::peg_quantize
// (body _peg_quantize_kernel): q = clip(rint(x / s_g) + z_g) per contiguous
// group of d/G columns, emitted as int8.
//
// Bound on the H100: bytes (4 or 2 bytes read, 1 written per element, a
// division and a rint). Design: an elementwise pass, four consecutive
// elements per thread (one 16-byte load for f32 rows whose width is a
// multiple of 4, one 4-byte store), the group's (s, z) picked by column.
// True division and half-to-even rint keep the reference semantics; the
// build has no fast math, so the result equals the plain version exactly.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load_f(const float* p, long i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, long i) {
  return __bfloat162float(p[i]);
}

__device__ __forceinline__ int8_t quant(float v, long col, int gs,
                                        const float* scale, const float* zp,
                                        float qmin, float qmax) {
  const int g = (int)(col / gs);
  float q = rintf(v / scale[g]) + zp[g];
  return (int8_t)fminf(fmaxf(q, qmin), qmax);
}

template <typename T>
__global__ void peg_quantize_kernel(const T* __restrict__ x,
                                    const float* __restrict__ scale,
                                    const float* __restrict__ zp,
                                    int8_t* __restrict__ out, long n, int d,
                                    int gs, float qmin, float qmax, int vec) {
  const long base = ((long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (base >= n) return;
  if (vec) {  // f32, d % 4 == 0, 16-byte aligned rows: one row, one vector
    const float4 v = *reinterpret_cast<const float4*>((const float*)x + base);
    const long c = base % d;
    char4 q;
    q.x = quant(v.x, c, gs, scale, zp, qmin, qmax);
    q.y = quant(v.y, c + 1, gs, scale, zp, qmin, qmax);
    q.z = quant(v.z, c + 2, gs, scale, zp, qmin, qmax);
    q.w = quant(v.w, c + 3, gs, scale, zp, qmin, qmax);
    *reinterpret_cast<char4*>(out + base) = q;
    return;
  }
  for (long i = base; i < base + 4 && i < n; ++i)
    out[i] = quant(load_f(x, i), i % d, gs, scale, zp, qmin, qmax);
}

}  // namespace

// x: (rows, d) f32 or bf16, contiguous; scale/zp (G,) f32 with d % G == 0;
// out (rows, d) int8. vec = 1 only for f32, d % 4 == 0 and 16-byte aligned
// x / 4-byte aligned out. Returns cudaGetLastError().
extern "C" int peg_quantize(const void* x, int x_is_bf16, const void* scale,
                            const void* zp, void* out, long n, int d,
                            int groups, int qmin, int qmax, int vec,
                            void* stream) {
  if (n > 0) {
    const int threads = 256;
    const long blocks = (n + 4L * threads - 1) / (4L * threads);
    cudaStream_t s = (cudaStream_t)stream;
    const int gs = d / groups;
    if (x_is_bf16)
      peg_quantize_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
          (const __nv_bfloat16*)x, (const float*)scale, (const float*)zp,
          (int8_t*)out, n, d, gs, (float)qmin, (float)qmax, 0);
    else
      peg_quantize_kernel<float><<<blocks, threads, 0, s>>>(
          (const float*)x, (const float*)scale, (const float*)zp,
          (int8_t*)out, n, d, gs, (float)qmin, (float)qmax, vec);
  }
  return (int)cudaGetLastError();
}
