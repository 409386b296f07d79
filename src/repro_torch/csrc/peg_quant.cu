// Per-embedding-group quantize (paper eq. 5), for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/peg_quant.py: q =
// clip(rint(x / s_g) + z_g, qmin, qmax) per contiguous group of d/G columns,
//   EMIT = true:  q as int8 (peg_quantize, body _peg_quantize_kernel);
//   EMIT = false: (q - z_g) * s_g in x's dtype, bf16 rounded to nearest even
//                 at the store (peg_fake_quant, body _peg_fakequant_kernel).
//
// Bound on the H100: bytes (4 or 2 bytes read, 1, 2 or 4 written per
// element, a division and a rint). Design: an elementwise pass, four
// consecutive elements per thread (for f32 rows whose width is a multiple
// of 4: one 16-byte load and one 4- or 16-byte store), the group's (s, z)
// picked by column. True division and half-to-even rint keep the reference
// semantics; the build has no fast math and no FMA contraction, so the
// result equals the plain version exactly.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load_f(const float* p, long i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f(float* p, long i, float v) { p[i] = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, long i, float v) {
  p[i] = __float2bfloat16(v);
}

// The quantized value q of v at column col (a float on [qmin, qmax]), and
// its group's (s, z).
__device__ __forceinline__ float quant(float v, long col, int gs,
                                       const float* scale, const float* zp,
                                       float qmin, float qmax, float* s,
                                       float* z) {
  const int g = (int)(col / gs);
  *s = scale[g];
  *z = zp[g];
  return fminf(fmaxf(rintf(v / *s) + *z, qmin), qmax);
}

template <typename T, bool EMIT>
__global__ void peg_quant_kernel(const T* __restrict__ x,
                                 const float* __restrict__ scale,
                                 const float* __restrict__ zp,
                                 void* __restrict__ out, long n, int d,
                                 int gs, float qmin, float qmax, int vec) {
  const long base = ((long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (base >= n) return;
  if (vec) {  // f32, d % 4 == 0, 16-byte aligned rows: one row, one vector
    const float4 v = *reinterpret_cast<const float4*>((const float*)x + base);
    const long c = base % d;
    const float in[4] = {v.x, v.y, v.z, v.w};
    float q[4], s[4], z[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      q[e] = quant(in[e], c + e, gs, scale, zp, qmin, qmax, &s[e], &z[e]);
    if (EMIT) {
      char4 o;
      o.x = (int8_t)q[0];
      o.y = (int8_t)q[1];
      o.z = (int8_t)q[2];
      o.w = (int8_t)q[3];
      *reinterpret_cast<char4*>((int8_t*)out + base) = o;
    } else {
      *reinterpret_cast<float4*>((float*)out + base) = make_float4(
          (q[0] - z[0]) * s[0], (q[1] - z[1]) * s[1], (q[2] - z[2]) * s[2],
          (q[3] - z[3]) * s[3]);
    }
    return;
  }
  for (long i = base; i < base + 4 && i < n; ++i) {
    float s, z;
    const float q = quant(load_f(x, i), i % d, gs, scale, zp, qmin, qmax, &s,
                          &z);
    if (EMIT)
      ((int8_t*)out)[i] = (int8_t)q;
    else
      store_f((T*)out, i, (q - z) * s);
  }
}

template <typename T>
void launch(const void* x, const void* scale, const void* zp, void* out,
            long n, int d, int gs, float qmin, float qmax, int vec, int emit,
            long blocks, int threads, cudaStream_t s) {
  if (emit)
    peg_quant_kernel<T, true><<<blocks, threads, 0, s>>>(
        (const T*)x, (const float*)scale, (const float*)zp, out, n, d, gs,
        qmin, qmax, vec);
  else
    peg_quant_kernel<T, false><<<blocks, threads, 0, s>>>(
        (const T*)x, (const float*)scale, (const float*)zp, out, n, d, gs,
        qmin, qmax, vec);
}

}  // namespace

// x: (rows, d) f32 or bf16, contiguous, n = rows * d; scale/zp (G,) f32 with
// d % G == 0; out (rows, d): int8 when emit = 1, x's dtype when emit = 0.
// vec = 1 only for f32, d % 4 == 0, 16-byte aligned x and out.
// Returns cudaGetLastError().
extern "C" int peg_quant(const void* x, int x_is_bf16, const void* scale,
                         const void* zp, void* out, long n, int d, int groups,
                         int qmin, int qmax, int vec, int emit, void* stream) {
  if (n > 0) {
    const int threads = 256;
    const long blocks = (n + 4L * threads - 1) / (4L * threads);
    cudaStream_t s = (cudaStream_t)stream;
    const int gs = d / groups;
    if (x_is_bf16)
      launch<__nv_bfloat16>(x, scale, zp, out, n, d, gs, (float)qmin,
                            (float)qmax, 0, emit, blocks, threads, s);
    else
      launch<float>(x, scale, zp, out, n, d, gs, (float)qmin, (float)qmax,
                    vec, emit, blocks, threads, s);
  }
  return (int)cudaGetLastError();
}
