// s8 x s8 -> s32 matmuls with the fused deployment epilogue, for Hopper.
//
// Replaces two TPU kernels of src/repro/kernels/int8_matmul.py:
//   * int8_matmul      (_int8_matmul_kernel + _epilogue), paper eq. 3:
//       f = (f32(A @ W) - z_a * colsum) * (s_a * s_w)
//   * int8_matmul_peg  (_int8_matmul_peg_kernel + _epilogue), eq. 4 -> 5:
//       f = (sum_g s_g * (f32(A_g @ W_g) - z_g * colsum_g)) * s_w
// followed by the shared epilogue: + bias, activation (tanh GELU, SiLU,
// ReLU), * mul, then optionally the int8 requant clip(rint(f/s_o) + z_o).
//
// Bound on the H100: at decode (M = lanes, 1-16 rows) the weight read is
// everything, so bytes bound it; at prefill (M = B*T) the int8 tensor-core
// rate starts to matter. Design, kept simple: a 64x64 output tile per
// 128-thread block (4 warps of 32x32), a 64-deep K tile staged through
// shared memory with the next tile's global loads issued into registers
// before the current tile's mma.sync.m16n8k32 (s8.s8.s32) steps. The B
// operand wants four consecutive k per 32-bit register, so the W tile is
// transposed to [n][k] while it is stored to shared memory. Every edge is
// masked (zero fill), so M, N and K need no padding: K = 2304 is not a
// multiple of any power-of-two K tile. PEG groups walk the K loop group by
// group, each group's tiles masked at its own end (a 16-wide group is one
// zero-padded tile), with one int32 partial per group folded into the f32
// accumulator in group order g = 0..G-1. The int32 sums are exact; the
// float epilogue keeps the reference's operation order, and the build has
// no fast math and no FMA contraction.
//
// 4-bit weights (w_bits = 4, the TPU kernels' w_bits=4 mode): W arrives as
// (K/2, N) pairwise-row nibbles, packed row r holding rows 2r (low nibble)
// and 2r+1 (high). The unpack happens while the W tile is stored to shared
// memory: a thread's k-quad 4q..4q+3 of a column is exactly the two packed
// bytes of rows 2q and 2q+1, which sign-extend into one B word, so the
// mma loop and the epilogue are the 8-bit ones. A 64-deep K tile reads 32
// packed rows (half the weight bytes); K tiles and PEG groups start at even
// k (the pack-time gate keeps group sizes even), so no byte is split, and
// the K tail is masked on packed rows. Not yet done here: wgmma/TMA,
// split-K for small-M decode.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 64, THREADS = 128;
constexpr int AS_STRIDE = BK + 16;      // bytes per A row in shared memory
constexpr int BS_STRIDE = BK / 4 + 4;   // 32-bit words per B column

enum Act { ACT_NONE = 0, ACT_GELU = 1, ACT_SILU = 2, ACT_RELU = 3 };

struct Params {
  const int8_t* a;          // (M, K)
  const int8_t* w;          // (K, N)
  const int32_t* colsum;    // (G, N) or null (per-tensor without zero-point)
  const float* a_scales;    // (G,)
  const float* a_zps;       // (G,) or null
  const float* w_scale;     // (1,)
  const float* bias;        // (N,) or null
  const float* mul;         // (M, N) or null
  const float* out_scale;   // (1,) or null: f32 output
  const float* out_zp;      // (1,) or null
  void* out;                // (M, N) f32 or int8
  int M, N, K, G, peg, act, vec_a, vec_w;   // w: (K/2, N) when W4
  float qmin, qmax;
};

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float activation(float x, int act) {
  switch (act) {
    case ACT_GELU:  // jax.nn.gelu(approximate=True), same operation order
      return x * (0.5f * (1.0f + tanhf(0.7978845608028654f *
                                       (x + 0.044715f * (x * x * x)))));
    case ACT_SILU:
      return x * (1.0f / (1.0f + expf(-x)));
    case ACT_RELU:
      return fmaxf(x, 0.0f);
    default:
      return x;
  }
}

// Global -> register staging for one K tile: A as 2 x 16 bytes per thread,
// W as a 4 (k) x 8 (n) byte block per thread (W4: 2 packed rows x 8 n).
struct Stage {
  int4 a[2];
  uint32_t w[4][2];
};

// One int4 nibble (0..15) sign-extended to an int8 byte.
__device__ __forceinline__ uint32_t sext4(uint32_t nib) {
  return (uint32_t)(((int)(nib ^ 8u) - 8) & 0xff);
}

template <bool W4>
__device__ __forceinline__ void load_tile(const Params& p, Stage& st, int m0,
                                          int n0, int k0, int k_hi) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * THREADS;       // 256 chunks of 16 bytes
    const int r = c >> 2, cc = (c & 3) * 16;
    const int gm = m0 + r, gk = k0 + cc;
    if (p.vec_a && gm < p.M && gk + 16 <= k_hi) {
      st.a[i] = *reinterpret_cast<const int4*>(p.a + (size_t)gm * p.K + gk);
    } else {
      uint32_t v[4] = {0u, 0u, 0u, 0u};
      if (gm < p.M)
        for (int e = 0; e < 16; ++e)
          if (gk + e < k_hi)
            v[e >> 2] |= (uint32_t)(uint8_t)p.a[(size_t)gm * p.K + gk + e]
                         << (8 * (e & 3));
      st.a[i] = make_int4((int)v[0], (int)v[1], (int)v[2], (int)v[3]);
    }
  }
  const int kq = tid >> 3, nc = (tid & 7) * 8;  // 16 k-quads x 8 n-chunks
  const int gn = n0 + nc;
#pragma unroll
  for (int r = 0; r < (W4 ? 2 : 4); ++r) {
    // row of W to read, and its first k (W4: packed row of k and k + 1)
    const int k_first = k0 + kq * 4 + (W4 ? 2 * r : r);
    const int kk = W4 ? k_first / 2 : k_first;
    if (p.vec_w && k_first < k_hi && gn + 8 <= p.N) {
      const uint2 v = *reinterpret_cast<const uint2*>(p.w + (size_t)kk * p.N + gn);
      st.w[r][0] = v.x;
      st.w[r][1] = v.y;
    } else {
      uint32_t v[2] = {0u, 0u};
      if (k_first < k_hi)
        for (int e = 0; e < 8; ++e)
          if (gn + e < p.N)
            v[e >> 2] |= (uint32_t)(uint8_t)p.w[(size_t)kk * p.N + gn + e]
                         << (8 * (e & 3));
      st.w[r][0] = v[0];
      st.w[r][1] = v[1];
    }
  }
}

template <bool W4>
__device__ __forceinline__ void store_tile(const Stage& st,
                                           int8_t (*As)[AS_STRIDE],
                                           uint32_t (*Bs)[BS_STRIDE]) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * THREADS;
    *reinterpret_cast<int4*>(&As[c >> 2][(c & 3) * 16]) = st.a[i];
  }
  const int kq = tid >> 3, nc = (tid & 7) * 8;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int h = e >> 2, sh = 8 * (e & 3);
    uint32_t word = 0u;
    if (W4) {   // packed bytes of k (kq*4, +1) and (kq*4 + 2, +3)
      const uint32_t b0 = (st.w[0][h] >> sh) & 0xffu;
      const uint32_t b1 = (st.w[1][h] >> sh) & 0xffu;
      word = sext4(b0 & 15u) | (sext4(b0 >> 4) << 8) |
             (sext4(b1 & 15u) << 16) | (sext4(b1 >> 4) << 24);
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        word |= ((st.w[r][h] >> sh) & 0xffu) << (8 * r);
    }
    Bs[nc + e][kq] = word;   // byte r = k (kq*4 + r), column nc + e
  }
}

template <bool W4>
__global__ void __launch_bounds__(THREADS)
int8_matmul_kernel(const Params p) {
  __shared__ __align__(16) int8_t As[BM][AS_STRIDE];
  __shared__ __align__(16) uint32_t Bs[BN][BS_STRIDE];

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int gq = lane >> 2, tq = lane & 3;

  const int gs = p.K / p.G;
  const int tiles_per_group = (gs + BK - 1) / BK;
  const int n_tiles = tiles_per_group * p.G;

  int acc[2][4][4];
  float facc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[i][j][c] = 0;
        facc[i][j][c] = 0.f;
      }

  Stage st;
  load_tile<W4>(p, st, m0, n0, 0, gs);
  for (int t = 0; t < n_tiles; ++t) {
    const int grp = t / tiles_per_group;
    store_tile<W4>(st, As, Bs);
    __syncthreads();
    if (t + 1 < n_tiles) {
      const int ng = (t + 1) / tiles_per_group;
      load_tile<W4>(p, st, m0, n0,
                ng * gs + ((t + 1) % tiles_per_group) * BK, (ng + 1) * gs);
    }
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int rb = wm + i * 16 + gq, kb = ks * 32 + tq * 4;
        af[i][0] = *reinterpret_cast<const uint32_t*>(&As[rb][kb]);
        af[i][1] = *reinterpret_cast<const uint32_t*>(&As[rb + 8][kb]);
        af[i][2] = *reinterpret_cast<const uint32_t*>(&As[rb][kb + 16]);
        af[i][3] = *reinterpret_cast<const uint32_t*>(&As[rb + 8][kb + 16]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int nb = wn + j * 8 + gq;
        bf[j][0] = Bs[nb][ks * 8 + tq];
        bf[j][1] = Bs[nb][ks * 8 + 4 + tq];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
    __syncthreads();

    if (p.peg && (t + 1) % tiles_per_group == 0) {
      // fold this group's int32 partial: facc += s_g * (f32(part) - z_g * cs)
      const float s_g = p.a_scales[grp], z_g = p.a_zps[grp];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int col = n0 + wn + j * 8 + tq * 2 + (c & 1);
            const float cs = col < p.N ? (float)p.colsum[(size_t)grp * p.N + col] : 0.f;
            facc[i][j][c] += s_g * ((float)acc[i][j][c] - z_g * cs);
            acc[i][j][c] = 0;
          }
    }
  }

  float s_prod = 0.f, z_a = 0.f;
  if (!p.peg) {
    s_prod = p.a_scales[0] * p.w_scale[0];
    if (p.a_zps) z_a = p.a_zps[0];
  }
  const float s_w = p.w_scale[0];
  const bool requant = p.out_scale != nullptr;
  const float s_o = requant ? p.out_scale[0] : 1.f;
  const float z_o = (requant && p.out_zp) ? p.out_zp[0] : 0.f;

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = m0 + wm + i * 16 + gq + (c >> 1) * 8;
        const int col = n0 + wn + j * 8 + tq * 2 + (c & 1);
        if (row >= p.M || col >= p.N) continue;
        float f;
        if (p.peg) {
          f = facc[i][j][c] * s_w;
        } else {
          f = (float)acc[i][j][c];
          if (p.colsum) f = f - z_a * (float)p.colsum[col];
          f = f * s_prod;
        }
        if (p.bias) f = f + p.bias[col];
        f = activation(f, p.act);
        const size_t o = (size_t)row * p.N + col;
        if (p.mul) f = f * p.mul[o];
        if (requant) {
          float q = rintf(f / s_o) + z_o;
          ((int8_t*)p.out)[o] = (int8_t)fminf(fmaxf(q, p.qmin), p.qmax);
        } else {
          ((float*)p.out)[o] = f;
        }
      }
}

}  // namespace

// See Params for shapes. peg = 0: per-tensor (G must be 1; colsum (N,) and
// a_zps optional together). peg = 1: PEG with G groups of K/G columns,
// colsum (G, N) and a_zps required. act: 0 none, 1 gelu, 2 silu, 3 relu.
// out_scale null: f32 output; else int8 output on [qmin, qmax].
// vec_a: K and K/G multiples of 16 and a 16-byte aligned; vec_w: N a
// multiple of 8 and w 8-byte aligned. w_bits = 4: w is (K/2, N) pairwise-row
// nibbles and K/G is even. Returns cudaGetLastError().
extern "C" int int8_matmul(const void* a, const void* w, const void* colsum,
                           const void* a_scales, const void* a_zps,
                           const void* w_scale, const void* bias,
                           const void* mul, const void* out_scale,
                           const void* out_zp, void* out, int M, int N, int K,
                           int G, int peg, int act, int qmin, int qmax,
                           int vec_a, int vec_w, int w_bits, void* stream) {
  Params p;
  p.a = (const int8_t*)a;
  p.w = (const int8_t*)w;
  p.colsum = (const int32_t*)colsum;
  p.a_scales = (const float*)a_scales;
  p.a_zps = (const float*)a_zps;
  p.w_scale = (const float*)w_scale;
  p.bias = (const float*)bias;
  p.mul = (const float*)mul;
  p.out_scale = (const float*)out_scale;
  p.out_zp = (const float*)out_zp;
  p.out = out;
  p.M = M;
  p.N = N;
  p.K = K;
  p.G = G;
  p.peg = peg;
  p.act = act;
  p.vec_a = vec_a;
  p.vec_w = vec_w;
  p.qmin = (float)qmin;
  p.qmax = (float)qmax;
  if (M > 0 && N > 0) {
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    if (w_bits == 4)
      int8_matmul_kernel<true><<<grid, THREADS, 0, (cudaStream_t)stream>>>(p);
    else
      int8_matmul_kernel<false><<<grid, THREADS, 0, (cudaStream_t)stream>>>(p);
  }
  return (int)cudaGetLastError();
}
