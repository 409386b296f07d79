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
// rate starts to matter. The int32 sums are exact; the float epilogue
// keeps the reference's operation order, and the build has no fast math
// and no FMA contraction.
//
// int8_matmul: split-K (int8_matmul_splitk_kernel). A grid of (N tiles, M
// tiles, K splits), each output tile's splits one thread-block cluster: a
// host-side planner (kernels/int8_matmul.py, plan_k_splits) picks a power
// of two up to 16 (Hopper's largest cluster) so that the grid fills the
// card about twice, each split keeping at least two 64-deep K tiles; split j
// owns the K tiles [j*kt/S, (j+1)*kt/S). The row tile follows M: 16 rows
// (one mma.sync.m16n8k32 row block, 4 warps across 128 columns) for M <=
// 16, else 64 rows (2 x 2 warps of 32 x 32 over 64 columns). Each CTA
// keeps a ring of six shared-memory stages filled with 16-byte cp.async,
// so at the serving shapes all of a split's K tiles are in flight at once:
// decode rows are bound by DRAM latency and bytes in flight, not by the
// mma. cp.async rather than TMA: a tile is one 2D box either way, cp.async
// needs no tensor map built per weight on the host, and its zero fill
// (src-size 0) masks the M, N and K edges. W arrives in its stored (K, N)
// layout (4-bit: (K/2, N) pairwise-row nibbles, bit for bit the reference's
// payload): a thread's B fragment is assembled when it is read, from four
// (k) rows of four consecutive columns, by a 4 x 4 byte transpose
// (__byte_perm); at 4 bits the two packed rows of a k-quad are sign-extended
// per byte first. So a warp's n8 block j holds the columns 4c + j (c = 0..7)
// of its 32, and the W rows are XOR-swizzled by 32 bytes every 8 rows so the
// fragment reads hit distinct banks. The splits' int32 partials are exact in
// any order, and they meet on chip: each CTA leaves its partial in its own
// shared memory, and after a cluster barrier each rank sums a share of the
// tile across the cluster's shared memory (distributed shared memory), runs
// the epilogue on it and writes it. Reducing through a global workspace
// instead (partials, or red.global.add, behind an arrival counter) adds
// fence, counter and read-back round trips that cost more than the mainloop
// at decode rows. One launch per call and no workspace.
//
// int8_matmul_peg: the same mainloop, split by PEG group spans
// (int8_matmul_peg_kernel). Each group of K/G columns is cut into
// `per_group` runs of whole K tiles, none across a group boundary; a
// group's last tile is masked at the group's end (a 16-wide reduced group is
// one zero-padded tile). The runs of `gpr` groups form one cluster of
// per_group x gpr blocks (at most 16; rank r runs group r / per_group, run
// r % per_group), and the cluster walks the G groups in rounds of gpr. The
// host planner (plan_peg_splits) picks per_group so the grid fills the card
// about twice, each run keeping at least two K tiles where its group has
// them, and gpr so the grid stays within the blocks the card holds at once
// (three an SM, by the ring's shared memory): at 64 rows a block per group
// would be 1.5 to 2.2 waves, and walking the groups in rounds measured
// faster than the extra waves. After each round's cluster barrier the
// reducing rank of an output element sums each group's int32 partial over
// its runs (distributed shared memory; exact in any order) and folds the
// groups into its f32 accumulator in group order g = 0..G-1,
//   facc += s_g * (f32(part_g) - z_g * colsum_g),
// so the float order, and the result, are those of one block walking all of
// K group by group. 4-bit weights are read as in the split-K kernel: K
// tiles, runs and PEG groups start at even k (the pack-time gate keeps group
// sizes even), so no byte is split.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int BK = 64, THREADS = 128;
constexpr int AS_STRIDE = BK + 16;      // bytes per A row in shared memory
constexpr int STAGES = 6;               // cp.async ring
constexpr int MAX_SPLITS = 16;          // Hopper's largest cluster

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
  int M, N, K, G, act, vec_a, vec_w;   // w: (K/2, N) when W4
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

// The shared epilogue after the scale: + bias -> act -> * mul -> store
// (f32, or the int8 requant on [qmin, qmax]); bias and mul are the
// element's operands where the call has them.
__device__ __forceinline__ void finish(const Params& p, int row, int col,
                                       float f, float bias, float mul) {
  if (p.bias) f = f + bias;
  f = activation(f, p.act);
  const size_t o = (size_t)row * p.N + col;
  if (p.mul) f = f * mul;
  if (p.out_scale) {
    const float z_o = p.out_zp ? p.out_zp[0] : 0.f;
    const float q = rintf(f / p.out_scale[0]) + z_o;
    ((int8_t*)p.out)[o] = (int8_t)fminf(fmaxf(q, p.qmin), p.qmax);
  } else {
    ((float*)p.out)[o] = f;
  }
}
__device__ __forceinline__ void finish(const Params& p, int row, int col,
                                       float f) {
  finish(p, row, col, f, p.bias ? p.bias[col] : 0.f,
         p.mul ? p.mul[(size_t)row * p.N + col] : 0.f);
}

// Four int4 nibbles per byte lane, (v ^ 8) - 8 each: the low nibbles of w,
// or (hi) its high nibbles, as four int8 bytes.
__device__ __forceinline__ uint32_t sext_lo(uint32_t w) {
  return __vsub4((w & 0x0f0f0f0fu) ^ 0x08080808u, 0x08080808u);
}
__device__ __forceinline__ uint32_t sext_hi(uint32_t w) {
  return __vsub4(((w >> 4) & 0x0f0f0f0fu) ^ 0x08080808u, 0x08080808u);
}

// ---------------------------------------------------------------------------
// The split mainloop: a run of K tiles through a cp.async ring.

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Byte offset of (row, byte column) in a W stage: rows of BN_ + 16 bytes,
// the column XOR-swizzled by 32 bytes on every other group of 8 rows.
template <int BN_>
__device__ __forceinline__ int w_off(int row, int col) {
  return row * (BN_ + 16) + (col ^ (((row >> 3) & 1) << 5));
}

// 4 x 4 byte transpose: out[j] byte r = byte j of r[r].
__device__ __forceinline__ void transpose4(const uint32_t (&r)[4],
                                           uint32_t (&out)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t t1 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  out[0] = __byte_perm(t0, t1, 0x5410);
  out[1] = __byte_perm(t0, t1, 0x7632);
  out[2] = __byte_perm(t2, t3, 0x5410);
  out[3] = __byte_perm(t2, t3, 0x7632);
}

// MI 16-row blocks per warp, WM warps along M (4 / WM along N).
template <int MI, int WM, bool W4>
struct SplitTile {
  static constexpr int WN = 4 / WM;
  static constexpr int BM_ = WM * MI * 16, BN_ = WN * 32;
  static constexpr int W_ROWS = W4 ? BK / 2 : BK;   // (packed) rows a tile
  static constexpr int A_BYTES = BM_ * AS_STRIDE;
  static constexpr int W_BYTES = W_ROWS * (BN_ + 16);
  static constexpr int STAGE = A_BYTES + W_BYTES;
};

// Start (vec) or perform (!vec) the loads of the K tile at k0 into one
// stage, zero past k_hi (the end of K, or of the tile's PEG group).
template <int MI, int WM, bool W4>
__device__ __forceinline__ void load_stage(const Params& p, int8_t* st,
                                           int m0, int n0, int k0, int k_hi,
                                           bool vec) {
  using T = SplitTile<MI, WM, W4>;
  const int tid = threadIdx.x;
  for (int c = tid; c < T::BM_ * (BK / 16); c += THREADS) {
    const int r = c >> 2, cc = (c & 3) * 16;
    const int gm = m0 + r, gk = k0 + cc;
    int8_t* dst = st + r * AS_STRIDE + cc;
    if (vec) {
      const bool ok = gm < p.M && gk < k_hi;
      cp_async16(dst, ok ? p.a + (size_t)gm * p.K + gk : p.a, ok);
    } else {
      for (int e = 0; e < 16; ++e)
        dst[e] = (gm < p.M && gk + e < k_hi)
                     ? p.a[(size_t)gm * p.K + gk + e] : (int8_t)0;
    }
  }
  int8_t* ws = st + T::A_BYTES;
  constexpr int CPR = T::BN_ / 16;                  // 16-byte chunks a row
  for (int c = tid; c < T::W_ROWS * CPR; c += THREADS) {
    const int r = c / CPR, cc = (c % CPR) * 16;
    const int k_first = k0 + (W4 ? 2 * r : r);      // first k of the row
    const int kk = W4 ? k_first / 2 : k_first;      // stored row
    const int gn = n0 + cc;
    int8_t* dst = ws + w_off<T::BN_>(r, cc);
    if (vec) {
      const bool ok = k_first < k_hi && gn < p.N;
      cp_async16(dst, ok ? p.w + (size_t)kk * p.N + gn : p.w, ok);
    } else {
      for (int e = 0; e < 16; ++e)
        dst[e] = (k_first < k_hi && gn + e < p.N)
                     ? p.w[(size_t)kk * p.N + gn + e] : (int8_t)0;
    }
  }
}

// Accumulate the nt K tiles from k_begin (masked at k_hi) of the output
// tile (m0, n0) into acc, through a ring of STAGES shared-memory stages. On
// return every stage has been consumed and the ring may be reused.
template <int MI, int WM, bool W4>
__device__ __forceinline__ void mainloop(const Params& p, int8_t* smem,
                                         int m0, int n0, int k_begin, int nt,
                                         int k_hi, int (&acc)[MI][4][4]) {
  using T = SplitTile<MI, WM, W4>;
  constexpr int R = STAGES;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp / T::WN) * MI * 16, wn = (warp % T::WN) * 32;
  const int gq = lane >> 2, tq = lane & 3;
  const bool vec = p.vec_a && p.vec_w;
#pragma unroll
  for (int s = 0; s < R - 1; ++s) {
    if (s < nt)
      load_stage<MI, WM, W4>(p, smem + s * T::STAGE, m0, n0,
                             k_begin + s * BK, k_hi, vec);
    cp_async_commit();
  }
  for (int t = 0; t < nt; ++t) {
    cp_async_wait<R - 2>();
    __syncthreads();                 // tile t landed; tile t-1 is consumed
    if (t + R - 1 < nt)
      load_stage<MI, WM, W4>(p, smem + ((t + R - 1) % R) * T::STAGE, m0, n0,
                             k_begin + (t + R - 1) * BK, k_hi, vec);
    cp_async_commit();
    const int8_t* As = smem + (t % R) * T::STAGE;
    const int8_t* Ws = As + T::A_BYTES;
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      uint32_t af[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int rb = wm + i * 16 + gq, kb = ks * 32 + tq * 4;
        af[i][0] = *reinterpret_cast<const uint32_t*>(
            As + rb * AS_STRIDE + kb);
        af[i][1] = *reinterpret_cast<const uint32_t*>(
            As + (rb + 8) * AS_STRIDE + kb);
        af[i][2] = *reinterpret_cast<const uint32_t*>(
            As + rb * AS_STRIDE + kb + 16);
        af[i][3] = *reinterpret_cast<const uint32_t*>(
            As + (rb + 8) * AS_STRIDE + kb + 16);
      }
      // B fragments: k-quad q = ks*8 + tq (b0) and + 4 (b1) of this
      // thread's four columns wn + 4 gq .. + 3, one word per n8 block j
      uint32_t bq[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = ks * 8 + h * 4 + tq;
        uint32_t r[4];
        if (W4) {
          const uint32_t w0 = *reinterpret_cast<const uint32_t*>(
              Ws + w_off<T::BN_>(2 * q, wn + 4 * gq));
          const uint32_t w1 = *reinterpret_cast<const uint32_t*>(
              Ws + w_off<T::BN_>(2 * q + 1, wn + 4 * gq));
          r[0] = sext_lo(w0);     // k = 4q
          r[1] = sext_hi(w0);     // 4q + 1
          r[2] = sext_lo(w1);     // 4q + 2
          r[3] = sext_hi(w1);     // 4q + 3
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            r[e] = *reinterpret_cast<const uint32_t*>(
                Ws + w_off<T::BN_>(4 * q + e, wn + 4 * gq));
        }
        transpose4(r, bq[h]);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t b[2] = {bq[0][j], bq[1][j]};
          mma_s8(acc[i][j], af[i], b);
        }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                       // every stage has been consumed
}

// A split's int32 partial goes to its own shared memory, element-major:
// element e = (i*4 + j)*4 + c of a thread is row wm + 16 i + gq + 8 (c >> 1),
// column wn + 4 (2 tq + (c & 1)) + j of the output tile (element_at).
template <int MI>
__device__ __forceinline__ void store_partial(int* part,
                                              const int (&acc)[MI][4][4]) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        part[((i * 4 + j) * 4 + c) * THREADS + threadIdx.x] = acc[i][j][c];
}

template <int MI, int WM>
__device__ __forceinline__ void element_at(int e, int m0, int n0, int* row,
                                           int* col) {
  constexpr int WN = 4 / WM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = e >> 4, j = (e >> 2) & 3, c = e & 3;
  *row = m0 + (warp / WN) * MI * 16 + i * 16 + (lane >> 2) + (c >> 1) * 8;
  *col = n0 + (warp % WN) * 32 + 4 * (2 * (lane & 3) + (c & 1)) + j;
}

template <int MI, int WM, bool W4>
__global__ void __launch_bounds__(THREADS)
int8_matmul_splitk_kernel(const Params p, int splits) {
  using T = SplitTile<MI, WM, W4>;
  extern __shared__ __align__(128) int8_t smem[];
  const int m0 = blockIdx.y * T::BM_, n0 = blockIdx.x * T::BN_;
  const int split = blockIdx.z;          // = the block's rank in its cluster

  const int kt = (p.K + BK - 1) / BK;
  const int t_begin = (int)((long)split * kt / splits);
  const int nt = (int)((long)(split + 1) * kt / splits) - t_begin;

  int acc[MI][4][4] = {};
  mainloop<MI, WM, W4>(p, smem, m0, n0, t_begin * BK, nt, p.K, acc);

  // After the cluster barrier, rank r sums elements r, r + S, ... of every
  // thread over the S ranks' shared memory (distributed shared memory;
  // int32 sums are exact in any order), runs the epilogue on them and
  // writes them. The second barrier keeps every block's shared memory
  // alive until the others have read it.
  constexpr int NE = MI * 16;
  int* part = reinterpret_cast<int*>(smem);
  store_partial<MI>(part, acc);
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const float s_prod = p.a_scales[0] * p.w_scale[0];
  const float z_a = p.a_zps ? p.a_zps[0] : 0.f;
  for (int e = split; e < NE; e += splits) {
    int row, col;
    element_at<MI, WM>(e, m0, n0, &row, &col);
    if (row >= p.M || col >= p.N) continue;
    int sum = 0;
#pragma unroll 16
    for (int r = 0; r < splits; ++r)
      sum += cluster.map_shared_rank(part, r)[e * THREADS + threadIdx.x];
    float f = (float)sum;
    if (p.colsum) f = f - z_a * (float)p.colsum[col];
    finish(p, row, col, f * s_prod);
  }
  cluster.sync();
}

// The PEG kernel: rank r of a cluster of per_group x gpr blocks runs, in
// each round of gpr groups, run r % per_group of group r / per_group.
// Rank r reduces the elements e with e % splits == r of every thread; it
// walks the cluster's ranks in order, so each step issues the loads of all
// its elements at once, and folds a group when its last run is summed, with
// the group's (s, z) and colsum staged in its own shared memory beside the
// partials before the barrier.
template <int MI, int WM, bool W4>
__global__ void __launch_bounds__(THREADS)
int8_matmul_peg_kernel(const Params p, int per_group, int gpr) {
  using T = SplitTile<MI, WM, W4>;
  extern __shared__ __align__(128) int8_t smem[];
  const int m0 = blockIdx.y * T::BM_, n0 = blockIdx.x * T::BN_;
  const int rank = blockIdx.z;           // = the block's rank in its cluster
  const int splits = per_group * gpr;

  const int gs = p.K / p.G;
  const int kt = (gs + BK - 1) / BK;     // K tiles of a group
  const int run = rank % per_group;
  const int t_begin = run * kt / per_group;
  const int nt = (run + 1) * kt / per_group - t_begin;

  constexpr int NE = MI * 16;
  static_assert((NE * THREADS + MAX_SPLITS * T::BN_ + 2 * MAX_SPLITS) * 4 <=
                    STAGES * T::STAGE, "the reduction's staging fits the ring");
  uint32_t own = 0;                      // the elements this rank reduces
#pragma unroll
  for (int e = 0; e < NE; ++e) own |= (uint32_t)(e % splits == rank) << e;
  float facc[NE];
#pragma unroll
  for (int e = 0; e < NE; ++e) facc[e] = 0.f;
  // shared memory after the ring drains: the partial (NE x THREADS int32),
  // then the round's colsum (gpr x BN_ int32), s_g and z_g (gpr f32 each)
  int* part = reinterpret_cast<int*>(smem);
  int* cs_s = part + NE * THREADS;
  float* sz_s = reinterpret_cast<float*>(cs_s + MAX_SPLITS * T::BN_);
  cg::cluster_group cluster = cg::this_cluster();
  for (int g0 = 0; g0 < p.G; g0 += gpr) {
    const int grp = g0 + rank / per_group;
    const int ng = min(gpr, p.G - g0);
    int acc[MI][4][4] = {};
    if (grp < p.G)
      mainloop<MI, WM, W4>(p, smem, m0, n0, grp * gs + t_begin * BK, nt,
                           (grp + 1) * gs, acc);
    store_partial<MI>(part, acc);
    for (int i = threadIdx.x; i < ng * T::BN_; i += THREADS) {
      const int gl = i / T::BN_, c = n0 + i % T::BN_;
      cs_s[i] = c < p.N ? p.colsum[(size_t)(g0 + gl) * p.N + c] : 0;
    }
    if (threadIdx.x < ng) {
      sz_s[threadIdx.x] = p.a_scales[g0 + threadIdx.x];
      sz_s[MAX_SPLITS + threadIdx.x] = p.a_zps[g0 + threadIdx.x];
    }
    cluster.sync();
    int gsum[NE];
#pragma unroll
    for (int e = 0; e < NE; ++e) gsum[e] = 0;
    for (int r = 0; r < ng * per_group; ++r) {
      const int* src = cluster.map_shared_rank(part, r) + threadIdx.x;
#pragma unroll
      for (int e = 0; e < NE; ++e)
        if (own >> e & 1) gsum[e] += src[e * THREADS];
      if ((r + 1) % per_group) continue;
      // the last run of group g0 + gl: fold it, in group order
      const int gl = r / per_group;
      const float s_g = sz_s[gl], z_g = sz_s[MAX_SPLITS + gl];
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        if (!(own >> e & 1)) continue;
        int row, col;
        element_at<MI, WM>(e, 0, 0, &row, &col);
        facc[e] += s_g * ((float)gsum[e] - z_g * (float)cs_s[gl * T::BN_ +
                                                             col]);
        gsum[e] = 0;
      }
    }
    cluster.sync();    // the partials are read: the ring may be refilled
  }
  // the epilogue, 16 elements at a time: their operands first (independent
  // loads), then the arithmetic and the stores
  const float s_w = p.w_scale[0];
#pragma unroll
  for (int e0 = 0; e0 < NE; e0 += 16) {
    float bias[16], mul[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      int row, col;
      element_at<MI, WM>(e0 + i, m0, n0, &row, &col);
      const bool ok = (own >> (e0 + i) & 1) && row < p.M && col < p.N;
      bias[i] = ok && p.bias ? p.bias[col] : 0.f;
      mul[i] = ok && p.mul ? p.mul[(size_t)row * p.N + col] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      int row, col;
      element_at<MI, WM>(e0 + i, m0, n0, &row, &col);
      if ((own >> (e0 + i) & 1) && row < p.M && col < p.N)
        finish(p, row, col, facc[e0 + i] * s_w, bias[i], mul[i]);
    }
  }
}

// Launch `kernel` over (N tiles, M tiles, cluster) with each output tile's
// `cluster` blocks as one thread-block cluster.
template <int MI, int WM, bool W4, typename... Args>
int launch_cluster(void (*kernel)(const Params, Args...), const Params& p,
                   int cluster, cudaStream_t stream, Args... args) {
  using T = SplitTile<MI, WM, W4>;
  constexpr int smem = STAGES * T::STAGE;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)   // clusters of 9..16 blocks are not portable
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;   // the K splits
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = cluster;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.N + T::BN_ - 1) / T::BN_,
                     (p.M + T::BM_ - 1) / T::BM_, cluster);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, p, args...);
}

template <int MI, int WM, bool W4>
int launch_splitk(const Params& p, int splits, cudaStream_t stream) {
  return launch_cluster<MI, WM, W4>(int8_matmul_splitk_kernel<MI, WM, W4>, p,
                                    splits, stream, splits);
}

template <int MI, int WM, bool W4>
int launch_peg(const Params& p, int per_group, int gpr, cudaStream_t stream) {
  return launch_cluster<MI, WM, W4>(int8_matmul_peg_kernel<MI, WM, W4>, p,
                                    per_group * gpr, stream, per_group, gpr);
}

}  // namespace

// See Params for shapes. Both modes launch one thread-block cluster per
// output tile of row_tile rows: 16 x 128 or 64 x 64. peg = 0: per-tensor (G
// must be
// 1; colsum (N,) and a_zps optional together), `splits` (1..16) K splits
// (kernels/int8_matmul.py plan_k_splits). peg = 1: PEG with G groups of K/G
// columns, colsum (G, N) and a_zps required, `splits` runs per group and
// `groups` groups per cluster, splits x groups <= 16 (plan_peg_splits). act: 0
// none, 1 gelu, 2 silu, 3 relu. out_scale null: f32 output; else int8
// output on [qmin, qmax]. vec_a: K and K/G multiples of 16 and a 16-byte
// aligned; vec_w: N a multiple of 16 and w 16-byte aligned. w_bits = 4: w
// is (K/2, N) pairwise-row nibbles and K/G is even. Returns
// cudaGetLastError().
extern "C" int int8_matmul(const void* a, const void* w, const void* colsum,
                           const void* a_scales, const void* a_zps,
                           const void* w_scale, const void* bias,
                           const void* mul, const void* out_scale,
                           const void* out_zp, void* out, int M, int N, int K,
                           int G, int peg, int act, int qmin, int qmax,
                           int vec_a, int vec_w, int w_bits, int row_tile,
                           int splits, int groups, void* stream) {
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
  p.act = act;
  p.vec_a = vec_a;
  p.vec_w = vec_w;
  p.qmin = (float)qmin;
  p.qmax = (float)qmax;
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  if (splits < 1 || splits > MAX_SPLITS || (row_tile != 16 && row_tile != 64)
      || G < 1 || (peg && (colsum == nullptr || a_zps == nullptr ||
                           groups < 1 || groups > G ||
                           splits * groups > MAX_SPLITS)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool w4 = w_bits == 4;
  if (peg && row_tile == 16)
    return w4 ? launch_peg<1, 1, true>(p, splits, groups, s)
              : launch_peg<1, 1, false>(p, splits, groups, s);
  if (peg)
    return w4 ? launch_peg<2, 2, true>(p, splits, groups, s)
              : launch_peg<2, 2, false>(p, splits, groups, s);
  if (row_tile == 16)
    return w4 ? launch_splitk<1, 1, true>(p, splits, s)
              : launch_splitk<1, 1, false>(p, splits, s);
  return w4 ? launch_splitk<2, 2, true>(p, splits, s)
            : launch_splitk<2, 2, false>(p, splits, s);
}
