// Tiled flash attention with an online softmax: forward, and the two backward
// kernels (dq; dk and dv), written by hand for Hopper (sm_90a).
//
// Replaces: seed_tpu/ops/flash_attention.py::_flash_kernel,
// ::_flash_bwd_dq_kernel and ::_flash_bwd_dkv_kernel (launched by
// _flash_fwd_bhsd and _flash_bwd_bhsd). Same function and the same rounding
// points:
//   forward   s = (q . k) * scale in fp32; masked entries (col > row + q_offset
//             when causal, col >= Sk always) become -0.7 * f32max, never -inf;
//             running max m, running sum l and the output accumulator are fp32;
//             p = exp(s - m) is rounded to the io type before P@V; the output
//             is acc * (1 / l) and lse = m + log(l); a q tile that meets no kv
//             tile gives output 0 and lse 0.
//   backward  p = exp(s - lse) is recomputed, dp = dO . V, ds = p * (dp - delta)
//             with delta = rowsum(dO * O) handed in; p and ds are rounded to the
//             io type before their products; dq and dk take the scale once, at
//             the end; all sums are fp32.
//   Causal loops skip the tiles that lie wholly above the diagonal.
// The bf16 kernels keep their scores in base 2: s * (scale * log2 e) and
// exp2, with lse = m ln 2 + log(l) out of the forward and lse * log2 e in the
// backward. The plain versions (ops/flash_attention.py) repeat it.
//
// What bounds it on the H100: at the training shape (B=4, H=32, S=1024, D=128,
// bf16, causal) the forward is 2*B*H*S*S*D = 34 GFLOP over 134 MB of q, k, v
// and o, about 256 operations per byte: just under the card's 295, so a
// full-rate kernel sits at the memory bound (0.040 ms) with the tensor cores
// (0.035 ms) right behind. dq runs three such products (51.6 GFLOP) and dk/dv
// four (68.8 GFLOP), over 1.25x and 1.5x the forward's bytes, so both are
// bound by operations (0.052 and 0.070 ms).
//
// The bf16 kernels share one shape, the FlashAttention-2 one: a block of 4
// warps owns 64 rows of one (batch, head), each warp 16 rows, and streams the
// other operand through a two-stage cp.async ring, so tile j + 1 is in flight
// while tile j is multiplied. Every product is mma.sync m16n8k16 with fp32
// accumulators in registers; operands come from shared rows padded by 16
// bytes (ldmatrix free of bank conflicts); a C fragment becomes the next
// product's bf16 A fragment in registers (c_to_a), so no score, P or dS
// ever touches shared memory. Only tiles that cross the diagonal or the end
// of the keys apply the element mask. No atomics and no split over the
// streamed operand: one block writes each output row, so results repeat bit
// for bit.
//
//   forward (flash_fwd_bf16_kernel): 64 q rows; K and V tiles of 64 rows (32
//     above Dp = 128, where the 16 x Dp output takes the registers); scores,
//     running max and sum in registers, the softmax reduced over the four
//     threads of a quad, the output rescaled by alpha in place; Q held as
//     fragments up to Dp = 128. The q tiles launch heaviest first.
//   dq (flash_bwd_dq_bf16_kernel): 64 q rows, Q and dO staged once, lse and
//     delta of the thread's two rows in registers; per kv tile (64 rows, 32
//     above Dp = 128) S = Q K^T and dP = dO V^T, p and ds in the C
//     fragments, then dQ += dS K from the same K tile through ldmatrix.trans.
//     The dQ accumulator (Dp / 2 registers a thread) stays in registers; Q is
//     held as fragments up to Dp = 128. The q tiles launch heaviest first.
//   dk/dv (flash_bwd_dkv_bf16_kernel): 64 kv rows, K and V staged once; per
//     q tile the scores come transposed, S^T = K Q^T and dP^T = V dO^T, so P^T
//     and dS^T sit in C fragments whose rows are the warp's own kv rows and go
//     straight into dV += P^T dO and dK += dS^T Q. Q, dO, lse and delta tiles
//     stream through the ring from the first q tile that reaches the kv
//     tile's diagonal. dK and dV cost Dp fp32 registers a thread, so the q
//     tile is 64 rows up to Dp = 64 and 32 above; above Dp = 128 two warps
//     share each 16 kv rows and own half of dK's and dV's columns each (8
//     warps; the scores are computed by both). The kv tiles launch in order,
//     which is heaviest first for this kernel.
//
// The fp32 kernels (flash_fwd_f32_kernel, flash_bwd_dq_f32_kernel,
// flash_bwd_dkv_f32_kernel) take the same shapes with fp32 operands on the
// tensor cores as split-TF32 products (sm90::mma_3xtf32: three mma.sync
// m16n8k8 tf32 products of each operand's hi and lo halves, within about
// 3 * 2^-22 of |a b| of the fp32 product, where TF32 alone keeps 11 bits).
// Operands are split in registers as their fragments leave shared memory,
// which holds each tile once (rows of Dp + 4 floats, Dp = D rounded up to
// 16); scores, P and dS stay in registers. The forward takes 64 q rows over
// kv tiles of 32 rows, dq 64 q rows over kv tiles of 16, dk/dv 64 kv rows
// over q tiles of 16 (above Dp = 128 with two warps on each 16 kv rows).
// dk/dv sums each q tile's products in a fragment of their own and adds it
// to dK and dV in round-to-nearest (sm90::add_rn): with one tensor-core
// chain over every q tile its error grew with the sequence, past 1e-4 of
// the plain version at S = 2048 and 4096 causal on the H100 (the early
// keys, whose first terms dwarf the rest), where dq and the forward stayed
// within 1.1e-5 up to S = 8192 with theirs.
// At the fp32 training shape (B=1, H=32, S=1024, D=128, causal) the forward
// is 8.6 GFLOP, 0.128 ms at the FMA units' 67 TFLOP/s, 0.052 ms as three
// TF32 products at 495; dq 1.5 times that, dk/dv twice.
//
// q, k, v and dO are read in place as [B, S, H, D] through element strides,
// ragged S and D are masked while staging (rows past the end and columns
// from D up to the padded head dim are zero), and nothing is padded or
// transposed in device memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float kMaskValue = (float)(-0.7 * (double)FLT_MAX);
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Strides {
  long long b, s, h;
};

// ------------------------------------------------ bf16 kernels (mma.sync)

constexpr int kMmaThreads = 128;      // 4 warps, 16 rows each
constexpr int kMmaRows = 64;          // rows a block owns: q rows (forward, dq), kv rows (dk/dv)
constexpr int kStages = 2;            // cp.async ring depth

// kv tile rows of the bf16 forward by padded head dim: above 128 the output
// accumulator (Dp / 2 fp32 registers a thread) leaves room for half the
// score tile only.
__host__ __device__ constexpr int fwd_kv_tile(int Dp) { return Dp <= 128 ? 64 : 32; }
// kv tile rows of the bf16 dq kernel: the same budget (the dQ accumulator).
__host__ __device__ constexpr int dq_kv_tile(int Dp) { return Dp <= 128 ? 64 : 32; }
// q tile rows of the bf16 dk/dv kernel: dK and dV take Dp registers a thread
// (up to 128) and S^T and dP^T q tile / 2 each.
__host__ __device__ constexpr int dkv_q_tile(int Dp) { return Dp <= 64 ? 64 : 32; }
// Warps that share 16 kv rows of the dk/dv kernel, each owning Dp / split
// columns of dK and dV: above Dp = 128 one warp's Dp registers would not fit.
__host__ __device__ constexpr int dkv_split(int Dp) { return Dp <= 128 ? 1 : 2; }

// Row i (0: g, 1: g + 8) of a warp's 16-row block of C fragments acc[N8][4],
// times `mul`, rounded to bf16 into columns [col0, col0 + 8 * N8) of `row`,
// those from D on dropped.
template <int N8>
__device__ __forceinline__ void store_row(bf16* row, const float (&acc)[N8][4], int i,
                                          float mul, int col0, int D, int t) {
#pragma unroll
  for (int n = 0; n < N8; ++n) {
    const int col = col0 + n * 8 + 2 * t;
    const float v0 = acc[n][2 * i] * mul, v1 = acc[n][2 * i + 1] * mul;
    if ((D & 1) == 0 && col + 1 < D) {
      *reinterpret_cast<__nv_bfloat162*>(row + col) = __floats2bfloat162_rn(v0, v1);
    } else {
      if (col < D) row[col] = __float2bfloat16_rn(v0);
      if (col + 1 < D) row[col + 1] = __float2bfloat16_rn(v1);
    }
  }
}

// ------------------------------------------------------ forward, bf16
// grid (H, B, q tiles). o is contiguous [B, Sq, H, D], lse fp32 [B, H, Sq].
// `scale_log2` is scale * log2(e) in fp32.
template <int Dp>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                      int Sq, int Sk, int H, int D, Strides qs, Strides ks, Strides vs,
                      float scale_log2, int causal, int q_offset, int vec) {
  constexpr int KT = fwd_kv_tile(Dp);
  constexpr int ld = Dp + sm90::kRowPad;
  constexpr int NS = KT / 8;             // n8 tiles of a score row block
  constexpr int ND = Dp / 8;             // n8 tiles of an output row block
  constexpr int KD = Dp / 16;            // k16 steps of Q K^T
  constexpr int KS = KT / 16;            // k16 steps of P V
  constexpr bool kQRegs = Dp <= 128;     // Q fragments held in registers
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + kMmaRows * ld;         // kStages stages of KT rows
  bf16* Vs = Ks + kStages * KT * ld;

  const int h = blockIdx.x, b = blockIdx.y;
  const int r0 = ((int)gridDim.z - 1 - (int)blockIdx.z) * kMmaRows;   // heaviest first
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wrow0 = warp * 16;
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;

  const int kv_tiles = (Sk + KT - 1) / KT;
  int hi = kv_tiles;
  if (causal) {
    const int last_row = r0 + kMmaRows - 1 + q_offset;
    hi = last_row < 0 ? 0 : min(kv_tiles, last_row / KT + 1);
  }

  // the ring: kv tile j lives in stage j % kStages, issued kStages - 1 tiles
  // ahead; one group per tile (Q rides with tile 0)
  auto stage_kv = [&](int j) {
    const int at = (j % kStages) * KT * ld;
    sm90::stage_tile<Dp, kMmaThreads>(Ks + at, kb, ks.s, j * KT, Sk, KT, D, vec);
    sm90::stage_tile<Dp, kMmaThreads>(Vs + at, vb, vs.s, j * KT, Sk, KT, D, vec);
  };
  sm90::stage_tile<Dp, kMmaThreads>(Qs, qb, qs.s, r0, Sq, kMmaRows, D, vec);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < hi) stage_kv(i);
    sm90::cp_async_commit();
  }

  // this thread's two rows (g and g + 8 of the warp's 16), on the causal scale
  const int row_lo = r0 + wrow0 + g + q_offset;
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  uint32_t qf[kQRegs ? KD : 1][4];

  for (int j = 0; j < hi; ++j) {
    sm90::cp_async_wait<kStages - 2>();
    __syncthreads();     // tile j visible; every warp is past tile j - 1
    if (j + kStages - 1 < hi) stage_kv(j + kStages - 1);
    sm90::cp_async_commit();
    const bf16* Kt = Ks + (j % kStages) * KT * ld;
    const bf16* Vt = Vs + (j % kStages) * KT * ld;
    if constexpr (kQRegs) {
      if (j == 0) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) sm90::load_a(qf[kk], Qs, ld, wrow0, kk * 16, lane);
      }
    }

    // S = Q K^T, then scores in base 2
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4];
      if constexpr (kQRegs) {
        a[0] = qf[kk][0], a[1] = qf[kk][1], a[2] = qf[kk][2], a[3] = qf[kk][3];
      } else {
        sm90::load_a(a, Qs, ld, wrow0, kk * 16, lane);
      }
#pragma unroll
      for (int n = 0; n < NS; n += 2) {
        uint32_t kf[4];
        sm90::load_b_nk(kf, Kt, ld, n * 8, kk * 16, lane);
        sm90::mma_bf16(s[n], a, kf[0], kf[1]);
        sm90::mma_bf16(s[n + 1], a, kf[2], kf[3]);
      }
    }
    const int c0 = j * KT;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = __fmul_rn(s[n][e], scale_log2);
    // element masks only where the tile crosses the diagonal or the keys' end
    if (c0 + KT > Sk || (causal && c0 + KT - 1 > r0 + wrow0 + q_offset)) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + n * 8 + 2 * t + (e & 1);
          const int row = row_lo + (e >> 1) * 8;
          if ((causal && col > row) || col >= Sk) s[n][e] = kMaskValue;
        }
    }

    // online softmax over the thread's two rows; quads hold whole rows
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m[i];
#pragma unroll
      for (int n = 0; n < NS; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
      mx = sm90::quad_max(mx);
      alpha[i] = exp2f(m[i] - mx);
      m[i] = mx;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        s[n][2 * i] = exp2f(s[n][2 * i] - mx);
        s[n][2 * i + 1] = exp2f(s[n][2 * i + 1] - mx);
        sum += s[n][2 * i] + s[n][2 * i + 1];
      }
      l[i] = __fadd_rn(__fmul_rn(alpha[i], l[i]), sm90::quad_sum(sum));
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V, P rounded to bf16 on its way to the A fragment
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4];
      sm90::c_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        uint32_t vf[4];
        sm90::load_b_kn(vf, Vt, ld, kk * 16, n * 8, lane);
        sm90::mma_bf16(acc[n], a, vf[0], vf[1]);
        sm90::mma_bf16(acc[n + 1], a, vf[2], vf[3]);
      }
    }
  }
  sm90::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + wrow0 + g + 8 * i;
    if (row >= Sq) continue;
    const float l_inv = l[i] == 0.f ? 1.f : 1.f / l[i];
    store_row(o + (((long long)b * Sq + row) * H + h) * D, acc, i, l_inv, 0, D, t);
    if (t == 0)
      lse[((long long)b * H + h) * Sq + row] =
          l[i] == 0.f ? 0.f : __fadd_rn(__fmul_rn(m[i], kLn2), logf(l[i]));
  }
}

// ------------------------------------------------------ backward dq, bf16
// grid (H, B, q tiles). lse and delta are fp32 [B, H, Sq]; dq is contiguous
// [B, Sq, H, D]. No q_offset: the caller takes another route for it.
template <int Dp>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dq, int Sq, int Sk, int H, int D, Strides qs,
                         Strides ks, Strides vs, Strides gs, float scale, float scale_log2,
                         int causal, int vec) {
  constexpr int KT = dq_kv_tile(Dp);
  constexpr int ld = Dp + sm90::kRowPad;
  constexpr int NS = KT / 8;             // n8 tiles of a score row block
  constexpr int ND = Dp / 8;             // n8 tiles of the dQ row block
  constexpr int KD = Dp / 16;            // k16 steps of Q K^T and dO V^T
  constexpr int KS = KT / 16;            // k16 steps of dS K
  constexpr bool kQRegs = Dp <= 128;     // Q fragments held in registers
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Gs = Qs + kMmaRows * ld;         // dO
  bf16* Ks = Gs + kMmaRows * ld;         // kStages stages of KT rows
  bf16* Vs = Ks + kStages * KT * ld;

  const int h = blockIdx.x, b = blockIdx.y;
  const int r0 = ((int)gridDim.z - 1 - (int)blockIdx.z) * kMmaRows;   // heaviest first
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wrow0 = warp * 16;
  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;

  const int kv_tiles = (Sk + KT - 1) / KT;
  const int hi = causal ? min(kv_tiles, (r0 + kMmaRows - 1) / KT + 1) : kv_tiles;

  auto stage_kv = [&](int j) {
    const int at = (j % kStages) * KT * ld;
    sm90::stage_tile<Dp, kMmaThreads>(Ks + at, kb, ks.s, j * KT, Sk, KT, D, vec);
    sm90::stage_tile<Dp, kMmaThreads>(Vs + at, vb, vs.s, j * KT, Sk, KT, D, vec);
  };
  sm90::stage_tile<Dp, kMmaThreads>(Qs, q + b * qs.b + h * qs.h, qs.s, r0, Sq, kMmaRows, D,
                                    vec);
  sm90::stage_tile<Dp, kMmaThreads>(Gs, dout + b * gs.b + h * gs.h, gs.s, r0, Sq, kMmaRows, D,
                                    vec);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < hi) stage_kv(i);
    sm90::cp_async_commit();
  }

  // this thread's two rows (g and g + 8 of the warp's 16): lse in base 2 and
  // delta (rows past Sq meet zero q and dO rows, so their ds is 0)
  const long long row_base = ((long long)b * H + h) * Sq;
  float lse2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + wrow0 + g + 8 * i;
    lse2[i] = row < Sq ? __fmul_rn(lse[row_base + row], kLog2e) : 0.f;
    dlt[i] = row < Sq ? delta[row_base + row] : 0.f;
  }
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  uint32_t qf[kQRegs ? KD : 1][4];

  for (int j = 0; j < hi; ++j) {
    sm90::cp_async_wait<kStages - 2>();
    __syncthreads();     // tile j visible; every warp is past tile j - 1
    if (j + kStages - 1 < hi) stage_kv(j + kStages - 1);
    sm90::cp_async_commit();
    const bf16* Kt = Ks + (j % kStages) * KT * ld;
    const bf16* Vt = Vs + (j % kStages) * KT * ld;
    if constexpr (kQRegs) {
      if (j == 0) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) sm90::load_a(qf[kk], Qs, ld, wrow0, kk * 16, lane);
      }
    }

    // S = Q K^T and dP = dO V^T
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4];
      if constexpr (kQRegs) {
        a[0] = qf[kk][0], a[1] = qf[kk][1], a[2] = qf[kk][2], a[3] = qf[kk][3];
      } else {
        sm90::load_a(a, Qs, ld, wrow0, kk * 16, lane);
      }
#pragma unroll
      for (int n = 0; n < NS; n += 2) {
        uint32_t kf[4];
        sm90::load_b_nk(kf, Kt, ld, n * 8, kk * 16, lane);
        sm90::mma_bf16(s[n], a, kf[0], kf[1]);
        sm90::mma_bf16(s[n + 1], a, kf[2], kf[3]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4];
      sm90::load_a(a, Gs, ld, wrow0, kk * 16, lane);
#pragma unroll
      for (int n = 0; n < NS; n += 2) {
        uint32_t vf[4];
        sm90::load_b_nk(vf, Vt, ld, n * 8, kk * 16, lane);
        sm90::mma_bf16(dp[n], a, vf[0], vf[1]);
        sm90::mma_bf16(dp[n + 1], a, vf[2], vf[3]);
      }
    }

    // scores in base 2, masked only where the tile crosses the diagonal or
    // the keys' end; then p and ds = p (dp - delta) in place of dp
    const int c0 = j * KT;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = __fmul_rn(s[n][e], scale_log2);
    if (c0 + KT > Sk || (causal && c0 + KT - 1 > r0 + wrow0)) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + n * 8 + 2 * t + (e & 1);
          const int row = r0 + wrow0 + g + (e >> 1) * 8;
          if ((causal && col > row) || col >= Sk) s[n][e] = kMaskValue;
        }
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(__fsub_rn(s[n][e], lse2[e >> 1]));
        dp[n][e] = __fmul_rn(p, __fsub_rn(dp[n][e], dlt[e >> 1]));
      }

    // dQ += dS K, dS rounded to bf16 on its way to the A fragment
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4];
      sm90::c_to_a(a, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        uint32_t kf[4];
        sm90::load_b_kn(kf, Kt, ld, kk * 16, n * 8, lane);
        sm90::mma_bf16(acc[n], a, kf[0], kf[1]);
        sm90::mma_bf16(acc[n + 1], a, kf[2], kf[3]);
      }
    }
  }
  sm90::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + wrow0 + g + 8 * i;
    if (row < Sq) store_row(dq + (((long long)b * Sq + row) * H + h) * D, acc, i, scale, 0, D, t);
  }
}

// -------------------------------------------------- backward dk/dv, bf16
// grid (H, B, kv tiles). dk, dv are contiguous [B, Sk, H, D]. Causal: the
// first q tile is the one whose last row reaches the kv tile's first column.
template <int Dp>
__global__ void __launch_bounds__(kMmaThreads * dkv_split(Dp))
flash_bwd_dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Sk, int H,
                          int D, Strides qs, Strides ks, Strides vs, Strides gs, float scale,
                          float scale_log2, int causal, int vec) {
  constexpr int kSplit = dkv_split(Dp);
  constexpr int kThreadsHere = kMmaThreads * kSplit;
  constexpr int QT = dkv_q_tile(Dp);
  constexpr int ld = Dp + sm90::kRowPad;
  constexpr int NQ = QT / 8;             // n8 tiles of a transposed score row block
  constexpr int NO = Dp / 8 / kSplit;    // n8 tiles of dK and dV a warp owns
  constexpr int KD = Dp / 16;            // k16 steps of K Q^T and V dO^T
  constexpr int KQ = QT / 16;            // k16 steps of P^T dO and dS^T Q
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + kMmaRows * ld;
  bf16* Qs = Vs + kMmaRows * ld;         // kStages stages of QT rows
  bf16* Gs = Qs + kStages * QT * ld;     // dO, the same
  float* Ls = reinterpret_cast<float*>(Gs + kStages * QT * ld);   // lse, kStages x QT
  float* Ds = Ls + kStages * QT;                                  // delta

  const int h = blockIdx.x, b = blockIdx.y, c0 = (int)blockIdx.z * kMmaRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wrow0 = (warp % 4) * 16;                 // the warp's kv rows
  const int col0 = (warp / 4) * (Dp / kSplit);       // its columns of dK and dV
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* gb = dout + b * gs.b + h * gs.h;
  const long long row_base = ((long long)b * H + h) * Sq;

  const int q_tiles = (Sq + QT - 1) / QT;
  const int lo = causal ? min(q_tiles, c0 / QT) : 0;

  // the ring: q tile i lives in stage (i - lo) % kStages with its lse and
  // delta; one group per tile (K and V ride with the first)
  auto stage_q = [&](int i) {
    const int st = (i - lo) % kStages, r0 = i * QT;
    sm90::stage_tile<Dp, kThreadsHere>(Qs + st * QT * ld, qb, qs.s, r0, Sq, QT, D, vec);
    sm90::stage_tile<Dp, kThreadsHere>(Gs + st * QT * ld, gb, gs.s, r0, Sq, QT, D, vec);
    for (int x = threadIdx.x; x < 2 * QT; x += kThreadsHere) {
      const int r = x % QT;
      const bool ok = r0 + r < Sq;
      const float* src = (x < QT ? lse : delta) + row_base + (ok ? r0 + r : 0);
      sm90::cp_async_4((x < QT ? Ls : Ds) + st * QT + r, src, ok);
    }
  };
  sm90::stage_tile<Dp, kThreadsHere>(Ks, k + b * ks.b + h * ks.h, ks.s, c0, Sk, kMmaRows, D, vec);
  sm90::stage_tile<Dp, kThreadsHere>(Vs, v + b * vs.b + h * vs.h, vs.s, c0, Sk, kMmaRows, D, vec);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (lo + i < q_tiles) stage_q(lo + i);
    sm90::cp_async_commit();
  }

  // this thread's two kv rows are kv_lo and kv_lo + 8
  const int kv_lo = c0 + wrow0 + g;
  const bool kv_edge = c0 + wrow0 + 15 >= Sk;
  float dka[NO][4], dva[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }

  for (int i = lo; i < q_tiles; ++i) {
    sm90::cp_async_wait<kStages - 2>();
    __syncthreads();     // tile i visible; every warp is past tile i - 1
    if (i + kStages - 1 < q_tiles) stage_q(i + kStages - 1);
    sm90::cp_async_commit();
    const int st = (i - lo) % kStages, r0 = i * QT;
    const bf16* Qt = Qs + st * QT * ld;
    const bf16* Gt = Gs + st * QT * ld;
    const float* Lt = Ls + st * QT;
    const float* Dt = Ds + st * QT;

    // S^T = K Q^T and dP^T = V dO^T: rows are this warp's kv rows
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4];
      sm90::load_a(a, Ks, ld, wrow0, kk * 16, lane);
#pragma unroll
      for (int n = 0; n < NQ; n += 2) {
        uint32_t f[4];
        sm90::load_b_nk(f, Qt, ld, n * 8, kk * 16, lane);
        sm90::mma_bf16(s[n], a, f[0], f[1]);
        sm90::mma_bf16(s[n + 1], a, f[2], f[3]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4];
      sm90::load_a(a, Vs, ld, wrow0, kk * 16, lane);
#pragma unroll
      for (int n = 0; n < NQ; n += 2) {
        uint32_t f[4];
        sm90::load_b_nk(f, Gt, ld, n * 8, kk * 16, lane);
        sm90::mma_bf16(dp[n], a, f[0], f[1]);
        sm90::mma_bf16(dp[n + 1], a, f[2], f[3]);
      }
    }

    // scores in base 2, masked where the tile crosses the diagonal or the
    // keys' end; then p in place of s and ds in place of dp. A C fragment's
    // column is a q row, so lse and delta come per column from the ring.
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = __fmul_rn(s[n][e], scale_log2);
    if (kv_edge || (causal && c0 + wrow0 + 15 > r0)) {
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = kv_lo + (e >> 1) * 8;
          const int row = r0 + n * 8 + 2 * t + (e & 1);
          if ((causal && col > row) || col >= Sk) s[n][e] = kMaskValue;
        }
    }
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
      const float2 lq = *reinterpret_cast<const float2*>(Lt + n * 8 + 2 * t);
      const float2 dd = *reinterpret_cast<const float2*>(Dt + n * 8 + 2 * t);
      const float l2[2] = {__fmul_rn(lq.x, kLog2e), __fmul_rn(lq.y, kLog2e)};
      const float dl[2] = {dd.x, dd.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(__fsub_rn(s[n][e], l2[e & 1]));
        s[n][e] = p;
        dp[n][e] = __fmul_rn(p, __fsub_rn(dp[n][e], dl[e & 1]));
      }
    }

    // dV += P^T dO and dK += dS^T Q over this warp's columns, P^T and dS^T
    // rounded to bf16 on their way to the A fragments
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
      uint32_t a[4];
      sm90::c_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t f[4];
        sm90::load_b_kn(f, Gt, ld, kk * 16, col0 + n * 8, lane);
        sm90::mma_bf16(dva[n], a, f[0], f[1]);
        sm90::mma_bf16(dva[n + 1], a, f[2], f[3]);
      }
      sm90::c_to_a(a, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t f[4];
        sm90::load_b_kn(f, Qt, ld, kk * 16, col0 + n * 8, lane);
        sm90::mma_bf16(dka[n], a, f[0], f[1]);
        sm90::mma_bf16(dka[n + 1], a, f[2], f[3]);
      }
    }
  }
  sm90::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = kv_lo + 8 * i;
    if (row >= Sk) continue;
    const long long at = (((long long)b * Sk + row) * H + h) * D;
    store_row(dk + at, dka, i, scale, col0, D, t);
    store_row(dv + at, dva, i, 1.f, col0, D, t);
  }
}

// ---------------------------------------------- fp32 kernels (split TF32)
//
// The bf16 kernels' shape with fp32 operands: every product is three
// mma.sync m16n8k8 tf32 products (sm90::mma_3xtf32), each operand split into
// hi and lo in registers right after its fragment is read from shared
// memory, so shared memory holds each tile once. Shared rows are Dp + 4
// floats; fragments come through scalar loads (ldmatrix moves 16-bit pairs)
// free of bank conflicts. A C fragment of scores becomes the A fragment of
// the next product in registers (sm90::c_to_a_tf32), V's, dO's, Q's and
// K's rows read in its k order.

// kv tile rows of the fp32 forward: the Q tile and a two-stage ring of K
// and V fit two blocks an SM up to Dp = 128 (101,376 bytes) and one above.
constexpr int kF32KvTile = 32;
// kv tile rows of the fp32 dq kernel: Q, dO and a two-stage ring of K and V
// fit two blocks an SM up to Dp = 128 (101,376 bytes; 32-row kv tiles would
// leave room for one) and one above (199,680 at Dp = 256).
constexpr int kF32DqKvTile = 16;
// q tile rows of the fp32 dk/dv kernel: K, V and a two-stage ring of Q and
// dO fit two blocks an SM up to Dp = 128 (101,632 bytes; 32-row q tiles
// would leave room for one) and one above (199,936 at Dp = 256).
constexpr int kF32QTile = 16;
// The fp32 kernels declare at least one block an SM: without it ptxas
// trades registers for a third block that shared memory does not allow,
// and spills.

// Row i (0: g, 1: g + 8) of a warp's 16-row block of C fragments acc[N8][4],
// times `mul`, into columns [col0, col0 + 8 * N8) of `row`, those from D on
// dropped.
template <int N8>
__device__ __forceinline__ void store_row_f32(float* row, const float (&acc)[N8][4], int i,
                                              float mul, int col0, int D, int t) {
#pragma unroll
  for (int n = 0; n < N8; ++n) {
    const int col = col0 + n * 8 + 2 * t;
    const float v0 = __fmul_rn(acc[n][2 * i], mul), v1 = __fmul_rn(acc[n][2 * i + 1], mul);
    if ((D & 1) == 0 && col + 1 < D) {
      *reinterpret_cast<float2*>(row + col) = make_float2(v0, v1);
    } else {
      if (col < D) row[col] = v0;
      if (col + 1 < D) row[col + 1] = v1;
    }
  }
}

// ------------------------------------------------------ forward, fp32
// grid (H, B, q tiles). o is contiguous [B, Sq, H, D], lse fp32 [B, H, Sq].
// The shape of flash_fwd_bf16_kernel with 32-row kv tiles and scores in
// base e.
template <int Dp>
__global__ void __launch_bounds__(kMmaThreads, 1)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                     int Sq, int Sk, int H, int D, Strides qs, Strides ks, Strides vs,
                     float scale, int causal, int q_offset, int vec) {
  constexpr int KT = kF32KvTile;
  constexpr int ld = Dp + sm90::kF32RowPad;
  constexpr int NS = KT / 8;             // n8 tiles of a score row block; k8 steps of P V
  constexpr int ND = Dp / 8;             // n8 tiles of an output row block; k8 steps of Q K^T
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + kMmaRows * ld;        // kStages stages of KT rows
  float* Vs = Ks + kStages * KT * ld;

  const int h = blockIdx.x, b = blockIdx.y;
  const int r0 = ((int)gridDim.z - 1 - (int)blockIdx.z) * kMmaRows;   // heaviest first
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wrow0 = warp * 16;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;

  const int kv_tiles = (Sk + KT - 1) / KT;
  int hi = kv_tiles;
  if (causal) {
    const int last_row = r0 + kMmaRows - 1 + q_offset;
    hi = last_row < 0 ? 0 : min(kv_tiles, last_row / KT + 1);
  }

  // the ring: kv tile j lives in stage j % kStages, issued kStages - 1 tiles
  // ahead; one group per tile (Q rides with tile 0)
  auto stage_kv = [&](int j) {
    const int at = (j % kStages) * KT * ld;
    sm90::stage_tile_f32<Dp, kMmaThreads>(Ks + at, kb, ks.s, j * KT, Sk, KT, D, vec);
    sm90::stage_tile_f32<Dp, kMmaThreads>(Vs + at, vb, vs.s, j * KT, Sk, KT, D, vec);
  };
  sm90::stage_tile_f32<Dp, kMmaThreads>(Qs, qb, qs.s, r0, Sq, kMmaRows, D, vec);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < hi) stage_kv(i);
    sm90::cp_async_commit();
  }

  // this thread's two rows (g and g + 8 of the warp's 16), on the causal scale
  const int row_lo = r0 + wrow0 + g + q_offset;
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int j = 0; j < hi; ++j) {
    sm90::cp_async_wait<kStages - 2>();
    __syncthreads();     // tile j visible; every warp is past tile j - 1
    if (j + kStages - 1 < hi) stage_kv(j + kStages - 1);
    sm90::cp_async_commit();
    const float* Kt = Ks + (j % kStages) * KT * ld;
    const float* Vt = Vs + (j % kStages) * KT * ld;

    // S = Q K^T, then scores times the scale
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) {
      uint32_t ah[4], al[4];
      sm90::load_a_tf32(ah, al, Qs, ld, wrow0, kk * 8, lane);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        uint32_t bh[2], bl[2];
        sm90::load_b_nk_tf32(bh, bl, Kt, ld, n * 8, kk * 8, lane);
        sm90::mma_3xtf32(s[n], ah, al, bh, bl);
      }
    }
    const int c0 = j * KT;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = __fmul_rn(s[n][e], scale);
    // element masks only where the tile crosses the diagonal or the keys' end
    if (c0 + KT > Sk || (causal && c0 + KT - 1 > r0 + wrow0 + q_offset)) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + n * 8 + 2 * t + (e & 1);
          const int row = row_lo + (e >> 1) * 8;
          if ((causal && col > row) || col >= Sk) s[n][e] = kMaskValue;
        }
    }

    // online softmax over the thread's two rows; quads hold whole rows
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m[i];
#pragma unroll
      for (int n = 0; n < NS; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
      mx = sm90::quad_max(mx);
      alpha[i] = expf(__fsub_rn(m[i], mx));
      m[i] = mx;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        s[n][2 * i] = expf(__fsub_rn(s[n][2 * i], mx));
        s[n][2 * i + 1] = expf(__fsub_rn(s[n][2 * i + 1], mx));
        sum += s[n][2 * i] + s[n][2 * i + 1];
      }
      l[i] = __fadd_rn(__fmul_rn(alpha[i], l[i]), sm90::quad_sum(sum));
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V, P's C fragments as the A operand
#pragma unroll
    for (int kk = 0; kk < NS; ++kk) {
      uint32_t ah[4], al[4];
      sm90::c_to_a_tf32(ah, al, s[kk]);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        uint32_t bh[2], bl[2];
        sm90::load_b_kn_tf32(bh, bl, Vt, ld, kk * 8, n * 8, lane);
        sm90::mma_3xtf32(acc[n], ah, al, bh, bl);
      }
    }
  }
  sm90::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + wrow0 + g + 8 * i;
    if (row >= Sq) continue;
    const float l_inv = l[i] == 0.f ? 1.f : 1.f / l[i];
    store_row_f32(o + (((long long)b * Sq + row) * H + h) * D, acc, i, l_inv, 0, D, t);
    if (t == 0)
      lse[((long long)b * H + h) * Sq + row] = l[i] == 0.f ? 0.f : __fadd_rn(m[i], logf(l[i]));
  }
}

// ------------------------------------------------------ backward dq, fp32
// grid (H, B, q tiles). lse and delta are fp32 [B, H, Sq]; dq is contiguous
// [B, Sq, H, D]. The shape of flash_bwd_dq_bf16_kernel with 16-row kv tiles
// and scores in base e. No q_offset: the caller takes another route for it.
template <int Dp>
__global__ void __launch_bounds__(kMmaThreads, 1)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dq, int Sq, int Sk, int H, int D, Strides qs,
                        Strides ks, Strides vs, Strides gs, float scale, int causal, int vec) {
  constexpr int KT = kF32DqKvTile;
  constexpr int ld = Dp + sm90::kF32RowPad;
  constexpr int NS = KT / 8;             // n8 tiles of a score row block; k8 steps of dS K
  constexpr int ND = Dp / 8;             // n8 tiles of the dQ row block; k8 steps of Q K^T
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Gs = Qs + kMmaRows * ld;        // dO
  float* Ks = Gs + kMmaRows * ld;        // kStages stages of KT rows
  float* Vs = Ks + kStages * KT * ld;

  const int h = blockIdx.x, b = blockIdx.y;
  const int r0 = ((int)gridDim.z - 1 - (int)blockIdx.z) * kMmaRows;   // heaviest first
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wrow0 = warp * 16;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;

  const int kv_tiles = (Sk + KT - 1) / KT;
  const int hi = causal ? min(kv_tiles, (r0 + kMmaRows - 1) / KT + 1) : kv_tiles;

  auto stage_kv = [&](int j) {
    const int at = (j % kStages) * KT * ld;
    sm90::stage_tile_f32<Dp, kMmaThreads>(Ks + at, kb, ks.s, j * KT, Sk, KT, D, vec);
    sm90::stage_tile_f32<Dp, kMmaThreads>(Vs + at, vb, vs.s, j * KT, Sk, KT, D, vec);
  };
  sm90::stage_tile_f32<Dp, kMmaThreads>(Qs, q + b * qs.b + h * qs.h, qs.s, r0, Sq, kMmaRows,
                                        D, vec);
  sm90::stage_tile_f32<Dp, kMmaThreads>(Gs, dout + b * gs.b + h * gs.h, gs.s, r0, Sq,
                                        kMmaRows, D, vec);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < hi) stage_kv(i);
    sm90::cp_async_commit();
  }

  // this thread's two rows (g and g + 8 of the warp's 16): lse and delta
  // (rows past Sq meet zero q and dO rows, so their ds is 0)
  const long long row_base = ((long long)b * H + h) * Sq;
  float ls[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + wrow0 + g + 8 * i;
    ls[i] = row < Sq ? lse[row_base + row] : 0.f;
    dlt[i] = row < Sq ? delta[row_base + row] : 0.f;
  }
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int j = 0; j < hi; ++j) {
    sm90::cp_async_wait<kStages - 2>();
    __syncthreads();     // tile j visible; every warp is past tile j - 1
    if (j + kStages - 1 < hi) stage_kv(j + kStages - 1);
    sm90::cp_async_commit();
    const float* Kt = Ks + (j % kStages) * KT * ld;
    const float* Vt = Vs + (j % kStages) * KT * ld;

    // S = Q K^T and dP = dO V^T
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) {
      uint32_t qh[4], ql[4], gh[4], gl[4];
      sm90::load_a_tf32(qh, ql, Qs, ld, wrow0, kk * 8, lane);
      sm90::load_a_tf32(gh, gl, Gs, ld, wrow0, kk * 8, lane);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        uint32_t bh[2], bl[2];
        sm90::load_b_nk_tf32(bh, bl, Kt, ld, n * 8, kk * 8, lane);
        sm90::mma_3xtf32(s[n], qh, ql, bh, bl);
        sm90::load_b_nk_tf32(bh, bl, Vt, ld, n * 8, kk * 8, lane);
        sm90::mma_3xtf32(dp[n], gh, gl, bh, bl);
      }
    }

    // scores times the scale, masked only where the tile crosses the
    // diagonal or the keys' end; then ds = p (dp - delta) in place of dp
    const int c0 = j * KT;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = __fmul_rn(s[n][e], scale);
    if (c0 + KT > Sk || (causal && c0 + KT - 1 > r0 + wrow0)) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + n * 8 + 2 * t + (e & 1);
          const int row = r0 + wrow0 + g + (e >> 1) * 8;
          if ((causal && col > row) || col >= Sk) s[n][e] = kMaskValue;
        }
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(__fsub_rn(s[n][e], ls[e >> 1]));
        dp[n][e] = __fmul_rn(p, __fsub_rn(dp[n][e], dlt[e >> 1]));
      }

    // dQ += dS K, dS's C fragments as the A operand, K's rows in their k order
#pragma unroll
    for (int kk = 0; kk < NS; ++kk) {
      uint32_t ah[4], al[4];
      sm90::c_to_a_tf32(ah, al, dp[kk]);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        uint32_t bh[2], bl[2];
        sm90::load_b_kn_tf32(bh, bl, Kt, ld, kk * 8, n * 8, lane);
        sm90::mma_3xtf32(acc[n], ah, al, bh, bl);
      }
    }
  }
  sm90::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + wrow0 + g + 8 * i;
    if (row < Sq)
      store_row_f32(dq + (((long long)b * Sq + row) * H + h) * D, acc, i, scale, 0, D, t);
  }
}

// -------------------------------------------------- backward dk/dv, fp32
// grid (H, B, kv tiles). dk, dv are contiguous [B, Sk, H, D]. The shape of
// flash_bwd_dkv_bf16_kernel with fp32 q tiles of 16 rows and scores in base
// e. Causal: the first q tile is the one whose last row
// reaches the kv tile's first column.
template <int Dp>
__global__ void __launch_bounds__(kMmaThreads * dkv_split(Dp), 1)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv, int Sq, int Sk, int H,
                         int D, Strides qs, Strides ks, Strides vs, Strides gs, float scale,
                         int causal, int vec) {
  constexpr int kSplit = dkv_split(Dp);
  constexpr int kThreadsHere = kMmaThreads * kSplit;
  constexpr int QT = kF32QTile;
  constexpr int ld = Dp + sm90::kF32RowPad;
  constexpr int NQ = QT / 8;             // n8 tiles of a transposed score row block;
                                         // k8 steps of P^T dO and dS^T Q
  constexpr int NO = Dp / 8 / kSplit;    // n8 tiles of dK and dV a warp owns
  constexpr int KD = Dp / 8;             // k8 steps of K Q^T and V dO^T
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);
  float* Vs = Ks + kMmaRows * ld;
  float* Qs = Vs + kMmaRows * ld;        // kStages stages of QT rows
  float* Gs = Qs + kStages * QT * ld;    // dO, the same
  float* Ls = Gs + kStages * QT * ld;    // lse, kStages x QT
  float* Ds = Ls + kStages * QT;         // delta

  const int h = blockIdx.x, b = blockIdx.y, c0 = (int)blockIdx.z * kMmaRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wrow0 = (warp % 4) * 16;                 // the warp's kv rows
  const int col0 = (warp / 4) * (Dp / kSplit);       // its columns of dK and dV
  const float* qb = q + b * qs.b + h * qs.h;
  const float* gb = dout + b * gs.b + h * gs.h;
  const long long row_base = ((long long)b * H + h) * Sq;

  const int q_tiles = (Sq + QT - 1) / QT;
  const int lo = causal ? min(q_tiles, c0 / QT) : 0;

  // the ring: q tile i lives in stage (i - lo) % kStages with its lse and
  // delta; one group per tile (K and V ride with the first)
  auto stage_q = [&](int i) {
    const int st = (i - lo) % kStages, r0 = i * QT;
    sm90::stage_tile_f32<Dp, kThreadsHere>(Qs + st * QT * ld, qb, qs.s, r0, Sq, QT, D, vec);
    sm90::stage_tile_f32<Dp, kThreadsHere>(Gs + st * QT * ld, gb, gs.s, r0, Sq, QT, D, vec);
    for (int x = threadIdx.x; x < 2 * QT; x += kThreadsHere) {
      const int r = x % QT;
      const bool ok = r0 + r < Sq;
      const float* src = (x < QT ? lse : delta) + row_base + (ok ? r0 + r : 0);
      sm90::cp_async_4((x < QT ? Ls : Ds) + st * QT + r, src, ok);
    }
  };
  sm90::stage_tile_f32<Dp, kThreadsHere>(Ks, k + b * ks.b + h * ks.h, ks.s, c0, Sk, kMmaRows, D,
                                         vec);
  sm90::stage_tile_f32<Dp, kThreadsHere>(Vs, v + b * vs.b + h * vs.h, vs.s, c0, Sk, kMmaRows, D,
                                         vec);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (lo + i < q_tiles) stage_q(lo + i);
    sm90::cp_async_commit();
  }

  // this thread's two kv rows are kv_lo and kv_lo + 8
  const int kv_lo = c0 + wrow0 + g;
  const bool kv_edge = c0 + wrow0 + 15 >= Sk;
  float dka[NO][4], dva[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }

  for (int i = lo; i < q_tiles; ++i) {
    sm90::cp_async_wait<kStages - 2>();
    __syncthreads();     // tile i visible; every warp is past tile i - 1
    if (i + kStages - 1 < q_tiles) stage_q(i + kStages - 1);
    sm90::cp_async_commit();
    const int st = (i - lo) % kStages, r0 = i * QT;
    const float* Qt = Qs + st * QT * ld;
    const float* Gt = Gs + st * QT * ld;
    const float* Lt = Ls + st * QT;
    const float* Dt = Ds + st * QT;

    // S^T = K Q^T and dP^T = V dO^T: rows are this warp's kv rows
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t kh[4], kl[4], vh[4], vl[4];
      sm90::load_a_tf32(kh, kl, Ks, ld, wrow0, kk * 8, lane);
      sm90::load_a_tf32(vh, vl, Vs, ld, wrow0, kk * 8, lane);
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        uint32_t bh[2], bl[2];
        sm90::load_b_nk_tf32(bh, bl, Qt, ld, n * 8, kk * 8, lane);
        sm90::mma_3xtf32(s[n], kh, kl, bh, bl);
        sm90::load_b_nk_tf32(bh, bl, Gt, ld, n * 8, kk * 8, lane);
        sm90::mma_3xtf32(dp[n], vh, vl, bh, bl);
      }
    }

    // scores times the scale, masked where the tile crosses the diagonal or
    // the keys' end; then p in place of s and ds in place of dp. A C
    // fragment's column is a q row, so lse and delta come per column.
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = __fmul_rn(s[n][e], scale);
    if (kv_edge || (causal && c0 + wrow0 + 15 > r0)) {
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = kv_lo + (e >> 1) * 8;
          const int row = r0 + n * 8 + 2 * t + (e & 1);
          if ((causal && col > row) || col >= Sk) s[n][e] = kMaskValue;
        }
    }
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
      const float2 lq = *reinterpret_cast<const float2*>(Lt + n * 8 + 2 * t);
      const float2 dd = *reinterpret_cast<const float2*>(Dt + n * 8 + 2 * t);
      const float ls[2] = {lq.x, lq.y}, dl[2] = {dd.x, dd.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(__fsub_rn(s[n][e], ls[e & 1]));
        s[n][e] = p;
        dp[n][e] = __fmul_rn(p, __fsub_rn(dp[n][e], dl[e & 1]));
      }
    }

    // dV += P^T dO, then dK += dS^T Q, over this warp's columns, P^T and
    // dS^T from their C fragments; the tile's products are summed apart and
    // added in round-to-nearest (sm90::add_rn)
    uint32_t ah[NQ][4], al[NQ][4];
#pragma unroll
    for (int kk = 0; kk < NQ; ++kk) sm90::c_to_a_tf32(ah[kk], al[kk], s[kk]);
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < NQ; ++kk) {
        uint32_t bh[2], bl[2];
        sm90::load_b_kn_tf32(bh, bl, Gt, ld, kk * 8, col0 + n * 8, lane);
        sm90::mma_3xtf32(part, ah[kk], al[kk], bh, bl);
      }
      sm90::add_rn(dva[n], part);
    }
#pragma unroll
    for (int kk = 0; kk < NQ; ++kk) sm90::c_to_a_tf32(ah[kk], al[kk], dp[kk]);
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < NQ; ++kk) {
        uint32_t bh[2], bl[2];
        sm90::load_b_kn_tf32(bh, bl, Qt, ld, kk * 8, col0 + n * 8, lane);
        sm90::mma_3xtf32(part, ah[kk], al[kk], bh, bl);
      }
      sm90::add_rn(dka[n], part);
    }
  }
  sm90::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = kv_lo + 8 * i;
    if (row >= Sk) continue;
    const long long at = (((long long)b * Sk + row) * H + h) * D;
    store_row_f32(dk + at, dka, i, scale, col0, D, t);
    store_row_f32(dv + at, dva, i, 1.f, col0, D, t);
  }
}

// ------------------------------------------------------------------ host

int round16(int d) { return (d + 15) / 16 * 16; }

// Rows of every tile the kernels walk, by io type (0 fp32, 1 bf16), head
// dim and `which`: 0 forward q tile, 1 forward kv tile, 2 dq's q rows, 3
// dq's kv tile, 4 dk/dv's kv rows, 5 dk/dv's q tile.
int tile_rows(int dtype, int D, int which) {
  if (dtype != 1) {
    switch (which) {
      case 1: return kF32KvTile;
      case 3: return kF32DqKvTile;
      case 5: return kF32QTile;
      default: return kMmaRows;
    }
  }
  const int Dp = sm90::padded_head_dim(D);
  switch (which) {
    case 1: return fwd_kv_tile(Dp);
    case 3: return dq_kv_tile(Dp);
    case 5: return dkv_q_tile(Dp);
    default: return kMmaRows;
  }
}

// Calls f(std::integral_constant<int, Dp>{}) with D's padded head dim.
template <typename F> int with_padded_dim(int D, F f) {
  switch (sm90::padded_head_dim(D)) {
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 96: return f(std::integral_constant<int, 96>{});
    case 128: return f(std::integral_constant<int, 128>{});
    case 192: return f(std::integral_constant<int, 192>{});
    case 256: return f(std::integral_constant<int, 256>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

// The same with the fp32 kernels' padded head dim, D rounded up to 16.
template <typename F> int with_f32_dim(int D, F f) {
  switch (round16(D)) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 48: return f(std::integral_constant<int, 48>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 80: return f(std::integral_constant<int, 80>{});
    case 96: return f(std::integral_constant<int, 96>{});
    case 112: return f(std::integral_constant<int, 112>{});
    case 128: return f(std::integral_constant<int, 128>{});
    case 144: return f(std::integral_constant<int, 144>{});
    case 160: return f(std::integral_constant<int, 160>{});
    case 176: return f(std::integral_constant<int, 176>{});
    case 192: return f(std::integral_constant<int, 192>{});
    case 208: return f(std::integral_constant<int, 208>{});
    case 224: return f(std::integral_constant<int, 224>{});
    case 240: return f(std::integral_constant<int, 240>{});
    case 256: return f(std::integral_constant<int, 256>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of the bf16 kernels: 0 forward, 1 dq, 2 dk/dv.
template <int Dp> size_t bf16_smem_bytes(int kernel) {
  constexpr size_t row = sizeof(bf16) * (Dp + sm90::kRowPad);
  if (kernel == 0) return row * (kMmaRows + 2 * kStages * fwd_kv_tile(Dp));
  if (kernel == 1) return row * (2 * kMmaRows + 2 * kStages * dq_kv_tile(Dp));
  return row * (2 * kMmaRows + 2 * kStages * dkv_q_tile(Dp)) +
         sizeof(float) * 2 * kStages * dkv_q_tile(Dp);
}

// Dynamic shared memory of the fp32 split-TF32 kernels: 0 forward, 1 dq,
// 2 dk/dv.
template <int Dp> size_t f32_smem_bytes(int kernel) {
  constexpr size_t row = sizeof(float) * (Dp + sm90::kF32RowPad);
  if (kernel == 0) return row * (kMmaRows + 2 * kStages * kF32KvTile);
  if (kernel == 1) return row * (2 * kMmaRows + 2 * kStages * kF32DqKvTile);
  return row * (2 * kMmaRows + 2 * kStages * kF32QTile) + sizeof(float) * 2 * kStages * kF32QTile;
}

int smem_bytes_for(int kernel, int dtype, int D) {
  if (dtype == 1)
    return with_padded_dim(
        D, [&](auto dp) { return (int)bf16_smem_bytes<decltype(dp)::value>(kernel); });
  return with_f32_dim(D,
                      [&](auto dp) { return (int)f32_smem_bytes<decltype(dp)::value>(kernel); });
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

struct Args {
  const void *q, *k, *v, *g, *lse, *delta;
  void *o0, *o1;       // forward: o, lse; dq: dq; dk/dv: dk, dv
  int B, Sq, Sk, H, D;
  Strides qs, ks, vs, gs;
  float scale;
  int causal, q_offset, vec;
  cudaStream_t st;
};

#define SEED_F32(p) static_cast<const float*>(p)
#define SEED_BF16(p) static_cast<const bf16*>(p)

template <int Dp> int launch_f32(int kernel, const Args& a) {
  const int tiles = ((kernel == 2 ? a.Sk : a.Sq) + kMmaRows - 1) / kMmaRows;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = f32_smem_bytes<Dp>(kernel);
  cudaError_t err = kernel == 0   ? allow_smem(flash_fwd_f32_kernel<Dp>, smem)
                    : kernel == 1 ? allow_smem(flash_bwd_dq_f32_kernel<Dp>, smem)
                                  : allow_smem(flash_bwd_dkv_f32_kernel<Dp>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.H, a.B, tiles);
  float* o0 = static_cast<float*>(a.o0);
  float* o1 = static_cast<float*>(a.o1);
  if (kernel == 0)
    flash_fwd_f32_kernel<Dp><<<grid, kMmaThreads, smem, a.st>>>(
        SEED_F32(a.q), SEED_F32(a.k), SEED_F32(a.v), o0, o1, a.Sq, a.Sk, a.H, a.D, a.qs, a.ks,
        a.vs, a.scale, a.causal, a.q_offset, a.vec);
  else if (kernel == 1)
    flash_bwd_dq_f32_kernel<Dp><<<grid, kMmaThreads, smem, a.st>>>(
        SEED_F32(a.q), SEED_F32(a.k), SEED_F32(a.v), SEED_F32(a.g), SEED_F32(a.lse),
        SEED_F32(a.delta), o0, a.Sq, a.Sk, a.H, a.D, a.qs, a.ks, a.vs, a.gs, a.scale, a.causal,
        a.vec);
  else
    flash_bwd_dkv_f32_kernel<Dp><<<grid, kMmaThreads * dkv_split(Dp), smem, a.st>>>(
        SEED_F32(a.q), SEED_F32(a.k), SEED_F32(a.v), SEED_F32(a.g), SEED_F32(a.lse),
        SEED_F32(a.delta), o0, o1, a.Sq, a.Sk, a.H, a.D, a.qs, a.ks, a.vs, a.gs, a.scale,
        a.causal, a.vec);
  return (int)cudaGetLastError();
}

template <int Dp> int launch_bf16(int kernel, const Args& a) {
  const int tiles = ((kernel == 2 ? a.Sk : a.Sq) + kMmaRows - 1) / kMmaRows;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = bf16_smem_bytes<Dp>(kernel);
  cudaError_t err = kernel == 0   ? allow_smem(flash_fwd_bf16_kernel<Dp>, smem)
                    : kernel == 1 ? allow_smem(flash_bwd_dq_bf16_kernel<Dp>, smem)
                                  : allow_smem(flash_bwd_dkv_bf16_kernel<Dp>, smem);
  if (err != cudaSuccess) return (int)err;
  const float scale_log2 = a.scale * kLog2e;
  dim3 grid(a.H, a.B, tiles);
  bf16* o0 = static_cast<bf16*>(a.o0);
  if (kernel == 0)
    flash_fwd_bf16_kernel<Dp><<<grid, kMmaThreads, smem, a.st>>>(
        SEED_BF16(a.q), SEED_BF16(a.k), SEED_BF16(a.v), o0, static_cast<float*>(a.o1), a.Sq,
        a.Sk, a.H, a.D, a.qs, a.ks, a.vs, scale_log2, a.causal, a.q_offset, a.vec);
  else if (kernel == 1)
    flash_bwd_dq_bf16_kernel<Dp><<<grid, kMmaThreads, smem, a.st>>>(
        SEED_BF16(a.q), SEED_BF16(a.k), SEED_BF16(a.v), SEED_BF16(a.g), SEED_F32(a.lse),
        SEED_F32(a.delta), o0, a.Sq, a.Sk, a.H, a.D, a.qs, a.ks, a.vs, a.gs, a.scale,
        scale_log2, a.causal, a.vec);
  else
    flash_bwd_dkv_bf16_kernel<Dp><<<grid, kMmaThreads * dkv_split(Dp), smem, a.st>>>(
        SEED_BF16(a.q), SEED_BF16(a.k), SEED_BF16(a.v), SEED_BF16(a.g), SEED_F32(a.lse),
        SEED_F32(a.delta), o0, static_cast<bf16*>(a.o1), a.Sq, a.Sk, a.H, a.D, a.qs, a.ks,
        a.vs, a.gs, a.scale, scale_log2, a.causal, a.vec);
  return (int)cudaGetLastError();
}

#undef SEED_F32
#undef SEED_BF16

int launch(int kernel, int dtype, const Args& a) {
  if (a.B < 1 || a.Sq < 1 || a.Sk < 1 || a.H < 1 || a.D < 1 || a.D > 256 || a.H > 65535 ||
      a.B > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return with_f32_dim(a.D, [&](auto dp) { return launch_f32<decltype(dp)::value>(kernel, a); });
  return with_padded_dim(a.D, [&](auto dp) { return launch_bf16<decltype(dp)::value>(kernel, a); });
}

Strides strides_at(const long long* s, int i) { return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]}; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dO and every output but lse).
// `strides` holds (batch, sequence, head) element strides of q, k, v and, for
// the backward kernels, dO, in that order; the head dim has a unit stride.
// `vec` says that a call may move 16 bytes at a time (see sm90::stage_tile
// and sm90::stage_tile_f32). Outputs are contiguous [B, S, H, D]; lse and
// delta are fp32 [B, H, Sq]. Each launch returns its cudaError_t (0 on success).

// Rows of the tiles the kernels walk (tile_rows above): the wrapper's mirror.
extern "C" int seed_flash_tile(int dtype, int D, int which) { return tile_rows(dtype, D, which); }

// Dynamic shared memory of one block of kernel 0 (forward), 1 (dq) or 2 (dk/dv).
extern "C" int seed_flash_smem_bytes(int kernel, int dtype, int D) {
  return smem_bytes_for(kernel, dtype, D);
}

extern "C" int seed_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                              int B, int Sq, int Sk, int H, int D, const long long* strides,
                              float scale, int causal, int q_offset, int vec, int dtype,
                              void* stream) {
  const Strides none{0, 0, 0};
  return launch(0, dtype,
                Args{q, k, v, nullptr, nullptr, nullptr, o, lse, B, Sq, Sk, H, D,
                     strides_at(strides, 0), strides_at(strides, 1), strides_at(strides, 2),
                     none, scale, causal, q_offset, vec,
                     static_cast<cudaStream_t>(stream)});
}

extern "C" int seed_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dq, int B, int Sq,
                                 int Sk, int H, int D, const long long* strides, float scale,
                                 int causal, int vec, int dtype, void* stream) {
  return launch(1, dtype,
                Args{q, k, v, dout, lse, delta, dq, nullptr, B, Sq, Sk, H, D,
                     strides_at(strides, 0), strides_at(strides, 1), strides_at(strides, 2),
                     strides_at(strides, 3), scale, causal, 0, vec,
                     static_cast<cudaStream_t>(stream)});
}

extern "C" int seed_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse, const void* delta,
                                  void* dk, void* dv, int B, int Sq, int Sk, int H, int D,
                                  const long long* strides, float scale, int causal, int vec,
                                  int dtype, void* stream) {
  return launch(2, dtype,
                Args{q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, H, D,
                     strides_at(strides, 0), strides_at(strides, 1), strides_at(strides, 2),
                     strides_at(strides, 3), scale, causal, 0, vec,
                     static_cast<cudaStream_t>(stream)});
}
