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
//
// What bounds it on the H100: at the training shape (B=4, H=32, S=1024, D=128,
// bf16, causal) the forward is 2*B*H*S*S*D = 34 GFLOP over 134 MB of q, k, v
// and o, about 256 operations per byte: just under the card's 295, so a
// full-rate kernel sits at the memory bound (0.040 ms) with the tensor cores
// (0.035 ms) right behind. dq runs three such products and dk/dv four, over
// 1.25x and 1.5x the forward's bytes, so both are bound by operations (0.052
// and 0.070 ms).
//
// Design: the TPU kernel keeps whole K/V rows of a head in VMEM and walks
// 512-row tiles; a Hopper block has 227 KB. Here one block owns (batch, head,
// one q tile) in the forward and in dq, and (batch, head, one kv tile) in
// dk/dv, and streams the other side through shared memory tile by tile, so
// no kernel needs atomics and results repeat from run to run. Tiles are
// square: 64 rows for bf16 (32 when D > 128), 32 for fp32 (16 when D > 128),
// which keeps the largest kernel (dk/dv: four operand tiles, two fp32 score
// tiles, two io-type tiles and two fp32 accumulators) inside shared memory up
// to D = 256. Every product runs out of shared memory through one tile
// primitive: bf16 takes the tensor cores through WMMA (mma.sync) fragments
// with fp32 accumulators that live in shared memory between steps, which is
// what lets the forward rescale its accumulator rows by exp(m_old - m_new)
// without knowing the fragment layout; fp32 has no full-precision tensor-core
// path (TF32 rounds the products) and runs the same primitive on the FMA
// units. q, k, v and dO are read in place as [B, S, H, D] through element
// strides, ragged S and D are masked while staging (rows past the end and
// columns from D up to the next multiple of 16 are zero), and nothing is
// padded or transposed in device memory. It is a first, simple kernel:
// accumulators in registers, wgmma and TMA pipelines are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kMaskValue = (float)(-0.7 * (double)FLT_MAX);

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Row padding of the shared tiles, in elements. bf16 rows keep WMMA's 16-byte
// leading dimension and shift consecutive rows by 4 banks; fp32 rows get an
// odd stride so that lanes reading down a column hit distinct banks.
template <typename T> struct Pad;
template <> struct Pad<__nv_bfloat16> { static constexpr int io = 8, acc = 4; };
template <> struct Pad<float> { static constexpr int io = 1, acc = 1; };

__host__ __device__ inline size_t region(size_t bytes) { return (bytes + 31) / 32 * 32; }

// Hands out 32-byte aligned pieces of the block's dynamic shared memory.
struct Carver {
  unsigned char* p;
  template <typename U> __device__ U* take(int n) {
    U* out = reinterpret_cast<U*>(p);
    p += region((size_t)n * sizeof(U));
    return out;
  }
};

// C[M][N] (+)= sum_k A(m, k) * B(k, n), every operand in shared memory.
//   LA row_major: A(m, k) = A[m * lda + k];  col_major: A[k * lda + m]
//   LB row_major: B(k, n) = B[k * ldb + n];  col_major: B[n * ldb + k]
// M, N and K are multiples of 16. bf16: one 16x16 output fragment per warp at
// a time, fp32 accumulation on the tensor cores.
template <typename LA, typename LB>
__device__ __forceinline__ void tile_mm(float* C, int ldc, const __nv_bfloat16* A, int lda,
                                        const __nv_bfloat16* B, int ldb, int M, int N, int K,
                                        bool accumulate) {
  constexpr bool a_row = std::is_same<LA, wmma::row_major>::value;
  constexpr bool b_row = std::is_same<LB, wmma::row_major>::value;
  const int warp = threadIdx.x >> 5;
  const int nt = N / 16, tiles = (M / 16) * nt;
  for (int t = warp; t < tiles; t += kWarps) {
    const int tm = t / nt, tn = t - tm * nt;
    float* c = C + tm * 16 * ldc + tn * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    if (accumulate) {
      wmma::load_matrix_sync(acc, c, ldc, wmma::mem_row_major);
    } else {
      wmma::fill_fragment(acc, 0.f);
    }
    for (int k0 = 0; k0 < K; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, LA> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, LB> b;
      const __nv_bfloat16* ap = a_row ? A + tm * 16 * lda + k0 : A + k0 * lda + tm * 16;
      const __nv_bfloat16* bp = b_row ? B + k0 * ldb + tn * 16 : B + tn * 16 * ldb + k0;
      wmma::load_matrix_sync(a, ap, lda);
      wmma::load_matrix_sync(b, bp, ldb);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(c, acc, ldc, wmma::mem_row_major);
  }
}

// fp32: each thread owns four rows of one output column; fused multiply-adds.
template <typename LA, typename LB>
__device__ __forceinline__ void tile_mm(float* C, int ldc, const float* A, int lda,
                                        const float* B, int ldb, int M, int N, int K,
                                        bool accumulate) {
  constexpr bool a_row = std::is_same<LA, wmma::row_major>::value;
  constexpr bool b_row = std::is_same<LB, wmma::row_major>::value;
  const int groups = (M / 4) * N;
  for (int idx = threadIdx.x; idx < groups; idx += kThreads) {
    const int mb = idx / N, n = idx - mb * N, m0 = mb * 4;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k = 0; k < K; ++k) {
      const float bv = b_row ? B[k * ldb + n] : B[n * ldb + k];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float av = a_row ? A[(m0 + i) * lda + k] : A[k * lda + m0 + i];
        acc[i] = fmaf(av, bv, acc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* c = C + (m0 + i) * ldc + n;
      *c = accumulate ? *c + acc[i] : acc[i];
    }
  }
}

// Rows [row0, row0 + tile) of one (batch, head) of x[B, S, H, D] into
// dst[tile][ld]: rows from `rows` on and columns from D up to Dp are zero.
// `vec` (bf16 only): D, the strides and the base address are multiples of 8
// elements, so a thread moves 16 bytes at a time.
template <typename T>
__device__ __forceinline__ void stage(T* dst, int ld, const T* src, long long row_stride,
                                      int row0, int rows, int tile, int D, int Dp, int vec) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (vec) {
      const int chunks = Dp / 8;
      for (int i = threadIdx.x; i < tile * chunks; i += kThreads) {
        const int r = i / chunks, c = (i - r * chunks) * 8;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (row0 + r < rows && c < D)
          val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * row_stride + c);
        *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
      }
      return;
    }
  }
  for (int i = threadIdx.x; i < tile * Dp; i += kThreads) {
    const int r = i / Dp, d = i - r * Dp;
    dst[r * ld + d] = (row0 + r < rows && d < D)
                          ? src[(long long)(row0 + r) * row_stride + d]
                          : from_f32<T>(0.f);
  }
}

// Per-row fp32 values (lse, delta) of rows [row0, row0 + tile), zero past `rows`.
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int row0, int rows,
                                           int tile) {
  for (int i = threadIdx.x; i < tile; i += kThreads)
    dst[i] = (row0 + i < rows) ? src[row0 + i] : 0.f;
}

__device__ __forceinline__ float masked_score(float s, float scale, int causal, int row,
                                              int col, int Sk) {
  s *= scale;
  return ((causal && col > row) || col >= Sk) ? kMaskValue : s;
}

struct Strides {
  long long b, s, h;
};

// ---------------------------------------------------------------- forward
// grid (q tiles, H, B). o is contiguous [B, Sq, H, D], lse fp32 [B, H, Sq].
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int Sq, int Sk, int H, int D,
                 int Dp, int tile, Strides qs, Strides ks, Strides vs, float scale, int causal,
                 int q_offset, int vec) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int ldt = Dp + Pad<T>::io, lds = tile + Pad<T>::acc;
  const int ldp = tile + Pad<T>::io, ldo = Dp + Pad<T>::acc;
  Carver cv{smem_raw};
  T* Qs = cv.take<T>(tile * ldt);
  T* Ks = cv.take<T>(tile * ldt);
  T* Vs = cv.take<T>(tile * ldt);
  T* Ps = cv.take<T>(tile * ldp);
  float* Ss = cv.take<float>(tile * lds);
  float* Os = cv.take<float>(tile * ldo);
  float* ms = cv.take<float>(tile);
  float* ls = cv.take<float>(tile);

  const int b = blockIdx.z, h = blockIdx.y, r0 = (int)blockIdx.x * tile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;

  stage(Qs, ldt, qb, qs.s, r0, Sq, tile, D, Dp, vec);
  for (int i = tid; i < tile * ldo; i += kThreads) Os[i] = 0.f;
  for (int i = tid; i < tile; i += kThreads) {
    ms[i] = -INFINITY;
    ls[i] = 0.f;
  }

  // kv tiles this q tile meets: all of them, or up to the diagonal
  const int kv_tiles = (Sk + tile - 1) / tile;
  int hi = kv_tiles;
  if (causal) {
    const int last_row = r0 + tile - 1 + q_offset;
    hi = last_row < 0 ? 0 : min(kv_tiles, last_row / tile + 1);
  }

  for (int j = 0; j < hi; ++j) {
    const int c0 = j * tile;
    __syncthreads();
    stage(Ks, ldt, kb, ks.s, c0, Sk, tile, D, Dp, vec);
    stage(Vs, ldt, vb, vs.s, c0, Sk, tile, D, Dp, vec);
    __syncthreads();
    tile_mm<wmma::row_major, wmma::col_major>(Ss, lds, Qs, ldt, Ks, ldt, tile, tile, Dp, false);
    __syncthreads();

    // online softmax, one warp per row: new max, rescale l and the output
    // row, p rounded to the io type for the product
    for (int r = warp; r < tile; r += kWarps) {
      const int row = r0 + r + q_offset;
      float* srow = Ss + r * lds;
      float mx = -INFINITY;
      for (int c = lane; c < tile; c += 32) {
        const float s = masked_score(srow[c], scale, causal, row, c0 + c, Sk);
        srow[c] = s;
        mx = fmaxf(mx, s);
      }
      mx = warp_max(mx);
      const float m_prev = ms[r], m_next = fmaxf(m_prev, mx);
      const float alpha = expf(m_prev - m_next);
      T* prow = Ps + r * ldp;
      float sum = 0.f;
      for (int c = lane; c < tile; c += 32) {
        const float p = expf(srow[c] - m_next);
        sum += p;
        prow[c] = from_f32<T>(p);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        ms[r] = m_next;
        ls[r] = alpha * ls[r] + sum;
      }
      float* orow = Os + r * ldo;
      for (int d = lane; d < Dp; d += 32) orow[d] *= alpha;
    }
    __syncthreads();
    tile_mm<wmma::row_major, wmma::row_major>(Os, ldo, Ps, ldp, Vs, ldt, tile, Dp, tile, true);
  }
  __syncthreads();

  for (int r = warp; r < tile; r += kWarps) {
    const int row = r0 + r;
    if (row >= Sq) continue;
    const float l = ls[r];
    const float l_inv = l == 0.f ? 1.f : 1.f / l;
    T* orow = o + (((long long)b * Sq + row) * H + h) * D;
    for (int d = lane; d < D; d += 32) orow[d] = from_f32<T>(Os[r * ldo + d] * l_inv);
    if (lane == 0) lse[((long long)b * H + h) * Sq + row] = l == 0.f ? 0.f : ms[r] + logf(l);
  }
}

// ------------------------------------------------------------ backward: dq
// grid (q tiles, H, B). lse and delta are fp32 [B, H, Sq]; dq is contiguous
// [B, Sq, H, D]. No q_offset: the caller takes another route for it.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int Sq, int Sk, int H,
                    int D, int Dp, int tile, Strides qs, Strides ks, Strides vs, Strides gs,
                    float scale, int causal, int vec) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int ldt = Dp + Pad<T>::io, lds = tile + Pad<T>::acc;
  const int ldp = tile + Pad<T>::io, ldo = Dp + Pad<T>::acc;
  Carver cv{smem_raw};
  T* Qs = cv.take<T>(tile * ldt);
  T* Gs = cv.take<T>(tile * ldt);       // dO
  T* Ks = cv.take<T>(tile * ldt);
  T* Vs = cv.take<T>(tile * ldt);
  T* dSs = cv.take<T>(tile * ldp);
  float* Ss = cv.take<float>(tile * lds);
  float* dPs = cv.take<float>(tile * lds);
  float* dQs = cv.take<float>(tile * ldo);
  float* lses = cv.take<float>(tile);
  float* deltas = cv.take<float>(tile);

  const int b = blockIdx.z, h = blockIdx.y, r0 = (int)blockIdx.x * tile;
  const int tid = threadIdx.x;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  const long long row_base = ((long long)b * H + h) * Sq;

  stage(Qs, ldt, q + b * qs.b + h * qs.h, qs.s, r0, Sq, tile, D, Dp, vec);
  stage(Gs, ldt, dout + b * gs.b + h * gs.h, gs.s, r0, Sq, tile, D, Dp, vec);
  stage_rows(lses, lse + row_base, r0, Sq, tile);
  stage_rows(deltas, delta + row_base, r0, Sq, tile);
  for (int i = tid; i < tile * ldo; i += kThreads) dQs[i] = 0.f;

  const int kv_tiles = (Sk + tile - 1) / tile;
  const int hi = causal ? min(kv_tiles, (int)blockIdx.x + 1) : kv_tiles;

  for (int j = 0; j < hi; ++j) {
    const int c0 = j * tile;
    __syncthreads();
    stage(Ks, ldt, kb, ks.s, c0, Sk, tile, D, Dp, vec);
    stage(Vs, ldt, vb, vs.s, c0, Sk, tile, D, Dp, vec);
    __syncthreads();
    tile_mm<wmma::row_major, wmma::col_major>(Ss, lds, Qs, ldt, Ks, ldt, tile, tile, Dp, false);
    tile_mm<wmma::row_major, wmma::col_major>(dPs, lds, Gs, ldt, Vs, ldt, tile, tile, Dp, false);
    __syncthreads();
    for (int i = tid; i < tile * tile; i += kThreads) {
      const int r = i / tile, c = i - r * tile;
      const float s = masked_score(Ss[r * lds + c], scale, causal, r0 + r, c0 + c, Sk);
      const float p = expf(s - lses[r]);
      dSs[r * ldp + c] = from_f32<T>(p * (dPs[r * lds + c] - deltas[r]));
    }
    __syncthreads();
    tile_mm<wmma::row_major, wmma::row_major>(dQs, ldo, dSs, ldp, Ks, ldt, tile, Dp, tile, true);
  }
  __syncthreads();

  for (int i = tid; i < tile * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    if (r0 + r < Sq)
      dq[(((long long)b * Sq + r0 + r) * H + h) * D + d] = from_f32<T>(dQs[r * ldo + d] * scale);
  }
}

// ------------------------------------------------------- backward: dk and dv
// grid (kv tiles, H, B). dk, dv are contiguous [B, Sk, H, D]. With causal
// masking the q tiles above this kv tile's diagonal tile are skipped (tiles
// are square and there is no q_offset, so the diagonal tile's index is the kv
// tile's).
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int Sq, int Sk, int H, int D, int Dp, int tile, Strides qs, Strides ks,
                     Strides vs, Strides gs, float scale, int causal, int vec) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int ldt = Dp + Pad<T>::io, lds = tile + Pad<T>::acc;
  const int ldp = tile + Pad<T>::io, ldo = Dp + Pad<T>::acc;
  Carver cv{smem_raw};
  T* Ks = cv.take<T>(tile * ldt);
  T* Vs = cv.take<T>(tile * ldt);
  T* Qs = cv.take<T>(tile * ldt);
  T* Gs = cv.take<T>(tile * ldt);       // dO
  T* Ps = cv.take<T>(tile * ldp);
  T* dSs = cv.take<T>(tile * ldp);
  float* Ss = cv.take<float>(tile * lds);
  float* dPs = cv.take<float>(tile * lds);
  float* dKs = cv.take<float>(tile * ldo);
  float* dVs = cv.take<float>(tile * ldo);
  float* lses = cv.take<float>(tile);
  float* deltas = cv.take<float>(tile);

  const int b = blockIdx.z, h = blockIdx.y, c0 = (int)blockIdx.x * tile;
  const int tid = threadIdx.x;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* gb = dout + b * gs.b + h * gs.h;
  const long long row_base = ((long long)b * H + h) * Sq;

  stage(Ks, ldt, k + b * ks.b + h * ks.h, ks.s, c0, Sk, tile, D, Dp, vec);
  stage(Vs, ldt, v + b * vs.b + h * vs.h, vs.s, c0, Sk, tile, D, Dp, vec);
  for (int i = tid; i < tile * ldo; i += kThreads) {
    dKs[i] = 0.f;
    dVs[i] = 0.f;
  }

  const int q_tiles = (Sq + tile - 1) / tile;
  const int lo = causal ? (int)blockIdx.x : 0;

  for (int qi = lo; qi < q_tiles; ++qi) {
    const int r0 = qi * tile;
    __syncthreads();
    stage(Qs, ldt, qb, qs.s, r0, Sq, tile, D, Dp, vec);
    stage(Gs, ldt, gb, gs.s, r0, Sq, tile, D, Dp, vec);
    stage_rows(lses, lse + row_base, r0, Sq, tile);
    stage_rows(deltas, delta + row_base, r0, Sq, tile);
    __syncthreads();
    tile_mm<wmma::row_major, wmma::col_major>(Ss, lds, Qs, ldt, Ks, ldt, tile, tile, Dp, false);
    tile_mm<wmma::row_major, wmma::col_major>(dPs, lds, Gs, ldt, Vs, ldt, tile, tile, Dp, false);
    __syncthreads();
    for (int i = tid; i < tile * tile; i += kThreads) {
      const int r = i / tile, c = i - r * tile;
      const float s = masked_score(Ss[r * lds + c], scale, causal, r0 + r, c0 + c, Sk);
      const float p = expf(s - lses[r]);
      Ps[r * ldp + c] = from_f32<T>(p);
      dSs[r * ldp + c] = from_f32<T>(p * (dPs[r * lds + c] - deltas[r]));
    }
    __syncthreads();
    // dV[c][d] += sum_r P[r][c] dO[r][d];  dK[c][d] += sum_r dS[r][c] Q[r][d]
    tile_mm<wmma::col_major, wmma::row_major>(dVs, ldo, Ps, ldp, Gs, ldt, tile, Dp, tile, true);
    tile_mm<wmma::col_major, wmma::row_major>(dKs, ldo, dSs, ldp, Qs, ldt, tile, Dp, tile, true);
  }
  __syncthreads();

  for (int i = tid; i < tile * D; i += kThreads) {
    const int c = i / D, d = i - c * D;
    if (c0 + c < Sk) {
      const long long at = (((long long)b * Sk + c0 + c) * H + h) * D + d;
      dk[at] = from_f32<T>(dKs[c * ldo + d] * scale);
      dv[at] = from_f32<T>(dVs[c * ldo + d]);
    }
  }
}

// ------------------------------------------------------------------ host

int round16(int d) { return (d + 15) / 16 * 16; }

// Square tile of the three kernels, by io type (0 fp32, 1 bf16) and head dim.
int tile_for(int dtype, int D) {
  if (dtype == 1) return D <= 128 ? 64 : 32;
  return D <= 128 ? 32 : 16;
}

// Dynamic shared memory of a kernel that holds `n_io` operand tiles, `n_p`
// io-type score tiles, `n_s` fp32 score tiles, `n_acc` fp32 accumulators and
// two fp32 row vectors.
template <typename T>
size_t smem_bytes(int tile, int Dp, int n_io, int n_p, int n_s, int n_acc) {
  return n_io * region(sizeof(T) * tile * (Dp + Pad<T>::io)) +
         n_p * region(sizeof(T) * tile * (tile + Pad<T>::io)) +
         n_s * region(sizeof(float) * tile * (tile + Pad<T>::acc)) +
         n_acc * region(sizeof(float) * tile * (Dp + Pad<T>::acc)) +
         2 * region(sizeof(float) * tile);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B, int Sq,
               int Sk, int H, int D, Strides qs, Strides ks, Strides vs, float scale,
               int causal, int q_offset, int vec, int dtype, cudaStream_t st) {
  const int tile = tile_for(dtype, D), Dp = round16(D);
  const size_t smem = smem_bytes<T>(tile, Dp, 3, 1, 1, 1);
  cudaError_t err = allow_smem(flash_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + tile - 1) / tile, H, B);
  flash_fwd_kernel<T><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), Sq, Sk, H, D, Dp, tile, qs, ks, vs, scale,
      causal, q_offset, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* g, const void* lse,
              const void* delta, void* dq, int B, int Sq, int Sk, int H, int D, Strides qs,
              Strides ks, Strides vs, Strides gs, float scale, int causal, int vec, int dtype,
              cudaStream_t st) {
  const int tile = tile_for(dtype, D), Dp = round16(D);
  const size_t smem = smem_bytes<T>(tile, Dp, 4, 1, 2, 1);
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + tile - 1) / tile, H, B);
  flash_bwd_dq_kernel<T><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), Sq, Sk, H, D, Dp, tile, qs, ks,
      vs, gs, scale, causal, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* g, const void* lse,
               const void* delta, void* dk, void* dv, int B, int Sq, int Sk, int H, int D,
               Strides qs, Strides ks, Strides vs, Strides gs, float scale, int causal,
               int vec, int dtype, cudaStream_t st) {
  const int tile = tile_for(dtype, D), Dp = round16(D);
  const size_t smem = smem_bytes<T>(tile, Dp, 4, 2, 2, 2);
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sk + tile - 1) / tile, H, B);
  flash_bwd_dkv_kernel<T><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sk, H,
      D, Dp, tile, qs, ks, vs, gs, scale, causal, vec);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int Sq, int Sk, int H, int D, int dtype) {
  return B < 1 || Sq < 1 || Sk < 1 || H < 1 || D < 1 || D > 256 || H > 65535 || B > 65535 ||
         (dtype != 0 && dtype != 1);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dO and every output but lse).
// `strides` holds (batch, sequence, head) element strides of q, k, v and, for
// the backward kernels, dO, in that order; the head dim has a unit stride.
// `vec` says that a bf16 call may move 8 elements at a time (see stage()).
// Outputs are contiguous [B, S, H, D]; lse and delta are fp32 [B, H, Sq].
// Each function returns the launch's cudaError_t (0 on success).

extern "C" int seed_flash_tile(int dtype, int D) { return tile_for(dtype, D); }

extern "C" int seed_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                              int B, int Sq, int Sk, int H, int D, const long long* strides,
                              float scale, int causal, int q_offset, int vec, int dtype,
                              void* stream) {
  if (bad_shape(B, Sq, Sk, H, D, dtype)) return (int)cudaErrorInvalidValue;
  const Strides qs{strides[0], strides[1], strides[2]}, ks{strides[3], strides[4], strides[5]},
      vs{strides[6], strides[7], strides[8]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16>(q, k, v, o, lse, B, Sq, Sk, H, D, qs, ks, vs, scale,
                                     causal, q_offset, vec, dtype, st);
  return launch_fwd<float>(q, k, v, o, lse, B, Sq, Sk, H, D, qs, ks, vs, scale, causal,
                           q_offset, 0, dtype, st);
}

extern "C" int seed_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dq, int B, int Sq,
                                 int Sk, int H, int D, const long long* strides, float scale,
                                 int causal, int vec, int dtype, void* stream) {
  if (bad_shape(B, Sq, Sk, H, D, dtype)) return (int)cudaErrorInvalidValue;
  const Strides qs{strides[0], strides[1], strides[2]}, ks{strides[3], strides[4], strides[5]},
      vs{strides[6], strides[7], strides[8]}, gs{strides[9], strides[10], strides[11]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_dq<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, B, Sq, Sk, H, D, qs, ks, vs,
                                    gs, scale, causal, vec, dtype, st);
  return launch_dq<float>(q, k, v, dout, lse, delta, dq, B, Sq, Sk, H, D, qs, ks, vs, gs,
                          scale, causal, 0, dtype, st);
}

extern "C" int seed_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse, const void* delta,
                                  void* dk, void* dv, int B, int Sq, int Sk, int H, int D,
                                  const long long* strides, float scale, int causal, int vec,
                                  int dtype, void* stream) {
  if (bad_shape(B, Sq, Sk, H, D, dtype)) return (int)cudaErrorInvalidValue;
  const Strides qs{strides[0], strides[1], strides[2]}, ks{strides[3], strides[4], strides[5]},
      vs{strides[6], strides[7], strides[8]}, gs{strides[9], strides[10], strides[11]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_dkv<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, H, D, qs, ks,
                                     vs, gs, scale, causal, vec, dtype, st);
  return launch_dkv<float>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, H, D, qs, ks, vs, gs,
                           scale, causal, 0, dtype, st);
}
