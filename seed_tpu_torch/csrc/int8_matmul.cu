// Int8-weight matmul, dequantised on chip: y[M, N] = (x[M, K] @ w_q[K, N]) * scale[N],
// written by hand for Hopper (sm_90a).
//
// Replaces: seed_tpu/ops/int8_matmul.py::_kernel (launched by int8_matmul).
// Same function and rounding: every int8 weight is converted to x's type
// (exact for int8 values) right before the product, products accumulate in
// fp32 over the whole K, the per-column scale is applied once after the full
// reduction, and the result is rounded once to x's type. The point of the TPU
// kernel is kept: the weights cross device memory as int8 only, in their
// [K, N] row-major layout, and no bf16 copy of them is ever written.
//
// What bounds it on the H100: at the 8B prefill shapes (M = 256, K and N in
// 4096..40320) the work is 2*M*N*K operations against ~K*N int8 bytes, about
// 500 operations per byte, so a full-rate kernel is bound by the tensor cores
// (989 TFLOP/s bf16) with the int8 weight stream close behind.
//
// Design (bf16 x), on the primitives of mma_sm90.cuh:
// - A block of 4 warps owns a 128x128 tile of y; each warp 64x64 (4 m16 x 8
//   n8 mma.sync.m16n8k16 tiles, fp32 accumulators in registers).
// - K steps of 64 stream through a 3-stage cp.async ring of 16-byte copies:
//   x as bf16 (rows of 64 + 8 elements) and w as int8 (rows of 128 + 16
//   bytes), so w takes half the shared bytes a bf16 copy would. The odd
//   multiple of 16 bytes per row keeps the eight rows of every ldmatrix in
//   distinct bank groups. One __syncthreads per step.
// - A operand: ldmatrix x4 of the x tile (load_a).
// - B operand: m16n8k16 wants two consecutive k at one n, which a row-major
//   [K, N] int8 tile does not give a plain load. ldmatrix.trans (b16) on the
//   int8 tile leaves each thread the bytes (k 2t, 2t+1) x (n 2g, 2g+1); the
//   even column's pair and the odd column's pair are split out and converted
//   in registers (s8x4_to_bf16: the byte in the mantissa of 2^23, less
//   2^23 + 128, exact for all 256 values; the upper half of the fp32 is the
//   bf16). So the two n8 mma tiles of a 16-column slab own its even and its
//   odd columns, and a thread's four C values of a row are four consecutive
//   columns of y.
// - Split-K, chosen by the wrapper (int8_plan): at M = 256, N = 4096 there
//   are only 64 tiles for 132 SMs, so the K range is cut into `split` runs
//   of whole 128-wide chunks (a ragged last run where the chunks do not
//   divide). Each split writes its fp32 partial tile to a workspace from the
//   caller's allocator; a second kernel sums the splits in split order, then
//   scales and rounds once. No atomics: results repeat bit for bit.
// - Epilogue from the accumulator registers: with one split, the fp32 scale,
//   one __float2bfloat16_rn and an 8-byte store of four columns per row;
//   otherwise a 16-byte store of the fp32 partials. Rows past M load as zero
//   and are not stored.
//
// fp32 x has no fp32 tensor-core path (TF32 would round the products), so it
// runs the first design's FMA-tiled kernel: 64x64 tiles, K steps of 16, 4x4
// outputs per thread. K and N are multiples of 128 (checked by the wrapper,
// as the TPU kernel requires).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 64, kStages = 3;
constexpr int kWarpsM = 2, kWarpsN = 2, kThreads = kWarpsM * kWarpsN * 32;
constexpr int kWM = kBM / kWarpsM, kWN = kBN / kWarpsN;   // 64 x 64 a warp
constexpr int kMT = kWM / 16;       // m16 tiles of a warp
constexpr int kNS = kWN / 16;       // 16-column slabs of a warp (2 n8 tiles each)
constexpr int kALd = kBK + 8;       // bf16 per x row in shared memory (144 bytes)
constexpr int kBLd = kBN + 16;      // bytes per w row in shared memory
constexpr int kAStageBytes = kBM * kALd * 2;
constexpr int kBStageBytes = kBK * kBLd;
constexpr int kStageBytes = kAStageBytes + kBStageBytes;
constexpr int kSmemBytes = kStages * kStageBytes;
constexpr int kChunk = 128;         // a split covers whole chunks of K
static_assert(kBM * kBK / 8 % kThreads == 0 && kBK * kBN / 16 % kThreads == 0,
              "copies split evenly over the threads");

// Four int8 weights, bytes (e0, o0, e1, o1) = (k 2t, n 2g), (k 2t, n 2g+1),
// (k 2t+1, n 2g), (k 2t+1, n 2g+1) as ldmatrix.trans leaves them, to the
// bf16x2 B halves of the even column (e0 low, e1 high) and the odd one.
// x ^ 0x80 = x + 128 goes into the mantissa of 2^23; the fp32 less
// 2^23 + 128 is x exactly, and an integer |x| <= 128 is a bf16, whose bits
// are the upper half of the fp32's.
__device__ __forceinline__ void s8x4_to_bf16(uint32_t r, uint32_t& even, uint32_t& odd) {
  const uint32_t u = r ^ 0x80808080u;
  const float bias = 8388736.f;   // 2^23 + 128
  const float e0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - bias;
  const float o0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - bias;
  const float e1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - bias;
  const float o1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - bias;
  even = __byte_perm(__float_as_uint(e0), __float_as_uint(e1), 0x7632);
  odd = __byte_perm(__float_as_uint(o0), __float_as_uint(o1), 0x7632);
}

// blockIdx = (n tile, m tile, split). With split == 1 y is written; else the
// fp32 partials of split s go to partial[s][M][N].
__global__ void __launch_bounds__(kThreads, 2)
int8_mm_bf16(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
             const float* __restrict__ scale, __nv_bfloat16* __restrict__ y,
             float* __restrict__ partial, int M, int N, int K, int split) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM, s = blockIdx.z;
  const int chunks = K / kChunk;   // split s: chunks [s c / split, (s + 1) c / split)
  const int k_begin = (s * chunks / split) * kChunk;
  const int steps = ((s + 1) * chunks / split) * kChunk / kBK - k_begin / kBK;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;

  auto load = [&](int stage, int k0) {
    __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem + stage * kStageBytes);
    unsigned char* Bs = smem + stage * kStageBytes + kAStageBytes;
#pragma unroll
    for (int j = 0; j < kBM * kBK / 8 / kThreads; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / (kBK / 8), c = i % (kBK / 8) * 8;
      const bool ok = m0 + r < M;
      sm90::cp_async_16(As + r * kALd + c, ok ? x + (long long)(m0 + r) * K + k0 + c : x, ok);
    }
#pragma unroll
    for (int j = 0; j < kBK * kBN / 16 / kThreads; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / (kBN / 16), c = i % (kBN / 16) * 16;
      sm90::cp_async_16(Bs + r * kBLd + c, w + (long long)(k0 + r) * N + n0 + c, true);
    }
  };

  float acc[kMT][kNS][2][4];   // [m16][slab][even, odd column][C fragment]
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNS; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][h][c] = 0.f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < steps) load(st, k_begin + st * kBK);
    sm90::cp_async_commit();
  }
  // lane's row and byte column of the ldmatrix.trans of a 16 x 32 w block:
  // matrices (k 0-7, n 0-15), (k 8-15, n 0-15), (k 0-7, n 16-31), (k 8-15, n 16-31)
  const int b_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int b_col = wn * kWN + (lane >> 4) * 16;
  for (int it = 0; it < steps; ++it) {
    sm90::cp_async_wait<kStages - 2>();
    __syncthreads();   // stage it has landed; the stage refilled below is read
    const int next = it + kStages - 1;
    if (next < steps) load(next % kStages, k_begin + next * kBK);
    sm90::cp_async_commit();
    const int stage = it % kStages;
    const __nv_bfloat16* As = reinterpret_cast<const __nv_bfloat16*>(smem + stage * kStageBytes);
    const unsigned char* Bs = smem + stage * kStageBytes + kAStageBytes;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[kMT][4];
#pragma unroll
      for (int i = 0; i < kMT; ++i) sm90::load_a(a[i], As, kALd, wm * kWM + i * 16, kk, lane);
#pragma unroll
      for (int p = 0; p < kNS / 2; ++p) {
        uint32_t r[4];
        sm90::ldmatrix_x4_trans(r, Bs + (kk + b_row) * kBLd + b_col + p * 32);
#pragma unroll
        for (int h = 0; h < 2; ++h) {   // slab 2p + h: r[2h] holds k 0-7, r[2h+1] k 8-15
          uint32_t e0, o0, e1, o1;
          s8x4_to_bf16(r[2 * h], e0, o0);
          s8x4_to_bf16(r[2 * h + 1], e1, o1);
#pragma unroll
          for (int i = 0; i < kMT; ++i) {
            sm90::mma_bf16(acc[i][2 * p + h][0], a[i], e0, e1);
            sm90::mma_bf16(acc[i][2 * p + h][1], a[i], o0, o1);
          }
        }
      }
    }
  }

  // C fragment: c0 c1 at (row g, tile columns 2t, 2t + 1), c2 c3 at row g + 8.
  // Tile column j of the even tile is slab column 2j, of the odd tile 2j + 1,
  // so (even c0, odd c0, even c1, odd c1) are slab columns 4t .. 4t + 3.
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int sl = 0; sl < kNS; ++sl) {
    const int col = n0 + wn * kWN + sl * 16 + 4 * t;
    const float4 sc = split == 1 ? *reinterpret_cast<const float4*>(scale + col)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * kWM + i * 16 + g + 8 * h;
        if (row >= M) continue;
        const float* ev = acc[i][sl][0];
        const float* od = acc[i][sl][1];
        if (split == 1) {
          uint2 out;
          out.x = sm90::pack_bf16(ev[2 * h] * sc.x, od[2 * h] * sc.y);
          out.y = sm90::pack_bf16(ev[2 * h + 1] * sc.z, od[2 * h + 1] * sc.w);
          *reinterpret_cast<uint2*>(y + (long long)row * N + col) = out;
        } else {
          *reinterpret_cast<float4*>(partial + ((long long)s * M + row) * N + col) =
              make_float4(ev[2 * h], od[2 * h], ev[2 * h + 1], od[2 * h + 1]);
        }
      }
    }
  }
}

// y = bf16((sum over s = 0, 1, .. of partial[s]) * scale), four columns a thread.
__global__ void int8_mm_reduce(const float* __restrict__ partial, const float* __restrict__ scale,
                               __nv_bfloat16* __restrict__ y, int M, int N, int split) {
  const long long total = (long long)M * N;
  const long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= total) return;
  float4 acc = *reinterpret_cast<const float4*>(partial + i);
  for (int s = 1; s < split; ++s) {
    const float4 p = *reinterpret_cast<const float4*>(partial + s * total + i);
    acc.x += p.x;
    acc.y += p.y;
    acc.z += p.z;
    acc.w += p.w;
  }
  const float4 sc = *reinterpret_cast<const float4*>(scale + i % N);
  uint2 out;
  out.x = sm90::pack_bf16(acc.x * sc.x, acc.y * sc.y);
  out.y = sm90::pack_bf16(acc.z * sc.z, acc.w * sc.w);
  *reinterpret_cast<uint2*>(y + i) = out;
}

constexpr int kFT = 64, kFK = 16, kFThreads = 256;

__global__ void __launch_bounds__(kFThreads)
int8_mm_f32(const float* __restrict__ x, const int8_t* __restrict__ w,
            const float* __restrict__ scale, float* __restrict__ y,
            int M, int N, int K) {
  __shared__ float As[kFK][kFT + 4];   // x tile, transposed: As[k][m]
  __shared__ float Bs[kFK][kFT];

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * kFT, n0 = blockIdx.x * kFT;
  const int a_row = tid >> 2, a_k = (tid & 3) * 4;     // 64 rows x 4 floats
  const int b_k = tid >> 4, b_col = (tid & 15) * 4;    // 16 rows x 4 int8

  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kFK) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    if (m0 + a_row < M)
      a = *reinterpret_cast<const float4*>(x + (long long)(m0 + a_row) * K + k0 + a_k);
    As[a_k + 0][a_row] = a.x;
    As[a_k + 1][a_row] = a.y;
    As[a_k + 2][a_row] = a.z;
    As[a_k + 3][a_row] = a.w;
    const char4 wv = *reinterpret_cast<const char4*>(w + (long long)(k0 + b_k) * N + n0 + b_col);
    Bs[b_k][b_col + 0] = (float)wv.x;
    Bs[b_k][b_col + 1] = (float)wv.y;
    Bs[b_k][b_col + 2] = (float)wv.z;
    Bs[b_k][b_col + 3] = (float)wv.w;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      y[(long long)gm * N + gn] = acc[i][j] * scale[gn];
    }
  }
}

}  // namespace

// Dynamic shared memory of one block of the bf16 kernel (the ring).
extern "C" int seed_int8_matmul_smem_bytes() { return kSmemBytes; }

// dtype: 0 = float32 x and y, 1 = bfloat16 x and y. w_q is int8 [K, N]
// row-major, scale float32 [N]. Requires K % 128 == 0, N % 128 == 0 and
// 16-byte aligned x and w_q. The plan (tile_m, tile_n, split) is the
// wrapper's int8_plan: bf16 takes the 128 x 128 tile and 1 <= split <= K / 128
// (a workspace of split * M * N floats when split > 1); fp32 takes the 64 x 64
// tile and no split. Returns the launch's cudaError_t (0 on success), and
// cudaErrorInvalidValue for a shape or plan the kernels do not take.
extern "C" int seed_int8_matmul(const void* x, const void* w, const void* scale, void* y,
                                void* workspace, int M, int N, int K, int tile_m, int tile_n,
                                int split, int dtype, void* stream) {
  if (M < 1 || K < 128 || K % 128 != 0 || N % 128 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (tile_m != kBM || tile_n != kBN || split < 1 || split > K / kChunk ||
        (split > 1 && workspace == nullptr))
      return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        int8_mm_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(N / kBN, (M + kBM - 1) / kBM, split);
    int8_mm_bf16<<<grid, kThreads, kSmemBytes, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
        static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(y),
        static_cast<float*>(workspace), M, N, K, split);
    if (split > 1) {
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      const long long quads = (long long)M * N / 4;
      int8_mm_reduce<<<(unsigned)((quads + 255) / 256), 256, 0, st>>>(
          static_cast<const float*>(workspace), static_cast<const float*>(scale),
          static_cast<__nv_bfloat16*>(y), M, N, split);
    }
  } else if (dtype == 0) {
    if (tile_m != kFT || tile_n != kFT || split != 1) return (int)cudaErrorInvalidValue;
    dim3 grid(N / kFT, (M + kFT - 1) / kFT);
    int8_mm_f32<<<grid, kFThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(w),
        static_cast<const float*>(scale), static_cast<float*>(y), M, N, K);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
