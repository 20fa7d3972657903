// Int8-weight matmul, dequantised on chip: y[M, N] = (x[M, K] @ w_q[K, N]) * scale[N],
// written by hand for Hopper (sm_90a).
//
// Replaces: seed_tpu/ops/int8_matmul.py::_kernel (launched by int8_matmul).
// Same function and rounding: every int8 weight is converted to x's type
// (exact for int8 values) right before the product, products accumulate in
// fp32 over the whole K, the per-column scale is applied once after the full
// reduction, and the result is rounded once to x's type. The point of the TPU
// kernel is kept: the weights cross device memory as int8 only, in their
// [K, N] row-major layout, and no bf16 or fp32 copy of them is ever written.
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
// Design (fp32 x, int8_mm_f32): the same shape on the TF32 tensor cores
// (mma.sync.m16n8k8.tf32), on 64 x 128 tiles, each warp 32 x 64. An int8
// weight in fp32 has at most 8 significant bits, so it is a tf32 value
// exactly and needs no split; x splits into hi + lo (within 2^-22 of |x|),
// and each product is x_lo w + x_hi w (sm90::mma_2xtf32_exact_b), two TF32
// products exact in fp32: at M = 256, K = N = 4096, 17.2 GFLOP of TF32 work,
// 0.035 ms at 495 TFLOP/s against 0.128 for the one product on the FMA units.
// - Chains of tensor-core accumulation are kept short. With one
//   accumulator chain over a split's whole K the error passed 1e-5 of
//   max|y| on the H100 wherever the chain was longer than 2,816 (K = 11008
//   under splits 1-3, K = 4096 unsplit at N = 40320), and held it wherever
//   it was at most that (the FMA units' round-to-nearest adds are the suspect
//   difference; it was not isolated). So each 128-wide chunk of K
//   accumulates in registers of its own, and the chunks are summed into a
//   second set with round-to-nearest adds: two 64-float accumulators a
//   thread, which is what sets the warp's tile.
// - K steps of 32 through a 6-stage cp.async ring: x as fp32 (rows of
//   32 + 8 floats), w as int8 (rows of 128 + 16 bytes, as bf16's).
// - A operand: m16n8k8 wants k-slots t and t + 4 of rows g and g + 8; the
//   k8 step's slot t is read from column 2t and t + 4 from 2t + 1, so each
//   row gives one 8-byte load (a sum over k does not depend on the order of
//   its terms). Rows of 40 floats keep a half-warp's 8-byte loads in
//   distinct banks. Split in registers, each fragment reused across the
//   warp's eight n8 tiles.
// - B operand: w rows 2t and 2t + 1 of the k8 step, in the same order. n8
//   tile j of a 32-column slab owns the slab's columns 4g + j, so one 32-bit
//   load of a w row gives four tiles their bytes; rows of 144 bytes keep the
//   loads of a warp in distinct banks. Converted in registers as for bf16
//   (the byte in the mantissa of 2^23, less the bias), stopping at the fp32,
//   and reused across the warp's two m16 tiles. A thread's C values of one
//   row are then eight consecutive columns of y: two 16-byte stores.
//
// K and N are multiples of 128 (checked by the wrapper, as the TPU kernel
// requires).
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

// y = (sum over s = 0, 1, .. of partial[s]) * scale, four columns a thread,
// stored as fp32 (f32_out) or rounded once to bf16.
__global__ void int8_mm_reduce(const float* __restrict__ partial, const float* __restrict__ scale,
                               void* __restrict__ y, int M, int N, int split, int f32_out) {
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
  const float4 v = make_float4(acc.x * sc.x, acc.y * sc.y, acc.z * sc.z, acc.w * sc.w);
  if (f32_out) {
    *reinterpret_cast<float4*>(static_cast<float*>(y) + i) = v;
    return;
  }
  uint2 out;
  out.x = sm90::pack_bf16(v.x, v.y);
  out.y = sm90::pack_bf16(v.z, v.w);
  *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(y) + i) = out;
}

constexpr int kFBM = 64, kFBK = 32, kFStages = 6;
constexpr int kFWM = kFBM / kWarpsM;   // 32 x 64 a warp
constexpr int kFMT = kFWM / 16;        // m16 tiles of a warp
constexpr int kN8 = kWN / 8;           // n8 tiles of a warp: tile 4 sl + j owns slab sl's columns 4g + j
constexpr int kFALd = kFBK + 8;        // floats per x row in shared memory (160 bytes)
constexpr int kFAStageBytes = kFBM * kFALd * 4;
constexpr int kFBStageBytes = kFBK * kBLd;
constexpr int kFStageBytes = kFAStageBytes + kFBStageBytes;
constexpr int kFSmemBytes = kFStages * kFStageBytes;
constexpr int kFStepsPerChunk = kChunk / kFBK;
static_assert(kFBM * kFBK / 4 % kThreads == 0 && kFBK * kBN / 16 % kThreads == 0,
              "copies split evenly over the threads");

// Four int8 weights, w[k][4g + j] in byte j of `r`, to fp32 bit patterns:
// each a tf32 value exactly.
__device__ __forceinline__ void s8x4_to_f32(uint32_t r, uint32_t (&f)[4]) {
  const uint32_t u = r ^ 0x80808080u;
  const float bias = 8388736.f;   // 2^23 + 128
  f[0] = __float_as_uint(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - bias);
  f[1] = __float_as_uint(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - bias);
  f[2] = __float_as_uint(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - bias);
  f[3] = __float_as_uint(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - bias);
}

// blockIdx = (n tile, m tile, split), as int8_mm_bf16, on a 64 x 128 tile.
__global__ void __launch_bounds__(kThreads, 2)
int8_mm_f32(const float* __restrict__ x, const int8_t* __restrict__ w,
            const float* __restrict__ scale, float* __restrict__ y,
            float* __restrict__ partial, int M, int N, int K, int split) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kFBM, s = blockIdx.z;
  const int chunks = K / kChunk;   // split s: chunks [s c / split, (s + 1) c / split)
  const int k_begin = (s * chunks / split) * kChunk;
  const int steps = ((s + 1) * chunks / split) * kChunk / kFBK - k_begin / kFBK;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;

  auto load = [&](int stage, int k0) {
    float* As = reinterpret_cast<float*>(smem + stage * kFStageBytes);
    unsigned char* Bs = smem + stage * kFStageBytes + kFAStageBytes;
#pragma unroll
    for (int j = 0; j < kFBM * kFBK / 4 / kThreads; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / (kFBK / 4), c = i % (kFBK / 4) * 4;
      const bool ok = m0 + r < M;
      sm90::cp_async_16(As + r * kFALd + c, ok ? x + (long long)(m0 + r) * K + k0 + c : x, ok);
    }
#pragma unroll
    for (int j = 0; j < kFBK * kBN / 16 / kThreads; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / (kBN / 16), c = i % (kBN / 16) * 16;
      sm90::cp_async_16(Bs + r * kBLd + c, w + (long long)(k0 + r) * N + n0 + c, true);
    }
  };

  // the products of one 128-wide chunk of K in part, the sum of the chunks
  // in acc, added in round-to-nearest: on the H100 one tensor-core
  // accumulation chain over a split's whole K missed the 1e-5 limit once it
  // was longer than 2,816 (at K = 11008), so a chain is kept to one chunk
  float acc[kFMT][kN8][4], part[kFMT][kN8][4];   // [m16][n8 tile][C fragment]
#pragma unroll
  for (int i = 0; i < kFMT; ++i)
#pragma unroll
    for (int n = 0; n < kN8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][n][c] = part[i][n][c] = 0.f;

#pragma unroll
  for (int st = 0; st < kFStages - 1; ++st) {
    if (st < steps) load(st, k_begin + st * kFBK);
    sm90::cp_async_commit();
  }
  for (int it = 0; it < steps; ++it) {
    sm90::cp_async_wait<kFStages - 2>();
    __syncthreads();   // stage it has landed; the stage refilled below is read
    const int next = it + kFStages - 1;
    if (next < steps) load(next % kFStages, k_begin + next * kFBK);
    sm90::cp_async_commit();
    const int stage = it % kFStages;
    const float* As = reinterpret_cast<const float*>(smem + stage * kFStageBytes);
    const unsigned char* Bs = smem + stage * kFStageBytes + kFAStageBytes;
#pragma unroll
    for (int kk = 0; kk < kFBK; kk += 8) {
      // B: k-slot t is w row kk + 2t, slot t + 4 row kk + 2t + 1
      uint32_t b[kN8][2];
#pragma unroll
      for (int sl = 0; sl < kN8 / 4; ++sl) {
        const unsigned char* p = Bs + (kk + 2 * t) * kBLd + wn * kWN + sl * 32 + 4 * g;
        uint32_t f0[4], f1[4];
        s8x4_to_f32(*reinterpret_cast<const uint32_t*>(p), f0);
        s8x4_to_f32(*reinterpret_cast<const uint32_t*>(p + kBLd), f1);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          b[4 * sl + j][0] = f0[j];
          b[4 * sl + j][1] = f1[j];
        }
      }
#pragma unroll
      for (int i = 0; i < kFMT; ++i) {
        // A: columns kk + 2t (slot t) and kk + 2t + 1 (slot t + 4) of rows g, g + 8
        const float* p = As + (wm * kFWM + i * 16 + g) * kFALd + kk + 2 * t;
        const float2 r0 = *reinterpret_cast<const float2*>(p);
        const float2 r1 = *reinterpret_cast<const float2*>(p + 8 * kFALd);
        uint32_t ah[4], al[4];
        sm90::split_tf32(r0.x, ah[0], al[0]);
        sm90::split_tf32(r1.x, ah[1], al[1]);
        sm90::split_tf32(r0.y, ah[2], al[2]);
        sm90::split_tf32(r1.y, ah[3], al[3]);
#pragma unroll
        for (int n = 0; n < kN8; ++n) sm90::mma_2xtf32_exact_b(part[i][n], ah, al, b[n]);
      }
    }
    if (it % kFStepsPerChunk == kFStepsPerChunk - 1) {   // a split ends on a chunk's end
#pragma unroll
      for (int i = 0; i < kFMT; ++i)
#pragma unroll
        for (int n = 0; n < kN8; ++n)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[i][n][c] = __fadd_rn(acc[i][n][c], part[i][n][c]);
            part[i][n][c] = 0.f;
          }
    }
  }

  // C fragment: c0 c1 at (row g, tile columns 2t, 2t + 1), c2 c3 at row g + 8.
  // Tile column c of tile 4 sl + j is slab column 4c + j, so c0 of tiles
  // 4 sl .. 4 sl + 3 are slab columns 8t .. 8t + 3 and c1 8t + 4 .. 8t + 7.
#pragma unroll
  for (int sl = 0; sl < kN8 / 4; ++sl) {
    const int col = n0 + wn * kWN + sl * 32 + 8 * t;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 sc0 = split == 1 ? *reinterpret_cast<const float4*>(scale + col) : zero;
    const float4 sc1 = split == 1 ? *reinterpret_cast<const float4*>(scale + col + 4) : zero;
#pragma unroll
    for (int i = 0; i < kFMT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * kFWM + i * 16 + g + 8 * h;
        if (row >= M) continue;
        const int c = 4 * sl;
        float4 v0 = make_float4(acc[i][c][2 * h], acc[i][c + 1][2 * h], acc[i][c + 2][2 * h],
                                acc[i][c + 3][2 * h]);
        float4 v1 = make_float4(acc[i][c][2 * h + 1], acc[i][c + 1][2 * h + 1],
                                acc[i][c + 2][2 * h + 1], acc[i][c + 3][2 * h + 1]);
        float* out = y + (long long)row * N + col;
        if (split == 1) {
          v0 = make_float4(v0.x * sc0.x, v0.y * sc0.y, v0.z * sc0.z, v0.w * sc0.w);
          v1 = make_float4(v1.x * sc1.x, v1.y * sc1.y, v1.z * sc1.z, v1.w * sc1.w);
        } else {
          out = partial + ((long long)s * M + row) * N + col;
        }
        *reinterpret_cast<float4*>(out) = v0;
        *reinterpret_cast<float4*>(out + 4) = v1;
      }
    }
  }
}

}  // namespace

// Dynamic shared memory of one block of the kernel for dtype (0 fp32 x,
// 1 bf16 x): the ring.
extern "C" int seed_int8_matmul_smem_bytes(int dtype) {
  return dtype == 1 ? kSmemBytes : kFSmemBytes;
}

// dtype: 0 = float32 x and y, 1 = bfloat16 x and y. w_q is int8 [K, N]
// row-major, scale float32 [N]. Requires K % 128 == 0, N % 128 == 0 and
// 16-byte aligned x and w_q. The plan (tile_m, tile_n, split) is the
// wrapper's int8_plan: the kernel's tile (bf16 128 x 128, fp32 64 x 128) and
// 1 <= split <= K / 128 (a workspace of split * M * N floats when split > 1).
// Returns the launch's cudaError_t (0 on success), and cudaErrorInvalidValue
// for a shape or plan the kernels do not take.
extern "C" int seed_int8_matmul(const void* x, const void* w, const void* scale, void* y,
                                void* workspace, int M, int N, int K, int tile_m, int tile_n,
                                int split, int dtype, void* stream) {
  if (M < 1 || K < 128 || K % 128 != 0 || N % 128 != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int bm = dtype == 1 ? kBM : kFBM;
  if (tile_m != bm || tile_n != kBN || split < 1 || split > K / kChunk ||
      (split > 1 && workspace == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(N / kBN, (M + bm - 1) / bm, split);
  float* partial = static_cast<float*>(workspace);
  const float* sc = static_cast<const float*>(scale);
  const int8_t* wq = static_cast<const int8_t*>(w);
  cudaError_t err;
  if (dtype == 1) {
    err = cudaFuncSetAttribute(int8_mm_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    int8_mm_bf16<<<grid, kThreads, kSmemBytes, st>>>(
        static_cast<const __nv_bfloat16*>(x), wq, sc, static_cast<__nv_bfloat16*>(y), partial,
        M, N, K, split);
  } else {
    err = cudaFuncSetAttribute(int8_mm_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kFSmemBytes);
    if (err != cudaSuccess) return (int)err;
    int8_mm_f32<<<grid, kThreads, kFSmemBytes, st>>>(static_cast<const float*>(x), wq, sc,
                                                      static_cast<float*>(y), partial, M, N, K,
                                                      split);
  }
  if (split > 1) {
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const long long quads = (long long)M * N / 4;
    int8_mm_reduce<<<(unsigned)((quads + 255) / 256), 256, 0, st>>>(partial, sc, y, M, N, split,
                                                                     dtype == 0);
  }
  return (int)cudaGetLastError();
}
