// Int8-weight matmul, dequantised on chip: y[M, N] = (x[M, K] @ w_q[K, N]) * scale[N],
// written by hand for Hopper (sm_90a).
//
// Replaces: seed_tpu/ops/int8_matmul.py::_kernel (launched by int8_matmul).
// Same function and rounding: every int8 weight is converted to x's type
// (exact for int8 values) right before the product, products accumulate in
// fp32 over the whole K, the per-column scale is applied once after the full
// reduction, and the result is rounded once to x's type. The point of the TPU
// kernel is kept: the weights cross device memory as int8 only, and no bf16
// copy of them is ever written.
//
// What bounds it on the H100: at the 8B prefill shapes (M = 256, K and N in
// 4096..40320) the work is 2*M*N*K operations against ~K*N int8 bytes, about
// 500 operations per byte, so a full-rate kernel is bound by the tensor cores
// (989 TFLOP/s bf16) with the int8 weight stream close behind.
//
// Design: bf16 x takes the tensor cores through WMMA (mma.sync) bf16
// fragments with fp32 accumulators. A block owns a 128x64 tile of y; each K
// step of 32 stages x as bf16 and the int8 w tile converted to bf16 in shared
// memory, and the loads of the next step are issued into registers before the
// products of this one. Each of the 8 warps owns 32x32 of the tile (2x2
// fragments); the epilogue goes through a per-warp 16x16 fp32 staging tile to
// apply the scale and round. fp32 x has no fp32 tensor-core path (TF32 would
// round the products), so it runs a plain FMA-tiled kernel: 64x64 tiles, K
// steps of 16, 4x4 outputs per thread. Ragged M is masked in both (rows past M
// load as zero and are not stored); K and N are multiples of 128 (checked by
// the wrapper, as the TPU kernel requires).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kBM = 128, kBN = 64, kBK = 32;
constexpr int kThreads = 256;
constexpr int kAStride = kBK + 8;   // bf16 elements; keeps fragment rows 32-byte aligned
constexpr int kBStride = kBN + 8;

__global__ void __launch_bounds__(kThreads)
int8_mm_bf16(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
             const float* __restrict__ scale, __nv_bfloat16* __restrict__ y,
             int M, int N, int K) {
  __shared__ __align__(32) __nv_bfloat16 As[kBM * kAStride];
  __shared__ __align__(32) __nv_bfloat16 Bs[kBK * kBStride];
  __shared__ __align__(32) float Cs[kThreads / 32][16 * 16];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int wm = warp >> 1, wn = warp & 1;   // 4 x 2 warps of 32x32

  // x tile: thread owns row tid/2, 16 bf16 at column (tid%2)*16
  const int a_row = tid >> 1, a_col = (tid & 1) * 16;
  // w tile: thread owns row tid/8, 8 int8 at column (tid%8)*8
  const int b_row = tid >> 3, b_col = (tid & 7) * 8;
  const bool a_ok = m0 + a_row < M;
  const __nv_bfloat16* xa = x + (long long)(m0 + a_row) * K + a_col;
  const int8_t* wb = w + (long long)b_row * N + n0 + b_col;

  uint4 a_reg[2];
  uint2 b_reg;
  auto load = [&](int k0) {
    if (a_ok) {
      a_reg[0] = *reinterpret_cast<const uint4*>(xa + k0);
      a_reg[1] = *reinterpret_cast<const uint4*>(xa + k0 + 8);
    } else {
      a_reg[0] = make_uint4(0, 0, 0, 0);
      a_reg[1] = make_uint4(0, 0, 0, 0);
    }
    b_reg = *reinterpret_cast<const uint2*>(wb + (long long)k0 * N);
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  load(0);
  for (int k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();
    *reinterpret_cast<uint4*>(&As[a_row * kAStride + a_col]) = a_reg[0];
    *reinterpret_cast<uint4*>(&As[a_row * kAStride + a_col + 8]) = a_reg[1];
    const int8_t* wv = reinterpret_cast<const int8_t*>(&b_reg);
    __align__(16) __nv_bfloat16 wconv[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) wconv[c] = __float2bfloat16_rn((float)wv[c]);
    *reinterpret_cast<uint4*>(&Bs[b_row * kBStride + b_col]) =
        *reinterpret_cast<const uint4*>(wconv);
    __syncthreads();
    if (k0 + kBK < K) load(k0 + kBK);

#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(af[i], &As[(wm * 32 + i * 16) * kAStride + kk], kAStride);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bf[j], &Bs[kk * kBStride + wn * 32 + j * 16], kBStride);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
  }

  // epilogue: lane handles 8 consecutive columns of one row of each 16x16 tile
  const int er = lane >> 1, ec = (lane & 1) * 8;
  float* cs = Cs[warp];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gm = m0 + wm * 32 + i * 16 + er;
      const int gn = n0 + wn * 32 + j * 16 + ec;
      if (gm < M) {
        __align__(16) __nv_bfloat16 out[8];
#pragma unroll
        for (int c = 0; c < 8; ++c)
          out[c] = __float2bfloat16_rn(cs[er * 16 + ec + c] * scale[gn + c]);
        *reinterpret_cast<uint4*>(y + (long long)gm * N + gn) =
            *reinterpret_cast<const uint4*>(out);
      }
      __syncwarp();
    }
  }
}

constexpr int kFT = 64, kFK = 16;

__global__ void __launch_bounds__(kThreads)
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

// dtype: 0 = float32 x and y, 1 = bfloat16 x and y. w_q is int8 [K, N]
// row-major, scale float32 [N]. Requires K % 128 == 0, N % 128 == 0 and
// 16-byte aligned x and w_q. Returns the launch's cudaError_t (0 on success).
extern "C" int seed_int8_matmul(const void* x, const void* w, const void* scale,
                                void* y, int M, int N, int K, int dtype, void* stream) {
  if (M < 1 || K % 128 != 0 || N % 128 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    dim3 grid(N / kBN, (M + kBM - 1) / kBM);
    int8_mm_bf16<<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
        static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(y), M, N, K);
  } else if (dtype == 0) {
    dim3 grid(N / kFT, (M + kFT - 1) / kFT);
    int8_mm_f32<<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(w),
        static_cast<const float*>(scale), static_cast<float*>(y), M, N, K);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
