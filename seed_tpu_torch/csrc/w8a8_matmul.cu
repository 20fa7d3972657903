// Fully quantized matmul: y[M, N] = f32(xq[M, K] @ wq[K, N]) * xs[M] * ws[N],
// int8 x int8 -> int32 on the tensor cores, written by hand for Hopper (sm_90a).
//
// Replaces: seed_tpu/ops/int8_matmul.py::_w8a8_kernel (launched by
// w8a8_matmul). Same function and rounding: the int8 products accumulate in
// int32 over the whole K (exact: |sum| <= K * 127^2 < 2^31 for K < 133,000),
// the sum is converted to fp32 (round to nearest even), multiplied by the
// row's activation scale and then by the column's weight scale, both in fp32
// and in that order, and rounded once to the output type. Two multiplications
// and no addition, so nothing can be contracted into an FMA and the result is
// bit-identical to the plain version.
//
// What bounds it on the H100: at the encoder's shapes (M = 2056, K and N in
// 1408..6144) the work is 2*M*N*K operations against about M*K + K*N int8
// bytes in and 2*M*N bytes out, over 1000 operations per byte, so a full-rate
// kernel is bound by the int8 tensor cores (1979 TOP/s dense). At decode
// shapes (M <= 64) it is bound by the int8 weight stream.
//
// Design: WMMA (mma.sync) signed-char fragments 16x16x16 with int32
// accumulators. A block of 8 warps owns a BM x BN tile of y; each K step of
// 64 stages the x and w tiles in shared memory as 16-byte-wide slabs
// (x: [k slab][row][16 k], w: [n slab][k][16 n]), so every fragment starts on
// a 32-byte boundary with a leading dimension of 16, and the loads of the next
// step are issued into registers before the products of this one. The
// epilogue goes through a per-warp 16x16 int32 staging tile: each lane scales
// and rounds 8 consecutive columns of one row and stores them as one vector.
// Two tile shapes: 128x128 (4x2 warps of 32x64) for M > 64, and 32x64 (2x4
// warps of 16x16) for decode-sized M, which puts more blocks on the weight
// stream. Ragged M is masked inside the kernel (rows past M load as zero and
// are not stored); K and N are multiples of 128 (checked by the wrapper, as
// the TPU kernel requires).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kThreads = 256;
constexpr int kBK = 64;              // int8 values of K per step
constexpr int kKSlabs = kBK / 16;    // 16-wide k slabs of the x tile
constexpr int kPad = 2;              // rows of padding per slab: 32 bytes, keeps
                                     // fragments 32-byte aligned, spreads banks

__device__ __forceinline__ void store8(float* dst, const float* v) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* dst, const float* v) {
  __align__(16) __nv_bfloat16 out[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) out[c] = __float2bfloat16_rn(v[c]);
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(out);
}

// WARPS_M x WARPS_N warps, each owning (WM*16) x (WN*16) of the block's tile.
template <int WARPS_M, int WARPS_N, int WM, int WN, typename OutT>
__global__ void __launch_bounds__(kThreads)
w8a8_mm(const int8_t* __restrict__ x, const float* __restrict__ xs,
        const int8_t* __restrict__ w, const float* __restrict__ ws,
        OutT* __restrict__ y, int M, int N, int K) {
  static_assert(WARPS_M * WARPS_N * 32 == kThreads, "8 warps per block");
  constexpr int BM = WARPS_M * WM * 16, BN = WARPS_N * WN * 16;
  constexpr int NSlabs = BN / 16;
  constexpr int A_VECS = BM * kKSlabs;     // 16-byte vectors of the x tile
  constexpr int B_VECS = kBK * NSlabs;     // ... of the w tile
  constexpr int A_PER = (A_VECS + kThreads - 1) / kThreads;
  constexpr int B_PER = (B_VECS + kThreads - 1) / kThreads;

  __shared__ __align__(32) int8_t As[kKSlabs][BM + kPad][16];
  __shared__ __align__(32) int8_t Bs[NSlabs][kBK + kPad][16];
  __shared__ __align__(32) int Cs[kThreads / 32][16 * 16];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;

  uint4 a_reg[A_PER], b_reg[B_PER];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int v = tid + i * kThreads;          // row = v / 4, k slab = v % 4
      const int row = v / kKSlabs, slab = v % kKSlabs;
      a_reg[i] = make_uint4(0, 0, 0, 0);
      if (v < A_VECS && m0 + row < M)
        a_reg[i] = *reinterpret_cast<const uint4*>(
            x + (long long)(m0 + row) * K + k0 + slab * 16);
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int v = tid + i * kThreads;          // k = v / NSlabs, n slab = v % NSlabs
      const int kr = v / NSlabs, slab = v % NSlabs;
      b_reg[i] = make_uint4(0, 0, 0, 0);
      if (v < B_VECS)
        b_reg[i] = *reinterpret_cast<const uint4*>(
            w + (long long)(k0 + kr) * N + n0 + slab * 16);
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int v = tid + i * kThreads;
      if (v < A_VECS)
        *reinterpret_cast<uint4*>(&As[v % kKSlabs][v / kKSlabs][0]) = a_reg[i];
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int v = tid + i * kThreads;
      if (v < B_VECS)
        *reinterpret_cast<uint4*>(&Bs[v % NSlabs][v / NSlabs][0]) = b_reg[i];
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[WM][WN];
#pragma unroll
  for (int i = 0; i < WM; ++i)
#pragma unroll
    for (int j = 0; j < WN; ++j) wmma::fill_fragment(acc[i][j], 0);

  load(0);
  for (int k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();                 // the previous step's fragments are read
    stage();
    __syncthreads();
    if (k0 + kBK < K) load(k0 + kBK);

#pragma unroll
    for (int ks = 0; ks < kKSlabs; ++ks) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> af[WM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> bf[WN];
#pragma unroll
      for (int i = 0; i < WM; ++i)
        wmma::load_matrix_sync(
            af[i], reinterpret_cast<const signed char*>(&As[ks][(wm * WM + i) * 16][0]), 16);
#pragma unroll
      for (int j = 0; j < WN; ++j)
        wmma::load_matrix_sync(
            bf[j], reinterpret_cast<const signed char*>(&Bs[wn * WN + j][ks * 16][0]), 16);
#pragma unroll
      for (int i = 0; i < WM; ++i)
#pragma unroll
        for (int j = 0; j < WN; ++j) wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
  }

  // epilogue: lane handles 8 consecutive columns of one row of each 16x16 tile
  const int er = lane >> 1, ec = (lane & 1) * 8;
  int* cs = Cs[warp];
#pragma unroll
  for (int i = 0; i < WM; ++i) {
#pragma unroll
    for (int j = 0; j < WN; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gm = m0 + (wm * WM + i) * 16 + er;
      const int gn = n0 + (wn * WN + j) * 16 + ec;
      if (gm < M) {
        const float row_scale = xs[gm];
        float out[8];
#pragma unroll
        for (int c = 0; c < 8; ++c)
          out[c] = __fmul_rn(__fmul_rn((float)cs[er * 16 + ec + c], row_scale),
                             ws[gn + c]);
        store8(y + (long long)gm * N + gn, out);
      }
      __syncwarp();
    }
  }
}

template <typename OutT>
void launch(const int8_t* x, const float* xs, const int8_t* w, const float* ws,
            OutT* y, int M, int N, int K, cudaStream_t st) {
  if (M > 64) {
    dim3 grid(N / 128, (M + 127) / 128);
    w8a8_mm<4, 2, 2, 4, OutT><<<grid, kThreads, 0, st>>>(x, xs, w, ws, y, M, N, K);
  } else {
    dim3 grid(N / 64, (M + 31) / 32);
    w8a8_mm<2, 4, 1, 1, OutT><<<grid, kThreads, 0, st>>>(x, xs, w, ws, y, M, N, K);
  }
}

}  // namespace

// out_dtype: 0 = float32 y, 1 = bfloat16 y. xq int8 [M, K] and wq int8 [K, N]
// row-major, xs float32 [M], ws float32 [N]. Requires K % 128 == 0,
// N % 128 == 0 and 16-byte aligned xq, wq and y. Returns the launch's
// cudaError_t (0 on success).
extern "C" int seed_w8a8_matmul(const void* xq, const void* xs, const void* wq,
                                const void* ws, void* y, int M, int N, int K,
                                int out_dtype, void* stream) {
  if (M < 1 || K < 128 || K % 128 != 0 || N % 128 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* x = static_cast<const int8_t*>(xq);
  const int8_t* w = static_cast<const int8_t*>(wq);
  const float* sx = static_cast<const float*>(xs);
  const float* sw = static_cast<const float*>(ws);
  if (out_dtype == 1) {
    launch(x, sx, w, sw, static_cast<__nv_bfloat16*>(y), M, N, K, st);
  } else if (out_dtype == 0) {
    launch(x, sx, w, sw, static_cast<float*>(y), M, N, K, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
