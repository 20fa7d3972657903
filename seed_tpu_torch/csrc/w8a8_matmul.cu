// Fully quantized matmul: y[M, N] = f32(xq[M, K] @ wq[K, N]) * xs[M] * ws[N],
// int8 x int8 -> int32 on the tensor cores, written by hand for Hopper (sm_90a).
//
// Replaces: seed_tpu/ops/int8_matmul.py::_w8a8_kernel (launched by
// w8a8_matmul). Same function and rounding: the int8 products accumulate in
// int32 over the whole K (exact: |sum| <= K * 127^2 < 2^31 for K < 133,000,
// in any order), the sum is converted to fp32 (round to nearest even),
// multiplied by the row's activation scale and then by the column's weight
// scale, both in fp32 and in that order, and rounded once to the output
// type. Two multiplications and no addition, so nothing can be contracted
// into an FMA and the result is bit-identical to the plain version.
//
// What bounds it on the H100: at the encoder's shapes (M = 2056, K and N in
// 1408..6144) the work is 2*M*N*K operations against about M*K + K*N int8
// bytes in and 2*M*N bytes out, over 1000 operations per byte, so a full-rate
// kernel is bound by the int8 tensor cores (1979 TOP/s dense). At decode
// shapes (M <= 64) it is bound by the int8 weight stream.
//
// Design, on the primitives of mma_sm90.cuh:
// - mma.sync.m16n8k32 s8 x s8 -> s32 with the accumulators in registers.
// - K steps of 64 stream through a 4-stage cp.async ring of 16-byte copies,
//   one __syncthreads per step: x rows of 64 + 16 bytes, w rows of BN + 16
//   bytes (odd multiples of 16, so the eight rows of an ldmatrix fall in
//   distinct bank groups).
// - A operand: plain ldmatrix x4 of the x tile, read as b16, leaves each
//   thread 4 consecutive k of one row: the s8 A fragment as it is.
// - B operand: the s8 fragment wants 4 consecutive k at one n, and the w
//   tile is [k][n]. ldmatrix.trans leaves a thread the bytes of two k rows
//   (2 of its 8 row addresses) at columns 2g and 2g + 1. Each lane hands
//   ldmatrix the row it chooses: in the "low" matrix of a 16-k half, rows
//   2t and 2t + 1 are k 4t and 4t + 1, in the "high" one k 4t + 2 and
//   4t + 3. Two byte permutes of (low, high) then give k 4t..4t + 3 of
//   column 2g and of column 2g + 1: the two n8 mma tiles of a 16-column slab
//   own its even and its odd columns, in the natural k order (the sum is
//   exact anyway). Those 8 rows are k {0, 1, 4, 5, 8, 9, 12, 13} (+2, +16):
//   rows 8..15 of every 16 sit 32 bytes further on, so they too fall in
//   distinct bank groups.
// - Epilogue from the int32 accumulators in registers: a thread's four C
//   values of a row are four consecutive columns of y, scaled and stored as
//   one 8-byte (bf16) or 16-byte (fp32) vector. No staging tile.
// - Tiles: 128x128 (4 warps of 64x64) for M > 64: the encoder's M = 2056
//   gives 17 x N/128 blocks (187 to 816 at its four shapes, over one wave of
//   two blocks per SM), and a 64x64 warp tile issues 32 mma per 8 ldmatrix,
//   so shared-memory reads stay under the tensor cores' rate. 32x64 (4 warps
//   of 32x16) for M <= 64 (decode rows), which puts N/64 blocks on the
//   weight stream. Ragged M is masked inside the kernel (rows past M load as
//   zero and are not stored); K and N are multiples of 128 (checked by the
//   wrapper, as the TPU kernel requires).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr int kBK = 64;            // int8 values of K per step
constexpr int kStages = 4;
constexpr int kALd = kBK + 16;     // bytes per x row in shared memory

// One stage of the ring: the BM x 64 x tile, then the 64 x BN w tile (rows
// of BN + 16 bytes, 32 more after rows 8..15 of every 16).
__host__ __device__ constexpr int stage_bytes(int BM, int BN) {
  return BM * kALd + kBK * (BN + 16) + kBK / 16 * 32;
}

__device__ __forceinline__ void store4(float* dst, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(dst) = make_float4(a, b, c, d);
}

__device__ __forceinline__ void store4(__nv_bfloat16* dst, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<uint2*>(dst) = make_uint2(sm90::pack_bf16(a, b), sm90::pack_bf16(c, d));
}

// WARPS_M x WARPS_N warps, each owning MT m16 tiles x NS 16-column slabs.
template <int WARPS_M, int WARPS_N, int MT, int NS, typename OutT>
__global__ void __launch_bounds__(WARPS_M * WARPS_N * 32, 2)
w8a8_mm(const int8_t* __restrict__ x, const float* __restrict__ xs,
        const int8_t* __restrict__ w, const float* __restrict__ ws,
        OutT* __restrict__ y, int M, int N, int K) {
  constexpr int kThreads = WARPS_M * WARPS_N * 32;
  constexpr int BM = WARPS_M * MT * 16, BN = WARPS_N * NS * 16;
  constexpr int BLd = BN + 16;            // bytes per w row in shared memory
  constexpr int AStage = BM * kALd, Stage = stage_bytes(BM, BN);
  static_assert(BN % 32 == 0 && Stage % 16 == 0, "odd 16-byte row units, aligned stages");
  static_assert(BM * kBK / 16 % kThreads == 0 && kBK * BN / 16 % kThreads == 0,
                "copies split evenly over the threads");
  // byte offset of w row k in a stage: rows 8..15 of every 16 sit 32 bytes
  // further on than rows 0..7 (so rows are never closer than BLd)
  auto b_row = [](int k) { return k * BLd + ((k + 8) >> 4) * 32; };

  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int steps = K / kBK;

  auto load = [&](int stage, int k0) {
    unsigned char* As = smem + stage * Stage;
    unsigned char* Bs = As + AStage;
#pragma unroll
    for (int j = 0; j < BM * kBK / 16 / kThreads; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / (kBK / 16), c = i % (kBK / 16) * 16;
      const bool ok = m0 + r < M;
      sm90::cp_async_16(As + r * kALd + c, ok ? x + (long long)(m0 + r) * K + k0 + c : x, ok);
    }
#pragma unroll
    for (int j = 0; j < kBK * BN / 16 / kThreads; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / (BN / 16), c = i % (BN / 16) * 16;
      sm90::cp_async_16(Bs + b_row(r) + c, w + (long long)(k0 + r) * N + n0 + c, true);
    }
  };

  int acc[MT][NS][2][4];   // [m16][slab][even, odd column][C fragment]
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][h][c] = 0;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < steps) load(st, st * kBK);
    sm90::cp_async_commit();
  }
  // A: lane's row and byte column in the ldmatrix x4 of a 16 x 32 x block:
  // matrices (m 0-7, k 0-15), (m 8-15, k 0-15), (m 0-7, k 16-31), (m 8-15, k 16-31)
  const int a_row = wm * MT * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 16;
  // B: lane's k row in the ldmatrix.trans x4 of a 32 x 16 w block: matrix q
  // is the low (q even) or high (q odd) matrix of k half q / 2, and its row
  // r is k 4 (r / 2) + (r % 2), plus 2 in a high matrix
  const int q = lane >> 3, r = lane & 7;
  const int b_k = (q >> 1) * 16 + (r >> 1) * 4 + (q & 1) * 2 + (r & 1);
  const int b_col = wn * NS * 16;
  for (int it = 0; it < steps; ++it) {
    sm90::cp_async_wait<kStages - 2>();
    __syncthreads();   // stage it has landed; the stage refilled below is read
    const int next = it + kStages - 1;
    if (next < steps) load(next % kStages, next * kBK);
    sm90::cp_async_commit();
    const unsigned char* As = smem + (it % kStages) * Stage;
    const unsigned char* Bs = As + AStage;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        sm90::ldmatrix_x4(a[i], As + (a_row + i * 16) * kALd + kk + a_col);
#pragma unroll
      for (int sl = 0; sl < NS; ++sl) {
        uint32_t b[4];   // low, high of k 0-15; low, high of k 16-31
        sm90::ldmatrix_x4_trans(b, Bs + b_row(kk + b_k) + b_col + sl * 16);
        const uint32_t e0 = __byte_perm(b[0], b[1], 0x6420), o0 = __byte_perm(b[0], b[1], 0x7531);
        const uint32_t e1 = __byte_perm(b[2], b[3], 0x6420), o1 = __byte_perm(b[2], b[3], 0x7531);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          sm90::mma_s8(acc[i][sl][0], a[i], e0, e1);
          sm90::mma_s8(acc[i][sl][1], a[i], o0, o1);
        }
      }
    }
  }

  // C fragment: c0 c1 at (row g, tile columns 2t, 2t + 1), c2 c3 at row g + 8.
  // Tile column j of the even tile is slab column 2j, of the odd tile 2j + 1,
  // so (even c0, odd c0, even c1, odd c1) are slab columns 4t .. 4t + 3.
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int sl = 0; sl < NS; ++sl) {
    const int col = n0 + b_col + sl * 16 + 4 * t;
    const float4 sc = *reinterpret_cast<const float4*>(ws + col);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * MT * 16 + i * 16 + g + 8 * h;
        if (row >= M) continue;
        const float rs = xs[row];
        const int* ev = acc[i][sl][0];
        const int* od = acc[i][sl][1];
        store4(y + (long long)row * N + col,
               __fmul_rn(__fmul_rn((float)ev[2 * h], rs), sc.x),
               __fmul_rn(__fmul_rn((float)od[2 * h], rs), sc.y),
               __fmul_rn(__fmul_rn((float)ev[2 * h + 1], rs), sc.z),
               __fmul_rn(__fmul_rn((float)od[2 * h + 1], rs), sc.w));
      }
    }
  }
}

template <int WARPS_M, int WARPS_N, int MT, int NS, typename OutT>
cudaError_t launch_tile(const int8_t* x, const float* xs, const int8_t* w, const float* ws,
                        OutT* y, int M, int N, int K, cudaStream_t st) {
  constexpr int BM = WARPS_M * MT * 16, BN = WARPS_N * NS * 16;
  constexpr int smem = kStages * stage_bytes(BM, BN);
  auto kernel = w8a8_mm<WARPS_M, WARPS_N, MT, NS, OutT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(N / BN, (M + BM - 1) / BM);
  kernel<<<grid, WARPS_M * WARPS_N * 32, smem, st>>>(x, xs, w, ws, y, M, N, K);
  return cudaGetLastError();
}

// The tile of a product with M rows: 128 x 128 above 64 rows, else 32 x 64.
constexpr bool large_tile(int M) { return M > 64; }

template <typename OutT>
cudaError_t launch(const int8_t* x, const float* xs, const int8_t* w, const float* ws,
                   OutT* y, int M, int N, int K, cudaStream_t st) {
  if (large_tile(M)) return launch_tile<2, 2, 4, 4>(x, xs, w, ws, y, M, N, K, st);
  return launch_tile<1, 4, 2, 1>(x, xs, w, ws, y, M, N, K, st);
}

}  // namespace

// Dynamic shared memory of one block for a product with M rows.
extern "C" int seed_w8a8_smem_bytes(int M) {
  return kStages * (large_tile(M) ? stage_bytes(128, 128) : stage_bytes(32, 64));
}

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
  if (out_dtype == 1) return (int)launch(x, sx, w, sw, static_cast<__nv_bfloat16*>(y), M, N, K, st);
  if (out_dtype == 0) return (int)launch(x, sx, w, sw, static_cast<float*>(y), M, N, K, st);
  return (int)cudaErrorInvalidValue;
}
