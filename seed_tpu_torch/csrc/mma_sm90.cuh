// Warp-level tensor-core primitives shared by the bf16 attention kernels
// (flash_attention.cu's forward and backward, short_mha.cu) and the two int8
// matmuls (int8_matmul.cu, w8a8_matmul.cu): mma.sync m16n8k16 bf16 with fp32
// accumulators and m16n8k32 s8 with int32 accumulators, both in registers,
// ldmatrix (plain and .trans) for the operands, cp.async copies of 16 bytes
// into shared memory, and the conversion of an fp32 accumulator fragment to
// a bf16 A operand without a trip through shared memory. At the end, the
// split-TF32 primitives of flash_attention.cu's fp32 kernels and of
// int8_matmul.cu's fp32-x kernel (mma.sync m16n8k8 tf32, fragments loaded
// and split from fp32 tiles).
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A 16x16 (4 x b32): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                      a3 (g+8, 2t+8..)
//   B 16x8  (2 x b32): b0 (k 2t..2t+1, n g), b1 (k 2t+8..2t+9, n g)
//   C 16x8  (4 x f32): c0 c1 (g, 2t..2t+1), c2 c3 (g+8, 2t..2t+1)
// and of mma.m16n8k32 s8 (four bytes a register, the lowest k first):
//   A 16x32: a0 (g, 4t..4t+3), a1 (g+8, 4t..), a2 (g, 4t+16..), a3 (g+8, 4t+16..)
//   B 32x8:  b0 (k 4t..4t+3, n g), b1 (k 4t+16..4t+19, n g)
//   C 16x8 (4 x s32): as above
// A row of a C fragment is spread over the four threads of a quad, so a
// row's max or sum is the thread's own values reduced over lanes xor 1, 2.
//
// Shared tiles are row-major with rows of Dp + 8 bf16 (Dp a multiple of 16):
// the row stride is an odd multiple of 16 bytes modulo 128, so the eight
// 16-byte rows one ldmatrix phase reads fall in distinct bank groups.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace sm90 {

constexpr int kRowPad = 8;    // bf16 elements of padding per shared row

// The padded head dims (multiples of 16) the bf16 kernels are built for; a
// head dim D runs in the smallest that holds it, its extra columns zero.
__host__ __device__ constexpr int padded_head_dim(int D) {
  return D <= 32 ? 32 : D <= 64 ? 64 : D <= 96 ? 96 : D <= 128 ? 128 : D <= 192 ? 192 : 256;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// D (+)= A * B, bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D (+)= A * B, s8 inputs, s32 accumulators (no .satfinite: exact while
// every partial sum stays inside int32).
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices; lane i gives the address of row i % 8 of matrix
// i / 8, and register j of every lane holds its part of matrix j.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// A fragment of the 16x16 block at (row0, col0) of a row-major tile.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int ld,
                                       int row0, int col0, int lane) {
  const int r = row0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int c = col0 + (lane >> 4) * 8;
  ldmatrix_x4(a, tile + r * ld + c);
}

// B fragments of two n8 tiles (n0, n0 + 8) over k16 at k0, where the tile
// holds B transposed: row n, column k (K of S = Q K^T). {b[0], b[1]} is the
// n0 tile, {b[2], b[3]} the n0 + 8 tile.
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], const __nv_bfloat16* tile, int ld,
                                          int n0, int k0, int lane) {
  const int r = n0 + (lane & 7) + (lane >> 4) * 8;
  const int c = k0 + ((lane >> 3) & 1) * 8;
  ldmatrix_x4(b, tile + r * ld + c);
}

// The same two n8 tiles when the tile holds B as it is: row k, column n
// (V of O = P V), through ldmatrix.trans.
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], const __nv_bfloat16* tile, int ld,
                                          int k0, int n0, int lane) {
  const int r = k0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int c = n0 + (lane >> 4) * 8;
  ldmatrix_x4_trans(b, tile + r * ld + c);
}

// Two fp32 values rounded to nearest-even bf16 and packed low, high.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of k16 block j of P from the C fragments of its two n8
// tiles (2j and 2j + 1), each value rounded to bf16.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                       const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// 16 bytes global -> shared, asynchronously; with `valid` false nothing is
// read and the destination is zero-filled.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}

// 4 bytes global -> shared (per-row fp32 values; .cg copies 16 bytes only,
// so this one goes through .ca), zero-filled when `valid` is false.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool valid) {
  const int bytes = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most N committed groups of this thread are still in flight.
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Rows [row0, row0 + rows_in_tile) of one (batch, head) of a [B, S, H, D]
// bf16 tensor (row stride `row_stride` elements) into a shared tile of
// `tile_rows` x Dp with row stride Dp + kRowPad. Rows from `rows` on and
// columns from D up to Dp are zero. With `vec` (D, the strides and the base
// address multiples of 8 elements) every thread issues 16-byte cp.async
// copies; otherwise it loads element by element, synchronously.
template <int Dp, int kThreads>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           long long row_stride, int row0, int rows,
                                           int tile_rows, int D, bool vec) {
  constexpr int ld = Dp + kRowPad, chunks = Dp / 8;
  if (vec) {
    for (int i = threadIdx.x; i < tile_rows * chunks; i += kThreads) {
      const int r = i / chunks, c = (i - r * chunks) * 8;
      const bool ok = row0 + r < rows && c < D;
      const __nv_bfloat16* s = ok ? src + (long long)(row0 + r) * row_stride + c : src;
      cp_async_16(dst + r * ld + c, s, ok);
    }
    return;
  }
  for (int i = threadIdx.x; i < tile_rows * Dp; i += kThreads) {
    const int r = i / Dp, d = i - r * Dp;
    dst[r * ld + d] = (row0 + r < rows && d < D) ? src[(long long)(row0 + r) * row_stride + d]
                                                 : __float2bfloat16_rn(0.f);
  }
}

// ------------------------------------------- fp32 products as split TF32
//
// An fp32 product on the tensor cores as three TF32 products ("3xTF32"):
// each operand x is split into hi = tf32(x) and lo = tf32(x - hi), both
// rounded to nearest with ties away (the rounding of cvt.rna.tf32.f32), and
// a * b is taken as
// a_lo * b_hi + a_hi * b_lo + a_hi * b_hi with fp32 accumulators. hi + lo
// holds x within 2^-22 of |x|, and the dropped a_lo * b_lo is below 2^-22
// of |a b|, so a product is within about 3 * 2^-22 of |a b| of the fp32 one.
//
// Fragment layouts of mma.m16n8k8 tf32 (g = lane / 4, t = lane % 4):
//   A 16x8 (4 x f32): a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//   B 8x8  (2 x f32): b0 (k t, n g), b1 (k t+4, n g)
//   C 16x8 (4 x f32): as for m16n8k16
// A C fragment holds columns 2t and 2t + 1 of rows g and g + 8, where an A
// fragment wants k-slots t and t + 4. A product whose A operand is a C
// fragment (P V) maps column 2t to k-slot t and 2t + 1 to k-slot t + 4, and
// reads B's rows in the same order: a sum over k does not depend on the
// order of its terms within a k8 step, so no value moves between threads.
//
// fp32 shared tiles are row-major with rows of Dp + 4 floats (Dp a multiple
// of 16): the stride is 4 or 20 modulo 32 banks, so both fragment reads
// below, (row g, column t) and (row 2t, column g), hit 32 distinct banks.

constexpr int kF32RowPad = 4;   // fp32 elements of padding per shared row

// D (+)= A * B, tf32 inputs (fp32 registers whose low 13 bits are zero),
// fp32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to tf32, nearest with ties away from zero: cvt.rna.tf32.f32's
// rounding in two integer instructions (half of the lowest kept bit added to
// the magnitude, the low 13 bits cleared), where the cvt takes several on
// sm_90a. Finite values and infinities round as the cvt rounds them.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo within 2^-22 of |x|, each part a tf32 value.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(__fsub_rn(x, __uint_as_float(hi)));
}

// D (+)= A * B in split TF32: the two small products first, then the large.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4], const uint32_t (&b_hi)[2],
                                           const uint32_t (&b_lo)[2]) {
  mma_tf32(d, a_lo, b_hi[0], b_hi[1]);
  mma_tf32(d, a_hi, b_lo[0], b_lo[1]);
  mma_tf32(d, a_hi, b_hi[0], b_hi[1]);
}

// D (+)= A * B where every B value is a tf32 value exactly (an int8 weight
// in fp32: at most 8 significant bits, where tf32 keeps 11): A split, B
// whole, two TF32 products, the small first. A tf32 x tf32 product is exact
// in fp32, so the only error is A's split residue: a product within 2^-22
// of |a b| of the fp32 one.
__device__ __forceinline__ void mma_2xtf32_exact_b(float (&d)[4], const uint32_t (&a_hi)[4],
                                                   const uint32_t (&a_lo)[4],
                                                   const uint32_t (&b)[2]) {
  mma_tf32(d, a_lo, b[0], b[1]);
  mma_tf32(d, a_hi, b[0], b[1]);
}

// d += c in round-to-nearest fp32 adds, c a C fragment of a few products
// accumulated on the tensor cores. A kernel whose sums run over a whole
// sequence keeps each tile's tensor-core chain apart and adds the tiles
// here: on the H100 one chain over every tile drifted past the fp32 limits
// (2,048-row dk/dv over 1e-4, K = 11008 over 1e-5) where the same sums
// added a tile at a time held them.
__device__ __forceinline__ void add_rn(float (&d)[4], const float (&c)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] = __fadd_rn(d[e], c[e]);
}

// Split A fragment of the 16x8 block at (row0, col0) of a row-major fp32 tile.
__device__ __forceinline__ void load_a_tf32(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                            const float* tile, int ld, int row0, int col0,
                                            int lane) {
  const float* p = tile + (row0 + (lane >> 2)) * ld + col0 + (lane & 3);
  split_tf32(p[0], hi[0], lo[0]);
  split_tf32(p[8 * ld], hi[1], lo[1]);
  split_tf32(p[4], hi[2], lo[2]);
  split_tf32(p[8 * ld + 4], hi[3], lo[3]);
}

// Split B fragment of the n8 tile at n0 over k8 at k0, where the tile holds
// B transposed: row n, column k (K of S = Q K^T).
__device__ __forceinline__ void load_b_nk_tf32(uint32_t (&hi)[2], uint32_t (&lo)[2],
                                               const float* tile, int ld, int n0, int k0,
                                               int lane) {
  const float* p = tile + (n0 + (lane >> 2)) * ld + k0 + (lane & 3);
  split_tf32(p[0], hi[0], lo[0]);
  split_tf32(p[4], hi[1], lo[1]);
}

// The same when the tile holds B as it is, row k, column n (V of O = P V),
// in the k order of c_to_a_tf32: k-slot t is row k0 + 2t, t + 4 is k0 + 2t + 1.
__device__ __forceinline__ void load_b_kn_tf32(uint32_t (&hi)[2], uint32_t (&lo)[2],
                                               const float* tile, int ld, int k0, int n0,
                                               int lane) {
  const float* p = tile + (k0 + 2 * (lane & 3)) * ld + n0 + (lane >> 2);
  split_tf32(p[0], hi[0], lo[0]);
  split_tf32(p[ld], hi[1], lo[1]);
}

// The split A fragment of one k8 step from the C fragment of one n8 tile
// (column 2t to k-slot t, 2t + 1 to t + 4).
__device__ __forceinline__ void c_to_a_tf32(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                            const float (&c)[4]) {
  split_tf32(c[0], hi[0], lo[0]);
  split_tf32(c[2], hi[1], lo[1]);
  split_tf32(c[1], hi[2], lo[2]);
  split_tf32(c[3], hi[3], lo[3]);
}

// stage_tile for fp32: rows of Dp + kF32RowPad floats; with `vec` (D, the
// strides and the base address multiples of 4 elements) 16-byte cp.async
// copies, otherwise element by element, synchronously.
template <int Dp, int kThreads>
__device__ __forceinline__ void stage_tile_f32(float* dst, const float* src,
                                               long long row_stride, int row0, int rows,
                                               int tile_rows, int D, bool vec) {
  constexpr int ld = Dp + kF32RowPad, chunks = Dp / 4;
  if (vec) {
    for (int i = threadIdx.x; i < tile_rows * chunks; i += kThreads) {
      const int r = i / chunks, c = (i - r * chunks) * 4;
      const bool ok = row0 + r < rows && c < D;
      const float* s = ok ? src + (long long)(row0 + r) * row_stride + c : src;
      cp_async_16(dst + r * ld + c, s, ok);
    }
    return;
  }
  for (int i = threadIdx.x; i < tile_rows * Dp; i += kThreads) {
    const int r = i / Dp, d = i - r * Dp;
    dst[r * ld + d] = (row0 + r < rows && d < D) ? src[(long long)(row0 + r) * row_stride + d]
                                                 : 0.f;
  }
}

}  // namespace sm90
