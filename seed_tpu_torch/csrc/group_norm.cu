// GroupNorm, optionally followed by SiLU, over bf16 NHWC activations, written
// by hand for Hopper (sm_90a):
//
//   y[b, p, c] = act(((x[b, p, c] - mean[b, g]) * rsqrt(var[b, g] + eps)) * scale[c] + bias[c])
//
// with g = c / (C / G), mean and var the fp32 statistics of group g of sample
// b over its N = H * W positions and C / G channels, and act the identity or
// SiLU.
//
// Replaces no TPU kernel. seed_tpu's UNet and VAE normalise with plain jnp
// ops (seed_tpu/models/unclip/unet.py group_norm), which XLA fuses on the
// TPU. The port ran the same chain as about 14 PyTorch passes a norm (cast,
// means over strided dims, centre, square, rsqrt, affine, cast back), and a
// SiLU pass after 45 of a UNet pass's 61 norms. This kernel computes the
// same function in one launch or two.
//
// Numerics: the plain chain's (ops/group_norm.py group_norm_plain).
// - fp32 statistics. The variance is the mean of squared deviations, never
//   E[x^2] - E[x]^2: each thread takes the mean and then the squared
//   deviations of its chunk of rows, held in registers (two passes), and the
//   partials are merged with their counts as weights (Chan et al.):
//   mean = sum n_i m_i / n, M2 = sum M2_i + sum n_i (m_i - mean)^2.
// - The affine in fp32 in the chain's order, each step rounded on its own
//   (__fsub_rn, __fmul_rn, __fadd_rn: nothing is contracted into an FMA),
//   rsqrtf as torch.rsqrt; SiLU on the fp32 value as x / (1 + exp(-x)),
//   with the SFU's exp and division (__expf, __fdividef: a few fp32 ulps,
//   far below the bf16 rounding; torch's exact exp and division would make
//   the normalisation compute-bound); then one rounding to bf16. Scale and
//   bias are read in fp32 or bf16 and converted to fp32 (exact).
// - Only the order of the sums differs from the plain chain. No atomics: a
//   repeat is bit-equal, and so is a CUDA graph's replay.
//
// What bounds it on the H100: memory. A norm reads each bf16 value and
// writes one, 4 bytes a value, against about 10 fp32 operations; at the
// de-tokenizer's shapes that is 811 MB a UNet pass at CFG batch 2 (4.8 ms an
// image at 3.35 TB/s over 20 passes). The statistics come before any output.
// Most of the UNet's norms are small (0.7 to 6 MB), so latency, and not
// bandwidth, bounds them: the time of a launch and of a few trips to memory.
//
// Two designs, chosen by the wrapper's group_norm_plan from the shape alone.
//
// Resident (gn_resident_kernel), where a group's slice of N x C / G values
// fits a block's shared memory (the plan gives it slices up to 96 KiB: the
// UNet's levels of 144 and 576 positions and most of 2,304's): one block a
// (sample, group) copies the slice in (cp.async, every copy in flight at
// once, 4, 8 or 16 bytes a copy as the group's channels allow), takes the
// mean and then the squared deviations over it, and normalises it from
// shared memory. One launch, one read of the input, no partials.
//
// Streaming (gn_stats_kernel, then gn_apply_kernel), for the rest:
// - Layout [B, N, C] contiguous, C % 8 == 0. A thread reads whole 16-byte
//   vectors of 8 channels: V = C / 8 threads cover a pixel row and a block of
//   T = V * R threads reads R consecutive rows at once (R = 384 / V, rounded
//   down, at least 1), all in one contiguous run. A group's C / G channels
//   (4 to 80 in the de-tokenizer) need not fill whole vectors; a thread sums
//   per channel and the block per group after, so nothing straddles.
// - The plan (the wrapper's streaming_plan, from (B, N, C) alone): a chunk
//   is R * U rows, U = 4, 2 or 1 rows a thread, the largest U whose chunks
//   still give every SM two blocks over the batch; each sample's chunks are
//   cut into Sb runs, one block each, so that B * Sb is about two blocks an
//   SM (264). Even 144 positions at B = 2 (U = 1) fill the 132 SMs; the
//   VAE's 768x768 levels give each block about 24 chunks.
// - gn_stats_kernel: a block walks its run chunk by chunk; each thread
//   merges its chunk's (mean, M2) per channel into a running one. The block
//   then merges its threads' partials per group in shared memory (8 lanes a
//   group, over its row slots and channels), and writes (mean, M2)
//   per group to a workspace [B, Sb, G] that the caller allocates.
// - gn_apply_kernel: every block copies its sample's Sb x G partials into
//   shared memory (cp.async, all in flight at once: one trip to L2) and
//   merges them per group (8 lanes a group, in one fixed order, so every
//   block holds the same statistics), then normalises its run. It takes
//   blocks and chunks in the reverse of gn_stats_kernel's order, so it first
//   reads what the first kernel read last, which is still in L2: a UNet
//   input (at most 35 MB) comes back from L2 nearly whole; the VAE's 768x768
//   inputs (151 and 302 MB) do not fit, and most of them are read from
//   device memory twice.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 384;            // T = V * R
constexpr int kMaxChannels = 8 * kMaxThreads;
constexpr int kMaxGroups = 64;
constexpr int kMaxRuns = 264;               // Sb: two blocks on each of 132 SMs
// gn_apply_kernel's dynamic shared memory at most: the partials as
// [G][Sb + 1] float2, and the rows of each run
constexpr int kMaxApplySmem = kMaxGroups * (kMaxRuns + 1) * 8 + kMaxRuns * 4;
// the resident design: a block of kResThreads holds one group's slice, at
// most kResMaxBytes, of at most kResMaxCg (an even number of) channels
constexpr int kResThreads = 512;
constexpr int kResMaxBytes = 200 * 1024;
constexpr int kResMaxCg = 256;

// the 8 bf16 channels of a 16-byte vector as fp32 (exact)
__device__ __forceinline__ void unpack(const uint4& v, float f[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// the chunks [c0, c1) of block s of a sample (Sb <= chunks: at least one;
// the entry keeps Sb * chunks below 2^31)
__device__ __forceinline__ void run_of(int s, int Sb, int chunks, int& c0, int& c1) {
  c0 = s * chunks / Sb;
  c1 = (s + 1) * chunks / Sb;
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst), "l"(gmem), "n"(BYTES));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Merges run on segments of kSeg lanes, one group a segment, four groups a
// warp: the warp's groups are g0 + lane / kSeg, and every lane of a warp
// runs the same steps (a group past G sums zeros).
constexpr int kSeg = 8;

// a sum over a segment's kSeg lanes; its lanes end with the same bits (each
// butterfly step adds the same two values in either order)
__device__ __forceinline__ float seg_sum(float v) {
#pragma unroll
  for (int o = kSeg / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int U>
__global__ void __launch_bounds__(kMaxThreads, 2)
gn_stats_kernel(const uint4* __restrict__ x, float2* __restrict__ part, int N, int V, int R,
                int G, int chunks, int Sb) {
  extern __shared__ float sm[];
  const int C = V * 8, P = R * U, T = V * R;
  float* sm_mean = sm;              // [R][C]: each thread's partial
  float* sm_m2 = sm + R * C;        // [R][C]
  float* sm_n = sm + 2 * R * C;     // [R]: rows each of the R row slots took
  const int s = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  const int v = t % V, r = t / V;
  int c0, c1;
  run_of(s, Sb, chunks, c0, c1);
  const int row_end = min(c1 * P, N);
  const uint4* xs = x + (size_t)b * N * V + v;

  float mean[8], m2[8], n = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) mean[i] = m2[i] = 0.f;
  for (int row0 = c0 * P + r; row0 < row_end; row0 += P) {
    uint4 d[U];
    int nb = 0;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int row = row0 + u * R;
      if (row < row_end) {
        d[u] = xs[(size_t)row * V];
        ++nb;
      } else {
        d[u] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    float cm[8], cq[8], f[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) cm[i] = cq[i] = 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (u < nb) {
        unpack(d[u], f);
#pragma unroll
        for (int i = 0; i < 8; ++i) cm[i] += f[i];
      }
    }
    const float inv = 1.f / (float)nb;
#pragma unroll
    for (int i = 0; i < 8; ++i) cm[i] *= inv;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (u < nb) {
        unpack(d[u], f);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float e = f[i] - cm[i];
          cq[i] = fmaf(e, e, cq[i]);
        }
      }
    }
    // Chan's merge of the chunk (nb rows) into the running partial (n rows)
    const float nn = n + (float)nb, w = (float)nb / nn, cross = n * w;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float e = cm[i] - mean[i];
      mean[i] = fmaf(e, w, mean[i]);
      m2[i] += fmaf(e * e, cross, cq[i]);
    }
    n = nn;
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    sm_mean[r * C + v * 8 + i] = mean[i];
    sm_m2[r * C + v * 8 + i] = m2[i];
  }
  if (v == 0) sm_n[r] = n;
  __syncthreads();
  // a group's partial from its R x C / G (row slot, channel) partials, each
  // weighed by its slot's rows (a slot that took no row weighs 0): the
  // segment's lanes over the entries (full warps only: T >= 193, six)
  const int Cg = C / G, E = R * Cg, lane = t & 31, k = lane % kSeg;
  const float count = (float)(row_end - c0 * P) * (float)Cg;
  for (int g0 = (t >> 5) * (32 / kSeg); g0 < G && (t | 31) < T; g0 += (T >> 5) * (32 / kSeg)) {
    const int g = g0 + lane / kSeg, E_g = g < G ? E : 0;
    float wm = 0.f;
    for (int e = k; e < E_g; e += kSeg) {
      const int q = e / Cg, c = g * Cg + e - q * Cg;
      wm = fmaf(sm_n[q], sm_mean[q * C + c], wm);
    }
    const float mu = seg_sum(wm) / count;
    float q2 = 0.f;
    for (int e = k; e < E_g; e += kSeg) {
      const int q = e / Cg, c = g * Cg + e - q * Cg;
      const float d = sm_mean[q * C + c] - mu;
      q2 += fmaf(sm_n[q] * d, d, sm_m2[q * C + c]);
    }
    q2 = seg_sum(q2);
    if (k == 0 && g < G) part[((size_t)b * Sb + s) * G + g] = make_float2(mu, q2);
  }
}

template <int U, int SILU>
__global__ void __launch_bounds__(kMaxThreads, 2)
gn_apply_kernel(const uint4* __restrict__ x, const float2* __restrict__ part,
                const void* __restrict__ scale, const void* __restrict__ bias, int params_bf16,
                uint4* __restrict__ y, float2* __restrict__ stats, int N, int V, int R, int G,
                int chunks, int Sb, float eps) {
  extern __shared__ float2 sm_part[];      // [G][Sb + 1]: the sample's partials
  float* sm_rows = reinterpret_cast<float*>(sm_part + G * (Sb + 1));   // [Sb]
  __shared__ float sm_mean[kMaxGroups], sm_rstd[kMaxGroups];
  const int C = V * 8, P = R * U, T = V * R, Cg = C / G;
  const int block = (int)(gridDim.x * gridDim.y) - 1 - (int)(blockIdx.x + blockIdx.y * gridDim.x);
  const int s = block % Sb, b = block / Sb;
  const int t = threadIdx.x, lane = t & 31, v = t % V, r = t / V;
  int c0, c1;
  run_of(s, Sb, chunks, c0, c1);
  const int row_end = min(c1 * P, N);
  const uint4* xs = x + (size_t)b * N * V + v;
  uint4* ys = y + (size_t)b * N * V + v;
  // the run's last chunk, first in this kernel's order: its loads go out
  // before the statistics are merged
  uint4 d[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int row = (c1 - 1) * P + r + u * R;
    if (row < row_end) d[u] = xs[(size_t)row * V];
  }

  // the sample's partials into shared memory, all copies in flight at once
  const float2* ps = part + (size_t)b * Sb * G;
  for (int i = t; i < Sb * G; i += T) {
    const int j = i / G, g = i - j * G;
    cp_async<8>(sm_part + g * (Sb + 1) + j, ps + i);
  }
  for (int j = t; j < Sb; j += T) {
    int j0, j1;
    run_of(j, Sb, chunks, j0, j1);
    sm_rows[j] = (float)(min(j1 * P, N) - j0 * P);
  }
  cp_async_wait_all();
  __syncthreads();
  // the sample's statistics, a segment a group (full warps only)
  const int k = lane % kSeg;
  for (int g0 = (t >> 5) * (32 / kSeg); g0 < G && (t | 31) < T; g0 += (T >> 5) * (32 / kSeg)) {
    const int g = g0 + lane / kSeg, S_g = g < G ? Sb : 0;
    const float2* pg = sm_part + g * (Sb + 1);
    float wn = 0.f, wm = 0.f;
    for (int j = k; j < S_g; j += kSeg) {
      wn += sm_rows[j];
      wm = fmaf(sm_rows[j], pg[j].x, wm);
    }
    wn = seg_sum(wn);
    wm = seg_sum(wm);
    const float mu = wm / wn;
    float q2 = 0.f;
    for (int j = k; j < S_g; j += kSeg) {
      const float e = pg[j].x - mu;
      q2 += fmaf(sm_rows[j] * (float)Cg * e, e, pg[j].y);
    }
    q2 = seg_sum(q2);
    if (k == 0 && g < G) {
      const float var = q2 / (wn * (float)Cg);
      sm_mean[g] = mu;
      sm_rstd[g] = rsqrtf(__fadd_rn(var, eps));
      if (stats != nullptr && s == 0) stats[(size_t)b * G + g] = make_float2(mu, var);
    }
  }
  __syncthreads();

  float mc[8], rc[8], sc[8], bc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = v * 8 + i, g = c / Cg;
    mc[i] = sm_mean[g];
    rc[i] = sm_rstd[g];
    if (params_bf16) {
      sc[i] = __bfloat162float(static_cast<const __nv_bfloat16*>(scale)[c]);
      bc[i] = __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[c]);
    } else {
      sc[i] = static_cast<const float*>(scale)[c];
      bc[i] = static_cast<const float*>(bias)[c];
    }
  }
  for (int k = c1 - 1; k >= c0; --k) {
    const int row0 = k * P + r;
    if (k < c1 - 1) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int row = row0 + u * R;
        if (row < row_end) d[u] = xs[(size_t)row * V];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int row = row0 + u * R;
      if (row < row_end) {
        float f[8];
        unpack(d[u], f);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float z = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(f[i], mc[i]), rc[i]), sc[i]), bc[i]);
          if (SILU) z = __fdividef(z, 1.f + __expf(-z));
          f[i] = z;
        }
        ys[(size_t)row * V] = make_uint4(pack(f[0], f[1]), pack(f[2], f[3]), pack(f[4], f[5]),
                                         pack(f[6], f[7]));
      }
    }
  }
}

// A word of VEC bytes: the widest copy that tiles a group's slice of a row.
template <int VEC> struct Word;
template <> struct Word<16> { using T = uint4; };
template <> struct Word<8> { using T = uint2; };
template <> struct Word<4> { using T = uint32_t; };

// a sum over the block's threads in one fixed order; every thread gets the
// same bits. `red` holds a value a warp.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();                       // red's last use is over
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += red[w];
  return s;
}

// One block a (sample, group) whose slice (N x C / G bf16 values) fits in
// shared memory: the slice is copied in once, its statistics are taken by
// two exact passes over it (no partials), and it is normalised from shared
// memory. One launch and one read of the input.
template <int VEC, int SILU>
__global__ void __launch_bounds__(kResThreads, 1)
gn_resident_kernel(const __nv_bfloat16* __restrict__ x, const void* __restrict__ scale,
                   const void* __restrict__ bias, int params_bf16, __nv_bfloat16* __restrict__ y,
                   float2* __restrict__ stats, int N, int C, int G, float eps) {
  using W = typename Word<VEC>::T;
  constexpr int E = VEC / 2;              // bf16 values a word
  extern __shared__ __align__(16) unsigned char sm_raw[];
  __nv_bfloat16* sm_x = reinterpret_cast<__nv_bfloat16*>(sm_raw);    // [N][Cg]
  __shared__ float red[32], sm_sc[kResMaxCg], sm_bc[kResMaxCg];
  const int g = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  const int Cg = C / G, S = Cg / E, words = N * S;
  const size_t base = (size_t)b * N * C + (size_t)g * Cg;
  for (int i = t; i < words; i += kResThreads) {
    const int row = i / S, k = i - row * S;
    cp_async<VEC>(sm_x + (size_t)row * Cg + k * E, x + base + (size_t)row * C + k * E);
  }
  for (int c = t; c < Cg; c += kResThreads) {
    if (params_bf16) {
      sm_sc[c] = __bfloat162float(static_cast<const __nv_bfloat16*>(scale)[g * Cg + c]);
      sm_bc[c] = __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[g * Cg + c]);
    } else {
      sm_sc[c] = static_cast<const float*>(scale)[g * Cg + c];
      sm_bc[c] = static_cast<const float*>(bias)[g * Cg + c];
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // two passes over the slice as bf16 pairs (Cg is even)
  const uint32_t* pairs = reinterpret_cast<const uint32_t*>(sm_x);
  const int n2 = N * Cg / 2;
  const float count = (float)N * (float)Cg;
  float sum = 0.f;
  for (int i = t; i < n2; i += kResThreads) {
    const uint32_t w = pairs[i];
    sum += __uint_as_float(w << 16) + __uint_as_float(w & 0xffff0000u);
  }
  const float mean = block_sum(sum, red) / count;
  float q = 0.f;
  for (int i = t; i < n2; i += kResThreads) {
    const uint32_t w = pairs[i];
    const float d0 = __uint_as_float(w << 16) - mean, d1 = __uint_as_float(w & 0xffff0000u) - mean;
    q = fmaf(d1, d1, fmaf(d0, d0, q));
  }
  const float var = block_sum(q, red) / count;
  const float rstd = rsqrtf(__fadd_rn(var, eps));
  if (stats != nullptr && t == 0) stats[(size_t)b * G + g] = make_float2(mean, var);

  for (int i = t; i < words; i += kResThreads) {
    const int row = i / S, k = i - row * S;
    union {
      W v;
      uint32_t w[VEC / 4];
    } p;
    p.v = *reinterpret_cast<const W*>(sm_x + (size_t)row * Cg + k * E);
#pragma unroll
    for (int j = 0; j < VEC / 4; ++j) {
      const int c = k * E + 2 * j;
      float z[2] = {__uint_as_float(p.w[j] << 16), __uint_as_float(p.w[j] & 0xffff0000u)};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        z[h] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(z[h], mean), rstd), sm_sc[c + h]),
                         sm_bc[c + h]);
        if (SILU) z[h] = __fdividef(z[h], 1.f + __expf(-z[h]));
      }
      p.w[j] = pack(z[0], z[1]);
    }
    *reinterpret_cast<W*>(y + base + (size_t)row * C + k * E) = p.v;
  }
}

// the largest word that tiles a group's C / G channels: 16, 8 or 4 bytes
inline int resident_vec(int Cg) { return Cg % 8 == 0 ? 16 : Cg % 4 == 0 ? 8 : 4; }

// Lets a kernel's two instances (without and with SiLU) take `bytes` of
// dynamic shared memory on the current device: once a device, on the first
// call, so never inside a CUDA graph's capture. `ready` holds a bit a device.
template <typename Kernel>
cudaError_t allow_smem(unsigned& ready, Kernel k0, Kernel k1, int bytes) {
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 32) return cudaErrorInvalidDevice;
  if (ready >> dev & 1u) return cudaSuccess;
  err = cudaFuncSetAttribute(k0, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) ready |= 1u << dev;
  return err;
}

template <int VEC>
cudaError_t launch_resident(const void* x, const void* scale, const void* bias, int params_bf16,
                            void* y, float2* stats, int B, int N, int C, int G, float eps,
                            int silu, cudaStream_t st) {
  static unsigned ready = 0;
  const cudaError_t err = allow_smem(ready, gn_resident_kernel<VEC, 0>,
                                     gn_resident_kernel<VEC, 1>, kResMaxBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(G, B);
  const size_t smem = (size_t)N * (C / G) * 2;
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(y);
  if (silu)
    gn_resident_kernel<VEC, 1><<<grid, kResThreads, smem, st>>>(xb, scale, bias, params_bf16, yb,
                                                                stats, N, C, G, eps);
  else
    gn_resident_kernel<VEC, 0><<<grid, kResThreads, smem, st>>>(xb, scale, bias, params_bf16, yb,
                                                                stats, N, C, G, eps);
  return cudaGetLastError();
}

template <int U>
cudaError_t launch(const uint4* x, const void* scale, const void* bias, int params_bf16, uint4* y,
                   float2* part, float2* stats, int B, int N, int V, int R, int G, int chunks,
                   int Sb, float eps, int silu, cudaStream_t st) {
  const dim3 grid(Sb, B);
  const int T = V * R;
  const size_t smem = (2 * (size_t)R * V * 8 + R) * sizeof(float);
  const size_t apply_smem = (size_t)G * (Sb + 1) * sizeof(float2) + Sb * sizeof(float);
  // the apply kernel's partials may take more than 48 KB
  static unsigned ready = 0;
  cudaError_t err =
      allow_smem(ready, gn_apply_kernel<U, 0>, gn_apply_kernel<U, 1>, kMaxApplySmem);
  if (err != cudaSuccess) return err;
  gn_stats_kernel<U><<<grid, T, smem, st>>>(x, part, N, V, R, G, chunks, Sb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (silu)
    gn_apply_kernel<U, 1><<<grid, T, apply_smem, st>>>(x, part, scale, bias, params_bf16, y,
                                                       stats, N, V, R, G, chunks, Sb, eps);
  else
    gn_apply_kernel<U, 0><<<grid, T, apply_smem, st>>>(x, part, scale, bias, params_bf16, y,
                                                       stats, N, V, R, G, chunks, Sb, eps);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one gn_stats_kernel block at C channels.
extern "C" int seed_group_norm_smem_bytes(int C) {
  const int V = C / 8, R = V < kMaxThreads ? kMaxThreads / V : 1;
  return (int)((2 * (size_t)R * C + R) * sizeof(float));
}

// x and y bf16 [B, N, C] contiguous and 16-byte aligned; scale and bias [C],
// float32 (params_bf16 = 0) or bfloat16 (1); workspace float32 [B, Sb, G, 2];
// stats null or float32 [B, G, 2], filled with each group's mean and
// variance. Requires C % 8 == 0, C <= 3072, 1 <= G <= 64, C % G == 0 and the
// plan of the wrapper's group_norm_plan: R = 384 / (C / 8) rounded down (at
// least 1), U in {1, 2, 4}, 1 <= Sb <= 264 and Sb <= the ceil(N / (R * U))
// chunks of a sample. silu: 0 = the norm alone, 1 = SiLU after it. Returns the launches'
// cudaError_t (0 on success), cudaErrorInvalidValue for a shape or plan the
// kernels do not take.
extern "C" int seed_group_norm(const void* x, const void* scale, const void* bias,
                               int params_bf16, void* y, void* workspace, void* stats, int B,
                               int N, int C, int G, int resident, int R, int U, int Sb,
                               float eps, int silu, void* stream) {
  if (B < 1 || B > 65535 || N < 1 || C < 8 || C % 8 != 0 || C > kMaxChannels || G < 1 ||
      G > kMaxGroups || C % G != 0 || (params_bf16 != 0 && params_bf16 != 1) ||
      (silu != 0 && silu != 1) || (resident != 0 && resident != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float2* st2 = static_cast<float2*>(stats);
  if (resident) {
    const int Cg = C / G;
    if (Cg % 2 != 0 || Cg > kResMaxCg || (long long)N * Cg * 2 > kResMaxBytes)
      return (int)cudaErrorInvalidValue;
    const int vec = resident_vec(Cg);
    if (vec == 16)
      return (int)launch_resident<16>(x, scale, bias, params_bf16, y, st2, B, N, C, G, eps, silu,
                                      st);
    if (vec == 8)
      return (int)launch_resident<8>(x, scale, bias, params_bf16, y, st2, B, N, C, G, eps, silu,
                                     st);
    return (int)launch_resident<4>(x, scale, bias, params_bf16, y, st2, B, N, C, G, eps, silu, st);
  }
  if (workspace == nullptr) return (int)cudaErrorInvalidValue;
  const int V = C / 8;
  if (R != (V < kMaxThreads ? kMaxThreads / V : 1)) return (int)cudaErrorInvalidValue;
  if (U != 1 && U != 2 && U != 4) return (int)cudaErrorInvalidValue;
  const long long P = (long long)R * U, chunks = (N + P - 1) / P;
  if (Sb < 1 || Sb > chunks || Sb > kMaxRuns || chunks * P > 2147483647LL ||
      (long long)(Sb + 1) * chunks > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const uint4* xv = static_cast<const uint4*>(x);
  uint4* yv = static_cast<uint4*>(y);
  float2* part = static_cast<float2*>(workspace);
  const int n = (int)chunks;
  if (U == 4)
    return (int)launch<4>(xv, scale, bias, params_bf16, yv, part, st2, B, N, V, R, G, n, Sb, eps,
                          silu, st);
  if (U == 2)
    return (int)launch<2>(xv, scale, bias, params_bf16, yv, part, st2, B, N, V, R, G, n, Sb, eps,
                          silu, st);
  return (int)launch<1>(xv, scale, bias, params_bf16, yv, part, st2, B, N, V, R, G, n, Sb, eps,
                        silu, st);
}
