// Int8 weight-only matmul for Hopper (sm_90a):
//     out[M, N] = (x[M, K] @ q[N, K]^T) * scale[N]
//
// Replaces distkeras_tpu/ops/quant.py::_q_matmul_kernel (launched by
// _q_matmul_pallas): int8 weight tiles are widened to the activation type in
// registers, the products accumulate in f32, and the per-output-channel f32
// scale is applied once to the accumulator. No dequantized weight is ever
// written to device memory.
//
// Layout: q is [N, K] int8, row-major: one row per output channel, the same
// layout as nn.Linear.weight (the JAX package keeps the transpose, [K, N]).
// Each output channel's K weights are contiguous, so a thread streams 16
// weights of one channel with one 16-byte load. scale is [N] f32; x and out
// are [M, K] / [M, N] row-major in float32 or bfloat16 (out has x's type).
//
// What bounds it on an H100:
//  * decode (M <= 16 rows): the weight bytes. Each weight byte feeds only M
//    multiply-adds, far below the ~295 operations per byte where the tensor
//    cores become the limit, so the kernel must stream q at HBM rate. At
//    that rate plain FMAs would not keep up (M multiply-adds and one int8
//    conversion per byte come close to the SM's FP32 and conversion
//    throughput), so bfloat16 decode runs on the tensor cores:
//    qmm_decode_kernel issues mma.sync m16n8k16 with the M <= 16 rows as
//    the A tile (missing rows zero) and a permuted k order,
//    so each thread's B fragment is 4 contiguous weight bytes and its A
//    fragment 4 contiguous x values: every q and x read is a 16-byte load.
//    int8 → bf16 goes through the fp32 magic-number trick (byte permute +
//    one FADD, exact), not the quarter-rate I2F. A block is 8 warps on 16
//    output channels, each warp a strided eighth of K, reduced through
//    shared memory: one kernel, no workspace, N/16 blocks.
//  * prefill (M > 16): operations. qmm_prefill_kernel runs the same
//    mma.sync tiles over 64 x 128 output blocks, fed by a 3-stage cp.async
//    ring that moves the int8 weight tile (half the bytes of bf16) and the
//    x tile into shared memory two K chunks ahead of the math. Not yet
//    wgmma or TMA: those are the next step.
//  * float32 (a checked path; the served model is bfloat16) runs a plain
//    64x64 FMA tile at every M.
//
// Ragged edges in M, N and K are masked in every kernel, so any shape runs;
// wide loads are used where K and the pointers allow them.
// Plain C interface (bound with ctypes): dk_q_matmul returns the
// cudaGetLastError() of its launches, 0 on success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDecodeM = 16;  // rows that take the tensor-core decode kernel

// Decode, bfloat16: tensor cores for M <= 16 rows (see the note at the top).
constexpr int kDecWarps = 8;            // warps per block, each 1/8 of K
constexpr int kDecTiles = 2;            // n8 tiles per warp
constexpr int kDecCols = 8 * kDecTiles; // output channels per block
constexpr int kDecKC = 64;              // k per warp step: 4 lanes x 16

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Four int8 in one word → bf16 pairs {b0, b1} and {b2, b3}, exactly: the
// biased byte b + 128 becomes the low mantissa of 2^23, one FADD removes
// 2^23 + 128.
__device__ __forceinline__ void i8x4_to_bf16(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
  lo = pack_bf16x2(f0, f1);
  hi = pack_bf16x2(f2, f3);
}

// c += A B for one m16n8k16 tile: a0/a2 hold A row g at logical k {2t, 2t+1}
// / {2t+8, 2t+9}, a1/a3 the same for row g+8; b0/b1 B column g at those k.
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], uint32_t a0, uint32_t a1,
                                               uint32_t a2, uint32_t a3, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// x[row][k .. k+15] as eight bf16 pairs; rows >= M and k >= K read as 0.
__device__ __forceinline__ void load_x16(const __nv_bfloat16* __restrict__ x, int row, int k,
                                         int M, int K, int vec, uint32_t (&w)[8]) {
  if (row < M && vec && k + 16 <= K) {
    const uint4* p = reinterpret_cast<const uint4*>(x + (size_t)row * K + k);
    const uint4 v0 = __ldg(p), v1 = __ldg(p + 1);
    w[0] = v0.x; w[1] = v0.y; w[2] = v0.z; w[3] = v0.w;
    w[4] = v1.x; w[5] = v1.y; w[6] = v1.z; w[7] = v1.w;
    return;
  }
  const unsigned short* xb = reinterpret_cast<const unsigned short*>(x) + (size_t)row * K;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int k0 = k + 2 * e;
    const uint32_t lo = (row < M && k0 < K) ? xb[k0] : 0u;
    const uint32_t hi = (row < M && k0 + 1 < K) ? xb[k0 + 1] : 0u;
    w[e] = lo | (hi << 16);
  }
}

// Thread (g = lane / 4, t = lane % 4) owns x rows g and g+8 and channel rows
// n0 + g (+8 per tile) at k .. k+15, k = chunk*64 + 16t. The 16 physical k split
// into four mma k-tiles s: physical 4s+{0,1} play logical {2t, 2t+1} and
// 4s+{2,3} logical {2t+8, 2t+9}; the same map on A and B, so the sum over
// k is unchanged. kRows16 = false (M <= 8, the served batch) leaves A rows
// 8..15 as zero registers and never loads them.
template <bool kRows16>
__global__ void __launch_bounds__(kDecWarps * 32)
qmm_decode_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
                  const float* __restrict__ scale, __nv_bfloat16* __restrict__ out,
                  int M, int N, int K, int vec_x, int vec_q) {
  __shared__ float red[kDecWarps][16][kDecCols];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * kDecCols;
  float c[kDecTiles][4];
#pragma unroll
  for (int j = 0; j < kDecTiles; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;

  const int nchunks = (K + kDecKC - 1) / kDecKC;
#pragma unroll 4
  for (int ch = warp; ch < nchunks; ch += kDecWarps) {
    const int k = ch * kDecKC + 16 * t;
    uint32_t xw[8], xw8[8] = {0, 0, 0, 0, 0, 0, 0, 0};  // rows g and g + 8
    load_x16(x, g, k, M, K, vec_x, xw);
    if (kRows16) load_x16(x, g + 8, k, M, K, vec_x, xw8);
#pragma unroll
    for (int j = 0; j < kDecTiles; ++j) {
      const int n = n0 + 8 * j + g;
      uint32_t qw[4];
      if (n < N && vec_q && k + 16 <= K) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(q + (size_t)n * K + k));
        qw[0] = v.x; qw[1] = v.y; qw[2] = v.z; qw[3] = v.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          uint32_t w = 0;
#pragma unroll
          for (int bb = 0; bb < 4; ++bb) {
            const int kk = k + 4 * e + bb;
            const uint32_t byte =
                (n < N && kk < K) ? (uint32_t)(uint8_t)q[(size_t)n * K + kk] : 0u;
            w |= byte << (8 * bb);
          }
          qw[e] = w;
        }
      }
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        uint32_t b0, b1;
        i8x4_to_bf16(qw[s], b0, b1);
        mma_bf16_16816(c[j], xw[2 * s], xw8[2 * s], xw[2 * s + 1], xw8[2 * s + 1], b0, b1);
      }
    }
  }
  // c[j][0..1]: row g, channels n0 + 8j + 2t + {0, 1}; c[j][2..3]: row g+8
#pragma unroll
  for (int j = 0; j < kDecTiles; ++j) {
    red[warp][g][8 * j + 2 * t] = c[j][0];
    red[warp][g][8 * j + 2 * t + 1] = c[j][1];
    red[warp][g + 8][8 * j + 2 * t] = c[j][2];
    red[warp][g + 8][8 * j + 2 * t + 1] = c[j][3];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 16 * kDecCols; i += blockDim.x) {
    const int m = i / kDecCols, cc = i % kDecCols, n = n0 + cc;
    if (m < M && n < N) {
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < kDecWarps; ++w) acc += red[w][m][cc];
      out[(size_t)m * N + n] = __float2bfloat16(acc * scale[n]);
    }
  }
}

// float32 (any M): 64x64 output tile per block, 4x4 per thread, K step 16.
__global__ void __launch_bounds__(256)
qmm_f32_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
               const float* __restrict__ scale, float* __restrict__ out,
               int M, int N, int K) {
  __shared__ float As[16][64 + 4];  // As[k][m]
  __shared__ float Bs[16][64 + 4];  // Bs[k][n] = q[n][k], widened
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * 64, n0 = blockIdx.x * 64;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += 16) {
    for (int i = threadIdx.x; i < 64 * 16; i += 256) {
      const int r = i / 16, kk = i % 16, gk = k0 + kk;
      const int gm = m0 + r, gn = n0 + r;
      As[kk][r] = (gm < M && gk < K) ? x[(size_t)gm * K + gk] : 0.f;
      Bs[kk][r] = (gn < N && gk < K) ? (float)q[(size_t)gn * K + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (m < M && n < N) out[(size_t)m * N + n] = acc[i][j] * scale[n];
    }
  }
}

// Prefill, bfloat16 (M > 16): a 3-stage cp.async pipeline feeding
// mma.sync. A block owns a 64 x 128 output tile; 8 warps (2 x 4) own 32 x 32
// each. Each 64-wide K chunk of x (bf16) and q (int8, half the bytes) is
// copied to shared memory asynchronously two chunks ahead of the math; the
// int8 tile is widened when its B fragments are read, with the same
// permuted k order as the decode kernel, so every fragment read is one
// 16-byte shared-memory load. Where K or a pointer does not allow 16-byte
// copies, the tile loads fall back to plain element copies.
constexpr int kPM = 64, kPN = 128, kPK = 64, kPStages = 3;
constexpr int kPALd = kPK + 8;  // bf16 per A row in shared memory (padded)
constexpr int kPABytes = kPM * kPALd * 2;
constexpr int kPStageBytes = kPABytes + kPN * kPK;
constexpr int kPSmemBytes = kPStages * kPStageBytes;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Stage K chunk kc of x rows m0.. and q rows n0.. (zero beyond M, N, K).
__device__ __forceinline__ void prefill_load(unsigned char* stage,
                                             const __nv_bfloat16* __restrict__ x,
                                             const int8_t* __restrict__ q, int m0, int n0, int kc,
                                             int M, int N, int K, int vec_x, int vec_q) {
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(stage);
  int8_t* Bs = reinterpret_cast<int8_t*>(stage + kPABytes);
  const int k0 = kc * kPK;
  for (int c = threadIdx.x; c < kPM * 8; c += 256) {  // 16-byte chunks of x
    const int r = c / 8, kk = (c % 8) * 8, gm = m0 + r, gk = k0 + kk;
    __nv_bfloat16* dst = As + r * kPALd + kk;
    const bool in = gm < M && gk < K;
    if (vec_x) {
      cp_async16(dst, in ? x + (size_t)gm * K + gk : x, in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = (gm < M && gk + e < K) ? x[(size_t)gm * K + gk + e] : __float2bfloat16(0.f);
    }
  }
  for (int c = threadIdx.x; c < kPN * 4; c += 256) {  // 16-byte chunks of q
    const int r = c / 4, kk = (c % 4) * 16, gn = n0 + r, gk = k0 + kk;
    int8_t* dst = Bs + r * kPK + kk;
    const bool in = gn < N && gk < K;
    if (vec_q) {
      cp_async16(dst, in ? q + (size_t)gn * K + gk : q, in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e) dst[e] = (gn < N && gk + e < K) ? q[(size_t)gn * K + gk + e] : 0;
    }
  }
}

__global__ void __launch_bounds__(256)
qmm_prefill_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
                   const float* __restrict__ scale, __nv_bfloat16* __restrict__ out, int M,
                   int N, int K, int vec_x, int vec_q) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.y * kPM, n0 = blockIdx.x * kPN;
  const int nchunks = (K + kPK - 1) / kPK;
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

#pragma unroll
  for (int st = 0; st < kPStages - 1; ++st) {
    if (st < nchunks)
      prefill_load(smem + st * kPStageBytes, x, q, m0, n0, st, M, N, K, vec_x, vec_q);
    cp_async_commit();
  }
  for (int kc = 0; kc < nchunks; ++kc) {
    cp_async_wait<kPStages - 2>();  // chunk kc has landed
    __syncthreads();                // ... for every thread; chunk kc-1 is consumed
    const int nxt = kc + kPStages - 1;
    if (nxt < nchunks)
      prefill_load(smem + (nxt % kPStages) * kPStageBytes, x, q, m0, n0, nxt, M, N, K, vec_x,
                   vec_q);
    cp_async_commit();

    const unsigned char* stage = smem + (kc % kPStages) * kPStageBytes;
    const __nv_bfloat16* As = reinterpret_cast<const __nv_bfloat16*>(stage);
    const int8_t* Bs = reinterpret_cast<const int8_t*>(stage + kPABytes);
    uint32_t bw[4][4][2];  // [n8 tile][k tile][pair]
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const uint4 v = *reinterpret_cast<const uint4*>(Bs + (wn * 32 + nt * 8 + g) * kPK + 16 * t);
      const uint32_t qw[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int s = 0; s < 4; ++s) i8x4_to_bf16(qw[s], bw[nt][s][0], bw[nt][s][1]);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const __nv_bfloat16* a = As + (wm * 32 + mt * 16 + g) * kPALd + 16 * t;
      const uint4 r0a = *reinterpret_cast<const uint4*>(a);
      const uint4 r0b = *reinterpret_cast<const uint4*>(a + 8);
      const uint4 r8a = *reinterpret_cast<const uint4*>(a + 8 * kPALd);
      const uint4 r8b = *reinterpret_cast<const uint4*>(a + 8 * kPALd + 8);
      const uint32_t xa[8] = {r0a.x, r0a.y, r0a.z, r0a.w, r0b.x, r0b.y, r0b.z, r0b.w};
      const uint32_t xb[8] = {r8a.x, r8a.y, r8a.z, r8a.w, r8b.x, r8b.y, r8b.z, r8b.w};
#pragma unroll
      for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_bf16_16816(acc[mt][nt], xa[2 * s], xb[2 * s], xa[2 * s + 1], xb[2 * s + 1],
                         bw[nt][s][0], bw[nt][s][1]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int row = m0 + wm * 32 + mt * 16 + g, col = n0 + wn * 32 + nt * 8 + 2 * t;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = row + 8 * hf;
        if (r >= M) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (col + e < N)
            out[(size_t)r * N + col + e] = __float2bfloat16(acc[mt][nt][2 * hf + e] * scale[col + e]);
      }
    }
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.
extern "C" int dk_q_matmul(const void* x, const void* q, const void* scale, void* out, int M,
                           int N, int K, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || N < 1 || K < 1) return (int)cudaErrorInvalidValue;
  const int8_t* qt = static_cast<const int8_t*>(q);
  const float* st = static_cast<const float*>(scale);
  if (dtype == 0) {
    dim3 grid((N + 63) / 64, (M + 63) / 64);
    qmm_f32_kernel<<<grid, 256, 0, s>>>(static_cast<const float*>(x), qt, st,
                                        static_cast<float*>(out), M, N, K);
  } else if (dtype == 1) {
    const __nv_bfloat16* xt = static_cast<const __nv_bfloat16*>(x);
    __nv_bfloat16* ot = static_cast<__nv_bfloat16*>(out);
    const int vec_x = K % 8 == 0 && aligned(x, 16);
    const int vec_q = K % 16 == 0 && aligned(q, 16);
    if (M <= kDecodeM) {
      const int blocks = (N + kDecCols - 1) / kDecCols;
      if (M > 8)
        qmm_decode_kernel<true><<<blocks, kDecWarps * 32, 0, s>>>(xt, qt, st, ot, M, N, K,
                                                                 vec_x, vec_q);
      else
        qmm_decode_kernel<false><<<blocks, kDecWarps * 32, 0, s>>>(xt, qt, st, ot, M, N, K,
                                                                  vec_x, vec_q);
    } else {
      static bool configured = false;  // raise the dynamic shared-memory cap once
      if (!configured) {
        const cudaError_t e = cudaFuncSetAttribute(
            qmm_prefill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kPSmemBytes);
        if (e != cudaSuccess) return (int)e;
        configured = true;
      }
      dim3 grid((N + kPN - 1) / kPN, (M + kPM - 1) / kPM);
      qmm_prefill_kernel<<<grid, 256, kPSmemBytes, s>>>(xt, qt, st, ot, M, N, K, vec_x, vec_q);
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
