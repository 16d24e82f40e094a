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
// scale is [N] f32; x and out are [M, K] / [M, N] row-major in float32 or
// bfloat16 (out has x's type).
//
// What bounds it on an H100, and the kernel for each case (ops/quant.py's
// plan_q_matmul picks the path, the token tile and the K split):
//  * decode (M <= 16 rows): the weight bytes. Each weight byte feeds only M
//    multiply-adds, far below the ~295 operations per byte where the tensor
//    cores become the limit, so q must stream at the HBM rate, which needs
//    many bytes in flight. qmm_decode_split_kernel splits K over a cluster
//    of up to 8 blocks so that every decode shape runs at least two blocks
//    per SM, keeps 8 chunks of q and x in flight per block through a
//    cp.async ring, and reduces the partial sums in rank order through
//    distributed shared memory (deterministic). The products are mma.sync
//    m16n8k16 with the M <= 16 rows as the A tile and a permuted k order, so
//    each thread's B fragment is 4 contiguous weight bytes and its A
//    fragment 4 contiguous x values. int8 -> bf16 goes through the fp32
//    magic-number trick (byte permute + one FADD, exact), not the
//    quarter-rate I2F.
//  * prefill (M > 16): operations on paper; on the card, the bytes each SM
//    takes in per chunk (measured in PERF.md: the load path alone runs at
//    ~33 bytes a cycle an SM, ~65% of the time of the whole kernel).
//    qmm_prefill_wgmma_kernel runs wgmma with the weight as the register
//    operand (D^T = q x^T), so each weight is widened once and serves up to
//    256 tokens, and the int8 weight tile costs half the bytes of a bf16
//    one; x arrives by TMA as a 128-byte-swizzled K-major tile, q as an
//    int8 TMA box, through a 4-deep ring fed by one producer warp; a K
//    split over a cluster fills the card at the served prompt lengths
//    (see the kernel's note).
//  * shapes that TMA and cp.async rows cannot take (K % 16 != 0, or x or q
//    not 16-byte aligned) run the first design: qmm_decode_kernel (8 warps
//    on 16 channels, each a strided eighth of K, wide global loads) and
//    qmm_prefill_kernel (mma.sync over 64 x 128 tiles fed by a 3-stage
//    cp.async ring), which mask every ragged edge element by element;
//  * float32 (a checked path; the served model is bfloat16) runs a plain
//    64x64 FMA tile at every M.
//
// ptxas and SASS of the wgmma kernels: chip_smoke.py's check_sass. Plain C
// interface (bound with ctypes): dk_q_matmul returns the cudaGetLastError()
// (or the launch's error) of its launch, 0 on success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

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

// -- decode, bfloat16, split K across a cluster (M <= 16, K % 16 == 0) --------
//
// A block owns 32 output channels and a contiguous range of 128-wide K
// chunks; the `splits` blocks of a channel tile form one cluster along grid y
// and split its chunks evenly. Each block keeps kDsStages chunks of q (int8)
// and x (bf16) in flight through a cp.async ring, so it never waits on a load
// it issued just before: the weight streams at the HBM rate. 8 warps: warp w
// takes n8 tile w % 4 of the channels and k half w / 4 of every chunk, with
// the mma.sync tiles (and the permuted k order) of qmm_decode_kernel in two
// accumulator chains. The q rows sit in shared memory with the 64-byte halves
// of odd rows swapped, so a quarter warp's 16-byte loads of two rows hit 32
// different banks. Each block leaves its f32 partial sums in its shared
// memory; after a cluster barrier, block r sums a 1/splits share of the
// outputs over the cluster's blocks in rank order through distributed shared
// memory (a fixed order: two launches give the same bits), scales and stores
// them. No workspace, no second launch.
constexpr int kDsCh = 32;                         // output channels per block
constexpr int kDsKC = 128;                        // k per stage
constexpr int kDsStages = 5;                      // depth of the cp.async ring
constexpr int kDsXLd = kDsKC + 8;                 // bf16 per staged x row (conflict-free reads)
constexpr int kDsQBytes = kDsCh * kDsKC;
constexpr int kDsStageBytes = kDsQBytes + 16 * kDsXLd * 2;
constexpr int kMaxCluster = 8;                    // portable cluster size

template <bool kRows16>
__global__ void __launch_bounds__(256)
qmm_decode_split_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
                        const float* __restrict__ scale, __nv_bfloat16* __restrict__ out, int M,
                        int N, int K) {
  __shared__ __align__(16) unsigned char smem[kDsStages * kDsStageBytes];
  __shared__ float part[2][16][kDsCh];  // [k half][row][channel]
  constexpr int kRowsUsed = kRows16 ? 16 : 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int nt = warp % 4, kh = warp / 4;
  const int splits = gridDim.y, rank = (int)hopper::cluster_rank();
  const int n0 = blockIdx.x * kDsCh;
  const int nch = (K + kDsKC - 1) / kDsKC;
  const int c0 = (int)((long long)rank * nch / splits);
  const int nloc = (int)((long long)(rank + 1) * nch / splits) - c0;

  auto load = [&](int i) {  // chunk c0 + i into its stage; zeros past N, M and K
    unsigned char* st = smem + (i % kDsStages) * kDsStageBytes;
    const int k0 = (c0 + i) * kDsKC;
    {
      const int r = threadIdx.x / 8, p = threadIdx.x % 8, gn = n0 + r, gk = k0 + 16 * p;
      const bool in = gn < N && gk < K;
      cp_async16(st + r * kDsKC + 16 * (p ^ ((r & 1) << 2)), in ? q + (size_t)gn * K + gk : q,
                 in ? 16 : 0);
    }
    for (int idx = threadIdx.x; idx < kRowsUsed * 16; idx += 256) {
      const int r = idx / 16, p = idx % 16, gk = k0 + 8 * p;
      const bool in = r < M && gk < K;
      cp_async16(st + kDsQBytes + r * kDsXLd * 2 + 16 * p, in ? x + (size_t)r * K + gk : x,
                 in ? 16 : 0);
    }
  };

  float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  const int qrow = 8 * nt + g;
  const int qoff = qrow * kDsKC + 16 * ((4 * kh + t) ^ ((qrow & 1) << 2));
#pragma unroll
  for (int st = 0; st < kDsStages - 1; ++st) {
    if (st < nloc) load(st);
    cp_async_commit();
  }
  for (int i = 0; i < nloc; ++i) {
    cp_async_wait<kDsStages - 2>();  // chunk i has landed
    __syncthreads();                 // ... for every thread; chunk i-1's stage is free
    if (i + kDsStages - 1 < nloc) load(i + kDsStages - 1);
    cp_async_commit();
    const unsigned char* st = smem + (i % kDsStages) * kDsStageBytes;
    const __nv_bfloat16* xs =
        reinterpret_cast<const __nv_bfloat16*>(st + kDsQBytes) + 64 * kh + 16 * t;
    const uint4 v = *reinterpret_cast<const uint4*>(st + qoff);
    const uint32_t qw[4] = {v.x, v.y, v.z, v.w};
    uint32_t xw[8], xw8[8] = {0, 0, 0, 0, 0, 0, 0, 0};  // rows g and g + 8
    {
      const uint4 a = *reinterpret_cast<const uint4*>(xs + g * kDsXLd);
      const uint4 b = *reinterpret_cast<const uint4*>(xs + g * kDsXLd + 8);
      xw[0] = a.x; xw[1] = a.y; xw[2] = a.z; xw[3] = a.w;
      xw[4] = b.x; xw[5] = b.y; xw[6] = b.z; xw[7] = b.w;
    }
    if (kRows16) {
      const uint4 a = *reinterpret_cast<const uint4*>(xs + (g + 8) * kDsXLd);
      const uint4 b = *reinterpret_cast<const uint4*>(xs + (g + 8) * kDsXLd + 8);
      xw8[0] = a.x; xw8[1] = a.y; xw8[2] = a.z; xw8[3] = a.w;
      xw8[4] = b.x; xw8[5] = b.y; xw8[6] = b.z; xw8[7] = b.w;
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      uint32_t b0, b1;
      i8x4_to_bf16(qw[s], b0, b1);
      mma_bf16_16816(c[s / 2], xw[2 * s], xw8[2 * s], xw[2 * s + 1], xw8[2 * s + 1], b0, b1);
    }
  }
  cp_async_wait<0>();
  // c[.][0..1]: row g, channels 8 nt + 2t + {0, 1}; c[.][2..3]: row g + 8
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    part[kh][g][8 * nt + 2 * t + e] = c[0][e] + c[1][e];
    part[kh][g + 8][8 * nt + 2 * t + e] = c[0][2 + e] + c[1][2 + e];
  }
  hopper::cluster_sync();  // every block's partial sums are in place
  const int total = M * kDsCh;
  const int lo = (int)((long long)rank * total / splits);
  const int hi = (int)((long long)(rank + 1) * total / splits);
  for (int e = lo + (int)threadIdx.x; e < hi; e += 256) {
    const int m = e / kDsCh, cc = e % kDsCh, n = n0 + cc;
    float acc = 0.f;
    for (int r = 0; r < splits; ++r)
      acc += hopper::ld_cluster_f32(hopper::cluster_map(&part[0][m][cc], r)) +
             hopper::ld_cluster_f32(hopper::cluster_map(&part[1][m][cc], r));
    if (n < N) out[(size_t)m * N + n] = __float2bfloat16(acc * scale[n]);
  }
  hopper::cluster_sync();  // no block leaves while another still reads its partial sums
}

// -- prefill, bfloat16, on wgmma (M > 16, K % 16 == 0) -------------------------
//
// The roles of the operands swap: D^T[n, m] = sum_k q[n, k] x[m, k], so the
// int8 weight is wgmma's A operand, from registers, widened once per chunk by
// the exact byte-permute + FADD of i8x4_to_bf16, and then serves every token
// of the block's tile (TN of 64, 128, 192 or 256, wgmma's N). x is the B
// operand, bf16, K-major, read by wgmma straight from a 128-byte-swizzled TMA
// tile. A block owns 64 WG channels (WG consumer warpgroups of 64) by TN
// tokens: one producer warp keeps a kQStages-deep TMA ring full (the q tile
// as an int8 box, the x tile as a swizzled bf16 box); each consumer thread
// reads its two channel rows of q with 16-byte shared-memory loads, picks its
// bytes by one byte permute, widens them, and issues four m64nTNk16 wgmma per
// 64-wide K chunk, with the next chunk's widening overlapping the running
// products (two register buffers of A fragments). f32 accumulators; the
// epilogue writes them transposed ([m][n]) into shared memory, where the
// scale (one per channel) and the bf16 [M, N] row-major store happen in
// 16-byte stores along n. Split K: the `splits` blocks of a tile form a cluster
// along grid z, each sums an even share of the chunks, and block r reduces a
// 1/splits share of the tile's tokens over the cluster in rank order through
// distributed shared memory (fixed order, deterministic), so a served prefill
// of 80-336 tokens still fills the card. Tried and not kept (PERF.md): TMA
// multicast of x to a pair of blocks (no gain: the bytes an SM takes in,
// not the L2, bound the load path) and splits over more than one wave.
constexpr int kQStages = 4;

template <int TN, int WG>
struct QmmSmem {
  static constexpr uint32_t x_bytes = TN * 128;          // TN tokens x 64 k, bf16, swizzled
  static constexpr uint32_t q_bytes = 64 * WG * 64;      // 64 WG channels x 64 k, int8
  static constexpr uint32_t q_off = kQStages * x_bytes;
  static constexpr uint32_t ring = q_off + kQStages * q_bytes;
  static constexpr int ldp = 64 * WG + 4;                // f32 per token of the partial tile
  static constexpr uint32_t part_bytes = TN * ldp * 4;   // reuses the ring after the loop
  static constexpr uint32_t bar_off = ring > part_bytes ? ring : part_bytes;
  static constexpr uint32_t bytes = bar_off + 16 * kQStages + 1024;  // + alignment
};

template <int TN, int WG>
__global__ void __launch_bounds__(128 * WG + 32, 1)
qmm_prefill_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tx, const float* __restrict__ scale,
                         __nv_bfloat16* __restrict__ out, int M, int N, int K) {
  using S = QmmSmem<TN, WG>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + S::bar_off);
  uint64_t* empty = full + kQStages;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n0 = blockIdx.x * 64 * WG, m0 = blockIdx.y * TN;
  const int splits = gridDim.z, rank = (int)hopper::cluster_rank();
  const int nch = (K + 63) / 64;
  const int c0 = rank * nch / splits, nloc = (rank + 1) * nch / splits - c0;

  if (tid == 0) {
    for (int s = 0; s < kQStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4 * WG);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4 * WG) {  // producer warp
    if (lane == 0) {
      for (int i = 0; i < nloc; ++i) {
        const int s = i % kQStages, k0 = 64 * (c0 + i);
        if (i >= kQStages) hopper::mbar_wait(&empty[s], (i / kQStages - 1) & 1);
        hopper::mbar_arrive_expect_tx(&full[s], S::x_bytes + S::q_bytes);
        hopper::tma_load_2d(base + s * S::x_bytes, &tx, &full[s], k0, m0);
        hopper::tma_load_2d(base + S::q_off + s * S::q_bytes, &tq, &full[s], k0, n0);
      }
    }
    __syncwarp();
    hopper::cluster_sync();  // partial tiles written
    hopper::cluster_sync();  // partial tiles read
    return;
  }

  // consumer warpgroups: 64 channels each, 16 a warp
  const int wg = warp / 4, g = lane / 4, t = lane % 4;
  const int r0 = 64 * wg + 16 * (warp % 4) + g;  // the thread's channel rows r0, r0 + 8
  const bool upper = (t >> 1) != 0;
  const uint32_t sel = (t & 1) ? 0x7632u : 0x5410u;
  float acc[TN / 2];
#pragma unroll
  for (int e = 0; e < TN / 2; ++e) acc[e] = 0.f;
  uint32_t fa[4][4], fb[4][4];

  // A fragments of one chunk: for k step ks, rows r0 / r0 + 8 at k 16 ks + 2t,
  // +1 (regs 0 / 1) and + 8 (regs 2 / 3), taken from one 16-byte load per row
  auto widen = [&](const uint8_t* qs, uint32_t(&a)[4][4]) {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint4 v0 = *reinterpret_cast<const uint4*>(qs + r0 * 64 + 16 * ks);
      const uint4 v1 = *reinterpret_cast<const uint4*>(qs + (r0 + 8) * 64 + 16 * ks);
      i8x4_to_bf16(__byte_perm(upper ? v0.y : v0.x, upper ? v0.w : v0.z, sel), a[ks][0],
                   a[ks][2]);
      i8x4_to_bf16(__byte_perm(upper ? v1.y : v1.x, upper ? v1.w : v1.z, sel), a[ks][1],
                   a[ks][3]);
    }
  };
  auto step = [&](int i, uint32_t(&a)[4][4]) {
    const int s = i % kQStages;
    hopper::mbar_wait(&full[s], (i / kQStages) & 1);
    widen(base + S::q_off + s * S::q_bytes, a);
    hopper::fence_regs(a);
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      hopper::wgmma_rs_kb(acc, a[ks], hopper::sw128_desc(base + s * S::x_bytes + 32 * ks));
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();  // chunk i - 1 is done: its stage and A buffer are free
    hopper::fence_regs(acc);
    if (i > 0) {
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[(i - 1) % kQStages]);
    }
  };
  for (int i = 0; i < nloc; i += 2) {
    step(i, fa);
    if (i + 1 < nloc) step(i + 1, fb);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * WG) : "memory");  // the ring is no longer read

  // the partial tile, transposed: P[m][n] (f32, ldp per token), conflict-free
  float* P = reinterpret_cast<float*>(base);
#pragma unroll
  for (int j = 0; j < TN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = 8 * j + 2 * t + e;
      P[m * S::ldp + r0] = acc[4 * j + e];
      P[m * S::ldp + r0 + 8] = acc[4 * j + 2 + e];
    }
  hopper::cluster_sync();
  // block `rank` finishes a 1/splits share of the tile's tokens: each thread
  // owns 8 channels (their scales read once) and walks the tokens 16 at a
  // time; the splits' partial sums are read at once, then added in rank order
  constexpr int kGroups = 8 * WG;  // 8-channel groups per token
  const int mlo = rank * TN / splits, mhi = (rank + 1) * TN / splits;
  const int nl = 8 * (tid % kGroups), gn = n0 + nl;
  float sc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) sc[e] = gn + e < N ? scale[gn + e] : 0.f;
  const bool vec_out = gn + 7 < N && N % 8 == 0;
#pragma unroll 2
  for (int m = mlo + tid / kGroups; m < mhi; m += 128 * WG / kGroups) {
    const int gm = m0 + m;
    if (gm >= M || gn >= N) continue;
    const float* row = P + m * S::ldp + nl;
    float4 v[2];
    if (splits == 1) {
      v[0] = *reinterpret_cast<const float4*>(row);
      v[1] = *reinterpret_cast<const float4*>(row + 4);
    } else {
      float4 p[kMaxCluster][2];
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r)
        if (r < splits) {
          const uint32_t at = hopper::cluster_map(row, r);
          p[r][0] = hopper::ld_cluster_f32x4(at);
          p[r][1] = hopper::ld_cluster_f32x4(at + 16);
        }
      v[0] = v[1] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r)
        if (r < splits)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            v[h].x += p[r][h].x;
            v[h].y += p[r][h].y;
            v[h].z += p[r][h].z;
            v[h].w += p[r][h].w;
          }
    }
    const uint4 w = make_uint4(hopper::pack_bf16x2(v[0].x * sc[0], v[0].y * sc[1]),
                               hopper::pack_bf16x2(v[0].z * sc[2], v[0].w * sc[3]),
                               hopper::pack_bf16x2(v[1].x * sc[4], v[1].y * sc[5]),
                               hopper::pack_bf16x2(v[1].z * sc[6], v[1].w * sc[7]));
    __nv_bfloat16* o = out + (size_t)gm * N + gn;
    if (vec_out) {
      *reinterpret_cast<uint4*>(o) = w;
    } else {
      const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (gn + e < N)
          o[e] = __ushort_as_bfloat16((unsigned short)(words[e / 2] >> (16 * (e % 2))));
    }
  }
  hopper::cluster_sync();
}

template <typename Kernel, typename... Args>
int launch_cluster(Kernel kernel, dim3 grid, int threads, uint32_t smem, dim3 cluster,
                   cudaStream_t s, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster.x;
  attr[0].val.clusterDim.y = cluster.y;
  attr[0].val.clusterDim.z = cluster.z;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <int TN, int WG>
int prefill_wgmma(const void* x, const void* q, const float* scale, __nv_bfloat16* out, int M,
                  int N, int K, int splits, cudaStream_t s) {
  using S = QmmSmem<TN, WG>;
  static const int attr = (int)cudaFuncSetAttribute(
      qmm_prefill_wgmma_kernel<TN, WG>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::bytes);
  if (attr) return attr;
  CUtensorMap tq, tx;
  if (!hopper::rows_map_2d(&tq, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, K, N, K, 64, 64 * WG,
                           CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !hopper::rows_map_2d(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M, 2 * (uint64_t)K, 64,
                           TN, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((N + 64 * WG - 1) / (64 * WG)), (unsigned)((M + TN - 1) / TN),
                  (unsigned)splits);
  return launch_cluster(qmm_prefill_wgmma_kernel<TN, WG>, grid, 128 * WG + 32, S::bytes,
                        dim3(1, 1, (unsigned)splits), s, tq, tx, scale, out, M, N, K);
}

template <int WG>
int prefill_wgmma_tn(int tn, const void* x, const void* q, const float* scale,
                     __nv_bfloat16* out, int M, int N, int K, int splits, cudaStream_t s) {
  switch (tn) {
    case 64: return prefill_wgmma<64, WG>(x, q, scale, out, M, N, K, splits, s);
    case 128: return prefill_wgmma<128, WG>(x, q, scale, out, M, N, K, splits, s);
    case 192: return prefill_wgmma<192, WG>(x, q, scale, out, M, N, K, splits, s);
    case 256: return prefill_wgmma<256, WG>(x, q, scale, out, M, N, K, splits, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. path (ops/quant.py's plan_q_matmul picks
// it): 0 the float32 tile, 1 the bf16 decode kernel with one block per 16
// channels, 2 the bf16 decode kernel split K over a cluster of `splits`
// blocks, 3 the bf16 mma.sync prefill kernel, 4 the bf16 wgmma prefill kernel
// with `tn` tokens and `wg` consumer warpgroups a block, split K over a
// cluster of `splits` blocks. Paths 2 and 4 need K % 16 == 0 and 16-byte
// aligned x and q (TMA and cp.async rows); 1 and 3 take any shape.
extern "C" int dk_q_matmul(const void* x, const void* q, const void* scale, void* out, int M,
                           int N, int K, int dtype, int path, int tn, int wg, int splits,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || N < 1 || K < 1) return (int)cudaErrorInvalidValue;
  const int8_t* qt = static_cast<const int8_t*>(q);
  const float* st = static_cast<const float*>(scale);
  if (dtype == 0 && path == 0) {
    dim3 grid((N + 63) / 64, (M + 63) / 64);
    qmm_f32_kernel<<<grid, 256, 0, s>>>(static_cast<const float*>(x), qt, st,
                                        static_cast<float*>(out), M, N, K);
    return (int)cudaGetLastError();
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  const __nv_bfloat16* xt = static_cast<const __nv_bfloat16*>(x);
  __nv_bfloat16* ot = static_cast<__nv_bfloat16*>(out);
  const int vec_x = K % 8 == 0 && aligned(x, 16);
  const int vec_q = K % 16 == 0 && aligned(q, 16);
  // the K split hands every block at least one chunk: 128 wide (decode), 64 (prefill)
  const int nch = path == 2 ? (K + kDsKC - 1) / kDsKC : (K + 63) / 64;
  const bool split_ok = vec_x && vec_q && splits >= 1 && splits <= kMaxCluster && splits <= nch;
  if (path == 1 && M <= kDecodeM) {
    const int blocks = (N + kDecCols - 1) / kDecCols;
    if (M > 8)
      qmm_decode_kernel<true><<<blocks, kDecWarps * 32, 0, s>>>(xt, qt, st, ot, M, N, K, vec_x,
                                                               vec_q);
    else
      qmm_decode_kernel<false><<<blocks, kDecWarps * 32, 0, s>>>(xt, qt, st, ot, M, N, K,
                                                                vec_x, vec_q);
    return (int)cudaGetLastError();
  }
  if (path == 2 && M <= kDecodeM && split_ok) {
    const dim3 grid((unsigned)((N + kDsCh - 1) / kDsCh), (unsigned)splits);
    const dim3 cluster(1, (unsigned)splits, 1);
    const int e = M > 8 ? launch_cluster(qmm_decode_split_kernel<true>, grid, 256, 0, cluster, s,
                                         xt, qt, st, ot, M, N, K)
                        : launch_cluster(qmm_decode_split_kernel<false>, grid, 256, 0, cluster,
                                         s, xt, qt, st, ot, M, N, K);
    return e ? e : (int)cudaGetLastError();
  }
  if (path == 3) {
    static bool configured = false;  // raise the dynamic shared-memory cap once
    if (!configured) {
      const cudaError_t e = cudaFuncSetAttribute(
          qmm_prefill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kPSmemBytes);
      if (e != cudaSuccess) return (int)e;
      configured = true;
    }
    dim3 grid((N + kPN - 1) / kPN, (M + kPM - 1) / kPM);
    qmm_prefill_kernel<<<grid, 256, kPSmemBytes, s>>>(xt, qt, st, ot, M, N, K, vec_x, vec_q);
    return (int)cudaGetLastError();
  }
  if (path == 4 && split_ok && (wg == 1 || wg == 2)) {
    const int e = wg == 2 ? prefill_wgmma_tn<2>(tn, x, q, st, ot, M, N, K, splits, s)
                          : prefill_wgmma_tn<1>(tn, x, q, st, ot, M, N, K, splits, s);
    return e ? e : (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}
