// Flash-attention forward for Hopper (sm_90a): online-softmax attention that
// never stores the [L, L] score matrix, emitting O and the per-row
// log-sum-exp.
//
// Replaces distkeras_tpu/ops/flash_attention.py::_fa_kernel (launched by
// _fa_forward). Same contract: causal masking, a sliding `window` through
// band_predicate (query i sees key j iff j <= i when causal, i - j < window,
// and j - i < window when bidirectional), an optional key_mask [B, L]
// (attend where > 0.5), grouped-query attention (query head h reads K/V head
// h / (H / Hkv), read in place: no repeated K/V is materialized), masked
// scores set to -1e9, and fully masked rows giving O = 0 (l floored at
// 1e-30). Unlike the TPU kernel it takes any L: the last q and k tiles are
// masked at the sequence end, so serving prefill lengths that are block
// multiples but not tile multiples run here too.
//
// Layout: q [B, L, H, D], k/v [B, L, Hkv, D] (float32 or bfloat16),
// key_mask [B, L] f32 or null → out [B, L, H, D] in q's type, lse [B*H, L]
// f32. D <= 128.
//
// Grid: one block per (b*h, 64-row q tile). The block loops over the k tiles
// of its band only (the _first_k_tile/_last_k_tile bounds of the TPU
// kernel), holding Q and one K/V tile in shared memory.
//
// What bounds it on an H100: at prefill lengths the work is operations
// (4*L*L*D per head, half that causal) against a few MB of Q/K/V, so the
// tensor cores are the roof. Two kernels, chosen by dtype and head dim:
//  * fa_fwd_mma_kernel (bfloat16, D = 64 or 128, 16-byte aligned inputs —
//    the served path): tensor cores through mma.sync m16n8k16, FA2-style.
//    Four warps own 16 query rows each; S = QK^T stays in registers, the
//    online softmax runs on it there (row max and sum across the 4 lanes of
//    a quad), and P is re-packed in registers as the A operand of O += PV,
//    so neither S nor P touches shared memory. V is stored transposed in
//    shared memory so each B fragment is one 32-bit load; rows are padded
//    16 bytes so fragment loads hit 32 distinct banks. O (f32) lives in
//    registers, scaled per row by the softmax correction. Loads are not
//    pipelined yet (no cp.async/TMA ring) and the tiles are mma.sync, not
//    wgmma: that is the next step.
//  * fa_fwd_kernel (float32, or any other D <= 128): plain f32 FMAs from
//    shared memory (4x4 register tiles for S = QK^T, 4x8 for O += PV),
//    ~114 KB of f32 tiles, m and l per row in shared memory.
//
// Plain C interface (bound with ctypes): dk_flash_attention_fwd returns the
// cudaGetLastError() of its launch, 0 on success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64, kBK = 64, kDMax = 128, kThreads = 256;
constexpr int kQLd = kDMax + 1, kPLd = kBK + 1;
constexpr float kNeg = -1e9f;  // _NEG of the TPU kernel
constexpr size_t kSmemBytes =
    sizeof(float) * ((size_t)kBQ * kQLd + (size_t)kBK * kQLd + (size_t)kBK * kDMax +
                     (size_t)kBQ * kPLd + 3 * kBQ);

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// band_predicate + key mask + sequence end, for one (query, key) position.
__device__ __forceinline__ bool valid_at(int qp, int kp, int L, int causal, int window,
                                         const float* km) {
  if (kp >= L) return false;
  if (causal && kp > qp) return false;
  if (window > 0) {
    if (qp - kp >= window) return false;
    if (!causal && kp - qp >= window) return false;
  }
  if (km != nullptr && !(km[kp] > 0.5f)) return false;
  return true;
}

// The band of k tiles q tile q0 can see (_first_k_tile/_last_k_tile).
__device__ __forceinline__ void band_tiles(int q0, int L, int causal, int window, int& first,
                                           int& last) {
  const int nk = (L + kBK - 1) / kBK;
  first = window > 0 ? max(0, q0 - window + 1) / kBK : 0;
  last = nk - 1;
  if (causal) {
    last = min(last, (q0 + kBQ - 1) / kBK);
  } else if (window > 0) {
    last = min(last, (q0 + kBQ - 1 + window - 1) / kBK);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const float* __restrict__ key_mask, T* __restrict__ out,
              float* __restrict__ lse, int L, int H, int Hkv, int D, float scale,
              int causal, int window) {
  extern __shared__ float smem[];
  float* Qs = smem;                   // [kBQ][kQLd], pre-scaled
  float* Ks = Qs + kBQ * kQLd;        // [kBK][kQLd]
  float* Vs = Ks + kBK * kQLd;        // [kBK][kDMax]
  float* Ps = Vs + kBK * kDMax;       // [kBQ][kPLd]: scores, then probabilities
  float* m_s = Ps + kBQ * kPLd;       // running max
  float* l_s = m_s + kBQ;             // running denominator
  float* c_s = l_s + kBQ;             // this tile's rescale factor

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);       // _kv_row: GQA head map
  const int q0 = blockIdx.y * kBQ;
  const size_t qs = (size_t)H * D, ks = (size_t)Hkv * D;
  const T* qb = q + (size_t)b * L * qs + (size_t)h * D;
  const T* kb = k + (size_t)b * L * ks + (size_t)hk * D;
  const T* vb = v + (size_t)b * L * ks + (size_t)hk * D;
  const float* km = key_mask != nullptr ? key_mask + (size_t)b * L : nullptr;

  for (int i = tid; i < kBQ * kDMax; i += kThreads) {
    const int r = i / kDMax, d = i % kDMax, qp = q0 + r;
    Qs[r * kQLd + d] = (qp < L && d < D) ? to_f32(qb[(size_t)qp * qs + d]) * scale : 0.f;
  }
  if (tid < kBQ) {
    m_s[tid] = kNeg;
    l_s[tid] = 0.f;
  }

  const int rg = tid / 16, cg = tid % 16;  // rows rg+16i, cols / dims cg+16j
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  int first, last;
  band_tiles(q0, L, causal, window, first, last);

  const int warp = tid / 32, lane = tid % 32;
  for (int kt = first; kt <= last; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // previous tile's Ks/Vs/Ps are consumed
    for (int i = tid; i < kBK * kDMax; i += kThreads) {
      const int r = i / kDMax, d = i % kDMax, kp = k0 + r;
      const bool in = kp < L && d < D;
      Ks[r * kQLd + d] = in ? to_f32(kb[(size_t)kp * ks + d]) : 0.f;
      Vs[r * kDMax + d] = in ? to_f32(vb[(size_t)kp * ks + d]) : 0.f;
    }
    __syncthreads();

    // S = (q * scale) k^T for rows rg+16i, keys cg+16j; invalid → -inf marker
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(rg + 16 * i) * kQLd + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = Ks[(cg + 16 * j) * kQLd + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bb[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = cg + 16 * j;
        Ps[r * kPLd + c] =
            valid_at(q0 + r, k0 + c, L, causal, window, km) ? s[i][j] : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax, one warp per 8 rows, two keys per lane
    for (int rr = 0; rr < kBQ / 8; ++rr) {
      const int r = warp * (kBQ / 8) + rr;
      const float x0 = Ps[r * kPLd + lane], x1 = Ps[r * kPLd + lane + 32];
      float mx = fmaxf(isinf(x0) ? kNeg : x0, isinf(x1) ? kNeg : x1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = isinf(x0) ? 0.f : expf(x0 - m_new);
      const float p1 = isinf(x1) ? 0.f : expf(x1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      Ps[r * kPLd + lane] = p0;
      Ps[r * kPLd + lane + 32] = p1;
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[rg + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= corr;
    }
    const int kn = min(kBK, L - k0);
    for (int c = 0; c < kn; ++c) {
      float p[4], vv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(rg + 16 * i) * kPLd + c];
#pragma unroll
      for (int j = 0; j < 8; ++j) vv[j] = Vs[c * kDMax + cg + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg + 16 * i, qp = q0 + r;
    if (qp >= L) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
    T* orow = out + (size_t)b * L * qs + (size_t)qp * qs + (size_t)h * D;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = cg + 16 * j;
      if (d < D) orow[d] = from_f32<T>(acc[i][j] / l);
    }
    if (cg == 0) lse[(size_t)bh * L + qp] = m_s[r] + logf(l);
  }
}

// -- bfloat16 on the tensor cores ------------------------------------------

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// c += A B, m16n8k16: a0/a2 A row g at k {2t, 2t+1} / {2t+8, 2t+9}, a1/a3 row
// g+8; b0/b1 B column g at the same k; c0,c1 row g and c2,c3 row g+8 at
// columns 2t, 2t+1 (g = lane / 4, t = lane % 4).
__device__ __forceinline__ void mma_16816(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                          uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int D>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * ((size_t)2 * kBQ * (D + 8) + (size_t)D * (kBK + 8));
}

template <int D>
__global__ void __launch_bounds__(128)
fa_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const float* __restrict__ key_mask,
                  __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int L, int H,
                  int Hkv, float scale, int causal, int window) {
  constexpr int LD = D + 8, VLD = kBK + 8, C8 = D / 8;  // padded row strides
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kBQ][LD]
  __nv_bfloat16* Ks = Qs + kBQ * LD;                                // [kBK][LD]
  __nv_bfloat16* Vt = Ks + kBK * LD;                                // [D][VLD]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);  // _kv_row: GQA head map
  const int q0 = blockIdx.y * kBQ;
  const size_t qs = (size_t)H * D, ks = (size_t)Hkv * D;
  const __nv_bfloat16* qb = q + (size_t)b * L * qs + (size_t)h * D;
  const __nv_bfloat16* kb = k + (size_t)b * L * ks + (size_t)hk * D;
  const __nv_bfloat16* vb = v + (size_t)b * L * ks + (size_t)hk * D;
  const float* km = key_mask != nullptr ? key_mask + (size_t)b * L : nullptr;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  for (int i = tid; i < kBQ * C8; i += 128) {
    const int r = i / C8, c = (i % C8) * 8, qp = q0 + r;
    *reinterpret_cast<uint4*>(Qs + r * LD + c) =
        qp < L ? *reinterpret_cast<const uint4*>(qb + (size_t)qp * qs + c) : zero;
  }

  const int r0 = warp * 16;                     // this warp's rows in the tile
  const int row0 = q0 + r0 + g, row1 = row0 + 8;  // the thread's two rows
  float o[C8][4];
#pragma unroll
  for (int j = 0; j < C8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;

  int first, last;
  band_tiles(q0, L, causal, window, first, last);
  for (int kt = first; kt <= last; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // previous tile's Ks/Vt are consumed (and Qs is stored)
    for (int i = tid; i < kBK * C8; i += 128) {
      const int r = i % kBK, c = (i / kBK) * 8, kp = k0 + r;  // r fastest: Vt stores
      *reinterpret_cast<uint4*>(Ks + r * LD + c) =
          kp < L ? *reinterpret_cast<const uint4*>(kb + (size_t)kp * ks + c) : zero;
      const uint4 vv =
          kp < L ? *reinterpret_cast<const uint4*>(vb + (size_t)kp * ks + c) : zero;
      const uint32_t vw[4] = {vv.x, vv.y, vv.z, vv.w};
      unsigned short* vt16 = reinterpret_cast<unsigned short*>(Vt);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        vt16[(c + e) * VLD + r] = (unsigned short)(vw[e / 2] >> (16 * (e % 2)));
    }
    __syncthreads();

    // S = Q K^T: 16 rows x 64 keys as 8 n8 tiles, in registers
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kd = 0; kd < D; kd += 16) {
      const __nv_bfloat16* qa = Qs + (r0 + g) * LD + kd + 2 * t;
      const uint32_t a0 = lds32(qa), a1 = lds32(qa + 8 * LD);
      const uint32_t a2 = lds32(qa + 8), a3 = lds32(qa + 8 * LD + 8);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const __nv_bfloat16* kk = Ks + (nt * 8 + g) * LD + kd + 2 * t;
        mma_16816(s[nt], a0, a1, a2, a3, lds32(kk), lds32(kk + 8));
      }
    }

    // mask (-inf marker; -1e9 in the max, as the TPU kernel), online softmax
    float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kp = k0 + nt * 8 + 2 * t + e;
        if (valid_at(row0, kp, L, causal, window, km)) {
          s[nt][e] *= scale;
          mx0 = fmaxf(mx0, s[nt][e]);
        } else {
          s[nt][e] = -INFINITY;
        }
        if (valid_at(row1, kp, L, causal, window, km)) {
          s[nt][2 + e] *= scale;
          mx1 = fmaxf(mx1, s[nt][2 + e]);
        } else {
          s[nt][2 + e] = -INFINITY;
        }
      }
    }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[nt][e] = isinf(s[nt][e]) ? 0.f : expf(s[nt][e] - mn0);
        s[nt][2 + e] = isinf(s[nt][2 + e]) ? 0.f : expf(s[nt][2 + e] - mn1);
        sum0 += s[nt][e];
        sum1 += s[nt][2 + e];
      }
    }
    const float c0 = expf(m0 - mn0), c1 = expf(m1 - mn1);
    l0 = l0 * c0 + quad_sum(sum0);
    l1 = l1 * c1 + quad_sum(sum1);
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int j = 0; j < C8; ++j) {
      o[j][0] *= c0; o[j][1] *= c0;
      o[j][2] *= c1; o[j][3] *= c1;
    }

    // O += P V: P re-packed from the S registers as the A operand
#pragma unroll
    for (int kq = 0; kq < kBK / 16; ++kq) {
      const uint32_t a0 = pack_bf16x2(s[2 * kq][0], s[2 * kq][1]);
      const uint32_t a1 = pack_bf16x2(s[2 * kq][2], s[2 * kq][3]);
      const uint32_t a2 = pack_bf16x2(s[2 * kq + 1][0], s[2 * kq + 1][1]);
      const uint32_t a3 = pack_bf16x2(s[2 * kq + 1][2], s[2 * kq + 1][3]);
#pragma unroll
      for (int j = 0; j < C8; ++j) {
        const __nv_bfloat16* vt = Vt + (j * 8 + g) * VLD + kq * 16 + 2 * t;
        mma_16816(o[j], a0, a1, a2, a3, lds32(vt), lds32(vt + 8));
      }
    }
  }

  const float f0 = 1.f / fmaxf(l0, 1e-30f), f1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
  for (int j = 0; j < C8; ++j) {
    const int d = j * 8 + 2 * t;
    if (row0 < L)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)b * L * qs + (size_t)row0 * qs +
                                         (size_t)h * D + d) =
          __floats2bfloat162_rn(o[j][0] * f0, o[j][1] * f0);
    if (row1 < L)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)b * L * qs + (size_t)row1 * qs +
                                         (size_t)h * D + d) =
          __floats2bfloat162_rn(o[j][2] * f1, o[j][3] * f1);
  }
  if (t == 0) {
    if (row0 < L) lse[(size_t)bh * L + row0] = m0 + logf(fmaxf(l0, 1e-30f));
    if (row1 < L) lse[(size_t)bh * L + row1] = m1 + logf(fmaxf(l1, 1e-30f));
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, const void* key_mask, void* out,
               void* lse, int B, int L, int H, int Hkv, float scale, int causal, int window,
               cudaStream_t s) {
  static bool configured = false;  // raise the dynamic shared-memory cap once
  constexpr size_t bytes = mma_smem_bytes<D>();
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(fa_fwd_mma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  dim3 grid((unsigned)(B * H), (unsigned)((L + kBQ - 1) / kBQ));
  fa_fwd_mma_kernel<D><<<grid, 128, bytes, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(key_mask),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), L, H, Hkv, scale, causal,
      window);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* key_mask, void* out,
           void* lse, int B, int L, int H, int Hkv, int D, float scale, int causal,
           int window, cudaStream_t s) {
  static bool configured = false;  // raise the dynamic shared-memory cap once
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(fa_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  dim3 grid((unsigned)(B * H), (unsigned)((L + kBQ - 1) / kBQ));
  fa_fwd_kernel<T><<<grid, kThreads, kSmemBytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(key_mask), static_cast<T*>(out), static_cast<float*>(lse),
      L, H, Hkv, D, scale, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dk_flash_attention_max_head_dim() { return kDMax; }

// dtype: 0 = float32, 1 = bfloat16. window <= 0 means no window.
extern "C" int dk_flash_attention_fwd(const void* q, const void* k, const void* v,
                                      const void* key_mask, void* out, void* lse, int B,
                                      int L, int H, int Hkv, int D, float scale, int causal,
                                      int window, int dtype, void* stream) {
  if (B < 1 || L < 1 || H < 1 || Hkv < 1 || H % Hkv != 0 || D < 1 || D > kDMax)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, key_mask, out, lse, B, L, H, Hkv, D, scale, causal, window, s);
  if (dtype == 1 && aligned16(q) && aligned16(k) && aligned16(v)) {
    if (D == 128)
      return launch_mma<128>(q, k, v, key_mask, out, lse, B, L, H, Hkv, scale, causal, window,
                             s);
    if (D == 64)
      return launch_mma<64>(q, k, v, key_mask, out, lse, B, L, H, Hkv, scale, causal, window,
                            s);
  }
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, key_mask, out, lse, B, L, H, Hkv, D, scale, causal,
                                 window, s);
  return (int)cudaErrorInvalidValue;
}
