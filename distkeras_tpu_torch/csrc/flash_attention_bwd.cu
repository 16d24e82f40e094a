// Flash-attention backward for Hopper (sm_90a): dq (K3) and dk/dv (K4) from
// the forward's saved per-row log-sum-exp, never storing the [L, L] score or
// probability matrices.
//
// Replaces distkeras_tpu/ops/flash_attention.py::_fa_bwd_dq_kernel (K3) and
// ::_fa_bwd_dkv_kernel (K4), launched by _fa_backward. Same contract as the
// forward (csrc/flash_attention.cu): causal masking, a sliding `window`
// through band_predicate (query i sees key j iff j <= i when causal,
// i - j < window, and j - i < window when bidirectional) with out-of-band
// tiles skipped on both sides, an optional key_mask [B, L] (attend where
// > 0.5), grouped-query attention (query head h reads K/V head
// h / (H / Hkv)), masked scores at -1e9, any L (ragged tiles are masked at
// the sequence end). Both kernels rebuild p = exp(s * scale - lse) and set
// it to 0 off the valid set, so a fully masked row has zero gradients:
//   dp = dO v^T,  ds = p (dp - delta),  dq = scale * ds k,
//   dv = p^T dO,  dk = scale * ds^T q,
// with delta = rowsum(dO * O) [B*H, L] computed by the caller in f32.
//
// Layout: q/dO/dq [B, L, H, D], k/v/dk/dv [B, L, Hkv, D] (float32 or
// bfloat16), lse and delta [B*H, L] f32, key_mask [B, L] f32 or null. D <= 128.
//
// Grids. The TPU kernels walk the reduction axis on a sequential grid axis
// with VMEM accumulators; here a loop inside each block does:
//  * K3: one block per (b*h, q tile); it loops over the in-band k tiles
//    (the _first_k_tile/_last_k_tile bounds) and keeps dq in f32 registers,
//    written once.
//  * K4: one block per (b*hkv, k tile); it loops over the group's q heads
//    and, for each, over the in-band q tiles (_first_q_tile/_last_q_tile),
//    so dk and dv are summed over the whole GQA group inside the block: no
//    repeated K/V, no atomics, a deterministic result. Under causal masking
//    the first k tiles see the most q tiles, so the launch order starts the
//    longest blocks first.
//
// What bounds them on an H100: at training shapes (L = 2048, D = 64 or 128)
// each kernel does three (K3) or four (K4) L x L x D products per head, half
// that causal, against a few reads of q/k/v/dO: operations, so the tensor
// cores are the roof. Two kernels each, chosen by dtype and head dim:
//  * fa_bwd_dq_wgmma_kernel (K3: bfloat16, D = 64 or 128, 16-byte aligned
//    inputs). 128 q rows a block, 384 threads in three warpgroups, on a 1-D
//    grid whose consecutive blocks are the q tiles of one head (and the
//    heads of one GQA group neighbours), so the blocks resident together
//    read the same K/V from L2 (with the head index fastest: 540 against
//    497-516 us at config 9's shape, 657-664 against 609-633 at config 6's,
//    flash_ab.py on the H100); under causal masking the last q tiles have
//    the longest bands and launch first.
//    - Loads: one producer warp (warpgroup 2, down to 40 registers by
//      setmaxnreg) brings the block's q and dO tiles once and 64-key K/V
//      tiles through a 2-stage TMA ring (the 4-D maps of K4; a 3-stage ring
//      measured within the 2-stage one's spread), and writes each k tile's
//      key validity (key mask
//      and sequence end, read once per tile) and whether all or none of it
//      is valid; a tile with no valid key is neither loaded nor computed.
//      The consumers read their rows' lse (times log2 e; +inf past L) and
//      delta once into registers.
//    - Products: two consumer warpgroups (up to 232 registers each) own 64
//      q rows each. S = Q K^T and dP = dO V^T are wgmma m64n64k16 with q or
//      dO as A and the K or V tile as B, all K-major; dQ += dS K is wgmma
//      m64n64k16 (one per 64-column half of D) with dS packed to bf16 from
//      the accumulators as the register A operand and K read MN-major
//      through the transpose flag: no transposed copy of K exists. dQ
//      (64 x D f32 per warpgroup) stays in registers, scaled and stored once.
//    - p = exp2(s * scale * log2 e - lse * log2 e) is one FFMA and one
//      ex2.approx; only an edge tile (the sequence end, a masked key, the
//      diagonal or a window edge for the warp's 16 rows) evaluates the
//      predicate per entry. A fully masked row meets only skipped or edge
//      tiles, so its dq is exactly 0.
//    ptxas (CUDA 12.9): 168 registers at launch, no spills; SASS: 24 HGMMA
//    and 8 UTMALDG at D = 128, 12 and 4 at D = 64 (chip_smoke.py's
//    check_sass).
//  * fa_bwd_dkv_wgmma_kernel (K4: bfloat16, D = 64 or 128, 16-byte aligned
//    inputs). 128 keys a block, 384 threads in three warpgroups, on a 1-D
//    grid whose consecutive blocks are the k tiles of one head, so the
//    blocks resident together share its q and dO through L2 (8-12% faster
//    than the head index fastest at the training shapes, flash_ab.py on
//    the H100). A block whose 128 keys are all masked (a padded tail)
//    writes zeros and loads nothing.
//    - Loads: one producer warp (warpgroup 2, down to 24 registers by
//      setmaxnreg) brings the block's K and V once, then each (head, 64-row
//      q tile)'s q and dO by TMA into a 2-stage ring (4-D tensor maps over
//      (D, heads, L, B), 64-column boxes with the 128-byte swizzle, rows
//      past L zero-filled), and writes the tile's lse (times log2 e; +inf
//      past L, so p = 0 there) and delta, read from global memory once per
//      tile; mbarriers signal a full and a free stage.
//    - Products: two consumer warpgroups (up to 240 registers each) own 64
//      keys each. S^T = K Q^T and dP^T = V dO^T are wgmma m64n64k16 with
//      the K or V tile (loaded once) as A and the q or dO tile as B, all
//      K-major. dV += P^T dO and dK += dS^T q are wgmma m64n64k16 (one per
//      64-column half of D) with P^T and dS^T as register A operands,
//      packed to bf16 from the accumulators, and dO and q read MN-major
//      through wgmma's transpose flag: no transposed copy of q or dO
//      exists. dK and dV (2 x 64 x D f32 per warpgroup) stay in registers.
//    - p as in K3; only an edge tile (the sequence end, a masked key of the
//      warp's 16 keys, the diagonal or a window edge) evaluates the
//      predicate per entry, with the key mask of the thread's two keys read
//      once per block.
//    ptxas (CUDA 12.9): 168 registers at launch (setmaxnreg moves them to
//    the consumers), no spills; SASS: 32 HGMMA and 8 UTMALDG at D = 128,
//    16 and 4 at D = 64 (chip_smoke.py's check_sass).
//  * fa_bwd_*_kernel (float32, or any other D <= 128): plain f32 FMAs over
//    shared-memory tiles, one score tile entry per thread at a time.
//
// Plain C interface (bound with ctypes): each launcher returns the
// cudaGetLastError() of its launch, 0 on success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kDMax = 128;

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
  if (qp >= L || kp >= L) return false;
  if (causal && kp > qp) return false;
  if (window > 0) {
    if (qp - kp >= window) return false;
    if (!causal && kp - qp >= window) return false;
  }
  if (km != nullptr && !(km[kp] > 0.5f)) return false;
  return true;
}

// The k tiles (width bk) that q tile [q0, q0 + bq) can see
// (_first_k_tile/_last_k_tile).
__device__ __forceinline__ void k_band(int q0, int bq, int bk, int L, int causal, int window,
                                       int& first, int& last) {
  first = window > 0 ? max(0, q0 - window + 1) / bk : 0;
  last = (L + bk - 1) / bk - 1;
  if (causal) {
    last = min(last, (q0 + bq - 1) / bk);
  } else if (window > 0) {
    last = min(last, (q0 + bq - 1 + window - 1) / bk);
  }
}

// The q tiles (width bq) that can see k tile [k0, k0 + bk)
// (_first_q_tile/_last_q_tile).
__device__ __forceinline__ void q_band(int k0, int bk, int bq, int L, int causal, int window,
                                       int& first, int& last) {
  first = causal ? k0 / bq : (window > 0 ? max(0, k0 - window + 1) / bq : 0);
  last = (L + bq - 1) / bq - 1;
  if (window > 0) last = min(last, (k0 + bk - 1 + window - 1) / bq);
}

// band_predicate for one (query, key) pair.
__device__ __forceinline__ bool in_band(int qp, int kp, int causal, int window) {
  if (causal && kp > qp) return false;
  if (window > 0) {
    if (qp - kp >= window) return false;
    if (!causal && kp - qp >= window) return false;
  }
  return true;
}

// -- f32 FMA kernels (float32, or bfloat16 at other head dims) --------------

constexpr int kThreads = 256;
constexpr int kLd = kDMax + 1;     // f32 tile row stride: conflict-free columns
constexpr int kGQ = 16, kGK = 32;  // K3: q rows per block, keys per k tile
constexpr int kGK4 = 16, kGQ4 = 32;  // K4: keys per block, q rows per q tile
constexpr size_t kDqSmem =
    sizeof(float) * (2 * kGQ * kLd + 2 * kGK * kLd + kGQ * (kGK + 1) + 2 * kGQ);
constexpr size_t kDkvSmem =
    sizeof(float) * (2 * kGK4 * kLd + 2 * kGQ4 * kLd + 2 * kGK4 * (kGQ4 + 1) + 2 * kGQ4);

template <typename T>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, const float* __restrict__ key_mask,
                 T* __restrict__ dq, int L, int H, int Hkv, int D, float scale, int causal,
                 int window) {
  extern __shared__ float smem[];
  float* Qs = smem;                   // [kGQ][kLd]
  float* Gs = Qs + kGQ * kLd;         // [kGQ][kLd]: dO
  float* Ks = Gs + kGQ * kLd;         // [kGK][kLd]
  float* Vs = Ks + kGK * kLd;         // [kGK][kLd]
  float* Ss = Vs + kGK * kLd;         // [kGQ][kGK + 1]: ds
  float* Ls = Ss + kGQ * (kGK + 1);   // lse per row
  float* Ds = Ls + kGQ;               // delta per row

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.y * kGQ;
  const size_t qs = (size_t)H * D, ks = (size_t)Hkv * D;
  const T* qb = q + (size_t)b * L * qs + (size_t)h * D;
  const T* gb = dout + (size_t)b * L * qs + (size_t)h * D;
  const T* kb = k + (size_t)b * L * ks + (size_t)hk * D;
  const T* vb = v + (size_t)b * L * ks + (size_t)hk * D;
  const float* km = key_mask != nullptr ? key_mask + (size_t)b * L : nullptr;

  for (int i = tid; i < kGQ * kDMax; i += kThreads) {
    const int r = i / kDMax, d = i % kDMax, qp = q0 + r;
    const bool in = qp < L && d < D;
    Qs[r * kLd + d] = in ? to_f32(qb[(size_t)qp * qs + d]) : 0.f;
    Gs[r * kLd + d] = in ? to_f32(gb[(size_t)qp * qs + d]) : 0.f;
  }
  if (tid < kGQ) {
    const int qp = q0 + tid;
    Ls[tid] = qp < L ? lse[(size_t)bh * L + qp] : 0.f;
    Ds[tid] = qp < L ? delta[(size_t)bh * L + qp] : 0.f;
  }

  const int dcol = tid % kDMax, rbase = tid / kDMax;  // rows rbase + 2j
  float acc[kGQ / 2];
#pragma unroll
  for (int j = 0; j < kGQ / 2; ++j) acc[j] = 0.f;

  int first, last;
  k_band(q0, kGQ, kGK, L, causal, window, first, last);
  for (int kt = first; kt <= last; ++kt) {
    const int k0 = kt * kGK;
    __syncthreads();  // previous tile's Ks/Vs/Ss are consumed (and Qs/Gs stored)
    for (int i = tid; i < kGK * kDMax; i += kThreads) {
      const int r = i / kDMax, d = i % kDMax, kp = k0 + r;
      const bool in = kp < L && d < D;
      Ks[r * kLd + d] = in ? to_f32(kb[(size_t)kp * ks + d]) : 0.f;
      Vs[r * kLd + d] = in ? to_f32(vb[(size_t)kp * ks + d]) : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < kGQ * kGK; e += kThreads) {
      const int r = e / kGK, c = e % kGK;
      float ds = 0.f;
      if (valid_at(q0 + r, k0 + c, L, causal, window, km)) {
        float s = 0.f, dp = 0.f;
        for (int d = 0; d < D; ++d) {
          s = fmaf(Qs[r * kLd + d], Ks[c * kLd + d], s);
          dp = fmaf(Gs[r * kLd + d], Vs[c * kLd + d], dp);
        }
        ds = expf(s * scale - Ls[r]) * (dp - Ds[r]);
      }
      Ss[r * (kGK + 1) + c] = ds;
    }
    __syncthreads();
    if (dcol < D) {
#pragma unroll
      for (int j = 0; j < kGQ / 2; ++j) {
        const int r = rbase + 2 * j;
        for (int c = 0; c < kGK; ++c)
          acc[j] = fmaf(Ss[r * (kGK + 1) + c], Ks[c * kLd + dcol], acc[j]);
      }
    }
  }

  if (dcol < D) {
#pragma unroll
    for (int j = 0; j < kGQ / 2; ++j) {
      const int qp = q0 + rbase + 2 * j;
      if (qp < L)
        dq[(size_t)b * L * qs + (size_t)qp * qs + (size_t)h * D + dcol] =
            from_f32<T>(acc[j] * scale);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ delta, const float* __restrict__ key_mask,
                  T* __restrict__ dk, T* __restrict__ dv, int L, int H, int Hkv, int D,
                  float scale, int causal, int window) {
  extern __shared__ float smem[];
  float* Ks = smem;                   // [kGK4][kLd]
  float* Vs = Ks + kGK4 * kLd;        // [kGK4][kLd]
  float* Qs = Vs + kGK4 * kLd;        // [kGQ4][kLd]
  float* Gs = Qs + kGQ4 * kLd;        // [kGQ4][kLd]: dO
  float* Ps = Gs + kGQ4 * kLd;        // [kGK4][kGQ4 + 1]: p^T
  float* Ss = Ps + kGK4 * (kGQ4 + 1);  // [kGK4][kGQ4 + 1]: ds^T
  float* Ls = Ss + kGK4 * (kGQ4 + 1);  // lse per q row
  float* Ds = Ls + kGQ4;               // delta per q row

  const int tid = threadIdx.x;
  const int bk = blockIdx.x, b = bk / Hkv, hk = bk % Hkv;
  const int group = H / Hkv;
  const int k0 = blockIdx.y * kGK4;
  const size_t qs = (size_t)H * D, ks = (size_t)Hkv * D;
  const T* kb = k + (size_t)b * L * ks + (size_t)hk * D;
  const T* vb = v + (size_t)b * L * ks + (size_t)hk * D;
  const float* km = key_mask != nullptr ? key_mask + (size_t)b * L : nullptr;

  for (int i = tid; i < kGK4 * kDMax; i += kThreads) {
    const int r = i / kDMax, d = i % kDMax, kp = k0 + r;
    const bool in = kp < L && d < D;
    Ks[r * kLd + d] = in ? to_f32(kb[(size_t)kp * ks + d]) : 0.f;
    Vs[r * kLd + d] = in ? to_f32(vb[(size_t)kp * ks + d]) : 0.f;
  }

  const int dcol = tid % kDMax, cbase = tid / kDMax;  // keys cbase + 2j
  float acc_k[kGK4 / 2], acc_v[kGK4 / 2];
#pragma unroll
  for (int j = 0; j < kGK4 / 2; ++j) acc_k[j] = acc_v[j] = 0.f;

  int first, last;
  q_band(k0, kGK4, kGQ4, L, causal, window, first, last);
  for (int gi = 0; gi < group; ++gi) {
    const int h = hk * group + gi, bh = b * H + h;
    const T* qb = q + (size_t)b * L * qs + (size_t)h * D;
    const T* gb = dout + (size_t)b * L * qs + (size_t)h * D;
    for (int qt = first; qt <= last; ++qt) {
      const int q0 = qt * kGQ4;
      __syncthreads();  // previous q tile consumed (and Ks/Vs stored)
      for (int i = tid; i < kGQ4 * kDMax; i += kThreads) {
        const int r = i / kDMax, d = i % kDMax, qp = q0 + r;
        const bool in = qp < L && d < D;
        Qs[r * kLd + d] = in ? to_f32(qb[(size_t)qp * qs + d]) : 0.f;
        Gs[r * kLd + d] = in ? to_f32(gb[(size_t)qp * qs + d]) : 0.f;
      }
      if (tid < kGQ4) {
        const int qp = q0 + tid;
        Ls[tid] = qp < L ? lse[(size_t)bh * L + qp] : 0.f;
        Ds[tid] = qp < L ? delta[(size_t)bh * L + qp] : 0.f;
      }
      __syncthreads();
      for (int e = tid; e < kGK4 * kGQ4; e += kThreads) {
        const int c = e / kGQ4, r = e % kGQ4;
        float p = 0.f, ds = 0.f;
        if (valid_at(q0 + r, k0 + c, L, causal, window, km)) {
          float s = 0.f, dp = 0.f;
          for (int d = 0; d < D; ++d) {
            s = fmaf(Qs[r * kLd + d], Ks[c * kLd + d], s);
            dp = fmaf(Gs[r * kLd + d], Vs[c * kLd + d], dp);
          }
          p = expf(s * scale - Ls[r]);
          ds = p * (dp - Ds[r]);
        }
        Ps[c * (kGQ4 + 1) + r] = p;
        Ss[c * (kGQ4 + 1) + r] = ds;
      }
      __syncthreads();
      if (dcol < D) {
#pragma unroll
        for (int j = 0; j < kGK4 / 2; ++j) {
          const int c = cbase + 2 * j;
          for (int r = 0; r < kGQ4; ++r) {
            acc_v[j] = fmaf(Ps[c * (kGQ4 + 1) + r], Gs[r * kLd + dcol], acc_v[j]);
            acc_k[j] = fmaf(Ss[c * (kGQ4 + 1) + r], Qs[r * kLd + dcol], acc_k[j]);
          }
        }
      }
    }
  }

  if (dcol < D) {
#pragma unroll
    for (int j = 0; j < kGK4 / 2; ++j) {
      const int kp = k0 + cbase + 2 * j;
      if (kp < L) {
        const size_t off = (size_t)b * L * ks + (size_t)kp * ks + (size_t)hk * D + dcol;
        dk[off] = from_f32<T>(acc_k[j] * scale);
        dv[off] = from_f32<T>(acc_v[j]);
      }
    }
  }
}

// -- bfloat16 on the tensor cores: wgmma, TMA rings, warp specialisation ----

constexpr int kWThreads = 384;  // warpgroups 0-1 consume, warpgroup 2 loads
constexpr uint32_t kRow = 128;  // bytes of one swizzled tile row (64 bf16)
constexpr float kLog2e = 1.4426950408889634f;

// K3 on wgmma: a block owns 128 q rows (two consumer warpgroups of 64) and
// walks the in-band 64-key tiles of its (b, h) through a TMA ring.
constexpr int kDqBQ = 128;     // q rows per block
constexpr int kDqBK = 64;      // keys per k tile
constexpr int kDqStages = 2;   // depth of the K/V ring

// Shared memory of the wgmma K3, offsets from a 1024-byte aligned base.
template <int D>
struct DqSmem {
  static constexpr int H2 = D / 64;                            // 64-column halves
  static constexpr uint32_t q_bytes = H2 * kDqBQ * kRow;       // the q (or dO) tile
  static constexpr uint32_t kv_bytes = H2 * kDqBK * kRow;      // one K or V tile
  static constexpr uint32_t g_off = q_bytes;
  static constexpr uint32_t k_off = 2 * q_bytes;               // [kDqStages] K tiles
  static constexpr uint32_t v_off = k_off + kDqStages * kv_bytes;
  static constexpr uint32_t mask_off = v_off + kDqStages * kv_bytes;  // [kDqStages][kDqBK] f32
  static constexpr uint32_t flag_off = mask_off + kDqStages * kDqBK * 4;
  static constexpr uint32_t bar_off = flag_off + 64;
  static constexpr uint32_t bytes = bar_off + 8 * (1 + 3 * kDqStages) + 1024;  // + alignment
};

template <int D>
__global__ void __launch_bounds__(kWThreads, 1)
fa_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tg, const float* __restrict__ lse,
                       const float* __restrict__ delta, const float* __restrict__ key_mask,
                       __nv_bfloat16* __restrict__ dq, int L, int H, int Hkv, float scale,
                       int causal, int window) {
  using S = DqSmem<D>;
  constexpr int H2 = S::H2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Qs = base;
  uint8_t* Gs = base + S::g_off;
  float* maskS = reinterpret_cast<float*>(base + S::mask_off);
  int* flagS = reinterpret_cast<int*>(base + S::flag_off);
  uint64_t* qg_full = reinterpret_cast<uint64_t*>(base + S::bar_off);  // q and dO landed
  uint64_t* k_full = qg_full + 1;        // K tile landed, key mask tile written
  uint64_t* v_full = k_full + kDqStages;  // V tile landed
  uint64_t* empty = v_full + kDqStages;   // both consumer warpgroups are done with the stage

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // One block per (b*h, q tile) on a 1-D grid: the q tiles of one head are
  // consecutive and the heads of one GQA group neighbours, so the blocks
  // resident together read the same K/V from L2; under causal masking the
  // last q tiles have the longest bands and launch first.
  const int nqt = (L + kDqBQ - 1) / kDqBQ;
  const int bh = (int)blockIdx.x / nqt, b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = (nqt - 1 - (int)blockIdx.x % nqt) * kDqBQ;
  int first, last;
  k_band(q0, kDqBQ, kDqBK, L, causal, window, first, last);
  const int ntiles = last - first + 1;

  if (tid == 0) {
    hopper::mbar_init(qg_full, 1);
    for (int s = 0; s < kDqStages; ++s) {
      hopper::mbar_init(&k_full[s], 32);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&empty[s], 8);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 8) {  // producer warpgroup: its first warp keeps the ring full
    hopper::regs_dealloc<40>();
    if (warp == 8) {
      if (lane == 0) {
        hopper::mbar_arrive_expect_tx(qg_full, 2 * S::q_bytes);
        for (int c = 0; c < H2; ++c) {
          hopper::tma_load_4d(Qs + c * kDqBQ * kRow, &tq, qg_full, 64 * c, h, q0, b);
          hopper::tma_load_4d(Gs + c * kDqBQ * kRow, &tg, qg_full, 64 * c, h, q0, b);
        }
      }
      const float* km = key_mask != nullptr ? key_mask + (size_t)b * L : nullptr;
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % kDqStages, k0 = (first + i) * kDqBK;
        if (i >= kDqStages) hopper::mbar_wait(&empty[s], (i / kDqStages - 1) & 1);
        // the tile's key validity (mask and sequence end), read once, and
        // whether all of it (1) or none of it (-1: skipped without loading)
        // is valid
        bool all = true, any = false;
        for (int c = lane; c < kDqBK; c += 32) {
          const int kp = k0 + c;
          const float mv = (kp < L && (km == nullptr || km[kp] > 0.5f)) ? 1.f : 0.f;
          maskS[s * kDqBK + c] = mv;
          all = all && mv > 0.f;
          any = any || mv > 0.f;
        }
        all = __all_sync(0xffffffffu, all);
        any = __any_sync(0xffffffffu, any);
        if (lane == 0 && !any) {
          flagS[s] = -1;
          hopper::mbar_arrive(&k_full[s]);
          hopper::mbar_arrive(&v_full[s]);
        } else if (lane == 0) {
          flagS[s] = all ? 1 : 0;
          uint8_t* Ks = base + S::k_off + s * S::kv_bytes;
          uint8_t* Vs = base + S::v_off + s * S::kv_bytes;
          hopper::mbar_arrive_expect_tx(&k_full[s], S::kv_bytes);
          for (int c = 0; c < H2; ++c)
            hopper::tma_load_4d(Ks + c * kDqBK * kRow, &tk, &k_full[s], 64 * c, hk, k0, b);
          hopper::mbar_arrive_expect_tx(&v_full[s], S::kv_bytes);
          for (int c = 0; c < H2; ++c)
            hopper::tma_load_4d(Vs + c * kDqBK * kRow, &tv, &v_full[s], 64 * c, hk, k0, b);
        } else {
          hopper::mbar_arrive(&k_full[s]);
        }
      }
    }
  } else {  // consumer warpgroups: 64 q rows each, 16 a warp
    hopper::regs_alloc<232>();
    const int wg = warp / 4, g = lane / 4, t = lane % 4;
    const int wr0 = q0 + 64 * wg + 16 * (warp % 4);  // this warp's first row
    const int row_a = wr0 + g, row_b = row_a + 8;     // the thread's two rows
    const uint8_t* Qw = Qs + 64 * wg * kRow;
    const uint8_t* Gw = Gs + 64 * wg * kRow;
    // lse (in log2 units) and delta of the thread's rows, read once; rows
    // past L get lse = +inf, so their p is 0
    const size_t lrow = (size_t)bh * L;
    const float lse_a = row_a < L ? lse[lrow + row_a] * kLog2e : INFINITY;
    const float lse_b = row_b < L ? lse[lrow + row_b] * kLog2e : INFINITY;
    const float dl_a = row_a < L ? delta[lrow + row_a] : 0.f;
    const float dl_b = row_b < L ? delta[lrow + row_b] : 0.f;
    const float scale_log2 = scale * kLog2e;
    float acc[H2][32];
#pragma unroll
    for (int c = 0; c < H2; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[c][e] = 0.f;
    hopper::mbar_wait(qg_full, 0);

    for (int i = 0; i < ntiles; ++i) {
      const int s = i % kDqStages, k0 = (first + i) * kDqBK;
      const uint32_t parity = (i / kDqStages) & 1;
      const uint8_t* Ks = base + S::k_off + s * S::kv_bytes;
      const uint8_t* Vs = base + S::v_off + s * S::kv_bytes;
      hopper::mbar_wait(&k_full[s], parity);
      const int flag = flagS[s];
      if (flag < 0) {  // no valid key: p = 0 throughout
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&empty[s]);
        continue;
      }

      // S = Q K^T and dP = dO V^T: 64 rows x 64 keys, all operands K-major
      float sc[32], dp[32];
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk / 4, off = (kk % 4) * 32;
        hopper::wgmma_ss_m64n64(sc, hopper::sw128_desc(Qw + c * kDqBQ * kRow + off),
                                hopper::sw128_desc(Ks + c * kDqBK * kRow + off), kk > 0);
      }
      hopper::mbar_wait(&v_full[s], parity);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk / 4, off = (kk % 4) * 32;
        hopper::wgmma_ss_m64n64(dp, hopper::sw128_desc(Gw + c * kDqBQ * kRow + off),
                                hopper::sw128_desc(Vs + c * kDqBK * kRow + off), kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      hopper::fence_regs(dp);

      // p = exp2(s scale log2e - lse log2e), ds = p (dp - delta) into sc.
      // Only an edge tile (the sequence end, a masked key, the diagonal or
      // a window edge for this warp's rows) evaluates the predicate per
      // entry; p is 0 off the valid set.
      const bool interior =
          flag > 0 && (!causal || k0 + kDqBK - 1 <= wr0) &&
          (window <= 0 || (wr0 + 15 - k0 < window && (causal || k0 + kDqBK - 1 - wr0 < window)));
      const float* mk = maskS + s * kDqBK;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * t + e, kp = k0 + c;
          float pa = hopper::exp2_approx(fmaf(sc[4 * j + e], scale_log2, -lse_a));
          float pb = hopper::exp2_approx(fmaf(sc[4 * j + 2 + e], scale_log2, -lse_b));
          if (!interior) {
            const bool mv = mk[c] > 0.f;
            if (!(mv && in_band(row_a, kp, causal, window))) pa = 0.f;
            if (!(mv && in_band(row_b, kp, causal, window))) pb = 0.f;
          }
          sc[4 * j + e] = pa * (dp[4 * j + e] - dl_a);
          sc[4 * j + 2 + e] = pb * (dp[4 * j + 2 + e] - dl_b);
        }
      }

      // dQ += dS K: dS packed to bf16 from the accumulators (the register-A
      // layout); K read MN-major through the transpose flag, so no
      // transposed copy of K exists
      uint32_t da[kDqBK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kDqBK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          da[kk][r] = hopper::pack_bf16x2(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
#pragma unroll
      for (int c = 0; c < H2; ++c) hopper::fence_regs(acc[c]);
      hopper::fence_regs(da);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDqBK / 16; ++kk)
#pragma unroll
        for (int c = 0; c < H2; ++c)
          hopper::wgmma_rs_m64n64_tb(acc[c], da[kk],
                                     hopper::sw128_desc(Ks + c * kDqBK * kRow + kk * 2048));
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < H2; ++c) hopper::fence_regs(acc[c]);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
    }

    const size_t qs = (size_t)H * D;
    __nv_bfloat16* orow_a = dq + (size_t)b * L * qs + (size_t)row_a * qs + (size_t)h * D;
    __nv_bfloat16* orow_b = orow_a + 8 * qs;
#pragma unroll
    for (int c = 0; c < H2; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = 64 * c + 8 * j + 2 * t;
        if (row_a < L)
          *reinterpret_cast<__nv_bfloat162*>(orow_a + d) =
              __floats2bfloat162_rn(acc[c][4 * j] * scale, acc[c][4 * j + 1] * scale);
        if (row_b < L)
          *reinterpret_cast<__nv_bfloat162*>(orow_b + d) =
              __floats2bfloat162_rn(acc[c][4 * j + 2] * scale, acc[c][4 * j + 3] * scale);
      }
  }
}

// K4 on wgmma: a block owns 128 keys (two consumer warpgroups of 64) and
// walks the group's q heads and in-band 64-row q tiles through a TMA ring.
constexpr int kWBKV = 128;      // keys per block
constexpr int kWBQ4 = 64;       // q rows per q tile
constexpr int kStages = 2;      // depth of the q/dO ring

// Shared memory of the wgmma K4, offsets from a 1024-byte aligned base.
template <int D>
struct DkvSmem {
  static constexpr int H2 = D / 64;                           // 64-column halves
  static constexpr uint32_t kv_bytes = H2 * kWBKV * kRow;     // the K (or V) tile
  static constexpr uint32_t q_bytes = H2 * kWBQ4 * kRow;      // one q (or dO) tile
  static constexpr uint32_t v_off = kv_bytes;
  static constexpr uint32_t q_off = 2 * kv_bytes;             // [kStages] q tiles
  static constexpr uint32_t g_off = q_off + kStages * q_bytes;  // [kStages] dO tiles
  static constexpr uint32_t lse_off = g_off + kStages * q_bytes;  // [kStages][kWBQ4] lse*log2e
  static constexpr uint32_t delta_off = lse_off + kStages * kWBQ4 * 4;
  static constexpr uint32_t bar_off = delta_off + kStages * kWBQ4 * 4;
  static constexpr uint32_t bytes = bar_off + 8 * (1 + 2 * kStages) + 1024;  // + alignment
};

template <int D>
__global__ void __launch_bounds__(kWThreads, 1)
fa_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tg, const float* __restrict__ lse,
                        const float* __restrict__ delta, const float* __restrict__ key_mask,
                        __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int L,
                        int H, int Hkv, float scale, int causal, int window) {
  using S = DkvSmem<D>;
  constexpr int H2 = S::H2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Ks = base;
  uint8_t* Vs = base + S::v_off;
  float* lseS = reinterpret_cast<float*>(base + S::lse_off);
  float* deltaS = reinterpret_cast<float*>(base + S::delta_off);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(base + S::bar_off);
  uint64_t* full = kv_full + 1;        // q, dO tiles landed, lse and delta written
  uint64_t* empty = full + kStages;    // both consumer warpgroups are done with the stage

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // One block per (b*hkv, k tile), the tiles of one head consecutive so
  // that they run together and read its q/dO from L2; under causal masking
  // the first k tiles have the longest bands.
  const int nkt = (L + kWBKV - 1) / kWBKV;
  const int bkv = (int)blockIdx.x / nkt, b = bkv / Hkv, hk = bkv % Hkv;
  const int group = H / Hkv;
  const int k0 = ((int)blockIdx.x % nkt) * kWBKV;
  const float* km = key_mask != nullptr ? key_mask + (size_t)b * L : nullptr;
  int first, last;
  q_band(k0, kWBKV, kWBQ4, L, causal, window, first, last);
  const int nq = last - first + 1;

  if (tid == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 32);
      hopper::mbar_init(&empty[s], 8);
    }
    hopper::fence_barrier_init();
  }
  // A block whose keys are all masked (a padded tail) has dk = dv = 0 and
  // walks no q tile.
  const int kp = k0 + tid % kWBKV;
  const int live = __syncthreads_or(kp < L && (km == nullptr || km[kp] > 0.5f));
  const int ntiles = live ? group * nq : 0;  // (head, q tile) pairs

  if (warp >= 8) {  // producer warpgroup: its first warp keeps the ring full
    hopper::regs_dealloc<24>();
    if (warp == 8) {
      if (lane == 0 && ntiles > 0) {
        hopper::mbar_arrive_expect_tx(kv_full, 2 * S::kv_bytes);
        for (int c = 0; c < H2; ++c) {
          hopper::tma_load_4d(Ks + c * kWBKV * kRow, &tk, kv_full, 64 * c, hk, k0, b);
          hopper::tma_load_4d(Vs + c * kWBKV * kRow, &tv, kv_full, 64 * c, hk, k0, b);
        }
      }
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % kStages, h = hk * group + i / nq, q0 = (first + i % nq) * kWBQ4;
        const size_t row = (size_t)(b * H + h) * L;
        if (i >= kStages) hopper::mbar_wait(&empty[s], (i / kStages - 1) & 1);
        // lse (in log2 units) and delta read once per tile; rows past L get
        // lse = +inf, so their p is 0
        for (int c = lane; c < kWBQ4; c += 32) {
          const int qp = q0 + c;
          lseS[s * kWBQ4 + c] = qp < L ? lse[row + qp] * kLog2e : INFINITY;
          deltaS[s * kWBQ4 + c] = qp < L ? delta[row + qp] : 0.f;
        }
        if (lane == 0) {
          uint8_t* Qs = base + S::q_off + s * S::q_bytes;
          uint8_t* Gs = base + S::g_off + s * S::q_bytes;
          hopper::mbar_arrive_expect_tx(&full[s], 2 * S::q_bytes);
          for (int c = 0; c < H2; ++c) {
            hopper::tma_load_4d(Qs + c * kWBQ4 * kRow, &tq, &full[s], 64 * c, h, q0, b);
            hopper::tma_load_4d(Gs + c * kWBQ4 * kRow, &tg, &full[s], 64 * c, h, q0, b);
          }
        } else {
          hopper::mbar_arrive(&full[s]);
        }
      }
    }
  } else {  // consumer warpgroups: 64 keys each, 16 a warp
    hopper::regs_alloc<240>();
    const int wg = warp / 4, g = lane / 4, t = lane % 4;
    const int kw0 = k0 + 64 * wg + 16 * (warp % 4);  // this warp's first key
    const int key_a = kw0 + g, key_b = key_a + 8;    // the thread's two keys
    const uint8_t* Kw = Ks + 64 * wg * kRow;
    const uint8_t* Vw = Vs + 64 * wg * kRow;
    // the key mask of the thread's keys, read once; keys past L are invalid
    const bool kv_a = key_a < L && (km == nullptr || km[key_a] > 0.5f);
    const bool kv_b = key_b < L && (km == nullptr || km[key_b] > 0.5f);
    const bool keys_valid = __all_sync(0xffffffffu, kv_a && kv_b);
    const float scale_log2 = scale * kLog2e;
    float dka[H2][32], dva[H2][32];
#pragma unroll
    for (int c = 0; c < H2; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) dka[c][e] = dva[c][e] = 0.f;
    if (ntiles > 0) hopper::mbar_wait(kv_full, 0);

    for (int i = 0; i < ntiles; ++i) {
      const int s = i % kStages, q0 = (first + i % nq) * kWBQ4;
      const uint8_t* Qs = base + S::q_off + s * S::q_bytes;
      const uint8_t* Gs = base + S::g_off + s * S::q_bytes;
      hopper::mbar_wait(&full[s], (i / kStages) & 1);

      // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries, all K-major
      float st[32], dpt[32];
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk / 4, off = (kk % 4) * 32;
        hopper::wgmma_ss_m64n64(st, hopper::sw128_desc(Kw + c * kWBKV * kRow + off),
                                hopper::sw128_desc(Qs + c * kWBQ4 * kRow + off), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk / 4, off = (kk % 4) * 32;
        hopper::wgmma_ss_m64n64(dpt, hopper::sw128_desc(Vw + c * kWBKV * kRow + off),
                                hopper::sw128_desc(Gs + c * kWBQ4 * kRow + off), kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(st);
      hopper::fence_regs(dpt);

      // p^T = exp2(s scale log2e - lse log2e) into st, ds^T = p^T (dp^T -
      // delta) into dpt. Only an edge tile (the sequence end, a masked key,
      // the diagonal or a window edge for this warp's keys) evaluates the
      // predicate per entry; p is 0 off the valid set.
      const bool interior =
          keys_valid && q0 + kWBQ4 <= L && (!causal || kw0 + 15 <= q0) &&
          (window <= 0 || (q0 + kWBQ4 - 1 - kw0 < window && (causal || kw0 + 15 - q0 < window)));
      const float* ls = lseS + s * kWBQ4;
      const float* ds = deltaS + s * kWBQ4;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + 2 * t;
        const float2 l2 = *reinterpret_cast<const float2*>(ls + c);
        const float2 d2 = *reinterpret_cast<const float2*>(ds + c);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float lq = e ? l2.y : l2.x, dq_ = e ? d2.y : d2.x;
          float p0 = hopper::exp2_approx(fmaf(st[4 * j + e], scale_log2, -lq));
          float p1 = hopper::exp2_approx(fmaf(st[4 * j + 2 + e], scale_log2, -lq));
          if (!interior) {
            const int qp = q0 + c + e;
            if (!(kv_a && in_band(qp, key_a, causal, window))) p0 = 0.f;
            if (!(kv_b && in_band(qp, key_b, causal, window))) p1 = 0.f;
          }
          st[4 * j + e] = p0;
          st[4 * j + 2 + e] = p1;
          dpt[4 * j + e] = p0 * (dpt[4 * j + e] - dq_);
          dpt[4 * j + 2 + e] = p1 * (dpt[4 * j + 2 + e] - dq_);
        }
      }

      // dV += P^T dO and dK += dS^T Q: P^T and dS^T packed to bf16 from the
      // accumulators (the register-A layout); dO and q read MN-major with the
      // transpose flag, so neither needs a transposed copy
      uint32_t pa[kWBQ4 / 16][4], sa[kWBQ4 / 16][4];
#pragma unroll
      for (int kk = 0; kk < kWBQ4 / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pa[kk][r] = hopper::pack_bf16x2(st[8 * kk + 2 * r], st[8 * kk + 2 * r + 1]);
          sa[kk][r] = hopper::pack_bf16x2(dpt[8 * kk + 2 * r], dpt[8 * kk + 2 * r + 1]);
        }
      }
#pragma unroll
      for (int c = 0; c < H2; ++c) {
        hopper::fence_regs(dva[c]);
        hopper::fence_regs(dka[c]);
      }
      hopper::fence_regs(pa);
      hopper::fence_regs(sa);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWBQ4 / 16; ++kk)
#pragma unroll
        for (int c = 0; c < H2; ++c) {
          hopper::wgmma_rs_m64n64_tb(dva[c], pa[kk],
                                     hopper::sw128_desc(Gs + c * kWBQ4 * kRow + kk * 2048));
          hopper::wgmma_rs_m64n64_tb(dka[c], sa[kk],
                                     hopper::sw128_desc(Qs + c * kWBQ4 * kRow + kk * 2048));
        }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < H2; ++c) {
        hopper::fence_regs(dva[c]);
        hopper::fence_regs(dka[c]);
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
    }

    // The thread's keys and offsets are recomputed from the special
    // registers here, so nothing computed before the loop stays live
    // across it (without this ptxas spills a few predicates at D = 128).
    uint32_t tid_e, bid_e;
    asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(tid_e));
    asm volatile("mov.u32 %0, %%ctaid.x;\n" : "=r"(bid_e));
    const int bkv_e = (int)bid_e / nkt, lane_e = (int)tid_e % 32, t_e = lane_e % 4;
    const int ka = ((int)bid_e % nkt) * kWBKV + 64 * ((int)tid_e / 128) +
                   16 * (((int)tid_e / 32) % 4) + lane_e / 4;
    const size_t ks = (size_t)Hkv * D;
    const size_t off_a = (size_t)(bkv_e / Hkv) * L * ks + (size_t)ka * ks +
                         (size_t)(bkv_e % Hkv) * D;
    const size_t off_b = off_a + 8 * ks;
#pragma unroll
    for (int c = 0; c < H2; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = 64 * c + 8 * j + 2 * t_e;
        if (ka < L) {
          *reinterpret_cast<__nv_bfloat162*>(dk + off_a + d) =
              __floats2bfloat162_rn(dka[c][4 * j] * scale, dka[c][4 * j + 1] * scale);
          *reinterpret_cast<__nv_bfloat162*>(dv + off_a + d) =
              __floats2bfloat162_rn(dva[c][4 * j], dva[c][4 * j + 1]);
        }
        if (ka + 8 < L) {
          *reinterpret_cast<__nv_bfloat162*>(dk + off_b + d) =
              __floats2bfloat162_rn(dka[c][4 * j + 2] * scale, dka[c][4 * j + 3] * scale);
          *reinterpret_cast<__nv_bfloat162*>(dv + off_b + d) =
              __floats2bfloat162_rn(dva[c][4 * j + 2], dva[c][4 * j + 3]);
        }
      }
  }
}

// Raise a kernel's dynamic shared-memory cap once per process.
template <typename K>
cudaError_t configure(K kernel, size_t bytes, bool& done) {
  if (done) return cudaSuccess;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) done = true;
  return e;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta, *key_mask;
  int B, L, H, Hkv, D;
  float scale;
  int causal, window;
  cudaStream_t s;
};

template <int D>
int launch_dq_wgmma(const Args& a, void* dq) {
  static bool done = false;
  constexpr uint32_t bytes = DqSmem<D>::bytes;
  cudaError_t e = configure(fa_bwd_dq_wgmma_kernel<D>, bytes, done);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap tq, tk, tv, tg;
  if (!hopper::bf16_rows_map(&tq, a.q, a.B, a.L, a.H, D, kDqBQ) ||
      !hopper::bf16_rows_map(&tg, a.dout, a.B, a.L, a.H, D, kDqBQ) ||
      !hopper::bf16_rows_map(&tk, a.k, a.B, a.L, a.Hkv, D, kDqBK) ||
      !hopper::bf16_rows_map(&tv, a.v, a.B, a.L, a.Hkv, D, kDqBK))
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)(a.B * a.H) * (unsigned)((a.L + kDqBQ - 1) / kDqBQ);
  fa_bwd_dq_wgmma_kernel<D><<<blocks, kWThreads, bytes, a.s>>>(
      tq, tk, tv, tg, static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<const float*>(a.key_mask), static_cast<__nv_bfloat16*>(dq), a.L, a.H, a.Hkv,
      a.scale, a.causal, a.window);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dq(const Args& a, void* dq) {
  static bool done = false;
  cudaError_t e = configure(fa_bwd_dq_kernel<T>, kDqSmem, done);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)(a.B * a.H), (unsigned)((a.L + kGQ - 1) / kGQ));
  fa_bwd_dq_kernel<T><<<grid, kThreads, kDqSmem, a.s>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<const float*>(a.key_mask),
      static_cast<T*>(dq), a.L, a.H, a.Hkv, a.D, a.scale, a.causal, a.window);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_wgmma(const Args& a, void* dk, void* dv) {
  static bool done = false;
  constexpr uint32_t bytes = DkvSmem<D>::bytes;
  cudaError_t e = configure(fa_bwd_dkv_wgmma_kernel<D>, bytes, done);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap tq, tk, tv, tg;
  if (!hopper::bf16_rows_map(&tq, a.q, a.B, a.L, a.H, D, kWBQ4) ||
      !hopper::bf16_rows_map(&tg, a.dout, a.B, a.L, a.H, D, kWBQ4) ||
      !hopper::bf16_rows_map(&tk, a.k, a.B, a.L, a.Hkv, D, kWBKV) ||
      !hopper::bf16_rows_map(&tv, a.v, a.B, a.L, a.Hkv, D, kWBKV))
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)(a.B * a.Hkv) * (unsigned)((a.L + kWBKV - 1) / kWBKV);
  fa_bwd_dkv_wgmma_kernel<D><<<blocks, kWThreads, bytes, a.s>>>(
      tq, tk, tv, tg, static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<const float*>(a.key_mask), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), a.L, a.H, a.Hkv, a.scale, a.causal, a.window);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dkv(const Args& a, void* dk, void* dv) {
  static bool done = false;
  cudaError_t e = configure(fa_bwd_dkv_kernel<T>, kDkvSmem, done);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)(a.B * a.Hkv), (unsigned)((a.L + kGK4 - 1) / kGK4));
  fa_bwd_dkv_kernel<T><<<grid, kThreads, kDkvSmem, a.s>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<const float*>(a.key_mask),
      static_cast<T*>(dk), static_cast<T*>(dv), a.L, a.H, a.Hkv, a.D, a.scale, a.causal,
      a.window);
  return (int)cudaGetLastError();
}

bool valid_args(const Args& a) {
  return a.B >= 1 && a.L >= 1 && a.H >= 1 && a.Hkv >= 1 && a.H % a.Hkv == 0 && a.D >= 1 &&
         a.D <= kDMax;
}

// The tensor-core kernels take bfloat16 at D = 64 or 128 with 16-byte aligned
// q/k/v/dO (every row then starts 16-byte aligned).
bool use_mma(const Args& a, int dtype) {
  return dtype == 1 && (a.D == 64 || a.D == 128) && aligned16(a.q) && aligned16(a.k) &&
         aligned16(a.v) && aligned16(a.dout);
}

}  // namespace

extern "C" int dk_flash_attention_bwd_max_head_dim() { return kDMax; }

// dtype: 0 = float32, 1 = bfloat16. window <= 0 means no window.
extern "C" int dk_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                         const void* dout, const void* lse, const void* delta,
                                         const void* key_mask, void* dq, int B, int L, int H,
                                         int Hkv, int D, float scale, int causal, int window,
                                         int dtype, void* stream) {
  const Args a{q, k, v, dout, lse, delta, key_mask, B, L, H, Hkv, D, scale, causal, window,
               static_cast<cudaStream_t>(stream)};
  if (!valid_args(a)) return (int)cudaErrorInvalidValue;
  if (use_mma(a, dtype))
    return D == 128 ? launch_dq_wgmma<128>(a, dq) : launch_dq_wgmma<64>(a, dq);
  if (dtype == 0) return launch_dq<float>(a, dq);
  if (dtype == 1) return launch_dq<__nv_bfloat16>(a, dq);
  return (int)cudaErrorInvalidValue;
}

extern "C" int dk_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse, const void* delta,
                                          const void* key_mask, void* dk, void* dv, int B, int L,
                                          int H, int Hkv, int D, float scale, int causal,
                                          int window, int dtype, void* stream) {
  const Args a{q, k, v, dout, lse, delta, key_mask, B, L, H, Hkv, D, scale, causal, window,
               static_cast<cudaStream_t>(stream)};
  if (!valid_args(a)) return (int)cudaErrorInvalidValue;
  if (use_mma(a, dtype))
    return D == 128 ? launch_dkv_wgmma<128>(a, dk, dv) : launch_dkv_wgmma<64>(a, dk, dv);
  if (dtype == 0) return launch_dkv<float>(a, dk, dv);
  if (dtype == 1) return launch_dkv<__nv_bfloat16>(a, dk, dv);
  return (int)cudaErrorInvalidValue;
}
