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
// What bounds it on an H100: at training and prefill lengths the work is
// operations (4*L*L*D per head, half that causal) against a few MB of
// Q/K/V, so the tensor cores are the roof; the softmax's exponentials (one
// per score against 4*D tensor-core operations) are the next limit. Three
// kernels; ops/flash_attention.py::flash_route picks by dtype, head dim and
// alignment, and the small-D kernel has an entry point of its own:
//  * fa_fwd_wgmma_kernel (bfloat16, D = 64 or 128, 16-byte aligned inputs:
//    the served prefill and both training configs). One block per (b*h,
//    128-row q tile) on a 1-D grid whose consecutive blocks are the q tiles
//    of one head, longest causal band first: the blocks resident together
//    share their K/V through L2 (with the head index fastest, every
//    resident block read another head's K/V from HBM: 461 against 357 us
//    at config 9's shape, flash_ab.py on the H100). 384 threads in three
//    warpgroups.
//    - Loads: one producer warp (warpgroup 2, down to 40 registers by
//      setmaxnreg) brings Q once and K/V tiles of 128 keys into a 2-stage
//      ring by TMA: Q, K and V are 4-D tensor maps over (D, heads, L, B),
//      boxes of 64 columns by 128 rows with the 128-byte swizzle, rows past
//      L zero-filled by the hardware. It also writes each tile's key
//      validity (key mask and sequence end, read from global memory once
//      per tile) and whether all or none of it is valid, then signals the
//      consumers through mbarriers (K and V separately); the consumers
//      free a stage through a third mbarrier. A tile with no valid key (a
//      padded tail) is neither loaded nor computed: its p would be 0. TMA,
//      not a cp.async ring: three tensor-map encodes per call cost the host
//      ~microseconds, and the producer spends no registers on addresses.
//    - Products: two consumer warpgroups (up to 232 registers each) own 64
//      q rows each. S = Q K^T is wgmma m64n128k16 with Q and K both
//      K-major in shared memory; O += P V is wgmma m64n64k16 (one per
//      64-column half of D) with P as the register A operand (the bf16-
//      packed S accumulator already has that layout) and V read MN-major
//      through wgmma's transpose flag: no transposed copy of V exists.
//    - Softmax: only an edge tile (the sequence end, a masked key, the
//      diagonal or a window edge for a warp's 16 rows) evaluates the
//      predicate per entry; an interior tile goes straight to the row max.
//      scale*log2(e) is folded into one FFMA feeding ex2.approx, the
//      running max is kept in the log2 domain, l is summed per thread and
//      reduced across the quad once at the end, and lse is written back in
//      natural log (K3 and K4 read it so). A fully masked row gets O = 0
//      and the plain version's -1e9 + log(1e-30).
//    - Tried and not kept: issuing tile i's S before tile i-1's P V so the
//      softmax overlaps it (FA3's intra-warpgroup pipelining, two P tiles
//      live): 3% slower at config 9's shape and 18% at config 6's
//      (flash_ab.py on the H100).
//    ptxas (CUDA 12.9): 168 registers at launch (setmaxnreg moves them to
//    the consumers), no spills; SASS: 24 HGMMA and 6 UTMALDG at D = 128,
//    12 and 3 at D = 64 (chip_smoke.py's check_sass).
//  * fa_fwd_small_kernel (bfloat16, D = 16 or 32, 16-byte aligned inputs:
//    the LM twin's D=16, the zoo's default widths' D=32), through
//    dk_flash_attention_fwd_small, which refuses anything else (no fallback
//    to the FMA kernel).
//    - What bounds it: at the twin's L=128, latency (B*H items of one q
//      tile and one k tile, a few us of work each); at L=2048 the softmax
//      (exponentials, and each warpgroup's serial S -> softmax -> P V
//      chain), not the tensor cores: at D = 32 it sits at 5.9x the
//      operations bound (chip_smoke.py, H100 80GB HBM3, 700 W).
//    - Tensor cores: wgmma at the row width's swizzle. A 16- or 32-column
//      head is a 32- or 64-byte row: TMA boxes the whole head with
//      CU_TENSOR_MAP_SWIZZLE_32B / _64B, and wgmma reads it through
//      descriptors of layout types 3 / 2 (hopper.cuh: sw32_desc,
//      sw64_desc). S = Q K^T is m64n128k16, one k16 step at D = 16 and two
//      at 32 (+32 bytes inside the row); O += P V is m64n16k16 / m64n32k16
//      with P as the register A operand and V MN-major through the
//      transpose flag (+16 rows a k16 step). This is the first choice for
//      these head dims (mma.sync with ldmatrix was the fallback); it came
//      right on the first call on the card.
//    - Occupancy: shared memory sized by D (Q double-buffered, a 2-stage
//      K/V ring of 128-key tiles: ~26 KB at D = 16, ~50 KB at 32); 256
//      threads, two warpgroups of 64 q rows, both computing;
//      __launch_bounds__(256, 2): 128 registers, two blocks an SM. No
//      producer warpgroup (its registers are what the consumers lack):
//      warp 0 issues the TMA loads itself, two elements ahead, and keeps
//      its walk's state in shared memory.
//    - Work per block: a persistent grid of min(items, resident blocks)
//      blocks (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs), each
//      walking (b*h, 128-row q tile) items, q tiles from the last (under
//      causal masking the longest bands first) and handed out in snake
//      order (small_item_index), as one stream of (item, k tile)
//      elements: the next item's Q, K and V load during this item's last
//      tile and epilogue.
//    - Softmax, lse and fully masked rows as in fa_fwd_wgmma_kernel; an
//      edge tile masks each row by the range of the tile's columns its
//      band holds (band_predicate solved once a tile), and reads the key
//      mask only where the tile has a masked key or the sequence end
//      (the per-entry predicate it replaced was most of an edge tile's
//      cost).
//    - Tried and not kept (A/B on the H100): a 3-stage ring (no gain);
//      64-key tiles at three blocks an SM (a faster decode prefill, but a
//      slower L=2048, and it spills).
//    ptxas: 127 registers at D = 16 and 32, no spills; SASS: 9 / 10
//    HGMMA and 6 UTMALDG (chip_smoke.py's check_sass).
//  * fa_fwd_kernel (float32, or bfloat16 at any other D <= 128): one block
//    per (b*h, 64-row q tile) over the k tiles of its band, plain f32 FMAs
//    from shared memory (4x4 register tiles for S = QK^T, 4x8 for O +=
//    PV), ~114 KB of f32 tiles, m and l per row in shared memory.
//
// Plain C interface (bound with ctypes): dk_flash_attention_fwd and
// dk_flash_attention_fwd_small return the cudaGetLastError() of their
// launch, 0 on success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

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

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
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

// The k tiles (width bk) that q tile [q0, q0 + bq) can see
// (_first_k_tile/_last_k_tile).
__device__ __forceinline__ void band_tiles(int q0, int bq, int bk, int L, int causal, int window,
                                           int& first, int& last) {
  first = window > 0 ? max(0, q0 - window + 1) / bk : 0;
  last = (L + bk - 1) / bk - 1;
  if (causal) {
    last = min(last, (q0 + bq - 1) / bk);
  } else if (window > 0) {
    last = min(last, (q0 + bq - 1 + window - 1) / bk);
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
  band_tiles(q0, kBQ, kBK, L, causal, window, first, last);

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

// -- bfloat16 on the tensor cores: wgmma, a TMA ring, warp specialisation ---

constexpr int kWBQ = 128;        // q rows per block: two consumer warpgroups of 64
constexpr int kWBK = 128;        // keys per k tile
constexpr int kStages = 2;       // depth of the K/V ring
constexpr int kWThreads = 384;   // warpgroups 0-1 consume, warpgroup 2 loads
constexpr uint32_t kRow = 128;   // bytes of one swizzled tile row (64 bf16)
constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;

// Shared memory of the wgmma kernel, offsets from a 1024-byte aligned base.
template <int D>
struct FwdSmem {
  static constexpr int H2 = D / 64;                          // 64-column halves
  static constexpr uint32_t q_bytes = H2 * kWBQ * kRow;
  static constexpr uint32_t kv_bytes = H2 * kWBK * kRow;     // one K or V tile
  static constexpr uint32_t k_off = q_bytes;                  // [kStages] K tiles
  static constexpr uint32_t v_off = k_off + kStages * kv_bytes;
  static constexpr uint32_t mask_off = v_off + kStages * kv_bytes;  // [kStages][kWBK] f32
  static constexpr uint32_t flag_off = mask_off + kStages * kWBK * 4;
  static constexpr uint32_t bar_off = flag_off + 64;
  static constexpr uint32_t bytes = bar_off + 8 * (1 + 3 * kStages) + 1024;  // + alignment
};

// band_predicate for one (query, key) pair.
__device__ __forceinline__ bool in_band(int qp, int kp, int causal, int window) {
  if (causal && kp > qp) return false;
  if (window > 0) {
    if (qp - kp >= window) return false;
    if (!causal && kp - qp >= window) return false;
  }
  return true;
}

template <int D>
__global__ void __launch_bounds__(kWThreads, 1)
fa_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const float* __restrict__ key_mask,
                    __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int L, int H,
                    int Hkv, float scale_log2, int causal, int window) {
  using S = FwdSmem<D>;
  constexpr int H2 = S::H2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Qs = base;
  float* maskS = reinterpret_cast<float*>(base + S::mask_off);
  int* flagS = reinterpret_cast<int*>(base + S::flag_off);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(base + S::bar_off);
  uint64_t* k_full = q_full + 1;          // K tile landed, key mask tile written
  uint64_t* v_full = k_full + kStages;    // V tile landed
  uint64_t* empty = v_full + kStages;     // both consumer warpgroups are done with the stage

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // One block per (b*h, q tile), the tiles of one head consecutive so that
  // they run together and read its K/V from L2; longest causal bands first.
  const int nqt = (L + kWBQ - 1) / kWBQ;
  const int bh = (int)blockIdx.x / nqt, b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);  // _kv_row: GQA head map
  const int q0 = (nqt - 1 - (int)blockIdx.x % nqt) * kWBQ;
  int first, last;
  band_tiles(q0, kWBQ, kWBK, L, causal, window, first, last);
  const int ntiles = last - first + 1;  // walked from `last` down

  if (tid == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
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
        hopper::mbar_arrive_expect_tx(q_full, S::q_bytes);
        for (int c = 0; c < H2; ++c)
          hopper::tma_load_4d(Qs + c * kWBQ * kRow, &tq, q_full, 64 * c, h, q0, b);
      }
      const float* km = key_mask != nullptr ? key_mask + (size_t)b * L : nullptr;
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % kStages, k0 = (last - i) * kWBK;
        if (i >= kStages) hopper::mbar_wait(&empty[s], (i / kStages - 1) & 1);
        // the tile's key validity (mask and sequence end), read once, and
        // whether all of it (1) or none of it (-1: a padded tail, skipped
        // without loading) is valid
        bool all = true, any = false;
        for (int c = lane; c < kWBK; c += 32) {
          const int kp = k0 + c;
          const float mv = (kp < L && (km == nullptr || km[kp] > 0.5f)) ? 1.f : 0.f;
          maskS[s * kWBK + c] = mv;
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
            hopper::tma_load_4d(Ks + c * kWBK * kRow, &tk, &k_full[s], 64 * c, hk, k0, b);
          hopper::mbar_arrive_expect_tx(&v_full[s], S::kv_bytes);
          for (int c = 0; c < H2; ++c)
            hopper::tma_load_4d(Vs + c * kWBK * kRow, &tv, &v_full[s], 64 * c, hk, k0, b);
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
    float o[H2][32];
#pragma unroll
    for (int c = 0; c < H2; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) o[c][e] = 0.f;
    // running max in the log2 domain (scale * log2(e) folded in) and the
    // thread's partial row sums
    float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
    hopper::mbar_wait(q_full, 0);

    for (int i = 0; i < ntiles; ++i) {
      const int s = i % kStages, k0 = (last - i) * kWBK;
      const uint32_t parity = (i / kStages) & 1;
      const uint8_t* Ks = base + S::k_off + s * S::kv_bytes;
      const uint8_t* Vs = base + S::v_off + s * S::kv_bytes;
      hopper::mbar_wait(&k_full[s], parity);
      const int flag = flagS[s];
      if (flag < 0) {  // no valid key: p = 0 throughout
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&empty[s]);
        continue;
      }

      // S = Q K^T: 64 rows x 128 keys, Q and K both K-major in shared memory
      float sc[64];
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk / 4, off = (kk % 4) * 32;
        hopper::wgmma_ss_m64n128(sc, hopper::sw128_desc(Qw + c * kWBQ * kRow + off),
                                 hopper::sw128_desc(Ks + c * kWBK * kRow + off), kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);

      // Only an edge tile evaluates the predicate per entry: one that holds
      // the sequence end or a masked key, or crosses the diagonal or a
      // window edge for this warp's rows. Invalid entries become -inf.
      const bool interior =
          flag > 0 && (!causal || k0 + kWBK - 1 <= wr0) &&
          (window <= 0 || (wr0 + 15 - k0 < window && (causal || k0 + kWBK - 1 - wr0 < window)));
      if (!interior) {
        const float* mk = maskS + s * kWBK;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * j + 2 * t + e, kp = k0 + c;
            const bool mv = mk[c] > 0.f;
            if (!(mv && in_band(row_a, kp, causal, window))) sc[4 * j + e] = -INFINITY;
            if (!(mv && in_band(row_b, kp, causal, window))) sc[4 * j + 2 + e] = -INFINITY;
          }
        }
      }

      // online softmax: one FFMA and one ex2 per entry
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        mx_a = fmaxf(mx_a, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx_b = fmaxf(mx_b, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
      const float mn_a = fmaxf(m_a, quad_max(mx_a) * scale_log2);
      const float mn_b = fmaxf(m_b, quad_max(mx_b) * scale_log2);
      const float mu_a = mn_a == -INFINITY ? 0.f : mn_a;  // a row with nothing valid yet
      const float mu_b = mn_b == -INFINITY ? 0.f : mn_b;
      const float c_a = hopper::exp2_approx(m_a - mu_a), c_b = hopper::exp2_approx(m_b - mu_b);
      m_a = mn_a;
      m_b = mn_b;
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[4 * j + e] = hopper::exp2_approx(fmaf(sc[4 * j + e], scale_log2, -mu_a));
          sc[4 * j + 2 + e] = hopper::exp2_approx(fmaf(sc[4 * j + 2 + e], scale_log2, -mu_b));
          sum_a += sc[4 * j + e];
          sum_b += sc[4 * j + 2 + e];
        }
      }
      l_a = l_a * c_a + sum_a;
      l_b = l_b * c_b + sum_b;
#pragma unroll
      for (int c = 0; c < H2; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[c][4 * j] *= c_a;
          o[c][4 * j + 1] *= c_a;
          o[c][4 * j + 2] *= c_b;
          o[c][4 * j + 3] *= c_b;
        }

      // O += P V: P packed to bf16 from the S registers, which already hold
      // the register-A layout; V read MN-major (no transposed copy)
      uint32_t pa[kWBK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kWBK / 16; ++kk) {
        pa[kk][0] = hopper::pack_bf16x2(sc[8 * kk], sc[8 * kk + 1]);
        pa[kk][1] = hopper::pack_bf16x2(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = hopper::pack_bf16x2(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = hopper::pack_bf16x2(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
      hopper::mbar_wait(&v_full[s], parity);
#pragma unroll
      for (int c = 0; c < H2; ++c) hopper::fence_regs(o[c]);
      hopper::fence_regs(pa);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWBK / 16; ++kk)
#pragma unroll
        for (int c = 0; c < H2; ++c)
          hopper::wgmma_rs_m64n64_tb(o[c], pa[kk],
                                     hopper::sw128_desc(Vs + c * kWBK * kRow + kk * 2048));
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < H2; ++c) hopper::fence_regs(o[c]);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
    }

    l_a = quad_sum(l_a);
    l_b = quad_sum(l_b);
    const float f_a = 1.f / fmaxf(l_a, 1e-30f), f_b = 1.f / fmaxf(l_b, 1e-30f);
    const size_t qs = (size_t)H * D;
    __nv_bfloat16* orow_a = out + (size_t)b * L * qs + (size_t)row_a * qs + (size_t)h * D;
    __nv_bfloat16* orow_b = orow_a + 8 * qs;
#pragma unroll
    for (int c = 0; c < H2; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = 64 * c + 8 * j + 2 * t;
        if (row_a < L)
          *reinterpret_cast<__nv_bfloat162*>(orow_a + d) =
              __floats2bfloat162_rn(o[c][4 * j] * f_a, o[c][4 * j + 1] * f_a);
        if (row_b < L)
          *reinterpret_cast<__nv_bfloat162*>(orow_b + d) =
              __floats2bfloat162_rn(o[c][4 * j + 2] * f_b, o[c][4 * j + 3] * f_b);
      }
    // natural-log lse (K3 and K4 read it); a fully masked row has l = 0 and
    // the plain version's -1e9 + log(1e-30)
    if (t == 0) {
      const float dead = kNeg + logf(1e-30f);
      if (row_a < L) lse[(size_t)bh * L + row_a] = l_a > 0.f ? (m_a + log2f(l_a)) * kLn2 : dead;
      if (row_b < L) lse[(size_t)bh * L + row_b] = l_b > 0.f ? (m_b + log2f(l_b)) * kLn2 : dead;
    }
  }
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, const void* key_mask, void* out,
                 void* lse, int B, int L, int H, int Hkv, float scale, int causal, int window,
                 cudaStream_t s) {
  static bool configured = false;  // raise the dynamic shared-memory cap once
  constexpr uint32_t bytes = FwdSmem<D>::bytes;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(fa_fwd_wgmma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  CUtensorMap tq, tk, tv;
  if (!hopper::bf16_rows_map(&tq, q, B, L, H, D, kWBQ) ||
      !hopper::bf16_rows_map(&tk, k, B, L, Hkv, D, kWBK) ||
      !hopper::bf16_rows_map(&tv, v, B, L, Hkv, D, kWBK))
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)(B * H) * (unsigned)((L + kWBQ - 1) / kWBQ);
  fa_fwd_wgmma_kernel<D><<<blocks, kWThreads, bytes, s>>>(
      tq, tk, tv, static_cast<const float*>(key_mask), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), L, H, Hkv, scale * kLog2e, causal, window);
  return (int)cudaGetLastError();
}

// -- bfloat16 at D = 16 and 32: wgmma at the row width's swizzle, persistent --

constexpr int kSQ = 128;           // q rows an item: two warpgroups of 64
constexpr int kSK = 128;           // keys a k tile
constexpr int kSThreads = 256;     // both warpgroups compute; warp 0 also loads
constexpr int kSBlocksPerSM = 2;   // caps registers at 128 a thread

// Shared memory of the small-D kernel, offsets from a 1024-byte aligned base.
template <int D>
struct SmallFwdSmem {
  static constexpr uint32_t row = 2 * D;                   // bytes of a tile row
  static constexpr uint32_t q_bytes = kSQ * row;           // one Q tile
  static constexpr uint32_t kv_bytes = kSK * row;          // one K or V tile
  static constexpr uint32_t k_off = 2 * q_bytes;           // Q double-buffered by item
  static constexpr uint32_t v_off = k_off + kStages * kv_bytes;
  static constexpr uint32_t mask_off = v_off + kStages * kv_bytes;  // [kStages][kSK] f32
  static constexpr uint32_t flag_off = mask_off + kStages * kSK * 4;
  static constexpr uint32_t prod_off = flag_off + 16;      // the producer's walk
  static constexpr uint32_t bar_off = flag_off + 64;
  static constexpr uint32_t bytes = bar_off + 8 * (4 + 3 * kStages) + 1024;  // + alignment
};

// One work item of the persistent grid: a (b*h, 128-row q tile) pair and its
// k tiles. Items run q tile by q tile from the last, so under causal masking
// the longest bands start first; the heads of one q tile are consecutive.
struct SmallItem {
  int bh, q0, first, last;
};

// Where warp 0's walk over the block's (item, k tile) stream stands: the
// item (local index), its tile, the element, whether there is one, the item.
struct SmallProducer {
  int m, i, n, more;
  SmallItem it;
};

// The block's m-th item of the persistent grid, in snake order: even
// rounds hand out items by block, odd rounds in reverse, so each block's
// long and short causal items pair up. Round-robin would leave the
// slowest block 21% above the mean at L=2048 (16 q tiles), snake 3%: a
// count of tiles, not a timing.
__device__ __forceinline__ int small_item_index(int m) {
  const int G = (int)gridDim.x, b = (int)blockIdx.x;
  return m * G + ((m & 1) ? G - 1 - b : b);
}

__device__ __forceinline__ SmallItem small_item(int j, int BH, int nqt, int L, int causal,
                                                int window) {
  SmallItem it;
  it.bh = j % BH;
  it.q0 = (nqt - 1 - j / BH) * kSQ;
  band_tiles(it.q0, kSQ, kSK, L, causal, window, it.first, it.last);
  return it;
}

template <int D>
__global__ void __launch_bounds__(kSThreads, kSBlocksPerSM)
fa_fwd_small_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const float* __restrict__ key_mask,
                    __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int B, int L, int H,
                    int Hkv, float scale_log2, int causal, int window) {
  using S = SmallFwdSmem<D>;
  constexpr int R = S::row;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  float* maskS = reinterpret_cast<float*>(base + S::mask_off);
  int* flagS = reinterpret_cast<int*>(base + S::flag_off);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(base + S::bar_off);  // [2] the item's Q landed
  uint64_t* q_empty = q_full + 2;        // [2] every warp is done with the item's Q
  uint64_t* k_full = q_empty + 2;        // K tile landed, key mask tile written
  uint64_t* v_full = k_full + kStages;   // V tile landed
  uint64_t* empty = v_full + kStages;    // every warp is done with the stage

  // The loads: warp 0 walks the block's stream of (item, k tile) elements
  // two elements ahead of the consumers (all eight warps, itself included),
  // so the next item's Q, K and V are in flight during this item's last
  // tile and epilogue. Each element's key validity (mask and sequence end)
  // is read once; a tile with no valid key is not loaded. The walk's state
  // lives in shared memory: in registers every thread would carry it.
  SmallProducer* ps = reinterpret_cast<SmallProducer*>(base + S::prod_off);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int BH = B * H, nqt = (L + kSQ - 1) / kSQ, nitems = BH * nqt, group = H / Hkv;

  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      hopper::mbar_init(&q_full[i], 1);
      hopper::mbar_init(&q_empty[i], 8);
    }
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&k_full[s], 32);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&empty[s], 8);
    }
    hopper::fence_barrier_init();
    *ps = SmallProducer{0, 0, 0, (int)blockIdx.x < nitems,
                        small_item(blockIdx.x, BH, nqt, L, causal, window)};
  }
  __syncthreads();
  auto produce = [&]() {
    const SmallProducer st = *ps;
    const int s = st.n % kStages, b = st.it.bh / H, h = st.it.bh % H;
    if (st.n >= kStages) hopper::mbar_wait(&empty[s], (st.n / kStages - 1) & 1);
    if (st.i == 0) {  // the item's first tile brings its Q
      const int qb = st.m & 1;
      if (st.m >= 2) hopper::mbar_wait(&q_empty[qb], ((st.m >> 1) - 1) & 1);
      if (lane == 0) {
        hopper::mbar_arrive_expect_tx(&q_full[qb], S::q_bytes);
        hopper::tma_load_4d(base + qb * S::q_bytes, &tq, &q_full[qb], 0, h, st.it.q0, b);
      }
    }
    const int k0 = (st.it.last - st.i) * kSK;
    const float* km = key_mask != nullptr ? key_mask + (size_t)b * L : nullptr;
    bool all = true, any = false;
    for (int c = lane; c < kSK; c += 32) {
      const int kp = k0 + c;
      const float mv = (kp < L && (km == nullptr || km[kp] > 0.5f)) ? 1.f : 0.f;
      maskS[s * kSK + c] = mv;
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
      const int hk = h / group;
      hopper::mbar_arrive_expect_tx(&k_full[s], S::kv_bytes);
      hopper::tma_load_4d(base + S::k_off + s * S::kv_bytes, &tk, &k_full[s], 0, hk, k0, b);
      hopper::mbar_arrive_expect_tx(&v_full[s], S::kv_bytes);
      hopper::tma_load_4d(base + S::v_off + s * S::kv_bytes, &tv, &v_full[s], 0, hk, k0, b);
    } else {
      hopper::mbar_arrive(&k_full[s]);
    }
    SmallProducer nx = st;
    ++nx.n;
    if (++nx.i > st.it.last - st.it.first) {
      nx.i = 0;
      const int j = small_item_index(++nx.m);
      nx.more = j < nitems;
      if (nx.more) nx.it = small_item(j, BH, nqt, L, causal, window);
    }
    __syncwarp();
    if (lane == 0) *ps = nx;
    __syncwarp();
  };
  if (warp == 0)
    for (int e = 0; e < kStages && ps->more; ++e) produce();

  const int wg = warp / 4, g = lane / 4, t = lane % 4;
  int n = 0;  // the consumers' stream element
  for (int m = 0;; ++m) {
    const int j = small_item_index(m);
    if (j >= nitems) break;
    const SmallItem it = small_item(j, BH, nqt, L, causal, window);
    const int qb = m & 1, ntiles = it.last - it.first + 1;
    const uint8_t* Qw = base + qb * S::q_bytes + 64 * wg * R;
    const int wr0 = it.q0 + 64 * wg + 16 * (warp % 4);  // this warp's first row
    const int row_a = wr0 + g, row_b = row_a + 8;        // the thread's two rows
    float o[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) o[e] = 0.f;
    // running max in the log2 domain (scale * log2(e) folded in) and the
    // thread's partial row sums
    float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
    hopper::mbar_wait(&q_full[qb], (m >> 1) & 1);

    for (int i = 0; i < ntiles; ++i, ++n) {
      const int s = n % kStages, k0 = (it.last - i) * kSK;
      const uint32_t parity = (n / kStages) & 1;
      const uint8_t* Ks = base + S::k_off + s * S::kv_bytes;
      const uint8_t* Vs = base + S::v_off + s * S::kv_bytes;
      hopper::mbar_wait(&k_full[s], parity);
      const int flag = flagS[s];
      if (flag < 0) {  // no valid key: p = 0 throughout
        if (i == ntiles - 1) {
          __syncwarp();
          if (lane == 0) hopper::mbar_arrive(&q_empty[qb]);
        }
      } else {
        // S = Q K^T: 64 rows x 128 keys, Q and K K-major (one k16 step at
        // D = 16, two at 32: +32 bytes inside the swizzled row)
        float sc[kSK / 2];
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hopper::wgmma_ss_m64n128(sc, hopper::sw_desc<R>(Qw + 32 * kk),
                                   hopper::sw_desc<R>(Ks + 32 * kk), kk > 0);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(sc);
        if (i == ntiles - 1) {  // the item's Q is read for the last time
          __syncwarp();
          if (lane == 0) hopper::mbar_arrive(&q_empty[qb]);
        }

        // Only an edge tile evaluates the predicate per entry: one that
        // holds the sequence end or a masked key, or crosses the diagonal
        // or a window edge for this warp's rows. Invalid entries get -inf.
        const bool interior =
            flag > 0 && (!causal || k0 + kSK - 1 <= wr0) &&
            (window <= 0 || (wr0 + 15 - k0 < window && (causal || k0 + kSK - 1 - wr0 < window)));
        if (!interior) {
          // the band as a range of the tile's columns a row sees, lo..hi
          // (band_predicate), and the key mask only where the tile has a
          // masked key or the sequence end
          const int big = 1 << 30, d_a = row_a - k0, d_b = row_b - k0;
          const int hi_a = causal ? d_a : (window > 0 ? d_a + window - 1 : big);
          const int hi_b = causal ? d_b : (window > 0 ? d_b + window - 1 : big);
          const int lo_a = window > 0 ? d_a - window + 1 : -big;
          const int lo_b = window > 0 ? d_b - window + 1 : -big;
          const float* mk = maskS + s * kSK;
#pragma unroll
          for (int jj = 0; jj < kSK / 8; ++jj) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = 8 * jj + 2 * t + e;
              const bool mv = flag > 0 || mk[c] > 0.f;
              if (!(mv && c >= lo_a && c <= hi_a)) sc[4 * jj + e] = -INFINITY;
              if (!(mv && c >= lo_b && c <= hi_b)) sc[4 * jj + 2 + e] = -INFINITY;
            }
          }
        }

        // online softmax: one FFMA and one ex2 per entry
        float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
        for (int jj = 0; jj < kSK / 8; ++jj) {
          mx_a = fmaxf(mx_a, fmaxf(sc[4 * jj], sc[4 * jj + 1]));
          mx_b = fmaxf(mx_b, fmaxf(sc[4 * jj + 2], sc[4 * jj + 3]));
        }
        const float mn_a = fmaxf(m_a, quad_max(mx_a) * scale_log2);
        const float mn_b = fmaxf(m_b, quad_max(mx_b) * scale_log2);
        const float mu_a = mn_a == -INFINITY ? 0.f : mn_a;  // a row with nothing valid yet
        const float mu_b = mn_b == -INFINITY ? 0.f : mn_b;
        const float c_a = hopper::exp2_approx(m_a - mu_a), c_b = hopper::exp2_approx(m_b - mu_b);
        m_a = mn_a;
        m_b = mn_b;
        float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
        for (int jj = 0; jj < kSK / 8; ++jj) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            sc[4 * jj + e] = hopper::exp2_approx(fmaf(sc[4 * jj + e], scale_log2, -mu_a));
            sc[4 * jj + 2 + e] = hopper::exp2_approx(fmaf(sc[4 * jj + 2 + e], scale_log2, -mu_b));
            sum_a += sc[4 * jj + e];
            sum_b += sc[4 * jj + 2 + e];
          }
        }
        l_a = l_a * c_a + sum_a;
        l_b = l_b * c_b + sum_b;
#pragma unroll
        for (int jj = 0; jj < D / 8; ++jj) {
          o[4 * jj] *= c_a;
          o[4 * jj + 1] *= c_a;
          o[4 * jj + 2] *= c_b;
          o[4 * jj + 3] *= c_b;
        }

        // O += P V: P packed to bf16 from the S registers (the register-A
        // layout); V read MN-major through the transpose flag, one swizzle
        // atom wide (N = D), 16 keys a k16 step
        uint32_t pa[kSK / 16][4];
#pragma unroll
        for (int kk = 0; kk < kSK / 16; ++kk) {
          pa[kk][0] = hopper::pack_bf16x2(sc[8 * kk], sc[8 * kk + 1]);
          pa[kk][1] = hopper::pack_bf16x2(sc[8 * kk + 2], sc[8 * kk + 3]);
          pa[kk][2] = hopper::pack_bf16x2(sc[8 * kk + 4], sc[8 * kk + 5]);
          pa[kk][3] = hopper::pack_bf16x2(sc[8 * kk + 6], sc[8 * kk + 7]);
        }
        hopper::mbar_wait(&v_full[s], parity);
        hopper::fence_regs(o);
        hopper::fence_regs(pa);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kSK / 16; ++kk)
          hopper::wgmma_rs_tb(o, pa[kk], hopper::sw_desc<R>(Vs + kk * 16 * R));
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(o);
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
      if (warp == 0 && ps->more) produce();
    }

    l_a = quad_sum(l_a);
    l_b = quad_sum(l_b);
    const float f_a = 1.f / fmaxf(l_a, 1e-30f), f_b = 1.f / fmaxf(l_b, 1e-30f);
    const int b = it.bh / H, h = it.bh % H;
    const size_t qs = (size_t)H * D;
    __nv_bfloat16* orow_a = out + (size_t)b * L * qs + (size_t)row_a * qs + (size_t)h * D;
    __nv_bfloat16* orow_b = orow_a + 8 * qs;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      const int d = 8 * jj + 2 * t;
      if (row_a < L)
        *reinterpret_cast<__nv_bfloat162*>(orow_a + d) =
            __floats2bfloat162_rn(o[4 * jj] * f_a, o[4 * jj + 1] * f_a);
      if (row_b < L)
        *reinterpret_cast<__nv_bfloat162*>(orow_b + d) =
            __floats2bfloat162_rn(o[4 * jj + 2] * f_b, o[4 * jj + 3] * f_b);
    }
    // natural-log lse; a fully masked row has l = 0 and the plain version's
    // -1e9 + log(1e-30)
    if (t == 0) {
      const float dead = kNeg + logf(1e-30f);
      if (row_a < L) lse[(size_t)it.bh * L + row_a] = l_a > 0.f ? (m_a + log2f(l_a)) * kLn2 : dead;
      if (row_b < L) lse[(size_t)it.bh * L + row_b] = l_b > 0.f ? (m_b + log2f(l_b)) * kLn2 : dead;
    }
  }
}

// Raise the small kernel's shared-memory cap and read how many blocks stay
// resident on an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), once.
template <int D>
int small_resident(int* per_sm, int* sms) {
  static int blocks = 0, count = 0;
  if (blocks == 0) {
    cudaError_t e = cudaFuncSetAttribute(fa_fwd_small_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)SmallFwdSmem<D>::bytes);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fa_fwd_small_kernel<D>, kSThreads,
                                                      SmallFwdSmem<D>::bytes);
    if (e != cudaSuccess) return (int)e;
    int dev = 0;
    e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    if (blocks < 1) return (int)cudaErrorInvalidConfiguration;
  }
  *per_sm = blocks;
  *sms = count;
  return 0;
}

template <int D>
int launch_small(const void* q, const void* k, const void* v, const void* key_mask, void* out,
                 void* lse, int B, int L, int H, int Hkv, float scale, int causal, int window,
                 cudaStream_t s) {
  int per_sm = 0, sms = 0;
  const int err = small_resident<D>(&per_sm, &sms);
  if (err != 0) return err;
  CUtensorMap tq, tk, tv;
  if (!hopper::bf16_head_map(&tq, q, B, L, H, D, kSQ) ||
      !hopper::bf16_head_map(&tk, k, B, L, Hkv, D, kSK) ||
      !hopper::bf16_head_map(&tv, v, B, L, Hkv, D, kSK))
    return (int)cudaErrorInvalidValue;
  // persistent: as many blocks as stay resident, or one an item
  const long long items = (long long)B * H * ((L + kSQ - 1) / kSQ);
  const unsigned blocks = (unsigned)(items < (long long)per_sm * sms ? items : per_sm * sms);
  fa_fwd_small_kernel<D><<<blocks, kSThreads, SmallFwdSmem<D>::bytes, s>>>(
      tq, tk, tv, static_cast<const float*>(key_mask), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), B, L, H, Hkv, scale * kLog2e, causal, window);
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
      return launch_wgmma<128>(q, k, v, key_mask, out, lse, B, L, H, Hkv, scale, causal,
                               window, s);
    if (D == 64)
      return launch_wgmma<64>(q, k, v, key_mask, out, lse, B, L, H, Hkv, scale, causal, window,
                              s);
  }
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, key_mask, out, lse, B, L, H, Hkv, D, scale, causal,
                                 window, s);
  return (int)cudaErrorInvalidValue;
}

// The small-D kernel (fa_fwd_small_kernel): bfloat16, D = 16 or 32, 16-byte
// aligned q/k/v. Anything else is refused (the caller routes it elsewhere).
extern "C" int dk_flash_attention_fwd_small(const void* q, const void* k, const void* v,
                                            const void* key_mask, void* out, void* lse, int B,
                                            int L, int H, int Hkv, int D, float scale,
                                            int causal, int window, void* stream) {
  if (B < 1 || L < 1 || H < 1 || Hkv < 1 || H % Hkv != 0 || (D != 16 && D != 32) ||
      !aligned16(q) || !aligned16(k) || !aligned16(v))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 16
             ? launch_small<16>(q, k, v, key_mask, out, lse, B, L, H, Hkv, scale, causal, window, s)
             : launch_small<32>(q, k, v, key_mask, out, lse, B, L, H, Hkv, scale, causal, window,
                                s);
}

// Blocks of the small-D kernel resident on one SM, and the SM count (its
// persistent grid is their product); 0 on success.
extern "C" int dk_flash_attention_fwd_small_occupancy(int D, int* per_sm, int* sms) {
  if (D == 16) return small_resident<16>(per_sm, sms);
  if (D == 32) return small_resident<32>(per_sm, sms);
  return (int)cudaErrorInvalidValue;
}
