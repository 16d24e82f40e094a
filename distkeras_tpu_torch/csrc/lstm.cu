// The LSTM recurrence for Hopper (sm_90a): forward scan, reverse-time
// backward scan, and the recurrent-weight gradient.
//
// Replaces distkeras_tpu/ops/recurrent.py::_lstm_fwd_kernel (launched by
// _fwd) and ::_lstm_bwd_kernel (launched by _bwd). Gate math as there:
//     z_t = gx_t (f32) + h_{t-1} @ wh      (wh cast to the model type T,
//                                            products accumulated in f32)
//     i, f, g, o = sigmoid(z_i), sigmoid(z_f + 1), tanh(z_g), sigmoid(z_o)
//     c_t = f c_{t-1} + i g (f32)          h_t = T(o tanh(c_t))
// with h_0 = c_0 = 0. Every kernel takes a leading problem axis G (the
// engine's W stacked workers): gx [G, B, T, 4H], wh [G, H, 4H] f32,
// hs / cs [G, B, T, H], all batch-major (the model's own layout, so no
// transposes), row-major and contiguous.
//
// What bounds it on an H100: neither bytes nor operations but the T
// dependent steps. At the IMDB config (T=200, B=64, H=128, G=8, bf16) the
// forward moves ~157 MB (~47 us at HBM rate) and does 13.4 GFLOP (~14 us
// on the tensor cores), while 200 steps each wait for the last one.
// In bf16 at H 32, 64 and 128 the forward runs lstm_fwd_cluster_kernel:
// each group of batch rows spread over a thread-block cluster, h exchanged
// through distributed shared memory every step (see its note); at the IMDB
// shape ~0.41 ms against the per-block scan's ~1.49 (PERF.md, lstm_probe.py
// for the parts of a step). The per-block scans, forward and backward:
//  * rows of the batch are independent recurrences, so blocks split
//    (G, B / 16) and never synchronise with one another: no grid barrier;
//  * each block stages its worker's wh once, in T, in shared memory
//    (bf16 at H = 128 is 128 KiB, above the 48 KiB default: the launcher
//    opts in with cudaFuncAttributeMaxDynamicSharedMemorySize), and keeps
//    h (T, double-buffered) and c (f32) in shared memory across all steps;
//  * per step the 16 rows' h @ wh runs on the tensor cores (mma.sync
//    m16n8k16, bf16 in, f32 accumulate). Warp w owns 16-wide slabs of the
//    hidden units and computes all four gates' columns for them, so the
//    gate math, the c update and the output store happen in registers of
//    the thread that holds the products; one __syncthreads per step
//    publishes the new h.
// Where wh in T does not fit in shared memory (float32 at H = 128 is
// 256 KiB) or T is float32 (the tensor cores would round it), the same
// kernels take their second load path: h @ wh as f32 FMAs with wh read
// through the L2 cache and rounded to T as it is read.
//
// The backward scan (lstm_bwd_kernel) runs the same split in reverse time:
// it recomputes z from the saved h_{t-1} (zero at t = 0), carries dh and
// dc in f32 in shared memory, writes dgx_t = T(dz) and forms the carried
// dh_{t-1} = T(dz) @ wh^T on the tensor cores from the same staged wh
// (its B fragments are contiguous pairs of a wh row, while the forward
// product's are pairs of a column, read as two 16-bit loads). It is
// latency-bound like the forward: read from global memory inside the step,
// h_{t-1}, gx_t, c_t, c_{t-1} and dhs_t would sit on the dependent chain.
// So the whole block copies step t-1's inputs (h_{t-2},
// gx_{t-1}, dhs_{t-1} and c_{t-2}; 29 KiB at the IMDB shape) into a second
// shared-memory buffer by cp.async at the top of step t, so they land
// while step t computes (a ring of three c tiles reads each c once: step
// t's c_t is step t+1's c_{t-1}), and dh_{t-1} is summed in four partial
// mma chains of 4H/64 steps instead of one of 4H/16. Two barriers a step,
// as before: the dz tile is published before the dh product reads all of
// it, and the end of the step publishes the landed inputs and frees dz (a
// second dz tile to drop one barrier does not fit beside wh at H = 128).
// Shapes whose staged buffers do not fit in shared memory, or whose
// sequences are not 16-byte aligned, run lstm_bwd_direct_kernel: the same
// step with its inputs read from global memory in the step.
// The weight gradient dwh = sum_t h_{t-1}^T T(dz_t) does not belong to the
// recurrence: it is a [H, B(T-1)] x [B(T-1), 4H] product per worker over
// the saved hs and the emitted dgx, 13.4 GFLOP at the IMDB shape. In bf16
// at H a multiple of 64, lstm_dwh_wgmma_kernel runs it on the tensor
// cores (wgmma with both operands read MN-major from TMA tiles, bf16 in,
// f32 accumulate: the same products as f32 FMAs of the bf16 values);
// otherwise lstm_dwh_kernel does f32 FMAs. Both sum in a fixed order, one
// block per output tile: deterministic.
// ptxas (CUDA 12.9), no spills: the staged scans 96-124 registers, the
// direct ones 120-126, the cluster forward 74-126, lstm_dwh_wgmma_kernel 58
// (SASS: 4 HGMMA, 2 UTMALDG; chip_smoke.py's check_sass). At the IMDB shape
// on the H100 the backward scan takes ~1.6 ms and dwh ~0.08 ms (PERF.md).
// Plain C interface (bound with ctypes): each dk_lstm_* returns the
// cudaGetLastError() of its launches, 0 on success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

// Per-step probes: lstm_probe.py builds this file with -DDK_LSTM_PROBE (which
// adds the dk_lstm_probe_* entry points: a forward scan on a chosen path, and
// the counters), and each warp of the forward scans then adds the clock64()
// cycles between their STEP_MARKs to dk_lstm_probe_cycles (slot 7 counts the
// warps); -DDK_LSTM_PROBE_NOMARK keeps the entry points without the marks,
// -DDK_LSTM_PROBE_NO_GX drops lstm_fwd_kernel's in-step gx loads. The
// shipped build compiles the marks to nothing.
#ifdef DK_LSTM_PROBE
__device__ unsigned long long dk_lstm_probe_cycles[8];
#endif
#if defined(DK_LSTM_PROBE) && !defined(DK_LSTM_PROBE_NOMARK)
#define STEP_DECL long long step_t0_ = clock64(), step_acc_[7] = {0, 0, 0, 0, 0, 0, 0}
#define STEP_MARK(i)                        \
  do {                                      \
    const long long n_ = clock64();         \
    step_acc_[i] += n_ - step_t0_;          \
    step_t0_ = n_;                          \
  } while (0)
#define STEP_FLUSH()                                                                    \
  do {                                                                                  \
    if ((threadIdx.x & 31) == 0) {                                                      \
      for (int i_ = 0; i_ < 7; ++i_)                                                    \
        atomicAdd(&dk_lstm_probe_cycles[i_], (unsigned long long)step_acc_[i_]);        \
      atomicAdd(&dk_lstm_probe_cycles[7], 1ull);                                        \
    }                                                                                   \
  } while (0)
#else
#define STEP_DECL do {} while (0)
#define STEP_MARK(i) do {} while (0)
#define STEP_FLUSH() do {} while (0)
#endif
#ifdef DK_LSTM_PROBE_NO_GX
#define GX_LOAD(v) 0.f
#else
#define GX_LOAD(v) (v)
#endif

namespace {

constexpr int kRows = 16;     // batch rows per block: the mma M
constexpr int kMaxWarps = 8;  // warps per block, each on 16-wide slabs of H
constexpr int kPad = 8;       // row padding (elements) of shared-memory tiles
constexpr size_t kSmemCap = 227 * 1024;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// c += A B for one m16n8k16 tile: a0/a2 hold A row gid at k {2t, 2t+1} /
// {2t+8, 2t+9}, a1/a3 the same for row gid+8; b0/b1 B column gid at those k.
__device__ __forceinline__ void mma16816(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Shared-memory plan of one kernel: wh (tensor-core path only), then the
// h tile(s), the dz tile (backward), then the f32 carries.
struct Plan {
  int ldw, ldh, ldz;
  size_t wh, h, dz, carry, total;
};

template <typename T>
__host__ __device__ inline Plan plan(int H, bool mma, bool backward) {
  Plan p;
  p.ldw = 4 * H + kPad;
  p.ldh = H + kPad;
  p.ldz = 4 * H + kPad;
  p.wh = mma ? (size_t)H * p.ldw * sizeof(bf16) : 0;
  p.h = (size_t)(backward ? 1 : 2) * kRows * p.ldh * sizeof(T);
  p.dz = backward ? (size_t)kRows * p.ldz * sizeof(T) : 0;
  p.carry = (size_t)(backward ? 2 : 1) * kRows * H * sizeof(float);
  p.total = p.wh + p.h + p.dz + p.carry;
  return p;
}

// Stage worker g's wh [H, 4H] (f32) in shared memory as bf16, row-major.
__device__ __forceinline__ void stage_wh(bf16* wh_s, const float* __restrict__ whg, int H,
                                         int ldw) {
  const int H4 = 4 * H;
  for (int idx = threadIdx.x; idx < H * H4; idx += blockDim.x) {
    const int k = idx / H4, n = idx - k * H4;
    wh_s[k * ldw + n] = __float2bfloat16_rn(whg[idx]);
  }
}

// acc[q][nt][.] += h[16 rows, H] @ wh[:, q*H + slab*16 + nt*8 + (0..7)],
// in the mma C layout: regs 0/1 row gid at columns 2*tq + {0, 1}, regs 2/3
// row gid + 8.
template <typename T, bool kMma>
__device__ __forceinline__ void gate_products(float (&acc)[4][2][4], const T* h, int ldh,
                                              const bf16* wh_s, int ldw,
                                              const float* __restrict__ whg, int H, int slab,
                                              int gid, int tq) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[q][nt][r] = 0.f;
  if constexpr (kMma) {
    const bf16* hb = reinterpret_cast<const bf16*>(h);
    for (int kk = 0; kk < H; kk += 16) {
      const int k = kk + 2 * tq;
      const uint32_t a0 = lds32(hb + gid * ldh + k), a1 = lds32(hb + (gid + 8) * ldh + k);
      const uint32_t a2 = lds32(hb + gid * ldh + k + 8);
      const uint32_t a3 = lds32(hb + (gid + 8) * ldh + k + 8);
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const bf16* w = wh_s + k * ldw + q * H + slab * 16 + nt * 8 + gid;
          mma16816(acc[q][nt], a0, a1, a2, a3, pack2(w[0], w[ldw]),
                   pack2(w[8 * ldw], w[9 * ldw]));
        }
    }
  } else {
    const int H4 = 4 * H;
    for (int k = 0; k < H; ++k) {
      const float h0 = to_f(h[gid * ldh + k]), h1 = to_f(h[(gid + 8) * ldh + k]);
      const float* wr = whg + (size_t)k * H4 + slab * 16 + 2 * tq;
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float w = to_f(from_f<T>(__ldg(wr + q * H + nt * 8 + e)));
            acc[q][nt][e] = fmaf(h0, w, acc[q][nt][e]);
            acc[q][nt][2 + e] = fmaf(h1, w, acc[q][nt][2 + e]);
          }
    }
  }
}

template <typename T, bool kMma>
__global__ void lstm_fwd_kernel(const T* __restrict__ gx, const float* __restrict__ wh,
                                T* __restrict__ hs, T* __restrict__ cs, int B, int Tn, int H,
                                int save_c) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Plan p = plan<T>(H, kMma, false);
  bf16* wh_s = reinterpret_cast<bf16*>(smem);
  T* h_s = reinterpret_cast<T*>(smem + p.wh);
  float* c_s = reinterpret_cast<float*>(smem + p.wh + p.h);
  const int g = blockIdx.y, row0 = blockIdx.x * kRows, H4 = 4 * H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gid = lane >> 2, tq = lane & 3;
  const int nwarps = blockDim.x >> 5, slabs = H / 16;
  const float* whg = wh + (size_t)g * H * H4;
  if constexpr (kMma) stage_wh(wh_s, whg, H, p.ldw);
  for (int idx = threadIdx.x; idx < kRows * p.ldh; idx += blockDim.x) h_s[idx] = from_f<T>(0.f);
  for (int idx = threadIdx.x; idx < kRows * H; idx += blockDim.x) c_s[idx] = 0.f;
  __syncthreads();

  int buf = 0;
  STEP_DECL;
  for (int t = 0; t < Tn; ++t) {
    STEP_MARK(6);
    const T* hcur = h_s + buf * kRows * p.ldh;
    T* hnext = h_s + (buf ^ 1) * kRows * p.ldh;
    for (int slab = warp; slab < slabs; slab += nwarps) {
      float acc[4][2][4];
      gate_products<T, kMma>(acc, hcur, p.ldh, wh_s, p.ldw, whg, H, slab, gid, tq);
      STEP_MARK(1);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = gid + 8 * half, row = row0 + r, reg = 2 * half + e;
            const int j = slab * 16 + nt * 8 + 2 * tq + e;
            const bool valid = row < B;
            const size_t at = (((size_t)g * B + row) * Tn + t);
            const T* gxr = gx + at * H4;
            float z[4];
#pragma unroll
            for (int q = 0; q < 4; ++q)
              z[q] = GX_LOAD(valid ? to_f(gxr[q * H + j]) : 0.f) + acc[q][nt][reg];
            const float ig = sigmoid(z[0]), fg = sigmoid(z[1] + 1.f);
            const float gg = tanhf(z[2]), og = sigmoid(z[3]);
            const float c = fg * c_s[r * H + j] + ig * gg;
            const T h = from_f<T>(og * tanhf(c));
            c_s[r * H + j] = c;
            hnext[r * p.ldh + j] = h;
            if (valid) {
              hs[at * H + j] = h;
              if (save_c) cs[at * H + j] = from_f<T>(c);
            }
          }
      STEP_MARK(2);
    }
    __syncthreads();
    STEP_MARK(5);
    buf ^= 1;
  }
  STEP_FLUSH();
}

// -- backward -----------------------------------------------------------------

// cp.async of one 16-byte chunk; src_bytes = 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(hopper::smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, bf16 a, bf16 b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __halves2bfloat162(a, b);
}

// Rows row0 .. row0+15 of step t of a [G, B, T, n] sequence into a
// [kRows][ld] tile by cp.async (16 bytes a copy, every thread of the block);
// rows past B and steps outside [0, T) land as zeros.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, int ld, const T* __restrict__ src, int g,
                                           int row0, int B, int Tn, int t, int n) {
  constexpr int kPer = 16 / (int)sizeof(T);
  const int chunks = n / kPer;
  for (int idx = threadIdx.x; idx < kRows * chunks; idx += blockDim.x) {
    const int r = idx / chunks, c = (idx - r * chunks) * kPer, row = row0 + r;
    const bool in = row < B && t >= 0 && t < Tn;
    cp_async16(dst + r * ld + c, in ? src + (((size_t)g * B + row) * Tn + t) * n + c : src,
               in ? 16 : 0);
  }
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// -- forward scan across a thread-block cluster (bf16) ------------------------
//
// The per-block scan above runs one block per (worker, 16 rows): 32 blocks
// at the IMDB shape on 132 SMs, each walking T dependent steps alone. Here a
// cluster of C blocks shares each (worker, R rows): block r owns H/C hidden
// units and all four gates' columns for them, so the gate math stays in the
// thread that holds the products. Warp w owns 8 of those units (one n8 tile
// of each gate); its B fragments of wh (cast to bf16) for all of K stay in
// registers for the whole scan (64 at H = 128), so a step reads only h from
// shared memory (ldmatrix) and runs 4 independent mma chains of H/16. c lives
// in the registers of the thread that owns its cell. gx_t for the block's
// columns arrives by cp.async kDepth - 1 steps ahead into a ring, so no
// global load sits on the dependent chain. Each step a block writes its
// h_t slice into every block's next-h tile through distributed shared memory
// and one cluster barrier publishes it; the barrier is split into arrive
// (release) and wait (acquire) so the hs / cs stores overlap the wait.
// Products in the same k order as lstm_fwd_kernel's; same gate functions.
constexpr int kDepth = 4;  // steps of gx in flight

template <int H, int C>
struct ClusterFwd {
  static constexpr int Hc = H / C;          // hidden units per block
  static constexpr int warps = Hc / 8;      // one n8 tile of units a warp
  static constexpr int threads = 32 * warps;
  static constexpr int KT = H / 16;         // k tiles of h @ wh
  static constexpr int ldh = H + kPad;      // bf16 per row of an h tile
  static constexpr int ldg = 4 * Hc + kPad; // bf16 per row of a staged gx tile
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(hopper::smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&a)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(a[0]), "=r"(a[1])
               : "r"(hopper::smem_u32(p))
               : "memory");
}

// R batch rows a cluster: 16, or 8 where that still leaves at most two
// blocks a SM (then rows 8..15 of the mma's A tile are zeros, and each thread
// has half the cells, so half the gate math on the dependent chain).
template <int H, int C, int R>
__global__ void __launch_bounds__(ClusterFwd<H, C>::threads)
lstm_fwd_cluster_kernel(const bf16* __restrict__ gx, const float* __restrict__ wh,
                        bf16* __restrict__ hs, bf16* __restrict__ cs, int B, int Tn, int save_c) {
  using P = ClusterFwd<H, C>;
  constexpr int kHalves = R / 8;  // 8-row halves of the mma tile that hold rows
  __shared__ __align__(16) bf16 h_s[2][R][P::ldh];
  __shared__ __align__(16) bf16 gx_s[kDepth][R][P::ldg];
  const int rank = (int)hopper::cluster_rank();
  const int g = blockIdx.y, row0 = (blockIdx.x / C) * R, H4 = 4 * H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tq = lane & 3;
  const int ul = 8 * warp + 2 * tq;        // the thread's two units, local to the block
  const int u0 = rank * P::Hc + ul;        // ... and in h
  STEP_DECL;

  uint32_t bw[4][P::KT][2];  // B fragments: column rank Hc + 8 warp + gid of each gate
  {
    const float* whg = wh + (size_t)g * H * H4 + rank * P::Hc + 8 * warp + gid;
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int kk = 0; kk < P::KT; ++kk) {
        const float* w = whg + (size_t)(16 * kk + 2 * tq) * H4 + q * H;
        bw[q][kk][0] = pack2(__float2bfloat16_rn(w[0]), __float2bfloat16_rn(w[H4]));
        bw[q][kk][1] = pack2(__float2bfloat16_rn(w[8 * H4]), __float2bfloat16_rn(w[9 * H4]));
      }
  }
  for (int idx = tid; idx < R * P::ldh; idx += P::threads) (&h_s[0][0][0])[idx] = from_f<bf16>(0.f);

  // step t's gx columns of this block (gate q: q H + rank Hc ..), rows past B
  // and steps past T as zeros
  auto stage_gx = [&](int t) {
    constexpr int per_gate = P::Hc / 8, per_row = 4 * per_gate;  // 16-byte pieces
    bf16* dst = &gx_s[t % kDepth][0][0];
    for (int idx = tid; idx < R * per_row; idx += P::threads) {
      const int r = idx / per_row, p = idx % per_row, q = p / per_gate;
      const int col = q * P::Hc + (p % per_gate) * 8, row = row0 + r;
      const bool in = row < B && t < Tn;
      const bf16* src =
          gx + (((size_t)g * B + row) * Tn + t) * H4 + q * H + rank * P::Hc + (p % per_gate) * 8;
      cp_async16(dst + r * P::ldg + col, in ? src : gx, in ? 16 : 0);
    }
  };
#pragma unroll
  for (int t = 0; t < kDepth - 1; ++t) {
    stage_gx(t);
    cp_async_commit();
  }
  float c[2 * kHalves];  // cells (gid + 8 half, u0 + e) at 2 half + e
#pragma unroll
  for (int e = 0; e < 2 * kHalves; ++e) c[e] = 0.f;
  cp_async_wait<kDepth - 2>();
  hopper::cluster_sync();  // every block runs; h_{-1} = 0 and gx_0 are in place

  for (int t = 0; t < Tn; ++t) {
    STEP_MARK(6);
    stage_gx(t + kDepth - 1);  // into the slot step t - 1 read
    cp_async_commit();
    STEP_MARK(0);
    float acc[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[q][0] = acc[q][1] = acc[q][2] = acc[q][3] = 0.f;
    const bf16* hcur = &h_s[t & 1][0][0];
#pragma unroll
    for (int kk = 0; kk < P::KT; ++kk) {
      uint32_t a[4];
      if constexpr (R == 16) {
        ldmatrix_x4(a, hcur + (lane & 15) * P::ldh + 16 * kk + 8 * (lane >> 4));
      } else {
        uint32_t lo[2];
        ldmatrix_x2(lo, hcur + (lane & 7) * P::ldh + 16 * kk + 8 * ((lane >> 3) & 1));
        a[0] = lo[0];
        a[2] = lo[1];
        a[1] = a[3] = 0u;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
        mma16816(acc[q], a[0], a[1], a[2], a[3], bw[q][kk][0], bw[q][kk][1]);
    }
    STEP_MARK(1);
    const bf16* gxs = &gx_s[t % kDepth][0][0];
    uint32_t hp[kHalves], cp[kHalves];
#pragma unroll
    for (int half = 0; half < kHalves; ++half) {
      const int r = gid + 8 * half;
      float zz[4][2];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const __nv_bfloat162 v =
            *reinterpret_cast<const __nv_bfloat162*>(gxs + r * P::ldg + q * P::Hc + ul);
        zz[q][0] = to_f(v.x) + acc[q][2 * half];
        zz[q][1] = to_f(v.y) + acc[q][2 * half + 1];
      }
      bf16 hv[2], cv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float ig = sigmoid(zz[0][e]), fg = sigmoid(zz[1][e] + 1.f);
        const float gg = tanhf(zz[2][e]), og = sigmoid(zz[3][e]);
        const float cc = fg * c[2 * half + e] + ig * gg;
        c[2 * half + e] = cc;
        hv[e] = from_f<bf16>(og * tanhf(cc));
        cv[e] = from_f<bf16>(cc);
      }
      hp[half] = pack2(hv[0], hv[1]);
      cp[half] = pack2(cv[0], cv[1]);
    }
    STEP_MARK(2);
    if (t + 1 < Tn) {
      bf16* hnext = &h_s[(t + 1) & 1][0][0];
#pragma unroll
      for (int peer = 0; peer < C; ++peer)
#pragma unroll
        for (int half = 0; half < kHalves; ++half)
          hopper::st_cluster_u32(
              hopper::cluster_map(hnext + (gid + 8 * half) * P::ldh + u0, (uint32_t)peer),
              hp[half]);
    }
    cp_async_wait<kDepth - 2>();  // this thread's pieces of gx_{t+1} landed
    hopper::cluster_arrive();
    STEP_MARK(3);
#pragma unroll
    for (int half = 0; half < kHalves; ++half) {
      const int row = row0 + gid + 8 * half;
      if (row < B) {
        const size_t at = (((size_t)g * B + row) * Tn + t) * H + u0;
        *reinterpret_cast<uint32_t*>(hs + at) = hp[half];
        if (save_c) *reinterpret_cast<uint32_t*>(cs + at) = cp[half];
      }
    }
    STEP_MARK(4);
    hopper::cluster_wait();  // h_t of every block, and gx_{t+1}, in place
    STEP_MARK(5);
  }
  STEP_FLUSH();
}

template <int H, int C, int R>
int fwd_cluster(const void* gx, const void* wh, void* hs, void* cs, int G, int B, int Tn,
                int save_c, cudaStream_t s) {
  using P = ClusterFwd<H, C>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(C * ((B + R - 1) / R)), (unsigned)G);
  cfg.blockDim = dim3(P::threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, lstm_fwd_cluster_kernel<H, C, R>, static_cast<const bf16*>(gx),
      static_cast<const float*>(wh), static_cast<bf16*>(hs), static_cast<bf16*>(cs), B, Tn,
      save_c);
  return e ? (int)e : (int)cudaGetLastError();
}

// Rows a cluster takes: 8 where G ceil(B / 8) clusters of C blocks still fit
// two blocks a SM of the H100's 132, else 16.
int cluster_rows(int G, int B, int C) { return G * ((B + 7) / 8) * C <= 2 * 132 ? 8 : 16; }

template <int H, int C>
int fwd_cluster_rows(const void* gx, const void* wh, void* hs, void* cs, int G, int B, int Tn,
                     int save_c, int rows, cudaStream_t s) {
  return rows == 8 ? fwd_cluster<H, C, 8>(gx, wh, hs, cs, G, B, Tn, save_c, s)
                   : fwd_cluster<H, C, 16>(gx, wh, hs, cs, G, B, Tn, save_c, s);
}

// The cluster a bf16 forward scan of this H runs on (0: the per-block scan).
int cluster_size(int H) { return H == 128 || H == 64 ? 4 : H == 32 ? 2 : 0; }

// Shared-memory plan of the staged backward scan: wh (tensor-core path
// only), two buffers of step inputs {h_{t-1}, dhs_t, gx_t}, a ring of three
// c tiles, the dz tile, then the f32 carries dc and dh.
struct StagedPlan {
  int ldw, ldh, ldz;
  size_t tile_h, buf, buf_bytes, cs, dz, carry, total;
};

template <typename T>
__host__ __device__ inline StagedPlan staged_plan(int H, bool mma) {
  StagedPlan p;
  p.ldw = 4 * H + kPad;
  p.ldh = H + kPad;
  p.ldz = 4 * H + kPad;
  p.tile_h = (size_t)kRows * p.ldh * sizeof(T);
  const size_t tile_z = (size_t)kRows * p.ldz * sizeof(T);
  p.buf = mma ? (size_t)H * p.ldw * sizeof(bf16) : 0;
  p.buf_bytes = 2 * p.tile_h + tile_z;
  p.cs = p.buf + 2 * p.buf_bytes;
  p.dz = p.cs + 3 * p.tile_h;
  p.carry = p.dz + tile_z;
  p.total = p.carry + 2 * (size_t)kRows * H * sizeof(float);
  return p;
}

// The reverse-time scan with every step's inputs on chip before the step
// starts: at the top of step t the whole block copies step t-1's h_{t-2},
// dhs_{t-1}, gx_{t-1} and c_{t-2} into the other buffer by cp.async; the
// copies land while step t computes, and the barrier that ends step t makes
// them visible. c_t is step t+1's c_{t-1}, so the three-tile ring loads each
// c once. Two barriers a step: after the dz tile is written (the dh product
// reads all of it) and at the end (the next stage landed; dz free again).
template <typename T, bool kMma>
__global__ void lstm_bwd_kernel(const T* __restrict__ gx, const float* __restrict__ wh,
                                const T* __restrict__ hs, const T* __restrict__ cs,
                                const T* __restrict__ dhs, T* __restrict__ dgx, int B, int Tn,
                                int H) {
  extern __shared__ __align__(16) unsigned char smem[];
  const StagedPlan p = staged_plan<T>(H, kMma);
  bf16* wh_s = reinterpret_cast<bf16*>(smem);
  T* dz_s = reinterpret_cast<T*>(smem + p.dz);
  float* dc_s = reinterpret_cast<float*>(smem + p.carry);
  float* dh_s = dc_s + kRows * H;
  const int g = blockIdx.y, row0 = blockIdx.x * kRows, H4 = 4 * H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gid = lane >> 2, tq = lane & 3;
  const int nwarps = blockDim.x >> 5, slabs = H / 16;
  const float* whg = wh + (size_t)g * H * H4;
  auto buf_at = [&](int buf, int k) {  // k: 0 h_{t-1}, 1 dhs_t, 2 gx_t
    return reinterpret_cast<T*>(smem + p.buf + buf * p.buf_bytes + k * p.tile_h);
  };
  auto cs_at = [&](int t) {  // the ring slot of c_t (t >= -1)
    return reinterpret_cast<T*>(smem + p.cs + ((t + 3) % 3) * p.tile_h);
  };
  auto stage_step = [&](int t, int buf) {  // step t's inputs; zeros out of range
    stage_rows(buf_at(buf, 0), p.ldh, hs, g, row0, B, Tn, t - 1, H);
    stage_rows(buf_at(buf, 1), p.ldh, dhs, g, row0, B, Tn, t, H);
    stage_rows(buf_at(buf, 2), p.ldz, gx, g, row0, B, Tn, t, H4);
    stage_rows(cs_at(t - 1), p.ldh, cs, g, row0, B, Tn, t - 1, H);
    cp_async_commit();
  };

  stage_rows(cs_at(Tn - 1), p.ldh, cs, g, row0, B, Tn, Tn - 1, H);
  stage_step(Tn - 1, 0);
  if constexpr (kMma) stage_wh(wh_s, whg, H, p.ldw);
  for (int idx = threadIdx.x; idx < 2 * kRows * H; idx += blockDim.x) dc_s[idx] = 0.f;
  cp_async_wait_all();
  __syncthreads();

  for (int t = Tn - 1; t >= 0; --t) {
    const int buf = (Tn - 1 - t) & 1;
    if (t > 0) stage_step(t - 1, buf ^ 1);
    const T* h_s = buf_at(buf, 0);
    const T* dhs_s = buf_at(buf, 1);
    const T* gx_s = buf_at(buf, 2);
    const T* c_s = cs_at(t);
    const T* cp_s = cs_at(t - 1);
    for (int slab = warp; slab < slabs; slab += nwarps) {
      float acc[4][2][4];
      gate_products<T, kMma>(acc, h_s, p.ldh, wh_s, p.ldw, whg, H, slab, gid, tq);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = gid + 8 * half, row = row0 + r;
          const int j0 = slab * 16 + nt * 8 + 2 * tq;  // the thread's two columns
          T dq[4][2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = j0 + e;
            float z[4];
#pragma unroll
            for (int q = 0; q < 4; ++q)
              z[q] = to_f(gx_s[r * p.ldz + q * H + j]) + acc[q][nt][2 * half + e];
            const float ig = sigmoid(z[0]), fg = sigmoid(z[1] + 1.f);
            const float gg = tanhf(z[2]), og = sigmoid(z[3]);
            const float c = to_f(c_s[r * p.ldh + j]), c_prev = to_f(cp_s[r * p.ldh + j]);
            const float tc = tanhf(c);
            const float dh = to_f(dhs_s[r * p.ldh + j]) + dh_s[r * H + j];
            const float d_o = dh * tc * og * (1.f - og);
            const float dc = dh * og * (1.f - tc * tc) + dc_s[r * H + j];
            dc_s[r * H + j] = dc * fg;
            dq[0][e] = from_f<T>(dc * gg * ig * (1.f - ig));
            dq[1][e] = from_f<T>(dc * c_prev * fg * (1.f - fg));
            dq[2][e] = from_f<T>(dc * ig * (1.f - gg * gg));
            dq[3][e] = from_f<T>(d_o);
          }
          const size_t at = ((size_t)g * B + row) * Tn + t;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            store2(dz_s + r * p.ldz + q * H + j0, dq[q][0], dq[q][1]);
            if (row < B) store2(dgx + at * H4 + q * H + j0, dq[q][0], dq[q][1]);
          }
        }
    }
    __syncthreads();  // the dz tile is complete
    // dh_{t-1} = T(dz) @ wh^T for this warp's slabs, in four partial sums
    // over k (a 4H/64-deep mma chain each, not 4H/16), added in a fixed order
    for (int slab = warp; slab < slabs; slab += nwarps) {
      float acc[4][2][4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[k][nt][r] = 0.f;
      if constexpr (kMma) {
        const bf16* dzb = reinterpret_cast<const bf16*>(dz_s);
        for (int k0 = 0; k0 < H4; k0 += 64) {
#pragma unroll
          for (int part = 0; part < 4; ++part) {
            const int k = k0 + 16 * part + 2 * tq;
            const uint32_t a0 = lds32(dzb + gid * p.ldz + k);
            const uint32_t a1 = lds32(dzb + (gid + 8) * p.ldz + k);
            const uint32_t a2 = lds32(dzb + gid * p.ldz + k + 8);
            const uint32_t a3 = lds32(dzb + (gid + 8) * p.ldz + k + 8);
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
              const bf16* w = wh_s + (slab * 16 + nt * 8 + gid) * p.ldw + k;
              mma16816(acc[part][nt], a0, a1, a2, a3, lds32(w), lds32(w + 8));
            }
          }
        }
      } else {
        for (int n = 0; n < H4; ++n) {
          const float d0 = to_f(dz_s[gid * p.ldz + n]), d1 = to_f(dz_s[(gid + 8) * p.ldz + n]);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int j = slab * 16 + nt * 8 + 2 * tq + e;
              const float w = to_f(from_f<T>(__ldg(whg + (size_t)j * H4 + n)));
              acc[0][nt][e] = fmaf(d0, w, acc[0][nt][e]);
              acc[0][nt][2 + e] = fmaf(d1, w, acc[0][nt][2 + e]);
            }
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int reg = 2 * half + e;
            dh_s[(gid + 8 * half) * H + slab * 16 + nt * 8 + 2 * tq + e] =
                (acc[0][nt][reg] + acc[1][nt][reg]) + (acc[2][nt][reg] + acc[3][nt][reg]);
          }
    }
    cp_async_wait_all();
    __syncthreads();  // step t-1's inputs landed for every thread; dz free
  }
}

// The scan with step inputs read from global memory in the step, for the
// shapes whose staged plan does not fit in shared memory or whose sequences
// are not 16-byte aligned.
template <typename T, bool kMma>
__global__ void lstm_bwd_direct_kernel(const T* __restrict__ gx, const float* __restrict__ wh,
                                       const T* __restrict__ hs, const T* __restrict__ cs,
                                       const T* __restrict__ dhs, T* __restrict__ dgx, int B,
                                       int Tn, int H) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Plan p = plan<T>(H, kMma, true);
  bf16* wh_s = reinterpret_cast<bf16*>(smem);
  T* h_s = reinterpret_cast<T*>(smem + p.wh);
  T* dz_s = reinterpret_cast<T*>(smem + p.wh + p.h);
  float* dc_s = reinterpret_cast<float*>(smem + p.wh + p.h + p.dz);
  float* dh_s = dc_s + kRows * H;
  const int g = blockIdx.y, row0 = blockIdx.x * kRows, H4 = 4 * H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gid = lane >> 2, tq = lane & 3;
  const int nwarps = blockDim.x >> 5, slabs = H / 16;
  const float* whg = wh + (size_t)g * H * H4;
  if constexpr (kMma) stage_wh(wh_s, whg, H, p.ldw);
  for (int idx = threadIdx.x; idx < 2 * kRows * H; idx += blockDim.x) dc_s[idx] = 0.f;

  for (int t = Tn - 1; t >= 0; --t) {
    // h_{t-1} of the block's rows; zero at t = 0 and for rows past B
    for (int idx = threadIdx.x; idx < kRows * H; idx += blockDim.x) {
      const int r = idx / H, k = idx - r * H, row = row0 + r;
      h_s[r * p.ldh + k] = (row < B && t > 0)
                               ? hs[(((size_t)g * B + row) * Tn + t - 1) * H + k]
                               : from_f<T>(0.f);
    }
    __syncthreads();
    for (int slab = warp; slab < slabs; slab += nwarps) {
      float acc[4][2][4];
      gate_products<T, kMma>(acc, h_s, p.ldh, wh_s, p.ldw, whg, H, slab, gid, tq);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = gid + 8 * half, row = row0 + r, reg = 2 * half + e;
            const int j = slab * 16 + nt * 8 + 2 * tq + e;
            const bool valid = row < B;
            const size_t at = (((size_t)g * B + row) * Tn + t);
            float z[4];
#pragma unroll
            for (int q = 0; q < 4; ++q)
              z[q] = (valid ? to_f(gx[at * H4 + q * H + j]) : 0.f) + acc[q][nt][reg];
            const float ig = sigmoid(z[0]), fg = sigmoid(z[1] + 1.f);
            const float gg = tanhf(z[2]), og = sigmoid(z[3]);
            const float c = valid ? to_f(cs[at * H + j]) : 0.f;
            const float c_prev = (valid && t > 0) ? to_f(cs[(at - 1) * H + j]) : 0.f;
            const float tc = tanhf(c);
            const float dh = (valid ? to_f(dhs[at * H + j]) : 0.f) + dh_s[r * H + j];
            const float d_o = dh * tc * og * (1.f - og);
            const float dc = dh * og * (1.f - tc * tc) + dc_s[r * H + j];
            const float d_i = dc * gg * ig * (1.f - ig);
            const float d_f = dc * c_prev * fg * (1.f - fg);
            const float d_g = dc * ig * (1.f - gg * gg);
            dc_s[r * H + j] = dc * fg;
            const T dq[4] = {from_f<T>(d_i), from_f<T>(d_f), from_f<T>(d_g), from_f<T>(d_o)};
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              dz_s[r * p.ldz + q * H + j] = dq[q];
              if (valid) dgx[at * H4 + q * H + j] = dq[q];
            }
          }
    }
    __syncthreads();
    // dh_{t-1} = T(dz) @ wh^T for this warp's slabs, same C layout as above
    for (int slab = warp; slab < slabs; slab += nwarps) {
      float acc[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[nt][r] = 0.f;
      if constexpr (kMma) {
        const bf16* dzb = reinterpret_cast<const bf16*>(dz_s);
        for (int kk = 0; kk < H4; kk += 16) {
          const int k = kk + 2 * tq;
          const uint32_t a0 = lds32(dzb + gid * p.ldz + k);
          const uint32_t a1 = lds32(dzb + (gid + 8) * p.ldz + k);
          const uint32_t a2 = lds32(dzb + gid * p.ldz + k + 8);
          const uint32_t a3 = lds32(dzb + (gid + 8) * p.ldz + k + 8);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const bf16* w = wh_s + (slab * 16 + nt * 8 + gid) * p.ldw + k;
            mma16816(acc[nt], a0, a1, a2, a3, lds32(w), lds32(w + 8));
          }
        }
      } else {
        for (int n = 0; n < H4; ++n) {
          const float d0 = to_f(dz_s[gid * p.ldz + n]), d1 = to_f(dz_s[(gid + 8) * p.ldz + n]);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int j = slab * 16 + nt * 8 + 2 * tq + e;
              const float w = to_f(from_f<T>(__ldg(whg + (size_t)j * H4 + n)));
              acc[nt][e] = fmaf(d0, w, acc[nt][e]);
              acc[nt][2 + e] = fmaf(d1, w, acc[nt][2 + e]);
            }
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            dh_s[(gid + 8 * half) * H + slab * 16 + nt * 8 + 2 * tq + e] = acc[nt][2 * half + e];
    }
  }
}

// dwh[g][i][n] = sum over b and t >= 1 of hs[g,b,t-1,i] * dgx[g,b,t,n]:
// 64 x 64 output tiles, 4 x 4 per thread, K = B (T-1) in chunks of 16.
constexpr int kDwTile = 64, kDwK = 16;

template <typename T>
__global__ void __launch_bounds__(256)
lstm_dwh_kernel(const T* __restrict__ hs, const T* __restrict__ dgx, float* __restrict__ dwh,
                int B, int Tn, int H) {
  __shared__ float a_s[kDwK][kDwTile];
  __shared__ float b_s[kDwK][kDwTile];
  const int g = blockIdx.z, i0 = blockIdx.y * kDwTile, n0 = blockIdx.x * kDwTile;
  const int H4 = 4 * H, tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long long K = (long long)B * (Tn - 1);
  float acc[4][4] = {};
  for (long long k0 = 0; k0 < K; k0 += kDwK) {
    for (int idx = threadIdx.x; idx < kDwK * kDwTile; idx += blockDim.x) {
      const int kk = idx / kDwTile, col = idx - kk * kDwTile;
      const long long k = k0 + kk;
      float a = 0.f, b = 0.f;
      if (k < K) {
        const long long bi = k / (Tn - 1);
        const int t = (int)(k - bi * (Tn - 1)) + 1;
        const size_t at = ((size_t)g * B + bi) * Tn + t;
        if (i0 + col < H) a = to_f(hs[(at - 1) * H + i0 + col]);
        if (n0 + col < H4) b = to_f(dgx[at * H4 + n0 + col]);
      }
      a_s[kk][col] = a;
      b_s[kk][col] = b;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDwK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        a[u] = a_s[kk][ty * 4 + u];
        b[u] = b_s[kk][tx * 4 + u];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(a[u], b[v], acc[u][v]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int i = i0 + ty * 4 + u, n = n0 + tx * 4 + v;
      if (i < H && n < H4) dwh[((size_t)g * H + i) * H4 + n] = acc[u][v];
    }
}

// dwh on the tensor cores (bf16, H a multiple of 64, 16-byte aligned hs and
// dgx): one block per (worker, 64 rows of H, 64 columns of 4H), 64 x 64 f32
// accumulators in one consumer warpgroup. The contraction runs over the
// pairs (b, u) with u = t - 1: for each batch row, chunks of 64 steps of hs
// (rows u) and of dgx (rows u + 1) arrive by TMA through a 4-deep ring (one
// producer warp; 3-D tiles of the [G*B, T, n] sequences, steps past T
// zero-filled, which also drops the pair (T-1, T)), and each chunk is four
// wgmma m64n64k16 with both operands read MN-major. One block sums its whole
// contraction in a fixed order: deterministic, no atomics, no second pass.
constexpr int kDwStep = 64;                // steps per chunk; rows and columns per block
constexpr int kDwStages = 4;               // depth of the TMA ring
constexpr uint32_t kDwBytes = kDwStep * 128;  // one 64 x 64 bf16 tile
constexpr uint32_t kDwSmem = kDwStages * 2 * kDwBytes + 8 * 2 * kDwStages + 1024;

__global__ void __launch_bounds__(160)
lstm_dwh_wgmma_kernel(const __grid_constant__ CUtensorMap th, const __grid_constant__ CUtensorMap tg,
                      float* __restrict__ dwh, int B, int Tn, int H) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + kDwStages * 2 * kDwBytes);
  uint64_t* empty = full + kDwStages;
  const int g = blockIdx.z, i0 = blockIdx.y * kDwStep, n0 = blockIdx.x * kDwStep;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nch = (Tn - 1 + kDwStep - 1) / kDwStep;  // chunks per batch row
  const int total = B * nch;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kDwStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4) {  // producer
    if (lane == 0) {
      for (int i = 0; i < total; ++i) {
        const int s = i % kDwStages, b = i / nch, u0 = (i % nch) * kDwStep;
        if (i >= kDwStages) hopper::mbar_wait(&empty[s], (i / kDwStages - 1) & 1);
        uint8_t* A = base + s * 2 * kDwBytes;
        hopper::mbar_arrive_expect_tx(&full[s], 2 * kDwBytes);
        hopper::tma_load_4d(A, &th, &full[s], i0, 0, u0, g * B + b);
        hopper::tma_load_4d(A + kDwBytes, &tg, &full[s], n0, 0, u0 + 1, g * B + b);
      }
    }
  } else {  // consumer warpgroup: rows i0 + 16 warp .. + 15
    float acc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.f;
    for (int i = 0; i < total; ++i) {
      const int s = i % kDwStages;
      const uint8_t* A = base + s * 2 * kDwBytes;
      hopper::mbar_wait(&full[s], (i / kDwStages) & 1);
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDwStep / 16; ++kk)
        hopper::wgmma_ss_m64n64_tt(acc, hopper::sw128_desc(A + kk * 2048),
                                   hopper::sw128_desc(A + kDwBytes + kk * 2048));
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
    }
    const int gid = lane / 4, t = lane % 4, H4 = 4 * H;
    float* out = dwh + ((size_t)g * H + i0 + 16 * warp + gid) * H4 + n0 + 2 * t;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<float2*>(out + 8 * j) = make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(out + 8 * (size_t)H4 + 8 * j) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

// Raise a scan kernel's dynamic shared-memory cap to the card's limit,
// once per instantiation (a launch then asks for what its H needs).
template <typename T, bool kMma, bool kBackward>
int configure() {
  static const int err = (int)cudaFuncSetAttribute(
      kBackward ? (const void*)lstm_bwd_direct_kernel<T, kMma>
                : (const void*)lstm_fwd_kernel<T, kMma>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemCap);
  return err;
}

template <typename T, bool kMma>
int configure_staged() {
  static const int err = (int)cudaFuncSetAttribute(
      (const void*)lstm_bwd_kernel<T, kMma>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemCap);
  return err;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
bool use_mma(int H) {
  return std::is_same<T, bf16>::value && plan<T>(H, true, true).total <= kSmemCap;
}

dim3 scan_grid(int G, int B) { return dim3((unsigned)((B + kRows - 1) / kRows), (unsigned)G); }
int scan_threads(int H) { return 32 * (H / 16 < kMaxWarps ? H / 16 : kMaxWarps); }

// path: -1 the plan's choice, 0 the per-block scan, 1 the cluster scan (bf16,
// H of cluster_size, 16-byte aligned gx; rows of cluster_rows), 2 the same on
// 16 rows a cluster.
template <typename T>
int fwd(const void* gx, const void* wh, void* hs, void* cs, int G, int B, int Tn, int H,
        int save_c, int path, cudaStream_t s) {
  const int C = std::is_same<T, bf16>::value && aligned16(gx) ? cluster_size(H) : 0;
  if (path < 0) path = C > 0 ? 1 : 0;
  if (path == 1 || path == 2) {  // 2: the cluster scan on 16 rows whatever the plan
    if (C == 0) return (int)cudaErrorInvalidValue;
    const int rows = path == 2 ? 16 : cluster_rows(G, B, C);
    if (H == 128) return fwd_cluster_rows<128, 4>(gx, wh, hs, cs, G, B, Tn, save_c, rows, s);
    if (H == 64) return fwd_cluster_rows<64, 4>(gx, wh, hs, cs, G, B, Tn, save_c, rows, s);
    return fwd_cluster_rows<32, 2>(gx, wh, hs, cs, G, B, Tn, save_c, rows, s);
  }
  const bool mma = use_mma<T>(H);
  const size_t bytes = plan<T>(H, mma, false).total;
  if (bytes > kSmemCap) return (int)cudaErrorInvalidValue;
  auto kernel = mma ? lstm_fwd_kernel<T, true> : lstm_fwd_kernel<T, false>;
  if (int e = mma ? configure<T, true, false>() : configure<T, false, false>()) return e;
  kernel<<<scan_grid(G, B), scan_threads(H), bytes, s>>>(
      static_cast<const T*>(gx), static_cast<const float*>(wh), static_cast<T*>(hs),
      static_cast<T*>(cs), B, Tn, H, save_c);
  return (int)cudaGetLastError();
}

int dwh_wgmma(const void* hs, const void* dgx, void* dwh, int G, int B, int Tn, int H,
              cudaStream_t s) {
  static const int err = (int)cudaFuncSetAttribute(
      lstm_dwh_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kDwSmem);
  if (err) return err;
  CUtensorMap th, tg;
  if (!hopper::bf16_rows_map(&th, hs, G * B, Tn, 1, H, kDwStep) ||
      !hopper::bf16_rows_map(&tg, dgx, G * B, Tn, 1, 4 * H, kDwStep))
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)(4 * H / kDwStep), (unsigned)(H / kDwStep), (unsigned)G);
  lstm_dwh_wgmma_kernel<<<grid, 160, kDwSmem, s>>>(th, tg, static_cast<float*>(dwh), B, Tn, H);
  return (int)cudaGetLastError();
}

// parts: 1 = the reverse scan (dgx), 2 = the weight gradient (dwh, from hs
// and the dgx already in place), 3 = both, in that order.
template <typename T>
int bwd(const void* gx, const void* wh, const void* hs, const void* cs, const void* dhs,
        void* dgx, void* dwh, int G, int B, int Tn, int H, int parts, cudaStream_t s) {
  if (parts & 1) {
    const bool mma = use_mma<T>(H);
    const size_t staged = staged_plan<T>(H, mma).total;
    const T *gx_ = static_cast<const T*>(gx), *hs_ = static_cast<const T*>(hs),
            *cs_ = static_cast<const T*>(cs), *dhs_ = static_cast<const T*>(dhs);
    const float* wh_ = static_cast<const float*>(wh);
    T* dgx_ = static_cast<T*>(dgx);
    if (staged <= kSmemCap && aligned16(gx) && aligned16(hs) && aligned16(cs) &&
        aligned16(dhs)) {
      auto kernel = mma ? lstm_bwd_kernel<T, true> : lstm_bwd_kernel<T, false>;
      if (int e = mma ? configure_staged<T, true>() : configure_staged<T, false>()) return e;
      kernel<<<scan_grid(G, B), scan_threads(H), staged, s>>>(gx_, wh_, hs_, cs_, dhs_, dgx_, B,
                                                               Tn, H);
    } else {
      const size_t bytes = plan<T>(H, mma, true).total;
      if (bytes > kSmemCap) return (int)cudaErrorInvalidValue;
      auto kernel = mma ? lstm_bwd_direct_kernel<T, true> : lstm_bwd_direct_kernel<T, false>;
      if (int e = mma ? configure<T, true, true>() : configure<T, false, true>()) return e;
      kernel<<<scan_grid(G, B), scan_threads(H), bytes, s>>>(gx_, wh_, hs_, cs_, dhs_, dgx_, B,
                                                              Tn, H);
    }
    if (cudaError_t e = cudaGetLastError()) return (int)e;
  }
  if (parts & 2) {
    if constexpr (std::is_same<T, bf16>::value) {
      if (H % kDwStep == 0 && aligned16(hs) && aligned16(dgx))
        return dwh_wgmma(hs, dgx, dwh, G, B, Tn, H, s);
    }
    dim3 grid((unsigned)((4 * H + kDwTile - 1) / kDwTile), (unsigned)((H + kDwTile - 1) / kDwTile),
              (unsigned)G);
    lstm_dwh_kernel<T><<<grid, 256, 0, s>>>(static_cast<const T*>(hs), static_cast<const T*>(dgx),
                                            static_cast<float*>(dwh), B, Tn, H);
  }
  return (int)cudaGetLastError();
}

bool shape_ok(int G, int B, int Tn, int H) {
  return G >= 1 && B >= 1 && Tn >= 1 && H >= 16 && H % 16 == 0;
}

}  // namespace

// Whether the kernels take this (dtype, H): H a multiple of 16 whose tiles
// fit in shared memory. dtype: 0 = float32, 1 = bfloat16.
extern "C" int dk_lstm_supported(int dtype, int H) {
  if (H < 16 || H % 16) return 0;
  if (dtype == 0) return plan<float>(H, false, true).total <= kSmemCap;
  if (dtype == 1) return use_mma<bf16>(H) || plan<bf16>(H, false, true).total <= kSmemCap;
  return 0;
}

// Forward scan: gx [G,B,T,4H] (dtype), wh [G,H,4H] f32 -> hs [G,B,T,H], and
// cs [G,B,T,H] when save_c (cs may be null otherwise).
extern "C" int dk_lstm_fwd(const void* gx, const void* wh, void* hs, void* cs, int G, int B,
                           int Tn, int H, int save_c, int dtype, void* stream) {
  if (!shape_ok(G, B, Tn, H) || (save_c && cs == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return fwd<float>(gx, wh, hs, cs, G, B, Tn, H, save_c, -1, s);
  if (dtype == 1) return fwd<bf16>(gx, wh, hs, cs, G, B, Tn, H, save_c, -1, s);
  return (int)cudaErrorInvalidValue;
}

// The cluster size the forward scan of this (dtype, H) runs on, given 16-byte
// aligned gx (0 for the per-block scan), and the batch rows a cluster takes.
extern "C" int dk_lstm_fwd_cluster(int dtype, int H) { return dtype == 1 ? cluster_size(H) : 0; }
extern "C" int dk_lstm_fwd_cluster_rows(int G, int B, int C) { return cluster_rows(G, B, C); }

#ifdef DK_LSTM_PROBE
// The forward scan on a chosen path (0 per-block, 1 cluster, 2 cluster on 16
// rows), bf16.
extern "C" int dk_lstm_probe_fwd(const void* gx, const void* wh, void* hs, void* cs, int G,
                                 int B, int Tn, int H, int save_c, int path, void* stream) {
  if (!shape_ok(G, B, Tn, H)) return (int)cudaErrorInvalidValue;
  return fwd<bf16>(gx, wh, hs, cs, G, B, Tn, H, save_c, path, static_cast<cudaStream_t>(stream));
}

// Copy the 8 probe counters out and zero them.
extern "C" int dk_lstm_probe_read(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, dk_lstm_probe_cycles, sizeof(dk_lstm_probe_cycles));
  if (e) return (int)e;
  const unsigned long long zeros[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  return (int)cudaMemcpyToSymbol(dk_lstm_probe_cycles, zeros, sizeof(zeros));
}
#endif

// Backward scan and weight gradient: gx, hs, cs, dhs as saved / given ->
// dgx [G,B,T,4H] (dtype), dwh [G,H,4H] f32; `parts` as for bwd (3 on the
// training path; 1 and 2 time the two launches apart).
extern "C" int dk_lstm_bwd(const void* gx, const void* wh, const void* hs, const void* cs,
                           const void* dhs, void* dgx, void* dwh, int G, int B, int Tn, int H,
                           int dtype, int parts, void* stream) {
  if (!shape_ok(G, B, Tn, H) || parts < 1 || parts > 3) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return bwd<float>(gx, wh, hs, cs, dhs, dgx, dwh, G, B, Tn, H, parts, s);
  if (dtype == 1) return bwd<bf16>(gx, wh, hs, cs, dhs, dgx, dwh, G, B, Tn, H, parts, s);
  return (int)cudaErrorInvalidValue;
}
