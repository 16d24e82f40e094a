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
// So the design keeps everything a step needs on chip:
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
// product's are pairs of a column, read as two 16-bit loads). The weight
// gradient dwh = sum_t h_{t-1}^T T(dz_t) does not belong to the
// recurrence: lstm_dwh_kernel computes it afterwards from the saved hs
// and the emitted dgx as a [H, B(T-1)] x [B(T-1), 4H] product per worker,
// one f32 accumulator per output element in a fixed order: deterministic.
// Plain C interface (bound with ctypes): each dk_lstm_* returns the
// cudaGetLastError() of its launches, 0 on success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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
  for (int t = 0; t < Tn; ++t) {
    const T* hcur = h_s + buf * kRows * p.ldh;
    T* hnext = h_s + (buf ^ 1) * kRows * p.ldh;
    for (int slab = warp; slab < slabs; slab += nwarps) {
      float acc[4][2][4];
      gate_products<T, kMma>(acc, hcur, p.ldh, wh_s, p.ldw, whg, H, slab, gid, tq);
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
              z[q] = (valid ? to_f(gxr[q * H + j]) : 0.f) + acc[q][nt][reg];
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
    }
    __syncthreads();
    buf ^= 1;
  }
}

template <typename T, bool kMma>
__global__ void lstm_bwd_kernel(const T* __restrict__ gx, const float* __restrict__ wh,
                                const T* __restrict__ hs, const T* __restrict__ cs,
                                const T* __restrict__ dhs, T* __restrict__ dgx, int B, int Tn,
                                int H) {
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

// Raise a scan kernel's dynamic shared-memory cap to the card's limit,
// once per instantiation (a launch then asks for what its H needs).
template <typename T, bool kMma, bool kBackward>
int configure() {
  static const int err = (int)cudaFuncSetAttribute(
      kBackward ? (const void*)lstm_bwd_kernel<T, kMma> : (const void*)lstm_fwd_kernel<T, kMma>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemCap);
  return err;
}

template <typename T>
bool use_mma(int H) {
  return std::is_same<T, bf16>::value && plan<T>(H, true, true).total <= kSmemCap;
}

dim3 scan_grid(int G, int B) { return dim3((unsigned)((B + kRows - 1) / kRows), (unsigned)G); }
int scan_threads(int H) { return 32 * (H / 16 < kMaxWarps ? H / 16 : kMaxWarps); }

template <typename T>
int fwd(const void* gx, const void* wh, void* hs, void* cs, int G, int B, int Tn, int H,
        int save_c, cudaStream_t s) {
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

template <typename T>
int bwd(const void* gx, const void* wh, const void* hs, const void* cs, const void* dhs,
        void* dgx, void* dwh, int G, int B, int Tn, int H, cudaStream_t s) {
  const bool mma = use_mma<T>(H);
  const size_t bytes = plan<T>(H, mma, true).total;
  if (bytes > kSmemCap) return (int)cudaErrorInvalidValue;
  auto kernel = mma ? lstm_bwd_kernel<T, true> : lstm_bwd_kernel<T, false>;
  if (int e = mma ? configure<T, true, true>() : configure<T, false, true>()) return e;
  kernel<<<scan_grid(G, B), scan_threads(H), bytes, s>>>(
      static_cast<const T*>(gx), static_cast<const float*>(wh), static_cast<const T*>(hs),
      static_cast<const T*>(cs), static_cast<const T*>(dhs), static_cast<T*>(dgx), B, Tn, H);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  dim3 grid((unsigned)((4 * H + kDwTile - 1) / kDwTile), (unsigned)((H + kDwTile - 1) / kDwTile),
            (unsigned)G);
  lstm_dwh_kernel<T><<<grid, 256, 0, s>>>(static_cast<const T*>(hs), static_cast<const T*>(dgx),
                                          static_cast<float*>(dwh), B, Tn, H);
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
  if (dtype == 0) return fwd<float>(gx, wh, hs, cs, G, B, Tn, H, save_c, s);
  if (dtype == 1) return fwd<bf16>(gx, wh, hs, cs, G, B, Tn, H, save_c, s);
  return (int)cudaErrorInvalidValue;
}

// Backward scan and weight gradient: gx, hs, cs, dhs as saved / given ->
// dgx [G,B,T,4H] (dtype), dwh [G,H,4H] f32.
extern "C" int dk_lstm_bwd(const void* gx, const void* wh, const void* hs, const void* cs,
                           const void* dhs, void* dgx, void* dwh, int G, int B, int Tn, int H,
                           int dtype, void* stream) {
  if (!shape_ok(G, B, Tn, H)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return bwd<float>(gx, wh, hs, cs, dhs, dgx, dwh, G, B, Tn, H, s);
  if (dtype == 1) return bwd<bf16>(gx, wh, hs, cs, dhs, dgx, dwh, G, B, Tn, H, s);
  return (int)cudaErrorInvalidValue;
}
