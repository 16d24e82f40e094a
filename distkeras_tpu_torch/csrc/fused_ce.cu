// The chunked fused cross-entropy's f32 row work for Hopper (sm_90a): one
// pass over a chunk's logits in the forward (ce_fwd_rows) and one in the
// backward (ce_bwd_rows).
//
// Replaces no Pallas kernel: the JAX package computes its chunked fused
// cross-entropy (distkeras_tpu/ops/fused_ce.py) in XLA. The chunk products
// stay cuBLAS products (ops/fused_ce.py); these kernels take the softmax
// work between them, which PyTorch's elementwise kernels did in about a
// dozen reads and writes of each f32 chunk.
//
// Contract, per chunk of `rows` rows a group g (G groups: the workers a
// vmap folds in), with x = logits[g, r, :] + bias[g, :] in f32 (bias may be
// null):
//   ce_fwd_rows:  lse[g, r] = log sum_j exp(x_j),  nll[g, r] = lse - x_label
//   ce_bwd_rows:  d_j = (exp(x_j - lse[g, r]) - [j = label]) * w,
//                 w = mask[g, r] * scale[g],
//                 dlogits[g, r, j] = d_j rounded once to the output type,
//                 db[g, j] += sum_r d_j in f32, before that rounding.
// The backward takes the forward's lse, so neither the max, the sum of
// exponentials nor the picked logit is computed again, and the label's -1
// goes in by index: no one-hot exists. A label outside [0, V) reads a NaN
// nll. Logits rows are contiguous (row stride V); each operand's group
// stride is an argument, so a chunk's outputs land in slices of [G, N]
// tensors and its dlogits in a slice of a larger buffer.
//
// What bounds them on an H100: bytes. A chunk of config 9's head (G = 2,
// 512 rows, V = 16384) is 67 MB of f32 logits; the forward reads them once
// (20.0 us at 3.35 TB/s), the backward reads them once and writes 34 MB of
// bf16 dlogits (30.0 us), for one exp and a few adds an element. So the
// design is about keeping loads in flight and touching each byte once:
//  * ce_fwd_rows: one 256-thread block a row. Each thread keeps an online
//    (max, sum of exp) over its columns, four float4 loads in flight at a
//    time (16-byte aligned rows with V % 4 == 0; otherwise one element at
//    a time), merges it across the warp by shuffles and across the block
//    through shared memory in a fixed order, and thread 0 reads the
//    label's logit (from L2: the row was just read) and writes lse and nll.
//  * ce_bwd_rows: a block owns a 128-column tile of one group and a run of
//    rows (grid: tiles x G x S row splits). Each warp walks every eighth
//    row of the run, four rows' loads in flight, each lane four columns
//    (one float4 when aligned), and writes dlogits as it goes; the bias
//    slice is read once a block. db's column sums stay in registers, are
//    summed over the block's warps through shared memory in a fixed
//    order, and reach db without atomics on the sums: with S = 1 the block
//    is the tile's only owner and adds its sums to db; with S > 1 each
//    block writes its sums to a partial buffer [S, G, V] and the last
//    block of the tile to finish (a ticket counted with atomicAdd, reset
//    to 0 by that block) adds the S partials in split order. db is
//    therefore bit-reproducible from run to run on one card. S is chosen
//    by the caller so that the grid fills the card.
// Products and sums are rounded one by one (__fmul_rn / __fadd_rn, no
// contraction into FMA) and exp is expf, so a dlogits element equals the
// plain version's (ops/fused_ce.py) for the same lse.
//
// Plain C interface (bound with ctypes): each entry returns the
// cudaGetLastError() of its launch, 0 on success.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kFwdThreads = 256;
constexpr int kFwdWarps = kFwdThreads / 32;
constexpr int kBwdThreads = 256;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kCols = 128;  // a backward block's column tile: 32 lanes x 4
constexpr unsigned kFull = 0xffffffffu;

// (m, s) <- the online (max, sum of exp) of the union of two column sets
__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  const float mm = fmaxf(m, m2);
  if (mm == -INFINITY) {  // both sets empty or all -inf
    s = __fadd_rn(s, s2);
    return;
  }
  s = __fadd_rn(__fmul_rn(s, expf(m - mm)), __fmul_rn(s2, expf(m2 - mm)));
  m = mm;
}

__device__ __forceinline__ void online_add(float& m, float& s, float v) {
  if (v > m) {
    s = __fmul_rn(s, expf(m - v));
    m = v;
  }
  if (m != -INFINITY) s = __fadd_rn(s, expf(v - m));
}

__device__ __forceinline__ void online_add4(float& m, float& s, float4 v) {
  const float mx = fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w));
  if (mx > m) {
    s = __fmul_rn(s, expf(m - mx));
    m = mx;
  }
  if (m == -INFINITY) return;
  const float a = __fadd_rn(expf(v.x - m), expf(v.y - m));
  const float b = __fadd_rn(expf(v.z - m), expf(v.w - m));
  s = __fadd_rn(s, __fadd_rn(a, b));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

template <bool kVec>
__global__ void __launch_bounds__(kFwdThreads)
ce_fwd_rows_kernel(const float* __restrict__ logits, long long logits_gs,
                   const float* __restrict__ bias, const long long* __restrict__ labels,
                   long long labels_gs, float* __restrict__ lse, float* __restrict__ nll,
                   long long out_gs, int V) {
  const int r = blockIdx.x, g = blockIdx.y;
  const float* x = logits + g * logits_gs + (long long)r * V;
  const float* b = bias == nullptr ? nullptr : bias + (long long)g * V;
  float m = -INFINITY, s = 0.f;
  if (kVec) {
    constexpr int kStep = 4 * kFwdThreads;  // columns one pass of the block reads
    int c = 4 * threadIdx.x;
    for (; c + 3 * kStep < V; c += 4 * kStep) {  // four float4 loads in flight
      float4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = *reinterpret_cast<const float4*>(x + c + u * kStep);
      if (b != nullptr) {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          v[u] = add4(v[u], *reinterpret_cast<const float4*>(b + c + u * kStep));
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) online_add4(m, s, v[u]);
    }
    for (; c < V; c += kStep) {
      float4 v = *reinterpret_cast<const float4*>(x + c);
      if (b != nullptr) v = add4(v, *reinterpret_cast<const float4*>(b + c));
      online_add4(m, s, v);
    }
  } else {
#pragma unroll 4
    for (int c = threadIdx.x; c < V; c += kFwdThreads)
      online_add(m, s, b == nullptr ? x[c] : __fadd_rn(x[c], b[c]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(kFull, m, o);
    const float s2 = __shfl_xor_sync(kFull, s, o);
    merge(m, s, m2, s2);
  }
  __shared__ float wm[kFwdWarps], ws[kFwdWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    wm[warp] = m;
    ws[warp] = s;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  m = wm[0];
  s = ws[0];
  for (int w = 1; w < kFwdWarps; ++w) merge(m, s, wm[w], ws[w]);
  const long long lab = labels[g * labels_gs + r];
  float picked = NAN;
  if (lab >= 0 && lab < V) picked = b == nullptr ? x[lab] : __fadd_rn(x[lab], b[lab]);
  const float l = __fadd_rn(m, logf(s));
  lse[g * out_gs + r] = l;
  nll[g * out_gs + r] = __fsub_rn(l, picked);
}

template <typename T>
struct Out;
template <>
struct Out<float> {
  static __device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
    *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
  }
  static __device__ __forceinline__ void store1(float* p, float a) { *p = a; }
};
template <>
struct Out<__nv_bfloat16> {
  static __device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b, float c,
                                                float d) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
    uint2 w;
    w.x = *reinterpret_cast<uint32_t*>(&lo);
    w.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = w;
  }
  static __device__ __forceinline__ void store1(__nv_bfloat16* p, float a) {
    *p = __float2bfloat16_rn(a);
  }
};
template <>
struct Out<__half> {
  static __device__ __forceinline__ void store4(__half* p, float a, float b, float c, float d) {
    __half2 lo = __floats2half2_rn(a, b), hi = __floats2half2_rn(c, d);
    uint2 w;
    w.x = *reinterpret_cast<uint32_t*>(&lo);
    w.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = w;
  }
  static __device__ __forceinline__ void store1(__half* p, float a) { *p = __float2half_rn(a); }
};

// the column of this lane's k-th value inside its block's tile
template <bool kVec>
__device__ __forceinline__ int tile_col(int lane, int k) {
  return kVec ? 4 * lane + k : lane + 32 * k;
}

struct Row {
  long long lab;
  float lse, w;
};

template <bool kVec>
__device__ __forceinline__ void load_row(const float* xr, int col0, int V, float v[4]) {
  if (kVec) {
    if (col0 + tile_col<true>(threadIdx.x % 32, 0) < V) {
      const float4 q = *reinterpret_cast<const float4*>(xr + col0 + tile_col<true>(threadIdx.x % 32, 0));
      v[0] = q.x;
      v[1] = q.y;
      v[2] = q.z;
      v[3] = q.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = col0 + tile_col<false>(threadIdx.x % 32, k);
      if (c < V) v[k] = xr[c];
    }
  }
}

template <bool kVec, typename T>
__device__ __forceinline__ void row_grad(const float v[4], const float bk[4], const Row& row,
                                         int col0, int V, T* out, float acc[4]) {
  const int lane = threadIdx.x % 32;
  float d[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int c = col0 + tile_col<kVec>(lane, k);
    float p = expf(__fsub_rn(__fadd_rn(v[k], bk[k]), row.lse));
    if (c == row.lab) p = __fsub_rn(p, 1.f);
    d[k] = __fmul_rn(p, row.w);
  }
  if (kVec) {
    const int c = col0 + tile_col<true>(lane, 0);
    if (c < V) {
      Out<T>::store4(out + c, d[0], d[1], d[2], d[3]);
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[k] = __fadd_rn(acc[k], d[k]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = col0 + tile_col<false>(lane, k);
      if (c < V) {
        Out<T>::store1(out + c, d[k]);
        acc[k] = __fadd_rn(acc[k], d[k]);
      }
    }
  }
}

template <bool kVec, typename T>
__global__ void __launch_bounds__(kBwdThreads)
ce_bwd_rows_kernel(const float* __restrict__ logits, long long logits_gs,
                   const float* __restrict__ bias, const long long* __restrict__ labels,
                   long long labels_gs, const float* __restrict__ lse, long long lse_gs,
                   const float* __restrict__ mask, long long mask_gs,
                   const float* __restrict__ scale, T* __restrict__ dlogits, long long out_gs,
                   float* __restrict__ db, float* __restrict__ partial,
                   unsigned* __restrict__ tickets, int rows, int V) {
  const int tile = blockIdx.x, g = blockIdx.y, split = blockIdx.z;
  const int G = gridDim.y, S = gridDim.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col0 = tile * kCols;
  const int per = (rows + S - 1) / S;
  const int r_end = min(rows, (split + 1) * per);
  const float sc = scale[g];
  float bk[4] = {0.f, 0.f, 0.f, 0.f};
  if (bias != nullptr) {
    const float* bg = bias + (long long)g * V;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = col0 + tile_col<kVec>(lane, k);
      if (c < V) bk[k] = bg[c];
    }
  }
  const float* xg = logits + g * logits_gs;
  T* og = dlogits + g * out_gs;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  int r = split * per + warp;
  for (; r + 3 * kBwdWarps < r_end; r += 4 * kBwdWarps) {  // four rows' loads in flight
    float v[4][4] = {};
    Row row[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int ru = r + u * kBwdWarps;
      row[u].lab = labels[g * labels_gs + ru];
      row[u].lse = lse[g * lse_gs + ru];
      row[u].w = __fmul_rn(mask[g * mask_gs + ru], sc);
      load_row<kVec>(xg + (long long)ru * V, col0, V, v[u]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      row_grad<kVec>(v[u], bk, row[u], col0, V, og + (long long)(r + u * kBwdWarps) * V, acc);
  }
  for (; r < r_end; r += kBwdWarps) {
    float v[4] = {};
    const Row row{labels[g * labels_gs + r], lse[g * lse_gs + r],
                  __fmul_rn(mask[g * mask_gs + r], sc)};
    load_row<kVec>(xg + (long long)r * V, col0, V, v);
    row_grad<kVec>(v, bk, row, col0, V, og + (long long)r * V, acc);
  }

  // db: the block's column sums, over its warps in order
  __shared__ float red[kBwdWarps][kCols];
#pragma unroll
  for (int k = 0; k < 4; ++k) red[warp][tile_col<kVec>(lane, k)] = acc[k];
  __syncthreads();
  const int j = threadIdx.x;  // this thread's column of the tile, if < kCols
  const long long at = (long long)g * V + col0 + j;
  if (j < kCols && col0 + j < V) {
    float sum = red[0][j];
    for (int w = 1; w < kBwdWarps; ++w) sum = __fadd_rn(sum, red[w][j]);
    if (S == 1)
      db[at] = __fadd_rn(db[at], sum);
    else
      partial[(long long)split * G * V + at] = sum;
  }
  if (S == 1) return;
  // the last of the tile's S blocks adds the partials in split order
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned* t = tickets + (long long)g * gridDim.x + tile;
    last = atomicAdd(t, 1u) == (unsigned)(S - 1);
    if (last) *t = 0u;  // every other block of the tile has taken its ticket
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (j < kCols && col0 + j < V) {
    float sum = __ldcg(partial + at);
    for (int s = 1; s < S; ++s) sum = __fadd_rn(sum, __ldcg(partial + (long long)s * G * V + at));
    db[at] = __fadd_rn(db[at], sum);
  }
}

template <typename T>
int launch_bwd(bool vec, dim3 grid, cudaStream_t st, const float* logits, long long logits_gs,
               const float* bias, const long long* labels, long long labels_gs, const float* lse,
               long long lse_gs, const float* mask, long long mask_gs, const float* scale,
               void* dlogits, long long out_gs, float* db, float* partial, unsigned* tickets,
               int rows, int V) {
  T* out = static_cast<T*>(dlogits);
  if (vec)
    ce_bwd_rows_kernel<true, T><<<grid, kBwdThreads, 0, st>>>(
        logits, logits_gs, bias, labels, labels_gs, lse, lse_gs, mask, mask_gs, scale, out,
        out_gs, db, partial, tickets, rows, V);
  else
    ce_bwd_rows_kernel<false, T><<<grid, kBwdThreads, 0, st>>>(
        logits, logits_gs, bias, labels, labels_gs, lse, lse_gs, mask, mask_gs, scale, out,
        out_gs, db, partial, tickets, rows, V);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dk_ce_bwd_cols() { return kCols; }

// Per chunk: logits [G, rows, V] f32 with group stride logits_gs (elements);
// bias [G, V] f32 contiguous or null; labels int64, lse and nll f32, each
// [G, rows] with unit row stride and the given group strides. vec: rows and
// bias 16-byte aligned and V % 4 == 0.
extern "C" int dk_ce_fwd_rows(const void* logits, long long logits_gs, const void* bias,
                              const void* labels, long long labels_gs, void* lse, void* nll,
                              long long out_gs, int G, int rows, int V, int vec, void* stream) {
  if (G < 1 || rows < 1 || V < 1 || G > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(rows, G);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(logits);
  const float* b = static_cast<const float*>(bias);
  const long long* y = static_cast<const long long*>(labels);
  float* l = static_cast<float*>(lse);
  float* n = static_cast<float*>(nll);
  if (vec)
    ce_fwd_rows_kernel<true><<<grid, kFwdThreads, 0, st>>>(x, logits_gs, b, y, labels_gs, l, n,
                                                          out_gs, V);
  else
    ce_fwd_rows_kernel<false><<<grid, kFwdThreads, 0, st>>>(x, logits_gs, b, y, labels_gs, l, n,
                                                           out_gs, V);
  return (int)cudaGetLastError();
}

// Per chunk, as the forward, plus: mask f32 [G, rows] (group stride
// mask_gs), scale f32 [G], dlogits [G, rows, V] of out_dtype (0 float32,
// 1 bfloat16, 2 float16) with group stride out_gs, db f32 [G, V] (added
// to), and for splits > 1 partial f32 [splits, G, V] and tickets uint32
// [G, ceil(V / dk_ce_bwd_cols())], all 0 (each launch leaves them 0). vec:
// also dlogits 4-element aligned and out_gs % 4 == 0.
extern "C" int dk_ce_bwd_rows(const void* logits, long long logits_gs, const void* bias,
                              const void* labels, long long labels_gs, const void* lse,
                              long long lse_gs, const void* mask, long long mask_gs,
                              const void* scale, void* dlogits, long long out_gs, int out_dtype,
                              void* db, void* partial, void* tickets, int G, int rows, int V,
                              int splits, int vec, void* stream) {
  if (G < 1 || rows < 1 || V < 1 || G > 65535 || splits < 1 || splits > 65535 ||
      (splits > 1 && (partial == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((V + kCols - 1) / kCols, G, splits);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(logits);
  const float* b = static_cast<const float*>(bias);
  const long long* y = static_cast<const long long*>(labels);
  const float* l = static_cast<const float*>(lse);
  const float* m = static_cast<const float*>(mask);
  const float* sc = static_cast<const float*>(scale);
  float* d = static_cast<float*>(db);
  float* p = static_cast<float*>(partial);
  unsigned* t = static_cast<unsigned*>(tickets);
  switch (out_dtype) {
    case 0:
      return launch_bwd<float>(vec, grid, st, x, logits_gs, b, y, labels_gs, l, lse_gs, m,
                               mask_gs, sc, dlogits, out_gs, d, p, t, rows, V);
    case 1:
      return launch_bwd<__nv_bfloat16>(vec, grid, st, x, logits_gs, b, y, labels_gs, l, lse_gs,
                                       m, mask_gs, sc, dlogits, out_gs, d, p, t, rows, V);
    case 2:
      return launch_bwd<__half>(vec, grid, st, x, logits_gs, b, y, labels_gs, l, lse_gs, m,
                                mask_gs, sc, dlogits, out_gs, d, p, t, rows, V);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
