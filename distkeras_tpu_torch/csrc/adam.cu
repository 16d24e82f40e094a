// Multi-tensor fused Adam for Hopper (sm_90a): one launch per optimizer step
// over every leaf of the (worker-stacked) parameter tree.
//
// Replaces distkeras_tpu/ops/pallas_kernels.py::_adam_kernel (launched per
// leaf by _adam_leaf). Per element, exactly as the TPU kernel:
//     m' = b1 m + (1 - b1) g           v' = b2 v + ((1 - b2) g) g
//     u  = ((-lr) (m' bc1)) / (sqrt(v' bc2) + eps)
// with g widened to f32, m and v in f32, u written in g's type, and
// bc = [1/(1 - b1^t), 1/(1 - b2^t)] computed once per step by the caller.
// The kernel returns the update u, not new parameters: the engine adds it
// (params += u), which the merge rules rely on. Products and sums are
// rounded one by one (__fmul_rn/__fadd_rn, no contraction into FMA), and
// sqrt and division are IEEE, so the kernel repeats its plain PyTorch
// version bit for bit.
//
// Layout: a device-side table of leaves, one row of nine int64 per leaf:
// pointers g, m, v, m_out, v_out, u, then the element count n, the index of
// the leaf's first 4096-element chunk among all leaves' chunks, and g's type
// (0 = float32, 1 = bfloat16). The op is elementwise, so each leaf's
// [W, ...] stack is one flat run of n elements.
//
// What bounds it on an H100: bytes. Each element reads g, m, v and writes
// m', v', u (24 bytes in f32) for 12 operations, far below the card's
// ~20 f32 operations per byte. So the design is about streaming: blocks
// walk all leaves' chunks grid-stride (one launch, however many leaves),
// and a chunk whose pointers are 16-byte aligned moves four elements per
// thread per load (float4, or four bf16 in 8 bytes); the rest goes one
// element at a time.
// Plain C interface (bound with ctypes): dk_adam returns the
// cudaGetLastError() of its launch, 0 on success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 4096;    // elements per chunk (a multiple of 4)
constexpr int kThreads = 256;

struct Leaf {
  int64_t g, m, v, m_out, v_out, u, n, chunk0, dtype;
};

struct Coef {
  float b1, one_minus_b1, b2, one_minus_b2, neg_lr, eps, bc1, bc2;
};

__device__ __forceinline__ void adam_elem(const Coef& k, float g, float m, float v,
                                          float& m_new, float& v_new, float& u) {
  m_new = __fadd_rn(__fmul_rn(k.b1, m), __fmul_rn(k.one_minus_b1, g));
  v_new = __fadd_rn(__fmul_rn(k.b2, v), __fmul_rn(__fmul_rn(k.one_minus_b2, g), g));
  const float mhat = __fmul_rn(m_new, k.bc1);
  const float vhat = __fmul_rn(v_new, k.bc2);
  u = __fdiv_rn(__fmul_rn(k.neg_lr, mhat), __fadd_rn(__fsqrt_rn(vhat), k.eps));
}

template <typename T>
__device__ __forceinline__ float load1(const T* p, int64_t i);
template <>
__device__ __forceinline__ float load1<float>(const float* p, int64_t i) { return p[i]; }
template <>
__device__ __forceinline__ float load1<__nv_bfloat16>(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
template <typename T>
__device__ __forceinline__ void store1(T* p, int64_t i, float x);
template <>
__device__ __forceinline__ void store1<float>(float* p, int64_t i, float x) { p[i] = x; }
template <>
__device__ __forceinline__ void store1<__nv_bfloat16>(__nv_bfloat16* p, int64_t i, float x) {
  p[i] = __float2bfloat16_rn(x);
}

// four consecutive elements of g as f32 / four f32 written as T
__device__ __forceinline__ float4 load4(const float* p, int64_t i) {
  return *reinterpret_cast<const float4*>(p + i);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p, int64_t i) {
  const uint2 w = *reinterpret_cast<const uint2*>(p + i);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, int64_t i, float4 x) {
  *reinterpret_cast<float4*>(p + i) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, int64_t i, float4 x) {
  __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
  uint2 w;
  w.x = *reinterpret_cast<uint32_t*>(&a);
  w.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p + i) = w;
}

__device__ __forceinline__ bool aligned(int64_t p, int bytes) { return p % bytes == 0; }

template <typename T>
__device__ void adam_chunk(const Leaf& L, const Coef& k, int64_t start, int64_t end) {
  const T* g = reinterpret_cast<const T*>(L.g);
  const float* m = reinterpret_cast<const float*>(L.m);
  const float* v = reinterpret_cast<const float*>(L.v);
  float* m_out = reinterpret_cast<float*>(L.m_out);
  float* v_out = reinterpret_cast<float*>(L.v_out);
  T* u = reinterpret_cast<T*>(L.u);
  const int gbytes = 4 * (int)sizeof(T);
  const bool vec = aligned(L.g, gbytes) && aligned(L.u, gbytes) && aligned(L.m, 16) &&
                   aligned(L.v, 16) && aligned(L.m_out, 16) && aligned(L.v_out, 16);
  int64_t i = start + 4 * (int64_t)threadIdx.x;
  int64_t scalar_from = start;
  if (vec) {
    const int64_t vec_end = start + ((end - start) / 4) * 4;
    for (; i < vec_end; i += 4 * kThreads) {
      const float4 gv = load4(g, i), mv = load4(m, i), vv = load4(v, i);
      float4 mn, vn, un;
      adam_elem(k, gv.x, mv.x, vv.x, mn.x, vn.x, un.x);
      adam_elem(k, gv.y, mv.y, vv.y, mn.y, vn.y, un.y);
      adam_elem(k, gv.z, mv.z, vv.z, mn.z, vn.z, un.z);
      adam_elem(k, gv.w, mv.w, vv.w, mn.w, vn.w, un.w);
      store4(m_out, i, mn);
      store4(v_out, i, vn);
      store4(u, i, un);
    }
    scalar_from = vec_end;
  }
  for (int64_t j = scalar_from + threadIdx.x; j < end; j += kThreads) {
    float mn, vn, un;
    adam_elem(k, load1(g, j), m[j], v[j], mn, vn, un);
    m_out[j] = mn;
    v_out[j] = vn;
    store1(u, j, un);
  }
}

__global__ void __launch_bounds__(kThreads)
adam_kernel(const Leaf* __restrict__ table, int n_leaves, int64_t total_chunks, Coef k) {
  for (int64_t c = blockIdx.x; c < total_chunks; c += gridDim.x) {
    int lo = 0, hi = n_leaves - 1;   // the last leaf whose first chunk is <= c
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (table[mid].chunk0 <= c) lo = mid; else hi = mid - 1;
    }
    const Leaf L = table[lo];
    const int64_t start = (c - L.chunk0) * kChunk;
    const int64_t end = start + kChunk < L.n ? start + kChunk : L.n;
    if (L.dtype == 1)
      adam_chunk<__nv_bfloat16>(L, k, start, end);
    else
      adam_chunk<float>(L, k, start, end);
  }
}

}  // namespace

extern "C" int dk_adam_chunk() { return kChunk; }

// table: device pointer to n_leaves rows of nine int64 (see the top);
// total_chunks: the sum of every leaf's ceil(n / 4096).
extern "C" int dk_adam(const void* table, int n_leaves, long long total_chunks, float b1,
                       float one_minus_b1, float b2, float one_minus_b2, float neg_lr,
                       float eps, float bc1, float bc2, int max_blocks, void* stream) {
  if (n_leaves < 1 || total_chunks < 1 || max_blocks < 1) return (int)cudaErrorInvalidValue;
  const Coef k{b1, one_minus_b1, b2, one_minus_b2, neg_lr, eps, bc1, bc2};
  const int blocks = (int)(total_chunks < max_blocks ? total_chunks : max_blocks);
  adam_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Leaf*>(table), n_leaves, (int64_t)total_chunks, k);
  return (int)cudaGetLastError();
}
