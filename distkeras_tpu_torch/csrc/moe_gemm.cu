// Grouped bf16 matrix products over row-sorted groups: the dropless expert
// layer's three products (distkeras_tpu_torch/ops/moe_gemm.py).
//
// Replaces no TPU kernel: the JAX package's expert layer (parallel/expert.py)
// is the GShard layer, one-hot dispatch into capacity slots and dense einsums
// left to XLA. The port's dropless layer sorts the (token, expert) pairs it
// holds by expert and runs each expert's SwiGLU over its own rows, so the
// products are a batch of GEMMs of uneven, possibly empty row counts whose
// offsets live on the device and never reach the host.
//
// Three entry points, one kernel template over a mode:
//  * FWD  y[r, n]   = sum_k x[r, k] w[g][n, k]   (x K-major, w K-major)
//  * DX   dx[r, k]  = sum_n dy[r, n] w[g][n, k]  (dy K-major, w MN-major)
//  * DW   dw[g][n, k] = sum_{r in g} dy[r, n] x[r, k]  (both MN-major)
// with w [G, N, K] in the port's [out, in] layout. Rows of no group come out
// zero in FWD and DX; an empty group's dw is zero.
//
// Bound: at the expert layer's shapes (K, N = 1024 or 2048, ~512 rows a
// group) every product is well above the card's ~295 operations a byte, so
// the tensor cores bound it. Design, right and simple first: a block computes
// a 128 x 128 tile of one group with two consumer warpgroups (m64 each, two
// n64 wgmma accumulators), all 256 threads loading bf16 tiles of 64 along the
// contraction with 16-byte cp.async into 128-byte-swizzled shared memory (the
// layout wgmma's descriptors read, hopper.cuh), three stages in flight, and a
// rows mask (zero fill) at each group's ragged end. FWD and DX size their grid
// from the static row count: ceil(R / 128) + G + 1 row tiles, each block
// finding its group by walking the offsets; tiles past the groups' zero the
// rows of no group, and the rest exit. DW's grid is (N / 128, K / 128, G), each
// block reducing over its group's rows. No TMA (the row tiles start anywhere),
// no warp specialisation, no persistent blocks: later work.
//
// Beside them, dk_moe_swiglu: the SwiGLU and the gate weights between the two
// products, forward and backward, over the held rows only (below).

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128;       // output rows a block (two warpgroups of 64)
constexpr int BN = 128;       // output columns a block (two n64 accumulators)
constexpr int BK = 64;        // contraction a stage: one 128-byte row
constexpr int STAGES = 3;
constexpr int THREADS = 256;
constexpr int TILE_BYTES = 128 * 64 * 2;  // one operand's tile of a stage
constexpr int SMEM_BYTES = STAGES * 2 * TILE_BYTES + 1024;

enum Mode { FWD = 0, DX = 1, DW = 2 };

struct Params {
  const __nv_bfloat16* a;  // FWD: x [R, K]; DX, DW: dy [R, N]
  const __nv_bfloat16* b;  // FWD, DX: w [G, N, K]; DW: x [R, K]
  __nv_bfloat16* c;        // FWD: y [R, N]; DX: dx [R, K]; DW: dw [G, N, K]
  const int* off;          // [G + 1]
  int groups, rows, n, k;
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// d (m64 x n64, f32) += A B, k16; A and B from shared memory, each K-major
// (flag 0) or MN-major (flag 1, the transpose wgmma has for 16-bit types).
template <int TA, int TB>
__device__ __forceinline__ void mma_m64n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, %35, "
      "%36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// A K-major tile: 128 rows (M or N) of 64 contraction elements, rows of 128
// bytes swizzled by row % 8; row i of the source is src + i * ld, valid while
// i < valid_rows (else zero-filled).
__device__ __forceinline__ void load_kmajor(uint8_t* tile, const __nv_bfloat16* src, long long ld,
                                            int valid_rows, int tid) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = tid + i * THREADS;
    const int row = q >> 3, chunk = q & 7;
    const bool ok = row < valid_rows;
    const __nv_bfloat16* s = ok ? src + row * ld + chunk * 8 : src;
    cp_async16(smem_u32(tile + row * 128 + ((chunk ^ (row & 7)) << 4)), s, ok);
  }
}

// An MN-major tile: 64 contraction rows of 128 M or N columns, stored as two
// atoms of 64 columns (8 KB each), rows of 128 bytes swizzled by row % 8;
// contraction row i of the source is src + i * ld, valid while i <
// valid_rows (else zero-filled).
__device__ __forceinline__ void load_mnmajor(uint8_t* tile, const __nv_bfloat16* src, long long ld,
                                             int valid_rows, int tid) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = tid + i * THREADS;
    const int row = q >> 4, atom = (q >> 3) & 1, chunk = q & 7;
    const bool ok = row < valid_rows;
    const __nv_bfloat16* s = ok ? src + row * ld + atom * 64 + chunk * 8 : src;
    cp_async16(smem_u32(tile + atom * 8192 + row * 128 + ((chunk ^ (row & 7)) << 4)), s, ok);
  }
}

// The tile of stage `kt` for the block's operands.
template <int MODE>
__device__ __forceinline__ void load_stage(uint8_t* ta, uint8_t* tb, const Params& p, int g,
                                           int row0, int row_end, int m0, int n0, int kt,
                                           int tid) {
  const int c0 = kt * BK;
  if constexpr (MODE == FWD) {
    load_kmajor(ta, p.a + (long long)row0 * p.k + c0, p.k, row_end - row0, tid);
    load_kmajor(tb, p.b + ((long long)g * p.n + n0) * p.k + c0, p.k, BN, tid);
  } else if constexpr (MODE == DX) {
    load_kmajor(ta, p.a + (long long)row0 * p.n + c0, p.n, row_end - row0, tid);
    load_mnmajor(tb, p.b + ((long long)g * p.n + c0) * p.k + n0, p.k, BK, tid);
  } else {
    const int r = row0 + c0, valid = row_end - r;
    load_mnmajor(ta, p.a + (long long)r * p.n + m0, p.n, valid, tid);
    load_mnmajor(tb, p.b + (long long)r * p.k + n0, p.k, valid, tid);
  }
}

template <int MODE>
__device__ __forceinline__ void mma_stage(float (&acc)[2][32], const uint8_t* ta,
                                          const uint8_t* tb, int wg) {
  constexpr int TA = MODE == DW ? 1 : 0;
  constexpr int TB = MODE == FWD ? 0 : 1;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t da = sw128_desc(ta + wg * 8192 + (TA ? kk * 2048 : kk * 32));
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const uint64_t db = sw128_desc(tb + j * 8192 + (TB ? kk * 2048 : kk * 32));
      mma_m64n64<TA, TB>(acc[j], da, db);
    }
  }
}

// Zero rows [z0, z1) of the output's columns [n0, n0 + BN).
__device__ __forceinline__ void zero_rows(__nv_bfloat16* c, long long ld, int z0, int z1, int n0,
                                          int tid) {
  const int per_row = BN / 8;  // 16-byte stores a row
  for (int q = tid; q < (z1 - z0) * per_row; q += THREADS) {
    const int r = z0 + q / per_row, col = n0 + (q % per_row) * 8;
    *reinterpret_cast<uint4*>(c + r * ld + col) = make_uint4(0, 0, 0, 0);
  }
}

template <int MODE>
__global__ void __launch_bounds__(THREADS) moe_gemm_kernel(Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int n0 = blockIdx.y * BN;

  int g = -1, row0 = 0, row_end = 0, m0 = 0, steps = 0;
  const long long ldc = MODE == FWD ? p.n : p.k;
  if constexpr (MODE == DW) {
    g = blockIdx.z;
    m0 = blockIdx.x * BM;
    row0 = p.off[g];
    row_end = p.off[g + 1];
    steps = (row_end - row0 + BK - 1) / BK;
  } else {
    // find this row tile's group: tiles are numbered group after group
    int t = blockIdx.x, acc = 0;
    for (int i = 0; i < p.groups; ++i) {
      const int a = p.off[i], b = p.off[i + 1];
      const int nt = (b - a + BM - 1) / BM;
      if (t < acc + nt) {
        g = i;
        row0 = a + (t - acc) * BM;
        row_end = min(b, row0 + BM);
        break;
      }
      acc += nt;
    }
    if (g < 0) {  // past the groups: zero the rows of no group, or exit
      const int z0 = p.off[p.groups] + (t - acc) * BM;
      if (z0 < p.rows) zero_rows(p.c, ldc, z0, min(z0 + BM, p.rows), n0, tid);
      return;
    }
    steps = (MODE == FWD ? p.k : p.n) / BK;
  }

  uint8_t* ta = smem;
  uint8_t* tb = smem + STAGES * TILE_BYTES;
  float acc[2][32];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps)
      load_stage<MODE>(ta + s * TILE_BYTES, tb + s * TILE_BYTES, p, g, row0, row_end, m0, n0, s,
                       tid);
    cp_async_commit();
  }
  for (int kt = 0; kt < steps; ++kt) {
    cp_async_wait<STAGES - 2>();
    fence_proxy_async();
    __syncthreads();
    const int st = kt % STAGES;
    wgmma_fence();
    mma_stage<MODE>(acc, ta + st * TILE_BYTES, tb + st * TILE_BYTES, wg);
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done ...
    __syncthreads();  // ... in both warpgroups: its buffers may be refilled
    const int nxt = kt + STAGES - 1;
    if (nxt < steps)
      load_stage<MODE>(ta + (nxt % STAGES) * TILE_BYTES, tb + (nxt % STAGES) * TILE_BYTES, p, g,
                       row0, row_end, m0, n0, nxt, tid);
    cp_async_commit();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < 2; ++j) fence_regs(acc[j]);

  // epilogue: accumulator element (row w*16 + l/4 (+8), column 8i + 2(l%4) (+1))
  const int t = tid & 127, warp = t >> 5, lane = t & 31;
  __nv_bfloat16* out;
  int limit;
  if constexpr (MODE == DW) {
    out = p.c + ((long long)g * p.n + m0) * p.k + n0;
    limit = BM;
  } else {
    out = p.c + (long long)row0 * ldc + n0;
    limit = row_end - row0;
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = j * 64 + i * 8 + (lane & 3) * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wg * 64 + warp * 16 + (lane >> 2) + h * 8;
        if (row < limit)
          *reinterpret_cast<__nv_bfloat162*>(out + row * ldc + col) =
              __floats2bfloat162_rn(acc[j][i * 4 + h * 2], acc[j][i * 4 + h * 2 + 1]);
      }
    }
  }
}

template <int MODE> cudaError_t launch(const Params& p, cudaStream_t stream) {
  static bool ready = false;
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(moe_gemm_kernel<MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e != cudaSuccess) return e;
    ready = true;
  }
  dim3 grid;
  if (MODE == DW) {
    grid = dim3(p.n / BM, p.k / BN, p.groups);
  } else {
    grid = dim3((p.rows + BM - 1) / BM + p.groups + 1, (MODE == FWD ? p.n : p.k) / BN, 1);
  }
  moe_gemm_kernel<MODE><<<grid, THREADS, SMEM_BYTES, stream>>>(p);
  return cudaGetLastError();
}

// -- the SwiGLU between the products, over the held rows only -------------------
//
// The layer's buffers have the static W·T·k rows, of which the groups hold
// off[G] (about an eighth at the Trinity cell); the plain PyTorch version
// walks every row in f32. These walk the held rows: a block of 8 warps takes
// 8 rows, a warp a row, and a block past off[G] exits (its rows' outputs are
// never read: the products read only group rows). Bound: bytes.

constexpr int ACT_ROWS = 8;

__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  uint4 v;
  uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = pack_bf16x2(f[2 * i], f[2 * i + 1]);
  return v;
}

// a[r] = silu(h[r, :F]) * h[r, F:] * ws[r], bf16, rows r < off[G].
__global__ void __launch_bounds__(32 * ACT_ROWS)
    moe_swiglu_fwd_kernel(const __nv_bfloat16* h, const float* ws, __nv_bfloat16* a,
                          const int* count, int f) {
  const int r = blockIdx.x * ACT_ROWS + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (r >= *count) return;
  const __nv_bfloat16* hr = h + (long long)r * 2 * f;
  const float w = ws[r];
  for (int c = lane * 8; c < f; c += 32 * 8) {
    float g[8], u[8], o[8];
    unpack8(*reinterpret_cast<const uint4*>(hr + c), g);
    unpack8(*reinterpret_cast<const uint4*>(hr + f + c), u);
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = g[i] / (1.f + __expf(-g[i])) * u[i] * w;
    *reinterpret_cast<uint4*>(a + (long long)r * f + c) = pack8(o);
  }
}

// From the forward's h, the weights ws and da = d/d(act · ws) (bf16): dh
// (bf16, [gate | up]), a_w = act · ws (bf16, the down product's input again)
// and dws[r] = sum_j da[r, j] act[r, j] (f32; zero for rows of no group).
__global__ void __launch_bounds__(32 * ACT_ROWS)
    moe_swiglu_bwd_kernel(const __nv_bfloat16* h, const float* ws, const __nv_bfloat16* da,
                          __nv_bfloat16* dh, __nv_bfloat16* a_w, float* dws, const int* count,
                          int rows, int f) {
  const int r = blockIdx.x * ACT_ROWS + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (r >= rows) return;
  if (r >= *count) {
    if (lane == 0) dws[r] = 0.f;
    return;
  }
  const __nv_bfloat16* hr = h + (long long)r * 2 * f;
  const float w = ws[r];
  float sum = 0.f;
  for (int c = lane * 8; c < f; c += 32 * 8) {
    float g[8], u[8], d[8], dg[8], du[8], aw[8];
    unpack8(*reinterpret_cast<const uint4*>(hr + c), g);
    unpack8(*reinterpret_cast<const uint4*>(hr + f + c), u);
    unpack8(*reinterpret_cast<const uint4*>(da + (long long)r * f + c), d);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float sg = 1.f / (1.f + __expf(-g[i]));
      const float act = g[i] * sg * u[i];
      sum += d[i] * act;
      aw[i] = act * w;
      const float dw = d[i] * w;
      dg[i] = dw * u[i] * sg * (1.f + g[i] * (1.f - sg));
      du[i] = dw * g[i] * sg;
    }
    *reinterpret_cast<uint4*>(dh + (long long)r * 2 * f + c) = pack8(dg);
    *reinterpret_cast<uint4*>(dh + (long long)r * 2 * f + f + c) = pack8(du);
    *reinterpret_cast<uint4*>(a_w + (long long)r * f + c) = pack8(aw);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  if (lane == 0) dws[r] = sum;
}

}  // namespace

// The SwiGLU between the products, rows r < off[groups] of `rows`; f a
// multiple of 8. bwd == 0: a = swiglu(h) * ws; bwd != 0: dh, a_w and dws
// from h, ws and da.
extern "C" int dk_moe_swiglu(int bwd, const void* h, const void* ws, const void* da, void* out,
                             void* a_w, void* dws, const void* off, int groups, int rows, int f,
                             void* stream) {
  const int* count = static_cast<const int*>(off) + groups;
  const dim3 grid((rows + ACT_ROWS - 1) / ACT_ROWS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* hp = static_cast<const __nv_bfloat16*>(h);
  if (bwd == 0) {
    moe_swiglu_fwd_kernel<<<grid, 32 * ACT_ROWS, 0, s>>>(
        hp, static_cast<const float*>(ws), static_cast<__nv_bfloat16*>(out), count, f);
  } else {
    moe_swiglu_bwd_kernel<<<grid, 32 * ACT_ROWS, 0, s>>>(
        hp, static_cast<const float*>(ws), static_cast<const __nv_bfloat16*>(da),
        static_cast<__nv_bfloat16*>(out), static_cast<__nv_bfloat16*>(a_w),
        static_cast<float*>(dws), count, rows, f);
  }
  return cudaGetLastError();
}

// mode 0 (FWD): a = x [rows, k], b = w [groups, n, k], c = y [rows, n]
// mode 1 (DX):  a = dy [rows, n], b = w [groups, n, k], c = dx [rows, k]
// mode 2 (DW):  a = dy [rows, n], b = x [rows, k], c = dw [groups, n, k]
// off: int32 [groups + 1] on the device. n and k multiples of 128.
extern "C" int dk_moe_gemm(int mode, const void* a, const void* b, void* c, const void* off,
                           int groups, int rows, int n, int k, void* stream) {
  Params p{static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
           static_cast<__nv_bfloat16*>(c), static_cast<const int*>(off), groups, rows, n, k};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case FWD: return launch<FWD>(p, s);
    case DX: return launch<DX>(p, s);
    case DW: return launch<DW>(p, s);
    default: return cudaErrorInvalidValue;
  }
}
