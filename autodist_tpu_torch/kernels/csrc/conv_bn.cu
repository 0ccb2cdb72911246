// Fused pointwise conv + BatchNorm for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel autodist_tpu/kernels/conv_bn.py:_kernel
// (launched by _fwd_call; public entry fused_pointwise). It computes, for
// x [N, Cin] (NHWC flattened after the stride subsample) and W [Cin, Cout]:
//   xn = relu?(x * a + b)   per Cin, in f32, rounded to x's dtype (prologue;
//                           only when a/b are given)
//   acc = xn . W            f32 sums
//   y = acc in out_dtype;   s1 = sum_rows acc, s2 = sum_rows acc^2 per Cout,
//                           in f32 from the accumulator (epilogue)
// with the Pallas kernel's cast points: the prologue rounds exactly where
// `xn.astype(x_ref.dtype)` does, and the stats come from the f32 accumulator,
// not from y after rounding. The wrapper passes W already cast to x's dtype
// and transposed to [Cout, Cin], so both operand tiles are read along Cin.
//
// What bounds it on an H100. At ResNet-101's main-path shapes (batch 256,
// e.g. 50176 x 1024 x 256 in bf16) the product is 2 N Cin Cout = 2.6e10 FLOP
// on about 130 MB, 27 us at 989 TFLOP/s against 39 us for the bytes: the
// shapes sit near the ridge, bound by bytes when Cout is small against Cin
// and by operations otherwise. What the design does about that:
//   * the BatchNorm statistics pass over y and the previous BatchNorm's
//     normalize pass over x cost no extra trip through device memory: the
//     prologue runs while an x tile is staged into shared memory, and the
//     stats are summed from the accumulator registers in the epilogue;
//   * bf16 runs on the tensor cores (mma.sync m16n8k16, f32 sums);
//   * a TPU grid carries s1/s2 in VMEM across its sequential row tiles; CUDA
//     blocks run in no order, so each CTA owns one 128 x 128 output tile and
//     loops over Cin, writes its per-column partial sums to a
//     [row_tiles, Cout] scratch, and a second small kernel sums that scratch
//     over the row tiles in a fixed order. No atomics: deterministic.
// It is still a simple design: tiles are staged with plain 16-byte loads and
// waited for (no copy/compute overlap), and the prologue re-reads a and b per
// element from the cache. wgmma, TMA staging and pipelining are the next steps
// toward the bound; they change no arithmetic contract above.
//
// f32 runs on the CUDA cores (scalar FMA; the tensor cores would round f32 to
// TF32): a 128 x 128 tile over 256 threads as a 16 x 16 grid, thread (ty, tx)
// owning rows ty + 16 i and columns tx + 16 j (i, j < 8).
//
// Edges: rows past N and Cin past the K step are staged as zeros (after the
// prologue, so relu(b) never leaks in); their products are exact zeros and add
// nothing to s1/s2. Cout must be a multiple of 128 and Cin of 8 (the gate
// `supports` guarantees both); x and W must be 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
constexpr int BM = 128;         // rows of an output tile
constexpr int BN = 128;         // output channels of an output tile
constexpr int NTH = 256;        // threads of a CTA
constexpr int BK = 32;          // Cin step of the tensor-core kernel
constexpr int AP = BK + 8;      // pitch (bf16) of its [128][BK] tiles: 20 words
constexpr int FK = 16;          // Cin step of the f32 kernel
constexpr int FP = BM + 4;      // pitch (f32) of its [FK][128] tiles

// The prologue on one element, f32 with separate rounding of the product and
// the sum (as the reference's two f32 ops; no contraction to an FMA).
__device__ __forceinline__ float prologue_f(float v, float a, float b, int relu) {
  const float f = __fadd_rn(__fmul_rn(v, a), b);
  return relu ? fmaxf(f, 0.f) : f;
}

__device__ __forceinline__ void store2(bf16* dst, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(lo, hi);
}
__device__ __forceinline__ void store2(float* dst, float lo, float hi) {
  *reinterpret_cast<float2*>(dst) = make_float2(lo, hi);
}
__device__ __forceinline__ void store1(bf16* dst, float v) { *dst = __float2bfloat16(v); }
__device__ __forceinline__ void store1(float* dst, float v) { *dst = v; }

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage a [128][BK] bf16 tile of rows [r0, r0 + 128) x Cin [k0, k0 + BK) of a
// row-major [rows, cin] matrix into shared memory (pitch AP), 16 bytes per
// load, zero past `rows` or `cin`; the prologue, when given, is applied on the
// way in and rounded back to bf16.
__device__ __forceinline__ void stage_bf16(bf16* dst, const bf16* src, int r0, int rows, int k0,
                                           int cin, const float* pa, const float* pb,
                                           int relu) {
  for (int idx = threadIdx.x; idx < BM * (BK / 8); idx += NTH) {
    const int r = idx / (BK / 8), c = (idx % (BK / 8)) * 8;
    const int gr = r0 + r, gk = k0 + c;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (gr < rows && gk < cin) {
      v = *reinterpret_cast<const uint4*>(src + (size_t)gr * cin + gk);
      if (pa != nullptr) {
        bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          e[j] = __float2bfloat16(
              prologue_f(__bfloat162float(e[j]), __ldg(pa + gk + j), __ldg(pb + gk + j), relu));
      }
    }
    *reinterpret_cast<uint4*>(dst + r * AP + c) = v;
  }
}

// ---------------------------------------------------------------------------
// bf16: 8 warps as 4 (rows) x 2 (columns); warp (wm, wn) owns rows
// 32 wm .. 32 wm + 31 and columns 64 wn .. 64 wn + 63 of the tile, i.e. 2 x 8
// m16n8 accumulators. In the m16n8k16 fragments, lane = 4 g + t: a C fragment
// holds rows g and g + 8, columns 2 t and 2 t + 1 of an 8-column tile.
// ---------------------------------------------------------------------------
template <typename TOut>
__global__ void __launch_bounds__(NTH)
cb_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wt,
              const float* __restrict__ pa, const float* __restrict__ pb, int relu,
              int want_stats, TOut* __restrict__ y, float* __restrict__ part, int n, int cin,
              int cout) {
  __shared__ __align__(16) bf16 as[BM * AP];
  __shared__ __align__(16) bf16 bs[BN * AP];
  __shared__ float red[2][4][BN];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
  const int r0 = blockIdx.x * BM, c0 = blockIdx.y * BN;

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.f;

  const uint32_t* aw = reinterpret_cast<const uint32_t*>(as);
  const uint32_t* bw = reinterpret_cast<const uint32_t*>(bs);
  for (int k0 = 0; k0 < cin; k0 += BK) {
    __syncthreads();  // the previous step's fragment reads are done
    stage_bf16(as, x, r0, n, k0, cin, pa, pb, relu);
    stage_bf16(bs, wt + (size_t)c0 * cin, 0, BN, k0, cin, nullptr, nullptr, 0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK / 2; kk += 8) {   // kk: word offset of a k16 step
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const uint32_t* p = aw + (wm * 32 + mi * 16 + g) * (AP / 2) + kk + t;
        af[mi][0] = p[0];
        af[mi][1] = p[8 * (AP / 2)];
        af[mi][2] = p[4];
        af[mi][3] = p[8 * (AP / 2) + 4];
      }
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const uint32_t* p = bw + (wn * 64 + ni * 8 + g) * (AP / 2) + kk + t;
        const uint32_t b0 = p[0], b1 = p[4];
        mma16816(acc[0][ni], af[0], b0, b1);
        mma16816(acc[1][ni], af[1], b0, b1);
      }
    }
  }

  // epilogue: y, then the per-column partial sums of this tile
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int r_lo = r0 + wm * 32 + mi * 16 + g;
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const int c = c0 + wn * 64 + ni * 8 + 2 * t;
      if (r_lo < n) store2(y + (size_t)r_lo * cout + c, acc[mi][ni][0], acc[mi][ni][1]);
      if (r_lo + 8 < n) store2(y + (size_t)(r_lo + 8) * cout + c, acc[mi][ni][2], acc[mi][ni][3]);
    }
  }
  if (!want_stats) return;
#pragma unroll
  for (int ni = 0; ni < 8; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float s = 0.f, q = 0.f;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float v = acc[mi][ni][2 * h + j];
          s += v;
          q += v * v;
        }
      // sum over the 8 lanes (g) that share this column, fixed pattern
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, o);
        q += __shfl_xor_sync(0xffffffffu, q, o);
      }
      if (g == 0) {
        red[0][wm][wn * 64 + ni * 8 + 2 * t + j] = s;
        red[1][wm][wn * 64 + ni * 8 + 2 * t + j] = q;
      }
    }
  __syncthreads();
  const size_t tiles = gridDim.x;
  for (int i = threadIdx.x; i < 2 * BN; i += NTH) {
    const int k = i / BN, c = i % BN;
    const float v = ((red[k][0][c] + red[k][1][c]) + red[k][2][c]) + red[k][3][c];
    part[((size_t)k * tiles + blockIdx.x) * cout + c0 + c] = v;
  }
}

// ---------------------------------------------------------------------------
// f32 on the CUDA cores.
// ---------------------------------------------------------------------------
template <typename TOut>
__global__ void __launch_bounds__(NTH)
cb_f32_kernel(const float* __restrict__ x, const float* __restrict__ wt,
              const float* __restrict__ pa, const float* __restrict__ pb, int relu,
              int want_stats, TOut* __restrict__ y, float* __restrict__ part, int n, int cin,
              int cout) {
  __shared__ float as[FK * FP];   // [k][row]
  __shared__ float bs[FK * FP];   // [k][col]
  __shared__ float red[2][16][BN];

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int r0 = blockIdx.x * BM, c0 = blockIdx.y * BN;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < cin; k0 += FK) {
    __syncthreads();
    // 128 rows x 16 k of x and of W^T, 4 floats per load, stored k-major
    for (int idx = threadIdx.x; idx < BM * (FK / 4); idx += NTH) {
      const int r = idx / (FK / 4), c = (idx % (FK / 4)) * 4;
      const int gk = k0 + c;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 u = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gk < cin) {
        if (r0 + r < n) {
          v = *reinterpret_cast<const float4*>(x + (size_t)(r0 + r) * cin + gk);
          if (pa != nullptr) {
            v.x = prologue_f(v.x, __ldg(pa + gk), __ldg(pb + gk), relu);
            v.y = prologue_f(v.y, __ldg(pa + gk + 1), __ldg(pb + gk + 1), relu);
            v.z = prologue_f(v.z, __ldg(pa + gk + 2), __ldg(pb + gk + 2), relu);
            v.w = prologue_f(v.w, __ldg(pa + gk + 3), __ldg(pb + gk + 3), relu);
          }
        }
        u = *reinterpret_cast<const float4*>(wt + (size_t)(c0 + r) * cin + gk);
      }
      as[(c + 0) * FP + r] = v.x;
      as[(c + 1) * FP + r] = v.y;
      as[(c + 2) * FP + r] = v.z;
      as[(c + 3) * FP + r] = v.w;
      bs[(c + 0) * FP + r] = u.x;
      bs[(c + 1) * FP + r] = u.y;
      bs[(c + 2) * FP + r] = u.z;
      bs[(c + 3) * FP + r] = u.w;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FK; ++k) {
      float av[8], bv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = as[k * FP + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = bs[k * FP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) store1(y + (size_t)r * cout + c0 + tx + 16 * j, acc[i][j]);
  }
  if (!want_stats) return;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float s = 0.f, q = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s += acc[i][j];
      q += acc[i][j] * acc[i][j];
    }
    red[0][ty][tx + 16 * j] = s;
    red[1][ty][tx + 16 * j] = q;
  }
  __syncthreads();
  const size_t tiles = gridDim.x;
  for (int i = threadIdx.x; i < 2 * BN; i += NTH) {
    const int k = i / BN, c = i % BN;
    float v = 0.f;
#pragma unroll
    for (int r = 0; r < 16; ++r) v += red[k][r][c];
    part[((size_t)k * tiles + blockIdx.x) * cout + c0 + c] = v;
  }
}

// s[k][c] = sum over row tiles of part[k][tile][c], k in {0: s1, 1: s2}: 32
// columns x 8 row groups a CTA; each group sums tiles g, g + 8, ... in order,
// then the 8 group sums add in order. Deterministic.
__global__ void __launch_bounds__(NTH)
cb_stats_kernel(const float* __restrict__ part, float* __restrict__ s, int tiles, int cout) {
  __shared__ float red[8][33];
  const int cx = threadIdx.x % 32, grp = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + cx;
  const float* p = part + (size_t)blockIdx.y * tiles * cout;
  float v = 0.f;
  for (int r = grp; r < tiles; r += 8) v += p[(size_t)r * cout + c];
  red[grp][cx] = v;
  __syncthreads();
  if (grp == 0) {
    float tot = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) tot += red[i][cx];
    s[(size_t)blockIdx.y * cout + c] = tot;
  }
}

template <typename TIn, typename TOut>
cudaError_t run(const void* x, const void* wt, const void* a, const void* b, int relu,
                int want_stats, void* y, void* part, void* s, int n, int cin, int cout,
                cudaStream_t st) {
  const int tiles = (n + BM - 1) / BM;
  const dim3 grid(tiles, cout / BN);
  if constexpr (std::is_same<TIn, bf16>::value)
    cb_mma_kernel<TOut><<<grid, NTH, 0, st>>>((const bf16*)x, (const bf16*)wt, (const float*)a,
                                               (const float*)b, relu, want_stats, (TOut*)y,
                                               (float*)part, n, cin, cout);
  else
    cb_f32_kernel<TOut><<<grid, NTH, 0, st>>>((const float*)x, (const float*)wt, (const float*)a,
                                               (const float*)b, relu, want_stats, (TOut*)y,
                                               (float*)part, n, cin, cout);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !want_stats) return err;
  cb_stats_kernel<<<dim3(cout / 32, 2), NTH, 0, st>>>((const float*)part, (float*)s, tiles, cout);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry, loaded with ctypes; returns the launches' cudaError_t.
// dtype codes: 0 = f32, 1 = bf16. a and b are f32 [Cin] or null (no
// prologue); wt is W^T [Cout, Cin] in x's dtype; part is f32
// [2][ceil(n / 128)][Cout] scratch and s f32 [2][Cout] (s1 then s2), both
// unused when want_stats is 0.
extern "C" int cb_fwd(int in_dtype, int out_dtype, const void* x, const void* wt, const void* a,
                      const void* b, int prologue, int relu, int want_stats, void* y, void* part,
                      void* s, int n, int cin, int cout, void* stream) {
  (void)cudaGetLastError();
  if (n <= 0) return (int)cudaSuccess;
  if (cin <= 0 || cin % 8 || cout <= 0 || cout % BN) return (int)cudaErrorInvalidValue;
  if (!prologue) a = b = nullptr;
  cudaStream_t st = (cudaStream_t)stream;
  if (in_dtype == 1 && out_dtype == 1)
    return (int)run<bf16, bf16>(x, wt, a, b, relu, want_stats, y, part, s, n, cin, cout, st);
  if (in_dtype == 1 && out_dtype == 0)
    return (int)run<bf16, float>(x, wt, a, b, relu, want_stats, y, part, s, n, cin, cout, st);
  if (in_dtype == 0 && out_dtype == 0)
    return (int)run<float, float>(x, wt, a, b, relu, want_stats, y, part, s, n, cin, cout, st);
  if (in_dtype == 0 && out_dtype == 1)
    return (int)run<float, bf16>(x, wt, a, b, relu, want_stats, y, part, s, n, cin, cout, st);
  return (int)cudaErrorInvalidValue;
}
