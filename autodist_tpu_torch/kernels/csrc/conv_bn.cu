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
// not from y after rounding. The wrapper passes W cast to x's dtype in its
// natural [Cin, Cout] layout.
//
// What bounds it on an H100. At ResNet-101's main-path shapes (batch 256,
// e.g. 50176 x 1024 x 256 in bf16) the product is 2 N Cin Cout = 2.6e10 FLOP
// on about 130 MB, 27 us at 989 TFLOP/s against 39 us for the bytes: the
// shapes sit near the ridge, bound by bytes when Cout is small against Cin
// and by operations otherwise. What the design does about that:
//   * the BatchNorm statistics pass over y and the previous BatchNorm's
//     normalize pass over x cost no extra trip through device memory: the
//     prologue runs on the A fragments in registers between shared memory
//     and the tensor cores, and the stats are summed from the accumulator;
//   * bf16 (cb_wgmma_kernel) is warp-specialised like the flash kernels: a
//     producer thread issues TMA copies of x boxes [128 rows x 64 Cin] and W
//     boxes [64 Cin x 64 Cout] (128-byte swizzle) into a ring of stages with
//     full / empty mbarriers, and two consumer warpgroups, 64 rows each,
//     run wgmma products over a 128 x BN output tile. W is read as it lies,
//     an MN-major B operand, so it is never transposed. With a prologue, A
//     comes from registers (read from the swizzled x tile, normalized,
//     rounded); without one, straight from shared memory. Each step's
//     products run while the next stage is read, and a stage is released
//     once the products after it have retired theirs;
//   * x is the large operand: the CTAs that share an x row tile are
//     consecutive in the grid (output-channel tiles innermost), so they run
//     together and x comes from device memory once, not Cout / BN times;
//   * y leaves through shared memory (the ring, once both warpgroups are
//     done with it) and a TMA store, which writes no row past N;
//   * a TPU grid carries s1/s2 in VMEM across its sequential row tiles; CUDA
//     blocks run in no order, so each CTA sums its columns (shuffles over a
//     warp's rows, then the 8 warps in a fixed order in shared memory), writes
//     them to a [row_tiles, Cout] scratch, and a second small kernel sums
//     that scratch over the row tiles in a fixed order. No atomics:
//     deterministic.
//
// f32 runs on the CUDA cores (scalar FMA; the tensor cores would round f32 to
// TF32): a 128 x 128 tile over 256 threads as a 16 x 16 grid, thread (ty, tx)
// owning rows ty + 16 i and columns tx + 16 j (i, j < 8).
//
// Edges: TMA fills rows past N and Cin past the edge with zeros, but the
// prologue would turn a zero into relu(b): the bf16 kernel zeroes those rows
// and Cin columns after the prologue (the f32 kernel stages them as zeros
// after it), so they add nothing to y's sums or to s1/s2. Cout must be a
// multiple of 128 and Cin of 8 (the gate `supports` guarantees both; TMA
// needs 16-byte row strides); x, W, a, b and y must be 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"

// Output channels of the bf16 kernel's tile: 256 where Cout allows it (128
// otherwise), as chip_k4_tiles.py measured faster on an H100; a build may
// set 128 to compare the two on one card.
#ifndef CB_BLOCK_N
#define CB_BLOCK_N 256
#endif

namespace {

using bf16 = __nv_bfloat16;
using sm90::HT;
using sm90::WG;
constexpr int BM = 128;         // rows of an output tile
constexpr int BN = 128;         // output channels of the f32 kernel's tile
constexpr int NTH = 256;        // threads of the f32 kernel
constexpr int FK = 16;          // Cin step of the f32 kernel
constexpr int FP = BM + 4;      // pitch (f32) of its [FK][128] tiles
constexpr int XK = 64;          // Cin step of the bf16 kernel (one 128-byte row)
constexpr uint32_t X_BYTES = BM * XK * 2;   // one x box
constexpr uint32_t AB_BYTES = 2 * XK * 4;   // a and b of one Cin step

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

// Two f32 rounded to bf16 (round to nearest even, as .astype), low half first.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// ---------------------------------------------------------------------------
// bf16: the warp-specialised wgmma kernel. 384 threads: warpgroups 0 and 1
// consume, each owning 64 rows of the CTA's 128 x BN_ output tile; in
// warpgroup 2 one thread issues every TMA copy, and the warpgroup hands its
// registers to the consumers (setmaxnreg 24 / 240). Shared memory: the ring
// (STAGES x [x box, W boxes]), a and b per stage, the stats' partial sums,
// the barriers.
// ---------------------------------------------------------------------------
__host__ __device__ constexpr int wgmma_stages(int bn) { return bn == 256 ? 4 : 6; }
__host__ __device__ constexpr uint32_t ring_bytes(int bn) {
  return wgmma_stages(bn) * (X_BYTES + XK * bn * 2u);
}
constexpr size_t wgmma_smem(int bn) {
  return 1024 + ring_bytes(bn) + wgmma_stages(bn) * AB_BYTES + 2 * 8 * 4u * bn +
         16 * wgmma_stages(bn);
}

// d (64 x N) += A (64 x 16) . B (16 x N), B MN-major in shared memory; A from
// registers or (K-major) from shared memory.
template <int N>
__device__ __forceinline__ void rs_product(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 128) sm90::wgmma_rs_n128(d, a, db, 1);
  else sm90::wgmma_rs_n256(d, a, db, 1);
}
template <int N>
__device__ __forceinline__ void ss_product(float (&d)[N / 2], uint64_t da, uint64_t db) {
  if constexpr (N == 128) sm90::wgmma_ss_mn_n128(d, da, db, 1);
  else sm90::wgmma_ss_mn_n256(d, da, db, 1);
}

template <int BN_, typename TOut, bool PRO>
__global__ void __launch_bounds__(HT, 1)
cb_wgmma_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                const __grid_constant__ CUtensorMap ty, float* __restrict__ part, int relu,
                int want_stats, int n, int cin, int cout) {
  constexpr int STAGES = wgmma_stages(BN_);
  constexpr uint32_t W_BYTES = XK * BN_ * 2;
  constexpr int EL = sizeof(TOut), SC = 128 / EL;   // y: columns of a 128-byte row
  static_assert(BM * BN_ * EL <= ring_bytes(BN_), "y's staging tile must fit in the ring");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm90::align1024(smem_raw);
  const uint32_t base = sm90::smem_u32(smem);
  const uint32_t sab = base + ring_bytes(BN_);   // a, b: [STAGES][2][XK] f32
  float* red = reinterpret_cast<float*>(smem + ring_bytes(BN_) + STAGES * AB_BYTES);  // [2][8][BN_]
  const uint32_t bars = sab + STAGES * AB_BYTES + 2 * 8 * 4 * BN_;   // full[STAGES], empty[STAGES]
  auto sx = [&](int st) { return base + st * X_BYTES; };
  auto sw = [&](int st) { return base + STAGES * X_BYTES + st * W_BYTES; };
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (STAGES + st); };

  // consecutive CTAs share an x row tile: output-channel tiles innermost
  const int n_ct = cout / BN_, rt = blockIdx.x / n_ct, ct = blockIdx.x % n_ct;
  const int r0 = rt * BM, c0 = ct * BN_, n_k = (cin + XK - 1) / XK;
  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      sm90::mbar_init(full(st), 1);
      sm90::mbar_init(empty(st), 2 * WG);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  // the role is warp-uniform to the compiler: setmaxnreg is warpgroup-collective
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / WG, 0);
  if (wg == 2) {   // producer
    sm90::reg_dealloc<24>();
    if (threadIdx.x == 2 * WG) {
      for (int it = 0; it < n_k; ++it) {
        const int st = it % STAGES, k0 = it * XK;
        sm90::mbar_wait(empty(st), ((it / STAGES) & 1) ^ 1);
        sm90::mbar_expect_tx(full(st), X_BYTES + W_BYTES + (PRO ? AB_BYTES : 0));
        sm90::tma_load_2d(sx(st), &tx, full(st), k0, r0);
#pragma unroll
        for (int s = 0; s < BN_ / 64; ++s)
          sm90::tma_load_2d(sw(st) + s * XK * 128, &tw, full(st), c0 + 64 * s, k0);
        if constexpr (PRO) {
          sm90::tma_load_2d(sab + st * AB_BYTES, &ta, full(st), k0, 0);
          sm90::tma_load_2d(sab + st * AB_BYTES + XK * 4, &tb, full(st), k0, 0);
        }
      }
    }
    return;
  }

  // consumers
  sm90::reg_alloc<240>();
  const int tid = threadIdx.x % WG, warp = tid / 32, g = (tid & 31) >> 2, t = tid & 3;
  const int lr = wg * 64 + warp * 16 + g;   // this lane's rows of the tile: lr, lr + 8
  float acc[BN_ / 2];
#pragma unroll
  for (int i = 0; i < BN_ / 2; ++i) acc[i] = 0.f;

  // One Cin step: wait for its stage, issue its four k16 products, then
  // release the stage before it once that step's products have retired.
  auto step = [&](int it, uint32_t(&frag)[4][4], uint32_t(&prev)[4][4]) {
    const int st = it % STAGES, k0 = it * XK;
    sm90::mbar_wait(full(st), (it / STAGES) & 1);
    if constexpr (PRO) {
      const unsigned char* xt = smem + st * X_BYTES;
      const float* as = reinterpret_cast<const float*>(smem + ring_bytes(BN_) + st * AB_BYTES);
      const float* bs = as + XK;
      const bool edge = r0 + BM > n || k0 + XK > cin;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {   // the m64k16 A fragment: rows lr / lr + 8, 2 Cin each
          const int r = lr + 8 * (i & 1), c = 16 * kk + 8 * (i >> 1) + 2 * t;
          const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(xt + sm90::swz<BM>(r, c));
          const float2 av = *reinterpret_cast<const float2*>(as + c);
          const float2 bv = *reinterpret_cast<const float2*>(bs + c);
          float lo = prologue_f(__low2float(v), av.x, bv.x, relu);
          float hi = prologue_f(__high2float(v), av.y, bv.y, relu);
          if (edge && (r0 + r >= n || k0 + c >= cin)) lo = hi = 0.f;   // Cin % 8 == 0: c + 1 too
          frag[kk][i] = pack_bf16(lo, hi);
        }
      sm90::fence_operand(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        rs_product<BN_>(acc, frag[kk], sm90::desc_mn(sw(st) + kk * 2048, XK * 128));
    } else {
      sm90::fence_operand(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ss_product<BN_>(acc, sm90::desc_k(sx(st) + wg * 64 * 128 + kk * 32),
                        sm90::desc_mn(sw(st) + kk * 2048, XK * 128));
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();
    if constexpr (PRO) sm90::fence_operand(prev);
    if (it > 0) sm90::mbar_arrive(empty((it - 1) % STAGES));
  };
  uint32_t fa[4][4], fb[4][4];   // A fragments of alternate steps
  int it = 0;
  for (; it + 1 < n_k; it += 2) {
    step(it, fa, fb);
    step(it + 1, fb, fa);
  }
  if (it < n_k) step(it, fa, fb);
  sm90::wgmma_wait<0>();
  sm90::fence_operand(acc);

  // y: both warpgroups are done with the ring, which now holds each
  // warpgroup's 64 x BN_ rows as 128-byte-wide swizzled slabs
  sm90::named_barrier(1, 2 * WG);
  unsigned char* yt = smem + wg * 64 * BN_ * EL;
  const int yr = warp * 16 + g;
#pragma unroll
  for (int j = 0; j < BN_ / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = yr + 8 * i, c = 8 * j + 2 * t;
      const int off = (c / SC) * 64 * 128 + r * 128 + ((((c % SC) * EL / 16) ^ (r & 7)) << 4) +
                      (c * EL) % 16;
      store2(reinterpret_cast<TOut*>(yt + off), acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
    }
  sm90::fence_async_smem();
  sm90::named_barrier(2 + wg, WG);
  if (tid == 0 && r0 + wg * 64 < n) {
    const uint32_t src = sm90::smem_u32(yt);
#pragma unroll
    for (int s = 0; s < BN_ / SC; ++s)
      sm90::tma_store_2d(&ty, src + s * 64 * 128, c0 + s * SC, r0 + wg * 64);
    sm90::tma_store_wait();
  }
  if (!want_stats) return;

  // s1, s2 of the tile's columns: each lane's two rows, the 8 lanes (g) that
  // share a column by shuffles, then the 8 warps in a fixed order
#pragma unroll
  for (int j = 0; j < BN_ / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float v0 = acc[4 * j + e], v1 = acc[4 * j + 2 + e];
      float s = v0 + v1, q = v0 * v0 + v1 * v1;
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, o);
        q += __shfl_xor_sync(0xffffffffu, q, o);
      }
      if (g == 0) {
        const int w = wg * 4 + warp, c = 8 * j + 2 * t + e;
        red[w * BN_ + c] = s;
        red[(8 + w) * BN_ + c] = q;
      }
    }
  sm90::named_barrier(1, 2 * WG);
  const size_t tiles = gridDim.x / n_ct;
  for (int i = threadIdx.x; i < 2 * BN_; i += 2 * WG) {
    const int k = i / BN_, c = i % BN_;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) v += red[(8 * k + w) * BN_ + c];
    part[((size_t)k * tiles + rt) * cout + c0 + c] = v;
  }
}

// ---------------------------------------------------------------------------
// f32 on the CUDA cores.
// ---------------------------------------------------------------------------
template <typename TOut>
__global__ void __launch_bounds__(NTH)
cb_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ pa, const float* __restrict__ pb, int relu,
              int want_stats, TOut* __restrict__ y, float* __restrict__ part, int n, int cin,
              int cout) {
  __shared__ __align__(16) float as[FK * FP];   // [k][row]
  __shared__ __align__(16) float bs[FK * FP];   // [k][col]
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
    // 128 rows x 16 k of x, stored k-major, and W rows [k0, k0 + 16) x the
    // tile's 128 columns, as they lie: one 4-float load of each per pass,
    // both in flight together
    static_assert(BM * (FK / 4) == FK * (BN / 4), "one pass stages both tiles");
    for (int idx = threadIdx.x; idx < BM * (FK / 4); idx += NTH) {
      const int r = idx / (FK / 4), c = (idx % (FK / 4)) * 4;
      const int gk = k0 + c;
      const int kw = idx / (BN / 4), cw = (idx % (BN / 4)) * 4;
      float4 u = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + kw < cin)
        u = *reinterpret_cast<const float4*>(w + (size_t)(k0 + kw) * cout + c0 + cw);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gk < cin && r0 + r < n) {
        v = *reinterpret_cast<const float4*>(x + (size_t)(r0 + r) * cin + gk);
        if (pa != nullptr) {
          v.x = prologue_f(v.x, __ldg(pa + gk), __ldg(pb + gk), relu);
          v.y = prologue_f(v.y, __ldg(pa + gk + 1), __ldg(pb + gk + 1), relu);
          v.z = prologue_f(v.z, __ldg(pa + gk + 2), __ldg(pb + gk + 2), relu);
          v.w = prologue_f(v.w, __ldg(pa + gk + 3), __ldg(pb + gk + 3), relu);
        }
      }
      as[(c + 0) * FP + r] = v.x;
      as[(c + 1) * FP + r] = v.y;
      as[(c + 2) * FP + r] = v.z;
      as[(c + 3) * FP + r] = v.w;
      *reinterpret_cast<float4*>(bs + kw * FP + cw) = u;
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

constexpr int block_n(int cout) { return CB_BLOCK_N == 256 && cout % 256 == 0 ? 256 : 128; }

template <int BN_, typename TOut, bool PRO>
cudaError_t run_wgmma(const void* x, const void* w, const void* a, const void* b, int relu,
                      int want_stats, void* y, void* part, int n, int cin, int cout,
                      cudaStream_t st) {
  constexpr CUtensorMapDataType BF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  constexpr CUtensorMapDataType F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  constexpr int EL = sizeof(TOut);
  CUtensorMap tx, tw, ty, ta, tb;
  if (!sm90::matrix_map(&tx, BF16, 2, x, n, cin, BM, XK, true) ||
      !sm90::matrix_map(&tw, BF16, 2, w, cin, cout, XK, 64, true) ||
      !sm90::matrix_map(&ty, EL == 2 ? BF16 : F32, EL, y, n, cout, 64, 128 / EL, true))
    return cudaErrorInvalidValue;
  if (PRO) {
    if (!sm90::matrix_map(&ta, F32, 4, a, 1, cin, 1, XK, false) ||
        !sm90::matrix_map(&tb, F32, 4, b, 1, cin, 1, XK, false))
      return cudaErrorInvalidValue;
  } else {
    ta = tb = tx;   // not read
  }
  auto kernel = cb_wgmma_kernel<BN_, TOut, PRO>;
  cudaError_t err = sm90::check_registers(kernel);
  if (err != cudaSuccess) return err;
  const size_t smem = wgmma_smem(BN_);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles = (n + BM - 1) / BM;
  kernel<<<tiles * (cout / BN_), HT, smem, st>>>(tx, tw, ta, tb, ty, (float*)part, relu,
                                                 want_stats, n, cin, cout);
  return cudaGetLastError();
}

template <typename TOut>
cudaError_t run_bf16(const void* x, const void* w, const void* a, const void* b, int relu,
                     int want_stats, void* y, void* part, int n, int cin, int cout,
                     cudaStream_t st) {
  if (block_n(cout) == 256)
    return a ? run_wgmma<256, TOut, true>(x, w, a, b, relu, want_stats, y, part, n, cin, cout, st)
             : run_wgmma<256, TOut, false>(x, w, a, b, relu, want_stats, y, part, n, cin, cout, st);
  return a ? run_wgmma<128, TOut, true>(x, w, a, b, relu, want_stats, y, part, n, cin, cout, st)
           : run_wgmma<128, TOut, false>(x, w, a, b, relu, want_stats, y, part, n, cin, cout, st);
}

template <typename TIn, typename TOut>
cudaError_t run(const void* x, const void* w, const void* a, const void* b, int relu,
                int want_stats, void* y, void* part, void* s, int n, int cin, int cout,
                cudaStream_t st) {
  const int tiles = (n + BM - 1) / BM;
  cudaError_t err;
  if constexpr (std::is_same<TIn, bf16>::value) {
    err = run_bf16<TOut>(x, w, a, b, relu, want_stats, y, part, n, cin, cout, st);
  } else {
    cb_f32_kernel<TOut><<<dim3(tiles, cout / BN), NTH, 0, st>>>(
        (const float*)x, (const float*)w, (const float*)a, (const float*)b, relu, want_stats,
        (TOut*)y, (float*)part, n, cin, cout);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess || !want_stats) return err;
  cb_stats_kernel<<<dim3(cout / 32, 2), NTH, 0, st>>>((const float*)part, (float*)s, tiles, cout);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Plain C entry, loaded with ctypes; returns the launches' cudaError_t.
// dtype codes: 0 = f32, 1 = bf16. a and b are f32 [Cin] or null (no
// prologue); w is W [Cin, Cout] in x's dtype; part is f32
// [2][ceil(n / 128)][Cout] scratch and s f32 [2][Cout] (s1 then s2), both
// unused when want_stats is 0.
int cb_fwd(int in_dtype, int out_dtype, const void* x, const void* w, const void* a,
           const void* b, int prologue, int relu, int want_stats, void* y, void* part, void* s,
           int n, int cin, int cout, void* stream) {
  (void)cudaGetLastError();
  if (n <= 0) return (int)cudaSuccess;
  if (cin <= 0 || cin % 8 || cout <= 0 || cout % BN) return (int)cudaErrorInvalidValue;
  if (!prologue) a = b = nullptr;
  cudaStream_t st = (cudaStream_t)stream;
  if (in_dtype == 1 && out_dtype == 1)
    return (int)run<bf16, bf16>(x, w, a, b, relu, want_stats, y, part, s, n, cin, cout, st);
  if (in_dtype == 1 && out_dtype == 0)
    return (int)run<bf16, float>(x, w, a, b, relu, want_stats, y, part, s, n, cin, cout, st);
  if (in_dtype == 0 && out_dtype == 0)
    return (int)run<float, float>(x, w, a, b, relu, want_stats, y, part, s, n, cin, cout, st);
  if (in_dtype == 0 && out_dtype == 1)
    return (int)run<float, bf16>(x, w, a, b, relu, want_stats, y, part, s, n, cin, cout, st);
  return (int)cudaErrorInvalidValue;
}

// Output channels of the bf16 kernel's tile at this Cout, and the dynamic
// shared-memory bytes of the kernel with that tile.
int cb_block_n(int cout) { return block_n(cout); }
int cb_wgmma_smem(int cout) { return (int)wgmma_smem(block_n(cout)); }

}  // extern "C"
