// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV kernels.
//
// Replaces the three Pallas TPU kernels of autodist_tpu/kernels/flash_attention.py:
//   fwd_wgmma_kernel (bf16, D 64/128/256), fwd_mma_kernel (bf16, D 16/32),
//   fwd_kernel (f32, D <= 256), fwd_wgmma_cols_kernel (bf16, D > 256),
//   fwd_cols_kernel (f32, D > 256)                             <- _fwd_kernel
//   dq_wgmma_kernel (bf16, D 64/128/256), dq_mma_kernel (bf16, D 16/32),
//   dq_kernel (f32, D <= 256), dq_wgmma_cols_kernel (bf16, D > 256),
//   dq_cols_kernel (f32, D > 256)                              <- _dq_kernel
//   dkv_wgmma_kernel (bf16, D 64/128/256), dkv_mma_kernel (bf16, D 16/32),
//   dkv_kernel (f32, D <= 256), dkv_wgmma_cols_kernel (bf16, D > 256),
//   dkv_cols_kernel (f32, D > 256)                             <- _dkv_kernel
// and computes what they compute, with the same constants (mask value -1e30,
// l floored at 1e-30) and the same cast points: P is rounded to v's dtype
// before P.V, dS to k's dtype before dS.K and to q's dtype before dS^T.Q, and
// P to dO's dtype before P^T.dO. All sums are f32. Which kernel runs is a
// rule of kernel, dtype and head dim (route()), fixed before the launch and
// read by the launchers (run_fwd / run_dq / run_dkv) and by fa_kernel_name.
//
// Layout: q, k, v, o, dO, dq, dk, dv are contiguous [B*H, S, D]; lse and delta
// are f32 [B*H, S]. Causal masking is by global position (q_pos >= k_pos
// kept); rows or columns past S (a ragged edge) are masked and never stored.
//
// What bounds these kernels on an H100. At the gpt_small shape
// (B4 H12 S4096 D64, causal, bf16) the forward does 1.03e11 FLOP on 101 MB, so
// it is bound by operations (0.10 ms at 989 TFLOP/s on the tensor cores
// against 0.03 ms for the bytes); dQ does 1.5x and dK/dV 2x the forward's
// operations. At a fixed H * D the work does not depend on D, so the same
// holds at D = 256. What the design does about that:
//   * bf16 runs on the tensor cores with f32 sums; all three kernels at
//     every D from 64 on as Hopper's warpgroup products (wgmma) fed by TMA
//     through an mbarrier ring, so copies overlap the products and no
//     operand is transposed in software (wgmma reads a tile MN-major
//     through its descriptor);
//   * the [S, S] score matrix never touches device memory: a CTA owns an
//     output tile and loops over the other operand's tiles, as the TPU grid's
//     sequential axis did, keeping its running sums in registers;
//   * causal tiles above the diagonal are skipped (the loop ends, or starts,
//     at the diagonal), which halves the work at long S, and the CTAs with
//     the most causal work are scheduled first;
//   * each CTA owns its output tile outright, so no atomics and no second
//     pass: results are deterministic, bit for bit (dQ has its own kernel,
//     not atomic adds from the dK/dV kernel as in FlashAttention-2/3).
//
// f32 runs on the CUDA cores (scalar FMA; the tensor cores would round to
// TF32): 64 query rows x 64 key rows per step, 256 threads as a 16 x 16 grid.
// Thread (ty, tx) owns score rows ty + 16 i and columns tx + 16 j (i, j < 4),
// and output columns tx + 16 jd (jd < D / 16). The 16 threads that share a
// score row are one half-warp, so row max and row sum are shuffles. Shared
// tiles are stored as f32 with a row pitch of D + 1 words (no bank conflicts
// on the strided reads). At D = 256 the four f32 tiles of dQ and dK/dV
// (257 KB at 64 rows) do not fit an SM's 227 KB of shared memory, so the
// query tile shrinks to QT = 32 rows there (q_tile).
//
// Above D = 256 no tile of D fits: not wgmma's N (at most 256), not a
// thread's 255 registers, not 227 KB of shared memory. There the kernels
// split the output columns into chunks over a third grid axis: each CTA
// streams the reductions over D (S = Q.K^T, dP = dO.V^T) through shared
// memory in 64-wide slices and recomputes the scores for its own column
// chunk; only chunk 0 writes LSE. The bf16 kernels do it on the tensor cores
// in chunks of 256 (*_wgmma_cols_kernel: the score work ceil(D / 256) times,
// 2x at D = 320 and 384), the f32 kernels on the CUDA cores in chunks of 128
// (*_cols_kernel: ceil(D / 128) times, 3x at D = 320 and 384). The bf16
// kernels' layout is described where they are defined. Supported: f32 and
// bf16, D in {16, 32, 64, 128, 256} and every multiple of 64 above 256; the
// wrapper zero-pads any other D to the next of these.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"

namespace {

constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // key/value rows per tile
constexpr int TX = 16;
constexpr int TY = 16;
constexpr int NT = TX * TY;     // threads per CTA
constexpr int RPT = BQ / TY;    // score rows per thread
constexpr int CPT = BK / TX;    // score columns per thread
constexpr int PP = BK + 1;      // row pitch of the [64, 64] score tiles
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The TPU kernel's .astype(dtype) before a product: round to T, keep as f32.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// Stage rows [row0, row0 + ROWS) of a [S, D] slab into shared memory as f32,
// row pitch D + 1, zero past S.
template <typename T, int D, int ROWS = 64>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0, int S) {
  for (int idx = threadIdx.x; idx < ROWS * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    const int g = row0 + r;
    dst[r * (D + 1) + c] = g < S ? to_f(src[(size_t)g * D + c]) : 0.f;
  }
}

// Stage `rows` entries of a per-row f32 vector (lse, delta), zero past S.
__device__ __forceinline__ void load_rows(float* dst, const float* src, int row0, int S,
                                          int rows = 64) {
  for (int r = threadIdx.x; r < rows; r += NT) dst[r] = row0 + r < S ? src[row0 + r] : 0.f;
}

// Reductions over the 16 lanes of a half-warp (the threads sharing a row).
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ bool live(int qpos, int kpos, int S, int causal) {
  return qpos < S && kpos < S && (!causal || qpos >= kpos);
}

// ---------------------------------------------------------------------------
// forward: one CTA per (b*h, QT-row q tile); loops over kv tiles up to the
// diagonal when causal; online softmax state per row in registers.
// ---------------------------------------------------------------------------
template <typename T, int D, int QT>
__global__ void __launch_bounds__(NT)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           T* __restrict__ o, float* __restrict__ lse, int S, float scale, int causal) {
  constexpr int LD = D + 1;
  constexpr int DPT = D / TX;
  constexpr int R = QT / TY;   // score rows per thread
  extern __shared__ float smem[];
  float* qs = smem;            // [QT][LD]
  float* ks = qs + QT * LD;    // [64][LD]
  float* vs = ks + BK * LD;    // [64][LD]
  float* ps = vs + BK * LD;    // [QT][PP]

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int q0 = blockIdx.x * QT;
  const size_t base = (size_t)blockIdx.y * S * D;
  q += base; k += base; v += base; o += base;
  lse += (size_t)blockIdx.y * S;

  load_tile<T, D, QT>(qs, q, q0, S);

  float m[R], l[R], acc[R][DPT];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int jd = 0; jd < DPT; ++jd) acc[i][jd] = 0.f;
  }

  const int kv_end = causal ? min(S, q0 + QT) : S;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile's ks / vs / ps reads are done
    load_tile<T, D>(ks, k, k0, S);
    load_tile<T, D>(vs, v, k0, S);
    __syncthreads();

    float s[R][CPT];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float a[R], b[CPT];
#pragma unroll
      for (int i = 0; i < R; ++i) a[i] = qs[(ty + TY * i) * LD + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) b[j] = ks[(tx + TX * j) * LD + d];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = ty + TY * i;
      float mb = NEG_INF;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float x = live(q0 + r, k0 + tx + TX * j, S, causal) ? s[i][j] * scale : NEG_INF;
        s[i][j] = x;
        mb = fmaxf(mb, x);
      }
      const float mn = fmaxf(m[i], half_warp_max(mb));
      const float alpha = expf(m[i] - mn);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = expf(s[i][j] - mn);
        rs += p;
        ps[r * PP + tx + TX * j] = round_to<T>(p);
      }
      l[i] = alpha * l[i] + half_warp_sum(rs);
      m[i] = mn;
#pragma unroll
      for (int jd = 0; jd < DPT; ++jd) acc[i][jd] *= alpha;
    }
    __syncthreads();

    for (int kk = 0; kk < BK; ++kk) {
      float b[DPT];
#pragma unroll
      for (int jd = 0; jd < DPT; ++jd) b[jd] = vs[kk * LD + tx + TX * jd];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float p = ps[(ty + TY * i) * PP + kk];
#pragma unroll
        for (int jd = 0; jd < DPT; ++jd) acc[i][jd] = fmaf(p, b[jd], acc[i][jd]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qpos = q0 + ty + TY * i;
    if (qpos >= S) continue;
    const float li = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jd = 0; jd < DPT; ++jd)
      o[(size_t)qpos * D + tx + TX * jd] = from_f<T>(acc[i][jd] / li);
    if (tx == 0) lse[qpos] = m[i] + logf(li);
  }
}

// ---------------------------------------------------------------------------
// dQ: one CTA per (b*h, QT-row q tile); loops over kv tiles up to the diagonal.
// P = exp(S - lse); dS = P * (dP - delta) * scale, rounded to k's dtype;
// dQ = sum dS.K.
// ---------------------------------------------------------------------------
template <typename T, int D, int QT>
__global__ void __launch_bounds__(NT)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, T* __restrict__ dq, int S, float scale,
          int causal) {
  constexpr int LD = D + 1;
  constexpr int DPT = D / TX;
  constexpr int R = QT / TY;    // score rows per thread
  extern __shared__ float smem[];
  float* qs = smem;             // [QT][LD]
  float* dos = qs + QT * LD;    // [QT][LD]
  float* ks = dos + QT * LD;    // [64][LD]
  float* vs = ks + BK * LD;     // [64][LD]
  float* dss = vs + BK * LD;    // [QT][PP]
  float* lse_s = dss + QT * PP; // [QT]
  float* delta_s = lse_s + QT;  // [QT]

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int q0 = blockIdx.x * QT;
  const size_t base = (size_t)blockIdx.y * S * D;
  q += base; k += base; v += base; dout += base; dq += base;
  lse += (size_t)blockIdx.y * S;
  delta += (size_t)blockIdx.y * S;

  load_tile<T, D, QT>(qs, q, q0, S);
  load_tile<T, D, QT>(dos, dout, q0, S);
  load_rows(lse_s, lse, q0, S, QT);
  load_rows(delta_s, delta, q0, S, QT);

  float acc[R][DPT];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int jd = 0; jd < DPT; ++jd) acc[i][jd] = 0.f;

  const int kv_end = causal ? min(S, q0 + QT) : S;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();
    load_tile<T, D>(ks, k, k0, S);
    load_tile<T, D>(vs, v, k0, S);
    __syncthreads();

    float s[R][CPT], dp[R][CPT];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float a[R], g[R], b[CPT], c[CPT];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        a[i] = qs[(ty + TY * i) * LD + d];
        g[i] = dos[(ty + TY * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        b[j] = ks[(tx + TX * j) * LD + d];
        c[j] = vs[(tx + TX * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          s[i][j] = fmaf(a[i], b[j], s[i][j]);
          dp[i][j] = fmaf(g[i], c[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = ty + TY * i;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float x = live(q0 + r, k0 + tx + TX * j, S, causal) ? s[i][j] * scale : NEG_INF;
        const float p = expf(x - lse_s[r]);
        dss[r * PP + tx + TX * j] = round_to<T>(p * (dp[i][j] - delta_s[r]) * scale);
      }
    }
    __syncthreads();

    for (int kk = 0; kk < BK; ++kk) {
      float b[DPT];
#pragma unroll
      for (int jd = 0; jd < DPT; ++jd) b[jd] = ks[kk * LD + tx + TX * jd];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float a = dss[(ty + TY * i) * PP + kk];
#pragma unroll
        for (int jd = 0; jd < DPT; ++jd) acc[i][jd] = fmaf(a, b[jd], acc[i][jd]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qpos = q0 + ty + TY * i;
    if (qpos >= S) continue;
#pragma unroll
    for (int jd = 0; jd < DPT; ++jd) dq[(size_t)qpos * D + tx + TX * jd] = from_f<T>(acc[i][jd]);
  }
}

// ---------------------------------------------------------------------------
// dK / dV: one CTA per (b*h, 64-row kv tile); loops over q tiles from the
// diagonal when causal. Thread (ty, tx) holds the transposed scores
// S^T[kv row ty + 16 i][q col tx + 16 j].
// dV += P^T.dO (P rounded to dO's dtype); dK += dS^T.Q (dS rounded to q's).
// ---------------------------------------------------------------------------
template <typename T, int D, int QT>
__global__ void __launch_bounds__(NT)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int S,
           float scale, int causal) {
  constexpr int LD = D + 1;
  constexpr int DPT = D / TX;
  constexpr int QC = QT / TX;    // q columns per thread
  constexpr int QP = QT + 1;     // row pitch of the [64, QT] tiles
  extern __shared__ float smem[];
  float* ks = smem;              // [64][LD]
  float* vs = ks + BK * LD;      // [64][LD]
  float* qs = vs + BK * LD;      // [QT][LD]
  float* dos = qs + QT * LD;     // [QT][LD]
  float* pts = dos + QT * LD;    // [64 kv][QP]
  float* dsts = pts + BK * QP;   // [64 kv][QP]
  float* lse_s = dsts + BK * QP; // [QT]
  float* delta_s = lse_s + QT;   // [QT]

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int k0 = blockIdx.x * BK;
  const size_t base = (size_t)blockIdx.y * S * D;
  q += base; k += base; v += base; dout += base; dk += base; dv += base;
  lse += (size_t)blockIdx.y * S;
  delta += (size_t)blockIdx.y * S;

  load_tile<T, D>(ks, k, k0, S);
  load_tile<T, D>(vs, v, k0, S);

  float acck[RPT][DPT], accv[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int jd = 0; jd < DPT; ++jd) acck[i][jd] = accv[i][jd] = 0.f;

  const int q_start = causal ? (k0 / QT) * QT : 0;
  for (int q0 = q_start; q0 < S; q0 += QT) {
    __syncthreads();
    load_tile<T, D, QT>(qs, q, q0, S);
    load_tile<T, D, QT>(dos, dout, q0, S);
    load_rows(lse_s, lse, q0, S, QT);
    load_rows(delta_s, delta, q0, S, QT);
    __syncthreads();

    float st[RPT][QC], dpt[RPT][QC];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < QC; ++j) st[i][j] = dpt[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float a[RPT], g[RPT], b[QC], c[QC];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        a[i] = ks[(ty + TY * i) * LD + d];
        g[i] = vs[(ty + TY * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < QC; ++j) {
        b[j] = qs[(tx + TX * j) * LD + d];
        c[j] = dos[(tx + TX * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < QC; ++j) {
          st[i][j] = fmaf(a[i], b[j], st[i][j]);
          dpt[i][j] = fmaf(g[i], c[j], dpt[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty + TY * i;
#pragma unroll
      for (int j = 0; j < QC; ++j) {
        const int c = tx + TX * j;
        const float x = live(q0 + c, k0 + r, S, causal) ? st[i][j] * scale : NEG_INF;
        const float p = expf(x - lse_s[c]);
        pts[r * QP + c] = round_to<T>(p);
        dsts[r * QP + c] = round_to<T>(p * (dpt[i][j] - delta_s[c]) * scale);
      }
    }
    __syncthreads();

    for (int qq = 0; qq < QT; ++qq) {
      float bo[DPT], bq[DPT];
#pragma unroll
      for (int jd = 0; jd < DPT; ++jd) {
        bo[jd] = dos[qq * LD + tx + TX * jd];
        bq[jd] = qs[qq * LD + tx + TX * jd];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float p = pts[(ty + TY * i) * QP + qq];
        const float ds = dsts[(ty + TY * i) * QP + qq];
#pragma unroll
        for (int jd = 0; jd < DPT; ++jd) {
          accv[i][jd] = fmaf(p, bo[jd], accv[i][jd]);
          acck[i][jd] = fmaf(ds, bq[jd], acck[i][jd]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int kpos = k0 + ty + TY * i;
    if (kpos >= S) continue;
#pragma unroll
    for (int jd = 0; jd < DPT; ++jd) {
      dk[(size_t)kpos * D + tx + TX * jd] = from_f<T>(acck[i][jd]);
      dv[(size_t)kpos * D + tx + TX * jd] = from_f<T>(accv[i][jd]);
    }
  }
}

// ---------------------------------------------------------------------------
// D > 256: the same three kernels with the output columns split into chunks
// of DC over grid axis z (chunk c owns columns [c DC, c DC + DC) of O, dQ, or
// dK and dV) and D a runtime multiple of DS. The score products stream D in
// DS-wide slices of both operands through shared memory; the operand of the
// output product (V, K, or Q and dO) is staged as the chunk's DC columns.
// The thread layout is that of the kernels above, with DC / 16 output
// columns a thread. A last chunk narrower than DC reads zero columns and
// stores none of them. They run f32 (bf16 above 256 runs the wgmma kernels
// further down).
// ---------------------------------------------------------------------------
constexpr int DS = 64;   // width of a slice of the score products' reduction
static_assert(DS == BK, "the slices share the score tiles' row pitch PP");

// Rows [row0, row0 + ROWS) x columns [c0, c0 + W) of a [S, D] slab into
// shared memory as f32, row pitch W + 1, zero past S and past column `cols`.
template <typename T, int W, int ROWS>
__device__ __forceinline__ void load_cols(float* dst, const T* src, int row0, int S, int D,
                                          int c0, int cols = W) {
  for (int idx = threadIdx.x; idx < ROWS * W; idx += NT) {
    const int r = idx / W, c = idx % W;
    const int g = row0 + r;
    dst[r * (W + 1) + c] = g < S && c < cols ? to_f(src[(size_t)g * D + c0 + c]) : 0.f;
  }
}

template <typename T, int DC, int QT>
__global__ void __launch_bounds__(NT)
fwd_cols_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                T* __restrict__ o, float* __restrict__ lse, int S, int D, float scale,
                int causal) {
  constexpr int DPT = DC / TX;
  constexpr int R = QT / TY;
  extern __shared__ float smem[];
  float* qs = smem;                  // [QT][PP], a DS-wide slice of Q
  float* ks = qs + QT * PP;          // [64][PP], the same slice of K
  float* vs = ks + BK * PP;          // [64][DC + 1], the chunk's columns of V
  float* ps = vs + BK * (DC + 1);    // [QT][PP]

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int q0 = blockIdx.x * QT, c0 = blockIdx.z * DC, cols = min(DC, D - c0);
  const size_t base = (size_t)blockIdx.y * S * D;
  q += base; k += base; v += base; o += base;
  lse += (size_t)blockIdx.y * S;

  float m[R], l[R], acc[R][DPT];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int jd = 0; jd < DPT; ++jd) acc[i][jd] = 0.f;
  }

  const int kv_end = causal ? min(S, q0 + QT) : S;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    float s[R][CPT];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
    for (int d0 = 0; d0 < D; d0 += DS) {
      __syncthreads();  // the previous slice's (and tile's) reads are done
      load_cols<T, DS, QT>(qs, q, q0, S, D, d0);
      load_cols<T, DS, BK>(ks, k, k0, S, D, d0);
      if (d0 == 0) load_cols<T, DC, BK>(vs, v, k0, S, D, c0, cols);
      __syncthreads();
      for (int d = 0; d < DS; ++d) {
        float a[R], b[CPT];
#pragma unroll
        for (int i = 0; i < R; ++i) a[i] = qs[(ty + TY * i) * PP + d];
#pragma unroll
        for (int j = 0; j < CPT; ++j) b[j] = ks[(tx + TX * j) * PP + d];
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = ty + TY * i;
      float mb = NEG_INF;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float x = live(q0 + r, k0 + tx + TX * j, S, causal) ? s[i][j] * scale : NEG_INF;
        s[i][j] = x;
        mb = fmaxf(mb, x);
      }
      const float mn = fmaxf(m[i], half_warp_max(mb));
      const float alpha = expf(m[i] - mn);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = expf(s[i][j] - mn);
        rs += p;
        ps[r * PP + tx + TX * j] = round_to<T>(p);
      }
      l[i] = alpha * l[i] + half_warp_sum(rs);
      m[i] = mn;
#pragma unroll
      for (int jd = 0; jd < DPT; ++jd) acc[i][jd] *= alpha;
    }
    __syncthreads();

    for (int kk = 0; kk < BK; ++kk) {
      float b[DPT];
#pragma unroll
      for (int jd = 0; jd < DPT; ++jd) b[jd] = vs[kk * (DC + 1) + tx + TX * jd];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float p = ps[(ty + TY * i) * PP + kk];
#pragma unroll
        for (int jd = 0; jd < DPT; ++jd) acc[i][jd] = fmaf(p, b[jd], acc[i][jd]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qpos = q0 + ty + TY * i;
    if (qpos >= S) continue;
    const float li = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jd = 0; jd < DPT; ++jd) {
      const int c = tx + TX * jd;
      if (c < cols) o[(size_t)qpos * D + c0 + c] = from_f<T>(acc[i][jd] / li);
    }
    // every chunk computes the same m and l; one of them writes LSE
    if (tx == 0 && blockIdx.z == 0) lse[qpos] = m[i] + logf(li);
  }
}

template <typename T, int DC, int QT>
__global__ void __launch_bounds__(NT)
dq_cols_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dq, int S, int D, float scale,
               int causal) {
  constexpr int DPT = DC / TX;
  constexpr int R = QT / TY;
  extern __shared__ float smem[];
  float* qs = smem;                  // [QT][PP], a DS-wide slice of Q
  float* dos = qs + QT * PP;         // [QT][PP], of dO
  float* ks = dos + QT * PP;         // [64][PP], of K
  float* vs = ks + BK * PP;          // [64][PP], of V
  float* kc = vs + BK * PP;          // [64][DC + 1], the chunk's columns of K
  float* dss = kc + BK * (DC + 1);   // [QT][PP]
  float* lse_s = dss + QT * PP;      // [QT]
  float* delta_s = lse_s + QT;       // [QT]

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int q0 = blockIdx.x * QT, c0 = blockIdx.z * DC, cols = min(DC, D - c0);
  const size_t base = (size_t)blockIdx.y * S * D;
  q += base; k += base; v += base; dout += base; dq += base;
  lse += (size_t)blockIdx.y * S;
  delta += (size_t)blockIdx.y * S;

  load_rows(lse_s, lse, q0, S, QT);
  load_rows(delta_s, delta, q0, S, QT);

  float acc[R][DPT];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int jd = 0; jd < DPT; ++jd) acc[i][jd] = 0.f;

  const int kv_end = causal ? min(S, q0 + QT) : S;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    float s[R][CPT], dp[R][CPT];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d0 = 0; d0 < D; d0 += DS) {
      __syncthreads();
      load_cols<T, DS, QT>(qs, q, q0, S, D, d0);
      load_cols<T, DS, QT>(dos, dout, q0, S, D, d0);
      load_cols<T, DS, BK>(ks, k, k0, S, D, d0);
      load_cols<T, DS, BK>(vs, v, k0, S, D, d0);
      if (d0 == 0) load_cols<T, DC, BK>(kc, k, k0, S, D, c0, cols);
      __syncthreads();
      for (int d = 0; d < DS; ++d) {
        float a[R], g[R], b[CPT], c[CPT];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          a[i] = qs[(ty + TY * i) * PP + d];
          g[i] = dos[(ty + TY * i) * PP + d];
        }
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          b[j] = ks[(tx + TX * j) * PP + d];
          c[j] = vs[(tx + TX * j) * PP + d];
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j) {
            s[i][j] = fmaf(a[i], b[j], s[i][j]);
            dp[i][j] = fmaf(g[i], c[j], dp[i][j]);
          }
      }
    }

#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = ty + TY * i;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float x = live(q0 + r, k0 + tx + TX * j, S, causal) ? s[i][j] * scale : NEG_INF;
        const float p = expf(x - lse_s[r]);
        dss[r * PP + tx + TX * j] = round_to<T>(p * (dp[i][j] - delta_s[r]) * scale);
      }
    }
    __syncthreads();

    for (int kk = 0; kk < BK; ++kk) {
      float b[DPT];
#pragma unroll
      for (int jd = 0; jd < DPT; ++jd) b[jd] = kc[kk * (DC + 1) + tx + TX * jd];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float a = dss[(ty + TY * i) * PP + kk];
#pragma unroll
        for (int jd = 0; jd < DPT; ++jd) acc[i][jd] = fmaf(a, b[jd], acc[i][jd]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qpos = q0 + ty + TY * i;
    if (qpos >= S) continue;
#pragma unroll
    for (int jd = 0; jd < DPT; ++jd) {
      const int c = tx + TX * jd;
      if (c < cols) dq[(size_t)qpos * D + c0 + c] = from_f<T>(acc[i][jd]);
    }
  }
}

template <typename T, int DC, int QT>
__global__ void __launch_bounds__(NT)
dkv_cols_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int S,
                int D, float scale, int causal) {
  constexpr int DPT = DC / TX;
  constexpr int QC = QT / TX;          // q columns per thread
  constexpr int QP = QT + 1;           // row pitch of the [64, QT] tiles
  extern __shared__ float smem[];
  float* ks = smem;                    // [64][PP], a DS-wide slice of K
  float* vs = ks + BK * PP;            // [64][PP], of V
  float* qs = vs + BK * PP;            // [QT][PP], of Q
  float* dos = qs + QT * PP;           // [QT][PP], of dO
  float* qc = dos + QT * PP;           // [QT][DC + 1], the chunk's columns of Q
  float* doc = qc + QT * (DC + 1);     // [QT][DC + 1], of dO
  float* pts = doc + QT * (DC + 1);    // [64 kv][QP]
  float* dsts = pts + BK * QP;         // [64 kv][QP]
  float* lse_s = dsts + BK * QP;       // [QT]
  float* delta_s = lse_s + QT;         // [QT]

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int k0 = blockIdx.x * BK, c0 = blockIdx.z * DC, cols = min(DC, D - c0);
  const size_t base = (size_t)blockIdx.y * S * D;
  q += base; k += base; v += base; dout += base; dk += base; dv += base;
  lse += (size_t)blockIdx.y * S;
  delta += (size_t)blockIdx.y * S;

  float acck[RPT][DPT], accv[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int jd = 0; jd < DPT; ++jd) acck[i][jd] = accv[i][jd] = 0.f;

  const int q_start = causal ? (k0 / QT) * QT : 0;
  for (int q0 = q_start; q0 < S; q0 += QT) {
    float st[RPT][QC], dpt[RPT][QC];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < QC; ++j) st[i][j] = dpt[i][j] = 0.f;
    for (int d0 = 0; d0 < D; d0 += DS) {
      __syncthreads();
      load_cols<T, DS, BK>(ks, k, k0, S, D, d0);
      load_cols<T, DS, BK>(vs, v, k0, S, D, d0);
      load_cols<T, DS, QT>(qs, q, q0, S, D, d0);
      load_cols<T, DS, QT>(dos, dout, q0, S, D, d0);
      if (d0 == 0) {
        load_cols<T, DC, QT>(qc, q, q0, S, D, c0, cols);
        load_cols<T, DC, QT>(doc, dout, q0, S, D, c0, cols);
        load_rows(lse_s, lse, q0, S, QT);
        load_rows(delta_s, delta, q0, S, QT);
      }
      __syncthreads();
      for (int d = 0; d < DS; ++d) {
        float a[RPT], g[RPT], b[QC], c[QC];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          a[i] = ks[(ty + TY * i) * PP + d];
          g[i] = vs[(ty + TY * i) * PP + d];
        }
#pragma unroll
        for (int j = 0; j < QC; ++j) {
          b[j] = qs[(tx + TX * j) * PP + d];
          c[j] = dos[(tx + TX * j) * PP + d];
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < QC; ++j) {
            st[i][j] = fmaf(a[i], b[j], st[i][j]);
            dpt[i][j] = fmaf(g[i], c[j], dpt[i][j]);
          }
      }
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty + TY * i;
#pragma unroll
      for (int j = 0; j < QC; ++j) {
        const int c = tx + TX * j;
        const float x = live(q0 + c, k0 + r, S, causal) ? st[i][j] * scale : NEG_INF;
        const float p = expf(x - lse_s[c]);
        pts[r * QP + c] = round_to<T>(p);
        dsts[r * QP + c] = round_to<T>(p * (dpt[i][j] - delta_s[c]) * scale);
      }
    }
    __syncthreads();

    for (int qq = 0; qq < QT; ++qq) {
      float bo[DPT], bq[DPT];
#pragma unroll
      for (int jd = 0; jd < DPT; ++jd) {
        bo[jd] = doc[qq * (DC + 1) + tx + TX * jd];
        bq[jd] = qc[qq * (DC + 1) + tx + TX * jd];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float p = pts[(ty + TY * i) * QP + qq];
        const float ds = dsts[(ty + TY * i) * QP + qq];
#pragma unroll
        for (int jd = 0; jd < DPT; ++jd) {
          accv[i][jd] = fmaf(p, bo[jd], accv[i][jd]);
          acck[i][jd] = fmaf(ds, bq[jd], acck[i][jd]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int kpos = k0 + ty + TY * i;
    if (kpos >= S) continue;
#pragma unroll
    for (int jd = 0; jd < DPT; ++jd) {
      const int c = tx + TX * jd;
      if (c >= cols) continue;
      dk[(size_t)kpos * D + c0 + c] = from_f<T>(acck[i][jd]);
      dv[(size_t)kpos * D + c0 + c] = from_f<T>(accv[i][jd]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 path: warp-level tensor-core products, mma.sync m16n8k16 (bf16 in, f32
// sums). 128 threads: warp w owns rows 16 w .. 16 w + 15 of the CTA's 64-row
// tile. In the m16n8k16 fragments, lane = 4 g + t: a C fragment holds rows g
// and g + 8, columns 2 t and 2 t + 1 of an 8-column tile, so a score row is
// shared by the 4 lanes of a quad (max and sum are two shuffles), and a
// 16 x 64 score tile converts in registers into the A operand of the next
// product (P.V, dS.K, ...) -- which is exactly where the TPU kernel casts it.
// B operands are read from shared memory as 32-bit pairs: a row tile
// [64][D + 8] when the pair runs along D, a transposed tile [D][72] when it
// runs along the 64 rows; both pitches keep the 32 lanes on 32 banks.
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;
constexpr int MT = 128;   // threads of a tensor-core CTA
constexpr int TP = 72;    // pitch (bf16 elements) of a transposed [D][64] tile

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 rounded to bf16 (round to nearest even, as .astype), low half first.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Rows [row0, row0 + 64) of a [S, D] slab into a [64][D + 8] tile, zero past S.
template <int D>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, int row0, int S) {
  constexpr int W = D / 2, P = (D + 8) / 2;
  const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
  uint32_t* d = reinterpret_cast<uint32_t*>(dst);
  for (int idx = threadIdx.x; idx < 64 * W; idx += MT) {
    const int r = idx / W, c = idx % W;
    d[r * P + c] = row0 + r < S ? s[(size_t)(row0 + r) * W + c] : 0u;
  }
}

// The same rows transposed into a [D][TP] tile, zero past S.
template <int D>
__device__ __forceinline__ void stage_cols(bf16* dst, const bf16* src, int row0, int S) {
  for (int idx = threadIdx.x; idx < 64 * D; idx += MT) {
    const int r = idx / D, c = idx % D;
    dst[c * TP + r] = row0 + r < S ? src[(size_t)(row0 + r) * D + c] : __float2bfloat16(0.f);
  }
}

// A fragments of rows r_lo and r_lo + 8 of a [S, D] slab, straight from
// device memory (read once per CTA), zero past S.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[D / 16][4], const bf16* src, int r_lo,
                                       int S, int t) {
  const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
  const int r_hi = r_lo + 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 8 + t;
    a[kk][0] = r_lo < S ? s[(size_t)r_lo * (D / 2) + c] : 0u;
    a[kk][1] = r_hi < S ? s[(size_t)r_hi * (D / 2) + c] : 0u;
    a[kk][2] = r_lo < S ? s[(size_t)r_lo * (D / 2) + c + 4] : 0u;
    a[kk][3] = r_hi < S ? s[(size_t)r_hi * (D / 2) + c + 4] : 0u;
  }
}

// acc (16 x 64) += A (16 x D) . tile^T, tile a [64][D + 8] row tile.
template <int D>
__device__ __forceinline__ void mma_rows(float (&acc)[8][4], const uint32_t (&a)[D / 16][4],
                                         const bf16* tile, int g, int t) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(tile);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t* b = w + (nt * 8 + g) * ((D + 8) / 2) + kk * 8 + t;
      mma16816(acc[nt], a[kk], b[0], b[4]);
    }
}

// acc (16 x D) += A (16 x 64) . tile, tile stored transposed as [D][TP].
template <int D>
__device__ __forceinline__ void mma_cols(float (&acc)[D / 8][4], const uint32_t (&a)[4][4],
                                         const bf16* tile_t, int g, int t) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(tile_t);
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t* b = w + (nd * 8 + g) * (TP / 2) + kk * 8 + t;
      mma16816(acc[nd], a[kk], b[0], b[4]);
    }
}

// A 16 x 64 tile of f32 C fragments, rounded to bf16 as A fragments.
__device__ __forceinline__ void to_a(uint32_t (&a)[4][4], const float (&c)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
}

// Rows r_lo and r_lo + 8 of a [S, D] bf16 output from f32 C fragments.
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&c)[D / 8][4], int r_lo,
                                           int S, int t, float inv_lo = 1.f, float inv_hi = 1.f) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r_lo + 8 * i;
    if (row >= S) continue;
    const float inv = i ? inv_hi : inv_lo;
    uint32_t* out = reinterpret_cast<uint32_t*>(dst + (size_t)row * D);
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      out[nd * 4 + t] = pack_bf16(c[nd][2 * i] * inv, c[nd][2 * i + 1] * inv);
  }
}

template <int D>
__global__ void __launch_bounds__(MT)
fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
               bf16* __restrict__ o, float* __restrict__ lse, int S, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);   // [64][D + 8]
  bf16* vt = ks + 64 * (D + 8);                    // [D][TP]

  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) >> 2, t = threadIdx.x & 3;
  const int q0 = blockIdx.x * 64;
  const int r_lo = q0 + warp * 16 + g;
  const size_t base = (size_t)blockIdx.y * S * D;
  q += base; k += base; v += base; o += base;
  lse += (size_t)blockIdx.y * S;

  uint32_t qa[D / 16][4];
  load_a<D>(qa, q, r_lo, S, t);
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
  zero(acc);

  const int kv_end = causal ? min(S, q0 + 64) : S;
  for (int k0 = 0; k0 < kv_end; k0 += 64) {
    __syncthreads();
    stage_rows<D>(ks, k, k0, S);
    stage_cols<D>(vt, v, k0, S);
    __syncthreads();

    float s[8][4];
    zero(s);
    mma_rows<D>(s, qa, ks, g, t);
    float mb[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + 2 * t + (e & 1);
        const float x = live(r_lo + 8 * (e >> 1), col, S, causal) ? s[nt][e] * scale : NEG_INF;
        s[nt][e] = x;
        mb[e >> 1] = fmaxf(mb[e >> 1], x);
      }
    float mn[2], alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mn[i] = fmaxf(m[i], quad_max(mb[i]));
      alpha[i] = expf(m[i] - mn[i]);
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nt][e] - mn[e >> 1]);
        s[nt][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] = alpha[i] * l[i] + quad_sum(rs[i]);
      m[i] = mn[i];
    }
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      acc[nd][0] *= alpha[0];
      acc[nd][1] *= alpha[0];
      acc[nd][2] *= alpha[1];
      acc[nd][3] *= alpha[1];
    }
    uint32_t pa[4][4];
    to_a(pa, s);   // P rounded to v's dtype
    mma_cols<D>(acc, pa, vt, g, t);
  }

  const float l_lo = fmaxf(l[0], 1e-30f), l_hi = fmaxf(l[1], 1e-30f);
  store_rows<D>(o, acc, r_lo, S, t, 1.f / l_lo, 1.f / l_hi);
  if (t == 0) {
    if (r_lo < S) lse[r_lo] = m[0] + logf(l_lo);
    if (r_lo + 8 < S) lse[r_lo + 8] = m[1] + logf(l_hi);
  }
}

template <int D>
__global__ void __launch_bounds__(MT)
dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
              const bf16* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, bf16* __restrict__ dq, int S, float scale,
              int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);   // [64][D + 8]
  bf16* vs = ks + 64 * (D + 8);                    // [64][D + 8]
  bf16* kt = vs + 64 * (D + 8);                    // [D][TP]

  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) >> 2, t = threadIdx.x & 3;
  const int q0 = blockIdx.x * 64;
  const int r_lo = q0 + warp * 16 + g;
  const size_t base = (size_t)blockIdx.y * S * D;
  q += base; k += base; v += base; dout += base; dq += base;
  lse += (size_t)blockIdx.y * S;
  delta += (size_t)blockIdx.y * S;

  uint32_t qa[D / 16][4], da[D / 16][4];
  load_a<D>(qa, q, r_lo, S, t);
  load_a<D>(da, dout, r_lo, S, t);
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r_lo + 8 * i;
    lse_r[i] = row < S ? lse[row] : 0.f;
    delta_r[i] = row < S ? delta[row] : 0.f;
  }
  float acc[D / 8][4];
  zero(acc);

  const int kv_end = causal ? min(S, q0 + 64) : S;
  for (int k0 = 0; k0 < kv_end; k0 += 64) {
    __syncthreads();
    stage_rows<D>(ks, k, k0, S);
    stage_rows<D>(vs, v, k0, S);
    stage_cols<D>(kt, k, k0, S);
    __syncthreads();

    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
    mma_rows<D>(s, qa, ks, g, t);
    mma_rows<D>(dp, da, vs, g, t);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, col = k0 + nt * 8 + 2 * t + (e & 1);
        const float x = live(r_lo + 8 * i, col, S, causal) ? s[nt][e] * scale : NEG_INF;
        const float p = expf(x - lse_r[i]);
        s[nt][e] = p * (dp[nt][e] - delta_r[i]) * scale;
      }
    uint32_t dsa[4][4];
    to_a(dsa, s);   // dS rounded to k's dtype
    mma_cols<D>(acc, dsa, kt, g, t);
  }
  store_rows<D>(dq, acc, r_lo, S, t);
}

template <int D>
__global__ void __launch_bounds__(MT)
dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
               const bf16* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv,
               int S, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // [64][D + 8]
  bf16* dos = qs + 64 * (D + 8);                   // [64][D + 8]
  bf16* qt = dos + 64 * (D + 8);                   // [D][TP]
  bf16* dot = qt + D * TP;                         // [D][TP]
  float* lse_s = reinterpret_cast<float*>(dot + D * TP);   // [64]
  float* delta_s = lse_s + 64;                              // [64]

  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) >> 2, t = threadIdx.x & 3;
  const int k0 = blockIdx.x * 64;
  const int r_lo = k0 + warp * 16 + g;   // this lane's kv rows: r_lo, r_lo + 8
  const size_t base = (size_t)blockIdx.y * S * D;
  q += base; k += base; v += base; dout += base; dk += base; dv += base;
  lse += (size_t)blockIdx.y * S;
  delta += (size_t)blockIdx.y * S;

  uint32_t ka[D / 16][4], va[D / 16][4];
  load_a<D>(ka, k, r_lo, S, t);
  load_a<D>(va, v, r_lo, S, t);
  float acck[D / 8][4], accv[D / 8][4];
  zero(acck);
  zero(accv);

  for (int q0 = causal ? k0 : 0; q0 < S; q0 += 64) {
    __syncthreads();
    stage_rows<D>(qs, q, q0, S);
    stage_rows<D>(dos, dout, q0, S);
    stage_cols<D>(qt, q, q0, S);
    stage_cols<D>(dot, dout, q0, S);
    if (threadIdx.x < 64) {
      const int row = q0 + threadIdx.x;
      lse_s[threadIdx.x] = row < S ? lse[row] : 0.f;
      delta_s[threadIdx.x] = row < S ? delta[row] : 0.f;
    }
    __syncthreads();

    float st[8][4], dpt[8][4];   // S^T and dP^T: kv rows x q columns
    zero(st);
    zero(dpt);
    mma_rows<D>(st, ka, qs, g, t);
    mma_rows<D>(dpt, va, dos, g, t);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + 2 * t + (e & 1);
        const float x = live(q0 + c, r_lo + 8 * (e >> 1), S, causal) ? st[nt][e] * scale
                                                                     : NEG_INF;
        const float p = expf(x - lse_s[c]);
        st[nt][e] = p;
        dpt[nt][e] = p * (dpt[nt][e] - delta_s[c]) * scale;
      }
    uint32_t a[4][4];
    to_a(a, st);    // P rounded to dO's dtype
    mma_cols<D>(accv, a, dot, g, t);
    to_a(a, dpt);   // dS rounded to q's dtype
    mma_cols<D>(acck, a, qt, g, t);
  }
  store_rows<D>(dk, acck, r_lo, S, t);
  store_rows<D>(dv, accv, r_lo, S, t);
}

// ---------------------------------------------------------------------------
// bf16 from D = 64 on: warp-specialised wgmma kernels (K1 forward, K2 dQ,
// K3 dK/dV). 384 threads: warpgroups 0 and 1 consume, each owning 64 rows of
// the CTA's 128-row output tile (K3 from D = 256 on splits a 64-row tile by
// columns instead, dkv_halves); warpgroup 2 produces: one thread issues
// every TMA copy, and the warpgroup hands its registers to the consumers
// (setmaxnreg 24 / 240). The CTA's own 128 rows are loaded once; the other
// operand streams through a ring of STAGES shared-memory stages, each with a
// "full" mbarrier (TMA transaction bytes) and an "empty" one (all 256
// consumer threads arrive when their products have read the stage).
//
// Tensor maps are 3-D over [B*H, S, D] with 64 x 64 boxes in TMA's 128-byte
// swizzle (sm90.cuh), so rows past S arrive as zeros and never as the next
// head's; a ragged edge is still masked, since a zero row scores 0, not
// -inf. Outputs leave through shared memory and a TMA store, which writes no
// row past S. Scores are kept in the log2 domain: exp2f of s * scale *
// log2(e) minus the running max, LSE converted back to natural log.
// ---------------------------------------------------------------------------
using sm90::align1024;
using sm90::HT;
using sm90::swz;
using sm90::WG;
constexpr uint32_t BOX_BYTES = 64 * 128;   // one 64-row x 128-byte TMA box
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// TMA rows [row0, row0 + ROWS) x columns [col0, col0 + D) of head bh into a
// swizzled [ROWS][D] tile, in boxes of min(ROWS, 64) rows (the map's box
// height); only the first `slabs` 64-column slabs are loaded.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int row0, int bh, int col0 = 0, int slabs = D / 64) {
  constexpr int BR = ROWS < 64 ? ROWS : 64;
#pragma unroll
  for (int s = 0; s < D / 64; ++s)
    if (s < slabs)
#pragma unroll
      for (int rb = 0; rb < ROWS / BR; ++rb)
        sm90::tma_load_3d(dst + (s * (ROWS / BR) + rb) * BR * 128, map, bar, col0 + s * 64,
                          row0 + rb * BR, bh);
}

// A warpgroup's 64 x D accumulator, row-scaled and rounded to bf16, into its
// rows [64 wg, 64 wg + 64) of a swizzled [128][D] tile; then TMA to rows
// [row0, row0 + 64) x columns [col0, col0 + 64 slabs) of head bh. All 128
// threads of the warpgroup call it.
template <int D>
__device__ __forceinline__ void store_tile(unsigned char* tile, const float (&acc)[D / 2],
                                           const CUtensorMap* map, int wg, int row0, int bh,
                                           float s_lo = 1.f, float s_hi = 1.f, int col0 = 0,
                                           int slabs = D / 64) {
  const int tid = threadIdx.x % WG, t = tid & 3;
  const int r_lo = wg * 64 + (tid / 32) * 16 + ((tid & 31) >> 2);
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float s = i ? s_hi : s_lo;
      *reinterpret_cast<uint32_t*>(tile + swz<128>(r_lo + 8 * i, 8 * j + 2 * t)) =
          pack_bf16(acc[4 * j + 2 * i] * s, acc[4 * j + 2 * i + 1] * s);
    }
  sm90::fence_async_smem();
  sm90::named_barrier(1 + wg, WG);
  if (tid == 0) {
    const uint32_t base = sm90::smem_u32(tile) + wg * BOX_BYTES;
#pragma unroll
    for (int s = 0; s < slabs; ++s)
      sm90::tma_store_3d(map, base + s * 128 * 128, col0 + s * 64, row0, bh);
    sm90::tma_store_wait();
  }
}

// f32 accumulator fragments of a 64 x N tile (wgmma's layout, which per warp
// is mma.sync's C layout) rounded to bf16 A fragments of the next product.
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[N / 16][4], const float (&c)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack_bf16(c[8 * kk + 0], c[8 * kk + 1]);
    a[kk][1] = pack_bf16(c[8 * kk + 2], c[8 * kk + 3]);
    a[kk][2] = pack_bf16(c[8 * kk + 4], c[8 * kk + 5]);
    a[kk][3] = pack_bf16(c[8 * kk + 6], c[8 * kk + 7]);
  }
}

template <int N>
__device__ __forceinline__ void ss_product(float (&d)[N / 2], uint64_t da, uint64_t db, int acc) {
  static_assert(N == 32 || N == 64 || N == 128, "score tiles are 32, 64 or 128 wide");
  if constexpr (N == 32) sm90::wgmma_ss_n32(d, da, db, acc);
  else if constexpr (N == 64) sm90::wgmma_ss_n64(d, da, db, acc);
  else sm90::wgmma_ss_n128(d, da, db, acc);
}
template <int N>
__device__ __forceinline__ void rs_product(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  static_assert(N == 64 || N == 128 || N == 256, "output tiles are 64, 128 or 256 wide");
  if constexpr (N == 64) sm90::wgmma_rs_n64(d, a, db, 1);
  else if constexpr (N == 128) sm90::wgmma_rs_n128(d, a, db, 1);
  else sm90::wgmma_rs_n256(d, a, db, 1);
}

// d (64 x N) = A . B^T over D: A the warpgroup's 64 rows of a swizzled
// [AR][D] tile at a, B N rows of a swizzled [BR][D] tile at b, both K-major.
template <int D, int N, int AR, int BR = N>
__device__ __forceinline__ void product_k(float (&d)[N / 2], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t da = a + (kk / 4) * AR * 128 + (kk % 4) * 32;
    const uint32_t db = b + (kk / 4) * BR * 128 + (kk % 4) * 32;
    ss_product<N>(d, sm90::desc_k(da), sm90::desc_k(db), kk > 0);
  }
}

// d (64 x D) += A . B over K rows: A bf16 fragments in registers, B a
// swizzled [K][D] tile at b read MN-major.
template <int D, int K>
__device__ __forceinline__ void product_mn(float (&d)[D / 2], const uint32_t (&a)[K / 16][4],
                                           uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) rs_product<D>(d, a[kk], sm90::desc_mn(b + kk * 2048, K * 128));
}

// One tile of the forward's online softmax, in the log2 domain, for the
// two rows (row_lo, row_lo + 8) a lane holds: mask (only a tile that
// reaches past S or past the warpgroup's first row w0), update the running
// max m and sum l, turn the scores s into P (f32; sums from f32 P), and
// return the factor alpha that rescales what O holds so far.
template <int BK>
__device__ __forceinline__ void online_softmax(float (&s)[BK / 2], float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], int row_lo, int k0, int w0,
                                               int S, int causal, int t, float scale_log2) {
  if (k0 + BK > S || (causal && k0 + BK - 1 > w0)) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (!live(row_lo + 8 * (e >> 1), k0 + 8 * j + 2 * t + (e & 1), S, causal))
          s[4 * j + e] = NEG_INF;
  }
  float mx[2] = {NEG_INF, NEG_INF}, rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float mn = fmaxf(m[i], quad_max(mx[i]) * scale_log2);
    alpha[i] = exp2f(m[i] - mn);
    m[i] = mn;
  }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(fmaf(s[4 * j + e], scale_log2, -m[e >> 1]));
      s[4 * j + e] = p;
      rs[e >> 1] += p;
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = alpha[i] * l[i] + quad_sum(rs[i]);
}

// K1: one CTA per (b*h, 128-row q tile), the q tiles in reverse order so the
// longest causal rows are scheduled first; K and V tiles of BK rows stream
// through the ring up to the diagonal. At D = 256 (fwd_bk, fwd_stages) the
// Q tile takes 64 KB and a 64-row (K, V) stage 64 KB, so two stages (192 KB);
// a consumer thread holds the 64 x 256 O accumulator (128 registers), the
// 64 x 64 scores (32) and P's bf16 fragments (16) of its 240.
template <int D, int BK, int STAGES>
__global__ void __launch_bounds__(HT, 1)
fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                 float* __restrict__ lse, int S, float scale_log2, int causal) {
  constexpr uint32_t Q_BYTES = 128 * D * 2, KV_BYTES = BK * D * 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t sq = sm90::smem_u32(smem), sk = sq + Q_BYTES, sv = sk + STAGES * KV_BYTES;
  const uint32_t q_bar = sv + STAGES * KV_BYTES;   // then full[STAGES], empty[STAGES]
  auto full = [&](int st) { return q_bar + 8 * (1 + st); };
  auto empty = [&](int st) { return q_bar + 8 * (1 + STAGES + st); };

  const int bh = blockIdx.x, q0 = (gridDim.y - 1 - blockIdx.y) * 128;
  const int kv_end = causal ? min(S, q0 + 128) : S;
  const int n_tiles = (kv_end + BK - 1) / BK;
  if (threadIdx.x == 0) {
    sm90::mbar_init(q_bar, 1);
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
      sm90::mbar_expect_tx(q_bar, Q_BYTES);
      load_tile<D, 128>(sq, &tq, q_bar, q0, bh);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % STAGES;
        sm90::mbar_wait(empty(st), ((it / STAGES) & 1) ^ 1);
        sm90::mbar_expect_tx(full(st), 2 * KV_BYTES);
        load_tile<D, BK>(sk + st * KV_BYTES, &tk, full(st), it * BK, bh);
        load_tile<D, BK>(sv + st * KV_BYTES, &tv, full(st), it * BK, bh);
      }
    }
  } else {   // consumers
    sm90::reg_alloc<240>();
    const int tid = threadIdx.x % WG, t = tid & 3;
    const int row_lo = q0 + wg * 64 + (tid / 32) * 16 + ((tid & 31) >> 2);   // and row_lo + 8
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

    sm90::mbar_wait(q_bar, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % STAGES;
      sm90::mbar_wait(full(st), (it / STAGES) & 1);
      float s[BK / 2];
      float alpha[2];
      sm90::wgmma_fence();
      product_k<D, BK, 128>(s, sq + wg * BOX_BYTES, sk + st * KV_BYTES);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_operand(s);
      online_softmax<BK>(s, m, l, alpha, row_lo, it * BK, q0 + wg * 64, S, causal, t, scale_log2);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j + 0] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }
      uint32_t pa[BK / 16][4];
      acc_to_a<BK>(pa, s);   // P rounded to v's dtype
      sm90::fence_operand(o);
      sm90::wgmma_fence();
      product_mn<D, BK>(o, pa, sv + st * KV_BYTES);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_operand(o);
      sm90::mbar_arrive(empty(st));
    }

    const float l_lo = fmaxf(l[0], 1e-30f), l_hi = fmaxf(l[1], 1e-30f);
    if (t == 0) {
      float* out = lse + (size_t)bh * S;
      if (row_lo < S) out[row_lo] = m[0] * LN2 + logf(l_lo);
      if (row_lo + 8 < S) out[row_lo + 8] = m[1] * LN2 + logf(l_hi);
    }
    // the warpgroup's Q rows are read by no one else: O goes out through them
    store_tile<D>(smem, o, &to, wg, q0 + wg * 64, bh, 1.f / l_lo, 1.f / l_hi);
  }
}

// K3 at D = 64 and 128: one CTA per (b*h, 128-row kv tile), kv tile 0 (the
// most causal work) first; q tiles of 64 rows with their lse and delta
// stream through the ring from the diagonal. S^T = K.Q^T and dP^T = V.dO^T
// read Q and dO K-major; dV += P^T.dO and dK += dS^T.Q read the same tiles
// MN-major.
template <int D, int STAGES>
__device__ __forceinline__ void dkv_rows(unsigned char* smem_raw, const CUtensorMap& tq,
                                         const CUtensorMap& tk, const CUtensorMap& tv,
                                         const CUtensorMap& tdo, const CUtensorMap& tdk,
                                         const CUtensorMap& tdv, const CUtensorMap& tlse,
                                         const CUtensorMap& tdelta, int S, float scale,
                                         int causal) {
  constexpr uint32_t KV_BYTES = 128 * D * 2, T_BYTES = 64 * D * 2, R_BYTES = 64 * 4;
  unsigned char* smem = align1024(smem_raw);
  const uint32_t sk = sm90::smem_u32(smem), sv = sk + KV_BYTES;
  const uint32_t ring = sv + KV_BYTES;                    // (Q, dO) per stage
  const uint32_t rows = ring + STAGES * 2 * T_BYTES;      // lse[STAGES][64], delta[STAGES][64]
  const uint32_t kv_bar = rows + STAGES * 2 * R_BYTES;    // then full[STAGES], empty[STAGES]
  auto sq = [&](int st) { return ring + st * 2 * T_BYTES; };
  auto sdo = [&](int st) { return ring + st * 2 * T_BYTES + T_BYTES; };
  auto full = [&](int st) { return kv_bar + 8 * (1 + st); };
  auto empty = [&](int st) { return kv_bar + 8 * (1 + STAGES + st); };
  const float* lse_s = reinterpret_cast<const float*>(smem + (rows - sk));
  const float* delta_s = lse_s + STAGES * 64;

  const int bh = blockIdx.x, k0 = blockIdx.y * 128;
  const int q_start = causal ? k0 : 0;
  const int n_tiles = (S - q_start + 63) / 64;
  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_bar, 1);
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
      sm90::mbar_expect_tx(kv_bar, 2 * KV_BYTES);
      load_tile<D, 128>(sk, &tk, kv_bar, k0, bh);
      load_tile<D, 128>(sv, &tv, kv_bar, k0, bh);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % STAGES, q0 = q_start + it * 64;
        sm90::mbar_wait(empty(st), ((it / STAGES) & 1) ^ 1);
        sm90::mbar_expect_tx(full(st), 2 * T_BYTES + 2 * R_BYTES);
        load_tile<D, 64>(sq(st), &tq, full(st), q0, bh);
        load_tile<D, 64>(sdo(st), &tdo, full(st), q0, bh);
        sm90::tma_load_2d(rows + st * R_BYTES, &tlse, full(st), q0, bh);
        sm90::tma_load_2d(rows + (STAGES + st) * R_BYTES, &tdelta, full(st), q0, bh);
      }
    }
  } else {   // consumers
    sm90::reg_alloc<240>();
    const int tid = threadIdx.x % WG, t = tid & 3;
    const int kw = k0 + wg * 64;                                 // the warpgroup's first kv row
    const int kv_lo = kw + (tid / 32) * 16 + ((tid & 31) >> 2);  // and kv_lo + 8
    const float scale_log2 = scale * LOG2E;
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

    sm90::mbar_wait(kv_bar, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % STAGES, q0 = q_start + it * 64;
      sm90::mbar_wait(full(st), (it / STAGES) & 1);
      if (!(causal && q0 + 63 < kw)) {   // else every (q, kv) pair is masked
        float s[32], dp[32];   // S^T and dP^T: kv rows x q columns
        sm90::wgmma_fence();
        product_k<D, 64, 128>(s, sk + wg * BOX_BYTES, sq(st));
        product_k<D, 64, 128>(dp, sv + wg * BOX_BYTES, sdo(st));
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_operand(s);
        sm90::fence_operand(dp);
        const bool edge = (causal && q0 < kw + 64) || q0 + 64 > S || kw + 64 > S;
        const float* ls = lse_s + st * 64;
        const float* ds = delta_s + st * 64;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 lv = *reinterpret_cast<const float2*>(ls + 8 * j + 2 * t);
          const float2 dl = *reinterpret_cast<const float2*>(ds + 8 * j + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = s[4 * j + e];
            if (edge && !live(q0 + 8 * j + 2 * t + (e & 1), kv_lo + 8 * (e >> 1), S, causal))
              x = NEG_INF;
            const float p = exp2f(fmaf(x, scale_log2, -((e & 1) ? lv.y : lv.x) * LOG2E));
            s[4 * j + e] = p;
            dp[4 * j + e] = p * (dp[4 * j + e] - ((e & 1) ? dl.y : dl.x)) * scale;
          }
        }
        uint32_t pa[4][4], dsa[4][4];
        acc_to_a<64>(pa, s);    // P rounded to dO's dtype
        acc_to_a<64>(dsa, dp);  // dS rounded to q's dtype
        sm90::fence_operand(dv);
        sm90::fence_operand(dk);
        sm90::wgmma_fence();
        product_mn<D, 64>(dv, pa, sdo(st));
        product_mn<D, 64>(dk, dsa, sq(st));
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_operand(dv);
        sm90::fence_operand(dk);
      }
      sm90::mbar_arrive(empty(st));
    }
    // the warpgroup's K and V rows are read by no one else: dK, dV go out
    // through them
    store_tile<D>(smem, dk, &tdk, wg, kw, bh);
    store_tile<D>(smem + KV_BYTES, dv, &tdv, wg, kw, bh);
  }
}

// A warpgroup's 64 x N accumulator, rounded to bf16, into a swizzled [64][N]
// tile (N / 64 slabs of BOX_BYTES); then TMA to rows [row0, row0 + 64) x
// columns [col0, col0 + 64 slabs) of head bh. All 128 threads of the
// warpgroup call it.
template <int N>
__device__ __forceinline__ void store_rows64(unsigned char* tile, const float (&acc)[N / 2],
                                             const CUtensorMap* map, int wg, int row0, int bh,
                                             int col0, int slabs = N / 64) {
  const int tid = threadIdx.x % WG, t = tid & 3;
  const int r_lo = (tid / 32) * 16 + ((tid & 31) >> 2);
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<uint32_t*>(tile + swz<64>(r_lo + 8 * i, 8 * j + 2 * t)) =
          pack_bf16(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
  sm90::fence_async_smem();
  sm90::named_barrier(1 + wg, WG);
  if (tid == 0) {
    const uint32_t base = sm90::smem_u32(tile);
#pragma unroll
    for (int s = 0; s < N / 64; ++s)
      if (s < slabs) sm90::tma_store_3d(map, base + s * BOX_BYTES, col0 + s * 64, row0, bh);
    sm90::tma_store_wait();
  }
}

// K3 from D = 256 on, split by columns: a warpgroup's S^T and dP^T (the
// CTA's 64 kv rows x the warpgroup's 32 q columns from qc, of the q tile at
// q0) into P = exp(S - lse) and dS = P (dP - delta) scale in f32, masked
// only on a tile that reaches the diagonal or past S; then both, rounded (P
// to dO's dtype, dS to q's), into the warpgroup's columns of the shared
// [64 kv][64 q] tiles P^T at pt and dS^T at pt + BOX_BYTES.
__device__ __forceinline__ void dkv_pds(float (&s)[16], float (&dp)[16], unsigned char* pt,
                                        const float* ls, const float* dl, int q0, int qc,
                                        int k0, int S, int causal, float scale) {
  const int tid = threadIdx.x % WG, t = tid & 3;
  const int kv_lo = (tid / 32) * 16 + ((tid & 31) >> 2);   // local kv row, and kv_lo + 8
  const float scale_log2 = scale * LOG2E;
  const bool edge = (causal && q0 < k0 + 64) || q0 + 64 > S || k0 + 64 > S;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 lv = *reinterpret_cast<const float2*>(ls + qc + 8 * j + 2 * t);
    const float2 dv = *reinterpret_cast<const float2*>(dl + qc + 8 * j + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * j + e];
      if (edge &&
          !live(q0 + qc + 8 * j + 2 * t + (e & 1), k0 + kv_lo + 8 * (e >> 1), S, causal))
        x = NEG_INF;
      const float p = exp2f(fmaf(x, scale_log2, -((e & 1) ? lv.y : lv.x) * LOG2E));
      s[4 * j + e] = p;
      dp[4 * j + e] = p * (dp[4 * j + e] - ((e & 1) ? dv.y : dv.x)) * scale;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint32_t off = swz<64>(kv_lo + 8 * i, qc + 8 * j + 2 * t);
      *reinterpret_cast<uint32_t*>(pt + off) = pack_bf16(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]);
      *reinterpret_cast<uint32_t*>(pt + BOX_BYTES + off) =
          pack_bf16(dp[4 * j + 2 * i], dp[4 * j + 2 * i + 1]);
    }
  }
  sm90::fence_async_smem();
}

// dV += P^T.dO and dK += dS^T.Q over a 64-row q tile, for a warpgroup's 128
// output columns: P^T and dS^T the shared [64][64] tiles at pd and
// pd + BOX_BYTES (A, K-major), dO and Q 64-row tiles at sdo and sq from the
// warpgroup's first column slab (B, read MN-major; slabs BOX_BYTES apart).
__device__ __forceinline__ void dkv_half_products(float (&dv)[64], float (&dk)[64], uint32_t pd,
                                                  uint32_t sdo, uint32_t sq) {
  sm90::fence_operand(dv);
  sm90::fence_operand(dk);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    sm90::wgmma_ss_mn_n128(dv, sm90::desc_k(pd + kk * 32),
                           sm90::desc_mn(sdo + kk * 2048, BOX_BYTES), 1);
    sm90::wgmma_ss_mn_n128(dk, sm90::desc_k(pd + BOX_BYTES + kk * 32),
                           sm90::desc_mn(sq + kk * 2048, BOX_BYTES), 1);
  }
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_operand(dv);
  sm90::fence_operand(dk);
}

// K3 at D = 256: one CTA per (b*h, 64-row kv tile), kv tile 0 first. The
// 128-row kv tile of D 64 and 128 does not fit here: its K and V would take
// 128 KB and each (Q, dO) stage 64 KB, and a consumer would hold two 64 x 256
// f32 accumulators (256 registers of its 240). So K and V rows stay resident
// (64 KB), two 64-row (Q, dO) stages (64 KB each) stream from the diagonal,
// and the warpgroups split the work by columns: warpgroup w computes S^T and
// dP^T for q columns [32 w, 32 w + 32) of the tile over all of D
// (m64n32k16), turns them into P and dS (dkv_pds), and after named barrier 3
// reads both warpgroups' halves as the A operand of dV += P^T.dO and
// dK += dS^T.Q for its output columns [128 w, 128 w + 128) (m64n128k16). No
// product is computed twice; a thread holds 64 + 64 accumulator registers
// and 16 + 16 of scores. The (P^T, dS^T) tiles are double-buffered, so one
// barrier a q tile suffices: a warpgroup writes buffer it % 2 after the
// barrier of tile it - 1, which the other passes only once it has retired
// its products of tile it - 2, the last to read that buffer.
template <int STAGES>
__device__ __forceinline__ void dkv_halves(unsigned char* smem_raw, const CUtensorMap& tq,
                                           const CUtensorMap& tk, const CUtensorMap& tv,
                                           const CUtensorMap& tdo, const CUtensorMap& tdk,
                                           const CUtensorMap& tdv, const CUtensorMap& tlse,
                                           const CUtensorMap& tdelta, int S, float scale,
                                           int causal) {
  constexpr int D = 256;
  constexpr uint32_t T_BYTES = 64 * D * 2, R_BYTES = 64 * 4, PD_BYTES = 2 * BOX_BYTES;
  unsigned char* smem = align1024(smem_raw);
  const uint32_t sk = sm90::smem_u32(smem), sv = sk + T_BYTES;
  const uint32_t ring = sv + T_BYTES;                    // (Q, dO) per stage
  const uint32_t pds = ring + STAGES * 2 * T_BYTES;      // (P^T, dS^T) x 2 buffers
  const uint32_t rows = pds + 2 * PD_BYTES;              // lse[STAGES][64], delta[STAGES][64]
  const uint32_t kv_bar = rows + STAGES * 2 * R_BYTES;   // then full[STAGES], empty[STAGES]
  auto sq = [&](int st) { return ring + st * 2 * T_BYTES; };
  auto sdo = [&](int st) { return ring + st * 2 * T_BYTES + T_BYTES; };
  auto full = [&](int st) { return kv_bar + 8 * (1 + st); };
  auto empty = [&](int st) { return kv_bar + 8 * (1 + STAGES + st); };
  const float* lse_s = reinterpret_cast<const float*>(smem + (rows - sk));
  const float* delta_s = lse_s + STAGES * 64;

  const int bh = blockIdx.x, k0 = blockIdx.y * 64;
  const int q_start = causal ? k0 : 0;
  const int n_tiles = (S - q_start + 63) / 64;
  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_bar, 1);
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
      sm90::mbar_expect_tx(kv_bar, 2 * T_BYTES);
      load_tile<D, 64>(sk, &tk, kv_bar, k0, bh);
      load_tile<D, 64>(sv, &tv, kv_bar, k0, bh);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % STAGES, q0 = q_start + it * 64;
        sm90::mbar_wait(empty(st), ((it / STAGES) & 1) ^ 1);
        sm90::mbar_expect_tx(full(st), 2 * T_BYTES + 2 * R_BYTES);
        load_tile<D, 64>(sq(st), &tq, full(st), q0, bh);
        load_tile<D, 64>(sdo(st), &tdo, full(st), q0, bh);
        sm90::tma_load_2d(rows + st * R_BYTES, &tlse, full(st), q0, bh);
        sm90::tma_load_2d(rows + (STAGES + st) * R_BYTES, &tdelta, full(st), q0, bh);
      }
    }
  } else {   // consumers
    sm90::reg_alloc<240>();
    const int qc = 32 * wg;   // the warpgroup's q columns of a tile
    float dk[64], dv[64];     // its output columns [128 wg, 128 wg + 128)
#pragma unroll
    for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;

    sm90::mbar_wait(kv_bar, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % STAGES, q0 = q_start + it * 64;
      sm90::mbar_wait(full(st), (it / STAGES) & 1);
      float s[16], dp[16];   // S^T and dP^T: kv rows x the warpgroup's q columns
      sm90::wgmma_fence();
      product_k<D, 32, 64, 64>(s, sk, sq(st) + qc * 128);
      product_k<D, 32, 64, 64>(dp, sv, sdo(st) + qc * 128);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_operand(s);
      sm90::fence_operand(dp);
      const uint32_t pd = pds + (it & 1) * PD_BYTES;
      dkv_pds(s, dp, smem + (pd - sk), lse_s + st * 64, delta_s + st * 64, q0, qc, k0, S,
              causal, scale);
      sm90::named_barrier(3, 2 * WG);   // both halves of P^T and dS^T are written
      dkv_half_products(dv, dk, pd, sdo(st) + wg * 2 * BOX_BYTES, sq(st) + wg * 2 * BOX_BYTES);
      sm90::mbar_arrive(empty(st));
    }
    // no one reads K or V after the last barrier: dK, dV go out through them
    store_rows64<128>(smem + wg * 2 * BOX_BYTES, dk, &tdk, wg, k0, bh, 128 * wg);
    store_rows64<128>(smem + T_BYTES + wg * 2 * BOX_BYTES, dv, &tdv, wg, k0, bh, 128 * wg);
  }
}

// K3: dkv_rows at D 64 and 128, dkv_halves at 256.
template <int D, int STAGES>
__global__ void __launch_bounds__(HT, 1)
dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                 const __grid_constant__ CUtensorMap tdk, const __grid_constant__ CUtensorMap tdv,
                 const __grid_constant__ CUtensorMap tlse,
                 const __grid_constant__ CUtensorMap tdelta, int S, float scale, int causal) {
  extern __shared__ unsigned char smem_raw[];
  if constexpr (D == 256)
    dkv_halves<STAGES>(smem_raw, tq, tk, tv, tdo, tdk, tdv, tlse, tdelta, S, scale, causal);
  else
    dkv_rows<D, STAGES>(smem_raw, tq, tk, tv, tdo, tdk, tdv, tlse, tdelta, S, scale, causal);
}

// K2: one CTA per (b*h, 128-row q tile), the q tiles in reverse order so the
// longest causal rows are scheduled first. The CTA's Q, dO, lse and delta
// rows are loaded once; K and V tiles of BK rows stream through the ring up
// to the diagonal. S = Q.K^T and dP = dO.V^T read K and V K-major; dQ +=
// dS.K reads the same K tile MN-major.
//
// At D = 256 the resident Q and dO tiles take 128 KB, and a 64-row (K, V)
// stage 64 KB: one such stage would leave the producer nothing to load ahead
// while the consumers work, and 64-row output tiles would halve the
// warpgroups that share each K and V stage. So BK = 32 there (dq_bk): three
// 32 KB stages (226 KB in all), the scores a 64 x 32 tile of 16 registers, and
// 128 registers a thread for the 64 x 256 dQ accumulator.
template <int D, int BK, int STAGES>
__global__ void __launch_bounds__(HT, 1)
dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                const __grid_constant__ CUtensorMap tdq, const __grid_constant__ CUtensorMap tlse,
                const __grid_constant__ CUtensorMap tdelta, int S, float scale, int causal) {
  constexpr uint32_t Q_BYTES = 128 * D * 2, T_BYTES = BK * D * 2, R_BYTES = 128 * 4;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t sq = sm90::smem_u32(smem), sdo = sq + Q_BYTES;
  const uint32_t ring = sdo + Q_BYTES;                 // (K, V) per stage
  const uint32_t rows = ring + STAGES * 2 * T_BYTES;   // lse[128], delta[128]
  const uint32_t q_bar = rows + 2 * R_BYTES;           // then full[STAGES], empty[STAGES]
  auto sk = [&](int st) { return ring + st * 2 * T_BYTES; };
  auto sv = [&](int st) { return ring + st * 2 * T_BYTES + T_BYTES; };
  auto full = [&](int st) { return q_bar + 8 * (1 + st); };
  auto empty = [&](int st) { return q_bar + 8 * (1 + STAGES + st); };
  const float* lse_s = reinterpret_cast<const float*>(smem + (rows - sq));
  const float* delta_s = lse_s + 128;

  const int bh = blockIdx.x, q0 = (gridDim.y - 1 - blockIdx.y) * 128;
  const int kv_end = causal ? min(S, q0 + 128) : S;
  const int n_tiles = (kv_end + BK - 1) / BK;
  if (threadIdx.x == 0) {
    sm90::mbar_init(q_bar, 1);
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
      sm90::mbar_expect_tx(q_bar, 2 * Q_BYTES + 2 * R_BYTES);
      load_tile<D, 128>(sq, &tq, q_bar, q0, bh);
      load_tile<D, 128>(sdo, &tdo, q_bar, q0, bh);
      for (int h = 0; h < 2; ++h) {
        sm90::tma_load_2d(rows + h * 256, &tlse, q_bar, q0 + 64 * h, bh);
        sm90::tma_load_2d(rows + R_BYTES + h * 256, &tdelta, q_bar, q0 + 64 * h, bh);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % STAGES;
        sm90::mbar_wait(empty(st), ((it / STAGES) & 1) ^ 1);
        sm90::mbar_expect_tx(full(st), 2 * T_BYTES);
        load_tile<D, BK>(sk(st), &tk, full(st), it * BK, bh);
        load_tile<D, BK>(sv(st), &tv, full(st), it * BK, bh);
      }
    }
  } else {   // consumers
    sm90::reg_alloc<240>();
    const int tid = threadIdx.x % WG, t = tid & 3;
    const int qw = q0 + wg * 64;                                   // the warpgroup's first q row
    const int lr = wg * 64 + (tid / 32) * 16 + ((tid & 31) >> 2);   // local row, and lr + 8
    const int row_lo = q0 + lr;
    const float scale_log2 = scale * LOG2E;
    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

    sm90::mbar_wait(q_bar, 0);
    const float lse2[2] = {lse_s[lr] * LOG2E, lse_s[lr + 8] * LOG2E};
    const float dl[2] = {delta_s[lr], delta_s[lr + 8]};
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % STAGES, k0 = it * BK;
      sm90::mbar_wait(full(st), (it / STAGES) & 1);
      if (!(causal && k0 > qw + 63)) {   // else every (q, kv) pair is masked
        float s[BK / 2], dp[BK / 2];
        sm90::wgmma_fence();
        product_k<D, BK, 128>(s, sq + wg * BOX_BYTES, sk(st));
        product_k<D, BK, 128>(dp, sdo + wg * BOX_BYTES, sv(st));
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_operand(s);
        sm90::fence_operand(dp);
        const bool edge = (causal && k0 + BK - 1 > qw) || k0 + BK > S || qw + 64 > S;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = s[4 * j + e];
            if (edge && !live(row_lo + 8 * (e >> 1), k0 + 8 * j + 2 * t + (e & 1), S, causal))
              x = NEG_INF;
            const float p = exp2f(fmaf(x, scale_log2, -lse2[e >> 1]));
            dp[4 * j + e] = p * (dp[4 * j + e] - dl[e >> 1]) * scale;
          }
        uint32_t dsa[BK / 16][4];
        acc_to_a<BK>(dsa, dp);   // dS rounded to k's dtype
        sm90::fence_operand(dq);
        sm90::wgmma_fence();
        product_mn<D, BK>(dq, dsa, sk(st));
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_operand(dq);
      }
      sm90::mbar_arrive(empty(st));
    }
    // the warpgroup's Q rows are read by no one else: dQ goes out through them
    store_tile<D>(smem, dq, &tdq, wg, qw, bh);
  }
}

// ---------------------------------------------------------------------------
// bf16 above D = 256: K1 and K2 (and K3, described at its kernel) on the
// tensor cores, the output columns split into chunks of N = 256 over grid
// axis z. Chunk c owns columns [N c, N c + N) of O or dQ; a last chunk past
// D loads and stores only its slabs inside D
// (the columns past D hold what the product makes of stale shared memory and
// are never stored; no column of O or dQ reads another). D is a runtime
// multiple of 64. The score products (S = Q.K^T, and dP = dO.V^T for dQ)
// stream D in 64-wide slices through ring A: a stage holds one slice of the
// CTA's 128 Q (and dO) rows and of the BK-row K (and V) tile. The chunk's N
// columns of V (forward) or K (dQ) stream through ring B. A slice's products
// are one commit group; the previous slice's group is retired, and its stage
// released, once the next is issued. Each CTA recomputes the scores for its
// chunk, ceil(D / 256) times the score work in all; every chunk computes the
// same softmax, and chunk 0 writes LSE. Ring A, free once both warpgroups are
// done (named barrier 3), carries the output tile out.
// ---------------------------------------------------------------------------
constexpr uint32_t SLICE_BYTES = 128 * 128;   // a 64-column slice of 128 rows

// The stages of ring A from `ia` on, one a slice of D: d (64 x BK) = the sum
// over the slices of (A rows of the warpgroup) . B^T for each (A, B) pair of
// a stage, A a 128-row slice at offset a_off[p], B a BK-row slice at b_off[p].
template <int BK, int SA, int NP>
__device__ __forceinline__ void slice_products(float (&d)[NP][BK / 2], int& ia, int n_slices,
                                               uint32_t ra, uint32_t a_bytes,
                                               const uint32_t (&a_off)[NP],
                                               const uint32_t (&b_off)[NP], uint32_t full,
                                               uint32_t empty, int wg) {
  int prev = 0;
  for (int sl = 0; sl < n_slices; ++sl, ++ia) {
    const int st = ia % SA;
    sm90::mbar_wait(full + 8 * st, (ia / SA) & 1);
    const uint32_t a = ra + st * a_bytes;
    sm90::wgmma_fence();
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ss_product<BK>(d[p], sm90::desc_k(a + a_off[p] + wg * BOX_BYTES + kk * 32),
                       sm90::desc_k(a + b_off[p] + kk * 32), sl > 0 || kk > 0);
    sm90::wgmma_commit();
    if (sl > 0) {
      sm90::wgmma_wait<1>();
      sm90::mbar_arrive(empty + 8 * prev);
    }
    prev = st;
  }
  sm90::wgmma_wait<0>();
  sm90::mbar_arrive(empty + 8 * prev);
#pragma unroll
  for (int p = 0; p < NP; ++p) sm90::fence_operand(d[p]);
}

// The same stages consumed without products (a tile every pair of which the
// warpgroup masks).
template <int SA>
__device__ __forceinline__ void skip_slices(int& ia, int n_slices, uint32_t full, uint32_t empty) {
  for (int sl = 0; sl < n_slices; ++sl, ++ia) {
    sm90::mbar_wait(full + 8 * (ia % SA), (ia / SA) & 1);
    sm90::mbar_arrive(empty + 8 * (ia % SA));
  }
}

// K1 above D = 256: one CTA per (b*h, 128-row q tile, N-column chunk), the q
// tiles in reverse order; BK-row K and V tiles up to the diagonal.
template <int N, int BK, int SA, int SB>
__global__ void __launch_bounds__(HT, 1)
fwd_wgmma_cols_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap to, float* __restrict__ lse, int S,
                      int D, float scale_log2, int causal) {
  constexpr uint32_t A_BYTES = SLICE_BYTES + BK * 128, B_BYTES = BK * N * 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t ra = sm90::smem_u32(smem), rb = ra + SA * A_BYTES;
  const uint32_t full_a = rb + SB * B_BYTES, empty_a = full_a + 8 * SA;
  const uint32_t full_b = empty_a + 8 * SA, empty_b = full_b + 8 * SB;

  const int bh = blockIdx.x, q0 = (gridDim.y - 1 - blockIdx.y) * 128, c0 = blockIdx.z * N;
  const int slabs = min(N, D - c0) / 64;
  const int kv_end = causal ? min(S, q0 + 128) : S;
  const int n_tiles = (kv_end + BK - 1) / BK, n_slices = D / 64;
  if (threadIdx.x == 0) {
    for (int st = 0; st < SA; ++st) {
      sm90::mbar_init(full_a + 8 * st, 1);
      sm90::mbar_init(empty_a + 8 * st, 2 * WG);
    }
    for (int st = 0; st < SB; ++st) {
      sm90::mbar_init(full_b + 8 * st, 1);
      sm90::mbar_init(empty_b + 8 * st, 2 * WG);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  // the role is warp-uniform to the compiler: setmaxnreg is warpgroup-collective
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / WG, 0);
  if (wg == 2) {   // producer
    sm90::reg_dealloc<24>();
    if (threadIdx.x == 2 * WG) {
      int ia = 0;
      for (int it = 0; it < n_tiles; ++it) {
        for (int sl = 0; sl < n_slices; ++sl, ++ia) {
          const int st = ia % SA;
          const uint32_t a = ra + st * A_BYTES;
          sm90::mbar_wait(empty_a + 8 * st, ((ia / SA) & 1) ^ 1);
          sm90::mbar_expect_tx(full_a + 8 * st, A_BYTES);
          load_tile<64, 128>(a, &tq, full_a + 8 * st, q0, bh, sl * 64);
          load_tile<64, BK>(a + SLICE_BYTES, &tk, full_a + 8 * st, it * BK, bh, sl * 64);
        }
        const int st = it % SB;
        sm90::mbar_wait(empty_b + 8 * st, ((it / SB) & 1) ^ 1);
        sm90::mbar_expect_tx(full_b + 8 * st, slabs * BK * 128);
        load_tile<N, BK>(rb + st * B_BYTES, &tv, full_b + 8 * st, it * BK, bh, c0, slabs);
      }
    }
  } else {   // consumers
    sm90::reg_alloc<240>();
    const int tid = threadIdx.x % WG, t = tid & 3;
    const int row_lo = q0 + wg * 64 + (tid / 32) * 16 + ((tid & 31) >> 2);   // and row_lo + 8
    const uint32_t a_off[1] = {0}, b_off[1] = {SLICE_BYTES};
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    float o[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) o[i] = 0.f;

    int ia = 0;
    for (int it = 0; it < n_tiles; ++it) {
      float s[1][BK / 2];
      float alpha[2];
      slice_products<BK, SA, 1>(s, ia, n_slices, ra, A_BYTES, a_off, b_off, full_a, empty_a, wg);
      online_softmax<BK>(s[0], m, l, alpha, row_lo, it * BK, q0 + wg * 64, S, causal, t,
                         scale_log2);
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        o[4 * j + 0] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }
      uint32_t pa[BK / 16][4];
      acc_to_a<BK>(pa, s[0]);   // P rounded to v's dtype
      const int sb = it % SB;
      sm90::mbar_wait(full_b + 8 * sb, (it / SB) & 1);
      sm90::fence_operand(o);
      sm90::wgmma_fence();
      product_mn<N, BK>(o, pa, rb + sb * B_BYTES);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_operand(o);
      sm90::mbar_arrive(empty_b + 8 * sb);
    }

    const float l_lo = fmaxf(l[0], 1e-30f), l_hi = fmaxf(l[1], 1e-30f);
    if (t == 0 && blockIdx.z == 0) {
      float* out = lse + (size_t)bh * S;
      if (row_lo < S) out[row_lo] = m[0] * LN2 + logf(l_lo);
      if (row_lo + 8 < S) out[row_lo + 8] = m[1] * LN2 + logf(l_hi);
    }
    sm90::named_barrier(3, 2 * WG);   // both warpgroups are done with ring A
    store_tile<N>(smem, o, &to, wg, q0 + wg * 64, bh, 1.f / l_lo, 1.f / l_hi, c0, slabs);
  }
}

// K2 above D = 256: one CTA per (b*h, 128-row q tile, N-column chunk of dQ),
// the q tiles in reverse order; BK-row K and V tiles up to the diagonal. The
// CTA's lse and delta rows are loaded once.
template <int N, int BK, int SA, int SB>
__global__ void __launch_bounds__(HT, 1)
dq_wgmma_cols_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ CUtensorMap tdq,
                     const __grid_constant__ CUtensorMap tlse,
                     const __grid_constant__ CUtensorMap tdelta, int S, int D, float scale,
                     int causal) {
  constexpr uint32_t A_BYTES = 2 * SLICE_BYTES + 2 * BK * 128, B_BYTES = BK * N * 2;
  constexpr uint32_t R_BYTES = 128 * 4;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t ra = sm90::smem_u32(smem), rb = ra + SA * A_BYTES;
  const uint32_t rows = rb + SB * B_BYTES;             // lse[128], delta[128]
  const uint32_t q_bar = rows + 2 * R_BYTES;
  const uint32_t full_a = q_bar + 8, empty_a = full_a + 8 * SA;
  const uint32_t full_b = empty_a + 8 * SA, empty_b = full_b + 8 * SB;
  const float* lse_s = reinterpret_cast<const float*>(smem + (rows - ra));
  const float* delta_s = lse_s + 128;

  const int bh = blockIdx.x, q0 = (gridDim.y - 1 - blockIdx.y) * 128, c0 = blockIdx.z * N;
  const int slabs = min(N, D - c0) / 64;
  const int kv_end = causal ? min(S, q0 + 128) : S;
  const int n_tiles = (kv_end + BK - 1) / BK, n_slices = D / 64;
  if (threadIdx.x == 0) {
    sm90::mbar_init(q_bar, 1);
    for (int st = 0; st < SA; ++st) {
      sm90::mbar_init(full_a + 8 * st, 1);
      sm90::mbar_init(empty_a + 8 * st, 2 * WG);
    }
    for (int st = 0; st < SB; ++st) {
      sm90::mbar_init(full_b + 8 * st, 1);
      sm90::mbar_init(empty_b + 8 * st, 2 * WG);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  // the role is warp-uniform to the compiler: setmaxnreg is warpgroup-collective
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / WG, 0);
  if (wg == 2) {   // producer
    sm90::reg_dealloc<24>();
    if (threadIdx.x == 2 * WG) {
      sm90::mbar_expect_tx(q_bar, 2 * R_BYTES);
      for (int h = 0; h < 2; ++h) {
        sm90::tma_load_2d(rows + h * 256, &tlse, q_bar, q0 + 64 * h, bh);
        sm90::tma_load_2d(rows + R_BYTES + h * 256, &tdelta, q_bar, q0 + 64 * h, bh);
      }
      int ia = 0;
      for (int it = 0; it < n_tiles; ++it) {
        for (int sl = 0; sl < n_slices; ++sl, ++ia) {
          const int st = ia % SA;
          const uint32_t a = ra + st * A_BYTES, bar = full_a + 8 * st;
          sm90::mbar_wait(empty_a + 8 * st, ((ia / SA) & 1) ^ 1);
          sm90::mbar_expect_tx(bar, A_BYTES);
          load_tile<64, 128>(a, &tq, bar, q0, bh, sl * 64);
          load_tile<64, 128>(a + SLICE_BYTES, &tdo, bar, q0, bh, sl * 64);
          load_tile<64, BK>(a + 2 * SLICE_BYTES, &tk, bar, it * BK, bh, sl * 64);
          load_tile<64, BK>(a + 2 * SLICE_BYTES + BK * 128, &tv, bar, it * BK, bh, sl * 64);
        }
        const int st = it % SB;
        sm90::mbar_wait(empty_b + 8 * st, ((it / SB) & 1) ^ 1);
        sm90::mbar_expect_tx(full_b + 8 * st, slabs * BK * 128);
        load_tile<N, BK>(rb + st * B_BYTES, &tk, full_b + 8 * st, it * BK, bh, c0, slabs);
      }
    }
  } else {   // consumers
    sm90::reg_alloc<240>();
    const int tid = threadIdx.x % WG, t = tid & 3;
    const int qw = q0 + wg * 64;                                   // the warpgroup's first q row
    const int lr = wg * 64 + (tid / 32) * 16 + ((tid & 31) >> 2);   // local row, and lr + 8
    const int row_lo = q0 + lr;
    const float scale_log2 = scale * LOG2E;
    const uint32_t a_off[2] = {0, SLICE_BYTES};
    const uint32_t b_off[2] = {2 * SLICE_BYTES, 2 * SLICE_BYTES + BK * 128};
    float dq[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) dq[i] = 0.f;

    sm90::mbar_wait(q_bar, 0);
    const float lse2[2] = {lse_s[lr] * LOG2E, lse_s[lr + 8] * LOG2E};
    const float dl[2] = {delta_s[lr], delta_s[lr + 8]};
    int ia = 0;
    for (int it = 0; it < n_tiles; ++it) {
      const int k0 = it * BK, sb = it % SB;
      if (causal && k0 > qw + 63) {   // every (q, kv) pair is masked
        skip_slices<SA>(ia, n_slices, full_a, empty_a);
        sm90::mbar_wait(full_b + 8 * sb, (it / SB) & 1);
        sm90::mbar_arrive(empty_b + 8 * sb);
        continue;
      }
      float sd[2][BK / 2];   // S and dP
      slice_products<BK, SA, 2>(sd, ia, n_slices, ra, A_BYTES, a_off, b_off, full_a, empty_a,
                                wg);
      const bool edge = (causal && k0 + BK - 1 > qw) || k0 + BK > S || qw + 64 > S;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sd[0][4 * j + e];
          if (edge && !live(row_lo + 8 * (e >> 1), k0 + 8 * j + 2 * t + (e & 1), S, causal))
            x = NEG_INF;
          const float p = exp2f(fmaf(x, scale_log2, -lse2[e >> 1]));
          sd[1][4 * j + e] = p * (sd[1][4 * j + e] - dl[e >> 1]) * scale;
        }
      uint32_t dsa[BK / 16][4];
      acc_to_a<BK>(dsa, sd[1]);   // dS rounded to k's dtype
      sm90::mbar_wait(full_b + 8 * sb, (it / SB) & 1);
      sm90::fence_operand(dq);
      sm90::wgmma_fence();
      product_mn<N, BK>(dq, dsa, rb + sb * B_BYTES);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_operand(dq);
      sm90::mbar_arrive(empty_b + 8 * sb);
    }
    sm90::named_barrier(3, 2 * WG);   // both warpgroups are done with ring A
    store_tile<N>(smem, dq, &tdq, wg, qw, bh, 1.f, 1.f, c0, slabs);
  }
}

// K3 above D = 256: one CTA per (b*h, 64-row kv tile, N-column chunk of dK
// and dV), kv tile 0 first; 64-row q tiles from the diagonal. The score
// products stream D through ring A, a stage one 64-wide slice of the CTA's
// K and V rows and of the q tile's Q and dO rows; ring B carries the q
// tile's N chunk columns of Q and dO, with its lse and delta. The
// warpgroups split the work as dkv_halves does at D = 256; a warpgroup
// whose 128 output columns lie past D (in a last chunk of 64 or 128
// columns) computes its scores and skips its products. Ring A, free once
// both warpgroups passed the last q tile's barrier, carries dK and dV out.
template <int N, int SA, int SB>
__global__ void __launch_bounds__(HT, 1)
dkv_wgmma_cols_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const __grid_constant__ CUtensorMap tdk,
                      const __grid_constant__ CUtensorMap tdv,
                      const __grid_constant__ CUtensorMap tlse,
                      const __grid_constant__ CUtensorMap tdelta, int S, int D, float scale,
                      int causal) {
  static_assert(N == 256, "two warpgroups of 128 output columns");
  constexpr uint32_t A_BYTES = 4 * BOX_BYTES, B_BYTES = 2 * 64 * N * 2;
  constexpr uint32_t R_BYTES = 64 * 4, PD_BYTES = 2 * BOX_BYTES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t ra = sm90::smem_u32(smem), rb = ra + SA * A_BYTES;
  const uint32_t pds = rb + SB * B_BYTES;     // (P^T, dS^T) x 2 buffers
  const uint32_t rows = pds + 2 * PD_BYTES;   // lse[SB][64], delta[SB][64]
  const uint32_t full_a = rows + SB * 2 * R_BYTES, empty_a = full_a + 8 * SA;
  const uint32_t full_b = empty_a + 8 * SA, empty_b = full_b + 8 * SB;
  const float* lse_s = reinterpret_cast<const float*>(smem + (rows - ra));
  const float* delta_s = lse_s + SB * 64;

  const int bh = blockIdx.x, k0 = blockIdx.y * 64, c0 = blockIdx.z * N;
  const int slabs = min(N, D - c0) / 64;
  const int q_start = causal ? k0 : 0;
  const int n_tiles = (S - q_start + 63) / 64, n_slices = D / 64;
  if (threadIdx.x == 0) {
    for (int st = 0; st < SA; ++st) {
      sm90::mbar_init(full_a + 8 * st, 1);
      sm90::mbar_init(empty_a + 8 * st, 2 * WG);
    }
    for (int st = 0; st < SB; ++st) {
      sm90::mbar_init(full_b + 8 * st, 1);
      sm90::mbar_init(empty_b + 8 * st, 2 * WG);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  // the role is warp-uniform to the compiler: setmaxnreg is warpgroup-collective
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / WG, 0);
  if (wg == 2) {   // producer
    sm90::reg_dealloc<24>();
    if (threadIdx.x == 2 * WG) {
      int ia = 0;
      for (int it = 0; it < n_tiles; ++it) {
        const int q0 = q_start + it * 64;
        for (int sl = 0; sl < n_slices; ++sl, ++ia) {
          const int st = ia % SA;
          const uint32_t a = ra + st * A_BYTES, bar = full_a + 8 * st;
          sm90::mbar_wait(empty_a + 8 * st, ((ia / SA) & 1) ^ 1);
          sm90::mbar_expect_tx(bar, A_BYTES);
          load_tile<64, 64>(a, &tk, bar, k0, bh, sl * 64);
          load_tile<64, 64>(a + BOX_BYTES, &tv, bar, k0, bh, sl * 64);
          load_tile<64, 64>(a + 2 * BOX_BYTES, &tq, bar, q0, bh, sl * 64);
          load_tile<64, 64>(a + 3 * BOX_BYTES, &tdo, bar, q0, bh, sl * 64);
        }
        const int st = it % SB;
        const uint32_t b = rb + st * B_BYTES, bar = full_b + 8 * st;
        sm90::mbar_wait(empty_b + 8 * st, ((it / SB) & 1) ^ 1);
        sm90::mbar_expect_tx(bar, 2 * slabs * BOX_BYTES + 2 * R_BYTES);
        load_tile<N, 64>(b, &tq, bar, q0, bh, c0, slabs);
        load_tile<N, 64>(b + B_BYTES / 2, &tdo, bar, q0, bh, c0, slabs);
        sm90::tma_load_2d(rows + st * R_BYTES, &tlse, bar, q0, bh);
        sm90::tma_load_2d(rows + (SB + st) * R_BYTES, &tdelta, bar, q0, bh);
      }
    }
  } else {   // consumers
    sm90::reg_alloc<240>();
    const int qc = 32 * wg;            // the warpgroup's q columns of a tile
    const bool own = 2 * wg < slabs;   // its output columns reach inside D
    const uint32_t a_off[2] = {0, BOX_BYTES};   // K and V: the same rows for both
    const uint32_t b_off[2] = {2 * BOX_BYTES + qc * 128, 3 * BOX_BYTES + qc * 128};
    float dk[64], dv[64];   // output columns [c0 + 128 wg, c0 + 128 wg + 128)
#pragma unroll
    for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;

    int ia = 0;
    for (int it = 0; it < n_tiles; ++it) {
      const int q0 = q_start + it * 64, sb = it % SB;
      float sd[2][16];   // S^T and dP^T
      slice_products<32, SA, 2>(sd, ia, n_slices, ra, A_BYTES, a_off, b_off, full_a, empty_a,
                                0);
      sm90::mbar_wait(full_b + 8 * sb, (it / SB) & 1);   // lse, delta, the chunk's columns
      const uint32_t pd = pds + (it & 1) * PD_BYTES;
      dkv_pds(sd[0], sd[1], smem + (pd - ra), lse_s + sb * 64, delta_s + sb * 64, q0, qc, k0,
              S, causal, scale);
      sm90::named_barrier(3, 2 * WG);   // both halves of P^T and dS^T are written
      const uint32_t b = rb + sb * B_BYTES + wg * 2 * BOX_BYTES;
      if (own) dkv_half_products(dv, dk, pd, b + B_BYTES / 2, b);
      sm90::mbar_arrive(empty_b + 8 * sb);
    }
    if (own) {
      const int n = min(2, slabs - 2 * wg);
      store_rows64<128>(smem + wg * 2 * BOX_BYTES, dk, &tdk, wg, k0, bh, c0 + 128 * wg, n);
      store_rows64<128>(smem + (4 + 2 * wg) * BOX_BYTES, dv, &tdv, wg, k0, bh, c0 + 128 * wg,
                        n);
    }
  }
}

// Shared-memory bytes of each kernel.
// The CUDA-core kernels' query tile: 64 rows, 32 at D = 256, where four f32
// tiles of 64 rows (dQ, dK/dV) would need more than an SM's 227 KB.
constexpr int q_tile(int d) { return d > 128 ? 32 : BQ; }
constexpr size_t fwd_smem(int d, int qt) {
  return 4u * ((size_t)(qt + 2 * BK) * (d + 1) + qt * PP);
}
constexpr size_t dq_smem(int d, int qt) {
  return 4u * ((size_t)(2 * qt + 2 * BK) * (d + 1) + qt * PP + 2 * qt);
}
constexpr size_t dkv_smem(int d, int qt) {
  return 4u * ((size_t)(2 * qt + 2 * BK) * (d + 1) + 2 * BK * (qt + 1) + 2 * qt);
}
constexpr size_t rows_bytes(int d) { return 2u * 64 * (d + 8); }
constexpr size_t cols_bytes(int d) { return 2u * d * TP; }

// The *_cols kernels (D > 256): output columns per chunk, query rows per
// tile, and shared memory (83 KB forward, 117 KB dQ, 100 KB dK/dV).
constexpr int COLS_DC = 128;
constexpr int FWD_COLS_QT = 64, DQ_COLS_QT = 64, DKV_COLS_QT = 32;
constexpr size_t fwd_cols_smem(int dc, int qt) {
  return 4u * ((size_t)2 * qt * PP + BK * PP + BK * (dc + 1));
}
constexpr size_t dq_cols_smem(int dc, int qt) {
  return 4u * ((size_t)3 * qt * PP + 2 * BK * PP + BK * (dc + 1) + 2 * qt);
}
constexpr size_t dkv_cols_smem(int dc, int qt) {
  return 4u * ((size_t)2 * BK * PP + 2 * qt * PP + 2 * qt * (dc + 1) + 2 * BK * (qt + 1) + 2 * qt);
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem, cudaStream_t st,
                   Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, st>>>(args...);
  return cudaGetLastError();
}

// ---- host side of the wgmma kernels: tensor maps and launch ----------------

// bf16 [bh, s, d] in boxes of 64 columns x box_rows rows, 128-byte swizzle,
// zeros past the edges.
bool tile_map(CUtensorMap* map, const void* ptr, int bh, int s, int d, int box_rows = 64) {
  const sm90::EncodeTiled encode = sm90::encode_tiled();
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)s * d * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1}, step[3] = {1, 1, 1};
  return encode && encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                          strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// f32 [bh, s] (lse, delta) in boxes of 64 entries, zeros past S.
bool row_map(CUtensorMap* map, const void* ptr, int bh, int s) {
  return sm90::matrix_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, ptr, bh, s, 1, 64, false);
}

using sm90::check_registers;

// Dynamic shared-memory bytes of the wgmma kernels (1024 for alignment).
constexpr size_t fwd_wgmma_smem(int d, int bk, int stages) {
  return 1024 + 2u * 128 * d + 2 * stages * 2u * bk * d + 8 * (1 + 2 * stages);
}
// K3's kv rows a CTA (64 at D = 256, dkv_halves), and its (Q, dO) stages
constexpr int dkv_tile(int d) { return d == 256 ? 64 : 128; }
constexpr int dkv_stages(int d) { return d == 256 ? 2 : 3; }
constexpr size_t dkv_wgmma_smem(int d, int stages) {
  return 1024 + 2 * 2u * dkv_tile(d) * d + stages * (2 * 2u * 64 * d + 2 * 4u * 64) +
         (d == 256 ? 4u * BOX_BYTES : 0) + 8 * (1 + 2 * stages);
}
constexpr size_t dq_wgmma_smem(int d, int bk, int stages) {
  return 1024 + 2 * 2u * 128 * d + stages * 2 * 2u * bk * d + 2 * 4u * 128 + 8 * (1 + 2 * stages);
}
constexpr int fwd_bk(int d) { return d == 256 ? 64 : 128; }
constexpr int fwd_stages(int d) { return d == 64 ? 3 : 2; }
constexpr int dq_bk(int d) { return d == 256 ? 32 : 64; }
constexpr int DQ_STAGES = 3;
// bf16 above D = 256 (the wgmma chunk kernels): output columns per chunk,
// kv rows per tile, and the stages of rings A and B.
constexpr int COLS_N = 256;
constexpr int FWD_COLS_BK = 64, FWD_COLS_SA = 6, FWD_COLS_SB = 2;
constexpr int DQ_COLS_BK = 32, DQ_COLS_SA = 4, DQ_COLS_SB = 2;
constexpr int DKV_COLS_SA = 2, DKV_COLS_SB = 2;
constexpr size_t fwd_wgmma_cols_smem(int bk, int sa, int sb) {
  return 1024 + sa * (SLICE_BYTES + bk * 128u) + sb * bk * COLS_N * 2u + 8 * 2 * (sa + sb);
}
constexpr size_t dq_wgmma_cols_smem(int bk, int sa, int sb) {
  return 1024 + sa * (2 * SLICE_BYTES + 2 * bk * 128u) + sb * bk * COLS_N * 2u + 2 * 4u * 128 +
         8 * (1 + 2 * (sa + sb));
}
constexpr size_t dkv_wgmma_cols_smem(int sa, int sb) {
  return 1024 + sa * 4u * BOX_BYTES + sb * (2 * 2u * 64 * COLS_N + 2 * 4u * 64) + 4u * BOX_BYTES +
         8 * 2 * (sa + sb);
}
constexpr size_t SMEM_LIMIT = 232448;   // an H100 block's opt-in maximum (227 KB)
static_assert(fwd_wgmma_cols_smem(FWD_COLS_BK, FWD_COLS_SA, FWD_COLS_SB) <= SMEM_LIMIT &&
                  FWD_COLS_SA * (SLICE_BYTES + FWD_COLS_BK * 128) >= 128 * COLS_N * 2,
              "K1 above D 256: the rings, and ring A holds the output tile");
static_assert(dq_wgmma_cols_smem(DQ_COLS_BK, DQ_COLS_SA, DQ_COLS_SB) <= SMEM_LIMIT &&
                  DQ_COLS_SA * (2 * SLICE_BYTES + 2 * DQ_COLS_BK * 128) >= 128 * COLS_N * 2,
              "K2 above D 256: the rings, and ring A holds the output tile");
static_assert(fwd_wgmma_smem(256, fwd_bk(256), fwd_stages(256)) <= SMEM_LIMIT, "K1 at D 256");
static_assert(dq_wgmma_smem(256, dq_bk(256), DQ_STAGES) <= SMEM_LIMIT, "K2 at D 256");
static_assert(dkv_wgmma_smem(256, dkv_stages(256)) <= SMEM_LIMIT, "K3 at D 256");
static_assert(dkv_wgmma_cols_smem(DKV_COLS_SA, DKV_COLS_SB) <= SMEM_LIMIT &&
                  DKV_COLS_SA * 4 * BOX_BYTES >= 2 * 64 * COLS_N * 2,
              "K3 above D 256: the rings, and ring A holds the dK and dV tiles");
static_assert(dkv_cols_smem(COLS_DC, DKV_COLS_QT) <= SMEM_LIMIT, "f32 K3 above D 256");

template <int D>
cudaError_t run_fwd_wgmma(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                          int s, float scale, int causal, cudaStream_t st) {
  constexpr int BKF = fwd_bk(D), STAGES = fwd_stages(D);
  CUtensorMap tq, tk, tv, to;
  if (s % 8 != 0 || !tile_map(&tq, q, bh, s, D) || !tile_map(&tk, k, bh, s, D) || !tile_map(&tv, v, bh, s, D) ||
      !tile_map(&to, o, bh, s, D))
    return cudaErrorInvalidValue;
  auto kernel = fwd_wgmma_kernel<D, BKF, STAGES>;
  const cudaError_t err = check_registers(kernel);
  if (err != cudaSuccess) return err;
  return launch(kernel, dim3(bh, (s + 127) / 128), HT, fwd_wgmma_smem(D, BKF, STAGES), st, tq,
                tk, tv, to, (float*)lse, s, scale * LOG2E, causal);
}

template <int D>
cudaError_t run_dkv_wgmma(const void* q, const void* k, const void* v, const void* dout,
                          const void* lse, const void* delta, void* dk, void* dv, int bh, int s,
                          float scale, int causal, cudaStream_t st) {
  CUtensorMap tq, tk, tv, tdo, tdk, tdv, tlse, tdelta;
  if (s % 8 != 0 || !tile_map(&tq, q, bh, s, D) || !tile_map(&tk, k, bh, s, D) || !tile_map(&tv, v, bh, s, D) ||
      !tile_map(&tdo, dout, bh, s, D) || !tile_map(&tdk, dk, bh, s, D) ||
      !tile_map(&tdv, dv, bh, s, D) || !row_map(&tlse, lse, bh, s) ||
      !row_map(&tdelta, delta, bh, s))
    return cudaErrorInvalidValue;
  constexpr int KT = dkv_tile(D), STAGES = dkv_stages(D);
  auto kernel = dkv_wgmma_kernel<D, STAGES>;
  const cudaError_t err = check_registers(kernel);
  if (err != cudaSuccess) return err;
  return launch(kernel, dim3(bh, (s + KT - 1) / KT), HT, dkv_wgmma_smem(D, STAGES), st, tq, tk,
                tv, tdo, tdk, tdv, tlse, tdelta, s, scale, causal);
}

template <int D>
cudaError_t run_dq_wgmma(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, void* dq, int bh, int s, float scale,
                         int causal, cudaStream_t st) {
  constexpr int BKQ = dq_bk(D);
  CUtensorMap tq, tk, tv, tdo, tdq, tlse, tdelta;
  if (s % 8 != 0 || !tile_map(&tq, q, bh, s, D) || !tile_map(&tk, k, bh, s, D, BKQ) ||
      !tile_map(&tv, v, bh, s, D, BKQ) || !tile_map(&tdo, dout, bh, s, D) ||
      !tile_map(&tdq, dq, bh, s, D) || !row_map(&tlse, lse, bh, s) ||
      !row_map(&tdelta, delta, bh, s))
    return cudaErrorInvalidValue;
  auto kernel = dq_wgmma_kernel<D, BKQ, DQ_STAGES>;
  const cudaError_t err = check_registers(kernel);
  if (err != cudaSuccess) return err;
  return launch(kernel, dim3(bh, (s + 127) / 128), HT, dq_wgmma_smem(D, BKQ, DQ_STAGES), st, tq,
                tk, tv, tdo, tdq, tlse, tdelta, s, scale, causal);
}

// Which kernel runs, a rule of (kernel, dtype, head dim). The wgmma kernels
// need S % 8 == 0 (TMA's 16-byte row strides of lse and delta), which every S
// that supports() admits meets.
enum Kernel { K_FWD = 0, K_DQ = 1, K_DKV = 2 };
enum Route { R_NONE, R_WGMMA, R_MMA, R_CORE, R_COLS, R_WGMMA_COLS };
// the widths of the *_cols kernels
constexpr bool cols_dim(int d) { return d > 256 && d % DS == 0; }
constexpr Route route(int kernel, bool bf, int d) {
  if (d > 256) {
    if (!cols_dim(d)) return R_NONE;
    return bf ? R_WGMMA_COLS : R_COLS;
  }
  if (d != 16 && d != 32 && d != 64 && d != 128 && d != 256) return R_NONE;
  if (!bf) return R_CORE;                   // f32: scalar FMA
  if (d <= 32) return R_MMA;                // mma.sync m16n8k16
  return R_WGMMA;                           // D 64, 128, 256
}
template <typename T>
constexpr bool is_bf16() { return std::is_same<T, bf16>::value; }
// above 256 the launchers split by dtype at compile time, as route() does
static_assert(route(K_FWD, true, 320) == R_WGMMA_COLS && route(K_DQ, true, 320) == R_WGMMA_COLS &&
                  route(K_DKV, true, 320) == R_WGMMA_COLS && route(K_FWD, false, 320) == R_COLS &&
                  route(K_DQ, false, 320) == R_COLS && route(K_DKV, false, 320) == R_COLS,
              "the *_cols launchers follow route()");

template <typename T, int D>
cudaError_t run_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                    int s, float scale, int causal, cudaStream_t st) {
  constexpr Route r = route(K_FWD, is_bf16<T>(), D);
  constexpr int QT = q_tile(D);
  if constexpr (r == R_WGMMA)
    return run_fwd_wgmma<D>(q, k, v, o, lse, bh, s, scale, causal, st);
  else if constexpr (r == R_MMA)
    return launch(fwd_mma_kernel<D>, dim3((s + 63) / 64, bh), MT, rows_bytes(D) + cols_bytes(D),
                  st, (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse, s,
                  scale, causal);
  else
    return launch(fwd_kernel<T, D, QT>, dim3((s + QT - 1) / QT, bh), NT, fwd_smem(D, QT), st,
                  (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse, s, scale, causal);
}

template <typename T, int D>
cudaError_t run_dq(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dq, int bh, int s, float scale,
                   int causal, cudaStream_t st) {
  constexpr Route r = route(K_DQ, is_bf16<T>(), D);
  constexpr int QT = q_tile(D);
  if constexpr (r == R_WGMMA)
    return run_dq_wgmma<D>(q, k, v, dout, lse, delta, dq, bh, s, scale, causal, st);
  else if constexpr (r == R_MMA)
    return launch(dq_mma_kernel<D>, dim3((s + 63) / 64, bh), MT, 2 * rows_bytes(D) + cols_bytes(D),
                  st, (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
                  (const float*)lse, (const float*)delta, (bf16*)dq, s, scale, causal);
  else
    return launch(dq_kernel<T, D, QT>, dim3((s + QT - 1) / QT, bh), NT, dq_smem(D, QT), st,
                  (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (const float*)lse,
                  (const float*)delta, (T*)dq, s, scale, causal);
}

template <typename T, int D>
cudaError_t run_dkv(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, void* dk, void* dv, int bh, int s,
                    float scale, int causal, cudaStream_t st) {
  constexpr Route r = route(K_DKV, is_bf16<T>(), D);
  constexpr int QT = q_tile(D);
  const dim3 grid((s + 63) / 64, bh);
  if constexpr (r == R_WGMMA)
    return run_dkv_wgmma<D>(q, k, v, dout, lse, delta, dk, dv, bh, s, scale, causal, st);
  else if constexpr (r == R_MMA)
    return launch(dkv_mma_kernel<D>, grid, MT,
                  2 * rows_bytes(D) + 2 * cols_bytes(D) + 2 * 64 * sizeof(float), st,
                  (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
                  (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv, s, scale,
                  causal);
  else
    return launch(dkv_kernel<T, D, QT>, grid, NT, dkv_smem(D, QT), st, (const T*)q, (const T*)k,
                  (const T*)v, (const T*)dout, (const float*)lse, (const float*)delta, (T*)dk,
                  (T*)dv, s, scale, causal);
}

// D > 256 (a multiple of 64): the column-chunked kernels, grid axis z over
// the chunks (COLS_N wide on the tensor cores, COLS_DC on the CUDA cores).
cudaError_t run_fwd_wgmma_cols(int d, const void* q, const void* k, const void* v, void* o,
                               void* lse, int bh, int s, float scale, int causal,
                               cudaStream_t st) {
  CUtensorMap tq, tk, tv, to;
  if (s % 8 != 0 || !tile_map(&tq, q, bh, s, d) || !tile_map(&tk, k, bh, s, d) ||
      !tile_map(&tv, v, bh, s, d) || !tile_map(&to, o, bh, s, d))
    return cudaErrorInvalidValue;
  auto kernel = fwd_wgmma_cols_kernel<COLS_N, FWD_COLS_BK, FWD_COLS_SA, FWD_COLS_SB>;
  const cudaError_t err = check_registers(kernel);
  if (err != cudaSuccess) return err;
  return launch(kernel, dim3(bh, (s + 127) / 128, (d + COLS_N - 1) / COLS_N), HT,
                fwd_wgmma_cols_smem(FWD_COLS_BK, FWD_COLS_SA, FWD_COLS_SB), st, tq, tk, tv, to,
                (float*)lse, s, d, scale * LOG2E, causal);
}

cudaError_t run_dq_wgmma_cols(int d, const void* q, const void* k, const void* v,
                              const void* dout, const void* lse, const void* delta, void* dq,
                              int bh, int s, float scale, int causal, cudaStream_t st) {
  CUtensorMap tq, tk, tv, tdo, tdq, tlse, tdelta;
  if (s % 8 != 0 || !tile_map(&tq, q, bh, s, d) || !tile_map(&tk, k, bh, s, d, DQ_COLS_BK) ||
      !tile_map(&tv, v, bh, s, d, DQ_COLS_BK) || !tile_map(&tdo, dout, bh, s, d) ||
      !tile_map(&tdq, dq, bh, s, d) || !row_map(&tlse, lse, bh, s) ||
      !row_map(&tdelta, delta, bh, s))
    return cudaErrorInvalidValue;
  auto kernel = dq_wgmma_cols_kernel<COLS_N, DQ_COLS_BK, DQ_COLS_SA, DQ_COLS_SB>;
  const cudaError_t err = check_registers(kernel);
  if (err != cudaSuccess) return err;
  return launch(kernel, dim3(bh, (s + 127) / 128, (d + COLS_N - 1) / COLS_N), HT,
                dq_wgmma_cols_smem(DQ_COLS_BK, DQ_COLS_SA, DQ_COLS_SB), st, tq, tk, tv, tdo, tdq,
                tlse, tdelta, s, d, scale, causal);
}

template <typename T>
cudaError_t run_fwd_cols(int d, const void* q, const void* k, const void* v, void* o, void* lse,
                         int bh, int s, float scale, int causal, cudaStream_t st) {
  constexpr int QT = FWD_COLS_QT;
  if constexpr (is_bf16<T>())
    return run_fwd_wgmma_cols(d, q, k, v, o, lse, bh, s, scale, causal, st);
  else
    return launch(fwd_cols_kernel<T, COLS_DC, QT>,
                  dim3((s + QT - 1) / QT, bh, (d + COLS_DC - 1) / COLS_DC), NT,
                  fwd_cols_smem(COLS_DC, QT), st, (const T*)q, (const T*)k, (const T*)v, (T*)o,
                  (float*)lse, s, d, scale, causal);
}

template <typename T>
cudaError_t run_dq_cols(int d, const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dq, int bh, int s, float scale,
                        int causal, cudaStream_t st) {
  constexpr int QT = DQ_COLS_QT;
  if constexpr (is_bf16<T>())
    return run_dq_wgmma_cols(d, q, k, v, dout, lse, delta, dq, bh, s, scale, causal, st);
  else
    return launch(dq_cols_kernel<T, COLS_DC, QT>,
                  dim3((s + QT - 1) / QT, bh, (d + COLS_DC - 1) / COLS_DC), NT,
                  dq_cols_smem(COLS_DC, QT), st, (const T*)q, (const T*)k, (const T*)v,
                  (const T*)dout, (const float*)lse, (const float*)delta, (T*)dq, s, d, scale,
                  causal);
}

cudaError_t run_dkv_wgmma_cols(int d, const void* q, const void* k, const void* v,
                               const void* dout, const void* lse, const void* delta, void* dk,
                               void* dv, int bh, int s, float scale, int causal,
                               cudaStream_t st) {
  CUtensorMap tq, tk, tv, tdo, tdk, tdv, tlse, tdelta;
  if (s % 8 != 0 || !tile_map(&tq, q, bh, s, d) || !tile_map(&tk, k, bh, s, d) ||
      !tile_map(&tv, v, bh, s, d) || !tile_map(&tdo, dout, bh, s, d) ||
      !tile_map(&tdk, dk, bh, s, d) || !tile_map(&tdv, dv, bh, s, d) ||
      !row_map(&tlse, lse, bh, s) || !row_map(&tdelta, delta, bh, s))
    return cudaErrorInvalidValue;
  auto kernel = dkv_wgmma_cols_kernel<COLS_N, DKV_COLS_SA, DKV_COLS_SB>;
  const cudaError_t err = check_registers(kernel);
  if (err != cudaSuccess) return err;
  return launch(kernel, dim3(bh, (s + 63) / 64, (d + COLS_N - 1) / COLS_N), HT,
                dkv_wgmma_cols_smem(DKV_COLS_SA, DKV_COLS_SB), st, tq, tk, tv, tdo, tdk, tdv,
                tlse, tdelta, s, d, scale, causal);
}

template <typename T>
cudaError_t run_dkv_cols(int d, const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, void* dk, void* dv, int bh, int s,
                         float scale, int causal, cudaStream_t st) {
  if constexpr (is_bf16<T>())
    return run_dkv_wgmma_cols(d, q, k, v, dout, lse, delta, dk, dv, bh, s, scale, causal, st);
  else
    return launch(dkv_cols_kernel<T, COLS_DC, DKV_COLS_QT>,
                  dim3((s + BK - 1) / BK, bh, (d + COLS_DC - 1) / COLS_DC), NT,
                  dkv_cols_smem(COLS_DC, DKV_COLS_QT), st, (const T*)q, (const T*)k, (const T*)v,
                  (const T*)dout, (const float*)lse, (const float*)delta, (T*)dk, (T*)dv, s, d,
                  scale, causal);
}

}  // namespace

// Dispatch on dtype (0 = f32, 1 = bf16) and head dim: FN<T, D> for each
// width route() names below 256, FN##_cols<T>(d, ...) above it. Any other
// head dim returns cudaErrorInvalidValue (the wrapper pads before it calls).
#define FA_DISPATCH(FN, ...)                                                       \
  do {                                                                             \
    (void)cudaGetLastError();                                                      \
    if (bh <= 0 || s <= 0) return (int)cudaSuccess;                                \
    cudaStream_t st = (cudaStream_t)stream;                                        \
    if (dtype == 0) {                                                              \
      switch (d) {                                                                 \
        case 16: return (int)FN<float, 16>(__VA_ARGS__, st);                       \
        case 32: return (int)FN<float, 32>(__VA_ARGS__, st);                       \
        case 64: return (int)FN<float, 64>(__VA_ARGS__, st);                       \
        case 128: return (int)FN<float, 128>(__VA_ARGS__, st);                     \
        case 256: return (int)FN<float, 256>(__VA_ARGS__, st);                     \
      }                                                                            \
      if (cols_dim(d)) return (int)FN##_cols<float>(d, __VA_ARGS__, st);                \
    } else if (dtype == 1) {                                                       \
      switch (d) {                                                                 \
        case 16: return (int)FN<__nv_bfloat16, 16>(__VA_ARGS__, st);               \
        case 32: return (int)FN<__nv_bfloat16, 32>(__VA_ARGS__, st);               \
        case 64: return (int)FN<__nv_bfloat16, 64>(__VA_ARGS__, st);               \
        case 128: return (int)FN<__nv_bfloat16, 128>(__VA_ARGS__, st);             \
        case 256: return (int)FN<__nv_bfloat16, 256>(__VA_ARGS__, st);             \
      }                                                                            \
      if (cols_dim(d)) return (int)FN##_cols<__nv_bfloat16>(d, __VA_ARGS__, st);        \
    }                                                                              \
    return (int)cudaErrorInvalidValue;                                             \
  } while (0)

// Plain C entries, loaded with ctypes. Each returns the launch's cudaError_t.
extern "C" {

int fa_fwd(int dtype, int d, const void* q, const void* k, const void* v, void* o, void* lse,
           int bh, int s, float scale, int causal, void* stream) {
  FA_DISPATCH(run_fwd, q, k, v, o, lse, bh, s, scale, causal);
}

int fa_dq(int dtype, int d, const void* q, const void* k, const void* v, const void* dout,
          const void* lse, const void* delta, void* dq, int bh, int s, float scale, int causal,
          void* stream) {
  FA_DISPATCH(run_dq, q, k, v, dout, lse, delta, dq, bh, s, scale, causal);
}

int fa_dkv(int dtype, int d, const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dk, void* dv, int bh, int s, float scale,
           int causal, void* stream) {
  FA_DISPATCH(run_dkv, q, k, v, dout, lse, delta, dk, dv, bh, s, scale, causal);
}

// The kernel that fa_fwd (kernel 0), fa_dq (1) or fa_dkv (2) launches at this
// dtype and head dim, by route(); null where none takes it.
const char* fa_kernel_name(int kernel, int dtype, int d) {
  static const char* const names[6][3] = {
      {nullptr, nullptr, nullptr},
      {"fwd_wgmma_kernel", "dq_wgmma_kernel", "dkv_wgmma_kernel"},
      {"fwd_mma_kernel", "dq_mma_kernel", "dkv_mma_kernel"},
      {"fwd_kernel", "dq_kernel", "dkv_kernel"},
      {"fwd_cols_kernel", "dq_cols_kernel", "dkv_cols_kernel"},
      {"fwd_wgmma_cols_kernel", "dq_wgmma_cols_kernel", "dkv_wgmma_cols_kernel"}};
  if (kernel < 0 || kernel > 2 || dtype < 0 || dtype > 1) return nullptr;
  return names[route(kernel, dtype == 1, d)][kernel];
}

// Dynamic shared-memory bytes of the bf16 wgmma kernel (0: forward, 1: dQ,
// 2: dK/dV) at head dim d, or 0 where d takes another kernel.
int fa_wgmma_smem(int kernel, int d) {
  if (kernel < 0 || kernel > 2) return 0;
  if (route(kernel, true, d) == R_WGMMA_COLS) {
    switch (kernel) {
      case K_FWD: return (int)fwd_wgmma_cols_smem(FWD_COLS_BK, FWD_COLS_SA, FWD_COLS_SB);
      case K_DQ: return (int)dq_wgmma_cols_smem(DQ_COLS_BK, DQ_COLS_SA, DQ_COLS_SB);
      case K_DKV: return (int)dkv_wgmma_cols_smem(DKV_COLS_SA, DKV_COLS_SB);
    }
  }
  if (route(kernel, true, d) != R_WGMMA) return 0;
  switch (kernel) {
    case K_FWD: return (int)fwd_wgmma_smem(d, fwd_bk(d), fwd_stages(d));
    case K_DQ: return (int)dq_wgmma_smem(d, dq_bk(d), DQ_STAGES);
    case K_DKV: return (int)dkv_wgmma_smem(d, dkv_stages(d));
  }
  return 0;
}

}  // extern "C"
