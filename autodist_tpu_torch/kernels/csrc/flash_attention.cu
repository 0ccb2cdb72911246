// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV kernels.
//
// Replaces the three Pallas TPU kernels of autodist_tpu/kernels/flash_attention.py:
//   fwd_wgmma_kernel (bf16, D 64/128), fwd_mma_kernel (bf16, D 16/32),
//   fwd_kernel (f32)                                  <- _fwd_kernel
//   dq_wgmma_kernel (bf16, D 64/128), dq_mma_kernel (bf16, D 16/32),
//   dq_kernel (f32)                                   <- _dq_kernel
//   dkv_wgmma_kernel (bf16, D 64/128), dkv_mma_kernel (bf16, D 16/32),
//   dkv_kernel (f32)                                  <- _dkv_kernel
// and computes what they compute, with the same constants (mask value -1e30,
// l floored at 1e-30) and the same cast points: P is rounded to v's dtype
// before P.V, dS to k's dtype before dS.K and to q's dtype before dS^T.Q, and
// P to dO's dtype before P^T.dO. All sums are f32. Which kernel runs is a
// rule of dtype and shape, fixed before the launch (run_fwd / run_dq /
// run_dkv): bf16 at D = 64 or 128 takes the wgmma kernels (S a multiple of
// 8, as supports() admits), other bf16 the mma.sync ones.
//
// Layout: q, k, v, o, dO, dq, dk, dv are contiguous [B*H, S, D]; lse and delta
// are f32 [B*H, S]. Causal masking is by global position (q_pos >= k_pos
// kept); rows or columns past S (a ragged edge) are masked and never stored.
//
// What bounds these kernels on an H100. At the gpt_small shape
// (B4 H12 S4096 D64, causal, bf16) the forward does 1.03e11 FLOP on 101 MB, so
// it is bound by operations (0.10 ms at 989 TFLOP/s on the tensor cores
// against 0.03 ms for the bytes); dQ does 1.5x and dK/dV 2x the forward's
// operations. What the design does about that:
//   * bf16 runs on the tensor cores with f32 sums; at D = 64 and 128 all
//     three kernels as Hopper's warpgroup products (wgmma) fed by TMA
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
// query tile shrinks to QT = 32 rows there (q_tile), and bf16 at D = 256
// runs these kernels too, with T = bf16 keeping its cast points: the
// mma.sync kernels hold a warp's A fragments and its D-wide accumulators in
// registers, which at D = 256 is more than the 255 a thread may have. The
// bf16 kernels' layout is described where they are defined. Supported: f32
// and bf16, D in {16, 32, 64, 128, 256}; the wrapper zero-pads any other
// D <= 256 to the next of these.

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
// bf16 at D = 64 and 128: warp-specialised wgmma kernels (K1 forward, K2
// dQ, K3 dK/dV). 384 threads: warpgroups 0 and 1 consume, each owning 64 rows of
// the CTA's 128-row output tile; warpgroup 2 produces: one thread issues
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

// TMA rows [row0, row0 + ROWS) of head bh into a swizzled [ROWS][D] tile.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int row0, int bh) {
#pragma unroll
  for (int s = 0; s < D / 64; ++s)
#pragma unroll
    for (int rb = 0; rb < ROWS / 64; ++rb)
      sm90::tma_load_3d(dst + (s * (ROWS / 64) + rb) * BOX_BYTES, map, bar, s * 64, row0 + rb * 64,
                        bh);
}

// A warpgroup's 64 x D accumulator, row-scaled and rounded to bf16, into its
// rows [64 wg, 64 wg + 64) of a swizzled [128][D] tile; then TMA to rows
// [row0, row0 + 64) of head bh. All 128 threads of the warpgroup call it.
template <int D>
__device__ __forceinline__ void store_tile(unsigned char* tile, const float (&acc)[D / 2],
                                           const CUtensorMap* map, int wg, int row0, int bh,
                                           float s_lo = 1.f, float s_hi = 1.f) {
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
    for (int s = 0; s < D / 64; ++s) sm90::tma_store_3d(map, base + s * 128 * 128, s * 64, row0, bh);
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
  if constexpr (N == 64) sm90::wgmma_ss_n64(d, da, db, acc);
  else sm90::wgmma_ss_n128(d, da, db, acc);
}
template <int N>
__device__ __forceinline__ void rs_product(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 64) sm90::wgmma_rs_n64(d, a, db, 1);
  else sm90::wgmma_rs_n128(d, a, db, 1);
}

// d (64 x N) = A . B^T over D: A the warpgroup's 64 rows of a swizzled
// [AR][D] tile at a, B a swizzled [N][D] tile at b, both K-major.
template <int D, int N, int AR>
__device__ __forceinline__ void product_k(float (&d)[N / 2], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t da = a + (kk / 4) * AR * 128 + (kk % 4) * 32;
    const uint32_t db = b + (kk / 4) * N * 128 + (kk % 4) * 32;
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
// through the ring up to the diagonal.
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

// K3: one CTA per (b*h, 128-row kv tile), kv tile 0 (the most causal work)
// first; q tiles of 64 rows with their lse and delta stream through the
// ring from the diagonal. S^T = K.Q^T and dP^T = V.dO^T read Q and dO
// K-major; dV += P^T.dO and dK += dS^T.Q read the same tiles MN-major.
template <int D, int STAGES>
__global__ void __launch_bounds__(HT, 1)
dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                 const __grid_constant__ CUtensorMap tdk, const __grid_constant__ CUtensorMap tdv,
                 const __grid_constant__ CUtensorMap tlse,
                 const __grid_constant__ CUtensorMap tdelta, int S, float scale, int causal) {
  constexpr uint32_t KV_BYTES = 128 * D * 2, T_BYTES = 64 * D * 2, R_BYTES = 64 * 4;
  extern __shared__ unsigned char smem_raw[];
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

// K2: one CTA per (b*h, 128-row q tile), the q tiles in reverse order so the
// longest causal rows are scheduled first. The CTA's Q, dO, lse and delta
// rows are loaded once; K and V tiles of 64 rows stream through the ring up
// to the diagonal. S = Q.K^T and dP = dO.V^T read K and V K-major; dQ +=
// dS.K reads the same K tile MN-major.
template <int D, int STAGES>
__global__ void __launch_bounds__(HT, 1)
dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                const __grid_constant__ CUtensorMap tdq, const __grid_constant__ CUtensorMap tlse,
                const __grid_constant__ CUtensorMap tdelta, int S, float scale, int causal) {
  constexpr uint32_t Q_BYTES = 128 * D * 2, T_BYTES = 64 * D * 2, R_BYTES = 128 * 4;
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
  const int n_tiles = (kv_end + 63) / 64;
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
        load_tile<D, 64>(sk(st), &tk, full(st), it * 64, bh);
        load_tile<D, 64>(sv(st), &tv, full(st), it * 64, bh);
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
      const int st = it % STAGES, k0 = it * 64;
      sm90::mbar_wait(full(st), (it / STAGES) & 1);
      if (!(causal && k0 > qw + 63)) {   // else every (q, kv) pair is masked
        float s[32], dp[32];
        sm90::wgmma_fence();
        product_k<D, 64, 128>(s, sq + wg * BOX_BYTES, sk(st));
        product_k<D, 64, 128>(dp, sdo + wg * BOX_BYTES, sv(st));
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_operand(s);
        sm90::fence_operand(dp);
        const bool edge = (causal && k0 + 63 > qw) || k0 + 64 > S || qw + 64 > S;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = s[4 * j + e];
            if (edge && !live(row_lo + 8 * (e >> 1), k0 + 8 * j + 2 * t + (e & 1), S, causal))
              x = NEG_INF;
            const float p = exp2f(fmaf(x, scale_log2, -lse2[e >> 1]));
            dp[4 * j + e] = p * (dp[4 * j + e] - dl[e >> 1]) * scale;
          }
        uint32_t dsa[4][4];
        acc_to_a<64>(dsa, dp);   // dS rounded to k's dtype
        sm90::fence_operand(dq);
        sm90::wgmma_fence();
        product_mn<D, 64>(dq, dsa, sk(st));
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

// bf16 [bh, s, d] in 64 x 64 boxes, 128-byte swizzle, zeros past the edges.
bool tile_map(CUtensorMap* map, const void* ptr, int bh, int s, int d) {
  const sm90::EncodeTiled encode = sm90::encode_tiled();
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)s * d * 2};
  const cuuint32_t box[3] = {64, 64, 1}, step[3] = {1, 1, 1};
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
constexpr size_t dkv_wgmma_smem(int d, int stages) {
  return 1024 + 2 * 2u * 128 * d + stages * (2 * 2u * 64 * d + 2 * 4u * 64) + 8 * (1 + 2 * stages);
}
constexpr size_t dq_wgmma_smem(int d, int stages) {
  return 1024 + 2 * 2u * 128 * d + stages * 2 * 2u * 64 * d + 2 * 4u * 128 + 8 * (1 + 2 * stages);
}
constexpr int FWD_BK = 128;
constexpr int fwd_stages(int d) { return d == 64 ? 3 : 2; }
constexpr int DKV_STAGES = 3;
constexpr int DQ_STAGES = 3;

template <int D>
cudaError_t run_fwd_wgmma(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                          int s, float scale, int causal, cudaStream_t st) {
  constexpr int STAGES = fwd_stages(D);
  CUtensorMap tq, tk, tv, to;
  if (s % 8 != 0 || !tile_map(&tq, q, bh, s, D) || !tile_map(&tk, k, bh, s, D) || !tile_map(&tv, v, bh, s, D) ||
      !tile_map(&to, o, bh, s, D))
    return cudaErrorInvalidValue;
  auto kernel = fwd_wgmma_kernel<D, FWD_BK, STAGES>;
  const cudaError_t err = check_registers(kernel);
  if (err != cudaSuccess) return err;
  return launch(kernel, dim3(bh, (s + 127) / 128), HT, fwd_wgmma_smem(D, FWD_BK, STAGES), st, tq,
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
  auto kernel = dkv_wgmma_kernel<D, DKV_STAGES>;
  const cudaError_t err = check_registers(kernel);
  if (err != cudaSuccess) return err;
  return launch(kernel, dim3(bh, (s + 127) / 128), HT, dkv_wgmma_smem(D, DKV_STAGES), st, tq, tk,
                tv, tdo, tdk, tdv, tlse, tdelta, s, scale, causal);
}

template <int D>
cudaError_t run_dq_wgmma(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, void* dq, int bh, int s, float scale,
                         int causal, cudaStream_t st) {
  CUtensorMap tq, tk, tv, tdo, tdq, tlse, tdelta;
  if (s % 8 != 0 || !tile_map(&tq, q, bh, s, D) || !tile_map(&tk, k, bh, s, D) ||
      !tile_map(&tv, v, bh, s, D) || !tile_map(&tdo, dout, bh, s, D) ||
      !tile_map(&tdq, dq, bh, s, D) || !row_map(&tlse, lse, bh, s) ||
      !row_map(&tdelta, delta, bh, s))
    return cudaErrorInvalidValue;
  auto kernel = dq_wgmma_kernel<D, DQ_STAGES>;
  const cudaError_t err = check_registers(kernel);
  if (err != cudaSuccess) return err;
  return launch(kernel, dim3(bh, (s + 127) / 128), HT, dq_wgmma_smem(D, DQ_STAGES), st, tq, tk,
                tv, tdo, tdq, tlse, tdelta, s, scale, causal);
}

// bf16 at D = 64 and 128 takes the wgmma kernels, D = 16 and 32 the
// mma.sync ones. The wgmma kernels need S % 8 == 0 (TMA's 16-byte row
// strides of lse and delta), which every S that supports() admits meets.
constexpr bool wgmma_dim(int d) { return d == 64 || d == 128; }

// f32 runs the CUDA-core kernels, bf16 the tensor-core ones up to D = 128 and
// the CUDA-core ones (T = bf16) at D = 256.
template <typename T>
constexpr bool mma_dim(int d) {
  return std::is_same<T, bf16>::value && d <= 128;
}

template <typename T, int D>
cudaError_t run_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                    int s, float scale, int causal, cudaStream_t st) {
  const dim3 grid((s + 63) / 64, bh);
  constexpr int QT = q_tile(D);
  if constexpr (std::is_same<T, bf16>::value && wgmma_dim(D))
    return run_fwd_wgmma<D>(q, k, v, o, lse, bh, s, scale, causal, st);
  else if constexpr (mma_dim<T>(D))
    return launch(fwd_mma_kernel<D>, grid, MT, rows_bytes(D) + cols_bytes(D), st,
                  (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse, s,
                  scale, causal);
  else
    return launch(fwd_kernel<T, D, QT>, dim3((s + QT - 1) / QT, bh), NT, fwd_smem(D, QT), st,
                  (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse, s, scale, causal);
}

template <typename T, int D>
cudaError_t run_dq(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dq, int bh, int s, float scale,
                   int causal, cudaStream_t st) {
  const dim3 grid((s + 63) / 64, bh);
  constexpr int QT = q_tile(D);
  if constexpr (std::is_same<T, bf16>::value && wgmma_dim(D))
    return run_dq_wgmma<D>(q, k, v, dout, lse, delta, dq, bh, s, scale, causal, st);
  else if constexpr (mma_dim<T>(D))
    return launch(dq_mma_kernel<D>, grid, MT, 2 * rows_bytes(D) + cols_bytes(D), st,
                  (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
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
  const dim3 grid((s + 63) / 64, bh);
  constexpr int QT = q_tile(D);
  if constexpr (std::is_same<T, bf16>::value && wgmma_dim(D))
    return run_dkv_wgmma<D>(q, k, v, dout, lse, delta, dk, dv, bh, s, scale, causal, st);
  else if constexpr (mma_dim<T>(D))
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

}  // namespace

// Dispatch on dtype (0 = f32, 1 = bf16) and head dim; FN is a run_* template.
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
    } else if (dtype == 1) {                                                       \
      switch (d) {                                                                 \
        case 16: return (int)FN<__nv_bfloat16, 16>(__VA_ARGS__, st);               \
        case 32: return (int)FN<__nv_bfloat16, 32>(__VA_ARGS__, st);               \
        case 64: return (int)FN<__nv_bfloat16, 64>(__VA_ARGS__, st);               \
        case 128: return (int)FN<__nv_bfloat16, 128>(__VA_ARGS__, st);             \
        case 256: return (int)FN<__nv_bfloat16, 256>(__VA_ARGS__, st);             \
      }                                                                            \
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

// Dynamic shared-memory bytes of the bf16 wgmma kernel (0: forward, 1: dK/dV,
// 2: dQ) at head dim d, or 0 where d takes the mma.sync kernels.
int fa_wgmma_smem(int kernel, int d) {
  if (!wgmma_dim(d)) return 0;
  switch (kernel) {
    case 0: return (int)fwd_wgmma_smem(d, FWD_BK, fwd_stages(d));
    case 1: return (int)dkv_wgmma_smem(d, DKV_STAGES);
    case 2: return (int)dq_wgmma_smem(d, DQ_STAGES);
  }
  return 0;
}

}  // extern "C"
