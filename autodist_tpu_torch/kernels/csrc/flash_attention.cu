// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV kernels.
//
// Replaces the three Pallas TPU kernels of autodist_tpu/kernels/flash_attention.py:
//   fwd_kernel  <- _fwd_kernel  (launched by _fwd)
//   dq_kernel   <- _dq_kernel   (launched by _bwd)
//   dkv_kernel  <- _dkv_kernel  (launched by _bwd)
// and computes what they compute, with the same constants (mask value -1e30,
// l floored at 1e-30) and the same cast points: P is rounded to v's dtype
// before P.V, dS to k's dtype before dS.K and to q's dtype before dS^T.Q, and
// P to dO's dtype before P^T.dO. All sums are f32.
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
//   * bf16 runs on the tensor cores (mma.sync m16n8k16, f32 sums), with the
//     scores kept in registers between the two products of each step;
//   * the [S, S] score matrix never touches device memory: a CTA owns one
//     64-row tile and loops over the other operand's tiles, as the TPU grid's
//     sequential axis did, keeping its running sums in registers;
//   * causal tiles above the diagonal are skipped (the loop ends, or starts,
//     at the diagonal), which halves the work at long S;
//   * each CTA owns its output tile outright, so no atomics and no second
//     pass: results are deterministic.
// It is still a simple design: tiles are staged through shared memory with
// plain loads and no overlap of copy and compute, so a CTA stalls on every
// tile. wgmma, TMA staging and pipelining are the next steps toward the bound;
// they change no arithmetic contract above.
//
// f32 runs on the CUDA cores (scalar FMA; the tensor cores would round to
// TF32): 64 query rows x 64 key rows per step, 256 threads as a 16 x 16 grid.
// Thread (ty, tx) owns score rows ty + 16 i and columns tx + 16 j (i, j < 4),
// and output columns tx + 16 jd (jd < D / 16). The 16 threads that share a
// score row are one half-warp, so row max and row sum are shuffles. Shared
// tiles are stored as f32 with a row pitch of D + 1 words (no bank conflicts
// on the strided reads). The bf16 kernels' layout is described where they
// are defined. Supported: f32 and bf16, D in {16, 32, 64, 128}.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// Stage rows [row0, row0 + 64) of a [S, D] slab into shared memory as f32,
// row pitch D + 1, zero past S.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0, int S) {
  for (int idx = threadIdx.x; idx < 64 * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    const int g = row0 + r;
    dst[r * (D + 1) + c] = g < S ? to_f(src[(size_t)g * D + c]) : 0.f;
  }
}

// Stage 64 entries of a per-row f32 vector (lse, delta), zero past S.
__device__ __forceinline__ void load_rows(float* dst, const float* src, int row0, int S) {
  for (int r = threadIdx.x; r < 64; r += NT) dst[r] = row0 + r < S ? src[row0 + r] : 0.f;
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
// forward: one CTA per (b*h, 64-row q tile); loops over kv tiles up to the
// diagonal when causal; online softmax state per row in registers.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(NT)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           T* __restrict__ o, float* __restrict__ lse, int S, float scale, int causal) {
  constexpr int LD = D + 1;
  constexpr int DPT = D / TX;
  extern __shared__ float smem[];
  float* qs = smem;            // [64][LD]
  float* ks = qs + BQ * LD;    // [64][LD]
  float* vs = ks + BK * LD;    // [64][LD]
  float* ps = vs + BK * LD;    // [64][PP]

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int q0 = blockIdx.x * BQ;
  const size_t base = (size_t)blockIdx.y * S * D;
  q += base; k += base; v += base; o += base;
  lse += (size_t)blockIdx.y * S;

  load_tile<T, D>(qs, q, q0, S);

  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int jd = 0; jd < DPT; ++jd) acc[i][jd] = 0.f;
  }

  const int kv_end = causal ? min(S, q0 + BQ) : S;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile's ks / vs / ps reads are done
    load_tile<T, D>(ks, k, k0, S);
    load_tile<T, D>(vs, v, k0, S);
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float a[RPT], b[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) a[i] = qs[(ty + TY * i) * LD + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) b[j] = ks[(tx + TX * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
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
      for (int i = 0; i < RPT; ++i) {
        const float p = ps[(ty + TY * i) * PP + kk];
#pragma unroll
        for (int jd = 0; jd < DPT; ++jd) acc[i][jd] = fmaf(p, b[jd], acc[i][jd]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
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
// dQ: one CTA per (b*h, 64-row q tile); loops over kv tiles up to the diagonal.
// P = exp(S - lse); dS = P * (dP - delta) * scale, rounded to k's dtype;
// dQ = sum dS.K.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(NT)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, T* __restrict__ dq, int S, float scale,
          int causal) {
  constexpr int LD = D + 1;
  constexpr int DPT = D / TX;
  extern __shared__ float smem[];
  float* qs = smem;             // [64][LD]
  float* dos = qs + BQ * LD;    // [64][LD]
  float* ks = dos + BQ * LD;    // [64][LD]
  float* vs = ks + BK * LD;     // [64][LD]
  float* dss = vs + BK * LD;    // [64][PP]
  float* lse_s = dss + BQ * PP; // [64]
  float* delta_s = lse_s + BQ;  // [64]

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int q0 = blockIdx.x * BQ;
  const size_t base = (size_t)blockIdx.y * S * D;
  q += base; k += base; v += base; dout += base; dq += base;
  lse += (size_t)blockIdx.y * S;
  delta += (size_t)blockIdx.y * S;

  load_tile<T, D>(qs, q, q0, S);
  load_tile<T, D>(dos, dout, q0, S);
  load_rows(lse_s, lse, q0, S);
  load_rows(delta_s, delta, q0, S);

  float acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int jd = 0; jd < DPT; ++jd) acc[i][jd] = 0.f;

  const int kv_end = causal ? min(S, q0 + BQ) : S;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();
    load_tile<T, D>(ks, k, k0, S);
    load_tile<T, D>(vs, v, k0, S);
    __syncthreads();

    float s[RPT][CPT], dp[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float a[RPT], g[RPT], b[CPT], c[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        a[i] = qs[(ty + TY * i) * LD + d];
        g[i] = dos[(ty + TY * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        b[j] = ks[(tx + TX * j) * LD + d];
        c[j] = vs[(tx + TX * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          s[i][j] = fmaf(a[i], b[j], s[i][j]);
          dp[i][j] = fmaf(g[i], c[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
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
      for (int i = 0; i < RPT; ++i) {
        const float a = dss[(ty + TY * i) * PP + kk];
#pragma unroll
        for (int jd = 0; jd < DPT; ++jd) acc[i][jd] = fmaf(a, b[jd], acc[i][jd]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
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
template <typename T, int D>
__global__ void __launch_bounds__(NT)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int S,
           float scale, int causal) {
  constexpr int LD = D + 1;
  constexpr int DPT = D / TX;
  extern __shared__ float smem[];
  float* ks = smem;              // [64][LD]
  float* vs = ks + BK * LD;      // [64][LD]
  float* qs = vs + BK * LD;      // [64][LD]
  float* dos = qs + BQ * LD;     // [64][LD]
  float* pts = dos + BQ * LD;    // [64 kv][PP]
  float* dsts = pts + BK * PP;   // [64 kv][PP]
  float* lse_s = dsts + BK * PP; // [64]
  float* delta_s = lse_s + BQ;   // [64]

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

  const int q_start = causal ? (k0 / BQ) * BQ : 0;
  for (int q0 = q_start; q0 < S; q0 += BQ) {
    __syncthreads();
    load_tile<T, D>(qs, q, q0, S);
    load_tile<T, D>(dos, dout, q0, S);
    load_rows(lse_s, lse, q0, S);
    load_rows(delta_s, delta, q0, S);
    __syncthreads();

    float st[RPT][CPT], dpt[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) st[i][j] = dpt[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float a[RPT], g[RPT], b[CPT], c[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        a[i] = ks[(ty + TY * i) * LD + d];
        g[i] = vs[(ty + TY * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        b[j] = qs[(tx + TX * j) * LD + d];
        c[j] = dos[(tx + TX * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          st[i][j] = fmaf(a[i], b[j], st[i][j]);
          dpt[i][j] = fmaf(g[i], c[j], dpt[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty + TY * i;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = tx + TX * j;
        const float x = live(q0 + c, k0 + r, S, causal) ? st[i][j] * scale : NEG_INF;
        const float p = expf(x - lse_s[c]);
        pts[r * PP + c] = round_to<T>(p);
        dsts[r * PP + c] = round_to<T>(p * (dpt[i][j] - delta_s[c]) * scale);
      }
    }
    __syncthreads();

    for (int qq = 0; qq < BQ; ++qq) {
      float bo[DPT], bq[DPT];
#pragma unroll
      for (int jd = 0; jd < DPT; ++jd) {
        bo[jd] = dos[qq * LD + tx + TX * jd];
        bq[jd] = qs[qq * LD + tx + TX * jd];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float p = pts[(ty + TY * i) * PP + qq];
        const float ds = dsts[(ty + TY * i) * PP + qq];
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

// Shared-memory bytes of each kernel.
constexpr size_t fwd_smem(int d) { return 4u * ((size_t)(BQ + 2 * BK) * (d + 1) + BQ * PP); }
constexpr size_t dq_smem(int d) {
  return 4u * ((size_t)(2 * BQ + 2 * BK) * (d + 1) + BQ * PP + 2 * BQ);
}
constexpr size_t dkv_smem(int d) {
  return 4u * ((size_t)(2 * BQ + 2 * BK) * (d + 1) + 2 * BK * PP + 2 * BQ);
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

// f32 runs the CUDA-core kernels, bf16 the tensor-core ones.
template <typename T, int D>
cudaError_t run_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                    int s, float scale, int causal, cudaStream_t st) {
  const dim3 grid((s + 63) / 64, bh);
  if constexpr (std::is_same<T, bf16>::value)
    return launch(fwd_mma_kernel<D>, grid, MT, rows_bytes(D) + cols_bytes(D), st,
                  (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse, s,
                  scale, causal);
  else
    return launch(fwd_kernel<T, D>, grid, NT, fwd_smem(D), st, (const T*)q, (const T*)k,
                  (const T*)v, (T*)o, (float*)lse, s, scale, causal);
}

template <typename T, int D>
cudaError_t run_dq(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dq, int bh, int s, float scale,
                   int causal, cudaStream_t st) {
  const dim3 grid((s + 63) / 64, bh);
  if constexpr (std::is_same<T, bf16>::value)
    return launch(dq_mma_kernel<D>, grid, MT, 2 * rows_bytes(D) + cols_bytes(D), st,
                  (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
                  (const float*)lse, (const float*)delta, (bf16*)dq, s, scale, causal);
  else
    return launch(dq_kernel<T, D>, grid, NT, dq_smem(D), st, (const T*)q, (const T*)k,
                  (const T*)v, (const T*)dout, (const float*)lse, (const float*)delta, (T*)dq,
                  s, scale, causal);
}

template <typename T, int D>
cudaError_t run_dkv(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, void* dk, void* dv, int bh, int s,
                    float scale, int causal, cudaStream_t st) {
  const dim3 grid((s + 63) / 64, bh);
  if constexpr (std::is_same<T, bf16>::value)
    return launch(dkv_mma_kernel<D>, grid, MT,
                  2 * rows_bytes(D) + 2 * cols_bytes(D) + 2 * 64 * sizeof(float), st,
                  (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
                  (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv, s, scale,
                  causal);
  else
    return launch(dkv_kernel<T, D>, grid, NT, dkv_smem(D), st, (const T*)q, (const T*)k,
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
      }                                                                            \
    } else if (dtype == 1) {                                                       \
      switch (d) {                                                                 \
        case 16: return (int)FN<__nv_bfloat16, 16>(__VA_ARGS__, st);               \
        case 32: return (int)FN<__nv_bfloat16, 32>(__VA_ARGS__, st);               \
        case 64: return (int)FN<__nv_bfloat16, 64>(__VA_ARGS__, st);               \
        case 128: return (int)FN<__nv_bfloat16, 128>(__VA_ARGS__, st);             \
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

}  // extern "C"
