// Token cross-entropy of the LM head for Hopper (sm_90a): the NLL of each
// row of logits against its target, and the NLL's gradient.
//
// Replaces no TPU kernel: the JAX package leaves the loss of
// autodist_tpu/models/transformer.py to XLA. The plain version is the f32
// logsumexp - gather in kernels/cross_entropy.py.
//
//   xent_fwd_kernel:  lse_r = log sum_j exp(x_rj),  nll_r = lse_r - x_r,t_r
//   xent_bwd_kernel:  dx_rj = g_r * exp(x_rj - lse_r) - (j == t_r ? g_r : 0)
//
// in f32 from the logits' own dtype (bf16 or f32), the gradient summed in
// f32 and rounded once to that dtype, as the plain version rounds it. g is
// dL/dnll per row, so a mask or a mean's count reaches the kernel through it.
//
// What bounds it on an H100: bytes. The forward reads R x V logits once
// (1.65 GB at [16384, 50257] bf16, 0.49 ms at 3.35 TB/s) and the backward
// reads them once more and writes the gradient once (0.98 ms); a few
// operations an element stay far under the card's rate. What the design
// does about that:
//   * one block a row, NT threads, so a 16,384-row step keeps every SM full
//     for many waves, and each thread holds UNROLL 16-byte loads in flight
//     (about 128 KB a full SM) before it reduces them;
//   * the forward reads each row once: a running max and sum of exps in
//     f32 (base 2, the max rescaling the sum when it grows), merged across
//     the warp by shuffles and across the block through shared memory; the
//     gold logit is one element read at the start;
//   * the logits are taken at any row stride of at least V (a padded head's
//     rows), and a row that does not start on 16 bytes (V odd) is read as a
//     scalar head up to the first 16-byte boundary, the vector body, and a
//     scalar tail. The gradient is written with the logits' row stride and
//     alignment (the wrapper allocates it so), so its rows split the same
//     way and its stores are 16 bytes too;
//   * the backward takes exp as expf(x - lse), the operation and rounding
//     of the plain version, so the gradient it rounds differs from that
//     version's by at most the last f32 bits; the forward's exps go through ex2.approx,
//     whose 2^-22 relative error averages out in the sum.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;      // threads of a block (one row)
constexpr int NW = NT / 32;  // warps of a block
constexpr int UNROLL = 4;    // 16-byte vectors a thread loads before it uses them
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}

// The elements of a 16-byte vector, in f32: 8 bf16 or 4 f32.
template <typename T>
struct Vec;
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const int4& v, float* f) {
    const uint32_t w[4] = {(uint32_t)v.x, (uint32_t)v.y, (uint32_t)v.z, (uint32_t)v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static int4 pack(const float* f) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<uint32_t*>(&h);
    }
    return make_int4((int)w[0], (int)w[1], (int)w[2], (int)w[3]);
  }
};
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const int4& v, float* f) {
    f[0] = __int_as_float(v.x);
    f[1] = __int_as_float(v.y);
    f[2] = __int_as_float(v.z);
    f[3] = __int_as_float(v.w);
  }
  __device__ static int4 pack(const float* f) {
    return make_int4(__float_as_int(f[0]), __float_as_int(f[1]), __float_as_int(f[2]),
                     __float_as_int(f[3]));
  }
};

// Elements of a row before its first 16-byte boundary (at most v).
template <typename T>
__device__ __forceinline__ int row_head(const T* row, int v) {
  const int mis = (int)(reinterpret_cast<uintptr_t>(row) & 15);
  const int head = mis ? (16 - mis) / (int)sizeof(T) : 0;
  return head < v ? head : v;
}

// Running max m (base 2: the max of x * log2 e) and sum s of exp2(y - m).
struct Online {
  float m = -INFINITY, s = 0.f;

  // Fold in n elements whose largest is xmax.
  __device__ __forceinline__ void add(const float* x, int n, float xmax) {
    const float vm = xmax * LOG2E;
    if (vm > m) {
      s *= ex2(m - vm);
      m = vm;
    }
    const float off = m == -INFINITY ? 0.f : m;  // an all -inf row adds 0s, not NaNs
#pragma unroll
    for (int i = 0; i < n; ++i) s += ex2(fmaf(x[i], LOG2E, -off));
  }

  __device__ __forceinline__ void merge(float m2, float s2) {
    const float mm = fmaxf(m, m2);
    const float off = mm == -INFINITY ? 0.f : mm;
    s = s * ex2(m - off) + s2 * ex2(m2 - off);
    m = mm;
  }
};

template <typename T>
__global__ void __launch_bounds__(NT) xent_fwd_kernel(const T* __restrict__ x, long long stride,
                                                      const long long* __restrict__ tgt, int v,
                                                      float* __restrict__ nll,
                                                      float* __restrict__ lse) {
  constexpr int VN = Vec<T>::N;
  const int r = blockIdx.x;
  const T* row = x + (long long)r * stride;
  float gold = 0.f;
  if (threadIdx.x == 0) {
    const long long t = tgt[r];
    gold = (t >= 0 && t < v) ? to_f32(row[t]) : NAN;  // a target outside the vocab: NaN
  }
  const int head = row_head(row, v);
  const int nvec = (v - head) / VN;
  const int tail = head + nvec * VN;
  Online acc;
  for (int j = threadIdx.x; j < head; j += NT) {
    const float f = to_f32(row[j]);
    acc.add(&f, 1, f);
  }
  for (int j = tail + threadIdx.x; j < v; j += NT) {
    const float f = to_f32(row[j]);
    acc.add(&f, 1, f);
  }
  const int4* body = reinterpret_cast<const int4*>(row + head);
  for (int base = threadIdx.x; base < nvec; base += NT * UNROLL) {
    int4 buf[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (base + u * NT < nvec) buf[u] = __ldcs(body + base + u * NT);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (base + u * NT < nvec) {
        float f[VN];
        Vec<T>::unpack(buf[u], f);
        float xmax = f[0];
#pragma unroll
        for (int i = 1; i < VN; ++i) xmax = fmaxf(xmax, f[i]);
        acc.add(f, VN, xmax);
      }
    }
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, acc.m, o);
    const float s2 = __shfl_xor_sync(0xffffffffu, acc.s, o);
    acc.merge(m2, s2);
  }
  __shared__ float part_m[NW], part_s[NW];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    part_m[warp] = acc.m;
    part_s[warp] = acc.s;
  }
  __syncthreads();
  if (warp == 0) {
    Online all;
    if (lane < NW) {
      all.m = part_m[lane];
      all.s = part_s[lane];
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, all.m, o);
      const float s2 = __shfl_xor_sync(0xffffffffu, all.s, o);
      all.merge(m2, s2);
    }
    if (lane == 0) {
      const float l = (all.m + log2f(all.s)) * LN2;
      lse[r] = l;
      nll[r] = l - gold;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) xent_bwd_kernel(const T* __restrict__ x, long long stride,
                                                      const long long* __restrict__ tgt,
                                                      const float* __restrict__ lse,
                                                      const float* __restrict__ g,
                                                      T* __restrict__ dx, int v) {
  constexpr int VN = Vec<T>::N;
  const int r = blockIdx.x;
  const T* row = x + (long long)r * stride;
  T* out = dx + (long long)r * stride;
  const float l = lse[r], gr = g[r];
  const long long t = tgt[r];
  const int head = row_head(row, v);
  const int nvec = (v - head) / VN;
  const int tail = head + nvec * VN;
  for (int j = threadIdx.x; j < head; j += NT) {
    const float d = gr * expf(to_f32(row[j]) - l);
    out[j] = from_f32<T>(j == t ? d - gr : d);
  }
  for (int j = tail + threadIdx.x; j < v; j += NT) {
    const float d = gr * expf(to_f32(row[j]) - l);
    out[j] = from_f32<T>(j == t ? d - gr : d);
  }
  const int4* body = reinterpret_cast<const int4*>(row + head);
  int4* obody = reinterpret_cast<int4*>(out + head);
  const long long tv = t - head;  // the target's place in the body
  for (int base = threadIdx.x; base < nvec; base += NT * UNROLL) {
    int4 buf[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (base + u * NT < nvec) buf[u] = __ldcs(body + base + u * NT);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = base + u * NT;
      if (i < nvec) {
        float f[VN];
        Vec<T>::unpack(buf[u], f);
#pragma unroll
        for (int k = 0; k < VN; ++k) {
          const float d = gr * expf(f[k] - l);
          f[k] = (long long)i * VN + k == tv ? d - gr : d;
        }
        __stcs(obody + i, Vec<T>::pack(f));
      }
    }
  }
}

template <typename T>
cudaError_t run_fwd(const void* x, long long stride, const void* tgt, int rows, int v, void* nll,
                    void* lse, cudaStream_t st) {
  if (reinterpret_cast<uintptr_t>(x) % sizeof(T)) return cudaErrorInvalidValue;
  xent_fwd_kernel<T><<<rows, NT, 0, st>>>(static_cast<const T*>(x), stride,
                                          static_cast<const long long*>(tgt), v,
                                          static_cast<float*>(nll), static_cast<float*>(lse));
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_bwd(const void* x, long long stride, const void* tgt, const void* lse,
                    const void* g, void* dx, int rows, int v, cudaStream_t st) {
  // the gradient's rows must split where the logits' rows do
  if (reinterpret_cast<uintptr_t>(x) % sizeof(T) ||
      ((reinterpret_cast<uintptr_t>(x) ^ reinterpret_cast<uintptr_t>(dx)) & 15))
    return cudaErrorInvalidValue;
  xent_bwd_kernel<T><<<rows, NT, 0, st>>>(
      static_cast<const T*>(x), stride, static_cast<const long long*>(tgt),
      static_cast<const float*>(lse), static_cast<const float*>(g), static_cast<T*>(dx), v);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Plain C entries, loaded with ctypes; each returns its launch's cudaError_t.
// dtype codes: 0 = f32, 1 = bf16. x: logits [rows, v] in that dtype, row
// stride `stride` elements (>= v), unit column stride; tgt: int64 [rows];
// nll, lse, g: f32 [rows]; dx: the gradient, laid out as x (same stride, the
// same address modulo 16).
int xent_fwd(int dtype, const void* x, long long stride, const void* tgt, int rows, int v,
             void* nll, void* lse, void* stream) {
  (void)cudaGetLastError();
  if (rows <= 0) return (int)cudaSuccess;
  if (v <= 0 || stride < v) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return (int)run_fwd<__nv_bfloat16>(x, stride, tgt, rows, v, nll, lse, st);
  if (dtype == 0) return (int)run_fwd<float>(x, stride, tgt, rows, v, nll, lse, st);
  return (int)cudaErrorInvalidValue;
}

int xent_bwd(int dtype, const void* x, long long stride, const void* tgt, const void* lse,
             const void* g, void* dx, int rows, int v, void* stream) {
  (void)cudaGetLastError();
  if (rows <= 0) return (int)cudaSuccess;
  if (v <= 0 || stride < v) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)run_bwd<__nv_bfloat16>(x, stride, tgt, lse, g, dx, rows, v, st);
  if (dtype == 0) return (int)run_bwd<float>(x, stride, tgt, lse, g, dx, rows, v, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
