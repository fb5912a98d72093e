// RWKV6 WKV recurrence for Hopper (sm_90a), bound through a plain C
// interface (ctypes; see ../wkv6.py).
//
// Replaces the Pallas TPU kernel repro/kernels/wkv6/wkv6.py::wkv6_pallas
// (_wkv_kernel).  Same function, per (batch b, head h), state S (K x K):
//
//     o_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//     S[i][j] <- w_t[i] * S[i][j] + k_t[i] * v_t[j],   w_t = exp(logw_t)
//
// Design: the recurrence token by token, not the TPU's chunk blocks.
// One block per (b, h), one thread per state column j, which keeps
// S[:, j] in registers for the whole sequence: columns never interact,
// so the state needs no shared memory and no reduction.  Per token each
// thread stages its own r[j], k[j], w[j] and r[j]*u[j]*k[j] in shared
// memory (double-buffered, so one barrier per token suffices), then
// reads all K of them back as broadcasts.  The next token's inputs are
// loaded into registers before the current token is computed, so their
// latency overlaps the arithmetic.  r, k and v are read in their own
// type (float32 or bfloat16); everything is accumulated in float32; o
// and the final state are written in float32.
//
// What bounds it on an H100: the bytes (r, k, v, logw read once, o
// written once; 4*K^2 flops per token and head is below the card's
// float32 rate for the bytes moved), but this simple form does not reach
// that bound: its (b, h) blocks of K threads give the card a few warps
// per SM, and each token is a dependent step.  Splitting the rows of S
// over more threads, or the chunked tensor-core form (wgmma, TMA), is a
// later change.
//
// The token-by-token form never forms exp(+cum) or exp(-cum) of a
// chunk's cumulative log-decay, so it stays finite at the reference's
// clamp (logw = -1) for any sequence length.  The reference's chunked
// form is finite there only up to chunk ~88: at its default of 128 tokens
// exp(-cum) overflows float32 and its output turns to NaN.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// grid: B*H blocks; block: K threads (thread j owns column j of S).
// r, k, v, logw, o: (B, S, H, K); u: (H, K); s0, s_end: (B, H, K, K).
template <typename T, int K>
__global__ void __launch_bounds__(K)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ logw,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ o, float* __restrict__ s_end, int S, int H) {
  __shared__ __align__(16) float sh_r[2][K];
  __shared__ __align__(16) float sh_k[2][K];
  __shared__ __align__(16) float sh_w[2][K];
  __shared__ __align__(16) float sh_ruk[2][K];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - (bh / H) * H;
  const int j = threadIdx.x;
  const long long tok_stride = static_cast<long long>(H) * K;
  const long long base = static_cast<long long>(b) * S * tok_stride +
                         static_cast<long long>(h) * K + j;
  const float* s_in = s0 ? s0 + static_cast<long long>(bh) * K * K : nullptr;

  float s[K];
#pragma unroll
  for (int i = 0; i < K; ++i) s[i] = s_in ? s_in[i * K + j] : 0.f;
  const float uj = u[h * K + j];

  // inputs of token 0
  float nr = to_float(r[base]), nk = to_float(k[base]),
        nv = to_float(v[base]), nlw = logw[base];

  for (int t = 0; t < S; ++t) {
    const int buf = t & 1;
    const float rj = nr, kj = nk, vj = nv;
    sh_r[buf][j] = rj;
    sh_k[buf][j] = kj;
    sh_w[buf][j] = expf(nlw);
    sh_ruk[buf][j] = rj * uj * kj;
    __syncthreads();
    if (t + 1 < S) {  // prefetch token t+1 while token t computes
      const long long nx = base + (t + 1) * tok_stride;
      nr = to_float(r[nx]);
      nk = to_float(k[nx]);
      nv = to_float(v[nx]);
      nlw = logw[nx];
    }
    const float4* r4 = reinterpret_cast<const float4*>(sh_r[buf]);
    const float4* k4 = reinterpret_cast<const float4*>(sh_k[buf]);
    const float4* w4 = reinterpret_cast<const float4*>(sh_w[buf]);
    const float4* q4 = reinterpret_cast<const float4*>(sh_ruk[buf]);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    float bonus[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i4 = 0; i4 < K / 4; ++i4) {
      const float4 rr = r4[i4], kk = k4[i4], ww = w4[i4], qq = q4[i4];
      const float rv[4] = {rr.x, rr.y, rr.z, rr.w};
      const float kv[4] = {kk.x, kk.y, kk.z, kk.w};
      const float wv[4] = {ww.x, ww.y, ww.z, ww.w};
      const float qv[4] = {qq.x, qq.y, qq.z, qq.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = i4 * 4 + c;
        acc[c] = fmaf(rv[c], s[i], acc[c]);
        bonus[c] += qv[c];
        s[i] = fmaf(wv[c], s[i], kv[c] * vj);
      }
    }
    o[base + t * tok_stride] = (acc[0] + acc[1]) + (acc[2] + acc[3]) +
                               ((bonus[0] + bonus[1]) + (bonus[2] + bonus[3])) * vj;
  }

  float* s_out = s_end + static_cast<long long>(bh) * K * K;
#pragma unroll
  for (int i = 0; i < K; ++i) s_out[i * K + j] = s[i];
}

template <typename T>
static int launch_typed(const void* r, const void* k, const void* v,
                        const float* logw, const float* u, const float* s0,
                        float* o, float* s_end, int B, int S, int H, int K,
                        cudaStream_t st) {
  const dim3 grid(B * H);
#define WKV6_CASE(KK)                                                     \
  case KK:                                                                \
    wkv6_kernel<T, KK><<<grid, KK, 0, st>>>(                              \
        static_cast<const T*>(r), static_cast<const T*>(k),               \
        static_cast<const T*>(v), logw, u, s0, o, s_end, S, H);           \
    break;
  switch (K) {
    WKV6_CASE(16)
    WKV6_CASE(32)
    WKV6_CASE(64)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef WKV6_CASE
  return static_cast<int>(cudaGetLastError());
}

extern "C" {

// r, k, v: float32 (bf16 == 0) or bfloat16 (bf16 == 1); logw, u, s0
// (nullable: a zero state), o, s_end: float32.  Returns the launch's
// cudaError_t.
int wkv6_launch(const void* r, const void* k, const void* v,
                const float* logw, const float* u, const float* s0,
                float* o, float* s_end, int B, int S, int H, int K,
                int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_typed<__nv_bfloat16>(r, k, v, logw, u, s0, o, s_end, B,
                                       S, H, K, st);
  return launch_typed<float>(r, k, v, logw, u, s0, o, s_end, B, S, H, K,
                             st);
}

}  // extern "C"
