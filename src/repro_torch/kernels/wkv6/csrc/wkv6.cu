// RWKV6 WKV recurrence for Hopper (sm_90a), bound through a plain C
// interface (ctypes; see ../wkv6.py).
//
// Replaces the Pallas TPU kernel repro/kernels/wkv6/wkv6.py::wkv6_pallas
// (_wkv_kernel).  Same function, per (batch b, head h), state S (K x K):
//
//     o_t[j] = sum_i r_t[i] * S[i][j] + v_t[j] * sum_i r_t[i] u[i] k_t[i]
//     S[i][j] <- w_t[i] * S[i][j] + k_t[i] * v_t[j],   w_t = exp(logw_t)
//
// What bounds it on an H100: the bytes (r, k, v, logw read once, o
// written once, 22.7 us at the rwkv6-3b prefill call in bf16) and close
// behind them the float32 work: the state update is a multiply and an FMA
// per element and token, the output one more FMA, about 3 K^2
// instructions per token and head (34 us of issue at that call).  Each
// token depends on the one before, so the design spreads that work over
// enough warps and keeps what each token costs in shared-memory reads,
// shuffles and barriers small:
//   * a tile of the state per lane: R rows x CL columns in registers
//     (WKV6_TILES, chosen from K and the call's length; rwkv6's K = 64
//     prefill runs 4 x 4 with 4 warps a block, 320 blocks).  Each r, k, w value a lane reads from shared
//     memory feeds CL columns, each v value R rows;
//   * the lanes holding one column group's rows join their partial
//     outputs by a halving butterfly of __shfl_xor_sync (each step a lane
//     keeps half its columns and sends the other half), and the bonus
//     sum_i r_i u_i k_i rides in the same sums (u in registers);
//   * inputs staged by chunks of 16 tokens in a ring of 3 shared-memory
//     buffers with cp.async, raw (bf16 widened in registers as it is
//     read); exp(logw) is taken in place one chunk ahead.  One barrier
//     per chunk; the token loop reads no device memory but writes o;
//   * two tokens per step, interleaved, so one token's shuffle sums
//     overlap the next one's FMAs;
//   * a decode step (S <= 2) skips the staging: each lane reads its own
//     rows and columns from device memory (no barrier), with the tile
//     (16, 4, 1) at K = 64: 320 one-warp blocks whose
//     lanes each hold 64 state values, so every lane has its share of the
//     state's 16-byte loads in flight at once.
// The recurrence itself stays token by token in float32 (the chunk is a
// staging unit, not the reference's factored chunk form): it never forms
// exp(+cum) or exp(-cum) of a cumulative log-decay, so it stays finite at
// the reference's clamp (logw = -1) for any sequence length.  The
// reference's chunked form is finite there only up to chunk ~88: at its
// default of 128 tokens exp(-cum) overflows float32 and its output turns
// to NaN.  r, k and v are read in their own type (float32 or bfloat16)
// and widened exactly; sums and the state are float32; o and the final
// state are written in float32.

#include <atomic>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

static constexpr int kMaxDevices = 64;  // device ordinals remembered
static constexpr int kChunk = 16;  // tokens staged per barrier
static constexpr int kRing = 3;    // chunks of staging buffers
static constexpr int kDirect = 2;  // up to this many tokens: no staging

// Element i of a staged row of T sits at i plus 16 bytes per 128 bytes
// before it: the 16-byte reads of the row lanes of one quarter-warp then
// fall in different banks (a no-op for bf16 rows of K <= 64).
template <typename T>
__device__ __forceinline__ constexpr int slot(int i) {
  return i + (16 / static_cast<int>(sizeof(T))) *
                 (i * static_cast<int>(sizeof(T)) / 128);
}

__device__ __forceinline__ float lo_bf16(unsigned x) {
  return __uint_as_float(x << 16);
}
__device__ __forceinline__ float hi_bf16(unsigned x) {
  return __uint_as_float(x & 0xffff0000u);
}

// N consecutive values (N * sizeof(T) bytes, as aligned) widened to
// float32 registers.
template <int N>
__device__ __forceinline__ void ld_f32(float (&d)[N], const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 x = reinterpret_cast<const float4*>(p)[q];
      d[4 * q] = x.x; d[4 * q + 1] = x.y; d[4 * q + 2] = x.z;
      d[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < N / 2; ++q) {
      const float2 x = reinterpret_cast<const float2*>(p)[q];
      d[2 * q] = x.x; d[2 * q + 1] = x.y;
    }
  }
}
template <int N>
__device__ __forceinline__ void ld_f32(float (&d)[N],
                                       const __nv_bfloat16* p) {
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int q = 0; q < N / 8; ++q) {
      const uint4 x = reinterpret_cast<const uint4*>(p)[q];
      const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        d[8 * q + 2 * e] = lo_bf16(w[e]);
        d[8 * q + 2 * e + 1] = hi_bf16(w[e]);
      }
    }
  } else if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const uint2 x = reinterpret_cast<const uint2*>(p)[q];
      d[4 * q] = lo_bf16(x.x); d[4 * q + 1] = hi_bf16(x.x);
      d[4 * q + 2] = lo_bf16(x.y); d[4 * q + 3] = hi_bf16(x.y);
    }
  } else {
#pragma unroll
    for (int q = 0; q < N / 2; ++q) {
      const unsigned x = reinterpret_cast<const unsigned*>(p)[q];
      d[2 * q] = lo_bf16(x); d[2 * q + 1] = hi_bf16(x);
    }
  }
}
template <int N>
__device__ __forceinline__ void st_f32(float* p, const float (&s)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q)
      reinterpret_cast<float4*>(p)[q] =
          make_float4(s[4 * q], s[4 * q + 1], s[4 * q + 2], s[4 * q + 3]);
  } else {
#pragma unroll
    for (int q = 0; q < N / 2; ++q)
      reinterpret_cast<float2*>(p)[q] = make_float2(s[2 * q], s[2 * q + 1]);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// The tile of S a lane holds: R rows x CL columns.  K/R "row lanes"
// share a group of CL columns; a warp holds 32/(K/R) such groups, a block
// W warps: JC = W * 32/(K/R) * CL columns, K/JC blocks per head.
// grid: B*H*(K/JC) blocks, block (b*H + h)*(K/JC) + g owning columns
// g*JC .. g*JC+JC-1 of head h; W*32 threads.
// r, k, v, logw, o: (B, S, H, K); u: (H, K); s0, s_end: (B, H, K, K);
// all 16-byte aligned.
template <typename T, int K, int R, int CL, int W>
__global__ void __launch_bounds__(W * 32)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ logw,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ o, float* __restrict__ s_end, int S, int H) {
  constexpr int NT = W * 32;          // threads
  constexpr int RLN = K / R;          // row lanes of one column group
  constexpr int CG = 32 / RLN;        // column groups per warp
  constexpr int JC = W * CG * CL;     // columns per block
  constexpr int NG = K / JC;          // blocks per head
  constexpr int C = kChunk;
  constexpr int TS = static_cast<int>(sizeof(T));
  constexpr int KT = slot<T>(K - 1) + 1;      // staged row of r or k
  constexpr int KF = slot<float>(K - 1) + 1;  // staged row of logw / w
  constexpr int PR = K * TS / 16;     // 16-byte pieces of a token's r (k)
  constexpr int PL = K * 4 / 16;      // ... of its logw
  constexpr int PV = JC * TS / 16;    // ... of its v columns
  constexpr int PT = 2 * PR + PL + PV;
  static_assert(RLN * R == K && RLN <= 32 && (RLN & (RLN - 1)) == 0 &&
                    CL <= RLN && (CL & (CL - 1)) == 0 && CL % 2 == 0 &&
                    R % 4 == 0 && 32 % R == 0 && NG * JC == K &&
                    PV * 16 == JC * TS,
                "unsupported WKV6 tile");

  // raw inputs of kRing chunks as cp.async lands them, logw turned into
  // w = exp(logw) in place one chunk ahead of its use
  __shared__ __align__(16) T sr[kRing][C][KT];
  __shared__ __align__(16) T sk[kRing][C][KT];
  __shared__ __align__(16) float sw[kRing][C][KF];
  __shared__ __align__(16) T sv[kRing][C][JC];

  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid & 31;
  const int bh = static_cast<int>(blockIdx.x) / NG;
  const int j0 = (static_cast<int>(blockIdx.x) - bh * NG) * JC;
  const int b = bh / H, h = bh - (bh / H) * H;
  const long long tok_stride = static_cast<long long>(H) * K;
  const long long base = static_cast<long long>(b) * S * tok_stride +
                         static_cast<long long>(h) * K;
  const int n_chunks = (S + C - 1) / C;
  auto tokens = [&](int ch) { return max(0, min(C, S - ch * C)); };

  // copy chunk ch into its ring buffer, one commit group
  auto issue = [&](int ch) {
    const int buf = ch % kRing, n = tokens(ch);
    for (int p = tid; p < n * PT; p += NT) {
      const int tau = p / PT, q = p - (p / PT) * PT;
      const long long x = base + (ch * C + tau) * tok_stride;
      if (q < PR) {
        const int i = q * 16 / TS;
        cp_async16(&sr[buf][tau][slot<T>(i)], r + x + i);
      } else if (q < 2 * PR) {
        const int i = (q - PR) * 16 / TS;
        cp_async16(&sk[buf][tau][slot<T>(i)], k + x + i);
      } else if (q < 2 * PR + PL) {
        const int i = (q - 2 * PR) * 4;
        cp_async16(&sw[buf][tau][slot<float>(i)], logw + x + i);
      } else {
        const int j = (q - 2 * PR - PL) * 16 / TS;
        cp_async16(&sv[buf][tau][j], v + x + j0 + j);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  // logw -> exp(logw) in place for chunk ch (landed and visible)
  auto decay = [&](int ch) {
    const int buf = ch % kRing, n = tokens(ch);
    for (int e = tid; e < n * K; e += NT) {
      float& x = sw[buf][e / K][slot<float>(e % K)];
      x = expf(x);
    }
  };

  // compute role: rows i0 .. i0+R-1 of columns j0+c0 .. j0+c0+CL-1
  const int rl = lane % RLN;
  const int c0 = ((tid >> 5) * CG + lane / RLN) * CL;
  const int i0 = rl * R;
  float st[R][CL], ur[R];
  const float* s_in = s0 ? s0 + static_cast<long long>(bh) * K * K : nullptr;
#pragma unroll
  for (int q = 0; q < R; ++q) {
    ur[q] = u[h * K + i0 + q];
    if (s_in) {
      ld_f32(st[q], s_in + (i0 + q) * K + j0 + c0);
    } else {
#pragma unroll
      for (int cc = 0; cc < CL; ++cc) st[q][cc] = 0.f;
    }
  }

  // NTK consecutive tokens, interleaved so their reductions overlap
  // (token t+1 reads the state token t wrote).  Token t's inputs start
  // at rp[t], kp[t], wp[t] (this lane's rows, contiguous) and vp[t] (its
  // columns), in shared or device memory; wp holds w = exp(logw), or
  // logw when EXPW.
  auto step = [&](auto ntk, auto expw, const T* const* rp, const T* const* kp,
                  const float* const* wp, const T* const* vp,
                  long long t_glob) {
    constexpr int NTK = decltype(ntk)::value;
    float vv[NTK][CL], acc[NTK][CL], bonus[NTK];
#pragma unroll
    for (int t = 0; t < NTK; ++t) {
      ld_f32(vv[t], vp[t]);
      bonus[t] = 0.f;  // this lane's rows of sum_i r_i u_i k_i
#pragma unroll
      for (int cc = 0; cc < CL; ++cc) acc[t][cc] = 0.f;
    }
#pragma unroll
    for (int q4 = 0; q4 < R / 4; ++q4) {
      float rv[NTK][4], kv[NTK][4], wv[NTK][4];
#pragma unroll
      for (int t = 0; t < NTK; ++t) {
        ld_f32(rv[t], rp[t] + 4 * q4);
        ld_f32(kv[t], kp[t] + 4 * q4);
        ld_f32(wv[t], wp[t] + 4 * q4);
        if constexpr (decltype(expw)::value) {
#pragma unroll
          for (int e = 0; e < 4; ++e) wv[t][e] = expf(wv[t][e]);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int t = 0; t < NTK; ++t)
          bonus[t] = fmaf(rv[t][e] * ur[q4 * 4 + e], kv[t][e], bonus[t]);
#pragma unroll
        for (int cc = 0; cc < CL; ++cc) {
          float& x = st[q4 * 4 + e][cc];
#pragma unroll
          for (int t = 0; t < NTK; ++t) {
            acc[t][cc] = fmaf(rv[t][e], x, acc[t][cc]);
            x = fmaf(wv[t][e], x, kv[t][e] * vv[t][cc]);
          }
        }
      }
    }
    // sum over the row lanes, halving the columns a lane carries each
    // step (each lane keeps one half and sends the other) until one is
    // left, then plain shuffle sums; the bonus joins row lane sums first
    int col = 0;
#pragma unroll
    for (int t = 0; t < NTK; ++t)
#pragma unroll
      for (int cc = 0; cc < CL; ++cc)
        acc[t][cc] = fmaf(vv[t][cc], bonus[t], acc[t][cc]);
#pragma unroll
    for (int st_ = 0, m = RLN / 2; m >= 1; ++st_, m >>= 1) {
      const int nv = CL >> st_;
      const bool up = (lane & m) != 0;
#pragma unroll
      for (int t = 0; t < NTK; ++t) {
        if (nv > 1) {
#pragma unroll
          for (int q = 0; q < nv / 2; ++q) {
            const float send = up ? acc[t][q] : acc[t][q + nv / 2];
            const float keep = up ? acc[t][q + nv / 2] : acc[t][q];
            acc[t][q] = keep + __shfl_xor_sync(0xffffffffu, send, m);
          }
        } else {
          acc[t][0] += __shfl_xor_sync(0xffffffffu, acc[t][0], m);
        }
      }
      if (nv > 1 && up) col += nv / 2;
    }
    if ((rl & (RLN / CL - 1)) == 0) {
#pragma unroll
      for (int t = 0; t < NTK; ++t)
        o[base + (t_glob + t) * tok_stride + j0 + c0 + col] = acc[t][0];
    }
  };
  using one = std::integral_constant<int, 1>;
  using two = std::integral_constant<int, 2>;
  float* s_out = s_end + static_cast<long long>(bh) * K * K;

  if (S <= kDirect) {
    // a decode step: each lane reads its own rows and columns from device
    // memory, no staging and no barrier
    for (int t = 0; t < S; ++t) {
      const long long x = base + t * tok_stride;
      const T* rp = r + x + i0;
      const T* kp = k + x + i0;
      const float* wp = logw + x + i0;
      const T* vp = v + x + j0 + c0;
      step(one(), std::true_type(), &rp, &kp, &wp, &vp, t);
    }
#pragma unroll
    for (int q = 0; q < R; ++q) st_f32(s_out + (i0 + q) * K + j0 + c0, st[q]);
    return;
  }

  issue(0);
  issue(1);
  asm volatile("cp.async.wait_group 1;\n" ::);
  __syncthreads();
  decay(0);
  for (int ch = 0; ch < n_chunks; ++ch) {
    // chunk ch+1 has landed; every thread is done with chunk ch-1 (its
    // buffer takes chunk ch+2) and has turned chunk ch's logw into w
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    issue(ch + 2);
    decay(ch + 1);
    const int buf = ch % kRing, n = tokens(ch);
    for (int tau = 0; tau < n; tau += 2) {
      const int t1 = min(tau + 1, n - 1);
      const T* rp[2] = {&sr[buf][tau][slot<T>(i0)], &sr[buf][t1][slot<T>(i0)]};
      const T* kp[2] = {&sk[buf][tau][slot<T>(i0)], &sk[buf][t1][slot<T>(i0)]};
      const float* wp[2] = {&sw[buf][tau][slot<float>(i0)],
                            &sw[buf][t1][slot<float>(i0)]};
      const T* vp[2] = {&sv[buf][tau][c0], &sv[buf][t1][c0]};
      if (tau + 1 < n)
        step(two(), std::false_type(), rp, kp, wp, vp, ch * C + tau);
      else
        step(one(), std::false_type(), rp, kp, wp, vp, ch * C + tau);
    }
  }

#pragma unroll
  for (int q = 0; q < R; ++q) st_f32(s_out + (i0 + q) * K + j0 + c0, st[q]);
}

// The tile each head size runs, (rows, columns) of the state a lane holds
// and warps a block: first for a staged call, then for a call of at most
// kDirect tokens (a decode step).  On the H100 a sweep of tiles put
// (4, 4, 4) first for rwkv6-3b's prefill call and (16, 4, 1) for its
// decode step.
#define WKV6_TILES(X)                                               \
  X(16, 4, 2, 1, 4, 2, 1)                                           \
  X(32, 4, 4, 2, 8, 4, 1)                                           \
  X(64, 4, 4, 4, 16, 4, 1)

template <typename T, int K, int R, int CL, int W>
static int launch_tile(const void* r, const void* k, const void* v,
                       const float* logw, const float* u, const float* s0,
                       float* o, float* s_end, int B, int S, int H,
                       cudaStream_t st) {
  // Every tile's blocks are shared-memory heavy and read no device memory
  // through L1, so each kernel asks for the largest shared-memory
  // carveout, once on each device (cudaFuncSetAttribute acts on the
  // current device only).
  constexpr int jc = W * (32 / (K / R)) * CL;
  static std::atomic<int> carveout_set[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (!carveout_set[dev].load()) {
    e = cudaFuncSetAttribute(wkv6_kernel<T, K, R, CL, W>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return static_cast<int>(e);
    carveout_set[dev].store(1);
  }
  wkv6_kernel<T, K, R, CL, W><<<B * H * (K / jc), W * 32, 0, st>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), logw, u, s0, o, s_end, S, H);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int launch_typed(const void* r, const void* k, const void* v,
                        const float* logw, const float* u, const float* s0,
                        float* o, float* s_end, int B, int S, int H, int K,
                        cudaStream_t st) {
#define WKV6_CASE(KK, R1, C1, W1, R2, C2, W2)                             \
  if (K == KK) {                                                          \
    if (S <= kDirect)                                                     \
      return launch_tile<T, KK, R2, C2, W2>(r, k, v, logw, u, s0, o,      \
                                            s_end, B, S, H, st);          \
    return launch_tile<T, KK, R1, C1, W1>(r, k, v, logw, u, s0, o, s_end, \
                                          B, S, H, st);                   \
  }
  WKV6_TILES(WKV6_CASE)
#undef WKV6_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" {

// r, k, v: float32 (bf16 == 0) or bfloat16 (bf16 == 1); logw, u, s0
// (nullable: a zero state), o, s_end: float32; all 16-byte aligned.
// K: one of WKV6_TILES' head sizes.  Returns the launch's cudaError_t.
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
