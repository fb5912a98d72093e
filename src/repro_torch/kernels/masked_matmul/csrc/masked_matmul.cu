// Fan-in-sparse masked matmul for Hopper (sm_90a), bound through a plain
// C interface (ctypes; see ../masked_matmul.py).
//
// Replaces the Pallas TPU kernel
// repro/kernels/masked_matmul/masked_matmul.py::masked_matmul_pallas
// (_mm_kernel), forward only as there:
//
//     y[b, n] = sum_f x[b, conn[n, f]] * w[n, f] + bias[n]
//
// The TPU kernel turns the gather into a one-hot selection matmul for its
// matrix unit.  Here the gather is direct: F reads through conn and F
// float32 FMAs an output; tensor cores have nothing to do.
//
// What bounds it on an H100: bytes.  x crosses device memory once (whole
// rows: the columns conn names are scattered over every cache line), y is
// written once; conn, w and bias are a few KB that stay in L2.  So the
// design keeps enough of x in flight on every SM and gets the gather out
// of the way of the copy:
//   * geometry per call from the batch and the card (masked_matmul.py:
//     mm_geometry).  A block takes tiles of `rows` batch rows for one tile
//     of `ntile` neurons (blockIdx.y), one neuron a thread; the grid is at
//     most what the card holds resident, and block b walks row tiles b,
//     b + gridDim.x, ...
//   * x staged by bulk asynchronous copy.  A tile of rows is one contiguous
//     span of rows x n_in floats, so one thread moves it into a stage of a
//     ring with one cp.async.bulk whose completion is counted in bytes on
//     the stage's mbarrier.  The block's first `stages` tiles are requested
//     at once, and each stage is refilled with the tile `stages` ahead as
//     soon as every thread is done with it: tile i+1 streams in while tile
//     i is gathered.  A bulk copy wants 16-byte ends, so a tile lands at
//     the offset of its start within 16 bytes (tile_lead; each stage has
//     16 bytes of slack) and the issuing thread copies the up to 3 floats
//     at each end itself: an x whose rows are not 16-byte aligned (n_in %
//     4 != 0, or a view that starts off a boundary) takes the same path.
//   * conn and w in registers.  Each thread loads its neuron's F indices
//     and weights once, before it waits on its first tile; F is a template
//     parameter for 1..8, and a generic instantiation reads them through
//     L1 for any other fan-in.
//   * stores coalesced: for each row, the lanes of a warp write
//     consecutive neurons.
//   * an index outside [0, n_in) is found when it is loaded: that output
//     is NaN and the index is never used as an address.
// Rows too wide for a block's shared memory (over ~58,000 floats) are
// gathered from device memory through L1 instead (smem_bytes == 0).

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

// Launch bound: 256 threads, 6 blocks an SM, so at most 40 registers a
// thread; the fan-ins 7 and 8 hold 14-16 registers of indices and
// weights and would spill there, so they take 4 blocks, 64 registers
// (masked_matmul.py: MAX_THREADS, regs_per_thread).
static constexpr int kMaxThreads = 256;
template <int FT>
struct MinBlocks {
  static constexpr int value = FT >= 7 ? 4 : 6;
};
// ring stages, and the 32-byte slot of their mbarriers at the start of
// shared memory (masked_matmul.py: MAX_STAGES, BARRIER_BYTES)
static constexpr int kMaxStages = 4;
static constexpr int kBarrierFloats = 2 * kMaxStages;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ int tile_lead(const float* src) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(src) & 15) >> 2);
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

// One thread: copy n floats from src (device memory) to stage +
// tile_lead(src) and arrive on `bar`, whose phase completes when the
// bytes have landed.
__device__ __forceinline__ void load_tile(float* stage, uint64_t* bar,
                                          const float* src, long long n) {
  float* dst = stage + tile_lead(src);
  const int head = static_cast<int>(min(n, static_cast<long long>(
                                               (4 - tile_lead(src)) & 3)));
  const long long body = (n - head) & ~3LL;
  for (int k = 0; k < head; ++k) dst[k] = __ldg(src + k);
  for (long long k = head + body; k < n; ++k) dst[k] = __ldg(src + k);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(static_cast<unsigned>(4 * body))
               : "memory");
  if (body > 0)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];\n"
        ::"r"(smem_addr(dst + head)), "l"(src + head),
          "r"(static_cast<unsigned>(4 * body)), "r"(smem_addr(bar))
        : "memory");
}

template <bool STAGED>
__device__ __forceinline__ float ld_x(const float* p) {
  return STAGED ? *p : __ldg(p);
}

// FT: the fan-in F as a compile-time constant (1..8), or 0 for the
// generic form.  STAGED: x through the ring in shared memory, else read
// from device memory.  Shared memory (STAGED): kMaxStages mbarriers in a
// 32-byte slot | `stages` stages of round_up4(rows * n_in) + 4 floats,
// exactly the wrapper's ledger (mm_smem_bytes).
template <int FT, bool STAGED>
__global__ void __launch_bounds__(kMaxThreads, MinBlocks<FT>::value)
masked_mm_kernel(const float* __restrict__ x, const int32_t* __restrict__ conn,
                 const float* __restrict__ w, const float* __restrict__ bias,
                 float* __restrict__ y, int B, int n_in, int n_out, int F,
                 int rows, int ntile, int stages) {
  extern __shared__ __align__(16) float smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  float* ring = smem + kBarrierFloats;
  const long long tile_len = static_cast<long long>(rows) * n_in;
  const long long stride = ((tile_len + 3) & ~3LL) + 4;
  const int n_tiles = (B + rows - 1) / rows;
  if (STAGED) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < stages; ++s)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                     ::"r"(smem_addr(full + s)), "r"(1) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0)
      for (int s = 0; s < stages; ++s) {
        const int t = blockIdx.x + s * gridDim.x;
        if (t < n_tiles)
          load_tile(ring + s * stride, full + s, x + t * tile_len,
                    static_cast<long long>(min(rows, B - t * rows)) * n_in);
      }
  }

  // this thread's neuron, its indices and weights, while the tiles land
  const int n = blockIdx.y * ntile + threadIdx.x;
  const bool active = threadIdx.x < ntile && n < n_out;
  const unsigned limit = static_cast<unsigned>(n_in);
  constexpr int NF = FT > 0 ? FT : 1;
  int c[NF];
  float wf[NF];
  bool bad = false;
  float b0 = 0.f;
  const int32_t* cn = conn + static_cast<long long>(n) * F;
  const float* wn = w + static_cast<long long>(n) * F;
  if (active) {
    if (FT > 0) {
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const unsigned j = static_cast<unsigned>(__ldg(cn + f));
        bad |= j >= limit;
        c[f] = j < limit ? static_cast<int>(j) : 0;
        wf[f] = __ldg(wn + f);
      }
    }
    if (bias) b0 = __ldg(bias + n);
  }
  const float nan = __int_as_float(0x7fc00000);

  int i = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++i) {
    const float* src = x + tile * tile_len;
    const int nr = min(rows, B - tile * rows);
    const float* xs = src;
    int s = 0;
    if (STAGED) {
      s = i % stages;
      mbar_wait(full + s, static_cast<unsigned>(i / stages) & 1);
      xs = ring + s * stride + tile_lead(src);
    }
    if (active) {
      float* yt = y + static_cast<long long>(tile) * rows * n_out + n;
#pragma unroll 1
      for (int r = 0; r < nr; ++r) {
        const float* row = xs + static_cast<long long>(r) * n_in;
        float acc = 0.f;
        if (FT > 0) {
#pragma unroll
          for (int f = 0; f < NF; ++f)
            acc = fmaf(ld_x<STAGED>(row + c[f]), wf[f], acc);
        } else {
          for (int f = 0; f < F; ++f) {
            const unsigned j = static_cast<unsigned>(__ldg(cn + f));
            const float xj = j < limit ? ld_x<STAGED>(row + j) : nan;
            acc = fmaf(xj, __ldg(wn + f), acc);
          }
        }
        yt[static_cast<long long>(r) * n_out] = bad ? nan : acc + b0;
      }
    }
    if (STAGED) {
      // every thread is done with stage s
      __syncthreads();
      const int next = tile + stages * gridDim.x;
      if (threadIdx.x == 0 && next < n_tiles) {
        // order the threads' reads of the stage before the copy's writes
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        load_tile(ring + s * stride, full + s, x + next * tile_len,
                  static_cast<long long>(min(rows, B - next * rows)) * n_in);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// C interface.  The launch goes on the caller's stream, allocates nothing,
// and returns the cudaError_t of the launch (0 on success).
// ---------------------------------------------------------------------------

struct Launch {
  const float* x;
  const int32_t* conn;
  const float* w;
  const float* bias;
  float* y;
  int B, n_in, n_out, F, rows, ntile, stages;
  dim3 grid;
  int threads, smem_bytes, carveout;
  cudaStream_t stream;
};

// The most dynamic shared memory and the carveout set for each
// instantiation are remembered, so a steady stream of one geometry sets
// them once.  cudaFuncSetAttribute acts on the current device only, so
// both are remembered per device ordinal (a slot holds the bytes, or the
// carveout + 1; 0: never set).
static constexpr int kMaxDevices = 64;

template <int FT, bool STAGED>
static cudaError_t launch(const Launch& a) {
  static std::atomic<int> max_smem[kMaxDevices], carveout[kMaxDevices];
  const void* kernel =
      reinterpret_cast<const void*>(masked_mm_kernel<FT, STAGED>);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (a.smem_bytes > 48 * 1024 && max_smem[dev].load() < a.smem_bytes) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem_bytes);
    if (e != cudaSuccess) return e;
    max_smem[dev].store(a.smem_bytes);
  }
  if (a.carveout >= 0 &&
      carveout[dev].exchange(a.carveout + 1) != a.carveout + 1) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout, a.carveout);
    if (e != cudaSuccess) return e;
  }
  masked_mm_kernel<FT, STAGED><<<a.grid, a.threads, a.smem_bytes,
                                 a.stream>>>(
      a.x, a.conn, a.w, a.bias, a.y, a.B, a.n_in, a.n_out, a.F, a.rows,
      a.ntile, a.stages);
  return cudaGetLastError();
}

template <bool STAGED>
static cudaError_t launch_f(const Launch& a) {
  switch (a.F) {
    case 1: return launch<1, STAGED>(a);
    case 2: return launch<2, STAGED>(a);
    case 3: return launch<3, STAGED>(a);
    case 4: return launch<4, STAGED>(a);
    case 5: return launch<5, STAGED>(a);
    case 6: return launch<6, STAGED>(a);
    case 7: return launch<7, STAGED>(a);
    case 8: return launch<8, STAGED>(a);
    default: return launch<0, STAGED>(a);
  }
}

extern "C" {

// x (B, n_in), w (n_out, F), bias (n_out,) nullable, y (B, n_out): float32;
// conn (n_out, F) int32; all contiguous.  Geometry from mm_geometry:
// `rows` rows a tile, `ntile` neurons a block of `threads` threads, a grid
// of grid x neuron_tiles blocks, `stages` ring stages of `smem_bytes`
// bytes in all (0: unstaged), the shared-memory carveout (percent; -1
// leaves it).
int masked_mm_launch(const float* x, const int32_t* conn, const float* w,
                     const float* bias, float* y, int B, int n_in, int n_out,
                     int F, int rows, int threads, int ntile, int grid,
                     int neuron_tiles, int stages, int smem_bytes,
                     int carveout, void* stream) {
  if (B <= 0 || n_out <= 0) return 0;
  if (threads < 1 || threads > kMaxThreads || ntile < 1 || ntile > threads ||
      rows < 1 || grid < 1 || neuron_tiles < 1 || neuron_tiles > 65535 ||
      F < 0 || (smem_bytes > 0 && (stages < 1 || stages > kMaxStages)))
    return static_cast<int>(cudaErrorInvalidValue);
  Launch a{x, conn, w, bias, y, B, n_in, n_out, F, rows, ntile, stages,
           dim3(grid, neuron_tiles), threads, smem_bytes, carveout,
           static_cast<cudaStream_t>(stream)};
  return static_cast<int>(smem_bytes > 0 ? launch_f<true>(a)
                                         : launch_f<false>(a));
}

}  // extern "C"
