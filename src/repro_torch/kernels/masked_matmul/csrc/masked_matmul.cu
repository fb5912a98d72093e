// Fan-in-sparse masked matmul for Hopper (sm_90a), bound through a plain
// C interface (ctypes; see ../masked_matmul.py).
//
// Replaces the Pallas TPU kernel
// repro/kernels/masked_matmul/masked_matmul.py::masked_matmul_pallas
// (_mm_kernel), forward only as there:
//
//     y[b, n] = sum_f x[b, conn[n, f]] * w[n, f] + bias[n]
//
// The TPU kernel turns the gather into a one-hot selection matmul for
// its matrix unit.  Here the gather is direct: one thread per output
// (b, n) reads its F inputs through conn and does F float32 FMAs.  A
// block owns `rows` batch rows and every neuron of them; it first copies
// its rows of x into shared memory (coalesced, 16 bytes a thread where
// aligned), so the scattered reads of the gather hit shared memory and x
// crosses device memory once.  When one row does not fit the block's
// shared memory, the kernel gathers from device memory instead.
//
// What bounds it on an H100: bytes.  Each output costs F gathers and F
// FMAs against 4 bytes written; x is read once.  Ragged edges (the last
// block's rows, any n_out) are masked per thread.  Each conn index is
// checked against [0, n_in) as it is read (one unsigned compare): an index
// outside makes its output NaN and is never used as an address.

#include <cstdint>
#include <cuda_runtime.h>

static constexpr int kThreads = 256;

template <bool STAGED>
__global__ void __launch_bounds__(kThreads)
masked_mm_kernel(const float* __restrict__ x, const int32_t* __restrict__ conn,
                 const float* __restrict__ w, const float* __restrict__ bias,
                 float* __restrict__ y, int B, int n_in, int n_out, int F,
                 int rows, int vec4) {
  extern __shared__ __align__(16) float xs[];
  const int b0 = blockIdx.x * rows;
  const int nb = min(rows, B - b0);
  const float* xb = x + static_cast<long long>(b0) * n_in;
  if (STAGED) {
    const int total = nb * n_in;
    if (vec4) {
      const float4* src = reinterpret_cast<const float4*>(xb);
      float4* dst = reinterpret_cast<float4*>(xs);
      for (int i = threadIdx.x; i < total / 4; i += kThreads) dst[i] = src[i];
    } else {
      for (int i = threadIdx.x; i < total; i += kThreads) xs[i] = xb[i];
    }
    __syncthreads();
  }
  const float* src = STAGED ? xs : xb;
  const int outs = nb * n_out;
  for (int idx = threadIdx.x; idx < outs; idx += kThreads) {
    const int rb = idx / n_out;
    const int n = idx - rb * n_out;
    const float* row = src + static_cast<long long>(rb) * n_in;
    const int32_t* c = conn + static_cast<long long>(n) * F;
    const float* wn = w + static_cast<long long>(n) * F;
    float acc = 0.f;
    for (int f = 0; f < F; ++f) {
      const unsigned j = static_cast<unsigned>(__ldg(c + f));
      const float xj =
          j < static_cast<unsigned>(n_in) ? row[j] : __int_as_float(0x7fc00000);
      acc = fmaf(xj, __ldg(wn + f), acc);
    }
    if (bias) acc += __ldg(bias + n);
    y[static_cast<long long>(b0 + rb) * n_out + n] = acc;
  }
}

extern "C" {

// x (B, n_in), w (n_out, F), bias (n_out,) nullable, y (B, n_out): float32;
// conn (n_out, F) int32.  smem_bytes == 0 selects the unstaged kernel.
// Returns the launch's cudaError_t.
int masked_mm_launch(const float* x, const int32_t* conn, const float* w,
                     const float* bias, float* y, int B, int n_in, int n_out,
                     int F, int rows, int smem_bytes, int vec4, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((B + rows - 1) / rows);
  if (smem_bytes > 0) {
    if (smem_bytes > 48 * 1024) {  // above 48 KB only when opted in
      cudaError_t e = cudaFuncSetAttribute(
          masked_mm_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem_bytes);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    masked_mm_kernel<true><<<grid, kThreads, smem_bytes, st>>>(
        x, conn, w, bias, y, B, n_in, n_out, F, rows, vec4);
  } else {
    masked_mm_kernel<false><<<grid, kThreads, 0, st>>>(
        x, conn, w, bias, y, B, n_in, n_out, F, rows, 0);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
