// LUT-mode inference kernels for Hopper (sm_90a), bound through a plain C
// interface (ctypes; see ../lut_gather.py).
//
// Replaces the Pallas TPU kernels of repro/kernels/lut_gather/lut_gather.py:
//   lut_gather_kernel           <- lut_gather_pallas (_lut_kernel): one layer
//   lut_fused_kernel            <- lut_network_fused_pallas, pipeline=False
//                                  (_fused_kernel -> _run_layers)
//   lut_fused_pipelined_kernel  <- lut_network_fused_pallas, pipeline=True
//                                  (_fused_pipelined_kernel)
//
// What bounds them on an H100: the work is integer gathers, no arithmetic
// to speak of, so the floor is bytes — each input code read once from
// device memory, each output code written once, the table slabs read once
// (they stay in the 50 MB L2 after the first touch).  The fused kernels
// keep the inter-layer codes in shared memory, so a forward pass moves the
// input codes in and the output codes out and nothing else; the per-layer
// kernel sends every layer's codes through device memory.  Routing is a
// direct gather of the F fan-in codes through `conn` plus shift/add — the
// TPU kernel's routing matmul is not ported, because a TF32 product would
// corrupt table addresses.
//
// Table address of sub-neuron (n, a): the F gathered codes packed
// in_bits apart, slot 0 in the low bits, masked to the row (& (K-1)) and
// offset by the flat slab base n*A*K + a*K.  With the adder on, the A
// sub-codes are packed sub_bits apart and looked up in row n of the adder
// table (& (Ka-1)).  Slabs are uint8, int32, or int4 nibble-packed (two
// codes per byte, low nibble first: byte fi>>1, nibble fi&1).  The masks
// keep a request code that is out of range inside its slab row.

#include <cstdint>
#include <cuda_runtime.h>

#define ENC_U8 0
#define ENC_I32 1
#define ENC_INT4 2
#define ENC_NONE (-1)  // adder off: the layer's output is sub-neuron 0's code

static constexpr int kThreads = 256;

// One layer as the kernels see it; mirrored by _LayerDesc in lut_gather.py
// (lut_desc_size() lets the wrapper check the layout).
struct LayerDesc {
  const int32_t* conn;  // (n_out, A, F)
  const uint8_t* sub;   // (n_out, A, K) u8|i32, or (n_out, A, K/2) int4
  const uint8_t* add;   // (n_out, Ka) u8|i32, or (n_out, Ka/2) int4; unused
                        // when add_enc == ENC_NONE
  int32_t n_in, n_out, A, F;
  int32_t in_bits, sub_bits;
  int32_t K, Ka;        // logical table widths, powers of two
  int32_t sub_enc, add_enc;
  int32_t pad0, pad1;
};

__device__ __forceinline__ int read_code(const uint8_t* slab, int enc,
                                         long long fi) {
  if (enc == ENC_I32) return __ldg(reinterpret_cast<const int*>(slab) + fi);
  if (enc == ENC_INT4) {
    const int byte = __ldg(slab + (fi >> 1));
    return (byte >> (static_cast<int>(fi & 1) * 4)) & 0xF;
  }
  return __ldg(slab + fi);
}

// Output code of neuron n for one row of input codes (`row` may live in
// shared or global memory).
__device__ __forceinline__ int lut_neuron(const LayerDesc& L,
                                          const int32_t* row, int n) {
  unsigned aidx = 0;
  for (int a = 0; a < L.A; ++a) {
    const long long sa = static_cast<long long>(n) * L.A + a;
    const int32_t* c = L.conn + sa * L.F;
    unsigned idx = 0;
    for (int f = 0; f < L.F; ++f)
      idx += static_cast<unsigned>(row[__ldg(c + f)]) << (L.in_bits * f);
    idx &= static_cast<unsigned>(L.K - 1);
    const int s = read_code(L.sub, L.sub_enc, sa * L.K + idx);
    if (L.add_enc == ENC_NONE) return s;
    aidx += static_cast<unsigned>(s) << (L.sub_bits * a);
  }
  aidx &= static_cast<unsigned>(L.Ka - 1);
  return read_code(L.add, L.add_enc, static_cast<long long>(n) * L.Ka + aidx);
}

// ---------------------------------------------------------------------------
// Kernel 3: one layer, one thread per output (row, neuron).  The flat
// index covers the ragged batch and neuron edges with one bound check.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
lut_gather_kernel(const int32_t* __restrict__ codes, int32_t* __restrict__ out,
                  int B, LayerDesc L) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= static_cast<long long>(B) * L.n_out) return;
  const int b = static_cast<int>(t / L.n_out);
  const int n = static_cast<int>(t - static_cast<long long>(b) * L.n_out);
  out[t] = lut_neuron(L, codes + static_cast<long long>(b) * L.n_in, n);
}

// ---------------------------------------------------------------------------
// Fused layers of one batch tile.  Layer 0 reads `in` (row stride n_in0);
// layer l >= 1 reads what layer l-1 wrote.  Hidden layers write P (even l)
// or Q (odd l) — two buffers, so no layer overwrites codes that other
// threads are still reading — and the last layer writes `out` in device
// memory.  A barrier separates the layers.
// ---------------------------------------------------------------------------
__device__ void run_layers(const LayerDesc* __restrict__ layers, int n_layers,
                           const int32_t* in, int32_t* P, int wP, int32_t* Q,
                           int wQ, int rows, int32_t* __restrict__ out) {
  const int32_t* src = in;
  int src_stride = layers[0].n_in;
  for (int l = 0; l < n_layers; ++l) {
    const LayerDesc L = layers[l];
    const bool last = (l == n_layers - 1);
    int32_t* dst = last ? out : ((l & 1) ? Q : P);
    const int dst_stride = last ? L.n_out : ((l & 1) ? wQ : wP);
    const int items = rows * L.n_out;
    for (int i = threadIdx.x; i < items; i += blockDim.x) {
      const int r = i / L.n_out;
      const int n = i - r * L.n_out;
      dst[static_cast<long long>(r) * dst_stride + n] =
          lut_neuron(L, src + r * src_stride, n);
    }
    if (!last) {
      __syncthreads();
      src = dst;
      src_stride = dst_stride;
    }
  }
}

// ---------------------------------------------------------------------------
// Kernel 1: the whole network, one block per tile of `rows` batch rows.
// Shared memory: in (rows x n_in0) | P (rows x wP) | Q (rows x wQ), int32.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
lut_fused_kernel(const int32_t* __restrict__ codes, int32_t* __restrict__ out,
                 int B, const LayerDesc* __restrict__ layers, int n_layers,
                 int rows, int wP, int wQ) {
  extern __shared__ __align__(16) int32_t smem[];
  const int n_in0 = layers[0].n_in;
  const int n_out_last = layers[n_layers - 1].n_out;
  int32_t* in = smem;
  int32_t* P = in + rows * n_in0;
  int32_t* Q = P + rows * wP;
  const long long row0 = static_cast<long long>(blockIdx.x) * rows;
  const int here = static_cast<int>(
      min(static_cast<long long>(rows), static_cast<long long>(B) - row0));
  const int32_t* src = codes + row0 * n_in0;
  for (int i = threadIdx.x; i < here * n_in0; i += blockDim.x) in[i] = src[i];
  __syncthreads();
  run_layers(layers, n_layers, in, P, wP, Q, wQ, here,
             out + row0 * n_out_last);
}

// Copy n contiguous int32 codes from device memory into shared memory with
// cp.async (16 bytes a copy when both sides are 16-byte aligned and n is a
// multiple of 4, else 4 bytes), as one commit group.
__device__ __forceinline__ void prefetch_codes(int32_t* dst,
                                               const int32_t* src, int n,
                                               bool vec16) {
  if (vec16) {
    for (int i = threadIdx.x * 4; i < n; i += blockDim.x * 4) {
      const unsigned s =
          static_cast<unsigned>(__cvta_generic_to_shared(dst + i));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                   "l"(src + i));
    }
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const unsigned s =
          static_cast<unsigned>(__cvta_generic_to_shared(dst + i));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                   "l"(src + i));
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ int tile_rows(int tile, int rows, int B) {
  return min(rows, B - tile * rows);
}

// ---------------------------------------------------------------------------
// Kernel 2: persistent form of kernel 1.  gridDim.x = min(n_tiles, #SMs);
// block b walks tiles b, b + gridDim.x, ...  While tile i computes, tile
// i+1's input codes stream into the other in-slot with cp.async — the two
// in-slots of the TPU kernel's DMA schedule.  Output rows go straight to
// device memory from the last layer, so no out-slots are needed.
// Shared memory: slot0 | slot1 (rows x n_in0 each) | P | Q, int32.
// Same run_layers as kernel 1, so the two agree bit for bit.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
lut_fused_pipelined_kernel(const int32_t* __restrict__ codes,
                           int32_t* __restrict__ out, int B,
                           const LayerDesc* __restrict__ layers, int n_layers,
                           int rows, int wP, int wQ, int vec16) {
  extern __shared__ __align__(16) int32_t smem[];
  const int n_in0 = layers[0].n_in;
  const int n_out_last = layers[n_layers - 1].n_out;
  int32_t* slot0 = smem;
  int32_t* slot1 = slot0 + rows * n_in0;
  int32_t* P = slot1 + rows * n_in0;
  int32_t* Q = P + rows * wP;
  const int n_tiles = (B + rows - 1) / rows;
  int tile = blockIdx.x;
  if (tile >= n_tiles) return;
  prefetch_codes(slot0, codes + static_cast<long long>(tile) * rows * n_in0,
                 tile_rows(tile, rows, B) * n_in0, vec16 != 0);
  for (int s = 0; tile < n_tiles; tile += gridDim.x, s ^= 1) {
    const int next = tile + gridDim.x;
    if (next < n_tiles) {
      // the other slot was last read by the previous tile, which every
      // thread finished before the barrier at the end of the loop body
      prefetch_codes(s ? slot0 : slot1,
                     codes + static_cast<long long>(next) * rows * n_in0,
                     tile_rows(next, rows, B) * n_in0, vec16 != 0);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    run_layers(layers, n_layers, s ? slot1 : slot0, P, wP, Q, wQ,
               tile_rows(tile, rows, B),
               out + static_cast<long long>(tile) * rows * n_out_last);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// C interface.  Every launch goes on the caller's stream, allocates
// nothing, and returns the cudaError_t of the launch (0 on success).
// ---------------------------------------------------------------------------
extern "C" int lut_desc_size() { return static_cast<int>(sizeof(LayerDesc)); }

extern "C" int lut_gather_launch(const int32_t* codes, int32_t* out, int B,
                                 const int32_t* conn, const uint8_t* sub,
                                 const uint8_t* add, int n_in, int n_out,
                                 int A, int F, int in_bits, int sub_bits,
                                 int K, int Ka, int sub_enc, int add_enc,
                                 void* stream) {
  const LayerDesc L{conn, sub, add, n_in, n_out, A, F, in_bits, sub_bits,
                    K, Ka, sub_enc, add_enc, 0, 0};
  const long long total = static_cast<long long>(B) * n_out;
  if (total == 0) return 0;
  const unsigned blocks =
      static_cast<unsigned>((total + kThreads - 1) / kThreads);
  lut_gather_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(codes, out, B, L);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lut_fused_launch(const int32_t* codes, int32_t* out, int B,
                                const void* layers, int n_layers, int rows,
                                int wP, int wQ, int smem_bytes, int pipeline,
                                int grid, int vec16, void* stream) {
  if (B == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const LayerDesc* d = static_cast<const LayerDesc*>(layers);
  if (pipeline) {
    if (smem_bytes > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          lut_fused_pipelined_kernel,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    lut_fused_pipelined_kernel<<<grid, kThreads, smem_bytes, st>>>(
        codes, out, B, d, n_layers, rows, wP, wQ, vec16);
  } else {
    if (smem_bytes > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          lut_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem_bytes);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    lut_fused_kernel<<<grid, kThreads, smem_bytes, st>>>(
        codes, out, B, d, n_layers, rows, wP, wQ);
  }
  return static_cast<int>(cudaGetLastError());
}
