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
// What the fused kernels are up against is latency: an output code is a
// chain of dependent reads (conn -> codes -> sub-table -> adder table),
// so the design is about keeping many chains in flight and making each
// read cheap:
//   * geometry from the batch: the wrapper picks the rows per block for
//     each call (lut_gather.py: fused_geometry), so HDR-Add2's 256-row
//     micro-batch runs on 128 blocks of 2 rows, not 8 blocks of 32, and a
//     4096-row batch on 512 blocks of 8 rows, four resident on each SM,
//     128 threads a block (the geometries a sweep on the H100 put first);
//   * rows fastest across lanes: thread t works on row t % R of its
//     block's R rows and on neurons t / R, t / R + T/R, ...  The lanes of
//     one neuron read the same `conn` words (a broadcast) and gather from
//     the same table row (a few cache lines, not 32), and the codes sit in
//     shared memory column-major (code c of row r at c*R + r), so those
//     lanes read consecutive banks;
//   * each output's reads issued together: the per-neuron work is a
//     template on (A, F) for the combinations of the paper's models, and on
//     the slab encodings, chosen by one branch per layer.  All A*F `conn`
//     loads are independent (16 or 8 bytes at a time where the slab is so
//     aligned), then all A*F code reads, then the A sub-table reads, then
//     the adder read: three dependent memory steps after the `conn`
//     loads.  Each thread carries two neurons at once.  Any other (A, F)
//     or encoding takes a generic path with runtime loops;
//   * the shared-memory carveout is set per launch to what the resident
//     blocks need, so the rest of the SM's 256 KB stays L1 for the tables.
//
// Table address of sub-neuron (n, a): the F gathered codes packed
// in_bits apart, slot 0 in the low bits, masked to the row (& (K-1)) and
// offset by the flat slab base n*A*K + a*K.  With the adder on, the A
// sub-codes are packed sub_bits apart and looked up in row n of the adder
// table (& (Ka-1)).  Slabs are uint8, int32, or int4 nibble-packed (two
// codes per byte, low nibble first: byte fi>>1, nibble fi&1).  The masks
// keep a request code that is out of range inside its slab row.  Every
// path computes exactly this, so all three kernels agree bit for bit.

#include <atomic>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#define ENC_U8 0
#define ENC_I32 1
#define ENC_INT4 2
#define ENC_NONE (-1)  // adder off: the layer's output is sub-neuron 0's code

static constexpr int kGatherThreads = 256;   // kernel 3
static constexpr int kMaxFusedThreads = 512;  // kernels 1 and 2

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

template <int E>
__device__ __forceinline__ int read_enc(const uint8_t* slab, long long fi) {
  if (E == ENC_I32) return __ldg(reinterpret_cast<const int*>(slab) + fi);
  if (E == ENC_INT4) {
    const int byte = __ldg(slab + (fi >> 1));
    return (byte >> (static_cast<int>(fi & 1) * 4)) & 0xF;
  }
  return __ldg(slab + fi);
}

__device__ __forceinline__ int read_code(const uint8_t* slab, int enc,
                                         long long fi) {
  if (enc == ENC_I32) return read_enc<ENC_I32>(slab, fi);
  if (enc == ENC_INT4) return read_enc<ENC_INT4>(slab, fi);
  return read_enc<ENC_U8>(slab, fi);
}

// Generic path: output code of neuron n for one row whose code c sits at
// row[c * cs] (cs = 1 for a row-major row in device memory, the block's
// row count for the fused kernels' column-major shared memory).
__device__ __forceinline__ int lut_neuron(const LayerDesc& L,
                                          const int32_t* row, int cs, int n) {
  unsigned aidx = 0;
  for (int a = 0; a < L.A; ++a) {
    const long long sa = static_cast<long long>(n) * L.A + a;
    const int32_t* c = L.conn + sa * L.F;
    unsigned idx = 0;
    for (int f = 0; f < L.F; ++f)
      idx += static_cast<unsigned>(row[__ldg(c + f) * cs]) << (L.in_bits * f);
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
__global__ void __launch_bounds__(kGatherThreads)
lut_gather_kernel(const int32_t* __restrict__ codes, int32_t* __restrict__ out,
                  int B, LayerDesc L) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= static_cast<long long>(B) * L.n_out) return;
  const int b = static_cast<int>(t / L.n_out);
  const int n = static_cast<int>(t - static_cast<long long>(b) * L.n_out);
  out[t] = lut_neuron(L, codes + static_cast<long long>(b) * L.n_in, 1, n);
}

// ---------------------------------------------------------------------------
// One layer of a fused block, for this thread's row r and its neurons
// n0, n0 + nstep, ...  Source code c of row r is src[c * R + r]; output n
// of row r goes to dst[r * d_rs + n * d_cs].
// ---------------------------------------------------------------------------
struct Pass {
  const int32_t* src;
  int32_t* dst;
  long long d_rs;
  int d_cs;
  int R, r, n0, nstep;
};

// One neuron's N conn indices: 16- or 8-byte loads where N and the slab's
// alignment allow (`vec`), else 4-byte ones.
template <int N>
__device__ __forceinline__ void load_conn(int (&c)[N], const int32_t* p,
                                          bool vec) {
  if constexpr (N % 4 == 0) {
    if (vec) {
#pragma unroll
      for (int q = 0; q < N / 4; ++q) {
        const int4 x = __ldg(reinterpret_cast<const int4*>(p) + q);
        c[4 * q] = x.x; c[4 * q + 1] = x.y; c[4 * q + 2] = x.z;
        c[4 * q + 3] = x.w;
      }
      return;
    }
  } else if constexpr (N % 2 == 0) {
    if (vec) {
#pragma unroll
      for (int q = 0; q < N / 2; ++q) {
        const int2 x = __ldg(reinterpret_cast<const int2*>(p) + q);
        c[2 * q] = x.x; c[2 * q + 1] = x.y;
      }
      return;
    }
  }
#pragma unroll
  for (int q = 0; q < N; ++q) c[q] = __ldg(p + q);
}

// (A, F) and the encodings known at compile time: two neurons in flight,
// every conn load, then every code read, then every sub-table read, then
// the adder reads, each group independent.
template <int A, int F, int SE, int AE>
__device__ __forceinline__ void layer_af(const LayerDesc& L, const Pass& p) {
  const unsigned kmask = static_cast<unsigned>(L.K - 1);
  const unsigned amask = static_cast<unsigned>(L.Ka - 1);
  const int in_bits = L.in_bits, sub_bits = L.sub_bits;
  const bool vec = (reinterpret_cast<uintptr_t>(L.conn) & 15) == 0;
  const int32_t* srow = p.src + p.r;
  int32_t* drow = p.dst + p.r * p.d_rs;
  for (int nb = p.n0; nb < L.n_out; nb += 2 * p.nstep) {
    const bool two = nb + p.nstep < L.n_out;
    const int n[2] = {nb, two ? nb + p.nstep : nb};
    int c[2][A * F];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      load_conn(c[i], L.conn + static_cast<long long>(n[i]) * (A * F), vec);
    unsigned idx[2][A];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int a = 0; a < A; ++a) {
        unsigned x = 0;
#pragma unroll
        for (int f = 0; f < F; ++f)
          x += static_cast<unsigned>(srow[c[i][a * F + f] * p.R])
               << (in_bits * f);
        idx[i][a] = x & kmask;
      }
    int s[2][A];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int a = 0; a < A; ++a)
        s[i][a] = read_enc<SE>(
            L.sub, (static_cast<long long>(n[i]) * A + a) * L.K + idx[i][a]);
    int o[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if constexpr (AE == ENC_NONE) {
        o[i] = s[i][0];
      } else {
        unsigned x = 0;
#pragma unroll
        for (int a = 0; a < A; ++a)
          x += static_cast<unsigned>(s[i][a]) << (sub_bits * a);
        o[i] = read_enc<AE>(L.add,
                            static_cast<long long>(n[i]) * L.Ka + (x & amask));
      }
    }
    drow[static_cast<long long>(n[0]) * p.d_cs] = o[0];
    if (two) drow[static_cast<long long>(n[1]) * p.d_cs] = o[1];
  }
}

__device__ __noinline__ void layer_generic(const LayerDesc& L, const Pass& p) {
  int32_t* drow = p.dst + p.r * p.d_rs;
  for (int n = p.n0; n < L.n_out; n += p.nstep)
    drow[static_cast<long long>(n) * p.d_cs] =
        lut_neuron(L, p.src + p.r, p.R, n);
}

// The encodings of one (A, F): single sub-neurons (A == 1) with the adder
// off, and adders (A >= 2) with the adder on; false for anything else.
template <int A, int F>
__device__ __forceinline__ bool layer_enc(const LayerDesc& L, const Pass& p) {
  if constexpr (A == 1) {
    if (L.add_enc != ENC_NONE) return false;
    switch (L.sub_enc) {
      case ENC_U8: layer_af<A, F, ENC_U8, ENC_NONE>(L, p); return true;
      case ENC_I32: layer_af<A, F, ENC_I32, ENC_NONE>(L, p); return true;
      case ENC_INT4: layer_af<A, F, ENC_INT4, ENC_NONE>(L, p); return true;
    }
    return false;
  } else {
#define LUT_ENC_CASE(SE, AE)                 \
  case SE * 3 + AE:                          \
    layer_af<A, F, SE, AE>(L, p);            \
    return true;
    if (L.add_enc == ENC_NONE) return false;
    switch (L.sub_enc * 3 + L.add_enc) {
      LUT_ENC_CASE(ENC_U8, ENC_U8)
      LUT_ENC_CASE(ENC_U8, ENC_I32)
      LUT_ENC_CASE(ENC_U8, ENC_INT4)
      LUT_ENC_CASE(ENC_I32, ENC_U8)
      LUT_ENC_CASE(ENC_I32, ENC_I32)
      LUT_ENC_CASE(ENC_I32, ENC_INT4)
      LUT_ENC_CASE(ENC_INT4, ENC_U8)
      LUT_ENC_CASE(ENC_INT4, ENC_I32)
      LUT_ENC_CASE(ENC_INT4, ENC_INT4)
    }
#undef LUT_ENC_CASE
    return false;
  }
}

// One branch per layer: the (A, F) of the paper's models — HDR (1,6),
// HDR-Add2 (2,4), JSC-XL (1,2)/(1,3), JSC-XL-Add2 (2,1)/(2,2), JSC-M Lite
// (1,4), JSC-M-Add2 (2,2), JSC-2L (1,3) — else the generic path.
__device__ __forceinline__ void run_layer(const LayerDesc& L, const Pass& p) {
  bool done = false;
  switch (L.A * 32 + L.F) {  // F <= 30: in_bits * F <= 30
    case 32 + 2: done = layer_enc<1, 2>(L, p); break;
    case 32 + 3: done = layer_enc<1, 3>(L, p); break;
    case 32 + 4: done = layer_enc<1, 4>(L, p); break;
    case 32 + 6: done = layer_enc<1, 6>(L, p); break;
    case 64 + 1: done = layer_enc<2, 1>(L, p); break;
    case 64 + 2: done = layer_enc<2, 2>(L, p); break;
    case 64 + 4: done = layer_enc<2, 4>(L, p); break;
  }
  if (!done) layer_generic(L, p);
}

// ---------------------------------------------------------------------------
// Fused layers of one tile of `here` <= R rows.  Layer 0 reads `in`;
// layer l >= 1 reads what layer l-1 wrote.  Hidden layers write P (even l)
// or Q (odd l) — two buffers, so no layer overwrites codes that other
// threads are still reading — and the last layer writes `out` (row-major,
// device memory).  All three are column-major with R rows.  A barrier
// separates the layers.  Threads beyond the last whole row group, and
// those whose row lies past the tile's end, only take the barriers.
// ---------------------------------------------------------------------------
__device__ void run_layers(const LayerDesc* __restrict__ layers, int n_layers,
                           const int32_t* in, int32_t* P, int32_t* Q, int R,
                           int here, int32_t* __restrict__ out) {
  const int tid = static_cast<int>(threadIdx.x);
  const int nstep = static_cast<int>(blockDim.x) / R;
  const int r = tid % R;
  const bool active = tid < nstep * R && r < here;
  Pass p{in, nullptr, 0, 0, R, r, active ? tid / R : INT_MAX, nstep};
  for (int l = 0; l < n_layers; ++l) {
    const LayerDesc L = layers[l];
    if (l == n_layers - 1) {
      p.dst = out;
      p.d_rs = L.n_out;
      p.d_cs = 1;
      run_layer(L, p);
    } else {
      p.dst = (l & 1) ? Q : P;
      p.d_rs = 1;
      p.d_cs = R;
      run_layer(L, p);
      __syncthreads();
      p.src = p.dst;
    }
  }
}

// Stage `here` rows of n_in codes (row-major in device memory) into
// shared memory column-major with R rows (code c of row r at c*R + r),
// 4-byte cp.async copies as one commit group.
__device__ __forceinline__ void stage_codes(int32_t* dst, const int32_t* src,
                                            int here, int n_in, int R) {
  for (int r = 0; r < here; ++r)
    for (int c = threadIdx.x; c < n_in; c += blockDim.x) {
      const unsigned s =
          static_cast<unsigned>(__cvta_generic_to_shared(dst + c * R + r));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                   "l"(src + static_cast<long long>(r) * n_in + c));
    }
  asm volatile("cp.async.commit_group;\n" ::);
}

// ---------------------------------------------------------------------------
// Kernel 1: the whole network, one block per tile of `rows` batch rows.
// Shared memory, column-major: in (n_in0 x rows) | P (wP x rows) |
// Q (wQ x rows), int32.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kMaxFusedThreads, 2)
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
  stage_codes(in, codes + row0 * n_in0, here, n_in0, rows);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  run_layers(layers, n_layers, in, P, Q, rows, here,
             out + row0 * n_out_last);
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
// Shared memory: slot0 | slot1 (n_in0 x rows each) | P | Q, int32,
// column-major.  Same run_layers as kernel 1, so the two agree bit for bit.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kMaxFusedThreads, 1)
lut_fused_pipelined_kernel(const int32_t* __restrict__ codes,
                           int32_t* __restrict__ out, int B,
                           const LayerDesc* __restrict__ layers, int n_layers,
                           int rows, int wP, int wQ) {
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
  stage_codes(slot0, codes + static_cast<long long>(tile) * rows * n_in0,
              tile_rows(tile, rows, B), n_in0, rows);
  for (int s = 0; tile < n_tiles; tile += gridDim.x, s ^= 1) {
    const int next = tile + gridDim.x;
    if (next < n_tiles) {
      // the other slot was last read by the previous tile, which every
      // thread finished before the barrier at the end of the loop body
      stage_codes(s ? slot0 : slot1,
                  codes + static_cast<long long>(next) * rows * n_in0,
                  tile_rows(next, rows, B), n_in0, rows);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    run_layers(layers, n_layers, s ? slot1 : slot0, P, Q, rows,
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
      static_cast<unsigned>((total + kGatherThreads - 1) / kGatherThreads);
  lut_gather_kernel<<<blocks, kGatherThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(codes, out, B, L);
  return static_cast<int>(cudaGetLastError());
}

// The shared-memory carveout (percent of the SM's unified L1 / shared
// memory) is a hint that CUDA rounds up to a configuration that holds the
// launch; the last value set for each kernel is remembered so a steady
// stream of one geometry sets it once.
static cudaError_t set_carveout(const void* kernel, std::atomic<int>& last,
                                int percent) {
  if (percent < 0 || last.exchange(percent) == percent) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout, percent);
}

static std::atomic<int> g_carveout_fused{-1}, g_carveout_pipelined{-1};

extern "C" int lut_fused_launch(const int32_t* codes, int32_t* out, int B,
                                const void* layers, int n_layers, int rows,
                                int threads, int wP, int wQ, int smem_bytes,
                                int pipeline, int grid, int carveout,
                                void* stream) {
  if (B == 0) return 0;
  if (threads < 1 || threads > kMaxFusedThreads || rows < 1 || rows > threads)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const LayerDesc* d = static_cast<const LayerDesc*>(layers);
  const void* kernel =
      pipeline ? reinterpret_cast<const void*>(lut_fused_pipelined_kernel)
               : reinterpret_cast<const void*>(lut_fused_kernel);
  cudaError_t e = set_carveout(
      kernel, pipeline ? g_carveout_pipelined : g_carveout_fused, carveout);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (smem_bytes > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (pipeline)
    lut_fused_pipelined_kernel<<<grid, threads, smem_bytes, st>>>(
        codes, out, B, d, n_layers, rows, wP, wQ);
  else
    lut_fused_kernel<<<grid, threads, smem_bytes, st>>>(
        codes, out, B, d, n_layers, rows, wP, wQ);
  return static_cast<int>(cudaGetLastError());
}
