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
// What all three are up against is latency: an output code is a chain of
// dependent reads (conn -> codes -> sub-table -> adder table), so the
// design is about keeping many chains in flight and making each read
// cheap:
//   * geometry from the batch: the wrapper picks rows (and, for kernel 3,
//     neurons) per block for each call (lut_gather.py: fused_geometry,
//     layer_geometry), so HDR-Add2's 256-row micro-batch spreads over
//     ~128 blocks, not a handful;
//   * rows fastest across lanes: thread t works on row t % R of its
//     block's R rows and on neurons t / R, t / R + T/R, ...  The lanes of
//     one neuron read the same `conn` words (a broadcast) and gather from
//     the same table row (a few cache lines, not 32), and the codes sit in
//     shared memory column-major (code c of row r at c*R + r), so those
//     lanes read consecutive banks;
//   * each output's reads issued together: the per-neuron work (run_layer,
//     shared by all three kernels) is a template on (A, F) for the
//     combinations of the paper's models, and on the slab encodings,
//     chosen by one branch per layer.  All A*F `conn` loads are
//     independent (16 or 8 bytes at a time where the slab is so aligned),
//     then all A*F code reads, then the A sub-table reads, then the adder
//     read: three dependent memory steps after the `conn` loads.  Each
//     thread carries two neurons at once.  Any other (A, F) or encoding
//     takes a generic path with runtime loops;
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

// Launch bounds: each kernel is held to 64 registers a thread, so the
// residency the wrapper plans (lut_gather.py, MAX_REGS_PER_THREAD) fits.
static constexpr int kMaxGatherThreads = 256;     // kernel 3
static constexpr int kMaxFusedThreads = 512;      // kernel 1
static constexpr int kMaxPipelinedThreads = 256;  // kernel 2
// kernel 2's ring holds at most two input stages (the TPU kernel's two
// in-slots)
static constexpr int kMaxStages = 2;

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
// row[c * cs].
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
// One layer for this thread's row r and its neurons n0, n0 + nstep, ...
// below n_end.  Source code c of row r is src[r * s_rs + c * s_cs]
// (column-major shared memory: s_rs = 1, s_cs = R; row-major: s_rs = the
// row's width, s_cs = 1); output n of row r goes to
// dst[r * d_rs + n * d_cs].
// ---------------------------------------------------------------------------
struct Pass {
  const int32_t* src;
  int32_t* dst;
  long long d_rs;
  int d_cs;
  int s_rs, s_cs;
  int r, n0, nstep, n_end;
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
  const int32_t* srow = p.src + p.r * p.s_rs;
  int32_t* drow = p.dst + p.r * p.d_rs;
  for (int nb = p.n0; nb < p.n_end; nb += 2 * p.nstep) {
    const bool two = nb + p.nstep < p.n_end;
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
          x += static_cast<unsigned>(srow[c[i][a * F + f] * p.s_cs])
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
  const int32_t* srow = p.src + p.r * p.s_rs;
  int32_t* drow = p.dst + p.r * p.d_rs;
  for (int n = p.n0; n < p.n_end; n += p.nstep)
    drow[static_cast<long long>(n) * p.d_cs] = lut_neuron(L, srow, p.s_cs, n);
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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// Kernel 3: one layer.  Block (x, y) takes rows x*R .. x*R + R-1 and
// neurons y*ntile .. y*ntile + ntile-1, as the TPU kernel's grid takes
// batch tiles x neuron tiles.  With `staged` the block first copies its
// rows' input codes into shared memory, column-major (code c of row r at
// c*R + r, as the fused kernels hold them), by 4-byte cp.async copies, all
// in flight at once, thread t copying row t % R so that a warp's copies
// land in consecutive banks; a layer whose rows do not fit a block's
// shared memory (over ~58,000 input codes) reads them from device memory,
// row-major.  Then run_layer, the fused kernels' own per-neuron code,
// writes the block's outputs row-major to device memory.  The layer comes
// by value, so no thread waits on a descriptor read.
//
// A chain of layers (lut_layers_launch) is a chain of dependent launches,
// each a few microseconds of dependent reads, so the gaps between them
// count: each layer after the first is a programmatic dependent launch.
// Its blocks are scheduled while the layer before still runs and wait
// (griddepcontrol.wait) for it to finish and its codes to be visible
// before they touch the codes or the output buffers; a launch without a
// prerequisite grid passes the wait at once.  (Bringing the first
// neurons' conn and table rows into L1 before the wait was tried, and
// was no faster: kernel_ab.py --sweep on the H100.)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kMaxGatherThreads, 4)
lut_gather_kernel(const int32_t* __restrict__ codes, int32_t* __restrict__ out,
                  int B, const LayerDesc L, int R, int ntile, int staged) {
  extern __shared__ __align__(16) int32_t smem[];
  // the next layer's launch may begin; its blocks wait for this grid
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int tid = static_cast<int>(threadIdx.x);
  const long long row0 = static_cast<long long>(blockIdx.x) * R;
  const int here = static_cast<int>(
      min(static_cast<long long>(R), static_cast<long long>(B) - row0));
  const int nstep = static_cast<int>(blockDim.x) / R;
  const int r = tid % R;
  const bool active = tid < nstep * R && r < here;
  const int32_t* rows = codes + row0 * L.n_in;
  Pass p{rows, out + row0 * L.n_out, L.n_out, 1, L.n_in, 1, r,
         static_cast<int>(blockIdx.y) * ntile + tid / R, nstep,
         min(L.n_out, static_cast<int>(blockIdx.y + 1) * ntile)};
  if (staged) {
    if (active)
      for (int c = tid / R; c < L.n_in; c += nstep)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                     ::"r"(smem_addr(smem + c * R + r)),
                       "l"(rows + static_cast<long long>(r) * L.n_in + c));
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    p.src = smem;
    p.s_rs = 1;
    p.s_cs = R;
  }
  if (active) run_layer(L, p);
}

// ---------------------------------------------------------------------------
// Fused layers of one tile of `here` <= R rows.  Layer 0 reads `in`, code
// c of row r at in[r * in_rs + c * in_cs]; layer l >= 1 reads what layer
// l-1 wrote.  Hidden layers write P (even l) or Q (odd l) — two buffers,
// so no layer overwrites codes that other threads are still reading — and
// the last layer writes `out` (row-major, device memory).  P and Q are
// column-major with R rows.  A barrier separates the layers.  Threads
// beyond the last whole row group, and those whose row lies past the
// tile's end, only take the barriers.
// ---------------------------------------------------------------------------
__device__ void run_layers(const LayerDesc* __restrict__ layers, int n_layers,
                           const int32_t* in, int in_rs, int in_cs,
                           int32_t* P, int32_t* Q, int R, int here,
                           int32_t* __restrict__ out) {
  const int tid = static_cast<int>(threadIdx.x);
  const int nstep = static_cast<int>(blockDim.x) / R;
  const int r = tid % R;
  const bool active = tid < nstep * R && r < here;
  Pass p{in, nullptr, 0, 0, in_rs, in_cs, r, active ? tid / R : INT_MAX,
         nstep, 0};
  for (int l = 0; l < n_layers; ++l) {
    const LayerDesc L = layers[l];
    p.n_end = L.n_out;
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
      p.s_rs = 1;
      p.s_cs = R;
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
  run_layers(layers, n_layers, in, 1, rows, P, Q, rows, here,
             out + row0 * n_out_last);
}

// ---------------------------------------------------------------------------
// Kernel 2's input ring.  A tile of rows is one contiguous span of
// rows x n_in0 int32 in device memory, so one bulk asynchronous copy
// (cp.async.bulk, completion counted in bytes on an mbarrier) moves it
// into a stage: the copy engine computes the addresses, and the threads
// spend no instructions on it.  A bulk copy wants 16-byte-aligned
// addresses and a multiple of 16 bytes, so the tile lands at the offset
// of its start within 16 bytes (`tile_lead`, 0-3 codes; each stage has 16
// bytes of slack for it), and the up to 3 codes before the first 16-byte
// boundary and after the last one are copied by the issuing thread before
// it arrives on the barrier.
// ---------------------------------------------------------------------------
__device__ __forceinline__ int tile_lead(const int32_t* src) {
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

// One thread: copy n codes from src (device memory) to stage + tile_lead,
// and arrive on `bar`, whose phase completes when the bytes have landed.
__device__ __forceinline__ void load_tile(int32_t* stage, uint64_t* bar,
                                          const int32_t* src, int n) {
  int32_t* dst = stage + tile_lead(src);
  const int head = min(n, (4 - tile_lead(src)) & 3);
  const int body = (n - head) & ~3;
  for (int k = 0; k < head; ++k) dst[k] = __ldg(src + k);
  for (int k = head + body; k < n; ++k) dst[k] = __ldg(src + k);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(4 * body) : "memory");
  if (body > 0)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];\n"
        ::"r"(smem_addr(dst + head)), "l"(src + head), "r"(4 * body),
          "r"(smem_addr(bar))
        : "memory");
}

__device__ __forceinline__ int tile_rows(int tile, int rows, int B) {
  return min(rows, B - tile * rows);
}

// ---------------------------------------------------------------------------
// Kernel 2: persistent form of kernel 1.  The wrapper sizes the grid to
// what the card holds resident and the rows per tile so that the tiles
// divide evenly over it (lut_gather.py: fused_geometry); block b walks
// tiles b, b + gridDim.x, ...  A ring of input stages takes the
// place of the TPU kernel's two in-slots: the block's first `stages`
// tiles are requested at once, and each stage is refilled with the tile
// `stages` ahead as soon as every thread is done with it, so tile i+1's
// codes stream in while tile i computes.  Output rows go straight to
// device memory from the last layer, so no out-slots are needed.
//
// Layer 0 reads its codes where the bulk copy put them, row-major (code
// c of row r at r*n_in0 + c), through the strides Pass carries; a
// transpose into kernel 1's column-major layout would cost a pass over
// the tile's codes, a barrier and a third buffer of shared memory a row.
// The price: the R lanes of one neuron read R words n_in0 apart, which
// share a bank when n_in0 * 4 bytes is a multiple of 128, and otherwise
// (HDR-Add2's 784 codes, JSC-XL-Add2's 16: 16 words mod 32) fall on two
// banks, a max(1, R/2)-way conflict on layer 0's code reads only; later
// layers read P and Q column-major, conflict-free, as kernel 1 does.
//
// Shared memory: `stages` mbarriers (8 bytes each, in a 16-byte slot) |
// `stages` stages of round_up4(rows*n_in0) + 4 int32 | P (wP x rows) |
// Q (wQ x rows), exactly the wrapper's ledger (fused_smem_bytes with
// pipeline=True).  A launch whose blocks walk one tile each takes one
// stage (there is nothing to prefetch), so it holds as many blocks per
// SM as kernel 1 would.  Same run_layers as kernel 1, so the two agree
// bit for bit.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kMaxPipelinedThreads, 4)
lut_fused_pipelined_kernel(const int32_t* __restrict__ codes,
                           int32_t* __restrict__ out, int B,
                           const LayerDesc* __restrict__ layers, int n_layers,
                           int rows, int wP, int wQ, int stages) {
  extern __shared__ __align__(16) int32_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  const int n_in0 = layers[0].n_in;
  const int n_out_last = layers[n_layers - 1].n_out;
  const long long tile_codes = static_cast<long long>(rows) * n_in0;
  const int stride = ((rows * n_in0 + 3) & ~3) + 4;
  int32_t* ring = smem + 4;
  int32_t* P = ring + stages * stride;
  int32_t* Q = P + rows * wP;
  const int n_tiles = (B + rows - 1) / rows;
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
        load_tile(ring + s * stride, full + s, codes + t * tile_codes,
                  tile_rows(t, rows, B) * n_in0);
    }
  int i = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++i) {
    const int s = i % stages;
    const int32_t* src = codes + tile * tile_codes;
    mbar_wait(full + s, static_cast<unsigned>(i / stages) & 1);
    run_layers(layers, n_layers, ring + s * stride + tile_lead(src), n_in0,
               1, P, Q, rows, tile_rows(tile, rows, B),
               out + static_cast<long long>(tile) * rows * n_out_last);
    // every thread is done with stage s, P and Q
    __syncthreads();
    const int next = tile + stages * gridDim.x;
    if (threadIdx.x == 0 && next < n_tiles) {
      // order the threads' reads of the stage before the copy's writes
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      load_tile(ring + s * stride, full + s, codes + next * tile_codes,
                tile_rows(next, rows, B) * n_in0);
    }
  }
}

// ---------------------------------------------------------------------------
// C interface.  Every launch goes on the caller's stream, allocates
// nothing, and returns the cudaError_t of the launch (0 on success).
// ---------------------------------------------------------------------------
extern "C" int lut_desc_size() { return static_cast<int>(sizeof(LayerDesc)); }

// The shared-memory carveout (percent of the SM's unified L1 / shared
// memory) is a hint that CUDA rounds up to a configuration that holds the
// launch; the last value set for each kernel is remembered so a steady
// stream of one geometry sets it once.  The same for the most dynamic
// shared memory a launch of each kernel may take.  cudaFuncSetAttribute
// acts on the current device only, so both are remembered per device
// ordinal: a launch on any card sets its own attributes once.  A slot
// holds the carveout + 1 (0: never set) or the bytes (0: never raised).
static constexpr int kMaxDevices = 64;
using DeviceSlots = std::atomic<int>[kMaxDevices];

static cudaError_t current_device(int* ordinal) {
  const cudaError_t e = cudaGetDevice(ordinal);
  if (e != cudaSuccess) return e;
  return *ordinal >= 0 && *ordinal < kMaxDevices ? cudaSuccess
                                                 : cudaErrorInvalidDevice;
}

static cudaError_t set_carveout(const void* kernel, DeviceSlots& last,
                                int percent) {
  if (percent < 0) return cudaSuccess;
  int dev = 0;
  const cudaError_t e = current_device(&dev);
  if (e != cudaSuccess) return e;
  if (last[dev].exchange(percent + 1) == percent + 1) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout, percent);
}

static cudaError_t set_max_smem(const void* kernel, DeviceSlots& last,
                                int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = current_device(&dev);
  if (e != cudaSuccess || last[dev].load() >= bytes) return e;
  e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) last[dev].store(bytes);
  return e;
}

static DeviceSlots g_carveout_fused, g_carveout_pipelined,
    g_carveout_gather;
static DeviceSlots g_smem_fused, g_smem_pipelined, g_smem_gather;

// Kernel 3 over a chain of n_layers layers (one layer: lut_gather; a
// per_layer plan: the whole forward), one launch a layer, from one host
// call.  `layers` is the host array of descriptors (each launch takes its
// layer by value); `geo` holds 6 ints a layer: rows, threads, neuron
// tile, row tiles, neuron tiles, dynamic shared memory (0: unstaged).
// Layer l writes `out` if it is the last, else buf0 (even l) or buf1
// (odd l), each B x that layer's width; layer l+1 reads it.
extern "C" int lut_layers_launch(const int32_t* codes, int32_t* out, int B,
                                 const void* layers, int n_layers,
                                 int32_t* buf0, int32_t* buf1,
                                 const int32_t* geo, int carveout,
                                 void* stream) {
  if (B == 0 || n_layers == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const LayerDesc* d = static_cast<const LayerDesc*>(layers);
  const void* kernel = reinterpret_cast<const void*>(lut_gather_kernel);
  int most = 0;
  for (int l = 0; l < n_layers; ++l) {
    const int* g = geo + 6 * l;
    if (g[1] < 1 || g[1] > kMaxGatherThreads || g[0] < 1 || g[0] > g[1] ||
        g[2] < 1 || g[3] < 1 || g[4] < 1 || g[4] > 65535)
      return static_cast<int>(cudaErrorInvalidValue);
    most = max(most, g[5]);
  }
  cudaError_t e = set_carveout(kernel, g_carveout_gather, carveout);
  if (e == cudaSuccess) e = set_max_smem(kernel, g_smem_gather, most);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute pdl[1] = {};
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  const int32_t* src = codes;
  for (int l = 0; l < n_layers; ++l) {
    const int* g = geo + 6 * l;
    int32_t* dst = l == n_layers - 1 ? out : ((l & 1) ? buf1 : buf0);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(g[3], g[4]);
    cfg.blockDim = dim3(g[1]);
    cfg.dynamicSmemBytes = g[5];
    cfg.stream = st;
    cfg.attrs = pdl;
    cfg.numAttrs = l > 0 ? 1 : 0;  // layer l > 0 depends on layer l-1
    e = cudaLaunchKernelEx(&cfg, lut_gather_kernel, src, dst, B, d[l], g[0],
                           g[2], static_cast<int>(g[5] > 0));
    if (e == cudaSuccess) e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    src = dst;
  }
  return 0;
}

// `pipeline` is 0 for kernel 1, else kernel 2's ring stages (1 or 2).
extern "C" int lut_fused_launch(const int32_t* codes, int32_t* out, int B,
                                const void* layers, int n_layers, int rows,
                                int threads, int wP, int wQ, int smem_bytes,
                                int pipeline, int grid, int carveout,
                                void* stream) {
  if (B == 0) return 0;
  const int most = pipeline ? kMaxPipelinedThreads : kMaxFusedThreads;
  if (threads < 1 || threads > most || rows < 1 || rows > threads ||
      pipeline < 0 || pipeline > kMaxStages)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const LayerDesc* d = static_cast<const LayerDesc*>(layers);
  const void* kernel =
      pipeline ? reinterpret_cast<const void*>(lut_fused_pipelined_kernel)
               : reinterpret_cast<const void*>(lut_fused_kernel);
  cudaError_t e = set_carveout(
      kernel, pipeline ? g_carveout_pipelined : g_carveout_fused, carveout);
  if (e == cudaSuccess)
    e = set_max_smem(kernel, pipeline ? g_smem_pipelined : g_smem_fused,
                     smem_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (pipeline)
    lut_fused_pipelined_kernel<<<grid, threads, smem_bytes, st>>>(
        codes, out, B, d, n_layers, rows, wP, wQ, pipeline);
  else
    lut_fused_kernel<<<grid, threads, smem_bytes, st>>>(
        codes, out, B, d, n_layers, rows, wP, wQ);
  return static_cast<int>(cudaGetLastError());
}
