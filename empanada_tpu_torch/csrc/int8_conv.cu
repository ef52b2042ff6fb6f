// s8 x s8 -> s32 convolution with a per-tensor activation scale and
// per-output-channel weight scales, for int8_execution models.
//
// Replaces XLA's integer convolution in empanada_tpu/models/blocks.py
// (int8_conv: lax.conv_general_dilated with preferred_element_type=int32).
// That is not a Pallas kernel; PyTorch has no CUDA int8 convolution, so the
// port writes it by hand.  It computes the JAX function bit for bit:
//
//   a_scale = max(max|x|, 1e-12) * f32(1 / 127)        (f32, whole tensor)
//   xq      = clip(rint(x / a_scale), -127, 127)       (s8, IEEE division)
//   acc     = conv(xq, wq)                             (s32, exact)
//   out     = T(float(acc) * (a_scale * w_scale[o]))   (f32 product first)
//
// wq and w_scale are quantized once from the f32 master weights by the
// wrapper (ops/int8_conv.py::quantize_weight), wq stored as
// [C_out][kh][kw][C_in] so that the GEMM's K runs contiguous.
//
// Inputs (on the card): x (N, H, W, C) bf16 or f32 in NHWC (the port's
// channels_last NCHW tensors), C % 32 == 0; wq s8 [O][KH][KW][C] behind a
// 2-D tensor map of [O, K] (int8_weight_map, encoded once per weight);
// w_scale f32 [O], O % 8 == 0.  Output: out (N, Ho, Wo, O) of x's type.
//
// One call is three kernels on one stream, no memset, nothing read back:
//
// 1. absmax_kernel: a grid-stride pass over x, 16-byte loads; each block
//    writes the max of |x| over its share to partial[block] (no initial
//    value needed: every slot is written).
// 2. quantize_kernel (programmatic dependent launch): every block reduces
//    the <= 1056 partial maxima itself, block 0 stores the max for the
//    GEMM's epilogue and the readout, and xq = clip(rint(x / a_scale)) is
//    written as s8 NHWC.  It lets the GEMM launch as it starts.
// 3. gemm_kernel (programmatic dependent launch; a cluster of the split's
//    blocks when K is split): an implicit GEMM, M = N*Ho*Wo output pixels
//    by N = O channels by K = KH*KW*C, in 128 x 128 tiles, K in steps of
//    128 bytes (one tap, 128 channels).  One producer warpgroup fills a
//    ring of 4 stages, each 128 x 128 bytes of A and of B in wgmma's
//    128-byte swizzle, paced by full and empty mbarriers; two consumer
//    warpgroups (64 rows each) run wgmma.m64n128k32 s8 from shared memory
//    into s32 registers.
//    - B (the weights) comes by TMA, one box of the [O, K] map a stage.
//      The weights depend on nothing, so the first stages' boxes are
//      asked for (and the barriers set up) before griddepcontrol.wait,
//      overlapping the quantize pass; only A waits for it.
//    - A (the im2col of xq): where C >= 128 and the stride <= 8, by TMA
//      too, one box of a 4-D map of xq (N, H, W, C) a stage: an M tile is
//      a block of (128 / wb) x wb output pixels of one image, and the box
//      holds their input pixels for the stage's tap, traversed at the
//      convolution's stride; out of bounds (the padding) is zero.  One
//      thread issues both boxes.  Otherwise by cp.async: an M tile is 128
//      consecutive output pixels, 16 bytes a thread, 8 threads a 128-byte
//      row, zero-filled at the padding and past M.  TMA is the faster
//      path: a stage of 16-byte cp.async copies costs the SM more issue
//      slots and shared-memory bandwidth than the tensor cores' work on it.
//
//    Where a request's grid is small the plan (ops/int8_conv.py::plan)
//    splits K over `split` blocks of one cluster (at most 4): rank r takes
//    K steps [r * steps / split, (r + 1) * steps / split).  The epilogue
//    writes each block's s32 tile to its shared memory; rank r owns rows
//    [r * 128 / split, (r + 1) * 128 / split), and every other block sends
//    it those rows by one bulk copy through distributed shared memory into
//    a receive slot, completing on the owner's mbarrier.  Integer sums are
//    exact in any order, so the split result is bit for bit the unsplit
//    one.  There is no global workspace and no counter, so nothing carries
//    over from one call to the next (CUDA graph replay and two streams are
//    safe).
//
//    C % 128 != 0 (any C % 32 == 0): a tap takes ceil(C / 128) K steps of
//    128 bytes; A is zero past C, so the B bytes the same box reads there
//    (the next tap's channels, or zeros past K) add nothing.
//
//    The epilogue converts with __int2float_rn, multiplies by
//    __fmul_rn(a_scale, w_scale[o]) and rounds to the output type (round
//    to nearest even), 16 or 8 bytes a thread, a warp a row.
//
// What bounds it on an H100: at MitoNet_v1's shapes (512 x 512 request:
// 4096 x 128 x 1152 in layer2, 1024 x 256 x 2304 in layer3, 1024 x 512 x
// 4608 in layer4) the products are 1.2-4.8 G integer operations a call
// against under 5 MB moved, so the bound is the tensor cores' int8 rate
// (1,979 TOP/s dense); the quantize passes are bound by bytes.  At N = 1
// the tiles alone (16-32) would leave most of the 132 SMs idle: the split
// brings the grid to 64-96 blocks, all resident at once.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;        // the prologue's blocks
constexpr int kReduceBlocks = 1056;  // 8 blocks per SM of an H100 at most

// the GEMM's tiles: rows (output pixels), columns (output channels), K bytes a stage
constexpr int kBM = 128, kBN = 128, kBK = 128;
constexpr int kStages = 4;
constexpr int kConsumers = 2;  // warpgroups of 64 rows
constexpr int kProducerThreads = 128;
constexpr int kGemmThreads = 128 * kConsumers + kProducerThreads;
constexpr int kTileBytes = kBM * kBK;  // A and B alike (kBN == kBM)
constexpr int kStageBytes = 2 * kTileBytes;
constexpr int kAccPitch = kBN + 8;  // s32 a row of the staged tile and the receive buffer
// blocks of a cluster: the reduction's cost grows with the split (PERF.md)
constexpr int kMaxSplit = 4;
constexpr int kRing = kStages * kStageBytes;
// the receive buffer: split - 1 slots of ceil(kBM / split) rows, at most kBM
constexpr int kRecvBytes = kBM * kAccPitch * 4;
// + alignment slack, barriers, the tile's weight scales and output pixels
constexpr int kSmemBytes = 1024 + kRing + kRecvBytes + (2 * kStages + 1) * 8 + kBN * 4 + kBM * 4;
static_assert(kBM * kAccPitch * 4 <= kRing, "the s32 tile reuses the ring");

// / 127 as XLA computes it: a multiplication by float32(1 / 127)
constexpr float kInv127 = 1.0f / 127.0f;

__device__ __forceinline__ float act_scale(float amax) {
  return __fmul_rn(fmaxf(amax, 1e-12f), kInv127);
}

// ---- programmatic dependent launch

// waits until the grids this one depends on have finished and their writes are visible
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// lets the next grid (launched with programmatic stream serialization) start
__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// ---- the prologue: per-block maxima, then quantize

// 16 bytes of x as floats: 8 bf16 or 4 f32
template <typename T> struct Vec;
template <> struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ static void load(const __nv_bfloat16* p, float* v) {
    uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};
template <> struct Vec<float> {
  static constexpr int n = 4;
  __device__ static void load(const float* p, float* v) {
    float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  }
};

// the max of m over the block, in every thread
__device__ __forceinline__ float block_max(float m) {
  __shared__ float warp_max[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  m = warp_max[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, warp_max[w]);
  return m;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) absmax_kernel(const T* __restrict__ x,
                                                          long long nvec,
                                                          float* __restrict__ partial) {
  griddep_launch_dependents();  // the quantize pass waits for this grid's end itself
  constexpr int V = Vec<T>::n;
  float m = 0.f;
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < nvec;
       i += (long long)gridDim.x * kThreads) {
    float v[V];
    Vec<T>::load(x + i * V, v);
#pragma unroll
    for (int k = 0; k < V; ++k) m = fmaxf(m, fabsf(v[k]));
  }
  m = block_max(m);
  if (threadIdx.x == 0) partial[blockIdx.x] = m;
}

__device__ __forceinline__ int quantize1(float v, float s) {
  float q = rintf(__fdiv_rn(v, s));
  return (int)fminf(fmaxf(q, -127.f), 127.f);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) quantize_kernel(const T* __restrict__ x,
                                                            long long nvec,
                                                            const float* partial, int nparts,
                                                            float* amax,
                                                            int8_t* __restrict__ xq) {
  // the GEMM may be scheduled now (its set-up and first weight loads
  // overlap this pass); it waits for this grid's end before reading xq
  griddep_launch_dependents();
  griddep_wait();  // absmax_kernel's maxima are written
  float m = 0.f;
  for (int i = threadIdx.x; i < nparts; i += kThreads) m = fmaxf(m, partial[i]);
  m = block_max(m);
  if (blockIdx.x == 0 && threadIdx.x == 0) *amax = m;
  constexpr int V = Vec<T>::n;
  const float s = act_scale(m);
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < nvec;
       i += (long long)gridDim.x * kThreads) {
    float v[V];
    Vec<T>::load(x + i * V, v);
    uint32_t packed[V / 4];
#pragma unroll
    for (int w = 0; w < V / 4; ++w) {
      uint32_t word = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        word |= (uint32_t)(quantize1(v[4 * w + k], s) & 0xff) << (8 * k);
      packed[w] = word;
    }
    if constexpr (V == 8)
      *reinterpret_cast<uint2*>(xq + i * V) = make_uint2(packed[0], packed[1]);
    else
      *reinterpret_cast<uint32_t*>(xq + i * V) = packed[0];
  }
}

// ---- shared memory, barriers, copies, clusters and wgmma (PTX)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// spins until the phase of `bar` with this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// an arrival on `bar` once this thread's earlier cp.async copies have landed
// (counted among the barrier's expected arrivals: .noinc)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  // src-size 0 writes 16 zero bytes and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// this thread's arrival on `bar`, posting the bytes its phase also waits for
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// a box of a 2-D tensor map at (c0, c1) into shared memory, swizzled by the
// map, completing its bytes on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// a box of a 4-D tensor map at (c0, c1, c2, c3)
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}

// makes shared-memory writes of the generic proxy (cp.async, stores)
// visible to the async proxy (wgmma)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// wgmma shared-memory descriptor of a K-major, 128-byte-swizzled operand
// whose 8-row groups lie 1024 bytes apart
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | (uint64_t(1) << 16) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kPending) : "memory");
}

// keeps the compiler from moving accumulator reads across a wgmma wait
__device__ __forceinline__ void fence_operands(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 x 128, s32) += A (64 x 32) . B (32 x 128), both operands s8 in
// shared memory, K-major
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], uint64_t desc_a,
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// this thread's arrival on the cluster barrier (paired with cluster_wait);
// it publishes the barriers set up before it
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// the address of the same shared-memory offset as `p` in block `rank` of the cluster
__device__ __forceinline__ uint32_t mapa(const void* p, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(smem_u32(p)),
               "r"(rank));
  return remote;
}

// `bytes` of this block's shared memory into another block's (cluster
// addresses `dst` and `bar`), completing on that block's barrier
__device__ __forceinline__ void bulk_copy_cluster(uint32_t dst, const void* src, int bytes,
                                                  uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(dst),
      "r"(smem_u32(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// ---- the GEMM

// the wrapper's launch plan (ops/int8_conv.py::plan), in its order
struct ConvPlan {
  int n, h, w, c, o, kh, kw, stride, pad, dil, ho, wo, tiles_m, tiles_n, split, k_steps, wb;
};

// four outputs, rounded to nearest even, in one store
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b, float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
  uint2 v;
  v.x = *reinterpret_cast<uint32_t*>(&lo);
  v.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = v;
}
__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// the output pixel (flat index into N * Ho * Wo) of row r of an M tile, or
// -1 past the output: a spatial block of hb x wb pixels of one image when
// the activations come by TMA (p.wb > 0), else 128 consecutive pixels
struct TileRows {
  int img, oy0, ox0, m0;
  __device__ TileRows(const ConvPlan& p, int tile) {
    if (p.wb > 0) {
      const int tw = (p.wo + p.wb - 1) / p.wb, hb = kBM / p.wb;
      const int th = (p.ho + hb - 1) / hb;
      img = tile / (th * tw);
      const int rem = tile - img * th * tw;
      oy0 = (rem / tw) * hb;
      ox0 = (rem % tw) * p.wb;
      m0 = 0;
    } else {
      img = oy0 = ox0 = 0;
      m0 = tile * kBM;
    }
  }
  __device__ int pixel(const ConvPlan& p, int r) const {
    if (p.wb > 0) {
      const int oy = oy0 + r / p.wb, ox = ox0 + r % p.wb;
      return oy < p.ho && ox < p.wo ? (img * p.ho + oy) * p.wo + ox : -1;
    }
    const int m = m0 + r;
    return m < p.n * p.ho * p.wo ? m : -1;
  }
};

// grid (split * tiles_m, tiles_n); a cluster of `split` blocks along x when split > 1
template <typename TOut>
__global__ void __launch_bounds__(kGemmThreads, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap wmap,
                const __grid_constant__ CUtensorMap xmap, const int8_t* __restrict__ xq,
                const float* __restrict__ w_scale, const float* amax,
                TOut* __restrict__ out, const ConvPlan p) {
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte alignment for the 128-byte swizzle (the same offset in every block)
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  int* recv = reinterpret_cast<int*>(smem + kRing);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kRing + kRecvBytes);
  uint64_t* empty = full + kStages;
  uint64_t* rbar = empty + kStages;  // the split's rows from the other blocks
  float* wsc = reinterpret_cast<float*>(rbar + 1);  // w_scale of the tile's columns
  int* pix = reinterpret_cast<int*>(wsc + kBN);     // the output pixel of each row, or -1

  const int tid = threadIdx.x, wg = tid >> 7;
  const int split = p.split, rank = blockIdx.x % split;
  const TileRows rows(p, blockIdx.x / split);
  const int n0 = blockIdx.y * kBN;
  const bool tma_a = p.wb > 0;
  // this block's K steps; every step lies in exactly one rank's range
  const int ks0 = (int)((long long)rank * p.k_steps / split);
  const int nk = (int)((long long)(rank + 1) * p.k_steps / split) - ks0;
  const int per_tap = (p.c + kBK - 1) / kBK;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      // TMA: one arrival that expects both boxes; cp.async: the 128 copiers' and B's
      mbar_init(&full[s], tma_a ? 1 : kProducerThreads + 1);
      mbar_init(&empty[s], kConsumers * 4);  // one arrival a consumer warp
    }
    mbar_init(rbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // the epilogue reads the scales and pixels from shared memory
  if (tid < kBN) wsc[tid] = n0 + tid < p.o ? w_scale[n0 + tid] : 0.f;
  if (tid < kBM) pix[tid] = rows.pixel(p, tid);
  __syncthreads();
  if (split > 1) {
    // the bytes the other blocks send this one; the barriers are published
    // to the cluster (waited on before the first copy)
    if (tid == 0)
      mbar_arrive_expect(rbar, (split - 1) * ((rank + 1) * kBM / split - rank * kBM / split) *
                                   kAccPitch * 4);
    cluster_arrive();
  }

  int acc[64];
  float a_s;  // act_scale of the max, once this thread has passed griddep_wait
  if (wg == kConsumers) {
    // ---- producer
    const int pt = tid - 128 * kConsumers;
    // K step ks: tap (ky, kx), channels from cc * kBK
    auto step = [&](int i, int& ky, int& kx, int& cc) {
      const int ks = ks0 + i, tap = ks / per_tap;
      cc = ks - tap * per_tap;
      ky = tap / p.kw;
      kx = tap - ky * p.kw;
    };
    auto load_b = [&](int i) {
      int ky, kx, cc;
      step(i, ky, kx, cc);
      tma_load_2d(smem + (i % kStages) * kStageBytes + kTileBytes, &wmap,
                  (ky * p.kw + kx) * p.c + cc * kBK, n0, &full[i % kStages]);
    };
    // the im2col rows of step i: one box of the tap's input pixels (TMA
    // path; out of bounds is zero, the padding)
    auto load_a = [&](int i) {
      int ky, kx, cc;
      step(i, ky, kx, cc);
      tma_load_4d(smem + (i % kStages) * kStageBytes, &xmap, cc * kBK,
                  rows.ox0 * p.stride - p.pad + kx * p.dil,
                  rows.oy0 * p.stride - p.pad + ky * p.dil, rows.img, &full[i % kStages]);
    };
    const int stage_bytes = tma_a ? kStageBytes : kTileBytes;  // what pt 0's arrival expects
    if (pt == 0) {
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&wmap))
                   : "memory");
      if (tma_a)
        asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&xmap))
                     : "memory");
      // the weights depend on nothing: the first stages' loads overlap the quantize pass
      for (int i = 0; i < kStages && i < nk; ++i) {
        mbar_arrive_expect(&full[i], stage_bytes);
        load_b(i);
      }
    }
    griddep_wait();  // xq is written
    if (tma_a) {
      // one thread issues both boxes of every stage
      if (pt == 0) {
        for (int i = 0; i < nk; ++i) {
          if (i >= kStages) {
            mbar_wait(&empty[i % kStages], ((i / kStages) + 1) & 1);
            mbar_arrive_expect(&full[i % kStages], stage_bytes);
            load_b(i);
          }
          load_a(i);
        }
      }
    } else {
      // cp.async: thread pt copies 16-byte chunk j of rows r0 + 16 i
      const int j = pt & 7, r0 = pt >> 3;
      const uint32_t a_off = r0 * 128 + ((j ^ (r0 & 7)) << 4);  // rows r0 + 16 i: same swizzle
      int base[8], hi0[8], wi0[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int m = rows.pixel(p, r0 + 16 * i);
        base[i] = 0;
        hi0[i] = wi0[i] = -(1 << 30);  // past the output: every tap out of bounds
        if (m >= 0) {
          const int img = m / (p.ho * p.wo), r = m - img * p.ho * p.wo;
          const int oy = r / p.wo, ox = r - oy * p.wo;
          base[i] = img * p.h * p.w * p.c;
          hi0[i] = oy * p.stride - p.pad;
          wi0[i] = ox * p.stride - p.pad;
        }
      }
      for (int i = 0; i < nk; ++i) {
        const int st = i % kStages;
        if (i >= kStages) {
          mbar_wait(&empty[st], ((i / kStages) + 1) & 1);
          if (pt == 0) {
            mbar_arrive_expect(&full[st], stage_bytes);
            load_b(i);
          }
        }
        int ky, kx, cc;
        step(i, ky, kx, cc);
        const int c_off = cc * kBK + j * 16;
        const bool c_ok = c_off < p.c;
        const int dy = ky * p.dil, dx = kx * p.dil;
        const uint32_t dst = smem_u32(smem + st * kStageBytes) + a_off;
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int hi = hi0[r] + dy, wi = wi0[r] + dx;
          const bool ok = c_ok && (unsigned)hi < (unsigned)p.h && (unsigned)wi < (unsigned)p.w;
          const int8_t* src = ok ? xq + base[r] + (hi * p.w + wi) * p.c + c_off : xq;
          cp_async16(dst + r * 16 * 128, src, ok);
        }
        cp_async_arrive(&full[st]);
      }
    }
    a_s = act_scale(*amax);
  } else {
    // ---- consumers: warpgroup wg computes rows wg * 64 .. wg * 64 + 63
    griddep_wait();  // amax is written
    a_s = act_scale(*amax);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0;
    const int lane = tid & 31;
    for (int i = 0; i < nk; ++i) {
      const int st = i % kStages;
      mbar_wait(&full[st], (i / kStages) & 1);
      if (!tma_a) fence_async_smem();  // the cp.async rows of A, for wgmma
      const uint8_t* a = smem + st * kStageBytes + wg * 64 * 128;
      const uint8_t* b = smem + st * kStageBytes + kTileBytes;
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kBK / 32; ++k)
        wgmma_m64n128k32_s8(acc, sw128_desc(a + k * 32), sw128_desc(b + k * 32));
      wgmma_commit();
      if (i > 0) {  // the previous stage's products are done: free it
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(&empty[(i - 1) % kStages]);
      }
    }
    wgmma_wait<0>();
    fence_operands(acc);
  }

  // ---- epilogue.  Each block's s32 tile goes into shared memory (over the
  // ring: every stage has been consumed once all threads are here), rows in
  // order.  With a split, rank r owns rows [r * kBM / split, (r + 1) * kBM /
  // split): every other block sends it those rows of its tile by one bulk
  // copy into a receive slot of its own (the TMA engine moves them through
  // distributed shared memory, completing on the owner's barrier `rbar`),
  // and the owner sums its rows over the split.  Integer sums are exact in
  // any order, so the split changes no bit.  Then the owner scales its rows
  // and writes them, a thread 4 fixed columns, a warp a row of 128.
  // Accumulator element (row, col) of a consumer thread: acc[4 j + 2 i + e]
  // with row = wg * 64 + 16 * warp + lane / 4 + 8 i, col = 8 j + 2 (lane % 4) + e
  int* tile = reinterpret_cast<int*>(smem);
  __syncthreads();
  if (wg < kConsumers) {
    const int lane = tid & 31;
    const int row0 = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
    const int col0 = 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
        *reinterpret_cast<int2*>(tile + (row0 + 8 * i) * kAccPitch + 8 * j + col0) =
            make_int2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
    fence_async_smem();  // the tile, for the bulk copies
  }
  __syncthreads();
  const int lo = rank * kBM / split, hi = (rank + 1) * kBM / split;
  const int rows_max = (kBM + split - 1) / split;
  if (split > 1) {
    cluster_wait();  // every block's rbar is set up
    if (tid == 0) {
      for (int o = 0; o < split; ++o) {
        if (o == rank) continue;
        const int olo = o * kBM / split, ohi = (o + 1) * kBM / split;
        const int slot = rank < o ? rank : rank - 1;
        bulk_copy_cluster(mapa(recv + slot * rows_max * kAccPitch, o),
                          tile + olo * kAccPitch, (ohi - olo) * kAccPitch * 4, mapa(rbar, o));
      }
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
    mbar_wait(rbar, 0);  // every other block's rows of this block have landed
  }
  const int c = 4 * (tid % (kBN / 4));
  const bool c_ok = n0 + c < p.o;  // O % 8 == 0: four columns are in or out together
  float sc[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) sc[e] = __fmul_rn(a_s, wsc[c + e]);
#pragma unroll 2
  for (int r = lo + tid / (kBN / 4); r < hi; r += kGemmThreads / (kBN / 4)) {
    const int m = pix[r];
    if (m < 0 || !c_ok) continue;
    int4 sum = *reinterpret_cast<const int4*>(tile + r * kAccPitch + c);
    for (int s = 0; s + 1 < split; ++s) {
      const int4 v =
          *reinterpret_cast<const int4*>(recv + (s * rows_max + r - lo) * kAccPitch + c);
      sum.x += v.x; sum.y += v.y; sum.z += v.z; sum.w += v.w;
    }
    store4(out + (long long)m * p.o + n0 + c, __fmul_rn(__int2float_rn(sum.x), sc[0]),
           __fmul_rn(__int2float_rn(sum.y), sc[1]), __fmul_rn(__int2float_rn(sum.z), sc[2]),
           __fmul_rn(__int2float_rn(sum.w), sc[3]));
  }
  // this block's tile stays until the copies out of it have read it
  if (split > 1 && tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// ---- host side

int reduce_blocks(long long nvec) {
  long long b = (nvec + kThreads - 1) / kThreads;
  return (int)(b < kReduceBlocks ? (b > 0 ? b : 1) : kReduceBlocks);
}

cudaLaunchAttribute pdl_attr() {
  cudaLaunchAttribute a;
  a.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  a.val.programmaticStreamSerializationAllowed = 1;
  return a;
}

// once a device: the GEMM's shared-memory opt-in, and the prologue's
// preference for the largest shared-memory carveout, so that the GEMM's
// blocks fit beside the quantize pass's (programmatic dependent launch)
// without the SM first draining to reconfigure
template <typename T>
int configure() {
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (ready[dev]) return 0;
  err = cudaFuncSetAttribute(gemm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(absmax_kernel<T>, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(quantize_kernel<T>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  ready[dev] = true;
  return 0;
}

template <typename T>
int quantize(const T* x, long long numel, float* amax, float* partial, int8_t* xq,
             cudaStream_t stream) {
  int e = configure<T>();
  if (e != 0) return e;
  const long long nvec = numel / Vec<T>::n;
  const int blocks = reduce_blocks(nvec);
  absmax_kernel<T><<<blocks, kThreads, 0, stream>>>(x, nvec, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr = pdl_attr();
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, quantize_kernel<T>, x, nvec, (const float*)partial, blocks,
                           amax, xq);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

template <typename TOut>
int gemm(const CUtensorMap& wmap, const CUtensorMap& xmap, const int8_t* xq,
         const float* w_scale, const float* amax, void* out, const ConvPlan& p,
         cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.split * p.tiles_m, p.tiles_n);
  cfg.blockDim = dim3(kGemmThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attrs[2] = {pdl_attr(), {}};
  attrs[1].id = cudaLaunchAttributeClusterDimension;
  attrs[1].val.clusterDim.x = p.split;
  attrs[1].val.clusterDim.y = 1;
  attrs[1].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = p.split > 1 ? 2 : 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, gemm_kernel<TOut>, wmap, xmap, xq, w_scale, amax,
                                       static_cast<TOut*>(out), p);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* sym = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &sym, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &sym, cudaEnableDefault, &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(sym);
  }
  return fn;
}

// an s8 tensor map in the 128-byte swizzle, out of bounds zero, into `out`
// (128 bytes)
int encode(void* out, int rank, const void* base, const cuuint64_t* dims,
           const cuuint64_t* strides, const cuuint32_t* box, const cuuint32_t* elem) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap m;
  CUresult r = fn(&m, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank, const_cast<void*>(base), dims,
                  strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  memcpy(out, &m, sizeof(m));
  return 0;
}

}  // namespace

extern "C" {

// dtype codes: 0 bf16, 1 f32.  Scratch of a call (ops/int8_conv.py::launch):
// xq (numel s8), then the max (one f32) and 1056 partial maxima (f32).

// absmax + quantize: xq (numel s8, NHWC) and max|x| in *amax
int int8_quantize_launch(int dtype, const void* x, long long numel, float* amax,
                         float* partial, int8_t* xq, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return quantize(static_cast<const __nv_bfloat16*>(x), numel, amax, partial, xq, st);
  if (dtype == 1) return quantize(static_cast<const float*>(x), numel, amax, partial, xq, st);
  return (int)cudaErrorInvalidValue;
}

// the 2-D tensor map of wq as [O, K] s8 (K = KH * KW * C), 128 x 128-byte
// boxes in the 128-byte swizzle, out of bounds zero: 128 bytes into `map`
int int8_weight_map(const int8_t* wq, int o, long long k, void* map) {
  if (k % 16 || reinterpret_cast<uintptr_t>(wq) % 16) return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)o};
  const cuuint64_t strides[1] = {(cuuint64_t)k};
  const cuuint32_t box[2] = {kBK, kBN};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, 2, wq, dims, strides, box, elem);
}

// the most clusters of `split` GEMM blocks the current device holds at once
// (GPCs of unequal size hold fewer than SMs / split), or a negative error
int int8_max_clusters(int split) {
  int e = configure<__nv_bfloat16>();
  if (e != 0) return -e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split);
  cfg.blockDim = dim3(kGemmThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = split;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int n = 0;
  cudaError_t err = cudaOccupancyMaxActiveClusters(&n, gemm_kernel<__nv_bfloat16>, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

// the whole function: quantize x, then the implicit GEMM into out (x's
// type); `map` from int8_weight_map, `plan` the 17 ints of ConvPlan.  With
// plan.wb > 0 the activations come by TMA: a 4-D map of xq (N, H, W, C),
// boxes of 128 channel bytes x wb x (128 / wb) output pixels' inputs,
// traversed at the convolution's stride
int int8_conv_launch(int dtype, const void* x, int8_t* scratch, const void* map,
                     const float* w_scale, void* out, const int* plan, void* stream) {
  ConvPlan p;
  memcpy(&p, plan, sizeof(p));
  if (p.c % 32 || p.o % 8 || p.split < 1 || p.split > kMaxSplit ||
      (p.wb > 0 && (kBM % p.wb || p.stride > 8 || p.wb * p.stride > 256 ||
                    kBM / p.wb * p.stride > 256)))
    return (int)cudaErrorInvalidValue;
  const long long numel = (long long)p.n * p.h * p.w * p.c;
  float* amax = reinterpret_cast<float*>(scratch + numel);
  CUtensorMap wmap, xmap;
  memcpy(&wmap, map, sizeof(wmap));
  memset(&xmap, 0, sizeof(xmap));
  if (p.wb > 0) {
    const cuuint64_t dims[4] = {(cuuint64_t)p.c, (cuuint64_t)p.w, (cuuint64_t)p.h,
                                (cuuint64_t)p.n};
    const cuuint64_t strides[3] = {(cuuint64_t)p.c, (cuuint64_t)p.w * p.c,
                                   (cuuint64_t)p.h * p.w * p.c};
    const cuuint32_t box[4] = {kBK, (cuuint32_t)(p.wb * p.stride),
                               (cuuint32_t)(kBM / p.wb * p.stride), 1};
    const cuuint32_t elem[4] = {1, (cuuint32_t)p.stride, (cuuint32_t)p.stride, 1};
    int e = encode(&xmap, 4, scratch, dims, strides, box, elem);
    if (e != 0) return e;
  }
  int err = int8_quantize_launch(dtype, x, numel, amax, amax + 1, scratch, stream);
  if (err != 0) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? gemm<__nv_bfloat16>(wmap, xmap, scratch, w_scale, amax, out, p, st)
                    : gemm<float>(wmap, xmap, scratch, w_scale, amax, out, p, st);
}

}  // extern "C"
