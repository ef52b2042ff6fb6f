// One PointRend eval subdivision step for a single-logit model, bf16.
//
// Replaces the Pallas TPU kernel empanada_tpu/ops/pallas_pointrend.py
// (_refine_kernel, launched by fused_refine_step).  It computes the same
// values, not the same layout: no phase-major permutation, no 128-channel
// coarse block, no lane-replicated predictor.
//
// Inputs (all on the card, contiguous):
//   up     (N, H2, W2)    bf16 logits already upsampled 2x (by the wrapper)
//   thr    (N,)           f32  refine where |up| <= thr (exact K-th value)
//   feat   (N, Hc, Wc, F) bf16 decoder features, NHWC
//   coarse (N, Hc, Wc)    bf16 coarse logit plane
//   wts    bf16, the layout of pointrend_refine.py::pack_weights: per hidden
//          layer l, W_l^T (256 x K_l, D padded to 256 with zeros) in K-slices
//          of 64, each slice 256 rows of 128 bytes in the 128-byte swizzle
//          that wgmma reads; then w_coarse (L x 256), bias (L x 256),
//          w_pred (256), w_pred_coarse, b_pred
// Output: out (N, H2, W2) bf16.
//
// The step is two launches on one stream:
//
// 1. select_kernel, one light pass over `up`: each thread tests 8 pixels
//    (one 16-byte vector) against thr[b] (|bf16| <= f32 threshold), copies
//    all 8 to `out`, and appends the flat indices b*H2*W2 + r*W2 + c of the
//    selected ones to a global int32 list, with one atomicAdd per warp on a
//    device counter (__ballot_sync / __popc give each pixel its place).
//    Nothing returns to the host.
// 2. refine_kernel, a persistent pass over that list: a grid of as many
//    blocks as fit on the card's SMs loops over chunks of 64 points,
//    reading the count from device memory.  A chunk may mix images.  A
//    block's two consumer warpgroups share a chunk; per chunk they
//      - decode their points and sample the coarse plane;
//      - gather the four feature taps of each point (16-byte loads) and
//        interpolate them (rows first, rounded to bf16, then columns,
//        rounded to bf16; lerps in __fmul_rn / __fadd_rn) into a bf16
//        activation buffer in shared memory, in the swizzled layout wgmma
//        reads as A;
//      - run each hidden layer as wgmma.mma_async m64n128k16 products, each
//        warpgroup on its half of the 256 output columns (A: the
//        activations, B: a 16 KB weight piece in shared memory, f32
//        accumulators in registers), then the epilogue
//          h = relu(bf16(bf16(acc + c * w_coarse) + bias))
//        from registers back into the activation buffer;
//      - after the last layer, the predictor from registers (the two
//        halves' partial sums meet in shared memory)
//          y = bf16(bf16(h . w_pred + c * w_pred_coarse) + b_pred)
//        and write y at the point's pixel.
//    One producer warp per block streams the weight pieces (half a K-slice:
//    128 output columns x 64 rows) through a ring of shared-memory stages
//    with TMA bulk copies (cp.async.bulk + mbarrier), several pieces in
//    flight while the products on earlier ones run; the warpgroup of a
//    piece's half releases its stage once its wgmma on it has completed.
//
// What bounds it on an H100: the select pass moves bytes (read up, write
// out: 4 bytes a pixel); the refine pass's work is the point MLP, ~395 kFLOP
// a point at MitoNet_v1 widths (F = D = 256), which only the tensor cores'
// wgmma path runs near its bound.  A step of one 512 x 512 request selects
// ~8,500 points, often clustered in a few places of the image: spreading
// points (not output tiles) over all SMs in 64-point chunks keeps every SM
// busy on about one chunk, where a tile-per-block schedule waits on its
// busiest tile.  The weights (~0.4 MB) are read from L2 once per chunk and
// block through the TMA ring.
//
// A point's result depends on no other point of its chunk (rows of a
// matrix product are independent), so the output does not depend on the
// order in which the atomics fill the list: two launches are bit-identical.
//
// The refine pass is a template over a phase so that the step can be timed
// in parts (the counterpart of the TPU profiling cuts in
// benchmarks/profile_refine_parts.py): kFull runs the whole step (the main
// path's kernel); kGather stops after the feature-tap loads and kInterp
// after the interpolation.  A cut still does all of its loads (an empty asm
// keeps the three unused taps of the gather cut), and writes per selected
// pixel the f32 channel sum of the top-left tap (gather) or of the sampled
// feature (interp), rounded to bf16.  The cuts run over the same list and
// the same persistent grid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "refine_layout.cuh"

namespace {

constexpr int kSelVec = 8;        // pixels per thread of the select pass
constexpr int kSelThreads = 256;  // block of the select pass

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float bf(const __nv_bfloat16 v) {
  return __bfloat162float(v);
}

// two consecutive bf16 values (4-byte aligned) as floats
__device__ __forceinline__ float2 bf2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// a * (1 - w) + b * w with each product and the sum rounded on its own (no
// FMA contraction), as the plain version's separate tensor ops round
__device__ __forceinline__ float lerp(float a, float b, float w) {
  return __fadd_rn(__fmul_rn(a, 1.f - w), __fmul_rn(b, w));
}

// bilinear weights of output index r at scale factor sf (exact in f32 for
// power-of-two sf): first tap i0, weight w on tap i0 + 1
__device__ __forceinline__ void axis_tap(int r, float inv_sf, int* i0, float* w) {
  float src = (static_cast<float>(r) + 0.5f) * inv_sf - 0.5f;
  float f = floorf(src);
  *i0 = static_cast<int>(f);
  *w = src - f;
}

// Keeps a loaded value alive without using it: the gather cut reads all
// four taps, like the whole step, but reports the top-left one only.
__device__ __forceinline__ void keep(const uint4 v) {
  asm volatile("" : : "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w));
}

// ---- shared memory, barriers, TMA and wgmma (PTX)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
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
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

// one weight piece (kPieceBytes, contiguous and already swizzled) by a TMA
// bulk copy that completes the transaction count of `bar`
__device__ __forceinline__ void load_piece(void* dst, const void* src, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(kPieceBytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(kPieceBytes), "r"(smem_addr(bar))
      : "memory");
}

// makes this thread's shared-memory stores visible to wgmma (async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// byte offset of the 16-byte group g (channels 8g..8g+7) of row `row` in
// an activation buffer: K-blocks of 64 channels (8 KB each), rows of 128
// bytes, 16-byte groups XOR-swizzled by row % 8 (wgmma's 128-byte swizzle)
__device__ __forceinline__ uint32_t act_offset(int row, int g) {
  return (g >> 3) * kActBlockBytes + row * 128 + (((g & 7) ^ (row & 7)) << 4);
}

// wgmma shared-memory descriptor of a K-major, 128-byte-swizzled operand
// whose 8-row groups lie 1024 bytes apart
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t a = smem_addr(p);
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
__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, f32) = A (64 x 16) . B (16 x 128) + (scale_d ? d : 0), both
// operands bf16 in shared memory, K-major
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a,
                                                 uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// ---- pass 1: select and compact

__global__ void __launch_bounds__(kSelThreads)
select_kernel(const __nv_bfloat16* __restrict__ up, const float* __restrict__ thr,
              __nv_bfloat16* __restrict__ out, int* __restrict__ list, int* __restrict__ count,
              int total, int hw, bool vec) {
  const int base = (blockIdx.x * kSelThreads + threadIdx.x) * kSelVec;
  const bool whole = vec && base + kSelVec <= total;
  __align__(16) __nv_bfloat16 v[kSelVec];
  if (whole) {
    *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(up + base);
  } else {
#pragma unroll
    for (int k = 0; k < kSelVec; ++k) {
      if (base + k < total) v[k] = up[base + k];
    }
  }
  unsigned sel = 0;
  int b = base / hw, edge = (b + 1) * hw;
#pragma unroll
  for (int k = 0; k < kSelVec; ++k) {
    if (base + k < total) {
      if (base + k == edge) {
        ++b;
        edge += hw;
      }
      if (fabsf(bf(v[k])) <= thr[b]) sel |= 1u << k;
    }
  }
  // every pixel is written through; the refine pass overwrites the selected
  if (whole) {
    *reinterpret_cast<uint4*>(out + base) = *reinterpret_cast<const uint4*>(v);
  } else {
#pragma unroll
    for (int k = 0; k < kSelVec; ++k) {
      if (base + k < total) out[base + k] = v[k];
    }
  }
  // the warp's selected pixels, k-major, take consecutive places of the list
  const unsigned lane = threadIdx.x % 32;
  const unsigned below = (1u << lane) - 1u;
  int pos[kSelVec];
  int n_warp = 0;
#pragma unroll
  for (int k = 0; k < kSelVec; ++k) {
    const unsigned ballot = __ballot_sync(0xffffffffu, (sel >> k) & 1u);
    pos[k] = n_warp + __popc(ballot & below);
    n_warp += __popc(ballot);
  }
  int first = 0;
  if (lane == 0 && n_warp > 0) first = atomicAdd(count, n_warp);
  first = __shfl_sync(0xffffffffu, first, 0);
#pragma unroll
  for (int k = 0; k < kSelVec; ++k) {
    if ((sel >> k) & 1u) list[first + pos[k]] = base + k;
  }
}

// ---- pass 2: refine the listed points

// bilinear interpolation of 8 channels from their four taps
__device__ __forceinline__ uint4 interp8(const uint4 (&tap)[4], float wy, float wx) {
  uint4 res;
  const auto* t00 = reinterpret_cast<const __nv_bfloat162*>(&tap[0]);
  const auto* t01 = reinterpret_cast<const __nv_bfloat162*>(&tap[1]);
  const auto* t10 = reinterpret_cast<const __nv_bfloat162*>(&tap[2]);
  const auto* t11 = reinterpret_cast<const __nv_bfloat162*>(&tap[3]);
  auto* o = reinterpret_cast<__nv_bfloat162*>(&res);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 v00 = __bfloat1622float2(t00[q]), v01 = __bfloat1622float2(t01[q]);
    const float2 v10 = __bfloat1622float2(t10[q]), v11 = __bfloat1622float2(t11[q]);
    // rows first (columns x0 and x1), rounded to bf16; then columns
    const float a0 = bf16r(lerp(v00.x, v10.x, wy)), a1 = bf16r(lerp(v01.x, v11.x, wy));
    const float b0 = bf16r(lerp(v00.y, v10.y, wy)), b1 = bf16r(lerp(v01.y, v11.y, wy));
    o[q] = __floats2bfloat162_rn(lerp(a0, a1, wx), lerp(b0, b1, wx));
  }
  return res;
}

// point record fields (kPointWords ints per point, structure of arrays);
// kPart holds the predictor's partial sum over the upper 128 columns
enum { kP = 0, kB, kY0, kX0, kWy, kWx, kCv, kPart };

// barrier of the two consumer warpgroups (id 1; 0 is __syncthreads), which
// the producer warp does not join
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

template <int kPhase>
__global__ void __launch_bounds__(kConsumers + 32, 2)
refine_kernel(const int* __restrict__ list, const int* __restrict__ count,
              const __nv_bfloat16* __restrict__ feat, const __nv_bfloat16* __restrict__ coarse,
              const __nv_bfloat16* __restrict__ wts, __nv_bfloat16* __restrict__ out, int h2,
              int w2, int hc, int wc, int F, int num_fc, float inv_sf) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  const RefineSmem lay = refine_smem(F);
  unsigned char* ring = smem + lay.ring;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bars);
  uint64_t* empty = full + kStages;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // the consumer warps of one column half
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int n_pts = *count;
  const int n_chunks = (n_pts + kRows - 1) / kRows;

  if (warp == kConsumers / 32) {
    // producer: one lane streams every chunk's weight pieces in the packed
    // buffer's order (layer by layer, K-slice by K-slice, the two column
    // halves of a slice in turn), which is the order the consumers take them
    if (kPhase != kFull || lane != 0) return;
    const int n_pieces = 2 * (F + (num_fc - 1) * kN) / kSliceK;
    int it = 0;
    for (int chunk = blockIdx.x; chunk < n_chunks; chunk += gridDim.x) {
      const unsigned char* src = reinterpret_cast<const unsigned char*>(wts);
      for (int q = 0; q < n_pieces; ++q, ++it, src += kPieceBytes) {
        const int stage = it % kStages;
        mbar_wait(&empty[stage], ((it / kStages) & 1) ^ 1);
        load_piece(ring + stage * kPieceBytes, src, &full[stage]);
      }
    }
    return;
  }

  // consumers: the two warpgroups split the 256 output columns (half 0:
  // 0-127, half 1: 128-255) and share everything else.  The "% 2" and
  // "% kConsumers" change no value here; the ranges they state keep the
  // chunk loop within 96 registers with few spills (ptxas: 20 bytes of
  // spill stores; 148 without them, and a slower chunk).
  const int half = (warp / 4) % 2, wq = warp % 4;
  const int t = threadIdx.x % kConsumers;  // consumer thread
  unsigned char* act = smem + lay.act;
  int* rec = reinterpret_cast<int*>(smem + lay.pts);
  float* recf = reinterpret_cast<float*>(rec);
  const int hw2 = h2 * w2;
  const int G = F / 8;  // 16-byte groups of a feature row
  const __nv_bfloat16* vecs =
      wts + static_cast<size_t>(F) * kN + static_cast<size_t>(num_fc - 1) * kN * kN;
  const __nv_bfloat16* wpred = vecs + 2 * num_fc * kN;
  const float wpred_c = bf(wpred[kN]);
  const float bpred = bf(wpred[kN + 1]);
  int q = 0;  // K-slices taken so far: this half's pieces are 2 q + half

  for (int chunk = blockIdx.x; chunk < n_chunks; chunk += gridDim.x) {
    const int base = chunk * kRows;
    const int m = min(kRows, n_pts - base);  // rows past m are zero padding

    // ---- the points: pixel, taps, weights, coarse sample
    if (t < kRows) {
      int p = -1, b = 0, y0 = 0, x0 = 0;
      float wy = 0.f, wx = 0.f, cv = 0.f;
      if (t < m) {
        p = list[base + t];
        b = p / hw2;
        const int rem = p - b * hw2;
        const int r = rem / w2;
        axis_tap(r, inv_sf, &y0, &wy);
        axis_tap(rem - r * w2, inv_sf, &x0, &wx);
        if (kPhase != kGather) {
          const __nv_bfloat16* cb = coarse + static_cast<size_t>(b) * hc * wc;
          float v[2][2];
#pragma unroll
          for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
            for (int dx = 0; dx < 2; ++dx) {
              const int y = y0 + dy, x = x0 + dx;
              v[dy][dx] = (y >= 0 && y < hc && x >= 0 && x < wc)
                              ? bf(cb[static_cast<size_t>(y) * wc + x]) : 0.f;
            }
          }
          const float a0 = bf16r(lerp(v[0][0], v[1][0], wy));
          const float a1 = bf16r(lerp(v[0][1], v[1][1], wy));
          cv = bf16r(lerp(a0, a1, wx));
        }
      }
      rec[kP * kRows + t] = p;
      rec[kB * kRows + t] = b;
      rec[kY0 * kRows + t] = y0;
      rec[kX0 * kRows + t] = x0;
      recf[kWy * kRows + t] = wy;
      recf[kWx * kRows + t] = wx;
      recf[kCv * kRows + t] = cv;
    }
    consumer_sync();

    // ---- gather the taps (16 bytes a load, 2 items a thread in flight)
    // and interpolate into the activation buffer
    constexpr int kBatch = 2;
    for (int e0 = t; e0 < kRows * G; e0 += kBatch * kConsumers) {
      uint4 tap[kBatch][4];
      float wy[kBatch], wx[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int e = e0 + k * kConsumers, i = e / G, g = e % G;
        const bool live = i < m;
        const int b = rec[kB * kRows + i], y0 = rec[kY0 * kRows + i], x0 = rec[kX0 * kRows + i];
        wy[k] = recf[kWy * kRows + i];
        wx[k] = recf[kWx * kRows + i];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int y = y0 + c / 2, x = x0 + c % 2;
          tap[k][c] = make_uint4(0u, 0u, 0u, 0u);
          if (live && y >= 0 && y < hc && x >= 0 && x < wc) {
            tap[k][c] = reinterpret_cast<const uint4*>(
                feat + ((static_cast<size_t>(b) * hc + y) * wc + x) * F)[g];
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int e = e0 + k * kConsumers, i = e / G, g = e % G;
        uint4 res;
        if constexpr (kPhase == kGather) {
          keep(tap[k][1]);
          keep(tap[k][2]);
          keep(tap[k][3]);
          res = tap[k][0];
        } else {
          // tap order: (y0, x0), (y0, x1), (y1, x0), (y1, x1)
          res = interp8(tap[k], wy[k], wx[k]);
        }
        *reinterpret_cast<uint4*>(act + act_offset(i, g)) = res;
      }
    }
    fence_async_smem();
    consumer_sync();

    if constexpr (kPhase != kFull) {
      // ---- cut phases: the channel sum of each point, 4 threads a point
      const int row = t / 4, part = t % 4;
      float s = 0.f;
      for (int g = part * (G / 4); g < (part + 1) * (G / 4); ++g) {
        const uint4 raw = *reinterpret_cast<const uint4*>(act + act_offset(row, g));
        const auto* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float2 f = __bfloat1622float2(h[c]);
          s += f.x + f.y;
        }
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (part == 0 && row < m) out[rec[kP * kRows + row]] = __float2bfloat16(s);
    } else {
      // ---- hidden layers on the tensor cores: this warpgroup's 128 output
      // columns, col0 .. col0 + 127; the predictor from registers
      const int col0 = half * (kN / 2);
      float d[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) d[i] = 0.f;
      const int r0 = wq * 16 + lane / 4;  // this thread's rows: r0 and r0 + 8
      const float cv0 = recf[kCv * kRows + r0], cv1 = recf[kCv * kRows + r0 + 8];
      float pred0 = 0.f, pred1 = 0.f;
      for (int l = 0; l < num_fc; ++l) {
        const int nk = (l == 0 ? F : kN) / kSliceK;
        for (int s = 0; s < nk; ++s, ++q) {
          const int piece = 2 * q + half, stage = piece % kStages;
          mbar_wait(&full[stage], (piece / kStages) & 1);
          const unsigned char* a = act + s * kActBlockBytes;
          const unsigned char* w = ring + stage * kPieceBytes;
          wgmma_fence();
#pragma unroll
          for (int j = 0; j < kSliceK / 16; ++j) {
            wgmma_m64n128k16(d, sw128_desc(a + j * 32), sw128_desc(w + j * 32), (s | j) != 0);
          }
          wgmma_commit();
          if (s > 0) {  // the previous piece's products are done: free its stage
            wgmma_wait<1>();
            if (lane == 0) mbar_arrive(&empty[(piece - 2) % kStages]);
          }
        }
        wgmma_wait<0>();
        if (lane == 0) mbar_arrive(&empty[(2 * (q - 1) + half) % kStages]);
        fence_operands(d);
        const bool last = l == num_fc - 1;
        if (!last) consumer_sync();  // both halves are done reading this layer's input

        // epilogue: accumulator element (row, col0 + col) of this thread is
        // d[4 j + 2 i + e] with row = r0 + 8 i, col = 8 j + 2 (lane % 4) + e
        const __nv_bfloat16* wcl = vecs + l * kN + col0;
        const __nv_bfloat16* bl = vecs + (num_fc + l) * kN + col0;
#pragma unroll
        for (int j = 0; j < kN / 16; ++j) {
          const int col = j * 8 + (lane % 4) * 2;
          const float2 wcv = bf2(wcl + col);
          const float2 bv = bf2(bl + col);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float cv = i ? cv1 : cv0;
            const float d0 = d[4 * j + 2 * i] + cv * wcv.x;
            const float d1 = d[4 * j + 2 * i + 1] + cv * wcv.y;
            const float h0 = fmaxf(bf16r(bf16r(d0) + bv.x), 0.f);
            const float h1 = fmaxf(bf16r(bf16r(d1) + bv.y), 0.f);
            if (last) {
              const float2 wp = bf2(wpred + col0 + col);
              float& acc = i ? pred1 : pred0;
              acc += h0 * wp.x;
              acc += h1 * wp.y;
            } else {
              const int cc = col0 + col;
              *reinterpret_cast<__nv_bfloat162*>(act + act_offset(r0 + 8 * i, cc / 8) +
                                                 (cc % 8) * 2) = __floats2bfloat162_rn(h0, h1);
            }
          }
        }
        if (!last) {
          fence_async_smem();
          consumer_sync();
        }
      }
      // the four lanes of a row hold its partial dot products; the upper
      // half's sums go through shared memory to the lower half
#pragma unroll
      for (int sh = 1; sh <= 2; sh *= 2) {
        pred0 += __shfl_xor_sync(0xffffffffu, pred0, sh);
        pred1 += __shfl_xor_sync(0xffffffffu, pred1, sh);
      }
      if (half == 1 && lane % 4 == 0) {
        recf[kPart * kRows + r0] = pred0;
        recf[kPart * kRows + r0 + 8] = pred1;
      }
      consumer_sync();
      if (half == 0 && lane % 4 == 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = r0 + 8 * i;
          if (row < m) {
            const float s = (i ? pred1 : pred0) + recf[kPart * kRows + row];
            const float y = bf16r(s + (i ? cv1 : cv0) * wpred_c) + bpred;
            out[rec[kP * kRows + row]] = __float2bfloat16(y);
          }
        }
      }
    }
    consumer_sync();  // the next chunk rewrites the records and the activations
  }
}

template <int kPhase>
cudaError_t set_smem(int F) {
  return cudaFuncSetAttribute(refine_kernel<kPhase>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(refine_smem(F).total));
}

template <int kPhase>
int blocks_per_sm(int F) {
  cudaError_t err = set_smem<kPhase>(F);
  int nb = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &nb, refine_kernel<kPhase>, kConsumers + 32, refine_smem(F).total);
  }
  return err == cudaSuccess ? nb : -static_cast<int>(err);
}

template <int kPhase>
int run(int grid, const void* up, const void* thr, const void* feat, const void* coarse,
        const void* wts, void* out, void* list, void* count, int n, int h2, int w2, int hc,
        int wc, int F, int num_fc, int sf, cudaStream_t stream) {
  const int total = n * h2 * w2;
  const int sel_blocks = (total + kSelThreads * kSelVec - 1) / (kSelThreads * kSelVec);
  const bool vec = reinterpret_cast<uintptr_t>(up) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  select_kernel<<<sel_blocks, kSelThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(up), static_cast<const float*>(thr),
      static_cast<__nv_bfloat16*>(out), static_cast<int*>(list), static_cast<int*>(count),
      total, h2 * w2, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = set_smem<kPhase>(F);
  if (err != cudaSuccess) return static_cast<int>(err);
  refine_kernel<kPhase><<<grid, kConsumers + 32, refine_smem(F).total, stream>>>(
      static_cast<const int*>(list), static_cast<const int*>(count),
      static_cast<const __nv_bfloat16*>(feat), static_cast<const __nv_bfloat16*>(coarse),
      static_cast<const __nv_bfloat16*>(wts), static_cast<__nv_bfloat16*>(out), h2, w2, hc, wc,
      F, num_fc, 1.0f / static_cast<float>(sf));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The shared memory one main-path block needs, so the wrapper can refuse
// widths that do not fit before launching.
size_t pointrend_refine_smem_bytes(int F, int D) { return smem_bytes(F, D); }

// Blocks of the refine pass at `phase` that fit on one SM: > 0, or minus
// the CUDA error, or 0 for an unknown phase.
int pointrend_refine_blocks_per_sm(int phase, int F) {
  switch (phase) {
    case kGather: return blocks_per_sm<kGather>(F);
    case kInterp: return blocks_per_sm<kInterp>(F);
    case kFull: return blocks_per_sm<kFull>(F);
    default: return 0;
  }
}

// One step (or its cut at `phase`): the select pass, then the refine pass
// on `grid` blocks.  `list` holds N*H2*W2 int32, `count` one int32 that is
// zero on entry.  Launches on `stream` and returns the first
// cudaGetLastError() that is not 0 (0 on success).
int pointrend_refine_launch(int phase, int grid, const void* up, const void* thr,
                            const void* feat, const void* coarse, const void* wts, void* out,
                            void* list, void* count, int n, int h2, int w2, int hc, int wc,
                            int F, int num_fc, int sf, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REFINE_RUN(P) \
  run<P>(grid, up, thr, feat, coarse, wts, out, list, count, n, h2, w2, hc, wc, F, num_fc, sf, s)
  switch (phase) {
    case kGather: return REFINE_RUN(kGather);
    case kInterp: return REFINE_RUN(kInterp);
    case kFull: return REFINE_RUN(kFull);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REFINE_RUN
}

}  // extern "C"
