// One PointRend eval subdivision step for a single-logit model, bf16.
//
// Replaces the Pallas TPU kernel empanada_tpu/ops/pallas_pointrend.py
// (_refine_kernel, launched by fused_refine_step).  It computes the same
// values, not the same layout: no phase-major permutation, no 128-channel
// coarse block, no lane-replicated predictor.
//
// Inputs (all on the card, contiguous):
//   up     (N, H2, W2)   bf16  logits already upsampled 2x (by the wrapper)
//   thr    (N,)          f32   refine where |up| <= thr (exact K-th value)
//   feat   (N, Hc, Wc, F) bf16 decoder features, NHWC
//   coarse (N, Hc, Wc)   bf16  coarse logit plane
//   wts    packed bf16: W_fine[0] (F x D), W_fine[k] (D x D) k = 1..L-1,
//          w_coarse (L x D), bias (L x D), w_pred (D), w_pred_coarse, b_pred
// Output: out (N, H2, W2) bf16.
//
// One block per (16 x 128 output tile, image).  The block tests every
// pixel of its tile against thr and copies the unselected pixels of `up`
// through; a tile without a selected pixel is done there.  The selected
// pixels are compacted into a shared-memory list and refined in chunks of
// 64 points: bilinear interpolation of the zero-padded feature map and the
// coarse plane at source (R + 0.5) / sf - 0.5 (rows first, rounded to bf16,
// then columns, rounded to bf16), then the point MLP
//   d = x_fine . W_fine + c * w_coarse (f32), h = relu(bf16(bf16(d) + b))
// on the tensor cores (WMMA bf16 x bf16 -> f32), and the predictor
//   y = bf16(bf16(h . w_pred + c * w_pred_coarse) + bf16(b_pred)).
//
// What bounds it on an H100: at MitoNet_v1 widths (F = D = 256) one point
// costs ~395 kFLOP of MLP against ~2 kB of feature reads, so a tile that
// refines every pixel is bound by tensor-core operations, while a step
// whose K = 8192 points cover ~3% of the plane is bound by the bytes of
// the copy-through and by how well the few refining tiles fill the card.
// The design therefore evaluates the MLP only for the selected points (the
// other pixels' output is `up` whatever the MLP says), keeps activations
// in shared memory, and reads the ~0.4 MB of weights from L2 through the
// WMMA fragment loads.  TMA, wgmma and a persistent schedule are left for
// later work.
//
// The kernel is a template over a phase so that the step can be timed in
// parts (the counterpart of the TPU profiling cuts in
// benchmarks/profile_refine_parts.py): pointrend_refine_launch runs the
// whole step (kFull, the main path's kernel); pointrend_refine_gather_launch
// stops after the selected points' feature-tap loads and
// pointrend_refine_interp_launch after the bilinear interpolation.  A cut
// phase still does all of its loads (its output depends on them, or an
// empty asm keeps them), and writes per selected pixel the f32 channel sum
// of the top-left tap (gather) or of the sampled feature (interp), rounded
// to bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "refine_layout.cuh"

using namespace nvcuda;

namespace {

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float bf(const __nv_bfloat16 v) {
  return __bfloat162float(v);
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
__device__ __forceinline__ void keep(const float2 v) {
  asm volatile("" : : "f"(v.x), "f"(v.y));
}

// kPhase: kFull is the step; kGather and kInterp stop after the feature
// taps' loads and after the bilinear interpolation, and write at each
// selected pixel the f32 sum over the F channels (of the top-left tap and
// of the sampled feature) rounded to bf16, for timing the phases.
template <int kPhase>
__global__ void __launch_bounds__(kThreads)
refine_kernel(const __nv_bfloat16* __restrict__ up, const float* __restrict__ thr,
              const __nv_bfloat16* __restrict__ feat,
              const __nv_bfloat16* __restrict__ coarse,
              const __nv_bfloat16* __restrict__ wts, __nv_bfloat16* __restrict__ out,
              int h2, int w2, int hc, int wc, int F, int D, int num_fc, float inv_sf) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldx = (F > D ? F : D) + kPad;  // bf16 activations row stride
  const int lda = D + kPad;                // f32 accumulator row stride
  __nv_bfloat16* xbuf = reinterpret_cast<__nv_bfloat16*>(smem);
  float* acc = reinterpret_cast<float*>(smem + sizeof(__nv_bfloat16) * kChunk * ldx);
  float* cval = acc + kChunk * lda;
  int16_t* plist = reinterpret_cast<int16_t*>(cval + kChunk);
  __shared__ int n_sel;

  const int b = blockIdx.y;
  const int ntx = (w2 + kTileW - 1) / kTileW;
  const int r0 = (blockIdx.x / ntx) * kTileH;
  const int c0 = (blockIdx.x % ntx) * kTileW;
  const float t = thr[b];
  const __nv_bfloat16* upb = up + static_cast<size_t>(b) * h2 * w2;
  __nv_bfloat16* outb = out + static_cast<size_t>(b) * h2 * w2;

  if (threadIdx.x == 0) n_sel = 0;
  __syncthreads();
  for (int p = threadIdx.x; p < kTileH * kTileW; p += kThreads) {
    const int r = r0 + p / kTileW, c = c0 + p % kTileW;
    if (r < h2 && c < w2) {
      const size_t o = static_cast<size_t>(r) * w2 + c;
      const __nv_bfloat16 u = upb[o];
      if (fabsf(bf(u)) <= t) {
        plist[atomicAdd(&n_sel, 1)] = static_cast<int16_t>(p);
      } else {
        outb[o] = u;
      }
    }
  }
  __syncthreads();
  const int n = n_sel;
  if (n == 0) return;

  const __nv_bfloat16* featb = feat + static_cast<size_t>(b) * hc * wc * F;
  const __nv_bfloat16* coarseb = coarse + static_cast<size_t>(b) * hc * wc;
  const __nv_bfloat16* wc_all = wts + static_cast<size_t>(F) * D +
                                static_cast<size_t>(num_fc - 1) * D * D;
  const __nv_bfloat16* bias_all = wc_all + static_cast<size_t>(num_fc) * D;
  const __nv_bfloat16* wpred = bias_all + static_cast<size_t>(num_fc) * D;
  const float wpred_c = bf(wpred[D]);
  const float bpred = bf(wpred[D + 1]);
  const int warp = threadIdx.x / 32;
  const int n_col = D / 16;
  const int half_f = F / 2;
  const __nv_bfloat162 zero2 = __floats2bfloat162_rn(0.f, 0.f);

  for (int base = 0; base < n; base += kChunk) {
    const int m = min(kChunk, n - base);

    // ---- bilinear interpolation of the features, two channels a thread
    for (int e = threadIdx.x; e < kChunk * half_f; e += kThreads) {
      const int i = e / half_f, q = e % half_f;
      __nv_bfloat162 res = zero2;
      if (i < m) {
        const int p = plist[base + i];
        int y0, x0;
        float wy, wx;
        axis_tap(r0 + p / kTileW, inv_sf, &y0, &wy);
        axis_tap(c0 + p % kTileW, inv_sf, &x0, &wx);
        float2 v[2][2];
        for (int dy = 0; dy < 2; ++dy) {
          for (int dx = 0; dx < 2; ++dx) {
            const int y = y0 + dy, x = x0 + dx;
            float2 val = make_float2(0.f, 0.f);
            if (y >= 0 && y < hc && x >= 0 && x < wc) {
              const __nv_bfloat162 raw = reinterpret_cast<const __nv_bfloat162*>(
                  featb + (static_cast<size_t>(y) * wc + x) * F)[q];
              val = __bfloat1622float2(raw);
            }
            v[dy][dx] = val;
          }
        }
        if constexpr (kPhase == kGather) {
          keep(v[0][1]);
          keep(v[1][0]);
          keep(v[1][1]);
          res = __floats2bfloat162_rn(v[0][0].x, v[0][0].y);
        } else {
          // rows first, rounded to bf16; then columns, rounded to bf16
          const float a0 = bf16r(lerp(v[0][0].x, v[1][0].x, wy));
          const float a1 = bf16r(lerp(v[0][1].x, v[1][1].x, wy));
          const float b0 = bf16r(lerp(v[0][0].y, v[1][0].y, wy));
          const float b1 = bf16r(lerp(v[0][1].y, v[1][1].y, wy));
          res = __floats2bfloat162_rn(lerp(a0, a1, wx), lerp(b0, b1, wx));
        }
      }
      reinterpret_cast<__nv_bfloat162*>(xbuf + i * ldx)[q] = res;
    }
    // ---- the coarse plane at the same points
    if (kPhase != kGather && threadIdx.x < kChunk) {
      const int i = threadIdx.x;
      float cv = 0.f;
      if (i < m) {
        const int p = plist[base + i];
        int y0, x0;
        float wy, wx;
        axis_tap(r0 + p / kTileW, inv_sf, &y0, &wy);
        axis_tap(c0 + p % kTileW, inv_sf, &x0, &wx);
        float v[2][2];
        for (int dy = 0; dy < 2; ++dy) {
          for (int dx = 0; dx < 2; ++dx) {
            const int y = y0 + dy, x = x0 + dx;
            v[dy][dx] = (y >= 0 && y < hc && x >= 0 && x < wc)
                            ? bf(coarseb[static_cast<size_t>(y) * wc + x]) : 0.f;
          }
        }
        const float a0 = bf16r(lerp(v[0][0], v[1][0], wy));
        const float a1 = bf16r(lerp(v[0][1], v[1][1], wy));
        cv = bf16r(lerp(a0, a1, wx));
      }
      cval[i] = cv;
    }
    __syncthreads();

    if constexpr (kPhase != kFull) {
      // ---- cut phases: the channel sum of each point, 4 threads a point
      const int i = threadIdx.x / 4, part = threadIdx.x % 4;
      float s = 0.f;
      for (int j = part; j < F; j += 4) s += bf(xbuf[i * ldx + j]);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (part == 0 && i < m) {
        const int p = plist[base + i];
        outb[static_cast<size_t>(r0 + p / kTileW) * w2 + c0 + p % kTileW] =
            __float2bfloat16(s);
      }
      __syncthreads();
      continue;
    }

    // ---- hidden layers: (64 x K) . (K x D) on the tensor cores
    const __nv_bfloat16* wl = wts;
    for (int layer = 0; layer < num_fc; ++layer) {
      const int K = layer == 0 ? F : D;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> accf[4][2];
      for (int i = 0; i < 4; ++i)
        for (int jj = 0; jj < 2; ++jj) wmma::fill_fragment(accf[i][jj], 0.f);
      for (int k = 0; k < K; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af[4];
        for (int i = 0; i < 4; ++i)
          wmma::load_matrix_sync(af[i], xbuf + (i * 16) * ldx + k, ldx);
        for (int jj = 0; jj < 2; ++jj) {
          const int j = warp + jj * 8;
          if (j < n_col) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bfr;
            wmma::load_matrix_sync(bfr, wl + static_cast<size_t>(k) * D + j * 16, D);
            for (int i = 0; i < 4; ++i) wmma::mma_sync(accf[i][jj], af[i], bfr, accf[i][jj]);
          }
        }
      }
      for (int jj = 0; jj < 2; ++jj) {
        const int j = warp + jj * 8;
        if (j < n_col) {
          for (int i = 0; i < 4; ++i)
            wmma::store_matrix_sync(acc + (i * 16) * lda + j * 16, accf[i][jj], lda,
                                    wmma::mem_row_major);
        }
      }
      __syncthreads();
      const __nv_bfloat16* wcl = wc_all + static_cast<size_t>(layer) * D;
      const __nv_bfloat16* bl = bias_all + static_cast<size_t>(layer) * D;
      for (int e = threadIdx.x; e < kChunk * D; e += kThreads) {
        const int i = e / D, j = e % D;
        const float d = acc[i * lda + j] + cval[i] * bf(wcl[j]);
        const float h = bf16r(bf16r(d) + bf(bl[j]));
        xbuf[i * ldx + j] = __float2bfloat16(fmaxf(h, 0.f));
      }
      __syncthreads();
      wl += static_cast<size_t>(K) * D;
    }

    // ---- predictor: 4 threads per point, then the blend
    {
      const int i = threadIdx.x / 4, part = threadIdx.x % 4;
      float s = 0.f;
      for (int j = part; j < D; j += 4) s += bf(xbuf[i * ldx + j]) * bf(wpred[j]);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (part == 0 && i < m) {
        const float d = s + cval[i] * wpred_c;
        const float y = bf16r(d) + bpred;
        const int p = plist[base + i];
        outb[static_cast<size_t>(r0 + p / kTileW) * w2 + c0 + p % kTileW] =
            __float2bfloat16(y);
      }
    }
    __syncthreads();
  }
}

template <int kPhase>
int launch(const void* up, const void* thr, const void* feat, const void* coarse,
           const void* wts, void* out, int n, int h2, int w2, int hc, int wc, int F, int D,
           int num_fc, int sf, void* stream) {
  const size_t smem = smem_bytes(F, D);
  cudaError_t err = cudaFuncSetAttribute(refine_kernel<kPhase>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ntiles = ((h2 + kTileH - 1) / kTileH) * ((w2 + kTileW - 1) / kTileW);
  dim3 grid(ntiles, n);
  refine_kernel<kPhase><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(up), static_cast<const float*>(thr),
      static_cast<const __nv_bfloat16*>(feat), static_cast<const __nv_bfloat16*>(coarse),
      static_cast<const __nv_bfloat16*>(wts), static_cast<__nv_bfloat16*>(out), h2, w2,
      hc, wc, F, D, num_fc, 1.0f / static_cast<float>(sf));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define REFINE_ENTRY(name, phase)                                                     \
  int name(const void* up, const void* thr, const void* feat, const void* coarse,    \
           const void* wts, void* out, int n, int h2, int w2, int hc, int wc, int F, \
           int D, int num_fc, int sf, void* stream) {                                \
    return launch<phase>(up, thr, feat, coarse, wts, out, n, h2, w2, hc, wc, F, D,  \
                         num_fc, sf, stream);                                         \
  }

extern "C" {

// Returns the shared memory one block needs, so the wrapper can refuse
// widths that do not fit before launching.
size_t pointrend_refine_smem_bytes(int F, int D) { return smem_bytes(F, D); }

// Each launches on `stream` and returns cudaGetLastError() (0 on success):
// the whole step, and its two cuts for timing.
REFINE_ENTRY(pointrend_refine_launch, kFull)
REFINE_ENTRY(pointrend_refine_gather_launch, kGather)
REFINE_ENTRY(pointrend_refine_interp_launch, kInterp)

}  // extern "C"
