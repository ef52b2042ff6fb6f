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
//   acc     = conv(xq, wq)                             (s32)
//   out     = T(float(acc) * (a_scale * w_scale[o]))   (f32 product first)
//
// wq and w_scale are quantized once from the f32 master weights by the
// wrapper (ops/int8_conv.py::quantize_weight), wq stored as
// [C_out][kh][kw][C_in] so that the GEMM's K runs contiguous.
//
// Inputs (on the card): x (N, H, W, C) bf16 or f32 in NHWC (the port's
// channels_last NCHW tensors), C % 32 == 0; wq s8 [O][KH][KW][C]; w_scale
// f32 [O], O % 8 == 0.  Output: out (N, Ho, Wo, O) of x's type, NHWC.
//
// One call is a memset of the 4-byte max and three launches on one stream,
// with nothing read back to the host:
//
// 1. absmax_kernel: a grid-stride pass over x, 16-byte loads, a warp and
//    block max of |x|, one atomicMax per block on the max's bit pattern
//    (non-negative floats order as their bits, so the max is exact).
// 2. quantize_kernel: xq = clip(rint(x / a_scale)) into an s8 NHWC buffer,
//    a_scale recomputed by every thread from the device max.
// 3. conv_kernel: an implicit GEMM, M = N*Ho*Wo output pixels by N = O
//    channels by K = KH*KW*C.  A block of 8 warps computes a BM x 128 tile
//    (BM = 32 * MT, MT picked per shape so that small grids still fill the
//    SMs); each warp BM/2 rows x 32 columns.  K moves in steps of 32 bytes
//    (one tap, 32 channels): per step the block copies the A rows (the
//    im2col of xq, zero-filled at the padding and past M) and the B rows
//    (wq) into shared memory with cp.async, 4 stages deep, rows 48 bytes
//    apart so that ldmatrix reads them without bank conflicts; the warps
//    run mma.sync.m16n8k32 s8 products into s32 registers.  The epilogue
//    converts with __int2float_rn, multiplies by __fmul_rn(a_scale,
//    w_scale[o]) and rounds to the output type (round to nearest even).
//
// What bounds it on an H100: at MitoNet_v1's shapes (512 x 512 request:
// 4096 x 128 x 1152 in layer2, 1024 x 256 x 2304 in layer3, 1024 x 512 x
// 4608 in layer4) the products are 1.2-4.8 G integer operations a call
// against under 5 MB moved, so the bound is the tensor cores' int8 rate
// (1,979 TOP/s dense); the quantize passes are bound by bytes.  This first
// version uses mma.sync from registers, which reaches a fraction of that
// rate; wgmma with TMA-fed stages is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;     // 8 warps a block, in every kernel
constexpr int kBN = 128;          // output channels a conv block
constexpr int kBK = 32;           // K bytes a pipeline stage
constexpr int kPitch = 48;        // bytes between shared-memory rows
constexpr int kStages = 4;
constexpr int kReduceBlocks = 1056;  // 8 blocks per SM of an H100 at most

// / 127 as XLA computes it: a multiplication by float32(1 / 127)
constexpr float kInv127 = 1.0f / 127.0f;

__device__ __forceinline__ float act_scale(const unsigned* amax) {
  return __fmul_rn(fmaxf(__uint_as_float(*amax), 1e-12f), kInv127);
}

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

template <typename T>
__global__ void __launch_bounds__(kThreads) absmax_kernel(const T* __restrict__ x,
                                                          long long nvec, unsigned* amax) {
  constexpr int V = Vec<T>::n;
  float m = 0.f;
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < nvec;
       i += (long long)gridDim.x * kThreads) {
    float v[V];
    Vec<T>::load(x + i * V, v);
#pragma unroll
    for (int k = 0; k < V; ++k) m = fmaxf(m, fabsf(v[k]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ float warp_max[kThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, warp_max[w]);
    atomicMax(amax, __float_as_uint(m));
  }
}

__device__ __forceinline__ int quantize1(float v, float s) {
  float q = rintf(__fdiv_rn(v, s));
  return (int)fminf(fmaxf(q, -127.f), 127.f);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) quantize_kernel(const T* __restrict__ x,
                                                            long long nvec,
                                                            const unsigned* amax,
                                                            int8_t* __restrict__ xq) {
  constexpr int V = Vec<T>::n;
  const float s = act_scale(amax);
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  // src-size 0 writes 16 zero bytes and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct ConvShape {
  int n, h, w, c, o, kh, kw, stride, pad, dil, ho, wo;
};

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// MT m16 tiles a warp: BM = 32 * MT rows a block (two warp rows)
template <int MT, typename TOut>
__global__ void __launch_bounds__(kThreads) conv_kernel(const int8_t* __restrict__ xq,
                                                        const int8_t* __restrict__ wq,
                                                        const float* __restrict__ w_scale,
                                                        const unsigned* amax,
                                                        TOut* __restrict__ out, ConvShape s) {
  constexpr int BM = 32 * MT;
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp >> 2, warp_n = warp & 3;
  const int M = s.n * s.ho * s.wo;
  const int K = s.kh * s.kw * s.c;
  const int KT = K / kBK;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * kBN;

  // this thread's copy slots: A row tid/2 (if < BM), B row tid/2, 16-byte half tid&1
  const int half = tid & 1, row = tid >> 1;
  const bool a_loader = row < BM;
  const int m = m0 + row;
  const bool m_ok = a_loader && m < M;
  int img = 0, hi0 = 0, wi0 = 0;
  if (m_ok) {
    img = m / (s.ho * s.wo);
    const int r = m - img * s.ho * s.wo;
    hi0 = (r / s.wo) * s.stride - s.pad;
    wi0 = (r % s.wo) * s.stride - s.pad;
  }
  const int8_t* xq_img = xq + (long long)img * s.h * s.w * s.c;
  const bool b_ok = n0 + row < s.o;
  const int8_t* b_src = wq + (long long)(b_ok ? n0 + row : 0) * K + half * 16;

  auto stage_a = [&](int st) { return smem + st * (BM + kBN) * kPitch; };
  auto stage_b = [&](int st) { return smem + st * (BM + kBN) * kPitch + BM * kPitch; };

  // the K position of the next stage to load: tap (ky, kx), channel c0
  int ld_kt = 0, ky = 0, kx = 0, c0 = 0;
  auto load_stage = [&](int st) {
    if (a_loader) {
      const int hi = hi0 + ky * s.dil, wi = wi0 + kx * s.dil;
      const bool ok = m_ok && hi >= 0 && hi < s.h && wi >= 0 && wi < s.w;
      const int8_t* src = ok ? xq_img + ((long long)hi * s.w + wi) * s.c + c0 + half * 16 : xq;
      cp_async16(smem_u32(stage_a(st) + row * kPitch + half * 16), src, ok);
    }
    cp_async16(smem_u32(stage_b(st) + row * kPitch + half * 16), b_src + ld_kt * kBK, b_ok);
    ++ld_kt;
    c0 += kBK;
    if (c0 == s.c) {
      c0 = 0;
      if (++kx == s.kw) { kx = 0; ++ky; }
    }
  };

  int acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < KT) load_stage(st);
    asm volatile("cp.async.commit_group;\n" ::);
  }

  // ldmatrix row addresses of this lane: A rows (lane & 15), bytes 16 * (lane >> 4);
  // B rows (lane & 7) + 8 * (lane >> 4), bytes 16 * ((lane >> 3) & 1)
  const int a_off = (warp_m * (BM / 2) + (lane & 15)) * kPitch + (lane >> 4) * 16;
  const int b_off = (warp_n * 32 + (lane & 7) + ((lane >> 4) << 3)) * kPitch +
                    ((lane >> 3) & 1) * 16;

  for (int kt = 0; kt < KT; ++kt) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
    __syncthreads();
    if (kt + kStages - 1 < KT) load_stage((kt + kStages - 1) % kStages);
    asm volatile("cp.async.commit_group;\n" ::);

    const int st = kt % kStages;
    const uint32_t a_base = smem_u32(stage_a(st)) + a_off;
    const uint32_t b_base = smem_u32(stage_b(st)) + b_off;
    uint32_t b[4][2];
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {  // two n8 tiles a load
      uint32_t r[4];
      ldmatrix_x4(b_base + jj * 16 * kPitch, r);
      b[2 * jj][0] = r[0];
      b[2 * jj][1] = r[1];
      b[2 * jj + 1][0] = r[2];
      b[2 * jj + 1][1] = r[3];
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      uint32_t a[4];
      ldmatrix_x4(a_base + i * 16 * kPitch, a);
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a, b[j][0], b[j][1]);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);

  // epilogue: c0,c1 at (row g, cols 2t, 2t+1); c2,c3 at row g + 8
  const float a_s = act_scale(amax);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + warp_n * 32 + j * 8 + 2 * t;
    if (col >= s.o) continue;
    const float s0 = __fmul_rn(a_s, w_scale[col]);
    const float s1 = __fmul_rn(a_s, w_scale[col + 1]);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int mm = m0 + warp_m * (BM / 2) + i * 16 + g + 8 * hf;
        if (mm >= M) continue;
        store2(out + (long long)mm * s.o + col,
               __fmul_rn(__int2float_rn(acc[i][j][2 * hf]), s0),
               __fmul_rn(__int2float_rn(acc[i][j][2 * hf + 1]), s1));
      }
    }
  }
}

int reduce_blocks(long long nvec) {
  long long b = (nvec + kThreads - 1) / kThreads;
  return (int)(b < kReduceBlocks ? (b > 0 ? b : 1) : kReduceBlocks);
}

template <typename T>
int quantize(const T* x, long long numel, unsigned* amax, int8_t* xq, cudaStream_t stream) {
  const long long nvec = numel / Vec<T>::n;
  cudaError_t err = cudaMemsetAsync(amax, 0, sizeof(unsigned), stream);
  if (err != cudaSuccess) return (int)err;
  absmax_kernel<T><<<reduce_blocks(nvec), kThreads, 0, stream>>>(x, nvec, amax);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  quantize_kernel<T><<<reduce_blocks(nvec), kThreads, 0, stream>>>(x, nvec, amax, xq);
  return (int)cudaGetLastError();
}

template <int MT, typename TOut>
int conv(const int8_t* xq, const int8_t* wq, const float* w_scale, const unsigned* amax,
         void* out, const ConvShape& s, cudaStream_t stream) {
  constexpr int BM = 32 * MT;
  constexpr int smem = kStages * (BM + kBN) * kPitch;
  // within the 48 KB a launch may take without an opt-in attribute
  static_assert(smem <= 48 * 1024, "conv_kernel: stages exceed 48 KB of shared memory");
  const int M = s.n * s.ho * s.wo;
  dim3 grid((M + BM - 1) / BM, (s.o + kBN - 1) / kBN);
  conv_kernel<MT, TOut><<<grid, kThreads, smem, stream>>>(xq, wq, w_scale, amax,
                                                          static_cast<TOut*>(out), s);
  return (int)cudaGetLastError();
}

template <typename TOut>
int conv_mt(int mt, const int8_t* xq, const int8_t* wq, const float* w_scale,
            const unsigned* amax, void* out, const ConvShape& s, cudaStream_t stream) {
  switch (mt) {
    case 1: return conv<1, TOut>(xq, wq, w_scale, amax, out, s, stream);
    case 2: return conv<2, TOut>(xq, wq, w_scale, amax, out, s, stream);
    case 4: return conv<4, TOut>(xq, wq, w_scale, amax, out, s, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype codes: 0 bf16, 1 f32

// memset + absmax + quantize: xq (numel s8, NHWC) and the max's bits in amax
int int8_quantize_launch(int dtype, const void* x, long long numel, unsigned* amax,
                         int8_t* xq, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return quantize(static_cast<const __nv_bfloat16*>(x), numel, amax, xq, st);
  if (dtype == 1) return quantize(static_cast<const float*>(x), numel, amax, xq, st);
  return (int)cudaErrorInvalidValue;
}

// the whole function: quantize x into xq, then the implicit GEMM into out (x's type)
int int8_conv_launch(int dtype, int mt, const void* x, int8_t* xq,
                     unsigned* amax, const int8_t* wq, const float* w_scale, void* out, int n,
                     int h, int w, int c, int o, int kh, int kw, int stride, int pad, int dil,
                     int ho, int wo, void* stream) {
  if (c % kBK || o % 8) return (int)cudaErrorInvalidValue;
  int err = int8_quantize_launch(dtype, x, (long long)n * h * w * c, amax, xq, stream);
  if (err != 0) return err;
  const ConvShape s{n, h, w, c, o, kh, kw, stride, pad, dil, ho, wo};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? conv_mt<__nv_bfloat16>(mt, xq, wq, w_scale, amax, out, s, st)
                    : conv_mt<float>(mt, xq, wq, w_scale, amax, out, s, st);
}

}  // extern "C"
