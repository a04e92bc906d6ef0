// The card's element-op rate probe: kernel K6 for sm_90a.
//
// Replaces the synthetic Pallas kernels of measure_vpu in
// scripts/roofline.py (kernel built at :75-91, chains at :111-148): one
// elementwise op chain over a (512, 1280) block, run for a given number of
// iterations, each element's value carried from one iteration to the next.
// The six chains and their op counts per element per iteration are the JAX
// probe's: fma_f32 and fma_bf16 (2: multiply and add), mix_f32 and mix_bf16
// (5: multiply, add, compare, select, max), recip_f32 (3: approximate
// reciprocal, multiply-add fix-up), div_f32 (3: divide, add).  The caller
// times N and 2N iterations and takes the rate from the difference, which
// cancels the launch and the loads and stores.
//
// What bounds it, by design: the rate at which the SMs dispatch the chain's
// instructions.  One thread per element (one bf16 pair for the bf16 chains),
// 655,360 elements: about five thousand blocks of 128 threads, enough warps
// on every SM to hide the latency of the dependent chain.  The iteration count is a
// runtime argument and the result is stored, so the compiler can neither
// fold the chain nor drop it; fma_f32 is one FFMA per iteration.  recip_f32
// uses rcp.approx.ftz.f32, as the slab render kernel does; div_f32 the
// exact IEEE division (nvcc's default -prec-div=true).  bf16 uses the
// __nv_bfloat162 intrinsics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

enum Chain { FMA_F32 = 0, FMA_BF16 = 1, MIX_F32 = 2, MIX_BF16 = 3, RECIP_F32 = 4, DIV_F32 = 5 };

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int CHAIN>
__device__ __forceinline__ float step_f32(float v) {
  if (CHAIN == FMA_F32) return fmaf(v, 1.0000001f, 1e-7f);
  if (CHAIN == MIX_F32) {
    const float a = __fmul_rn(v, 1.0000001f);
    const float b = __fadd_rn(v, 1e-7f);
    return fmaxf(b > a ? a : b, 0.5f);
  }
  if (CHAIN == RECIP_F32) return fmaf(rcp_approx(v), 1.0000001f, 1.0f);
  return __fadd_rn(1.0000001f / v, 1.0f);  // DIV_F32
}

template <int CHAIN>
__device__ __forceinline__ __nv_bfloat162 step_bf16(__nv_bfloat162 v) {
  const __nv_bfloat162 scale = __float2bfloat162_rn(1.001f);
  const __nv_bfloat162 shift = __float2bfloat162_rn(1e-3f);
  if (CHAIN == FMA_BF16) return __hfma2(v, scale, shift);
  const __nv_bfloat162 a = __hmul2(v, scale);  // MIX_BF16
  const __nv_bfloat162 b = __hadd2(v, shift);
  __nv_bfloat162 m;
  m.x = __hgt(b.x, a.x) ? a.x : b.x;
  m.y = __hgt(b.y, a.y) ? a.y : b.y;
  return __hmax2(m, __float2bfloat162_rn(0.5f));
}

template <int CHAIN>
__global__ void chain_f32_kernel(const float* __restrict__ x, float* __restrict__ out, int n,
                                 int iters) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = x[i];
  for (int it = 0; it < iters; ++it) v = step_f32<CHAIN>(v);
  out[i] = v;
}

template <int CHAIN>
__global__ void chain_bf16_kernel(const __nv_bfloat162* __restrict__ x,
                                  __nv_bfloat162* __restrict__ out, int n_pairs, int iters) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_pairs) return;
  __nv_bfloat162 v = x[i];
  for (int it = 0; it < iters; ++it) v = step_bf16<CHAIN>(v);
  out[i] = v;
}

// Runs `chain` (enum Chain) for `iters` iterations over n elements of x
// (float32, or bfloat16 with n even) into out, on `stream`.  Returns
// cudaGetLastError() as an int.
extern "C" int cp_roofline(const void* x, void* out, int n, int iters, int chain,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 128;
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  const __nv_bfloat162* xb = static_cast<const __nv_bfloat162*>(x);
  __nv_bfloat162* ob = static_cast<__nv_bfloat162*>(out);
  const int blocks_f = (n + threads - 1) / threads, blocks_b = (n / 2 + threads - 1) / threads;
  if ((chain == FMA_BF16 || chain == MIX_BF16) && n % 2) return static_cast<int>(cudaErrorInvalidValue);
  switch (chain) {
    case FMA_F32: chain_f32_kernel<FMA_F32><<<blocks_f, threads, 0, st>>>(xf, of, n, iters); break;
    case MIX_F32: chain_f32_kernel<MIX_F32><<<blocks_f, threads, 0, st>>>(xf, of, n, iters); break;
    case RECIP_F32: chain_f32_kernel<RECIP_F32><<<blocks_f, threads, 0, st>>>(xf, of, n, iters); break;
    case DIV_F32: chain_f32_kernel<DIV_F32><<<blocks_f, threads, 0, st>>>(xf, of, n, iters); break;
    case FMA_BF16:
      chain_bf16_kernel<FMA_BF16><<<blocks_b, threads, 0, st>>>(xb, ob, n / 2, iters);
      break;
    case MIX_BF16:
      chain_bf16_kernel<MIX_BF16><<<blocks_b, threads, 0, st>>>(xb, ob, n / 2, iters);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
