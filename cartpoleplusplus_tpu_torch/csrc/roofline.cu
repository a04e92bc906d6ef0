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
// What bounds it, by design: the rate at which the SMs issue the chain's
// instructions, or the rate of the pipe its slowest instruction class runs
// on (MUFU for the reciprocal).  The design keeps every SM busy for the
// same time and every scheduler fed:
//
// - One wave, sized to the card.  A unit is an element (float32) or a pair
//   (bfloat16, one __nv_bfloat162 register).  Each thread carries K units
//   at a time (k_of), so an SM needs W = ceil(units / (SMs·32·K)) warps,
//   rounded up to whole blocks of THREADS (4 warps, one per scheduler).  The grid is
//   SMs × B blocks, B = W / 4, at most what the occupancy API says an SM
//   holds; each block asks for dynamic shared memory it never touches, just
//   over a (B+1)-th of the SM's, so that no SM can hold more than B blocks
//   and every SM holds exactly B of them.
// - A balanced split (geometry(); utils/roofline.split mirrors it).  With T
//   threads, thread t's slot j holds unit j·T + t for j < full = units / T,
//   so loads and stores stay coalesced; the rest = units % T units of slot
//   `full` are spread over the blocks in equal runs (block b takes the run
//   [b·rest/G, (b+1)·rest/G) of them, its first threads one each), so no
//   block holds more than one unit above another.  Slots past the units
//   (at most one slot per thread on the card's shapes) carry a dummy 1.0
//   that is never stored.
// - K independent chains per thread, interleaved in registers, so a
//   dependent latency (the MUFU reciprocal's, the HFMA2's) is hidden by the
//   thread's own other chains as well as by other warps: K = 4, and 3 for
//   div_f32.  ptxas puts each IEEE division in a convergence region of its
//   own (BSSY ... BSYNC around the slow path's CALL), so a thread's
//   divisions run one after another and only warps hide their latency:
//   3 chains fill 13 warps a scheduler (the block's 655,360 elements in
//   99.5 % of the slots), where 4 fill 10.  The iteration loop is unrolled
//   unroll_of(chain) times, so the loop's own counter and branch are a few
//   percent of the instructions issued.
//
// Each unit's value sequence is the unit's chain alone, so the output is
// bit-identical to one thread per unit.  The iteration count is a runtime
// argument and the result is stored, so the compiler can neither fold the
// chain nor drop it; fma_f32 is one FFMA per iteration.  recip_f32 uses
// rcp.approx.ftz.f32, as the slab render kernel does; div_f32 the exact IEEE
// division (nvcc's default -prec-div=true).  bf16 uses the __nv_bfloat162
// intrinsics, fma_bf16 its constants from kernel arguments (PairConsts);
// mix_bf16 compares both halves at once (a mask per half) and selects with
// one bitwise op, as `b > a ? a : b` per half.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstring>

enum Chain { FMA_F32 = 0, FMA_BF16 = 1, MIX_F32 = 2, MIX_BF16 = 3, RECIP_F32 = 4, DIV_F32 = 5 };
constexpr int NUM_CHAINS = 6;
constexpr int THREADS = 128;  // one warp per scheduler
// Register ceiling, by the blocks of THREADS an SM must hold: 16 (at most
// 32 registers a thread; the card's shapes need 13 for div_f32, 10 for the
// other float32 chains, 5 for bf16), but 12 for mix_bf16 (40 registers),
// which at 32 reloads its constants inside the loop.
__host__ __device__ constexpr int min_blocks_of(int chain) { return chain == MIX_BF16 ? 12 : 16; }

// Independent chains per thread.
__host__ __device__ constexpr int k_of(int chain) { return chain == DIV_F32 ? 3 : 4; }

// Steps per pass of the unrolled loop, per chain: about 128 instructions a
// pass for K chains, so the counter and branch stay under 5 % of them.
__host__ __device__ constexpr int unroll_of(int chain) {
  return chain == FMA_F32 || chain == FMA_BF16 ? 32
         : chain == RECIP_F32                  ? 16
         : chain == DIV_F32                    ? 4
                                               : 8;
}

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

__device__ __forceinline__ unsigned bits_of(__nv_bfloat162 v) {
  unsigned u;
  memcpy(&u, &v, sizeof u);
  return u;
}

__device__ __forceinline__ __nv_bfloat162 bf162_of(unsigned u) {
  __nv_bfloat162 v;
  memcpy(&v, &u, sizeof v);
  return v;
}

// The bfloat16 scale and shift, kernel arguments for fma_bf16: held in
// registers, ptxas sends every other HFMA2 of the loop to the second 16-bit
// pipe (HFMA2.MMA); with an immediate shift it sent none there, and the loop
// ran at half the rate.  mix_bf16 keeps its literals, with which it ran
// faster than from arguments.
struct PairConsts {
  __nv_bfloat162 scale, shift;
};
struct NoConsts {};

template <int CHAIN>
__device__ __forceinline__ __nv_bfloat162 step_bf16(__nv_bfloat162 v, PairConsts c) {
  if (CHAIN == FMA_BF16) return __hfma2(v, c.scale, c.shift);
  const __nv_bfloat162 scale = __float2bfloat162_rn(1.001f);  // MIX_BF16
  const __nv_bfloat162 shift = __float2bfloat162_rn(1e-3f);
  const __nv_bfloat162 a = __hmul2(v, scale);
  const __nv_bfloat162 b = __hadd2(v, shift);
  const unsigned gt = __hgt2_mask(b, a);  // 0xffff in each half where b > a
  const unsigned m = (bits_of(a) & gt) | (bits_of(b) & ~gt);
  return __hmax2(bf162_of(m), __float2bfloat162_rn(0.5f));
}

template <int CHAIN>
__device__ __forceinline__ float step(float v, NoConsts) { return step_f32<CHAIN>(v); }

template <int CHAIN>
__device__ __forceinline__ __nv_bfloat162 step(__nv_bfloat162 v, PairConsts c) {
  return step_bf16<CHAIN>(v, c);
}

// `iters` steps of each of the K chains in v, interleaved.
template <int CHAIN, int K, typename T, typename C>
__device__ __forceinline__ void run_chains(T (&v)[K], int iters, C c) {
  constexpr int U = unroll_of(CHAIN);
  int left = iters;
  for (; left >= U; left -= U) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int k = 0; k < K; ++k) v[k] = step<CHAIN>(v[k], c);
    }
  }
#pragma unroll 1
  for (; left > 0; --left) {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = step<CHAIN>(v[k], c);
  }
}

// Units of the split: `slots` slots a thread (full of them whole, then the
// balanced runs of `rest`), taken K at a time.
template <int CHAIN, typename T, typename C>
__device__ __forceinline__ void chain_body(const T* __restrict__ x, T* __restrict__ out, int full,
                                           int rest, int slots, int iters, T dummy, C c) {
  constexpr int K = k_of(CHAIN);
  const long long g = gridDim.x, b = blockIdx.x;
  const long long n_threads = g * THREADS;
  const long long t = b * THREADS + threadIdx.x;
  const long long lo = b * rest / g, hi = (b + 1) * rest / g;
  const long long last = threadIdx.x < hi - lo ? full * n_threads + lo + threadIdx.x : -1;
  for (int s0 = 0; s0 < slots; s0 += K) {
    long long idx[K];
    T v[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int s = s0 + k;
      idx[k] = s < full ? s * n_threads + t : s == full ? last : -1;
      v[k] = idx[k] >= 0 ? x[idx[k]] : dummy;
    }
    run_chains<CHAIN>(v, iters, c);
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (idx[k] >= 0) out[idx[k]] = v[k];
  }
}

template <int CHAIN>
__global__ void __launch_bounds__(THREADS, min_blocks_of(CHAIN))
chain_f32_kernel(const float* __restrict__ x, float* __restrict__ out, int full, int rest,
                 int slots, int iters) {
  chain_body<CHAIN>(x, out, full, rest, slots, iters, 1.0f, NoConsts{});
}

template <int CHAIN>
__global__ void __launch_bounds__(THREADS, min_blocks_of(CHAIN))
chain_bf16_kernel(const __nv_bfloat162* __restrict__ x, __nv_bfloat162* __restrict__ out,
                  int full, int rest, int slots, int iters, PairConsts c) {
  chain_body<CHAIN>(x, out, full, rest, slots, iters, __float2bfloat162_rn(1.0f), c);
}

static const void* kernel_of(int chain) {
  switch (chain) {
    case FMA_F32: return reinterpret_cast<const void*>(chain_f32_kernel<FMA_F32>);
    case MIX_F32: return reinterpret_cast<const void*>(chain_f32_kernel<MIX_F32>);
    case RECIP_F32: return reinterpret_cast<const void*>(chain_f32_kernel<RECIP_F32>);
    case DIV_F32: return reinterpret_cast<const void*>(chain_f32_kernel<DIV_F32>);
    case FMA_BF16: return reinterpret_cast<const void*>(chain_bf16_kernel<FMA_BF16>);
    case MIX_BF16: return reinterpret_cast<const void*>(chain_bf16_kernel<MIX_BF16>);
    default: return nullptr;
  }
}

// What the card offers a chain's kernel, read once per device and chain.
struct Card {
  int ready, sms, max_blocks, smem_per_sm, smem_reserved, smem_optin;
};
constexpr int MAX_DEVICES = 64;
static Card cards[MAX_DEVICES][NUM_CHAINS];

static cudaError_t card_of(int chain, Card* out) {
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  Card& c = cards[dev][chain];
  if (!c.ready) {
    const void* fn = kernel_of(chain);
    if ((err = cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, dev)) ||
        (err = cudaDeviceGetAttribute(&c.smem_per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                                      dev)) ||
        (err = cudaDeviceGetAttribute(&c.smem_reserved, cudaDevAttrReservedSharedMemoryPerBlock,
                                      dev)) ||
        (err = cudaDeviceGetAttribute(&c.smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                      dev)) ||
        (err = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                                    cudaSharedmemCarveoutMaxShared)) ||
        (err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    c.smem_optin)) ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&c.max_blocks, fn, THREADS, 0)))
      return err;
    c.ready = 1;
  }
  *out = c;
  return cudaSuccess;
}

// The launch of `chain` over `units` units: blocks per SM, grid, dynamic
// shared memory, and the split (full, rest, slots).
struct Geometry {
  int sms, max_blocks, blocks_per_sm, grid, smem, full, rest, slots;
};

static cudaError_t geometry(int chain, int units, Geometry* g) {
  Card c;
  cudaError_t err = card_of(chain, &c);
  if (err != cudaSuccess) return err;
  const long long per_sm = (long long)c.sms * 32 * k_of(chain);
  const int warps = static_cast<int>((units + per_sm - 1) / per_sm);
  int blocks = (warps + THREADS / 32 - 1) / (THREADS / 32);
  blocks = blocks < 1 ? 1 : blocks > c.max_blocks ? c.max_blocks : blocks;
  // Shared memory that leaves room for `blocks` blocks on an SM, not one more.
  g->smem = blocks < c.max_blocks ? c.smem_per_sm / (blocks + 1) - c.smem_reserved + 1 : 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel_of(chain), THREADS,
                                                           g->smem)))
    return err;
  if (blocks < 1) return cudaErrorInvalidConfiguration;
  const long long threads = (long long)c.sms * blocks * THREADS;
  g->sms = c.sms;
  g->max_blocks = c.max_blocks;
  g->blocks_per_sm = blocks;
  g->grid = c.sms * blocks;
  g->full = static_cast<int>(units / threads);
  g->rest = static_cast<int>(units % threads);
  g->slots = g->full + (g->rest > 0);
  return cudaSuccess;
}

static bool is_bf16(int chain) { return chain == FMA_BF16 || chain == MIX_BF16; }

// Runs `chain` (enum Chain) for `iters` iterations over n elements of x
// (float32, or bfloat16 with n even) into out, on `stream`.  Returns
// cudaGetLastError() as an int.
extern "C" int cp_roofline(const void* x, void* out, int n, int iters, int chain,
                           void* stream) {
  if (chain < 0 || chain >= NUM_CHAINS || (is_bf16(chain) && n % 2))
    return static_cast<int>(cudaErrorInvalidValue);
  Geometry g;
  cudaError_t err = geometry(chain, is_bf16(chain) ? n / 2 : n, &g);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  const __nv_bfloat162* xb = static_cast<const __nv_bfloat162*>(x);
  __nv_bfloat162* ob = static_cast<__nv_bfloat162*>(out);
  const dim3 grid(g.grid), block(THREADS);
  const PairConsts pc{__float2bfloat162_rn(1.001f), __float2bfloat162_rn(1e-3f)};
#define CP_F32(C) \
  chain_f32_kernel<C><<<grid, block, g.smem, st>>>(xf, of, g.full, g.rest, g.slots, iters)
#define CP_BF16(C) \
  chain_bf16_kernel<C><<<grid, block, g.smem, st>>>(xb, ob, g.full, g.rest, g.slots, iters, pc)
  switch (chain) {
    case FMA_F32: CP_F32(FMA_F32); break;
    case MIX_F32: CP_F32(MIX_F32); break;
    case RECIP_F32: CP_F32(RECIP_F32); break;
    case DIV_F32: CP_F32(DIV_F32); break;
    case FMA_BF16: CP_BF16(FMA_BF16); break;
    case MIX_BF16: CP_BF16(MIX_BF16); break;
  }
#undef CP_F32
#undef CP_BF16
  return static_cast<int>(cudaGetLastError());
}

// The launch cp_roofline makes for `chain` over n elements, into out[0..10]:
// SMs, blocks an SM holds without the shared-memory request, blocks per SM,
// grid, threads per block, dynamic shared memory per block, K, the unroll,
// and the split's full, rest and slots.  Returns a cudaError_t as an int.
extern "C" int cp_roofline_geometry(int chain, int n, int* out) {
  if (chain < 0 || chain >= NUM_CHAINS || (is_bf16(chain) && n % 2))
    return static_cast<int>(cudaErrorInvalidValue);
  Geometry g;
  const cudaError_t err = geometry(chain, is_bf16(chain) ? n / 2 : n, &g);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int values[] = {g.sms, g.max_blocks, g.blocks_per_sm, g.grid, THREADS, g.smem,
                        k_of(chain), unroll_of(chain), g.full, g.rest, g.slots};
  for (int i = 0; i < 11; ++i) out[i] = values[i];
  return 0;
}
