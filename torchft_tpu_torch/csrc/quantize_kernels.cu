// Wire-compression kernels for Hopper (sm_90a): the q8 error-feedback
// quantizer (absmax pass + quantize pass) and the f32 -> bf16 cast that
// every compressed gradient step runs before its bytes leave the card,
// and the q8 decode.
//
// Replaces the Pallas kernels of torchft_tpu/ops/quantize_kernels.py:
//   tft_q8_absmax   <- _absmax_kernel / _absmax     (pallas_call at :109)
//   tft_q8_quantize <- _quant_kernel / _quantize_tiles (pallas_call at :175)
//   tft_q8_dequantize <- _dequant_kernel / dequantize_q8 (pallas_call at :253)
//   tft_cast_bf16   <- _cast_kernel / cast_bf16     (pallas_call at :281)
//
// The contract is BIT identity with the JAX kernels and with the native
// plan_pack_ef (native/src/collectives.cc): the codes, the scale, the
// residual and the NaN bits must match, or a device-packing ring member
// drifts from a host-packing one. Every rounding is therefore spelled out:
// __fadd_rn / __fdiv_rn / __fmul_rn / __fsub_rn (no FMA contraction, no
// approximate divide), rintf (half to even), and the canonical NaN
// 0x7FC00000 written by hand. Build WITHOUT --use_fast_math.
//
// Bound on this card: all three are pure streaming passes, so bytes bound
// them (3.35 TB/s of HBM on an H100 SXM). The q8 pair must at least read x
// and the residual and write the codes and the new residual: 13 B/element
// (the two-pass design reads x and res twice, 21 B/element). The cast reads
// 4 B and writes 2 B per element; the decode reads 1 B and writes 4 B.
//
// GPU design: blocks run in parallel and in no order, unlike the TPU's
// sequential grid that carried the running max in the output block. The
// absmax is reduced per block (warp shuffles, then one warp over the
// block's partials) and merged across blocks with atomicMax on the uint32
// bits of |d|. max is order-free, so the result is deterministic, and any
// NaN's bits exceed +Inf's (0x7F800000), so a poisoned leaf carries its
// poison into the scale by construction (fmaxf would drop it).
//
// C interface (route (b): nvcc -> .so, bound with ctypes). Each entry
// point launches on the caller's stream, never synchronises, and returns
// cudaGetLastError() (0 = success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned int kCanonNaN = 0x7FC00000u;
constexpr unsigned int kAbsMask = 0x7FFFFFFFu;
constexpr unsigned int kInfBits = 0x7F800000u;
constexpr int kThreads = 256;
// Enough blocks to fill 132 SMs several times over; each thread then walks
// the leaf with a grid stride.
constexpr int64_t kMaxBlocks = 132 * 8;

int blocks_for(int64_t n) {
  int64_t b = (n + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return static_cast<int>(b);
}

__global__ void absmax_kernel(const float* __restrict__ x,
                              const float* __restrict__ res, int64_t n,
                              unsigned int* __restrict__ out_bits) {
  unsigned int m = 0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    // d = x + res, the EF-adjusted payload (one exact f32 add).
    const float d = __fadd_rn(x[i], res[i]);
    m = max(m, __float_as_uint(d) & kAbsMask);
  }
  for (int off = 16; off > 0; off >>= 1)
    m = max(m, __shfl_down_sync(0xffffffffu, m, off));
  __shared__ unsigned int partial[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) partial[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < static_cast<int>(blockDim.x >> 5) ? partial[lane] : 0u;
    for (int off = 16; off > 0; off >>= 1)
      m = max(m, __shfl_down_sync(0xffffffffu, m, off));
    if (lane == 0) atomicMax(out_bits, m);
  }
}

// scale = max(absmax / 127, 1e-12) with a true IEEE divide and a NaN that
// survives the floor (jnp.maximum semantics: fmaxf(NaN, 1e-12) would
// return 1e-12 and hide the poison).
__device__ __forceinline__ float raw_scale(unsigned int absmax_bits) {
  const float s = __fdiv_rn(__uint_as_float(absmax_bits), 127.0f);
  return (s < 1e-12f) ? 1e-12f : s;  // NaN compares false: stays NaN
}

__global__ void quantize_kernel(const float* __restrict__ x,
                                const float* __restrict__ res,
                                const unsigned int* __restrict__ absmax_bits,
                                int64_t n, int8_t* __restrict__ q,
                                float* __restrict__ res_out,
                                float* __restrict__ scale_out) {
  const float s = raw_scale(*absmax_bits);
  const bool finite = (__float_as_uint(s) & kAbsMask) < kInfBits;
  const float canon_nan = __uint_as_float(kCanonNaN);
  if (blockIdx.x == 0 && threadIdx.x == 0) *scale_out = finite ? s : canon_nan;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    if (finite) {
      const float d = __fadd_rn(x[i], res[i]);
      // A finite scale means every d is finite, so v is too.
      float v = rintf(__fdiv_rn(d, s));
      v = fminf(fmaxf(v, -127.0f), 127.0f);
      q[i] = static_cast<int8_t>(v);
      // Two roundings, as the ring peers decode: d - round32(v * s).
      res_out[i] = __fsub_rn(d, __fmul_rn(v, s));
    } else {
      // Non-finite leaf: codes zero, the NaN scale carries the signal
      // (0 * NaN decodes to NaN everywhere), the carry poisons.
      q[i] = 0;
      res_out[i] = canon_nan;
    }
  }
}

// out = round32(float(q) * scale); every NaN (a NaN scale poisons the
// leaf) is written as the canonical 0x7FC00000: the card's arithmetic
// would give 0x7FFFFFFF, the host's decode keeps the scale's 0x7FC00000.
__global__ void dequantize_kernel(const int8_t* __restrict__ q,
                                  const float* __restrict__ scale, int64_t n,
                                  float* __restrict__ out) {
  const float s = *scale;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const float r = __fmul_rn(static_cast<float>(q[i]), s);
    out[i] = (__float_as_uint(r) & kAbsMask) > kInfBits
                 ? __uint_as_float(kCanonNaN) : r;
  }
}

__global__ void cast_bf16_kernel(const float* __restrict__ x, int64_t n,
                                 uint16_t* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const unsigned int b = __float_as_uint(x[i]);
    unsigned int r;
    if ((b & kAbsMask) > kInfBits) {
      // Every NaN becomes sign | 0x7FC0, as XLA and ml_dtypes give it;
      // __float2bfloat16_rn promises no particular NaN bits.
      r = ((b >> 16) & 0x8000u) | 0x7FC0u;
    } else {
      // Round to nearest even on the integer bits (Inf and overflow to
      // Inf fall out of the same carry).
      r = (b + 0x7FFFu + ((b >> 16) & 1u)) >> 16;
    }
    out[i] = static_cast<uint16_t>(r);
  }
}

}  // namespace

extern "C" {

int tft_q8_absmax(const void* x, const void* res, int64_t n, void* out_bits,
                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out_bits, 0, sizeof(unsigned int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  absmax_kernel<<<blocks_for(n), kThreads, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(res), n,
      static_cast<unsigned int*>(out_bits));
  return static_cast<int>(cudaGetLastError());
}

int tft_q8_quantize(const void* x, const void* res, const void* absmax_bits,
                    int64_t n, void* q, void* res_out, void* scale_out,
                    void* stream) {
  quantize_kernel<<<blocks_for(n), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(res),
      static_cast<const unsigned int*>(absmax_bits), n,
      static_cast<int8_t*>(q), static_cast<float*>(res_out),
      static_cast<float*>(scale_out));
  return static_cast<int>(cudaGetLastError());
}

int tft_q8_dequantize(const void* q, const void* scale, int64_t n, void* out,
                      void* stream) {
  dequantize_kernel<<<blocks_for(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scale), n,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

int tft_cast_bf16(const void* x, int64_t n, void* out, void* stream) {
  cast_bf16_kernel<<<blocks_for(n), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n, static_cast<uint16_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* tft_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
