// Wire-compression kernels for Hopper (sm_90a): the q8 error-feedback
// quantizer (absmax pass + quantize pass) and the f32 -> bf16 cast that
// every compressed gradient step runs before its bytes leave the card,
// and the q8 decode.
//
// Replaces the Pallas kernels of torchft_tpu/ops/quantize_kernels.py:
//   tft_q8_absmax_seg   <- _absmax_kernel / _absmax     (pallas_call at :109)
//   tft_q8_quantize_seg <- _quant_kernel / _quantize_tiles (pallas_call at :175)
//   tft_q8_dequantize   <- _dequant_kernel / dequantize_q8 (pallas_call at :253)
//   tft_cast_bf16       <- _cast_kernel / cast_bf16     (pallas_call at :281)
//
// The contract is BIT identity with the JAX kernels and with the native
// plan_pack_ef (native/src/collectives.cc): the codes, the scale, the
// residual and the NaN bits must match, or a device-packing ring member
// drifts from a host-packing one. Every rounding is therefore spelled out:
// __fadd_rn / __fdiv_rn / __fmul_rn / __fsub_rn (no FMA contraction, no
// approximate divide), rintf (half to even), and the canonical NaN
// 0x7FC00000 written by hand. Build WITHOUT --use_fast_math.
//
// Bound on this card: all of them are pure streaming passes, so bytes
// bound them (3.35 TB/s of HBM on an H100 SXM). The absmax pass reads x
// and the residual (8 B/element); the quantize pass reads them again and
// writes the int8 code and the new residual (13 B/element). The cast
// reads 4 B and writes 2 B per element; the decode reads 1 B and writes
// 4 B.
//
// The q8 pair is SEGMENTED: one launch of each covers every leaf of a
// plan group. The TPU ran one small kernel per leaf; on this card a
// 512-element leaf would pay a whole launch and its tail on 132 SMs, so
// the leaves travel as a segment table instead (x, residual in and out,
// element count, offset in the group's code buffer), passed BY VALUE as a
// __grid_constant__ kernel parameter (up to 32,764 bytes on sm_90 with
// CUDA 12.1+): no host-to-device copy, legal inside graph capture, no
// host buffer to keep alive. Each segment is cut into kChunk-element
// chunks; a persistent grid (a few blocks per SM) walks the chunks with a
// grid stride and finds a chunk's segment by binary search over the
// table's chunk prefix sums (block-uniform, so the parameter reads
// broadcast). An empty segment owns one chunk of no elements, so its
// scale (the floor, 1e-12) is still written. Segments whose pointers are
// 16-byte aligned (and whose code offset is a multiple of 4) take float4
// loads and stores and char4 code stores, two of each per array per
// thread in flight; any other segment (a view at an odd storage offset, a
// code offset off the 4-byte grid) takes a scalar loop in the same
// kernel, chosen per segment by a flag the entry point computes.
//
// Across blocks the absmax merges with atomicMax on the uint32 bits of
// |d|, into the segment's own slot (one cudaMemsetAsync of all the slots
// per launch). max is order-free, so the result is deterministic, and any
// NaN's bits exceed +Inf's (0x7F800000), so a poisoned leaf carries its
// poison into the scale by construction (fmaxf would drop it). The
// quantize pass writes the codes at their offset in the group's
// concatenated code buffer, the scale at the segment's index, and the new
// residual to res_out, which may be the residual it read: each element is
// read and written by the same thread, so the carry advances in place.
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

// -- the segmented q8 pair (K1a, K1b) -----------------------------------------

// Segments one launch takes; a group with more goes out in several
// launches. sizeof(SegTable) is ~23 KB of the 32,764 B parameter space.
constexpr int kSegCapacity = 512;
// Elements per chunk: 8 per thread, two float4 of each input in flight.
constexpr int kChunk = 2048;
constexpr int kVecPerThread = kChunk / 4 / kThreads;
// Resident blocks per SM the persistent grid aims at (2048 threads).
constexpr int kBlocksPerSm = 8;

struct Seg {
  const float* x;    // the leaf, f32, contiguous
  const float* res;  // its error-feedback carry
  float* res_out;    // the new carry (may be res: written in place)
  int64_t n;         // elements
  int64_t code_off;  // first code's index in the group's code buffer
};

struct SegTable {
  Seg seg[kSegCapacity];
  int chunk_start[kSegCapacity + 1];  // prefix sums of chunks per segment
  unsigned char vec[kSegCapacity];    // 1: the float4/char4 path applies
  int count;
};

// Largest s with chunk_start[s] <= c (every segment owns >= 1 chunk).
__device__ __forceinline__ int find_segment(const SegTable& t, int c, int hint) {
  if (hint >= 0 && c >= t.chunk_start[hint] && c < t.chunk_start[hint + 1])
    return hint;
  int lo = 0, hi = t.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.chunk_start[mid] <= c) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// Elements of the chunk that starts at element e0 of an n-element segment.
__device__ __forceinline__ int chunk_len(int64_t n, int64_t e0) {
  return n - e0 < kChunk ? static_cast<int>(n - e0) : kChunk;
}

__device__ __forceinline__ unsigned int abs_bits(float x, float r) {
  // d = x + res, the EF-adjusted payload (one exact f32 add).
  return __float_as_uint(__fadd_rn(x, r)) & kAbsMask;
}

// Block-wide max of m into *slot (every thread of the block calls it).
__device__ __forceinline__ void flush_max(unsigned int m, unsigned int* slot,
                                          unsigned int* partial) {
  for (int off = 16; off > 0; off >>= 1)
    m = max(m, __shfl_down_sync(0xffffffffu, m, off));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) partial[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kThreads / 32 ? partial[lane] : 0u;
    for (int off = 16; off > 0; off >>= 1)
      m = max(m, __shfl_down_sync(0xffffffffu, m, off));
    if (lane == 0) atomicMax(slot, m);
  }
  __syncthreads();  // partial is reused by the next flush
}

__global__ void __launch_bounds__(kThreads)
q8_absmax_seg_kernel(const __grid_constant__ SegTable t,
                     unsigned int* __restrict__ out_bits) {
  __shared__ unsigned int partial[kThreads / 32];
  const int total = t.chunk_start[t.count];
  unsigned int m = 0;
  int cur = -1;
  for (int c = blockIdx.x; c < total; c += gridDim.x) {
    const int s = find_segment(t, c, cur);
    if (s != cur) {  // block-uniform: every thread walks the same chunks
      if (cur >= 0) flush_max(m, out_bits + cur, partial);
      cur = s;
      m = 0;
    }
    const Seg& g = t.seg[s];
    const int64_t e0 = static_cast<int64_t>(c - t.chunk_start[s]) * kChunk;
    const int len = chunk_len(g.n, e0);
    const float* x = g.x + e0;
    const float* r = g.res + e0;
    if (t.vec[s]) {
      const int nv = len >> 2;
      float4 a[kVecPerThread], b[kVecPerThread];
#pragma unroll
      for (int k = 0; k < kVecPerThread; ++k) {
        const int v = threadIdx.x + k * kThreads;
        if (v < nv) {
          a[k] = __ldg(reinterpret_cast<const float4*>(x) + v);
          b[k] = __ldg(reinterpret_cast<const float4*>(r) + v);
        }
      }
#pragma unroll
      for (int k = 0; k < kVecPerThread; ++k) {
        if (threadIdx.x + k * kThreads < nv) {
          m = max(m, max(max(abs_bits(a[k].x, b[k].x), abs_bits(a[k].y, b[k].y)),
                         max(abs_bits(a[k].z, b[k].z), abs_bits(a[k].w, b[k].w))));
        }
      }
      const int i = (nv << 2) + threadIdx.x;  // the ragged tail, < 4 elements
      if (i < len) m = max(m, abs_bits(x[i], r[i]));
    } else {
      for (int i = threadIdx.x; i < len; i += kThreads)
        m = max(m, abs_bits(x[i], r[i]));
    }
  }
  if (cur >= 0) flush_max(m, out_bits + cur, partial);
}

// scale = max(absmax / 127, 1e-12) with a true IEEE divide and a NaN that
// survives the floor (jnp.maximum semantics: fmaxf(NaN, 1e-12) would
// return 1e-12 and hide the poison).
__device__ __forceinline__ float raw_scale(unsigned int absmax_bits) {
  const float s = __fdiv_rn(__uint_as_float(absmax_bits), 127.0f);
  return (s < 1e-12f) ? 1e-12f : s;  // NaN compares false: stays NaN
}

// One element of a leaf with a finite scale (so every d is finite).
__device__ __forceinline__ int8_t quant1(float x, float r, float s,
                                         float* res_out) {
  const float d = __fadd_rn(x, r);
  float v = rintf(__fdiv_rn(d, s));
  v = fminf(fmaxf(v, -127.0f), 127.0f);
  // Two roundings, as the ring peers decode: d - round32(v * s).
  *res_out = __fsub_rn(d, __fmul_rn(v, s));
  return static_cast<int8_t>(v);
}

__global__ void __launch_bounds__(kThreads)
q8_quantize_seg_kernel(const __grid_constant__ SegTable t,
                       const unsigned int* __restrict__ absmax_bits,
                       int8_t* __restrict__ q, float* __restrict__ scale_out) {
  const int total = t.chunk_start[t.count];
  const float canon_nan = __uint_as_float(kCanonNaN);
  int cur = -1;
  float s = 0.0f;
  bool finite = false;
  for (int c = blockIdx.x; c < total; c += gridDim.x) {
    const int sg = find_segment(t, c, cur);
    if (sg != cur) {
      cur = sg;
      s = raw_scale(absmax_bits[sg]);
      finite = (__float_as_uint(s) & kAbsMask) < kInfBits;
    }
    const Seg& g = t.seg[sg];
    const int64_t e0 = static_cast<int64_t>(c - t.chunk_start[sg]) * kChunk;
    if (e0 == 0 && threadIdx.x == 0) scale_out[sg] = finite ? s : canon_nan;
    const int len = chunk_len(g.n, e0);
    const float* x = g.x + e0;
    const float* r = g.res + e0;
    float* ro = g.res_out + e0;
    int8_t* qo = q + g.code_off + e0;
    if (!finite) {
      // Non-finite leaf: codes zero, the NaN scale carries the signal
      // (0 * NaN decodes to NaN everywhere), the carry poisons.
      for (int i = threadIdx.x; i < len; i += kThreads) {
        qo[i] = 0;
        ro[i] = canon_nan;
      }
    } else if (t.vec[sg]) {
      const int nv = len >> 2;
      float4 a[kVecPerThread], b[kVecPerThread];
#pragma unroll
      for (int k = 0; k < kVecPerThread; ++k) {
        const int v = threadIdx.x + k * kThreads;
        if (v < nv) {
          a[k] = __ldg(reinterpret_cast<const float4*>(x) + v);
          // res may be res_out: an ordinary (coherent) load
          b[k] = reinterpret_cast<const float4*>(r)[v];
        }
      }
#pragma unroll
      for (int k = 0; k < kVecPerThread; ++k) {
        const int v = threadIdx.x + k * kThreads;
        if (v < nv) {
          float4 o;
          char4 cq;
          cq.x = quant1(a[k].x, b[k].x, s, &o.x);
          cq.y = quant1(a[k].y, b[k].y, s, &o.y);
          cq.z = quant1(a[k].z, b[k].z, s, &o.z);
          cq.w = quant1(a[k].w, b[k].w, s, &o.w);
          reinterpret_cast<char4*>(qo)[v] = cq;
          reinterpret_cast<float4*>(ro)[v] = o;
        }
      }
      const int i = (nv << 2) + threadIdx.x;  // the ragged tail, < 4 elements
      if (i < len) qo[i] = quant1(x[i], r[i], s, ro + i);
    } else {
      for (int i = threadIdx.x; i < len; i += kThreads)
        qo[i] = quant1(x[i], r[i], s, ro + i);
    }
  }
}

// Fills the table from `count` rows of five int64 (x, res, res_out, n,
// code_off); `code_base` is the code buffer (null for the absmax pass,
// whose flag then ignores res_out and the codes). Returns the chunks, or
// -1 for a table the kernels do not take.
int64_t fill_table(const int64_t* rows, int count, const void* code_base,
                   SegTable* t) {
  if (count < 1 || count > kSegCapacity) return -1;
  t->count = count;
  int64_t chunks = 0;
  for (int i = 0; i < count; ++i) {
    const int64_t* row = rows + 5 * i;
    Seg& g = t->seg[i];
    g.x = reinterpret_cast<const float*>(row[0]);
    g.res = reinterpret_cast<const float*>(row[1]);
    g.res_out = reinterpret_cast<float*>(row[2]);
    g.n = row[3];
    g.code_off = row[4];
    if (g.n < 0) return -1;
    uintptr_t wide = static_cast<uintptr_t>(row[0]) | static_cast<uintptr_t>(row[1]);
    bool vec;
    if (code_base == nullptr) {
      vec = (wide & 15u) == 0;
    } else {
      wide |= static_cast<uintptr_t>(row[2]);
      const uintptr_t codes = reinterpret_cast<uintptr_t>(code_base) +
                              static_cast<uintptr_t>(g.code_off);
      vec = (wide & 15u) == 0 && (codes & 3u) == 0;
    }
    t->vec[i] = vec ? 1 : 0;
    t->chunk_start[i] = static_cast<int>(chunks);
    chunks += g.n == 0 ? 1 : (g.n + kChunk - 1) / kChunk;
    if (chunks > INT32_MAX) return -1;
  }
  t->chunk_start[count] = static_cast<int>(chunks);
  return chunks;
}

int persistent_blocks(int64_t chunks) {
  static int sms[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (sms[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    sms[dev] = n > 0 ? n : 132;
  }
  const int64_t cap = static_cast<int64_t>(sms[dev]) * kBlocksPerSm;
  return static_cast<int>(chunks < cap ? chunks : cap);
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

int tft_q8_seg_capacity() { return kSegCapacity; }

// K1a over `count` (<= tft_q8_seg_capacity()) segments, rows of five
// int64 (x, res, res_out, n, code_off; the last two columns but n are
// ignored here): max |x + res| of segment i as uint32 bits into
// out_bits[i]. One cudaMemsetAsync of the slots, one launch.
int tft_q8_absmax_seg(const int64_t* rows, int count, void* out_bits,
                      void* stream) {
  SegTable t;
  const int64_t chunks = fill_table(rows, count, nullptr, &t);
  if (chunks < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out_bits, 0, sizeof(unsigned int) * count, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  q8_absmax_seg_kernel<<<persistent_blocks(chunks), kThreads, 0, st>>>(
      t, static_cast<unsigned int*>(out_bits));
  return static_cast<int>(cudaGetLastError());
}

// K1b over the same rows given K1a's absmax_bits: segment i's codes at
// q[code_off + j], its scale at scale_out[i], its new carry at res_out
// (which may equal res). One launch.
int tft_q8_quantize_seg(const int64_t* rows, int count,
                        const void* absmax_bits, void* q, void* scale_out,
                        void* stream) {
  SegTable t;
  const int64_t chunks = fill_table(rows, count, q, &t);
  if (chunks < 0) return static_cast<int>(cudaErrorInvalidValue);
  q8_quantize_seg_kernel<<<persistent_blocks(chunks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      t, static_cast<const unsigned int*>(absmax_bits),
      static_cast<int8_t*>(q), static_cast<float*>(scale_out));
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
