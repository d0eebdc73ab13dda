// Wire-compression kernels for Hopper (sm_90a): the q8 error-feedback
// quantizer (absmax pass + quantize pass) and the f32 -> bf16 cast that
// every compressed gradient step runs before its bytes leave the card,
// and the q8 decode.
//
// Replaces the Pallas kernels of torchft_tpu/ops/quantize_kernels.py:
//   tft_q8_absmax_seg     <- _absmax_kernel / _absmax     (pallas_call at :109)
//   tft_q8_quantize_seg   <- _quant_kernel / _quantize_tiles (pallas_call at :175)
//   tft_q8_dequantize_seg <- _dequant_kernel / dequantize_q8 (pallas_call at :253)
//   tft_cast_bf16_seg     <- _cast_kernel / cast_bf16     (pallas_call at :281)
//
// The contract is BIT identity with the JAX kernels and with the native
// plan_pack_ef (native/src/collectives.cc): the codes, the scale, the
// residual and the NaN bits must match, or a device-packing ring member
// drifts from a host-packing one. Every rounding is therefore spelled out:
// __fadd_rn / __fdiv_rn / __fmul_rn / __fsub_rn (no FMA contraction, no
// approximate divide), rintf (half to even), the bf16 rounding done on the
// integer bits, and the canonical NaNs written by hand. Build WITHOUT
// --use_fast_math.
//
// Bound on this card: all of them are pure streaming passes, so bytes
// bound them (3.35 TB/s of HBM on an H100 SXM). The absmax pass reads x
// and the residual (8 B/element); the quantize pass reads them again and
// writes the int8 code and the new residual (13 B/element). The cast
// reads 4 B and writes 2 B per element; the decode reads 1 B and writes
// 4 B.
//
// All four are SEGMENTED: one launch covers every leaf of a plan group.
// The TPU ran one small kernel per leaf; on this card a 512-element leaf
// would pay a whole launch and its tail on 132 SMs, so the leaves travel
// as a segment table instead, passed BY VALUE as a __grid_constant__
// kernel parameter (up to 32,764 bytes on sm_90 with CUDA 12.1+): no
// host-to-device copy, legal inside graph capture, no host buffer to keep
// alive. One template (SegTable) serves the four kernels; each kernel has
// its own row (a small Seg struct: pointers, element count, offset in the
// group's wire buffer). A table holds 64 segments (both LMs' groups fit
// one): the launch copies the whole parameter, and an eager launch of a
// 512-segment table (15-23 KB) cost ~30 us more on the host than the
// kernel itself. Each segment is cut into kChunk-element chunks, one block
// per chunk (a persistent grid walking the chunks measured 3-20% slower on
// every kernel); a block finds its segment by binary search over the
// table's chunk prefix sums (block-uniform, so the parameter reads
// broadcast). An empty segment owns one chunk of no elements, so its q8
// scale (the floor, 1e-12) is still written. A segment whose pointers and
// wire offset sit on the vector grid takes 16-byte loads of each f32
// array and stores of the same element count (char4 codes, four bf16
// words in 8 bytes), two per array per thread in flight, neighbouring
// threads on neighbouring addresses; any other segment (a view at an odd
// storage offset, a wire offset off the grid) takes a scalar loop in the
// same kernel, chosen per segment by a flag the entry point computes.
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
// The decode is its inverse layout: codes from the group's buffer at each
// segment's offset, the segment's scale read once per block, f32 out to
// the segment's own destination. The cast reads each f32 leaf
// in place and writes its bf16 words at the segment's offset in the
// group's wire buffer, so the bf16 pack needs no f32 concatenation.
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

// -- the segment table (shared by the four kernels) ---------------------------

// Segments one launch takes; a group with more goes out in several
// launches. sizeof(SegTable<Q8Seg>), the largest, is ~2.9 KB.
constexpr int kSegCapacity = 64;
// Elements per chunk (one block): 8 per thread, two vectors of four of
// each array in flight.
constexpr int kChunk = 2048;
constexpr int kVecPerThread = kChunk / 4 / kThreads;

template <class Row>
struct SegTable {
  Row seg[kSegCapacity];
  int chunk_start[kSegCapacity + 1];  // prefix sums of chunks per segment
  unsigned char vec[kSegCapacity];    // 1: the 16-byte path applies
  int count;
};

// The rows, as the entry points read them: Row::kWidth int64 per segment.
// Row::load fills the row from them and says whether the segment is on the
// vector grid; `base` is the launch's wire buffer (the codes of the q8
// kernels, the bf16 words of the cast; 0 for the absmax pass, which
// writes none).

// K1a/K1b: (x, res, res_out, n, code_off)
struct Q8Seg {
  static constexpr int kWidth = 5;
  const float* x;    // the leaf, f32, contiguous
  const float* res;  // its error-feedback carry
  float* res_out;    // the new carry (may be res: written in place)
  int64_t n;         // elements
  int64_t code_off;  // first code's index in the group's code buffer
  static bool load(const int64_t* row, uintptr_t codes, Q8Seg* g) {
    g->x = reinterpret_cast<const float*>(row[0]);
    g->res = reinterpret_cast<const float*>(row[1]);
    g->res_out = reinterpret_cast<float*>(row[2]);
    g->n = row[3];
    g->code_off = row[4];
    uintptr_t wide = static_cast<uintptr_t>(row[0]) | static_cast<uintptr_t>(row[1]);
    if (codes == 0) return (wide & 15u) == 0;
    wide |= static_cast<uintptr_t>(row[2]);
    return (wide & 15u) == 0 &&
           ((codes + static_cast<uintptr_t>(g->code_off)) & 3u) == 0;
  }
};

// K2: (dst, n, code_off); the scale is the segment's index in the scales
struct DequantSeg {
  static constexpr int kWidth = 3;
  float* dst;        // the decoded leaf, f32
  int64_t n;
  int64_t code_off;  // first code's index in the group's code buffer
  static bool load(const int64_t* row, uintptr_t codes, DequantSeg* g) {
    g->dst = reinterpret_cast<float*>(row[0]);
    g->n = row[1];
    g->code_off = row[2];
    return (static_cast<uintptr_t>(row[0]) & 15u) == 0 &&
           ((codes + static_cast<uintptr_t>(g->code_off)) & 3u) == 0;
  }
};

// K3: (src, n, dst_off)
struct CastSeg {
  static constexpr int kWidth = 3;
  const float* src;  // the leaf, f32, contiguous
  int64_t n;
  int64_t dst_off;   // first word's index in the group's bf16 buffer
  static bool load(const int64_t* row, uintptr_t words, CastSeg* g) {
    g->src = reinterpret_cast<const float*>(row[0]);
    g->n = row[1];
    g->dst_off = row[2];
    return (static_cast<uintptr_t>(row[0]) & 15u) == 0 &&
           ((words + 2 * static_cast<uintptr_t>(g->dst_off)) & 7u) == 0;
  }
};

static_assert(sizeof(SegTable<Q8Seg>) <= 4096, "a table past 4 KB costs its launch");

// Fills the table from `count` rows. Returns the chunks, or -1 for a table
// the kernels do not take.
template <class Row>
int64_t fill_table(const int64_t* rows, int count, uintptr_t base,
                   SegTable<Row>* t) {
  if (count < 1 || count > kSegCapacity) return -1;
  t->count = count;
  int64_t chunks = 0;
  for (int i = 0; i < count; ++i) {
    Row& g = t->seg[i];
    t->vec[i] = Row::load(rows + Row::kWidth * i, base, &g) ? 1 : 0;
    if (g.n < 0) return -1;
    t->chunk_start[i] = static_cast<int>(chunks);
    chunks += g.n == 0 ? 1 : (g.n + kChunk - 1) / kChunk;
    if (chunks > INT32_MAX) return -1;
  }
  t->chunk_start[count] = static_cast<int>(chunks);
  return chunks;
}

// This block's chunk: its segment (the largest s with chunk_start[s] <=
// blockIdx.x; every segment owns >= 1 chunk), its first element in the
// segment and its length.
struct Chunk {
  int s;
  int64_t e0;
  int len;
};

template <class Row>
__device__ __forceinline__ Chunk block_chunk(const SegTable<Row>& t) {
  const int c = blockIdx.x;
  int lo = 0, hi = t.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.chunk_start[mid] <= c) lo = mid; else hi = mid - 1;
  }
  const int64_t e0 = static_cast<int64_t>(c - t.chunk_start[lo]) * kChunk;
  const int64_t left = t.seg[lo].n - e0;
  return {lo, e0, left < kChunk ? static_cast<int>(left) : kChunk};
}

// -- K1a/K1b: the q8 error-feedback pair --------------------------------------

__device__ __forceinline__ unsigned int abs_bits(float x, float r) {
  // d = x + res, the EF-adjusted payload (one exact f32 add).
  return __float_as_uint(__fadd_rn(x, r)) & kAbsMask;
}

// Block-wide max of m into *slot (every thread of the block calls it).
__device__ __forceinline__ void flush_max(unsigned int m, unsigned int* slot) {
  __shared__ unsigned int partial[kThreads / 32];
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
}

__global__ void __launch_bounds__(kThreads)
q8_absmax_seg_kernel(const __grid_constant__ SegTable<Q8Seg> t,
                     unsigned int* __restrict__ out_bits) {
  const Chunk ch = block_chunk(t);
  const Q8Seg& g = t.seg[ch.s];
  const float* x = g.x + ch.e0;
  const float* r = g.res + ch.e0;
  unsigned int m = 0;
  if (t.vec[ch.s]) {
    const int nv = ch.len >> 2;
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
    if (i < ch.len) m = max(m, abs_bits(x[i], r[i]));
  } else {
    for (int i = threadIdx.x; i < ch.len; i += kThreads)
      m = max(m, abs_bits(x[i], r[i]));
  }
  flush_max(m, out_bits + ch.s);
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
q8_quantize_seg_kernel(const __grid_constant__ SegTable<Q8Seg> t,
                       const unsigned int* __restrict__ absmax_bits,
                       int8_t* __restrict__ q, float* __restrict__ scale_out) {
  const float canon_nan = __uint_as_float(kCanonNaN);
  const Chunk ch = block_chunk(t);
  const float s = raw_scale(absmax_bits[ch.s]);
  const bool finite = (__float_as_uint(s) & kAbsMask) < kInfBits;
  if (ch.e0 == 0 && threadIdx.x == 0) scale_out[ch.s] = finite ? s : canon_nan;
  const Q8Seg& g = t.seg[ch.s];
  const int len = ch.len;
  const float* x = g.x + ch.e0;
  const float* r = g.res + ch.e0;
  float* ro = g.res_out + ch.e0;
  int8_t* qo = q + g.code_off + ch.e0;
  if (!finite) {
    // Non-finite leaf: codes zero, the NaN scale carries the signal
    // (0 * NaN decodes to NaN everywhere), the carry poisons.
    for (int i = threadIdx.x; i < len; i += kThreads) {
      qo[i] = 0;
      ro[i] = canon_nan;
    }
  } else if (t.vec[ch.s]) {
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

// -- K2: the q8 decode ----------------------------------------------------------

// round32(float(q) * scale); every NaN (a NaN scale poisons the leaf, an
// Inf scale gives NaN for a zero code) is written as the canonical
// 0x7FC00000: the card's arithmetic would give 0x7FFFFFFF, the host's
// decode keeps the scale's 0x7FC00000.
__device__ __forceinline__ float dequant1(int q, float s) {
  const float r = __fmul_rn(static_cast<float>(q), s);
  return (__float_as_uint(r) & kAbsMask) > kInfBits ? __uint_as_float(kCanonNaN) : r;
}

// The four int8 codes of a 32-bit word (little-endian), decoded.
__device__ __forceinline__ float4 dequant4(unsigned int w, float s) {
  // each byte moved to the top, then sign-extended by an arithmetic shift
  return make_float4(dequant1(static_cast<int>(w << 24) >> 24, s),
                     dequant1(static_cast<int>(w << 16) >> 24, s),
                     dequant1(static_cast<int>(w << 8) >> 24, s),
                     dequant1(static_cast<int>(w) >> 24, s));
}

__global__ void __launch_bounds__(kThreads)
q8_dequantize_seg_kernel(const __grid_constant__ SegTable<DequantSeg> t,
                         const int8_t* __restrict__ q,
                         const float* __restrict__ scales) {
  const Chunk ch = block_chunk(t);
  const float s = scales[ch.s];  // block-uniform: one read per block
  const DequantSeg& g = t.seg[ch.s];
  const int len = ch.len;
  const int8_t* qi = q + g.code_off + ch.e0;
  float* o = g.dst + ch.e0;
  if (t.vec[ch.s]) {
    // 4-byte loads of four codes and float4 stores, two of each per
    // thread in flight (one 8-byte load of eight codes per thread, with
    // its two float4 stores 32 bytes apart, measured 13-24% slower)
    const int nv = len >> 2;
    unsigned int w[kVecPerThread];
#pragma unroll
    for (int k = 0; k < kVecPerThread; ++k) {
      const int v = threadIdx.x + k * kThreads;
      if (v < nv) w[k] = __ldg(reinterpret_cast<const unsigned int*>(qi) + v);
    }
#pragma unroll
    for (int k = 0; k < kVecPerThread; ++k) {
      const int v = threadIdx.x + k * kThreads;
      if (v < nv) reinterpret_cast<float4*>(o)[v] = dequant4(w[k], s);
    }
    const int i = (nv << 2) + threadIdx.x;  // the ragged tail, < 4 elements
    if (i < len) o[i] = dequant1(qi[i], s);
  } else {
    for (int i = threadIdx.x; i < len; i += kThreads) o[i] = dequant1(qi[i], s);
  }
}

// -- K3: the bf16 wire cast -----------------------------------------------------

// f32 -> bf16 bits: round to nearest even on the integer bits (Inf and
// overflow to Inf fall out of the same carry); every NaN becomes
// sign | 0x7FC0, as XLA and ml_dtypes give it. Neither
// __float2bfloat16_rn nor cvt.rn.bf16x2.f32 promises those NaN bits, and
// the wire depends on them (a high-mantissa NaN must not round into Inf
// or -0.0 downstream).
__device__ __forceinline__ unsigned int bf16_bits(float x) {
  const unsigned int b = __float_as_uint(x);
  if ((b & kAbsMask) > kInfBits) return ((b >> 16) & 0x8000u) | 0x7FC0u;
  return (b + 0x7FFFu + ((b >> 16) & 1u)) >> 16;
}

// Four bf16 words of a float4, packed little-endian into 8 bytes.
__device__ __forceinline__ uint2 bf16x4(float4 a) {
  return make_uint2(bf16_bits(a.x) | (bf16_bits(a.y) << 16),
                    bf16_bits(a.z) | (bf16_bits(a.w) << 16));
}

__global__ void __launch_bounds__(kThreads)
cast_bf16_seg_kernel(const __grid_constant__ SegTable<CastSeg> t,
                     uint16_t* __restrict__ out) {
  const Chunk ch = block_chunk(t);
  const CastSeg& g = t.seg[ch.s];
  const int len = ch.len;
  const float* x = g.src + ch.e0;
  uint16_t* o = out + g.dst_off + ch.e0;
  if (t.vec[ch.s]) {
    // float4 loads and 8-byte stores of four words, two of each per
    // thread in flight
    const int nv = len >> 2;
    float4 a[kVecPerThread];
#pragma unroll
    for (int k = 0; k < kVecPerThread; ++k) {
      const int v = threadIdx.x + k * kThreads;
      if (v < nv) a[k] = __ldg(reinterpret_cast<const float4*>(x) + v);
    }
#pragma unroll
    for (int k = 0; k < kVecPerThread; ++k) {
      const int v = threadIdx.x + k * kThreads;
      if (v < nv) reinterpret_cast<uint2*>(o)[v] = bf16x4(a[k]);
    }
    const int i = (nv << 2) + threadIdx.x;  // the ragged tail, < 4 elements
    if (i < len) o[i] = static_cast<uint16_t>(bf16_bits(x[i]));
  } else {
    for (int i = threadIdx.x; i < len; i += kThreads)
      o[i] = static_cast<uint16_t>(bf16_bits(x[i]));
  }
}

}  // namespace

extern "C" {

int tft_seg_capacity() { return kSegCapacity; }

// Each segmented entry point takes `count` (<= tft_seg_capacity()) rows of
// its kernel's width, one per segment, and launches once.

// K1a over rows of five int64 (x, res, res_out, n, code_off; the last two
// columns but n are ignored here): max |x + res| of segment i as uint32
// bits into out_bits[i]. One cudaMemsetAsync of the slots, one launch.
int tft_q8_absmax_seg(const int64_t* rows, int count, void* out_bits,
                      void* stream) {
  SegTable<Q8Seg> t;
  const int64_t chunks = fill_table(rows, count, 0, &t);
  if (chunks < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out_bits, 0, sizeof(unsigned int) * count, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  q8_absmax_seg_kernel<<<static_cast<int>(chunks), kThreads, 0, st>>>(
      t, static_cast<unsigned int*>(out_bits));
  return static_cast<int>(cudaGetLastError());
}

// K1b over the same rows given K1a's absmax_bits: segment i's codes at
// q[code_off + j], its scale at scale_out[i], its new carry at res_out
// (which may equal res).
int tft_q8_quantize_seg(const int64_t* rows, int count,
                        const void* absmax_bits, void* q, void* scale_out,
                        void* stream) {
  SegTable<Q8Seg> t;
  const int64_t chunks = fill_table(rows, count, reinterpret_cast<uintptr_t>(q), &t);
  if (chunks < 0) return static_cast<int>(cudaErrorInvalidValue);
  q8_quantize_seg_kernel<<<static_cast<int>(chunks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      t, static_cast<const unsigned int*>(absmax_bits),
      static_cast<int8_t*>(q), static_cast<float*>(scale_out));
  return static_cast<int>(cudaGetLastError());
}

// K2 over rows of three int64 (dst, n, code_off): segment i's codes
// q[code_off + j] times scales[i] into dst[j], f32.
int tft_q8_dequantize_seg(const int64_t* rows, int count, const void* q,
                          const void* scales, void* stream) {
  SegTable<DequantSeg> t;
  const int64_t chunks = fill_table(rows, count, reinterpret_cast<uintptr_t>(q), &t);
  if (chunks < 0) return static_cast<int>(cudaErrorInvalidValue);
  q8_dequantize_seg_kernel<<<static_cast<int>(chunks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      t, static_cast<const int8_t*>(q), static_cast<const float*>(scales));
  return static_cast<int>(cudaGetLastError());
}

// K3 over rows of three int64 (src, n, dst_off): segment i's f32 elements
// as bf16 words into out[dst_off + j].
int tft_cast_bf16_seg(const int64_t* rows, int count, void* out, void* stream) {
  SegTable<CastSeg> t;
  const int64_t chunks = fill_table(rows, count, reinterpret_cast<uintptr_t>(out), &t);
  if (chunks < 0) return static_cast<int>(cudaErrorInvalidValue);
  cast_bf16_seg_kernel<<<static_cast<int>(chunks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      t, static_cast<uint16_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* tft_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
