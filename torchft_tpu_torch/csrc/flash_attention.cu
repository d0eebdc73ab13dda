// Flash attention for Hopper (sm_90a): the online-softmax forward and the
// backward of the flagship LM's attention, reading q/k/v in the strided
// (B, S, H, D) layout the qkv split yields.
//
// Replaces the Pallas kernels of torchft_tpu/ops/flash_attention.py:
//   tft_flash_fwd      <- _fwd_kernel / _flash_fwd_call (pallas_call at :261)
//   tft_flash_bwd_dkdv <- _bwd_kernel / _flash_bwd_call (pallas_call at :382),
//   tft_flash_bwd_dq      the fused backward split in two (see below)
//
// Numerics (the contract of _fwd_kernel/_bwd_kernel):
// - q arrives pre-scaled by sm_scale; scores are q . k^T accumulated in f32
//   from the input dtype (each element widened exactly to f32).
// - The fast path (causal, no window, block_q == block_k) masks with the
//   finite -1e30 and has no guards; the general path masks with -inf and
//   guards exp against rows with every key masked (out 0, lse -inf).
// - Forward: p is rounded to v's dtype before p.v; out = acc / max(l, 1e-30)
//   rounded to the input dtype; lse = m + log(l) in f32.
// - Backward: p = exp(s - lse), masked with a select (0 * inf would give
//   NaN); dv += p^T . do with p in do's dtype; dp = do . v^T;
//   ds = p * (dp - delta) rounded once to q's dtype and used for both
//   dk += ds^T . q and dq += ds . k; dq stays f32 until its store.
// - Every load past S is bound-checked and zero-filled, and masks always
//   include the bounds: the GPU needs no padding in memory.
// Build WITHOUT --use_fast_math: expf/logf and the divide must be the
// accurate ones.
//
// GPU design. The TPU backward walks key blocks and accumulates dq in a
// revisited output block, in order only because the TPU grid is
// sequential (flash_attention.py:303-309). Blocks of a GPU grid run in
// parallel and in no order, and a float atomicAdd into dq would make the
// sums' order, and so the bits, change from run to run. The backward is
// therefore two kernels, each owning its outputs: dkdv (grid over key
// tiles, loop over query tiles) and dq (grid over query tiles, loop over
// key tiles). Both rebuild p from lse, so the backward computes the
// scores and dp = do . v^T twice: 7 tile products per tile pair instead
// of the fused kernel's 5 (and two exp passes instead of one). Results
// are bit-identical run to run; the two kernels also form s and dp with
// the same f32 FMA chain in the same order, so their ds agree bit for bit.
//
// This is the simple kernel that is right first: one CTA of 256 threads
// per (batch*head, 64-row tile), tiles staged through shared memory as
// f32 (rows padded to D+1 floats: conflict-free column walks), every
// product a register-tiled scalar f32 FMA loop (4 x BN/16 scores per
// thread; each thread's 4 rows are reduced over the 16 lanes that share
// them with xor shuffles). No tensor cores, no TMA, no double buffering.
//
// Bound on this card (H100 SXM) at the path's shape (B16 H16 S2047 D64,
// causal, bf16): operations. The minimal work is 2 S^2 D per (b, h)
// forward (two products over the causal half) and 5 S^2 D backward, at
// 989 TFLOP/s bf16 dense; the bytes (q, k, v, out, lse once each) are
// several times smaller. These scalar loops reach a few percent of that
// bound; tensor cores (mma.sync / wgmma) are the next step.
//
// C interface (route (b): nvcc -> .so, bound with ctypes). Each entry
// point launches on the caller's stream, never synchronises, and returns
// cudaGetLastError() (0 = success); tft_cuda_error_string is in
// quantize_kernels.cu.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 64;  // query rows per tile; also the dkdv query tile
constexpr float kNegLarge = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse_in;
  const float* delta;
  void* out0;  // fwd: out; dkdv: dk; dq: dq
  void* out1;  // fwd: lse (f32); dkdv: dv
  int B, S, H;
  // (batch, seq, head) strides in elements of q, k, v, do; the last dim
  // is contiguous. Outputs are contiguous (B, S, H, D); lse and delta
  // are contiguous (B, H, S) f32.
  int64_t sq[3], sk[3], sv[3], sdo[3];
  int causal, window, fast;  // window 0: none
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
// x rounded to T's precision, kept as f32 (the .astype(T) before a product)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float row_max16(float x) {
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum16(float x) {
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Loads rows [r0, r0 + rows) of one (b, h) slice into shared memory as f32
// with row stride ld, zero-filling rows at or past S.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          int64_t row_stride, int r0, int rows,
                                          int S) {
  for (int e = threadIdx.x; e < rows * D; e += kThreads) {
    const int r = e / D, d = e % D;
    const int s = r0 + r;
    dst[r * ld + d] = s < S ? to_f32(src[s * row_stride + d]) : 0.f;
  }
}

__device__ __forceinline__ bool live(const Args& a, int qpos, int kpos) {
  return qpos < a.S && kpos < a.S && (!a.causal || qpos >= kpos) &&
         (a.window <= 0 || qpos - kpos < a.window);
}

// Does the (rows_q from q0) x (cols_k from k0) tile hold a masked element?
__device__ __forceinline__ bool tile_masked(const Args& a, int q0, int rows_q,
                                           int k0, int cols_k) {
  return (a.causal && k0 + cols_k - 1 > q0) ||
         (a.window > 0 && q0 + rows_q - 1 - k0 >= a.window) ||
         q0 + rows_q > a.S || k0 + cols_k > a.S;
}

// Key tiles [lo, hi) a query tile starting at q0 sees (causal: none past
// its last row; window: none wholly left of its first row's window).
template <int BN>
__device__ __forceinline__ void key_range(const Args& a, int q0, int* lo,
                                          int* hi) {
  const int num_k = (a.S + BN - 1) / BN;
  *hi = a.causal ? min(num_k, (q0 + kBM + BN - 1) / BN) : num_k;
  *lo = a.window > 0 ? max(0, q0 - a.window + 1) / BN : 0;
}

// ---------------------------------------------------------------------------
// K4 forward: out, lse
// ---------------------------------------------------------------------------

template <typename T, int D, int BN>
constexpr size_t fwd_smem() {
  return sizeof(float) * (kBM * (D + 1) + BN * (D + 1) + BN * D + kBM * (BN + 1));
}

template <typename T, int D, int BN>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Args a) {
  constexpr int CN = BN / 16;  // score columns per thread
  constexpr int CD = D / 16;   // output columns per thread
  constexpr int LD = D + 1, LP = BN + 1;
  extern __shared__ float smem[];
  float* Qs = smem;             // [kBM][LD]
  float* Ks = Qs + kBM * LD;    // [BN][LD]
  float* Vs = Ks + BN * LD;     // [BN][D]
  float* Ps = Vs + BN * D;      // [kBM][LP]
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
  // the causal grid's heaviest tiles (last rows) start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H, S = a.S;
  const T* q = static_cast<const T*>(a.q) + b * a.sq[0] + h * a.sq[2];
  const T* k = static_cast<const T*>(a.k) + b * a.sk[0] + h * a.sk[2];
  const T* v = static_cast<const T*>(a.v) + b * a.sv[0] + h * a.sv[2];
  const bool fast = a.fast;
  const float neg = fast ? kNegLarge : -INFINITY;

  load_tile<T, D>(Qs, LD, q, a.sq[1], q0, kBM, S);
  float m[4], l[4], acc[4][CD];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = neg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }
  int lo, hi;
  key_range<BN>(a, q0, &lo, &hi);
  for (int j = lo; j < hi; ++j) {
    const int k0 = j * BN;
    __syncthreads();  // the last tile's readers are done with Ks/Vs/Ps
    load_tile<T, D>(Ks, LD, k, a.sk[1], k0, BN, S);
    load_tile<T, D>(Vs, D, v, a.sv[1], k0, BN, S);
    __syncthreads();
    float s[4][CN];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < CN; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[CN];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(tr * 4 + i) * LD + d];
#pragma unroll
      for (int c = 0; c < CN; ++c) kv[c] = Ks[(tc + 16 * c) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CN; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }
    if (tile_masked(a, q0, kBM, k0, BN)) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CN; ++c)
          if (!live(a, q0 + tr * 4 + i, k0 + tc + 16 * c)) s[i][c] = neg;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mt = s[i][0];
#pragma unroll
      for (int c = 1; c < CN; ++c) mt = fmaxf(mt, s[i][c]);
      const float m_new = fmaxf(m[i], row_max16(mt));
      float corr, psum = 0.f;
      if (fast) {
        // every row has a live key (its own position), so m_new is finite
        // and exp(-1e30 - m_new) underflows to exactly 0
#pragma unroll
        for (int c = 0; c < CN; ++c) {
          s[i][c] = expf(s[i][c] - m_new);
          psum += s[i][c];
        }
        corr = expf(m[i] - m_new);
      } else {
        const float safe_m = isfinite(m_new) ? m_new : 0.f;
#pragma unroll
        for (int c = 0; c < CN; ++c) {
          s[i][c] = isfinite(s[i][c]) ? expf(s[i][c] - safe_m) : 0.f;
          psum += s[i][c];
        }
        corr = isfinite(m[i]) ? expf(m[i] - safe_m) : 0.f;
      }
      l[i] = l[i] * corr + row_sum16(psum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] *= corr;
#pragma unroll
      for (int c = 0; c < CN; ++c)
        Ps[(tr * 4 + i) * LP + tc + 16 * c] = round_to<T>(s[i][c]);
    }
    __syncthreads();
#pragma unroll 4
    for (int n = 0; n < BN; ++n) {
      float vv[CD];
#pragma unroll
      for (int c = 0; c < CD; ++c) vv[c] = Vs[n * D + tc + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[(tr * 4 + i) * LP + n];
#pragma unroll
        for (int c = 0; c < CD; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }
  T* out = static_cast<T*>(a.out0);
  float* lse = static_cast<float*>(a.out1) + static_cast<int64_t>(bh) * S;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + tr * 4 + i;
    if (r >= S) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
    T* orow = out + ((static_cast<int64_t>(b) * S + r) * a.H + h) * D;
#pragma unroll
    for (int c = 0; c < CD; ++c) orow[tc + 16 * c] = from_f32<T>(acc[i][c] / l_safe);
    if (tc == 0)
      lse[r] = (fast || isfinite(m[i])) ? m[i] + logf(l_safe) : -INFINITY;
  }
}

// ---------------------------------------------------------------------------
// K5 backward, part 1: dk, dv (grid over key tiles, loop over query tiles)
// ---------------------------------------------------------------------------

template <typename T, int D, int BN>
constexpr size_t dkdv_smem() {
  return sizeof(float) *
         (2 * BN * (D + 1) + 2 * kBM * (D + 1) + 2 * BN * (kBM + 1) + 2 * kBM);
}

template <typename T, int D, int BN>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(Args a) {
  constexpr int RK = BN / 16;   // key rows per thread
  constexpr int CQ = kBM / 16;  // query columns per thread
  constexpr int CD = D / 16;    // dk/dv columns per thread
  constexpr int LD = D + 1, LP = kBM + 1;
  extern __shared__ float smem[];
  float* Ks = smem;              // [BN][LD]
  float* Vs = Ks + BN * LD;      // [BN][LD]
  float* Qs = Vs + BN * LD;      // [kBM][LD]
  float* dOs = Qs + kBM * LD;    // [kBM][LD]
  float* Ps = dOs + kBM * LD;    // [BN][LP]  p^T in do's dtype
  float* dSs = Ps + BN * LP;     // [BN][LP]  ds^T in q's dtype
  float* lse_s = dSs + BN * LP;  // [kBM]
  float* delta_s = lse_s + kBM;  // [kBM]
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
  const int k0 = blockIdx.x * BN;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H, S = a.S;
  const T* q = static_cast<const T*>(a.q) + b * a.sq[0] + h * a.sq[2];
  const T* k = static_cast<const T*>(a.k) + b * a.sk[0] + h * a.sk[2];
  const T* v = static_cast<const T*>(a.v) + b * a.sv[0] + h * a.sv[2];
  const T* dout = static_cast<const T*>(a.dout) + b * a.sdo[0] + h * a.sdo[2];
  const float* lse = a.lse_in + static_cast<int64_t>(bh) * S;
  const float* delta = a.delta + static_cast<int64_t>(bh) * S;

  load_tile<T, D>(Ks, LD, k, a.sk[1], k0, BN, S);
  load_tile<T, D>(Vs, LD, v, a.sv[1], k0, BN, S);
  float dk[RK][CD], dv[RK][CD];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int c = 0; c < CD; ++c) dk[i][c] = dv[i][c] = 0.f;

  const int num_q = (S + kBM - 1) / kBM;
  const int lo = a.causal ? k0 / kBM : 0;
  // window: the last query that sees this tile's last key is k + w - 1
  const int hi = a.window > 0 ? min(num_q, (k0 + BN - 2 + a.window) / kBM + 1)
                              : num_q;
  for (int it = lo; it < hi; ++it) {
    const int q0 = it * kBM;
    __syncthreads();  // the last tile's readers are done
    load_tile<T, D>(Qs, LD, q, a.sq[1], q0, kBM, S);
    load_tile<T, D>(dOs, LD, dout, a.sdo[1], q0, kBM, S);
    for (int r = threadIdx.x; r < kBM; r += kThreads) {
      lse_s[r] = q0 + r < S ? lse[q0 + r] : 0.f;
      delta_s[r] = q0 + r < S ? delta[q0 + r] : 0.f;
    }
    __syncthreads();
    // s^T = k . q^T and dp^T = v . do^T, rows keys, columns queries
    float st[RK][CQ], dpt[RK][CQ];
#pragma unroll
    for (int i = 0; i < RK; ++i)
#pragma unroll
      for (int c = 0; c < CQ; ++c) st[i][c] = dpt[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[RK], vv[RK], qv[CQ], ov[CQ];
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        kv[i] = Ks[(tr * RK + i) * LD + d];
        vv[i] = Vs[(tr * RK + i) * LD + d];
      }
#pragma unroll
      for (int c = 0; c < CQ; ++c) {
        qv[c] = Qs[(tc + 16 * c) * LD + d];
        ov[c] = dOs[(tc + 16 * c) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int c = 0; c < CQ; ++c) {
          st[i][c] = fmaf(qv[c], kv[i], st[i][c]);
          dpt[i][c] = fmaf(ov[c], vv[i], dpt[i][c]);
        }
    }
    const bool masked = tile_masked(a, q0, kBM, k0, BN);
#pragma unroll
    for (int i = 0; i < RK; ++i)
#pragma unroll
      for (int c = 0; c < CQ; ++c) {
        const int qi = tc + 16 * c;
        float p = expf(st[i][c] - lse_s[qi]);
        if (masked && !live(a, q0 + qi, k0 + tr * RK + i)) p = 0.f;
        Ps[(tr * RK + i) * LP + qi] = round_to<T>(p);
        dSs[(tr * RK + i) * LP + qi] = round_to<T>(p * (dpt[i][c] - delta_s[qi]));
      }
    __syncthreads();
#pragma unroll 4
    for (int n = 0; n < kBM; ++n) {
      float qv[CD], ov[CD];
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        qv[c] = Qs[n * LD + tc + 16 * c];
        ov[c] = dOs[n * LD + tc + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        const float p = Ps[(tr * RK + i) * LP + n];
        const float ds = dSs[(tr * RK + i) * LP + n];
#pragma unroll
        for (int c = 0; c < CD; ++c) {
          dv[i][c] = fmaf(p, ov[c], dv[i][c]);
          dk[i][c] = fmaf(ds, qv[c], dk[i][c]);
        }
      }
    }
  }
  T* dk_out = static_cast<T*>(a.out0);
  T* dv_out = static_cast<T*>(a.out1);
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int r = k0 + tr * RK + i;
    if (r >= S) continue;
    const int64_t row = ((static_cast<int64_t>(b) * S + r) * a.H + h) * D;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      dk_out[row + tc + 16 * c] = from_f32<T>(dk[i][c]);
      dv_out[row + tc + 16 * c] = from_f32<T>(dv[i][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// K5 backward, part 2: dq (grid over query tiles, loop over key tiles)
// ---------------------------------------------------------------------------

template <typename T, int D, int BN>
constexpr size_t dq_smem() {
  return sizeof(float) * (2 * kBM * (D + 1) + 2 * BN * (D + 1) + kBM * (BN + 1));
}

template <typename T, int D, int BN>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Args a) {
  constexpr int CN = BN / 16;
  constexpr int CD = D / 16;
  constexpr int LD = D + 1, LP = BN + 1;
  extern __shared__ float smem[];
  float* Qs = smem;            // [kBM][LD]
  float* dOs = Qs + kBM * LD;  // [kBM][LD]
  float* Ks = dOs + kBM * LD;  // [BN][LD]
  float* Vs = Ks + BN * LD;    // [BN][LD]
  float* dSs = Vs + BN * LD;   // [kBM][LP]  ds in q's dtype
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H, S = a.S;
  const T* q = static_cast<const T*>(a.q) + b * a.sq[0] + h * a.sq[2];
  const T* k = static_cast<const T*>(a.k) + b * a.sk[0] + h * a.sk[2];
  const T* v = static_cast<const T*>(a.v) + b * a.sv[0] + h * a.sv[2];
  const T* dout = static_cast<const T*>(a.dout) + b * a.sdo[0] + h * a.sdo[2];
  const float* lse = a.lse_in + static_cast<int64_t>(bh) * S;
  const float* delta = a.delta + static_cast<int64_t>(bh) * S;

  load_tile<T, D>(Qs, LD, q, a.sq[1], q0, kBM, S);
  load_tile<T, D>(dOs, LD, dout, a.sdo[1], q0, kBM, S);
  float lse_r[4], delta_r[4], dq[4][CD];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + tr * 4 + i;
    lse_r[i] = r < S ? lse[r] : 0.f;
    delta_r[i] = r < S ? delta[r] : 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) dq[i][c] = 0.f;
  }
  int lo, hi;
  key_range<BN>(a, q0, &lo, &hi);
  for (int j = lo; j < hi; ++j) {
    const int k0 = j * BN;
    __syncthreads();
    load_tile<T, D>(Ks, LD, k, a.sk[1], k0, BN, S);
    load_tile<T, D>(Vs, LD, v, a.sv[1], k0, BN, S);
    __syncthreads();
    float s[4][CN], dp[4][CN];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < CN; ++c) s[i][c] = dp[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], ov[4], kv[CN], vv[CN];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(tr * 4 + i) * LD + d];
        ov[i] = dOs[(tr * 4 + i) * LD + d];
      }
#pragma unroll
      for (int c = 0; c < CN; ++c) {
        kv[c] = Ks[(tc + 16 * c) * LD + d];
        vv[c] = Vs[(tc + 16 * c) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CN; ++c) {
          s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
          dp[i][c] = fmaf(ov[i], vv[c], dp[i][c]);
        }
    }
    const bool masked = tile_masked(a, q0, kBM, k0, BN);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < CN; ++c) {
        float p = expf(s[i][c] - lse_r[i]);
        if (masked && !live(a, q0 + tr * 4 + i, k0 + tc + 16 * c)) p = 0.f;
        dSs[(tr * 4 + i) * LP + tc + 16 * c] = round_to<T>(p * (dp[i][c] - delta_r[i]));
      }
    __syncthreads();
#pragma unroll 4
    for (int n = 0; n < BN; ++n) {
      float kv[CD];
#pragma unroll
      for (int c = 0; c < CD; ++c) kv[c] = Ks[n * LD + tc + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = dSs[(tr * 4 + i) * LP + n];
#pragma unroll
        for (int c = 0; c < CD; ++c) dq[i][c] = fmaf(ds, kv[c], dq[i][c]);
      }
    }
  }
  T* dq_out = static_cast<T*>(a.out0);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + tr * 4 + i;
    if (r >= S) continue;
    T* row = dq_out + ((static_cast<int64_t>(b) * S + r) * a.H + h) * D;
#pragma unroll
    for (int c = 0; c < CD; ++c) row[tc + 16 * c] = from_f32<T>(dq[i][c]);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

enum Kind { kFwd, kDkdv, kDq };

template <typename T, int D, int BN>
int launch(Kind kind, const Args& a, cudaStream_t st) {
  void (*kernel)(Args);
  size_t smem;
  dim3 grid;
  const int bh = a.B * a.H;
  switch (kind) {
    case kFwd:
      kernel = flash_fwd_kernel<T, D, BN>;
      smem = fwd_smem<T, D, BN>();
      grid = dim3((a.S + kBM - 1) / kBM, bh);
      break;
    case kDkdv:
      kernel = flash_bwd_dkdv_kernel<T, D, BN>;
      smem = dkdv_smem<T, D, BN>();
      grid = dim3((a.S + BN - 1) / BN, bh);
      break;
    default:
      kernel = flash_bwd_dq_kernel<T, D, BN>;
      smem = dq_smem<T, D, BN>();
      grid = dim3((a.S + kBM - 1) / kBM, bh);
      break;
  }
  // above 48 KB only as opted-in dynamic shared memory (a host-side
  // attribute, legal during CUDA graph capture)
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_t(Kind kind, int D, int block_k, const Args& a, cudaStream_t st) {
  if (D == 64 && block_k == 64) return launch<T, 64, 64>(kind, a, st);
  if (D == 64 && block_k == 32) return launch<T, 64, 32>(kind, a, st);
  if (D == 128 && block_k == 64) return launch<T, 128, 64>(kind, a, st);
  if (D == 128 && block_k == 32) return launch<T, 128, 32>(kind, a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dtype: 0 float32, 1 bfloat16. strides: (batch, seq, head) of q, k, v
// and, for the backward, do (12 values; the forward reads 9).
int dispatch(Kind kind, const void* q, const void* k, const void* v,
             const void* dout, const void* lse_in, const void* delta,
             void* out0, void* out1, int dtype, int B, int S, int H, int D,
             const int64_t* strides, int causal, int window, int block_k,
             int fast, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse_in = static_cast<const float*>(lse_in);
  a.delta = static_cast<const float*>(delta);
  a.out0 = out0;
  a.out1 = out1;
  a.B = B;
  a.S = S;
  a.H = H;
  for (int i = 0; i < 3; ++i) {
    a.sq[i] = strides[i];
    a.sk[i] = strides[3 + i];
    a.sv[i] = strides[6 + i];
    a.sdo[i] = kind == kFwd ? 0 : strides[9 + i];
  }
  a.causal = causal;
  a.window = window;
  a.fast = fast;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_t<float>(kind, D, block_k, a, st);
  if (dtype == 1) return dispatch_t<__nv_bfloat16>(kind, D, block_k, a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

int tft_flash_fwd(const void* q, const void* k, const void* v, void* out,
                  void* lse, int dtype, int B, int S, int H, int D,
                  const int64_t* strides, int causal, int window, int block_k,
                  int fast, void* stream) {
  return dispatch(kFwd, q, k, v, nullptr, nullptr, nullptr, out, lse, dtype, B,
                  S, H, D, strides, causal, window, block_k, fast, stream);
}

int tft_flash_bwd_dkdv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int dtype, int B, int S, int H,
                       int D, const int64_t* strides, int causal, int window,
                       int block_k, int fast, void* stream) {
  return dispatch(kDkdv, q, k, v, dout, lse, delta, dk, dv, dtype, B, S, H, D,
                  strides, causal, window, block_k, fast, stream);
}

int tft_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, int dtype, int B, int S, int H, int D,
                     const int64_t* strides, int causal, int window,
                     int block_k, int fast, void* stream) {
  return dispatch(kDq, q, k, v, dout, lse, delta, dq, nullptr, dtype, B, S, H,
                  D, strides, causal, window, block_k, fast, stream);
}

}  // extern "C"
