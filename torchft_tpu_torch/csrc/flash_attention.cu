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
// - Every load past S is zero-filled, and masks always include the
//   bounds: the GPU needs no padding in memory.
// Build WITHOUT --use_fast_math: expf/logf and the divide must be the
// accurate ones.
//
// Bound on this card (H100 SXM) at the path's call (B16 H16 S2047 D64,
// causal, bf16): operations. The minimal work is two products of 2 flops
// per live (query, key) pair and head dim forward (137.4 GFLOP) and five
// backward (343.4 GFLOP), at 989 TFLOP/s bf16 dense: 0.139 and 0.347 ms.
// The bytes (q, k, v, out, do, lse once each) take about half that.
//
// Two kernel families, chosen by dtype (a dispatch, not a fallback: a call
// that the chosen kernel cannot take fails):
//
// bf16: tensor cores (mma.sync, the FlashAttention-2 design). The first
// port ran every product as a register-tiled scalar f32 FMA loop with one
// shared-memory load per FMA pair: shared-memory instructions bounded it
// at about a third of the 67 TFLOP/s f32 rate (the forward 6.03 ms, 2.3%
// of the bound above, on an NVIDIA H100 80GB HBM3 at 700.00 W). Here each
// warp owns 16 rows and every product is mma.sync.m16n8k16.bf16 with f32
// accumulators:
// - tiles stay bf16 in shared memory, rows padded to D + 8 elements, so
//   the 8 rows an ldmatrix reads start in 8 distinct bank groups;
// - operands come in as ldmatrix fragments (.trans for the operand read
//   down its rows: v in p.v, k in ds.k, q and do in the dk/dv products);
// - the online softmax stays in registers, rows reduced over the quad of
//   lanes that hold them;
// - p (and ds) go from the f32 accumulator layout straight into bf16
//   A-fragments in registers: no p tile in shared memory;
// - the streamed tiles (k/v in the forward and dq, q/do/lse/delta in
//   dk/dv) go through a two-stage cp.async ring of 16-byte copies, the next
//   tile in flight while this one computes; rows past S are zero-filled by
//   the copy's source size. cp.async needs every row 16-byte aligned: the
//   entry points refuse a bf16 pointer or stride that is not.
// At the path's call on that card (chip_smoke.py): the forward 0.88 ms
// (156 TFLOP/s), dk/dv 1.67 ms and dq 1.28 ms. Each warp still reads
// whole shared B tiles for its 16 rows (one ldmatrix.x4 per two mma);
// wgmma, which reads B once per 64-row warpgroup, is the next step.
//
// f32: scalar kernels. f32 products on tensor cores would be TF32, which
// keeps 10 mantissa bits and breaks the 2e-5 tolerance that the JAX
// package's tests set for f32; f32 is not on the LM's path. These are the
// first port's loops: 256 threads per (batch*head, 64-row tile), tiles
// staged as f32 with rows padded to D + 1 floats, each thread 4 rows x
// BN/16 columns reduced with xor shuffles.
//
// Why the backward is two kernels. The TPU backward walks key blocks and
// accumulates dq in a revisited output block, in order only because the
// TPU grid is sequential (flash_attention.py:303-309). Blocks of a GPU
// grid run in parallel and in no order, and a float atomicAdd into dq
// would make the sums' order, and so the bits, change from run to run.
// So each kernel owns its outputs: dkdv (grid over key tiles, loop over
// query tiles) and dq (grid over query tiles, loop over key tiles). Both
// rebuild p from lse and compute dp = do . v^T: 7 tile products per tile
// pair instead of the fused kernel's 5. Results are bit-identical run to
// run. The two kernels form s and dp with differently shaped products (dq
// takes q . k^T, dkdv k . q^T), whose f32 sums may round apart, so an
// element of ds may differ in its last bf16 place between dq and dk.
//
// Window 1. Each query then sees only its own key: p = 1, out = v, and
// ds = dp - delta subtracts two f32 sums of the same products, zero but for
// rounding, so every bit of dq and dk is rounding. There the backward takes
// the one live dp of a row as a dot product of its do and v rows, one f32
// FMA per element in d order (the order of an f32 matmul, which the plain
// version uses), instead of a tensor-core tile of which one element per row
// is live.
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

using bf16 = __nv_bfloat16;

constexpr int kBM = 64;         // query rows per tile; also the dkdv query tile
constexpr int kRows = 16;       // rows of one mma tile: each warp owns 16 rows
constexpr int kMmaThreads = 128;  // forward and dq: 4 warps x 16 query rows
// Blocks per SM the D64 tensor-core kernels are compiled for (registers
// capped at 65536 / (blocks x threads)): registers, not shared memory,
// set their occupancy, and the cap buys a block per SM (forward and dq
// 3 -> 4, dk/dv 2 -> 3) for 4-32 bytes of spill per thread (ptxas -v).
// D128 keeps its registers.
template <int D> constexpr int kMmaBlocks = D == 64 ? 4 : 1;
template <int D> constexpr int kDkdvBlocks = D == 64 ? 3 : 1;
constexpr int kThreads = 256;   // the scalar f32 kernels
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

// Query tiles [lo, hi) that see keys of the tile starting at k0.
template <int BN>
__device__ __forceinline__ void query_range(const Args& a, int k0, int* lo,
                                            int* hi) {
  const int num_q = (a.S + kBM - 1) / kBM;
  *lo = a.causal ? k0 / kBM : 0;
  // window: the last query that sees this tile's last key is k + w - 1
  *hi = a.window > 0 ? min(num_q, (k0 + BN - 2 + a.window) / kBM + 1) : num_q;
}

// ---------------------------------------------------------------------------
// PTX of the tensor-core kernels (sm_80 and later)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy past L1; the bytes past src_bytes (0 or 16)
// are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4-byte copy, likewise (lse and delta rows: S * 4 bytes apart, so not
// 16-byte aligned).
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// The same, each matrix transposed on its way into the registers.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d (16x8 f32) += a (16x16 bf16, row-major) . b (16x8 bf16, column-major)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 rounded to bf16 (nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// Tensor-core building blocks. Fragment layouts of mma.m16n8k16 (g = lane
// / 4, t = lane % 4): an accumulator holds rows g and g + 8, columns 2t and
// 2t + 1 of its 16x8 tile, as {[g][2t], [g][2t+1], [g+8][2t], [g+8][2t+1]}.
// ---------------------------------------------------------------------------

// Rows [r0, r0 + rows) of one (b, h) slice into a shared tile whose rows are
// D + 8 elements apart, one 16-byte copy per chunk; rows at or past S are
// zero-filled through the copy's source size, so no read leaves the tensor.
template <int D, int NT>
__device__ __forceinline__ void cp_rows(bf16* dst, const bf16* src,
                                        int64_t row_stride, int r0, int rows,
                                        int S) {
  constexpr int kChunks = D / 8;
  for (int e = threadIdx.x; e < rows * kChunks; e += NT) {
    const int r = e / kChunks, c = e % kChunks, s = r0 + r;
    const bool in = s < S;
    cp_async16(dst + r * (D + 8) + c * 8, in ? src + s * row_stride + c * 8 : src,
               in ? 16 : 0);
  }
}

// kBM f32 values [r0, r0 + kBM) of a row of length S, zero past S.
template <int NT>
__device__ __forceinline__ void cp_vec(float* dst, const float* src, int r0,
                                       int S) {
  for (int e = threadIdx.x; e < kBM; e += NT) {
    const int s = r0 + e;
    cp_async4(dst + e, s < S ? src + s : src, s < S ? 4 : 0);
  }
}

// A-fragments of the 16 x D rows [row0, row0 + 16) of a row-major tile.
template <int LD, int KD>
__device__ __forceinline__ void load_a(uint32_t (&af)[KD][4], const bf16* t,
                                       int row0) {
  const int l = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
    ldsm_x4(af[kk], t + (row0 + (l & 15)) * LD + kk * 16 + (l >> 4) * 8);
}

// acc (16 x 8NB) += A . B^T: A from fragments (16 x 16KD), B the first 8NB
// rows of tile b (8NB x 16KD, row-major; e.g. k for s = q . k^T).
template <int LD, int KD, int NB>
__device__ __forceinline__ void mma_abt(float (&acc)[NB][4],
                                        const uint32_t (&af)[KD][4],
                                        const bf16* b) {
  const int l = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
#pragma unroll
    for (int nb = 0; nb < NB; nb += 2) {
      uint32_t bf[4];
      ldsm_x4(bf, b + (nb * 8 + (l >> 4) * 8 + (l & 7)) * LD + kk * 16 +
                      ((l >> 3) & 1) * 8);
      mma16816(acc[nb], af[kk], bf[0], bf[1]);
      mma16816(acc[nb + 1], af[kk], bf[2], bf[3]);
    }
}

// acc (16 x 8ND) += P . B: P from f32 accumulators (16 x 8NP), rounded to
// bf16 into A-fragments in registers; B the first 8NP rows of tile b
// (8NP x 8ND, row-major; e.g. v for o = p . v), read transposed.
template <int LD, int NP, int ND>
__device__ __forceinline__ void mma_pb(float (&acc)[ND][4],
                                       const float (&p)[NP][4], const bf16* b) {
  const int l = threadIdx.x & 31;
#pragma unroll
  for (int kc = 0; kc < NP / 2; ++kc) {
    const uint32_t pa[4] = {pack_bf16(p[2 * kc][0], p[2 * kc][1]),
                            pack_bf16(p[2 * kc][2], p[2 * kc][3]),
                            pack_bf16(p[2 * kc + 1][0], p[2 * kc + 1][1]),
                            pack_bf16(p[2 * kc + 1][2], p[2 * kc + 1][3])};
#pragma unroll
    for (int nd = 0; nd < ND; nd += 2) {
      uint32_t bf[4];
      ldsm_x4_t(bf, b + (kc * 16 + (l & 7) + ((l >> 3) & 1) * 8) * LD +
                        nd * 8 + (l >> 4) * 8);
      mma16816(acc[nd], pa, bf[0], bf[1]);
      mma16816(acc[nd + 1], pa, bf[2], bf[3]);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[i][e] = 0.f;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// dp of the one live pair of a window-1 row: the f32 dot product of two
// bf16 rows of D, one FMA per element in d order (see the note at the top).
template <int D>
__device__ __forceinline__ float dot_rows(const bf16* x, const bf16* y) {
  float acc = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d)
    acc = fmaf(__bfloat162float(x[d]), __bfloat162float(y[d]), acc);
  return acc;
}

// A warp's 16-row f32 accumulator tile, divided by den[i] (rows g, g + 8),
// into bf16 rows of its own shared tile, then to rows [r0, r0 + 16) of the
// contiguous (B, S, H, D) output as 16-byte stores (rows past S skipped).
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, bf16* stage,
                                           const float (&acc)[D / 8][4],
                                           const float (&den)[2],
                                           const Args& a, int b, int h,
                                           int r0) {
  constexpr int LD = D + 8, kChunks = D / 8;
  const int l = threadIdx.x & 31, g = l >> 2, t = l & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      *reinterpret_cast<uint32_t*>(stage + (g + 8 * i) * LD + nd * 8 + 2 * t) =
          pack_bf16(acc[nd][2 * i] / den[i], acc[nd][2 * i + 1] / den[i]);
  __syncwarp();
  for (int e = l; e < kRows * kChunks; e += 32) {
    const int r = e / kChunks, c = e % kChunks, s = r0 + r;
    if (s < a.S)
      *reinterpret_cast<uint4*>(
          out + ((static_cast<int64_t>(b) * a.S + s) * a.H + h) * D + c * 8) =
          *reinterpret_cast<const uint4*>(stage + r * LD + c * 8);
  }
}

// ---------------------------------------------------------------------------
// K4 forward, bf16: out, lse
// ---------------------------------------------------------------------------

template <int D, int BN>
constexpr size_t fwd_mma_smem() {
  return sizeof(bf16) * (kBM + 4 * BN) * (D + 8);
}

template <int D, int BN>
__global__ void __launch_bounds__(kMmaThreads, kMmaBlocks<D>)
    flash_fwd_mma_kernel(Args a) {
  constexpr int LD = D + 8, KD = D / 16, NB = BN / 8, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // [kBM][LD]; at the end, out
  bf16* Ks = Qs + kBM * LD;                  // [2][BN][LD]
  bf16* Vs = Ks + 2 * BN * LD;               // [2][BN][LD]
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = (threadIdx.x >> 5) * kRows;  // this warp's rows
  // the causal grid's heaviest tiles (last rows) start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H, S = a.S;
  const bf16* q = static_cast<const bf16*>(a.q) + b * a.sq[0] + h * a.sq[2];
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.sk[0] + h * a.sk[2];
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.sv[0] + h * a.sv[2];
  const bool fast = a.fast;
  const float neg = fast ? kNegLarge : -INFINITY;
  int lo, hi;
  key_range<BN>(a, q0, &lo, &hi);

  cp_rows<D, kMmaThreads>(Qs, q, a.sq[1], q0, kBM, S);
  cp_rows<D, kMmaThreads>(Ks, k, a.sk[1], lo * BN, BN, S);
  cp_rows<D, kMmaThreads>(Vs, v, a.sv[1], lo * BN, BN, S);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[KD][4];
  load_a<LD>(qf, Qs, row0);
  float m[2] = {neg, neg}, l[2] = {0.f, 0.f}, o[ND][4];
  zero(o);
  for (int j = lo; j < hi; ++j) {
    const int stage = (j - lo) & 1;
    if (j + 1 < hi) {  // the next tile into the other stage
      const int nxt = (stage ^ 1) * BN * LD;
      cp_rows<D, kMmaThreads>(Ks + nxt, k, a.sk[1], (j + 1) * BN, BN, S);
      cp_rows<D, kMmaThreads>(Vs + nxt, v, a.sv[1], (j + 1) * BN, BN, S);
    }
    cp_async_commit();  // an empty group on the last tile
    cp_async_wait<1>();  // this tile's group has landed
    __syncthreads();
    const bf16* Kt = Ks + stage * BN * LD;
    const bf16* Vt = Vs + stage * BN * LD;
    float s[NB][4];
    zero(s);
    mma_abt<LD>(s, qf, Kt);
    const int k0 = j * BN;
    if (tile_masked(a, q0, kBM, k0, BN)) {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!live(a, q0 + row0 + g + (e >> 1) * 8, k0 + nb * 8 + 2 * t + (e & 1)))
            s[nb][e] = neg;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // rows g and g + 8
      float mt = s[0][2 * i];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        mt = fmaxf(mt, fmaxf(s[nb][2 * i], s[nb][2 * i + 1]));
      const float m_new = fmaxf(m[i], quad_max(mt));
      float corr, psum = 0.f;
      if (fast) {
        // every row has a live key (its own position), so m_new is finite
        // and exp(-1e30 - m_new) underflows to exactly 0
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int e = 2 * i; e < 2 * i + 2; ++e) {
            s[nb][e] = expf(s[nb][e] - m_new);
            psum += s[nb][e];
          }
        corr = expf(m[i] - m_new);
      } else {
        const float safe_m = isfinite(m_new) ? m_new : 0.f;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int e = 2 * i; e < 2 * i + 2; ++e) {
            s[nb][e] = isfinite(s[nb][e]) ? expf(s[nb][e] - safe_m) : 0.f;
            psum += s[nb][e];
          }
        corr = isfinite(m[i]) ? expf(m[i] - safe_m) : 0.f;
      }
      l[i] = l[i] * corr + quad_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        o[nd][2 * i] *= corr;
        o[nd][2 * i + 1] *= corr;
      }
    }
    mma_pb<LD>(o, s, Vt);  // p rounded to bf16 on its way in
    __syncthreads();       // the next iteration refills this stage
  }
  // each warp stages its rows in its own rows of Qs (only it read them)
  float l_safe[2];
  float* lse = static_cast<float*>(a.out1) + static_cast<int64_t>(bh) * S;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_safe[i] = fmaxf(l[i], 1e-30f);
    const int r = q0 + row0 + g + 8 * i;
    if (t == 0 && r < S)
      lse[r] = (fast || isfinite(m[i])) ? m[i] + logf(l_safe[i]) : -INFINITY;
  }
  store_rows<D>(static_cast<bf16*>(a.out0), Qs + row0 * LD, o, l_safe, a, b, h,
                q0 + row0);
}

// ---------------------------------------------------------------------------
// K5 backward, part 1, bf16: dk, dv (grid over key tiles, loop over query
// tiles). Each warp owns 16 keys, so BN / 16 warps.
// ---------------------------------------------------------------------------

template <int D, int BN>
constexpr size_t dkdv_mma_smem() {
  return sizeof(bf16) * (2 * BN + 4 * kBM) * (D + 8) + sizeof(float) * 4 * kBM;
}

template <int D, int BN>
__global__ void __launch_bounds__(2 * BN, kDkdvBlocks<D>)
    flash_bwd_dkdv_mma_kernel(Args a) {
  constexpr int NT = 2 * BN;  // BN / 16 warps of 32
  constexpr int LD = D + 8, KD = D / 16, NQ = kBM / 8, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // [BN][LD]; at the end, dk
  bf16* Vs = Ks + BN * LD;                   // [BN][LD]; at the end, dv
  bf16* Qs = Vs + BN * LD;                   // [2][kBM][LD]
  bf16* dOs = Qs + 2 * kBM * LD;             // [2][kBM][LD]
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * kBM * LD);  // [2][kBM]
  float* delta_s = lse_s + 2 * kBM;                             // [2][kBM]
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = (threadIdx.x >> 5) * kRows;  // this warp's keys
  const int k0 = blockIdx.x * BN;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H, S = a.S;
  const bf16* q = static_cast<const bf16*>(a.q) + b * a.sq[0] + h * a.sq[2];
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.sk[0] + h * a.sk[2];
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.sv[0] + h * a.sv[2];
  const bf16* dout = static_cast<const bf16*>(a.dout) + b * a.sdo[0] + h * a.sdo[2];
  const float* lse = a.lse_in + static_cast<int64_t>(bh) * S;
  const float* delta = a.delta + static_cast<int64_t>(bh) * S;
  int lo, hi;
  query_range<BN>(a, k0, &lo, &hi);

  cp_rows<D, NT>(Ks, k, a.sk[1], k0, BN, S);
  cp_rows<D, NT>(Vs, v, a.sv[1], k0, BN, S);
  if (lo < hi) {
    cp_rows<D, NT>(Qs, q, a.sq[1], lo * kBM, kBM, S);
    cp_rows<D, NT>(dOs, dout, a.sdo[1], lo * kBM, kBM, S);
    cp_vec<NT>(lse_s, lse, lo * kBM, S);
    cp_vec<NT>(delta_s, delta, lo * kBM, S);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  float dk[ND][4], dv[ND][4];
  zero(dk);
  zero(dv);
  for (int it = lo; it < hi; ++it) {
    const int stage = (it - lo) & 1;
    if (it + 1 < hi) {  // the next query tile into the other stage
      const int nxt = (stage ^ 1) * kBM, r1 = (it + 1) * kBM;
      cp_rows<D, NT>(Qs + nxt * LD, q, a.sq[1], r1, kBM, S);
      cp_rows<D, NT>(dOs + nxt * LD, dout, a.sdo[1], r1, kBM, S);
      cp_vec<NT>(lse_s + nxt, lse, r1, S);
      cp_vec<NT>(delta_s + nxt, delta, r1, S);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Qt = Qs + stage * kBM * LD;
    const bf16* dOt = dOs + stage * kBM * LD;
    const float* lse_t = lse_s + stage * kBM;
    const float* delta_t = delta_s + stage * kBM;
    const int q0 = it * kBM;
    // s^T = k . q^T and dp^T = v . do^T: rows keys, columns queries
    float st[NQ][4], dpt[NQ][4];
    zero(st);
    zero(dpt);
    {
      // this warp's k, then v rows as A-fragments (reloaded per tile:
      // holding them costs the registers of a third block per SM)
      uint32_t af[KD][4];
      load_a<LD>(af, Ks, row0);
      mma_abt<LD>(st, af, Qt);
      load_a<LD>(af, Vs, row0);
      mma_abt<LD>(dpt, af, dOt);
    }
    const bool masked = tile_masked(a, q0, kBM, k0, BN);
#pragma unroll
    for (int nb = 0; nb < NQ; ++nb) {
      // lse and delta of this thread's two query columns 2t, 2t + 1
      const float2 lse2 = *reinterpret_cast<const float2*>(lse_t + nb * 8 + 2 * t);
      const float2 delta2 =
          *reinterpret_cast<const float2*>(delta_t + nb * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = nb * 8 + 2 * t + (e & 1), ki = row0 + g + (e >> 1) * 8;
        float p = expf(st[nb][e] - (e & 1 ? lse2.y : lse2.x));
        if (masked && !live(a, q0 + qi, k0 + ki)) p = 0.f;
        const float dp = a.window == 1 && q0 + qi == k0 + ki
                             ? dot_rows<D>(dOt + qi * LD, Vs + ki * LD)
                             : dpt[nb][e];
        st[nb][e] = p;
        dpt[nb][e] = p * (dp - (e & 1 ? delta2.y : delta2.x));  // ds^T
      }
    }
    mma_pb<LD>(dv, st, dOt);   // p^T rounded to bf16 on its way in
    mma_pb<LD>(dk, dpt, Qt);   // ds^T likewise: its one rounding
    __syncthreads();           // the next iteration refills this stage
  }
  const float one[2] = {1.f, 1.f};
  store_rows<D>(static_cast<bf16*>(a.out0), Ks + row0 * LD, dk, one, a, b, h,
                k0 + row0);
  store_rows<D>(static_cast<bf16*>(a.out1), Vs + row0 * LD, dv, one, a, b, h,
                k0 + row0);
}

// ---------------------------------------------------------------------------
// K5 backward, part 2, bf16: dq (grid over query tiles, loop over key tiles)
// ---------------------------------------------------------------------------

template <int D, int BN>
constexpr size_t dq_mma_smem() {
  return sizeof(bf16) * (2 * kBM + 4 * BN) * (D + 8);
}

template <int D, int BN>
__global__ void __launch_bounds__(kMmaThreads, kMmaBlocks<D>)
    flash_bwd_dq_mma_kernel(Args a) {
  constexpr int LD = D + 8, KD = D / 16, NB = BN / 8, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // [kBM][LD]; at the end, dq
  bf16* dOs = Qs + kBM * LD;                 // [kBM][LD]
  bf16* Ks = dOs + kBM * LD;                 // [2][BN][LD]
  bf16* Vs = Ks + 2 * BN * LD;               // [2][BN][LD]
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = (threadIdx.x >> 5) * kRows;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H, S = a.S;
  const bf16* q = static_cast<const bf16*>(a.q) + b * a.sq[0] + h * a.sq[2];
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.sk[0] + h * a.sk[2];
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.sv[0] + h * a.sv[2];
  const bf16* dout = static_cast<const bf16*>(a.dout) + b * a.sdo[0] + h * a.sdo[2];
  const float* lse = a.lse_in + static_cast<int64_t>(bh) * S;
  const float* delta = a.delta + static_cast<int64_t>(bh) * S;
  int lo, hi;
  key_range<BN>(a, q0, &lo, &hi);

  cp_rows<D, kMmaThreads>(Qs, q, a.sq[1], q0, kBM, S);
  cp_rows<D, kMmaThreads>(dOs, dout, a.sdo[1], q0, kBM, S);
  cp_rows<D, kMmaThreads>(Ks, k, a.sk[1], lo * BN, BN, S);
  cp_rows<D, kMmaThreads>(Vs, v, a.sv[1], lo * BN, BN, S);
  cp_async_commit();
  float lse_r[2], delta_r[2];  // rows g and g + 8
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + row0 + g + 8 * i;
    lse_r[i] = r < S ? lse[r] : 0.f;
    delta_r[i] = r < S ? delta[r] : 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();
  float dq[ND][4];
  zero(dq);
  for (int j = lo; j < hi; ++j) {
    const int stage = (j - lo) & 1;
    if (j + 1 < hi) {
      const int nxt = (stage ^ 1) * BN * LD;
      cp_rows<D, kMmaThreads>(Ks + nxt, k, a.sk[1], (j + 1) * BN, BN, S);
      cp_rows<D, kMmaThreads>(Vs + nxt, v, a.sv[1], (j + 1) * BN, BN, S);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Kt = Ks + stage * BN * LD;
    const bf16* Vt = Vs + stage * BN * LD;
    float s[NB][4], dp[NB][4];
    zero(s);
    zero(dp);
    {
      uint32_t af[KD][4];  // as in dk/dv, reloaded per tile
      load_a<LD>(af, Qs, row0);
      mma_abt<LD>(s, af, Kt);
      load_a<LD>(af, dOs, row0);
      mma_abt<LD>(dp, af, Vt);
    }
    const int k0 = j * BN;
    const bool masked = tile_masked(a, q0, kBM, k0, BN);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = row0 + g + (e >> 1) * 8, ki = nb * 8 + 2 * t + (e & 1);
        float p = expf(s[nb][e] - lse_r[e >> 1]);
        if (masked && !live(a, q0 + qi, k0 + ki)) p = 0.f;
        const float dpe = a.window == 1 && q0 + qi == k0 + ki
                              ? dot_rows<D>(dOs + qi * LD, Vt + ki * LD)
                              : dp[nb][e];
        s[nb][e] = p * (dpe - delta_r[e >> 1]);  // ds
      }
    mma_pb<LD>(dq, s, Kt);  // ds rounded to bf16 on its way in
    __syncthreads();
  }
  const float one[2] = {1.f, 1.f};
  store_rows<D>(static_cast<bf16*>(a.out0), Qs + row0 * LD, dq, one, a, b, h,
                q0 + row0);
}

// ---------------------------------------------------------------------------
// The scalar f32 kernels
// ---------------------------------------------------------------------------

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

// Loads rows [r0, r0 + rows) of one (b, h) slice into shared memory with
// row stride ld, zero-filling rows at or past S.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src,
                                          int64_t row_stride, int r0, int rows,
                                          int S) {
  for (int e = threadIdx.x; e < rows * D; e += kThreads) {
    const int r = e / D, d = e % D;
    const int s = r0 + r;
    dst[r * ld + d] = s < S ? src[s * row_stride + d] : 0.f;
  }
}

template <int D, int BN>
constexpr size_t fwd_f32_smem() {
  return sizeof(float) * (kBM * (D + 1) + BN * (D + 1) + BN * D + kBM * (BN + 1));
}

template <int D, int BN>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Args a) {
  constexpr int CN = BN / 16;  // score columns per thread
  constexpr int CD = D / 16;   // output columns per thread
  constexpr int LD = D + 1, LP = BN + 1;
  extern __shared__ float smem_f[];
  float* Qs = smem_f;           // [kBM][LD]
  float* Ks = Qs + kBM * LD;    // [BN][LD]
  float* Vs = Ks + BN * LD;     // [BN][D]
  float* Ps = Vs + BN * D;      // [kBM][LP]
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H, S = a.S;
  const float* q = static_cast<const float*>(a.q) + b * a.sq[0] + h * a.sq[2];
  const float* k = static_cast<const float*>(a.k) + b * a.sk[0] + h * a.sk[2];
  const float* v = static_cast<const float*>(a.v) + b * a.sv[0] + h * a.sv[2];
  const bool fast = a.fast;
  const float neg = fast ? kNegLarge : -INFINITY;

  load_tile<D>(Qs, LD, q, a.sq[1], q0, kBM, S);
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
    load_tile<D>(Ks, LD, k, a.sk[1], k0, BN, S);
    load_tile<D>(Vs, D, v, a.sv[1], k0, BN, S);
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
      for (int c = 0; c < CN; ++c) Ps[(tr * 4 + i) * LP + tc + 16 * c] = s[i][c];
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
  float* out = static_cast<float*>(a.out0);
  float* lse = static_cast<float*>(a.out1) + static_cast<int64_t>(bh) * S;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + tr * 4 + i;
    if (r >= S) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
    float* orow = out + ((static_cast<int64_t>(b) * S + r) * a.H + h) * D;
#pragma unroll
    for (int c = 0; c < CD; ++c) orow[tc + 16 * c] = acc[i][c] / l_safe;
    if (tc == 0)
      lse[r] = (fast || isfinite(m[i])) ? m[i] + logf(l_safe) : -INFINITY;
  }
}

template <int D, int BN>
constexpr size_t dkdv_f32_smem() {
  return sizeof(float) *
         (2 * BN * (D + 1) + 2 * kBM * (D + 1) + 2 * BN * (kBM + 1) + 2 * kBM);
}

template <int D, int BN>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(Args a) {
  constexpr int RK = BN / 16;   // key rows per thread
  constexpr int CQ = kBM / 16;  // query columns per thread
  constexpr int CD = D / 16;    // dk/dv columns per thread
  constexpr int LD = D + 1, LP = kBM + 1;
  extern __shared__ float smem_f[];
  float* Ks = smem_f;            // [BN][LD]
  float* Vs = Ks + BN * LD;      // [BN][LD]
  float* Qs = Vs + BN * LD;      // [kBM][LD]
  float* dOs = Qs + kBM * LD;    // [kBM][LD]
  float* Ps = dOs + kBM * LD;    // [BN][LP]  p^T
  float* dSs = Ps + BN * LP;     // [BN][LP]  ds^T
  float* lse_s = dSs + BN * LP;  // [kBM]
  float* delta_s = lse_s + kBM;  // [kBM]
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
  const int k0 = blockIdx.x * BN;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H, S = a.S;
  const float* q = static_cast<const float*>(a.q) + b * a.sq[0] + h * a.sq[2];
  const float* k = static_cast<const float*>(a.k) + b * a.sk[0] + h * a.sk[2];
  const float* v = static_cast<const float*>(a.v) + b * a.sv[0] + h * a.sv[2];
  const float* dout = static_cast<const float*>(a.dout) + b * a.sdo[0] + h * a.sdo[2];
  const float* lse = a.lse_in + static_cast<int64_t>(bh) * S;
  const float* delta = a.delta + static_cast<int64_t>(bh) * S;

  load_tile<D>(Ks, LD, k, a.sk[1], k0, BN, S);
  load_tile<D>(Vs, LD, v, a.sv[1], k0, BN, S);
  float dk[RK][CD], dv[RK][CD];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int c = 0; c < CD; ++c) dk[i][c] = dv[i][c] = 0.f;

  int lo, hi;
  query_range<BN>(a, k0, &lo, &hi);
  for (int it = lo; it < hi; ++it) {
    const int q0 = it * kBM;
    __syncthreads();  // the last tile's readers are done
    load_tile<D>(Qs, LD, q, a.sq[1], q0, kBM, S);
    load_tile<D>(dOs, LD, dout, a.sdo[1], q0, kBM, S);
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
        Ps[(tr * RK + i) * LP + qi] = p;
        dSs[(tr * RK + i) * LP + qi] = p * (dpt[i][c] - delta_s[qi]);
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
  float* dk_out = static_cast<float*>(a.out0);
  float* dv_out = static_cast<float*>(a.out1);
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int r = k0 + tr * RK + i;
    if (r >= S) continue;
    const int64_t row = ((static_cast<int64_t>(b) * S + r) * a.H + h) * D;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      dk_out[row + tc + 16 * c] = dk[i][c];
      dv_out[row + tc + 16 * c] = dv[i][c];
    }
  }
}

template <int D, int BN>
constexpr size_t dq_f32_smem() {
  return sizeof(float) * (2 * kBM * (D + 1) + 2 * BN * (D + 1) + kBM * (BN + 1));
}

template <int D, int BN>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Args a) {
  constexpr int CN = BN / 16;
  constexpr int CD = D / 16;
  constexpr int LD = D + 1, LP = BN + 1;
  extern __shared__ float smem_f[];
  float* Qs = smem_f;          // [kBM][LD]
  float* dOs = Qs + kBM * LD;  // [kBM][LD]
  float* Ks = dOs + kBM * LD;  // [BN][LD]
  float* Vs = Ks + BN * LD;    // [BN][LD]
  float* dSs = Vs + BN * LD;   // [kBM][LP]
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H, S = a.S;
  const float* q = static_cast<const float*>(a.q) + b * a.sq[0] + h * a.sq[2];
  const float* k = static_cast<const float*>(a.k) + b * a.sk[0] + h * a.sk[2];
  const float* v = static_cast<const float*>(a.v) + b * a.sv[0] + h * a.sv[2];
  const float* dout = static_cast<const float*>(a.dout) + b * a.sdo[0] + h * a.sdo[2];
  const float* lse = a.lse_in + static_cast<int64_t>(bh) * S;
  const float* delta = a.delta + static_cast<int64_t>(bh) * S;

  load_tile<D>(Qs, LD, q, a.sq[1], q0, kBM, S);
  load_tile<D>(dOs, LD, dout, a.sdo[1], q0, kBM, S);
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
    load_tile<D>(Ks, LD, k, a.sk[1], k0, BN, S);
    load_tile<D>(Vs, LD, v, a.sv[1], k0, BN, S);
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
        dSs[(tr * 4 + i) * LP + tc + 16 * c] = p * (dp[i][c] - delta_r[i]);
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
  float* dq_out = static_cast<float*>(a.out0);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + tr * 4 + i;
    if (r >= S) continue;
    float* row = dq_out + ((static_cast<int64_t>(b) * S + r) * a.H + h) * D;
#pragma unroll
    for (int c = 0; c < CD; ++c) row[tc + 16 * c] = dq[i][c];
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

enum Kind { kFwd = 0, kDkdv = 1, kDq = 2 };

// Grid, block and dynamic shared memory of one kernel of one (dtype, D, BN).
struct Launch {
  void (*kernel)(Args);
  dim3 grid;
  int threads;
  size_t smem;
};

template <int D, int BN>
Launch plan_mma(Kind kind, int S, int bh) {
  const unsigned nq = (S + kBM - 1) / kBM, nk = (S + BN - 1) / BN;
  switch (kind) {
    case kFwd:
      return {flash_fwd_mma_kernel<D, BN>, dim3(nq, bh), kMmaThreads,
              fwd_mma_smem<D, BN>()};
    case kDkdv:
      return {flash_bwd_dkdv_mma_kernel<D, BN>, dim3(nk, bh), 2 * BN,
              dkdv_mma_smem<D, BN>()};
    default:
      return {flash_bwd_dq_mma_kernel<D, BN>, dim3(nq, bh), kMmaThreads,
              dq_mma_smem<D, BN>()};
  }
}

template <int D, int BN>
Launch plan_f32(Kind kind, int S, int bh) {
  const unsigned nq = (S + kBM - 1) / kBM, nk = (S + BN - 1) / BN;
  switch (kind) {
    case kFwd:
      return {flash_fwd_kernel<D, BN>, dim3(nq, bh), kThreads,
              fwd_f32_smem<D, BN>()};
    case kDkdv:
      return {flash_bwd_dkdv_kernel<D, BN>, dim3(nk, bh), kThreads,
              dkdv_f32_smem<D, BN>()};
    default:
      return {flash_bwd_dq_kernel<D, BN>, dim3(nq, bh), kThreads,
              dq_f32_smem<D, BN>()};
  }
}

// dtype 0 (f32): the scalar kernels; 1 (bf16): the tensor-core kernels.
bool plan(Kind kind, int dtype, int D, int block_k, int S, int bh, Launch* out) {
  const bool mma = dtype == 1;
  if (dtype != 0 && dtype != 1) return false;
  if (D == 64 && block_k == 64)
    *out = mma ? plan_mma<64, 64>(kind, S, bh) : plan_f32<64, 64>(kind, S, bh);
  else if (D == 64 && block_k == 32)
    *out = mma ? plan_mma<64, 32>(kind, S, bh) : plan_f32<64, 32>(kind, S, bh);
  else if (D == 128 && block_k == 64)
    *out = mma ? plan_mma<128, 64>(kind, S, bh) : plan_f32<128, 64>(kind, S, bh);
  else if (D == 128 && block_k == 32)
    *out = mma ? plan_mma<128, 32>(kind, S, bh) : plan_f32<128, 32>(kind, S, bh);
  else
    return false;
  return true;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// strides: (batch, seq, head) of q, k, v and, for the backward, do (12
// values; the forward reads 9).
int dispatch(Kind kind, const void* q, const void* k, const void* v,
             const void* dout, const void* lse_in, const void* delta,
             void* out0, void* out1, int dtype, int B, int S, int H, int D,
             const int64_t* strides, int causal, int window, int block_k,
             int fast, void* stream) {
  Launch l;
  if (B <= 0 || S <= 0 || H <= 0 || B * H > 65535 ||
      !plan(kind, dtype, D, block_k, S, B * H, &l))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_strides = kind == kFwd ? 9 : 12;
  if (dtype == 1) {  // cp.async moves 16-byte rows: 8 bf16 elements
    for (int i = 0; i < n_strides; ++i)
      if (strides[i] % 8 != 0) return static_cast<int>(cudaErrorMisalignedAddress);
    if (!aligned16(q) || !aligned16(k) || !aligned16(v) ||
        (kind != kFwd && !aligned16(dout)) || !aligned16(out0) ||
        (kind == kDkdv && !aligned16(out1)))
      return static_cast<int>(cudaErrorMisalignedAddress);
  }
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
  // above 48 KB only as opted-in dynamic shared memory (a host-side
  // attribute, legal during CUDA graph capture)
  cudaError_t err = cudaFuncSetAttribute(
      l.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(l.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  l.kernel<<<l.grid, l.threads, l.smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
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

// Dynamic shared memory one launch of a kernel takes (kind 0 forward, 1
// dk/dv, 2 dq), or -1 for a combination no kernel takes.
int tft_flash_smem_bytes(int kind, int dtype, int D, int block_k) {
  Launch l;
  if (kind < kFwd || kind > kDq ||
      !plan(static_cast<Kind>(kind), dtype, D, block_k, 1, 1, &l))
    return -1;
  return static_cast<int>(l.smem);
}

}  // extern "C"
