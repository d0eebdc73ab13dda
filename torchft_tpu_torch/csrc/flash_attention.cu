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
// Build WITHOUT --use_fast_math: the forward's expf/logf and divide, and
// every f32 kernel's, are the accurate ones. The bf16 backward rebuilds p
// = exp(s - lse) with ex2.approx of the log2e-scaled argument (exp_approx:
// relative error about 2^-21 against p's one rounding to bf16, 2^-9; on
// the smoke's cases the errors against the plain version did not move,
// PERF.md), which cut the instruction issue its elementwise part is bound
// by.
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
// bf16: tensor cores. The first port ran every product as a register-tiled
// scalar f32 FMA loop (the forward 6.03 ms, 2.3% of the bound above, on an
// NVIDIA H100 80GB HBM3 at 700.00 W); then every product went to
// mma.sync.m16n8k16 (the FlashAttention-2 design for Ampere: each warp
// owns 16 rows and reads whole shared B tiles through ldmatrix, tiles come
// in through a two-stage cp.async ring every thread issues; the forward
// 0.88 ms, 156 TFLOP/s).
//
// Both are now built for Hopper. The forward (K4):
// - a block is one warpgroup (4 warps) over 64 query rows of one (batch,
//   head); each product is one wgmma.mma_async per k16 step for the whole
//   warpgroup, so a shared B tile is read once per 64 rows, not once per
//   16;
// - q/k/v come in by TMA: thread 0 issues cp.async.bulk.tensor through
//   three 4-D tensor maps (D, head, row, batch, the strided qkv split read
//   in place) encoded on the host at each launch, into 1024-aligned tiles
//   in the 128-byte swizzle wgmma reads (a 64-wide bf16 row is 128 B;
//   D128 is two boxes across D); rows past S arrive as zeros. q once, k
//   and v through a two-stage ring, each stage's arrival counted in bytes
//   by an mbarrier; a __syncthreads after a tile's products frees its
//   stage for the tile two ahead;
// - s = q . k^T reads both operands K-major from shared memory
//   (m64n{BN}k16); o += p . v takes p from registers and v MN-major (the
//   transposed-B immediate), n64 per 64 columns of D;
// - wgmma's accumulator gives warp w rows 16w + g and 16w + g + 8 in
//   mma.sync's per-8-column C layout, so the online softmax (rows reduced
//   over the quad of lanes that hold them) and the f32 -> bf16 A-fragment
//   pack of p are those of mma.sync's fragments.
// What bounds it is the softmax's instruction issue, not the tensor
// cores: the accurate expf is a range reduction, an ex2 and a rescale
// for every (query, key) pair, and with the max, the sum, o's rescale and
// the pack the loop's SASS is mostly softmax, against 256 flops of
// product a pair at D64.
// Five blocks per SM overlap one block's waits and products with the
// others' softmax. Two warpgroups sharing each k/v tile (with or without a
// producer warp and empty barriers) and overlapping a tile's softmax with
// the next products inside a warpgroup were both slower on the card.
// The backward (K5) is the same machine, twice (its mma.sync kernels,
// with ldmatrix fragments and a cp.async ring, ran at 162-166 TFLOP/s of
// the products they execute):
// - dq: a block is one warpgroup over 64 query rows; q and do come in
//   once by TMA, k and v through the two-stage ring. s = q . k^T and
//   dp = do . v^T read both operands K-major; dq += ds . k takes ds from
//   registers and reads the same swizzled k tile MN-major (a second
//   descriptor over it), as the forward reads v.
// - dk/dv: a block is one warpgroup over 64 keys; k and v come in once,
//   q and do through the ring, lse and delta by 4-byte cp.async beside
//   them (a (B, H, S) row is S * 4 bytes apart, off TMA's 16-byte grid;
//   past S they read zeros). s^T = k . q^T and dp^T = v . do^T take k and
//   v as A; dv += p^T . do and dk += ds^T . q take p^T and ds^T from
//   registers and read do and q MN-major. dk and dv stay in registers
//   across the query loop.
// - delta = rowsum(do * out) is folded into dq, which is launched first:
//   each dq block reduces its own 64 rows (a thread a row, one chain of
//   f32 FMAs in d order, the plain version's order) and writes them to a
//   (B, H, S) f32 buffer that dk/dv then reads. No torch pass widens do
//   and out to f32 copies (that pass took 0.47 ms at the path's call, the
//   fold about 0.03).
// As in K4, the elementwise work between the products (p, the masks, ds,
// the packs) bounds both kernels, not the tensor cores; hence ex2.approx
// for p. Overlapping it with a product inside a warpgroup (p's exp under
// dp's product, or ds under dv's) was slower on the card.
// TMA, cp.async and the 16-byte loads need 16-byte aligned rows: the entry
// points refuse a bf16 pointer or stride that is not.
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
// wgmma's M is 64, so the dk/dv key tile is 64 whatever block_k is: how
// keys are grouped into blocks changes no key's sum (its query tiles are
// added in the same order), and block_k only shapes the dq kernel's key
// loop and its masks.
//
// Window 1. Each query then sees only its own key: p = 1, out = v, and
// ds = dp - delta subtracts two f32 sums of the same products, zero but for
// rounding, so every bit of dq and dk is rounding. There the backward takes
// the one live dp of a row as a dot product of its do and v rows, one f32
// FMA per element in d order (the order of an f32 matmul, which the plain
// version uses), instead of a tensor-core tile of which one element per row
// is live; the rows are read out of the swizzled tiles (sw_at). delta is
// folded in the same order (fold_delta), as the plain version takes it.
//
// C interface (route (b): nvcc -> .so, bound with ctypes). Each entry
// point launches on the caller's stream, never synchronises, and returns
// cudaGetLastError() (0 = success); tft_cuda_error_string is in
// quantize_kernels.cu. tft_wgmma_tile_test runs one tile product of each
// kind the kernels use, for the card tests. The backward is two launches,
// dq (which writes delta) before dk/dv (which reads it), on one stream.

#include <cuda.h>  // CUtensorMap and its enums (the types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 64;  // query rows per tile; also the dk/dv key and query tiles
constexpr int kRows = 16;  // rows of one m16 slice: warp w of a warpgroup owns 16
constexpr int kMmaThreads = 128;  // every bf16 kernel: one warpgroup
constexpr int kThreads = 256;   // the scalar f32 kernels
constexpr float kNegLarge = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const void* o;  // dq: the forward's out, read for delta
  const float* lse_in;
  const float* delta;  // dkdv: delta as the dq kernel wrote it
  void* out0;  // fwd: out; dkdv: dk; dq: dq
  void* out1;  // fwd: lse (f32); dkdv: dv; dq: delta (f32)
  int B, S, H;
  // (batch, seq, head) strides in elements of q, k, v, do and out; the
  // last dim is contiguous. Outputs are contiguous (B, S, H, D); lse and
  // delta are contiguous (B, H, S) f32.
  int64_t sq[3], sk[3], sv[3], sdo[3], so[3];
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
// Register and shared-memory helpers of the bf16 kernels
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4-byte global -> shared copy; the bytes past src_bytes (0 or 4) are
// zero-filled (lse and delta rows: S * 4 bytes apart, so not 16-byte
// aligned).
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

// Two f32 rounded to bf16 (nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Fragment layouts of mma.m16n8k16, which wgmma's accumulators and
// register A operands share (g = lane / 4, t = lane % 4): an accumulator
// holds rows g and g + 8, columns 2t and 2t + 1 of its 16x8 tile, as
// {[g][2t], [g][2t+1], [g+8][2t], [g+8][2t+1]}.

// f32 accumulators (16 x 8NP: the NP blocks of 8 columns of rows g and
// g + 8) rounded to bf16 into the A-fragments of NP / 2 k16 steps.
template <int NP>
__device__ __forceinline__ void pack_a(uint32_t (&a)[NP / 2][4],
                                       const float (&x)[NP][4]) {
#pragma unroll
  for (int kc = 0; kc < NP / 2; ++kc) {
    a[kc][0] = pack_bf16(x[2 * kc][0], x[2 * kc][1]);
    a[kc][1] = pack_bf16(x[2 * kc][2], x[2 * kc][3]);
    a[kc][2] = pack_bf16(x[2 * kc + 1][0], x[2 * kc + 1][1]);
    a[kc][3] = pack_bf16(x[2 * kc + 1][2], x[2 * kc + 1][3]);
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

// Element (r, d) of a bf16 tile as TMA's 128-byte swizzle lays it out from
// a 1024-aligned base: boxes of `rows` rows x 64 columns (128 B a row),
// box d / 64 after the others, and 16-byte chunk c of row r at c ^ (r & 7).
__device__ __forceinline__ float sw_at(const unsigned char* tile, int rows,
                                       int r, int d) {
  const int off = (d >> 6) * rows * 128 + r * 128 +
                  ((((d & 63) >> 3) ^ (r & 7)) << 4) + (d & 7) * 2;
  return __bfloat162float(*reinterpret_cast<const bf16*>(tile + off));
}

// dp of the one live pair of a window-1 row: the f32 dot product of row
// xr of tile x and row yr of tile y (swizzled, as sw_at reads them), one
// FMA per element in d order (see the note at the top).
template <int D>
__device__ __forceinline__ float dot_rows(const unsigned char* x, int xrows,
                                          int xr, const unsigned char* y,
                                          int yrows, int yr) {
  float acc = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d)
    acc = fmaf(sw_at(x, xrows, xr, d), sw_at(y, yrows, yr, d), acc);
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
// PTX of the Hopper kernels (sm_90a): mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrives once and adds bytes to the phase's expected transactions.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Waits for the phase of the given parity to complete; every thread of the
// warp calls it, and the warp leaves it converged (wgmma's .aligned
// instructions follow). A wrong parity would spin for ever: past ~2^32
// cycles (seconds) the kernel traps, so the launch fails instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) break;
    if (clock64() - t0 > (1LL << 32)) __trap();
  }
  __syncwarp();
}

// One box of a 4-D tensor map into shared memory, completing on bar.
__device__ __forceinline__ void tma_load4(void* dst, const CUtensorMap* map,
                                          uint64_t* bar, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma's shared-memory matrix descriptor of a tile as TMA's 128-byte
// swizzle lays it out: rows of 128 B (64 bf16), 8 rows to a 1024-byte
// atom, atoms 1024 B apart. That is the stride byte offset of both
// layouts used here: K-major (q, k: rows are M or N, 64 of K along a row)
// and MN-major (v: rows are K, 64 of N along a row). The leading byte
// offset is unused by both (K-major: a k16 step lies inside a row;
// MN-major: each product is N = 64, one atom wide), so it is set to the
// same 1024. A k16 step moves the start address: +32 B along a K-major
// row, +16 rows (2048 B) down an MN-major tile.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t addr = smem_addr(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(1024 >> 4) << 16) |
         (uint64_t(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N of this warpgroup's committed product groups
// are pending (groups complete in order).
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins accumulator registers at this point of the program: the compiler
// may not move their reads above a wait, or their writes below a fence.
template <int N>
__device__ __forceinline__ void fence_regs(float (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(x[i][e])::"memory");
}

#define TFT_F4(x) "+f"(x[0]), "+f"(x[1]), "+f"(x[2]), "+f"(x[3])

// The accumulator of m64nNk16 in the layout of mma.sync's C fragments:
// d[nb][e] of warp w is row 16w + g + 8 (e >> 1), column 8 nb + 2t + (e & 1)
// (g = lane / 4, t = lane % 4).

// d (64 x 64) = A . B^T (+ d if accumulate), A (64 x 16) and B (64 x 16)
// K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : TFT_F4(d[0]), TFT_F4(d[1]), TFT_F4(d[2]), TFT_F4(d[3]), TFT_F4(d[4]),
        TFT_F4(d[5]), TFT_F4(d[6]), TFT_F4(d[7])
      : "l"(da), "l"(db), "r"(accumulate));
}

// The same at N = 32.
__device__ __forceinline__ void wgmma_ss(float (&d)[4][4], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : TFT_F4(d[0]), TFT_F4(d[1]), TFT_F4(d[2]), TFT_F4(d[3])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64) += A . B, A (64 x 16) from registers in mma.sync's
// A-fragment layout (warp w: rows 16w..16w+15), B (16 x 64) MN-major in
// shared memory (the transposed-B immediate).
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : TFT_F4(d[0]), TFT_F4(d[1]), TFT_F4(d[2]), TFT_F4(d[3]), TFT_F4(d[4]),
        TFT_F4(d[5]), TFT_F4(d[6]), TFT_F4(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef TFT_F4

// Where the tensor map puts head, row and batch among its outer
// dimensions (1..3): the host orders them by stride.
struct TmaOrder {
  int h, s, b;
};

// One box of q, k or v: columns [c, c + 64) of rows [row, row + rows) of
// head h of batch b.
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map,
                                        uint64_t* bar, TmaOrder o, int c,
                                        int h, int row, int b) {
  const auto at = [&](int pos) {
    return o.h == pos ? h : o.s == pos ? row : b;
  };
  tma_load4(dst, map, bar, c, at(1), at(2), at(3));
}

// ---------------------------------------------------------------------------
// K4 forward, bf16: out, lse (TMA ring, mbarriers, wgmma)
// ---------------------------------------------------------------------------

// Blocks per SM the forward is compiled for. At D64 five: registers are
// capped at 65536 / (5 x 128) = 102 a thread (ptxas -v: 96, 12 bytes
// spilled), against 121 unbound and four blocks, and five blocks' 42 KB
// of shared memory each fit the SM's 227 KB; the fifth block was worth
// about 4% on the card.
template <int D> constexpr int kWgBlocks = D == 64 ? 5 : 2;
constexpr int kStages = 2;  // the k/v ring

// Shared memory of the forward, byte offsets from a 1024-aligned base: q
// (D/64 boxes of 64 rows x 128 B), the ring of k and v tiles (D/64 boxes
// of BN rows each), then the barriers (q's, one per stage).
template <int D, int BN>
struct FwdSmem {
  static constexpr int q_bytes = kBM * D * 2;
  static constexpr int kv_bytes = BN * D * 2;  // one k (or v) tile
  static constexpr int k = q_bytes;
  static constexpr int v = k + kStages * kv_bytes;
  static constexpr int bars = v + kStages * kv_bytes;
  // + slack to align the base
  static constexpr int bytes = bars + 8 * (1 + kStages) + 1024;
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - smem_addr(p) % 1024) % 1024);
}

// The online softmax of one s tile (rows g and g + 8 of this warp, NB
// blocks of 8 columns) into p, in place: the rows' running max m and sum
// l, and corr, each row's rescale of the output so far. Both rows go
// through each step together, so their shuffles and expf overlap.
template <int NB>
__device__ __forceinline__ void online_softmax(float (&s)[NB][4], float (&m)[2],
                                               float (&l)[2], float (&corr)[2],
                                               bool fast) {
  float m_new[2], psum[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mt = s[0][2 * i];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      mt = fmaxf(mt, fmaxf(s[nb][2 * i], s[nb][2 * i + 1]));
    m_new[i] = mt;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) m_new[i] = fmaxf(m[i], quad_max(m_new[i]));
  if (fast) {
    // every row has a live key (its own position), so m_new is finite and
    // exp(-1e30 - m_new) underflows to exactly 0
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = expf(s[nb][e] - m_new[e >> 1]);
#pragma unroll
    for (int i = 0; i < 2; ++i) corr[i] = expf(m[i] - m_new[i]);
  } else {
    float safe_m[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) safe_m[i] = isfinite(m_new[i]) ? m_new[i] : 0.f;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[nb][e] = isfinite(s[nb][e]) ? expf(s[nb][e] - safe_m[e >> 1]) : 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      corr[i] = isfinite(m[i]) ? expf(m[i] - safe_m[i]) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    psum[i] = 0.f;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) psum[i] += s[nb][2 * i] + s[nb][2 * i + 1];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = l[i] * corr[i] + quad_sum(psum[i]);
    m[i] = m_new[i];
  }
}

// One block: 64 query rows of one (batch, head), one warpgroup. Thread 0
// issues every TMA load; the others only wait on the barriers. The
// shared-memory descriptors are built once: a k16 step, a stage or a box
// only adds its byte offset / 16 to the start address field.
template <int D, int BN>
__global__ void __launch_bounds__(kMmaThreads, kWgBlocks<D>)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, Args a,
                           TmaOrder oq, TmaOrder ok, TmaOrder ov) {
  using L = FwdSmem<D, BN>;
  constexpr int DH = D / 64, NB = BN / 8, NK = BN / 16, LD = D + 8;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::bars);  // q, stages
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = (threadIdx.x >> 5) * kRows;  // this warp's rows
  // the causal grid's heaviest tiles (last rows) start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H, S = a.S;
  const bool fast = a.fast;
  const float neg = fast ? kNegLarge : -INFINITY;
  int lo, hi;
  key_range<BN>(a, q0, &lo, &hi);

  // tile j's k and v into stage st (thread 0)
  const auto load_kv = [&](int st, int j) {
    mbar_expect_tx(&bars[1 + st], 2 * L::kv_bytes);
#pragma unroll
    for (int c = 0; c < DH; ++c) {
      tma_box(smem + L::k + st * L::kv_bytes + c * BN * 128, &tk, &bars[1 + st],
              ok, 64 * c, h, j * BN, b);
      tma_box(smem + L::v + st * L::kv_bytes + c * BN * 128, &tv, &bars[1 + st],
              ov, 64 * c, h, j * BN, b);
    }
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < 1 + kStages; ++i) mbar_init(&bars[i], 1);
    mbar_init_fence();
    mbar_expect_tx(&bars[0], L::q_bytes);
#pragma unroll
    for (int c = 0; c < DH; ++c)
      tma_box(smem + c * kBM * 128, &tq, &bars[0], oq, 64 * c, h, q0, b);
    for (int st = 0; st < kStages && lo + st < hi; ++st) load_kv(st, lo + st);
  }
  __syncthreads();  // the barriers are initialised
  const uint64_t q_desc = sw128_desc(smem), k_desc = sw128_desc(smem + L::k),
                 v_desc = sw128_desc(smem + L::v);
  float m[2] = {neg, neg}, l[2] = {0.f, 0.f}, o[DH][8][4];
#pragma unroll
  for (int dh = 0; dh < DH; ++dh) zero(o[dh]);
  mbar_wait(&bars[0], 0);
  for (int j = lo; j < hi; ++j) {
    const int it = j - lo, st = it % kStages;
    const uint32_t stage16 = st * (L::kv_bytes >> 4);
    mbar_wait(&bars[1 + st], (it / kStages) & 1);
    // s = q . k^T: D/16 k16 steps, each +32 B along the rows of one box;
    // the first overwrites s (no zeroing pass)
    float s[NB][4];
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(s, q_desc + (((kk / 4) * kBM * 128 + (kk % 4) * 32) >> 4),
               k_desc + stage16 + (((kk / 4) * BN * 128 + (kk % 4) * 32) >> 4),
               kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    const int k0 = j * BN;
    if (tile_masked(a, q0, kBM, k0, BN)) {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!live(a, q0 + row0 + g + (e >> 1) * 8, k0 + nb * 8 + 2 * t + (e & 1)))
            s[nb][e] = neg;
    }
    float corr[2];
    online_softmax(s, m, l, corr, fast);
#pragma unroll
    for (int dh = 0; dh < DH; ++dh)
#pragma unroll
      for (int nd = 0; nd < 8; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[dh][nd][e] *= corr[e >> 1];
    // o += p . v: p rounded to bf16 into A fragments in registers; v read
    // down its rows, each k16 step 16 rows (2048 B) further
    uint32_t pa[NK][4];
    pack_a(pa, s);
#pragma unroll
    for (int dh = 0; dh < DH; ++dh) fence_regs(o[dh]);
    wgmma_fence();
#pragma unroll
    for (int dh = 0; dh < DH; ++dh)
#pragma unroll
      for (int kc = 0; kc < NK; ++kc)
        wgmma_rs(o[dh], pa[kc],
                 v_desc + stage16 + ((dh * BN * 128 + kc * 2048) >> 4));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int dh = 0; dh < DH; ++dh) fence_regs(o[dh]);
    __syncthreads();  // every warp's products have read this stage
    if (threadIdx.x == 0 && j + kStages < hi) load_kv(st, j + kStages);
  }
  // each warp stages its rows in its own 16 rows of padded shared memory
  // (q and the ring are no longer read: every load was waited for)
  float l_safe[2];
  float* lse = static_cast<float*>(a.out1) + static_cast<int64_t>(bh) * S;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_safe[i] = fmaxf(l[i], 1e-30f);
    const int r = q0 + row0 + g + 8 * i;
    if (t == 0 && r < S)
      lse[r] = (fast || isfinite(m[i])) ? m[i] + logf(l_safe[i]) : -INFINITY;
  }
  store_rows<D>(static_cast<bf16*>(a.out0),
                reinterpret_cast<bf16*>(smem) + row0 * LD,
                reinterpret_cast<const float(&)[D / 8][4]>(o), l_safe, a, b, h,
                q0 + row0);
}

// One wgmma tile product of each kind the kernels use, for the card
// tests: c (64 x 64 f32) = a . b^T with a and b K-major in shared memory
// (mn_major 0, as s = q . k^T, s^T = k . q^T and the dp products), or
// a . b with a in registers and b MN-major (mn_major 1, as o = p . v,
// dq = ds . k, dv = p^T . do and dk = ds^T . q). a and b are contiguous 64 x 64
// bf16 and come in through the forward's tensor maps.
__global__ void __launch_bounds__(kMmaThreads)
    wgmma_tile_test_kernel(const __grid_constant__ CUtensorMap ta,
                           const __grid_constant__ CUtensorMap tb,
                           const bf16* a, float* c, int mn_major) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* As = smem;
  unsigned char* Bs = smem + 8192;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + 16384);
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_init_fence();
    mbar_expect_tx(bar, mn_major ? 8192 : 16384);
    if (!mn_major) tma_load4(As, &ta, bar, 0, 0, 0, 0);
    tma_load4(Bs, &tb, bar, 0, 0, 0, 0);
  }
  __syncthreads();
  mbar_wait(bar, 0);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = (threadIdx.x >> 5) * kRows;
  float d[8][4];
  zero(d);
  fence_regs(d);
  if (!mn_major) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss(d, sw128_desc(As + kk * 32), sw128_desc(Bs + kk * 32), 1);
  } else {
    uint32_t af[4][4];
    const auto pair = [&](int r, int col) {
      return *reinterpret_cast<const uint32_t*>(a + r * 64 + col);
    };
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      af[kc][0] = pair(row0 + g, 16 * kc + 2 * t);
      af[kc][1] = pair(row0 + g + 8, 16 * kc + 2 * t);
      af[kc][2] = pair(row0 + g, 16 * kc + 8 + 2 * t);
      af[kc][3] = pair(row0 + g + 8, 16 * kc + 8 + 2 * t);
    }
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) wgmma_rs(d, af[kc], sw128_desc(Bs + kc * 2048));
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d);
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      c[(row0 + g + 8 * (e >> 1)) * 64 + nb * 8 + 2 * t + (e & 1)] = d[nb][e];
}

// ---------------------------------------------------------------------------
// K5 backward, bf16: dq with delta, then dk and dv (TMA rings, mbarriers,
// wgmma)
// ---------------------------------------------------------------------------

// Blocks per SM the backward kernels are compiled for (registers capped at
// 65536 / (blocks x 128)), as K4's, chosen in turns on the card: at D64 dq
// fits four (128 registers, no spill; 4% faster than three), dk/dv three
// (168; at four, 126 registers and 504 B spilled made it 1.66x slower).
// D128 takes two of each (up to 250 registers, no spill).
template <int D> constexpr int kDqBlocks = D == 64 ? 4 : 2;
template <int D> constexpr int kDkdvBlocks = D == 64 ? 3 : 2;

// exp(x) as ex2.approx(x log2e): a multiply and the SFU's 2^x, where the
// accurate expf is a range reduction, an ex2 and a rescale (see the note
// at the top).
__device__ __forceinline__ float exp_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// Descriptor offsets, in 16-byte units, into a swizzled tile of boxes of
// `rows` rows: k16 step kk of a K-major operand (+32 B along a row, the
// next box every 4 steps), and k16 step kc over the 64 columns of box dh
// of an MN-major one (+16 rows, 2048 B).
__device__ __forceinline__ uint32_t kmajor_step(int kk, int rows) {
  return ((kk / 4) * rows * 128 + (kk % 4) * 32) >> 4;
}
__device__ __forceinline__ uint32_t mnmajor_step(int dh, int kc, int rows) {
  return (dh * rows * 128 + kc * 2048) >> 4;
}

// delta = rowsum(do * out) of the kBM rows from q0 of head h of batch b,
// into delta_s and rows < S of the (B, H, S) f32 delta (a.out1): thread r
// < kBM takes row r through 16-byte loads as one chain of FMAs in d order
// (a bf16 product is exact in f32, so this is the plain version's chain
// of adds bit for bit, and in window 1, where out = v, it is dot_rows's
// dp: ds is then exactly 0). Rows past S give 0.
template <int D>
__device__ __forceinline__ void fold_delta(const Args& a, int b, int h,
                                           int q0, float* delta_s) {
  const int r = threadIdx.x, s = q0 + r;
  if (r >= kBM) return;
  float acc = 0.f;
  if (s < a.S) {
    const uint4* x = reinterpret_cast<const uint4*>(
        static_cast<const bf16*>(a.dout) + b * a.sdo[0] + s * a.sdo[1] +
        h * a.sdo[2]);
    const uint4* y = reinterpret_cast<const uint4*>(
        static_cast<const bf16*>(a.o) + b * a.so[0] + s * a.so[1] +
        h * a.so[2]);
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const uint4 xv = __ldg(x + c), yv = __ldg(y + c);
      const bf16* xe = reinterpret_cast<const bf16*>(&xv);
      const bf16* ye = reinterpret_cast<const bf16*>(&yv);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc = fmaf(__bfloat162float(xe[e]), __bfloat162float(ye[e]), acc);
    }
    static_cast<float*>(a.out1)[static_cast<int64_t>(b * a.H + h) * a.S + s] =
        acc;
  }
  delta_s[r] = acc;
}

// Shared memory of the dq kernel, byte offsets from a 1024-aligned base:
// q and do (D/64 boxes of 64 rows each), the ring of k and v tiles (D/64
// boxes of BN rows), delta of the block's rows, then the barriers (q and
// do's, one per stage).
template <int D, int BN>
struct DqSmem {
  static constexpr int q_bytes = kBM * D * 2;  // q (or do)
  static constexpr int kv_bytes = BN * D * 2;  // one k (or v) tile
  static constexpr int dO = q_bytes;
  static constexpr int k = 2 * q_bytes;
  static constexpr int v = k + kStages * kv_bytes;
  static constexpr int delta = v + kStages * kv_bytes;
  static constexpr int bars = delta + kBM * 4;
  // + slack to align the base
  static constexpr int bytes = bars + 8 * (1 + kStages) + 1024;
};

// One block: 64 query rows of one (batch, head), one warpgroup, laid out
// as the forward; thread 0 issues every TMA load.
template <int D, int BN>
__global__ void __launch_bounds__(kMmaThreads, kDqBlocks<D>)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tdo, Args a,
                              TmaOrder oq, TmaOrder ok, TmaOrder ov,
                              TmaOrder odo) {
  using L = DqSmem<D, BN>;
  constexpr int DH = D / 64, NB = BN / 8, NK = BN / 16, LD = D + 8;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::bars);  // q, stages
  float* delta_s = reinterpret_cast<float*>(smem + L::delta);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = (threadIdx.x >> 5) * kRows;  // this warp's rows
  // the causal grid's heaviest tiles (last rows) start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H, S = a.S;
  int lo, hi;
  key_range<BN>(a, q0, &lo, &hi);

  // tile j's k and v into stage st (thread 0)
  const auto load_kv = [&](int st, int j) {
    mbar_expect_tx(&bars[1 + st], 2 * L::kv_bytes);
#pragma unroll
    for (int c = 0; c < DH; ++c) {
      tma_box(smem + L::k + st * L::kv_bytes + c * BN * 128, &tk, &bars[1 + st],
              ok, 64 * c, h, j * BN, b);
      tma_box(smem + L::v + st * L::kv_bytes + c * BN * 128, &tv, &bars[1 + st],
              ov, 64 * c, h, j * BN, b);
    }
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < 1 + kStages; ++i) mbar_init(&bars[i], 1);
    mbar_init_fence();
    mbar_expect_tx(&bars[0], 2 * L::q_bytes);
#pragma unroll
    for (int c = 0; c < DH; ++c) {
      tma_box(smem + c * kBM * 128, &tq, &bars[0], oq, 64 * c, h, q0, b);
      tma_box(smem + L::dO + c * kBM * 128, &tdo, &bars[0], odo, 64 * c, h,
              q0, b);
    }
    for (int st = 0; st < kStages && lo + st < hi; ++st) load_kv(st, lo + st);
  }
  // while the tiles arrive: delta of this block's rows, for dq here and
  // for dk/dv after it
  fold_delta<D>(a, b, h, q0, delta_s);
  __syncthreads();  // the barriers are initialised, delta_s written
  const float* lse = a.lse_in + static_cast<int64_t>(bh) * S;
  float lse_r[2], delta_r[2];  // rows g and g + 8
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + g + 8 * i;
    lse_r[i] = q0 + r < S ? lse[q0 + r] : 0.f;
    delta_r[i] = delta_s[r];
  }
  const uint64_t q_desc = sw128_desc(smem), do_desc = sw128_desc(smem + L::dO),
                 k_desc = sw128_desc(smem + L::k),
                 v_desc = sw128_desc(smem + L::v);
  float dq[DH][8][4];
#pragma unroll
  for (int dh = 0; dh < DH; ++dh) zero(dq[dh]);
  mbar_wait(&bars[0], 0);
  for (int j = lo; j < hi; ++j) {
    const int it = j - lo, st = it % kStages;
    const uint32_t stage16 = st * (L::kv_bytes >> 4);
    mbar_wait(&bars[1 + st], (it / kStages) & 1);
    // s = q . k^T and dp = do . v^T, both operands K-major; the first k16
    // step of each overwrites it
    float s[NB][4], dp[NB][4];
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(s, q_desc + kmajor_step(kk, kBM),
               k_desc + stage16 + kmajor_step(kk, BN), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(dp, do_desc + kmajor_step(kk, kBM),
               v_desc + stage16 + kmajor_step(kk, BN), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    const int k0 = j * BN;
    const bool masked = tile_masked(a, q0, kBM, k0, BN);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = row0 + g + (e >> 1) * 8, ki = nb * 8 + 2 * t + (e & 1);
        float p = exp_approx(s[nb][e] - lse_r[e >> 1]);
        if (masked && !live(a, q0 + qi, k0 + ki)) p = 0.f;
        const float dpe =
            a.window == 1 && q0 + qi == k0 + ki
                ? dot_rows<D>(smem + L::dO, kBM, qi,
                              smem + L::v + st * L::kv_bytes, BN, ki)
                : dp[nb][e];
        s[nb][e] = p * (dpe - delta_r[e >> 1]);  // ds
      }
    // dq += ds . k: ds rounded to bf16 into A fragments (its one
    // rounding); the same k tile read down its rows (MN-major), n64 per
    // 64 columns of D
    uint32_t da[NK][4];
    pack_a(da, s);
#pragma unroll
    for (int dh = 0; dh < DH; ++dh) fence_regs(dq[dh]);
    wgmma_fence();
#pragma unroll
    for (int dh = 0; dh < DH; ++dh)
#pragma unroll
      for (int kc = 0; kc < NK; ++kc)
        wgmma_rs(dq[dh], da[kc], k_desc + stage16 + mnmajor_step(dh, kc, BN));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int dh = 0; dh < DH; ++dh) fence_regs(dq[dh]);
    __syncthreads();  // every warp's products have read this stage
    if (threadIdx.x == 0 && j + kStages < hi) load_kv(st, j + kStages);
  }
  // each warp stages its rows in its own 16 rows of padded shared memory
  // (q, do and the ring are no longer read: every load was waited for)
  const float one[2] = {1.f, 1.f};
  store_rows<D>(static_cast<bf16*>(a.out0),
                reinterpret_cast<bf16*>(smem) + row0 * LD,
                reinterpret_cast<const float(&)[D / 8][4]>(dq), one, a, b, h,
                q0 + row0);
}

// Shared memory of the dk/dv kernel, byte offsets from a 1024-aligned
// base: k and v (D/64 boxes of 64 rows each), the ring of q and do tiles,
// the ring of lse and delta rows (kBM f32 each), then the barriers (k and
// v's, one per stage).
template <int D>
struct DkdvSmem {
  static constexpr int t_bytes = kBM * D * 2;  // one tile of k, v, q or do
  static constexpr int v = t_bytes;
  static constexpr int q = 2 * t_bytes;
  static constexpr int dO = q + kStages * t_bytes;
  static constexpr int lse = dO + kStages * t_bytes;
  static constexpr int delta = lse + kStages * kBM * 4;
  static constexpr int bars = delta + kStages * kBM * 4;
  // + slack to align the base
  static constexpr int bytes = bars + 8 * (1 + kStages) + 1024;
};

// One block: 64 keys of one (batch, head), one warpgroup (warp w owns keys
// 16w..16w+15), looping over the query tiles that see them. Thread 0
// issues the TMA loads; every thread copies one lse or delta value a tile.
template <int D>
__global__ void __launch_bounds__(kMmaThreads, kDkdvBlocks<D>)
    flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                const __grid_constant__ CUtensorMap tdo,
                                Args a, TmaOrder oq, TmaOrder ok, TmaOrder ov,
                                TmaOrder odo) {
  using L = DkdvSmem<D>;
  constexpr int DH = D / 64, LD = D + 8;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::bars);  // k/v, stages
  const float* lse_s = reinterpret_cast<const float*>(smem + L::lse);
  const float* delta_s = reinterpret_cast<const float*>(smem + L::delta);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = (threadIdx.x >> 5) * kRows;  // this warp's keys
  // the causal grid's heaviest tiles (first keys) start first
  const int k0 = blockIdx.x * kBM;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H, S = a.S;
  const float* lse = a.lse_in + static_cast<int64_t>(bh) * S;
  const float* delta = a.delta + static_cast<int64_t>(bh) * S;
  int lo, hi;
  query_range<kBM>(a, k0, &lo, &hi);

  // query tile i's q and do into stage st (thread 0)
  const auto load_qdo = [&](int st, int i) {
    mbar_expect_tx(&bars[1 + st], 2 * L::t_bytes);
#pragma unroll
    for (int c = 0; c < DH; ++c) {
      tma_box(smem + L::q + st * L::t_bytes + c * kBM * 128, &tq,
              &bars[1 + st], oq, 64 * c, h, i * kBM, b);
      tma_box(smem + L::dO + st * L::t_bytes + c * kBM * 128, &tdo,
              &bars[1 + st], odo, 64 * c, h, i * kBM, b);
    }
  };
  // query tile i's lse (threads 0-63) and delta (64-127) into stage st,
  // zero past S: one 4-byte copy a thread, one commit group
  const auto load_vecs = [&](int st, int i) {
    const int e = threadIdx.x % kBM, s = i * kBM + e;
    const bool first = threadIdx.x < kBM;
    const float* src = first ? lse : delta;
    cp_async4(smem + (first ? L::lse : L::delta) + (st * kBM + e) * 4,
              s < S ? src + s : src, s < S ? 4 : 0);
    cp_async_commit();
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < 1 + kStages; ++i) mbar_init(&bars[i], 1);
    mbar_init_fence();
    mbar_expect_tx(&bars[0], 2 * L::t_bytes);
#pragma unroll
    for (int c = 0; c < DH; ++c) {
      tma_box(smem + c * kBM * 128, &tk, &bars[0], ok, 64 * c, h, k0, b);
      tma_box(smem + L::v + c * kBM * 128, &tv, &bars[0], ov, 64 * c, h, k0,
              b);
    }
    for (int st = 0; st < kStages && lo + st < hi; ++st) load_qdo(st, lo + st);
  }
  for (int st = 0; st < kStages && lo + st < hi; ++st) load_vecs(st, lo + st);
  cp_async_wait<0>();
  __syncthreads();  // the barriers are initialised, both stages' rows landed
  const uint64_t k_desc = sw128_desc(smem), v_desc = sw128_desc(smem + L::v),
                 q_desc = sw128_desc(smem + L::q),
                 do_desc = sw128_desc(smem + L::dO);
  float dk[DH][8][4], dv[DH][8][4];
#pragma unroll
  for (int dh = 0; dh < DH; ++dh) {
    zero(dk[dh]);
    zero(dv[dh]);
  }
  mbar_wait(&bars[0], 0);
  for (int i = lo; i < hi; ++i) {
    const int it = i - lo, st = it % kStages;
    const uint32_t stage16 = st * (L::t_bytes >> 4);
    mbar_wait(&bars[1 + st], (it / kStages) & 1);
    // s^T = k . q^T and dp^T = v . do^T: rows keys, columns queries, both
    // operands K-major
    float sT[8][4], dpT[8][4];
    fence_regs(sT);
    fence_regs(dpT);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(sT, k_desc + kmajor_step(kk, kBM),
               q_desc + stage16 + kmajor_step(kk, kBM), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(dpT, v_desc + kmajor_step(kk, kBM),
               do_desc + stage16 + kmajor_step(kk, kBM), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sT);
    fence_regs(dpT);
    const int q0 = i * kBM;
    const bool masked = tile_masked(a, q0, kBM, k0, kBM);
    const float* lse_t = lse_s + st * kBM;
    const float* delta_t = delta_s + st * kBM;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      // lse and delta of this thread's two query columns 2t, 2t + 1
      const float2 lse2 = *reinterpret_cast<const float2*>(lse_t + nb * 8 + 2 * t);
      const float2 delta2 =
          *reinterpret_cast<const float2*>(delta_t + nb * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = nb * 8 + 2 * t + (e & 1), ki = row0 + g + (e >> 1) * 8;
        float p = exp_approx(sT[nb][e] - (e & 1 ? lse2.y : lse2.x));
        if (masked && !live(a, q0 + qi, k0 + ki)) p = 0.f;
        const float dp =
            a.window == 1 && q0 + qi == k0 + ki
                ? dot_rows<D>(smem + L::dO + st * L::t_bytes, kBM, qi,
                              smem + L::v, kBM, ki)
                : dpT[nb][e];
        sT[nb][e] = p;
        dpT[nb][e] = p * (dp - (e & 1 ? delta2.y : delta2.x));  // ds^T
      }
    }
    // dv += p^T . do and dk += ds^T . q: p^T rounded to do's dtype and
    // ds^T to q's (its one rounding) into A fragments; do and q read down
    // their rows (MN-major), n64 per 64 columns of D
    uint32_t pa[4][4], da[4][4];
    pack_a(pa, sT);
    pack_a(da, dpT);
#pragma unroll
    for (int dh = 0; dh < DH; ++dh) {
      fence_regs(dk[dh]);
      fence_regs(dv[dh]);
    }
    wgmma_fence();
#pragma unroll
    for (int dh = 0; dh < DH; ++dh)
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
        wgmma_rs(dv[dh], pa[kc], do_desc + stage16 + mnmajor_step(dh, kc, kBM));
#pragma unroll
    for (int dh = 0; dh < DH; ++dh)
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
        wgmma_rs(dk[dh], da[kc], q_desc + stage16 + mnmajor_step(dh, kc, kBM));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int dh = 0; dh < DH; ++dh) {
      fence_regs(dk[dh]);
      fence_regs(dv[dh]);
    }
    cp_async_wait<0>();  // this thread's lse/delta copy of the next tile
    __syncthreads();  // this stage is free; the next tile's rows are visible
    if (i + kStages < hi) {
      if (threadIdx.x == 0) load_qdo(st, i + kStages);
      load_vecs(st, i + kStages);
    }
  }
  // staged in shared memory that is no longer read (every load was waited
  // for): dk in the first kBM padded rows, dv in the next
  const float one[2] = {1.f, 1.f};
  store_rows<D>(static_cast<bf16*>(a.out0),
                reinterpret_cast<bf16*>(smem) + row0 * LD,
                reinterpret_cast<const float(&)[D / 8][4]>(dk), one, a, b, h,
                k0 + row0);
  store_rows<D>(static_cast<bf16*>(a.out1),
                reinterpret_cast<bf16*>(smem) + (kBM + row0) * LD,
                reinterpret_cast<const float(&)[D / 8][4]>(dv), one, a, b, h,
                k0 + row0);
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
  const float* o = static_cast<const float*>(a.o) + b * a.so[0] + h * a.so[2];
  const float* lse = a.lse_in + static_cast<int64_t>(bh) * S;
  float* delta = static_cast<float*>(a.out1) + static_cast<int64_t>(bh) * S;

  load_tile<D>(Qs, LD, q, a.sq[1], q0, kBM, S);
  load_tile<D>(dOs, LD, dout, a.sdo[1], q0, kBM, S);
  float lse_r[4], delta_r[4], dq[4][CD];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + tr * 4 + i;
    lse_r[i] = r < S ? lse[r] : 0.f;
    // delta = rowsum(do * out), folded in as in the bf16 kernel: this
    // thread's D/16 columns, then the row's 16 threads (written for dk/dv)
    float part = 0.f;
    if (r < S) {
#pragma unroll
      for (int c = 0; c < CD; ++c)
        part = fmaf(dout[r * a.sdo[1] + tc + 16 * c],
                    o[r * a.so[1] + tc + 16 * c], part);
    }
    delta_r[i] = row_sum16(part);
    if (tc == 0 && r < S) delta[r] = delta_r[i];
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
// A tensor-map kernel (every bf16 one) takes its maps (q, k, v, and do for
// the backward), Args and the maps' orders; the f32 kernels take Args
// alone.
struct Launch {
  const void* kernel;
  dim3 grid;
  int threads;
  size_t smem;
  int maps;     // tensor maps: 0, 3 (q, k, v) or 4 (q, k, v, do)
  int kv_rows;  // rows of a k or v box (q and do boxes are kBM rows)
};

template <int D, int BN>
Launch plan_mma(Kind kind, int S, int bh) {
  const unsigned nq = (S + kBM - 1) / kBM;
  switch (kind) {
    case kFwd:
      return {reinterpret_cast<const void*>(&flash_fwd_wgmma_kernel<D, BN>),
              dim3(nq, bh), kMmaThreads, FwdSmem<D, BN>::bytes, 3, BN};
    case kDkdv:  // 64-key tiles whatever BN is (see the note at the top)
      return {reinterpret_cast<const void*>(&flash_bwd_dkdv_wgmma_kernel<D>),
              dim3(nq, bh), kMmaThreads, DkdvSmem<D>::bytes, 4, kBM};
    default:
      return {reinterpret_cast<const void*>(&flash_bwd_dq_wgmma_kernel<D, BN>),
              dim3(nq, bh), kMmaThreads, DqSmem<D, BN>::bytes, 4, BN};
  }
}

template <int D, int BN>
Launch plan_f32(Kind kind, int S, int bh) {
  const unsigned nq = (S + kBM - 1) / kBM, nk = (S + BN - 1) / BN;
  switch (kind) {
    case kFwd:
      return {reinterpret_cast<const void*>(&flash_fwd_kernel<D, BN>),
              dim3(nq, bh), kThreads, fwd_f32_smem<D, BN>(), 0, 0};
    case kDkdv:
      return {reinterpret_cast<const void*>(&flash_bwd_dkdv_kernel<D, BN>),
              dim3(nk, bh), kThreads, dkdv_f32_smem<D, BN>(), 0, 0};
    default:
      return {reinterpret_cast<const void*>(&flash_bwd_dq_kernel<D, BN>),
              dim3(nq, bh), kThreads, dq_f32_smem<D, BN>(), 0, 0};
  }
}

// dtype 0 (f32): the scalar kernels; 1 (bf16): the tensor-core kernels
// (wgmma, tiles by TMA).
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

// libcuda's cuTensorMapEncodeTiled, found through the runtime's entry
// point query: this library links no libcuda of its own.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// q, k or v (B, S, H, D) bf16 with (batch, seq, head) strides s, in
// elements, as a 4-D tensor map read in boxes of 64 columns x `rows` rows
// with the 128-byte swizzle; rows past S read as zeros. D is innermost;
// head, row and batch follow in the order of their strides (so a permuted
// view maps as well as the qkv split), an extent-1 dimension last (its
// stride is never used). *ord says where each went.
bool encode_map(CUtensorMap* map, TmaOrder* ord, const void* base, int B,
                int S, int H, int D, const int64_t* s, int rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const int64_t ext[3] = {H, S, B};      // head, row, batch
  const int64_t str[3] = {s[2], s[1], s[0]};
  int64_t last = D;  // a stride past every used one, for extent-1 dims
  for (int i = 0; i < 3; ++i)
    if (ext[i] > 1) last = str[i] * ext[i] > last ? str[i] * ext[i] : last;
  int64_t key[3];
  int idx[3] = {0, 1, 2};
  for (int i = 0; i < 3; ++i) key[i] = ext[i] > 1 ? str[i] : last;
  for (int i = 1; i < 3; ++i)  // insertion sort by key, stable
    for (int j = i; j > 0 && key[idx[j]] < key[idx[j - 1]]; --j) {
      const int x = idx[j];
      idx[j] = idx[j - 1];
      idx[j - 1] = x;
    }
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(D)};
  cuuint64_t strides[3];
  cuuint32_t box[4] = {64, 1, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  int pos[3];
  for (int r = 0; r < 3; ++r) {
    const int i = idx[r];
    pos[i] = r + 1;
    dims[r + 1] = static_cast<cuuint64_t>(ext[i]);
    strides[r] = static_cast<cuuint64_t>(2 * key[i]);  // bytes
    if (i == 1) box[r + 1] = static_cast<cuuint32_t>(rows);
  }
  *ord = {pos[0], pos[1], pos[2]};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// strides: (batch, seq, head) of q, k, v and, for the backward, do, and
// for dq out (the forward reads 9 values, dk/dv 12, dq 15).
int dispatch(Kind kind, const void* q, const void* k, const void* v,
             const void* dout, const void* o, const void* lse_in,
             const void* delta, void* out0, void* out1, int dtype, int B,
             int S, int H, int D, const int64_t* strides, int causal,
             int window, int block_k, int fast, void* stream) {
  Launch l;
  if (B <= 0 || S <= 0 || H <= 0 || B * H > 65535 ||
      !plan(kind, dtype, D, block_k, S, B * H, &l))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_strides = kind == kFwd ? 9 : kind == kDkdv ? 12 : 15;
  if (dtype == 1) {  // TMA and the 16-byte loads move 16-byte rows: 8 bf16
    for (int i = 0; i < n_strides; ++i)
      if (strides[i] % 8 != 0) return static_cast<int>(cudaErrorMisalignedAddress);
    if (!aligned16(q) || !aligned16(k) || !aligned16(v) ||
        (kind != kFwd && !aligned16(dout)) || (kind == kDq && !aligned16(o)) ||
        !aligned16(out0) || (kind == kDkdv && !aligned16(out1)))
      return static_cast<int>(cudaErrorMisalignedAddress);
  }
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.o = o;
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
    a.so[i] = kind == kDq ? strides[12 + i] : 0;
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
  // the tensor maps are encoded at every launch: host code, legal during
  // capture too (a graph keeps the parameters it was launched with)
  CUtensorMap maps[4];
  TmaOrder ords[4];
  void* params3[] = {&maps[0], &maps[1], &maps[2], &a,
                     &ords[0], &ords[1], &ords[2]};
  void* params4[] = {&maps[0], &maps[1], &maps[2], &maps[3], &a,
                     &ords[0], &ords[1], &ords[2], &ords[3]};
  void* params0[] = {&a};
  const void* src[4] = {q, k, v, dout};
  for (int i = 0; i < l.maps; ++i)  // q and do in kBM-row boxes
    if (!encode_map(&maps[i], &ords[i], src[i], B, S, H, D, strides + 3 * i,
                    i == 1 || i == 2 ? l.kv_rows : kBM))
      return static_cast<int>(cudaErrorInvalidValue);
  err = cudaLaunchKernel(
      l.kernel, l.grid, dim3(l.threads),
      l.maps == 4 ? params4 : l.maps == 3 ? params3 : params0, l.smem,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int tft_flash_fwd(const void* q, const void* k, const void* v, void* out,
                  void* lse, int dtype, int B, int S, int H, int D,
                  const int64_t* strides, int causal, int window, int block_k,
                  int fast, void* stream) {
  return dispatch(kFwd, q, k, v, nullptr, nullptr, nullptr, nullptr, out, lse,
                  dtype, B, S, H, D, strides, causal, window, block_k, fast,
                  stream);
}

// The backward's second launch: dk, dv from delta as the dq launch wrote
// it (strides: q, k, v, do).
int tft_flash_bwd_dkdv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int dtype, int B, int S, int H,
                       int D, const int64_t* strides, int causal, int window,
                       int block_k, int fast, void* stream) {
  return dispatch(kDkdv, q, k, v, dout, nullptr, lse, delta, dk, dv, dtype, B,
                  S, H, D, strides, causal, window, block_k, fast, stream);
}

// The backward's first launch: dq, and delta = rowsum(do * out) into the
// (B, H, S) f32 buffer delta (strides: q, k, v, do, out).
int tft_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* dout, const void* out, const void* lse,
                     void* delta, void* dq, int dtype, int B, int S, int H,
                     int D, const int64_t* strides, int causal, int window,
                     int block_k, int fast, void* stream) {
  return dispatch(kDq, q, k, v, dout, out, lse, nullptr, dq, delta, dtype, B,
                  S, H, D, strides, causal, window, block_k, fast, stream);
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

// One wgmma tile product through the kernels' tensor maps and
// descriptors, for the card tests: c (64 x 64 f32, contiguous) = a . b^T
// (mn_major 0: both operands K-major in shared memory, as s = q . k^T) or
// a . b (mn_major 1: a from registers, b MN-major, as o = p . v); a and b
// contiguous 64 x 64 bf16.
int tft_wgmma_tile_test(const void* a, const void* b, void* c, int mn_major,
                        void* stream) {
  const int64_t s[3] = {64 * 64, 64, 64};
  CUtensorMap ta, tb;
  TmaOrder ord;
  if (!aligned16(a) || !aligned16(b) ||
      !encode_map(&ta, &ord, a, 1, 64, 1, 64, s, 64) ||
      !encode_map(&tb, &ord, b, 1, 64, 1, 64, s, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  wgmma_tile_test_kernel<<<1, kMmaThreads, 16384 + 8 + 1024,
                           static_cast<cudaStream_t>(stream)>>>(
      ta, tb, static_cast<const bf16*>(a), static_cast<float*>(c), mn_major);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
