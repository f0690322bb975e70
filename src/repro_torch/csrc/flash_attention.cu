// Forward flash attention (online softmax) for Hopper (sm_90a).
//
// Replaces the TPU kernel `flash_attention_bhsd` of the JAX package
// (src/repro/kernels/flash_attention.py:91, body `_flash_kernel` :32).
// For q (B,H,Sq,Dh) and k, v (B,Hkv,Sk,Dh), H % Hkv == 0, it computes
//
//     out[b,h,i] = sum_j softmax_j(s_ij) v[b,h/(H/Hkv),j],
//     s_ij = (q_i . k_j) * (1/sqrt(Dh))   where the masks allow (i, j),
//     s_ij = -1e30                        elsewhere,
//
// with the masks of the TPU kernel: key j < Sk; causal: j <= i; window
// w > 0: j > i - w.  The running max m, sum l and accumulator are fp32
// and the masked sentinel is the FINITE -1e30, as in the TPU kernel: with
// -inf a row that is wholly masked inside a partly covered tile would give
// exp(-inf - -inf) = NaN; with -1e30 such a row adds exp(0) = 1 per key,
// and that garbage is wiped exactly by corr = exp(m_prev - m_new) = 0 when
// its first real score arrives.  l is floored at 1e-30 in the epilogue.
// Every operand is addressed through its (batch, head, sequence) strides,
// so the model's (B,S,H,Dh) layout is read and written in place; the head
// dim has stride 1.  Two kernels, by q's type:
//
// fp32: `flash_fwd_kernel`, on the CUDA cores, with the TPU kernel's
// arithmetic: the scale multiplies the finished fp32 q.k dot and both
// products are fp32 FMAs.  One block per (q-tile of 64 rows, head,
// batch); the loop over 64-key tiles carries m, l and the accumulator in
// registers.  256 threads as 16 x 16: thread (ty, tx) owns rows ty + 16i
// (i < 4) and, for the scores, key columns tx + 16j (j < 4); for the
// accumulator, head-dim columns tx + 16j.  q stays in shared memory; each
// k/v tile and the tile of probabilities pass through shared memory, rows
// padded by one float.  The masks are a range of keys a row (lo <= key <=
// hi): two compares a score and no branch.  A tile's first row is a
// 64-bit offset and a row inside it an int, so a load costs no 64-bit
// multiply by a stride read from the arguments (ops.py keeps sequence
// strides below 2^31 / 64).  Its ceiling is the 67 TFLOP/s fp32 rate.
// Shared memory is (64*(Dh+1)*2 + 64*Dh + 64*65) floats: 29 KB at Dh=16,
// 66 KB at Dh=64, 214 KB at Dh=256.
//
// bf16: `flash_fwd_kernel_wgmma`, on the tensor cores.  Bound: operations.
// At the LM serving slice's shape (B=8, H=32, Hkv=4, S=1920, Dh=64,
// causal) a call needs 4*Dh*B*H*S(S+1)/2 = 1.21e11 FLOP for 1.4e8 bytes
// of q, k, v and out: some 850 FLOP a byte, far above the card's ridge
// point (295), so the bound is the bf16 tensor-core rate, 989 TFLOP/s
// (0.122 ms).  At Dh=64 the softmax is the second limit: each score costs
// 256 tensor-core FLOP but also one exp2 on the SM's 16 special-function
// lanes a clock, which together cap the kernel near half the tensor rate.
// What the design does about it:
//   - Both products are `wgmma` m64nNk16 bf16 -> fp32.  S = Q K^T reads Q
//     and K from shared memory (K-major, 128-byte swizzle) in Dh/16 steps;
//     bf16 x bf16 products are exact in fp32, so S is the TPU kernel's
//     fp32 dot of upcast operands, summed in another order.
//   - P stays in registers: the m64nNk16 accumulator layout of S is the
//     register A-fragment of the next k16 step, so p is rounded to bf16
//     once and fed to O += P V (V from shared memory, MN-major, the
//     transpose bit), and never touches shared memory.  l is summed from
//     the fp32 p before rounding.  exp is exp2 with scale * log2(e)
//     folded into the scores.
//   - The softmax of key tile i runs while the tensor cores compute
//     P_{i-1} V_{i-1}: iteration i issues S_i = Q K_i^T and then
//     O += P_{i-1} V_{i-1} (two commit groups), waits for the first,
//     runs the softmax of S_i, waits for the second, and only then
//     rescales O and packs P_i.
//   - One producer thread issues TMA loads (one 4-d tensor map each for q,
//     k and v, built on the host from the tensor's strides) into a ring
//     of two K/V stages.  Completion and release are mbarriers, K and V
//     apart: a K stage is refilled as soon as S has read it, a V stage
//     once P V has, so each K load starts an iteration ahead of its use.
//     setmaxnreg moves registers from the producer to the consumers.
//   - The two consumer warpgroups take turns to issue their products
//     (named barriers 1 and 2), so one's softmax overlaps the other's
//     tensor-core work instead of both competing for the exp2 units at
//     once.
//     TMA zero-fills rows past Sq or Sk and head-dim columns past Dh, so
//     Dh = 16 and 32 run as a padded 64, and 96 as a padded 128.
//   - Consumer warpgroups own 64 query rows each (BQ = 128 at padded Dh
//     <= 128, 64 at 256); BK = 128 keys at padded Dh 64, else 64.  The
//     scale and masks are applied on the accumulator fragment, element
//     by element only in tiles that a mask cuts; key tiles wholly above
//     the diagonal end the loop and tiles wholly outside the window are
//     skipped, as in the TPU kernel; the q-tiles run longest first (the
//     slowest grid axis, reversed) so long causal tiles do not finish
//     last.
//   - Row max and the final row sum reduce over the thread's own columns
//     and then its quad (__shfl_xor_sync 1 and 2).  The epilogue
//     multiplies by 1 / max(l, 1e-30) (one division a row, not one an
//     element), rounds to bf16 once and stores through the out
//     strides, rows >= Sq clipped.
// Shared memory (Q + 2 stages of K and V, bf16, + 1 KB alignment):
//   padded Dh  64: BQ 128, BK 128: 16 KB + 2 x 2 x 16 KB = 80 KB
//   padded Dh 128: BQ 128, BK  64: 32 KB + 2 x 2 x 16 KB = 96 KB
//   padded Dh 256: BQ  64, BK  64: 32 KB + 2 x 2 x 32 KB = 160 KB
// Threads: 128 a consumer warpgroup + one producer warpgroup (one thread
// of it issues the loads): 384 at padded Dh <= 128, where setmaxnreg
// gives the consumers 232 registers and the producer 40 (ptxas allots
// 168 a thread at launch, the 384-thread bound), 256 at 256 (ptxas: about
// 200).  ptxas reports no spills and no stack for any head dim.
#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Passed by value from the ctypes wrapper (kernels/ops.py mirrors it).
struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  // element strides (batch, head, sequence) of q, k, v and out, each
  // indexed as (B,H,S,Dh); the head dim has stride 1
  long long q_stride[3];
  long long k_stride[3];
  long long v_stride[3];
  long long o_stride[3];
  int b, h, hkv, sq, sk, dh;
  int causal;
  int window;   // 0 = none
  float scale;  // 1/sqrt(Dh), rounded to fp32 on the host
};

namespace {

constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------------------
// fp32: CUDA-core kernel
// ---------------------------------------------------------------------------

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // keys per tile
constexpr int TX = 16;
constexpr int TY = 16;
constexpr int THREADS = TX * TY;
constexpr int RPT = BQ / TY;   // rows per thread
constexpr int CPT = BK / TX;   // score columns per thread

template <int DH>
constexpr size_t smem_floats() {
  return (size_t)BQ * (DH + 1) + (size_t)BK * (DH + 1) + (size_t)BK * DH +
         (size_t)BQ * (BK + 1);
}

template <int DH>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(const FlashArgs a) {
  constexpr int QLD = DH + 1, KLD = DH + 1, VLD = DH, PLD = BK + 1;
  constexpr int DPT = DH / TX;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * QLD;
  float* Vs = Ks + BK * KLD;
  float* Ps = Vs + BK * VLD;

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int kvh = hh / (a.h / a.hkv);
  const int q_start = blockIdx.x * BQ;
  const int q_last = q_start + BQ - 1;
  const float* q = static_cast<const float*>(a.q) + bb * a.q_stride[0] +
                   hh * a.q_stride[1];
  const float* k = static_cast<const float*>(a.k) + bb * a.k_stride[0] +
                   kvh * a.k_stride[1];
  const float* v = static_cast<const float*>(a.v) + bb * a.v_stride[0] +
                   kvh * a.v_stride[1];
  float* o = static_cast<float*>(a.out) + bb * a.o_stride[0] +
             hh * a.o_stride[1];
  const int qs = (int)a.q_stride[2];
  const int ks = (int)a.k_stride[2];
  const int vs = (int)a.v_stride[2];
  const int os = (int)a.o_stride[2];
  q += (long long)q_start * qs;
  o += (long long)q_start * os;

  for (int i = tid; i < BQ * DH; i += THREADS) {
    const int r = i / DH, d = i % DH;
    Qs[r * QLD + d] = q_start + r < a.sq ? q[r * qs + d] : 0.f;
  }

  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  const int nk = (a.sk + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k_start = kt * BK;
    // the same tile-level skip as the TPU kernel, uniform over the block
    if (a.causal && k_start > q_last) break;
    if (a.window > 0 && k_start + BK - 1 <= q_start - a.window) continue;

    __syncthreads();  // the previous tile's K, V and P are no longer read
    const float* k_rows = k + (long long)k_start * ks;
    const float* v_rows = v + (long long)k_start * vs;
    for (int i = tid; i < BK * DH; i += THREADS) {
      const int c = i / DH, d = i % DH;
      const bool in = k_start + c < a.sk;
      Ks[c * KLD + d] = in ? k_rows[c * ks + d] : 0.f;
      Vs[c * VLD + d] = in ? v_rows[c * vs + d] : 0.f;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = Qs[(ty + TY * i) * QLD + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = Ks[(tx + TX * j) * KLD + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty + TY * i, qp = q_start + r;
      // the keys that row qp sees: lo <= key <= hi
      const int hi = a.causal ? min(qp, a.sk - 1) : a.sk - 1;
      const int lo = a.window > 0 ? qp - a.window + 1 : 0;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kp = k_start + tx + TX * j;
        const bool ok = kp >= lo && kp <= hi;
        s[i][j] = ok ? s[i][j] * a.scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[r * PLD + tx + TX * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= corr;
    }
    __syncthreads();  // P is complete

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = Ps[(ty + TY * i) * PLD + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const float vv = Vs[c * VLD + tx + TX * j];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty + TY * i;
    if (q_start + r >= a.sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DPT; ++j)
      o[r * os + tx + TX * j] = acc[i][j] / denom;
  }
}

template <int DH>
int launch_f32_dh(const FlashArgs& a, cudaStream_t stream) {
  const size_t smem = smem_floats<DH>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.sq + BQ - 1) / BQ, a.h, a.b);
  flash_fwd_kernel<DH><<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor-core kernel (wgmma + TMA)
// ---------------------------------------------------------------------------

constexpr float LOG2E = 1.4426950408889634f;

template <int DHP>  // the head dim padded to 64, 128 or 256
struct Tc {
  static constexpr int BQ = DHP <= 128 ? 128 : 64;  // query rows a block
  static constexpr int BK = DHP <= 64 ? 128 : 64;   // keys a tile
  static constexpr int NWG = BQ / 64;               // consumer warpgroups
  static constexpr int THREADS = (NWG + 1) * 128;   // + the producer's
  static constexpr int NCB = DHP / 64;  // 64-column (128-byte) blocks of Dh
  static constexpr int STAGES = 2;
  static constexpr int Q_BYTES = BQ * DHP * 2;
  static constexpr int KV_BYTES = BK * DHP * 2;  // one K or V tile
  static constexpr int SMEM =
      1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 8 * (1 + 4 * STAGES);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Waits for the phase of the given parity to complete.  A wait that
// outlasts ~2^34 clocks (seconds) can only be a broken pipeline: it traps,
// so the launch fails with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (done) break;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// one TMA box {64 columns, rows, 1, 1} at (column, row, head, batch)
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptors for 128-byte-swizzled tiles stored as
// [rows][64] bf16 blocks (128-byte rows, 1024-byte 8-row atoms):
// start address >> 4 (bits 0-13), leading byte offset >> 4 (16-29),
// stride byte offset >> 4 (32-45: 1024 B between 8-row atoms), layout
// type 1 = 128-byte swizzle (62-63).  K-major (Q, K): the leading offset
// is unused.  MN-major (V): the leading offset steps to the next 64
// head-dim columns.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>  // until at most N committed groups are in flight
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Named barriers 1 and 2 (0 is __syncthreads) order the two consumer
// warpgroups' issue of their products: 128 threads arrive, 128 wait.
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// keeps the compiler from moving register reads or writes across the
// wgmma fence, issue and wait (asm volatile statements stay in order)
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (m64n64, fp32) {=, +=} A (smem desc, K-major) * B (smem desc, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32],
                                                uint64_t da, uint64_t db,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (m64n128, fp32) {=, +=} A (smem desc, K-major) * B (smem desc, K-major)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64],
                                                 uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (m64n64, fp32) += A (registers, bf16 pairs) * B (smem desc, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (m64n128, fp32) += A (registers, bf16 pairs) * B (smem desc, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (m64n256, fp32) += A (registers, bf16 pairs) * B (smem desc, MN-major)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]),
        "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]),
        "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]),
        "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]),
        "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]),
        "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
        "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void mma_qk(float (&d)[N / 2], uint64_t da,
                                       uint64_t db, int accumulate) {
  if constexpr (N == 64) wgmma_ss_n64(d, da, db, accumulate);
  else wgmma_ss_n128(d, da, db, accumulate);
}

template <int N>
__device__ __forceinline__ void mma_pv(float (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db);
  else wgmma_rs_n256(d, a, db);
}

// S = Q K^T for one key tile: Dh/16 k-steps, Q and K K-major (one commit
// group).  q_base / k_base: the warpgroup's Q rows and the K stage.
template <int DHP, int BQ, int BK>
__device__ __forceinline__ void issue_qk(float (&sc)[BK / 2], uint32_t q_base,
                                         uint32_t k_base) {
#pragma unroll
  for (int ks = 0; ks < DHP / 16; ++ks)
    mma_qk<BK>(sc, desc_kmajor(q_base + (ks / 4) * BQ * 128 + (ks % 4) * 32),
               desc_kmajor(k_base + (ks / 4) * BK * 128 + (ks % 4) * 32),
               ks > 0);
  wgmma_commit();
}

// O += P V for one key tile: BK/16 k-steps, P from registers, V MN-major
// (one commit group).
template <int DHP, int BK>
__device__ __forceinline__ void issue_pv(float (&o)[DHP / 2],
                                         const uint32_t (&pf)[BK / 16][4],
                                         uint32_t v_base) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    mma_pv<DHP>(o, pf[kk], desc_mnmajor(v_base + kk * 16 * 128, BK * 128));
  wgmma_commit();
}

// The online softmax of one key tile on the S fragment (see the consumer
// for the layout): scale (times log2 e) and masks, the row max over the
// thread's columns and then its quad, p = exp2(x - m) in place, and l
// from the fp32 p (summed over the thread's columns; the quad is summed
// in the epilogue, corr being uniform over it).
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             const FlashArgs& a, int k0,
                                             int r0, int c0, int w_lo,
                                             int w_hi, float sl2) {
  const bool cut = k0 + BK > a.sk || (a.causal && k0 + BK - 1 > w_lo) ||
                   (a.window > 0 && k0 <= w_hi - a.window);
  if (cut) {
    // row r keeps the columns 8n + (j % 2) in (lo[r], hi[r]], relative
    // to the thread's first column k0 + c0
    int lo[2], hi[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qp = r0 + 8 * r;
      hi[r] = (a.causal ? min(a.sk - 1, qp) : a.sk - 1) - k0 - c0;
      lo[r] = a.window > 0 ? qp - a.window - k0 - c0 : -1;
    }
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const int col = (j / 4) * 8 + (j % 2), r = (j / 2) % 2;
      sc[j] = col > lo[r] && col <= hi[r] ? sc[j] * sl2 : NEG_INF;
    }
  } else {
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) sc[j] *= sl2;
  }
  float mx[2] = {m[0], m[1]}, rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < BK / 2; ++j)
    mx[(j / 2) % 2] = fmaxf(mx[(j / 2) % 2], sc[j]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    corr[r] = fast_exp2(m[r] - mx[r]);
    m[r] = mx[r];
  }
#pragma unroll
  for (int j = 0; j < BK / 2; ++j) {
    sc[j] = fast_exp2(sc[j] - m[(j / 2) % 2]);
    rs[(j / 2) % 2] += sc[j];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = fmaf(l[r], corr[r], rs[r]);
}

// O *= corr, then p rounded to bf16 once: the S fragment of keys
// 16kk..16kk+15 is the A fragment of k-step kk.
template <int DHP, int BK>
__device__ __forceinline__ void rescale_and_pack(float (&o)[DHP / 2],
                                                 const float (&corr)[2],
                                                 const float (&sc)[BK / 2],
                                                 uint32_t (&pf)[BK / 16][4]) {
#pragma unroll
  for (int j = 0; j < DHP / 2; ++j) o[j] *= corr[(j / 2) % 2];
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x)
      pf[kk][x] = pack_bf16(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1]);
}

template <int DHP>
__global__ void __launch_bounds__(Tc<DHP>::THREADS, 1)
    flash_fwd_kernel_wgmma(const FlashArgs a,
                           const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv) {
  using C = Tc<DHP>;
  constexpr int BQ = C::BQ, BK = C::BK, NWG = C::NWG, NCB = C::NCB;
  constexpr int STAGES = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(base);  // [NCB][BQ][64]
  __nv_bfloat16* Ks = Qs + BQ * DHP;              // [STAGES][NCB][BK][64]
  __nv_bfloat16* Vs = Ks + STAGES * BK * DHP;     // [STAGES][NCB][BK][64]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + STAGES * BK * DHP);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* k_empty = v_full + STAGES;
  uint64_t* v_empty = k_empty + STAGES;

  const int hh = blockIdx.x, bb = blockIdx.y;
  const int q_start = (gridDim.z - 1 - blockIdx.z) * BQ;  // longest first
  const int kvh = hh / (a.h / a.hkv);
  // key tiles [kt_lo, kt_lo + n_tiles): the TPU kernel's tile skips
  const int q_last = min(q_start + BQ, a.sq) - 1;
  int kt_hi = (a.sk + BK - 1) / BK;
  if (a.causal) kt_hi = min(kt_hi, q_last / BK + 1);
  int kt_lo = 0;
  if (a.window > 0 && q_start - a.window + 1 > 0)
    kt_lo = (q_start - a.window + 1) / BK;
  const int n_tiles = max(kt_hi - kt_lo, 0);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(k_empty + s, NWG * 128);
      mbar_init(v_empty + s, NWG * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NWG) {
    // producer: one thread keeps the ring of K/V stages filled; a K stage
    // is refilled once S = Q K^T has read it, a V stage once P V has
    if constexpr (NWG == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == NWG * 128) {
      mbar_expect_tx(q_full, C::Q_BYTES);
      for (int cb = 0; cb < NCB; ++cb)
        tma_load(Qs + cb * BQ * 64, &tq, q_full, cb * 64, q_start, hh, bb);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES, k0 = (kt_lo + i) * BK;
        const int parity = (i / STAGES - 1) & 1;
        if (i >= STAGES) mbar_wait(k_empty + s, parity);
        mbar_expect_tx(k_full + s, C::KV_BYTES);
        for (int cb = 0; cb < NCB; ++cb)
          tma_load(Ks + (s * NCB + cb) * BK * 64, &tk, k_full + s, cb * 64,
                   k0, kvh, bb);
        if (i >= STAGES) mbar_wait(v_empty + s, parity);
        mbar_expect_tx(v_full + s, C::KV_BYTES);
        for (int cb = 0; cb < NCB; ++cb)
          tma_load(Vs + (s * NCB + cb) * BK * 64, &tv, v_full + s, cb * 64,
                   k0, kvh, bb);
      }
    }
  } else {
    // consumer warpgroup wg: query rows q_start + 64 wg ... + 63.  Thread
    // (warp, lane) holds rows r0 and r0 + 8 and, in every 8-column block
    // n of an accumulator, columns 8n + c0 and 8n + c0 + 1: element
    // 4n + 2r + c is (row r0 + 8r, column 8n + c0 + c).
    if constexpr (NWG == 2)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int r0 = q_start + wg * 64 + warp * 16 + lane / 4;
    const int c0 = (lane % 4) * 2;
    const int w_lo = q_start + wg * 64, w_hi = w_lo + 63;
    const float sl2 = a.scale * LOG2E;
    float o[DHP / 2], sc[BK / 2], corr[2];
    uint32_t pf[BK / 16][4];  // P of the previous tile, bf16 pairs
#pragma unroll
    for (int j = 0; j < DHP / 2; ++j) o[j] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    const uint32_t q_base = smem_u32(Qs) + wg * 64 * 128;

    const uint32_t k_stage = smem_u32(Ks), v_stage = smem_u32(Vs);
    constexpr uint32_t STAGE_BYTES = C::KV_BYTES;
    // With two consumer warpgroups they take turns to issue their products
    // (named barrier 1 + wg: "wg may issue"), so one's softmax overlaps
    // the other's tensor-core work.  Each issues n_tiles + 1 times;
    // warpgroup 1 opens the first turn of warpgroup 0 and skips the
    // hand-over after its own last turn, so every arrival is awaited.
    const auto my_turn = [&] {
      if constexpr (NWG == 2) named_sync(1 + wg);
    };
    const auto your_turn = [&](bool last) {
      if constexpr (NWG == 2)
        if (!(last && wg == 1)) named_arrive(2 - wg);
    };
    mbar_wait(q_full, 0);
    if (n_tiles > 0) {
      if constexpr (NWG == 2)
        if (wg == 1) named_arrive(1);
      // tile 0: S_0 and its softmax
      mbar_wait(k_full, 0);
      my_turn();
      wgmma_fence();
      issue_qk<DHP, BQ, BK>(sc, q_base, k_stage);
      your_turn(false);
      wgmma_wait<0>();
      fence_regs(sc);
      mbar_arrive(k_empty);
      softmax_tile<BK>(sc, m, l, corr, a, kt_lo * BK, r0, c0, w_lo, w_hi, sl2);
      rescale_and_pack<DHP, BK>(o, corr, sc, pf);
      // tile i: S_i = Q K_i^T, then O += P_{i-1} V_{i-1}; the softmax of
      // S_i runs while the tensor cores work on the second product
      for (int i = 1; i < n_tiles; ++i) {
        const int s = i % STAGES, sp = (i - 1) % STAGES;
        mbar_wait(k_full + s, (i / STAGES) & 1);
        mbar_wait(v_full + sp, ((i - 1) / STAGES) & 1);
        fence_regs(sc);
        fence_regs(o);
        my_turn();
        wgmma_fence();
        issue_qk<DHP, BQ, BK>(sc, q_base, k_stage + s * STAGE_BYTES);
        issue_pv<DHP, BK>(o, pf, v_stage + sp * STAGE_BYTES);
        your_turn(false);
        wgmma_wait<1>();
        fence_regs(sc);
        mbar_arrive(k_empty + s);
        softmax_tile<BK>(sc, m, l, corr, a, (kt_lo + i) * BK, r0, c0, w_lo,
                         w_hi, sl2);
        wgmma_wait<0>();
        fence_regs(o);
        mbar_arrive(v_empty + sp);
        rescale_and_pack<DHP, BK>(o, corr, sc, pf);
      }
      // the last tile's P V
      const int sp = (n_tiles - 1) % STAGES;
      mbar_wait(v_full + sp, ((n_tiles - 1) / STAGES) & 1);
      fence_regs(o);
      my_turn();
      wgmma_fence();
      issue_pv<DHP, BK>(o, pf, v_stage + sp * STAGE_BYTES);
      your_turn(true);
      wgmma_wait<0>();
      fence_regs(o);
    }

    // epilogue: out = acc / max(l, 1e-30), rounded to bf16 once
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out) +
                         bb * a.o_stride[0] + hh * a.o_stride[1];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qp = r0 + 8 * r;
      if (qp >= a.sq) continue;
      const float den = 1.f / fmaxf(l[r], 1e-30f);
      __nv_bfloat16* row = out + qp * a.o_stride[2];
#pragma unroll
      for (int n = 0; n < DHP / 8; ++n) {
        const int col = n * 8 + c0;
        if (col < a.dh)
          *reinterpret_cast<__nv_bfloat162*>(row + col) = __floats2bfloat162_rn(
              o[4 * n + 2 * r] * den, o[4 * n + 2 * r + 1] * den);
      }
    }
  }
}

// cuTensorMapEncodeTiled from the driver, through the runtime, so the
// library needs no -lcuda
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// error codes beside cudaError_t's (kernels/ops.py names them)
constexpr int ERR_NO_ENCODE = 100000;   // no cuTensorMapEncodeTiled entry
constexpr int ERR_ENCODE = 200000;      // + the CUresult of the encode

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 4-d map {Dh, S, heads, B} over an operand indexed (B, heads, S, Dh)
// with element strides st (batch, head, sequence), read in boxes of
// {64, rows, 1, 1} with the 128-byte swizzle; out-of-range elements
// (columns past Dh, rows past S) arrive as zeros.
int encode(CUtensorMap* map, const void* ptr, int dh, int s, int heads,
           int batch, const long long* st, int rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return ERR_NO_ENCODE;
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)s,
                              (cuuint64_t)heads, (cuuint64_t)batch};
  // byte strides of S, heads and B; a dim of extent 1 is only read at
  // coordinate 0, so it takes the packed stride whatever its own is
  cuuint64_t str[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                       (cuuint64_t)st[0] * 2};
  if (s == 1) str[0] = (cuuint64_t)dh * 2;
  if (heads == 1) str[1] = str[0] * s;
  if (batch == 1) str[2] = str[1] * heads;
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, str, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + (int)r;
}

template <int DHP>
int launch_tc(const FlashArgs& a, cudaStream_t stream) {
  using C = Tc<DHP>;
  CUtensorMap tq, tk, tv;
  int err = encode(&tq, a.q, a.dh, a.sq, a.h, a.b, a.q_stride, C::BQ);
  if (err == 0)
    err = encode(&tk, a.k, a.dh, a.sk, a.hkv, a.b, a.k_stride, C::BK);
  if (err == 0)
    err = encode(&tv, a.v, a.dh, a.sk, a.hkv, a.b, a.v_stride, C::BK);
  if (err != 0) return err;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel_wgmma<DHP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(a.h, a.b, (a.sq + C::BQ - 1) / C::BQ);
  if (grid.z > 65535) return (int)cudaErrorInvalidValue;
  flash_fwd_kernel_wgmma<DHP>
      <<<grid, C::THREADS, C::SMEM, stream>>>(a, tq, tk, tv);
  return (int)cudaGetLastError();
}

bool valid(const FlashArgs& a) {
  return a.b > 0 && a.h > 0 && a.hkv > 0 && a.h % a.hkv == 0 && a.sk > 0 &&
         a.sq > 0 && a.b <= 65535 && a.h <= 65535;
}

}  // namespace

extern "C" {

// Both return cudaGetLastError() after the launch (0 on success), or one
// of the codes above.
int repro_flash_attention_f32(FlashArgs a, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (!valid(a)) return (int)cudaErrorInvalidValue;
  switch (a.dh) {
    case 16: return launch_f32_dh<16>(a, st);
    case 32: return launch_f32_dh<32>(a, st);
    case 64: return launch_f32_dh<64>(a, st);
    case 96: return launch_f32_dh<96>(a, st);
    case 128: return launch_f32_dh<128>(a, st);
    case 256: return launch_f32_dh<256>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

int repro_flash_attention_bf16(FlashArgs a, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (!valid(a)) return (int)cudaErrorInvalidValue;
  switch (a.dh) {
    case 16:
    case 32:
    case 64: return launch_tc<64>(a, st);
    case 96:
    case 128: return launch_tc<128>(a, st);
    case 256: return launch_tc<256>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
