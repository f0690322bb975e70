// Chunked RWKV6 (Finch) recurrence for Hopper (sm_90a).
//
// Replaces the TPU kernel `rwkv6_chunked_bhsd` of the JAX package
// (src/repro/kernels/rwkv6_scan.py:75, body `_rwkv6_kernel` :27).  For
// r, k, v, logw indexed (B,S,H,dh) through their strides, S any length,
// and u (H,dh) it computes, per (b, h) and chunk of C rows in order, from
// a zero fp32 state S0:
//
//     cum = inclusive cumsum of logw over the chunk, per channel
//     cum_prev = cum - logw,  total = cum[C-1],  mid = cum[C/2]
//     q_in  = r e^{cum_prev}         q_mid = r e^{cum_prev - mid}
//     k_mid = k e^{mid - cum}        k_out = k e^{total - cum}
//     o  = (q_in S0 + tril_{-1}(q_mid k_mid^T) v) + (sum_d r u k) v
//     S0 <- e^{total}^T * S0 + k_out^T v
//
// and writes o (in the output's type, through its strides) and, after the
// last chunk, the fp32 state (B,H,dh,dh).  Three instantiations of one
// template, by (r/k/v, logw/u, out) type, each in a source of its own so
// that they build in parallel: (f32, f32, f32) in rwkv6_scan.cu and (bf16,
// bf16, bf16) in rwkv6_scan_bf16.cu for the JAX-parity wrappers on
// (B,H,S,dh) tensors, and (bf16, f32, f32) in rwkv6_scan_bf16_f32.cu for
// the model path, which reads RWKV6's bf16 projections and fp32 decay in
// place and writes fp32 (B,S,H,dh).
//
// Arithmetic: the TPU kernel's, in a fixed order, so that reading the
// model layout in place gives bit for bit what ops.rwkv6_chunked gives on
// upcast, zero-padded (B,H,S',dh) copies.  Every operand is upcast to
// fp32 (exactly) when it is read; cum is each channel's sequential sum from 0 (as torch.cumsum's
// scan of a non-innermost dimension); cum_prev, mid and the four factors
// are formed in that order with expf; every product is a chain of fp32
// FMAs in increasing order of its summed index (d for q_in S and the
// scores, s for the scores times v, t for k_out^T v); the inter- and
// intra-chunk parts are summed apart before the bonus diagonal
// (fmaf(r u, k) per lane, then a butterfly) is added.  --fmad=false
// keeps everything else uncontracted.  The TPU kernel's masked terms are
// skipped: the scores above the diagonal, which it zeroes, and in
// o_intra most of the zero columns past each row's diagonal, where it
// adds fmaf(0, v, acc) == acc (for finite v; a sum that is exactly -0
// could come out +0 instead, which needs every term of the row to
// underflow).
//
// A ragged last chunk (S not a multiple of C) is masked, not padded: its
// rows past S are read as zeros and not stored.  That is exactly the zero
// padding of the JAX wrapper: a zero logw row repeats the last real cum,
// so mid and total are read from those zero-filled rows as the padded
// path reads them, and a zero k row adds nothing to the state.
//
// Bound: operations.  At RWKV6-7B's serving shape (B, S, H, dh) = (8,
// 2048, 64, 64), C = 64, a chunk needs q_in S and k_out^T v (2 C dh^2
// FLOP each), the scores and their product with v over the strictly
// lower triangle (C (C-1) dh each) and the bonus diagonal (4 C dh):
// 2.59e10 FLOP, 0.387 ms at the card's fp32 rate (67 TFLOP/s).  The model
// path moves r, k, v in bf16 and logw, o in fp32 (14 B an element,
// 0.94 GB) and the 8.4 MB state: 0.283 ms at 3.35 TB/s.  (All fp32, as
// the JAX-parity entry takes it, 1.35 GB: 0.403 ms.)  The same products
// on the bf16 tensor cores would take 0.026 ms, but round differently.
//
// Design.  One block of 256 threads owns one (b, h) (and one 64-column
// slice of v, o and the state when dh = 128) and loops over the chunks;
// the state stays on chip for the whole sequence: 512 blocks at the
// serving shape.  Shared memory holds four fp32 work tiles F1-F4 and one
// staging buffer for the raw r, k, logw (and bf16 v) of the NEXT chunk:
//   - Asynchronous copies: cp.async of 16 bytes a thread, zero-filled past
//     S, straight from the strided tensors into the staging buffer.  The
//     raw chunk is consumed by step 4, so the next chunk's copies are
//     issued there and land while steps 5-7, two thirds of the arithmetic,
//     run.  fp32 v is copied straight into F4 at the top of its chunk and
//     waited for before step 5.  (cp.async, not TMA: per-thread copies
//     step any 16-byte stride with no tensor map to build per call, and
//     write the tiles in the layout the reads want.)
//   - Per chunk: 1. warps 0-1 scan one channel a thread (cum into F3,
//     mid, total; loads 16 rows ahead), the other six warps form the bonus
//     diagonal, all their rows at once (and upcast bf16 v into F4); 2. all
//     threads: q_in into F1; 3. o_inter = q_in S, S read from F2; 4. all
//     threads: q_mid into F1, k_mid into F2, k_out into F3 over cum (steps
//     2 and 4 load a batch of groups before they store any); 5. the scores
//     over the lower triangle only, 136 4x4 tiles (I >= J): 128 threads
//     take a whole tile, the next 32 one row of the other 8, so that no
//     SM sub-partition runs two warps of whole tiles, and the threads
//     without a whole tile update their part of the state meanwhile; the
//     scores go to F1 as A, zero above the diagonal in the diagonal tiles;
//     6. o_intra = A v up to each row's diagonal, then o is stored
//     (float4 stores for fp32); 7. the rest of the state.  The state lives
//     in registers (16 floats a thread) and is copied into F2 for the next
//     chunk's step 3 once k_mid is dead.  The exponentials run on all 256
//     threads; only the cumsum is sequential per channel.
//   - The products run as fp32 FMAs over 4x4 register tiles fed by float4
//     shared-memory reads (8 reads for 64 FMAs), their loops over d
//     unrolled.  For o, thread (p, cg) owns value columns 4cg..4cg+3 of
//     rows {2p, 2p+1, C-2-2p, C-1-2p}: paired rows give every thread about
//     the same causal work (126 of the 252 row-steps a full square would
//     take at C = 64); o_intra sums all four rows up to row 1's diagonal,
//     then the long two.  q_in, q_mid, k_mid and A, whose reads step down
//     rows 2 or 4 apart, are XOR-swizzled in 16-byte groups within a row
//     (one XOR an access, no bank conflicts); the state, v and cum/k_out
//     are read a row at a time and stay plain.
//   - Shared memory at dh = C = 64: 64 KB of work tiles, 768 B of per-row
//     and per-channel values, and a staging buffer of 40 KB (bf16 r, k, v
//     and fp32 logw), 48 KB (fp32 r, k, logw) or 32 KB (all bf16): at most
//     115,456 B, so two blocks fit an SM (228 KB, 1 KB reserved a block)
//     and 512 blocks take 1.94 waves of 264.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Passed by value from the ctypes wrapper (kernels/ops.py mirrors it).
struct Rwkv6Args {
  const void* r;
  const void* k;
  const void* v;
  const void* logw;
  const void* u;    // (H, dh), contiguous, logw's type
  void* out;        // indexed (B,S,H,dh) through o_stride, in the out type
  float* state;     // (B,H,dh,dh) fp32 final state, contiguous
  // (batch, sequence, head) strides in elements; dh has stride 1, and every
  // base and stride of r, k, v and logw is a multiple of 16 bytes
  long long r_stride[3];
  long long k_stride[3];
  long long v_stride[3];
  long long w_stride[3];
  long long o_stride[3];
  int b, h, s;
};

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr size_t SMEM_PER_SM = 233472;  // 228 KB on an H100 SM
constexpr size_t SMEM_RESERVED = 1024;  // the runtime's share of each block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// four consecutive elements from shared memory as floats
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// four consecutive outputs: one 16-byte store (fp32) or 8-byte store (bf16)
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const uint32_t*>(&lo);
  raw.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ float at(const float4& x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

// Element (row, col) of a row-major fp32 tile W floats wide whose 16-byte
// groups are XOR-permuted within each row: rows 4 apart (the score tiles)
// and rows 2 apart (the paired rows of o) land on different banks.
// swrow(row) ^ (4 g) is the group g of the row: one XOR an access.
template <int W>
__device__ __forceinline__ int swrow(int row) {
  constexpr int M = (W / 4 < 8 ? W / 4 : 8) - 1;
  return row * W + ((((row >> 2) ^ (((row >> 1) & 1) << 2)) & M) << 2);
}
template <int W>
__device__ __forceinline__ int sw(int row, int col) {
  return (swrow<W>(row) ^ (col & ~3)) + (col & 3);
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Issue the copies of ROWS rows of COLS elements (row stride rs) into a
// row-major tile; rows from nvalid on are zero-filled (their source is row
// 0, never read).
template <typename T, int ROWS, int COLS>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long rs, int nvalid,
                                          int tid) {
  constexpr int PER = 16 / sizeof(T);
  constexpr int CPR = COLS / PER;
#pragma unroll 1
  for (int i = tid; i < ROWS * CPR; i += THREADS) {
    const int t = i / CPR, c = (i % CPR) * PER;
    const bool ok = t < nvalid;
    const T* g = src + (ok ? t : 0) * rs + c;
    cp_async16(dst + t * COLS + c, g, ok);
  }
}

// o_intra of rows I0..3 += A[row][4g..4g+3] v[4g..4g+3][vcol..vcol+3]; A
// rows at ab[i] ^ (4 g), v NV wide
template <int I0, int NV>
__device__ __forceinline__ void intra_group(float (&intra)[4][4], const float* A,
                                            const float* V, const int (&ab)[4], int g,
                                            int vcol) {
  float4 vv[4];
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) vv[jj] = load4(V + (4 * g + jj) * NV + vcol);
#pragma unroll
  for (int i = I0; i < 4; ++i) {
    const float4 av = load4(A + (ab[i] ^ (4 * g)));
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int j = 0; j < 4; ++j) intra[i][j] = fmaf(at(av, jj), at(vv[jj], j), intra[i][j]);
  }
}

// Sizes of one instantiation, in floats unless named otherwise.
template <typename TI, typename TW, int DH, int C>
struct Cfg {
  static constexpr int DHEAD = DH, CH = C;
  static constexpr int NV = DH < 64 ? DH : 64;  // value columns a block
  static constexpr int SLICES = DH / NV;
  static constexpr int NCG = NV / 4;            // 4-column groups of a slice
  static constexpr bool V_DIRECT = sizeof(TI) == 4;  // fp32 v: cp.async into F4
  static constexpr int IO_TILES = (C / 4) * NCG;     // 4x4 tiles of o
  static constexpr int SC_TILES = (C / 4) * (C / 4 + 1) / 2;
  static constexpr int SC_FULL = SC_TILES / 32 * 32;         // whole-tile threads
  static constexpr int SC_PARTS = 4 * (SC_TILES - SC_FULL);  // one-row threads
  static constexpr int KV_TILES = (DH / 4) * NCG;    // 4x4 tiles of the state
  static constexpr int KVT = (KV_TILES + THREADS - 1) / THREADS;
  static constexpr int F1 = C * (DH > C ? DH : C);   // q_in, q_mid, A
  static constexpr int F2 = DH * (C > NV ? C : NV);  // S, k_mid
  static constexpr int F3 = C * DH;                  // cum, k_out
  static constexpr int F4 = C * NV;                  // v
  static constexpr int SMALL = C + 2 * DH;           // diag, mid, total
  static constexpr size_t STAGE_BYTES =
      2 * (size_t)C * DH * sizeof(TI) + (size_t)C * DH * sizeof(TW) +
      (V_DIRECT ? 0 : (size_t)C * NV * sizeof(TI));
  static constexpr size_t SMEM = (size_t)(F1 + F2 + F3 + F4 + SMALL) * 4 + STAGE_BYTES;
  static constexpr int MIN_BLOCKS = SMEM + SMEM_RESERVED <= SMEM_PER_SM / 2 ? 2 : 1;
  static_assert(IO_TILES <= THREADS && SC_FULL + SC_PARTS <= THREADS && DH <= THREADS / 2,
                "one o tile and one score tile a thread, and warps left for the diagonal");
};

// The scores of NI rows (q_mid rows at qb[i] ^ (4 g)) against four k_mid
// rows (kb[j] ^ (4 g)): fp32 FMAs over d in order.
template <int NI, int DH>
__device__ __forceinline__ void scores(float (&sc)[4][4], const float* Q, const float* K,
                                       const int (&qb)[4], const int (&kb)[4]) {
#pragma unroll
  for (int g = 0; g < DH / 4; ++g) {
    float4 q[NI], kk[4];
#pragma unroll
    for (int i = 0; i < NI; ++i) q[i] = load4(Q + (qb[i] ^ (4 * g)));
#pragma unroll
    for (int j = 0; j < 4; ++j) kk[j] = load4(K + (kb[j] ^ (4 * g)));
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(at(q[i], jj), at(kk[j], jj), sc[i][j]);
  }
}

// This thread's tiles of the state (rows 4dq.., columns 4cx.., tile n =
// tid + kt THREADS): S <- e^{total} * S + k_out^T v, t in order.
template <typename G>
__device__ __forceinline__ void state_update(float (&Sr)[G::KVT][4][4], const float* Kout,
                                             const float* V, const float* total, int tid) {
#pragma unroll
  for (int kt = 0; kt < G::KVT; ++kt) {
    const int n = tid + kt * THREADS;
    if (n < G::KV_TILES) {
      const int dq = n / G::NCG, cx = n % G::NCG;
      float kv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[i][j] = 0.f;
#pragma unroll 4
      for (int t = 0; t < G::CH; ++t) {
        const float4 ko = load4(Kout + t * G::DHEAD + 4 * dq), vv = load4(V + t * G::NV + 4 * cx);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) kv[i][j] = fmaf(at(ko, i), at(vv, j), kv[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = expf(total[4 * dq + i]);
#pragma unroll
        for (int j = 0; j < 4; ++j) Sr[kt][i][j] = e * Sr[kt][i][j] + kv[i][j];
      }
    }
  }
}

// ... and those tiles into the shared copy of the state (NV wide).
template <typename G>
__device__ __forceinline__ void state_store(const float (&Sr)[G::KVT][4][4], float* S, int tid) {
#pragma unroll
  for (int kt = 0; kt < G::KVT; ++kt) {
    const int n = tid + kt * THREADS;
    if (n < G::KV_TILES) {
      const int dq = n / G::NCG, cx = n % G::NCG;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        store4(S + (4 * dq + i) * G::NV + 4 * cx,
               make_float4(Sr[kt][i][0], Sr[kt][i][1], Sr[kt][i][2], Sr[kt][i][3]));
    }
  }
}

template <typename TI, typename TW, typename TO, int DH, int C>
__global__ void __launch_bounds__(THREADS, (Cfg<TI, TW, DH, C>::MIN_BLOCKS))
    rwkv6_chunked_kernel(const Rwkv6Args a) {
  using G = Cfg<TI, TW, DH, C>;
  constexpr int NV = G::NV, NCG = G::NCG;
  constexpr int CW = (DH + 31) / 32;  // warps of the per-channel scan
  constexpr int ELEM4 = C * DH / 4;   // float4 groups of a (C, dh) tile
  constexpr int EIT = (ELEM4 + THREADS - 1) / THREADS;
  constexpr int EB2 = EIT < 4 ? EIT : 4, EB4 = EIT < 2 ? EIT : 2;  // load batches
  extern __shared__ __align__(16) float smem[];
  float* F1 = smem;            // q_in, then q_mid, then the masked scores A
  float* F2 = F1 + G::F1;      // S (dk rows, this slice's dv columns), then k_mid
  float* F3 = F2 + G::F2;      // cum, then k_out
  float* F4 = F3 + G::F3;      // v (this slice's columns)
  float* diag = F4 + G::F4;    // sum_d r u k per row
  float* mid = diag + C;       // cum[C/2] per channel
  float* total = mid + DH;     // cum[C-1] per channel
  TI* Rs = reinterpret_cast<TI*>(total + DH);  // the staged raw chunk
  TI* Ks = Rs + C * DH;
  TW* Ws = reinterpret_cast<TW*>(Ks + C * DH);
  TI* Vs = reinterpret_cast<TI*>(Ws + C * DH);  // bf16 v only

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int slice = blockIdx.x % G::SLICES, bh = blockIdx.x / G::SLICES;
  const int bi = bh / a.h, hi = bh % a.h, c0 = slice * NV;
  const TI* r = static_cast<const TI*>(a.r) + bi * a.r_stride[0] + hi * a.r_stride[2];
  const TI* k = static_cast<const TI*>(a.k) + bi * a.k_stride[0] + hi * a.k_stride[2];
  const TI* v = static_cast<const TI*>(a.v) + bi * a.v_stride[0] + hi * a.v_stride[2] + c0;
  const TW* lw = static_cast<const TW*>(a.logw) + bi * a.w_stride[0] + hi * a.w_stride[2];
  TO* o = static_cast<TO*>(a.out) + bi * a.o_stride[0] + hi * a.o_stride[2] + c0;
  const long long rs = a.r_stride[1], ks = a.k_stride[1], vs = a.v_stride[1],
                  ws = a.w_stride[1], os = a.o_stride[1];

  // the bonus u of the channels this lane sums in the diagonal
  float us[CW];
#pragma unroll
  for (int j = 0; j < CW; ++j) {
    const int d = lane + 32 * j;
    us[j] = d < DH ? to_f32(static_cast<const TW*>(a.u)[(size_t)hi * DH + d]) : 0.f;
  }
  // o: rows {2p, 2p+1, C-2-2p, C-1-2p}, value columns 4cg..4cg+3
  const bool io = tid < G::IO_TILES;
  const int p = tid / NCG, cg = tid % NCG;
  const int rows[4] = {2 * p, 2 * p + 1, C - 2 - 2 * p, C - 1 - 2 * p};
  // scores: the 4x4 tiles (sI, sJ), sI >= sJ, numbered row by row; a thread
  // below SC_FULL owns a whole tile, the next SC_PARTS threads one row
  // (si0) of a tile each: no SM sub-partition runs two warps of whole tiles
  const bool sc_whole = tid < G::SC_FULL;
  const int sc_tile = sc_whole ? tid : G::SC_FULL + (tid - G::SC_FULL) / 4;
  const int si0 = sc_whole ? 0 : (tid - G::SC_FULL) % 4, sni = sc_whole ? 4 : 1;
  int sI = 0;
  while ((sI + 1) * (sI + 2) / 2 <= sc_tile) ++sI;
  const int sJ = sc_tile - sI * (sI + 1) / 2;
  // the state, this thread's tiles (state_update)
  float Sr[G::KVT][4][4];
#pragma unroll
  for (int kt = 0; kt < G::KVT; ++kt)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Sr[kt][i][j] = 0.f;
  for (int i = tid; i < DH * NV; i += THREADS) F2[i] = 0.f;

  const int seq = a.s;
  auto stage = [=](int ci) {
    const long long t0 = (long long)ci * C;
    const int nvalid = min(C, seq - ci * C);
    load_tile<TI, C, DH>(Rs, r + t0 * rs, rs, nvalid, tid);
    load_tile<TI, C, DH>(Ks, k + t0 * ks, ks, nvalid, tid);
    load_tile<TW, C, DH>(Ws, lw + t0 * ws, ws, nvalid, tid);
    if constexpr (!G::V_DIRECT) load_tile<TI, C, NV>(Vs, v + t0 * vs, vs, nvalid, tid);
  };
  stage(0);
  cp_async_commit();

  const int nc = (seq + C - 1) / C;
  for (int ci = 0; ci < nc; ++ci) {
    const int nvalid = min(C, seq - ci * C);
    cp_async_wait<0>();
    __syncthreads();  // the staged chunk has landed; the last chunk's reads are done
    if constexpr (G::V_DIRECT) {
      load_tile<float, C, NV>(F4, v + (long long)ci * C * vs, vs, nvalid, tid);
      cp_async_commit();
    }

    // 1. cum, per channel from 0 (warps 0..CW-1); the bonus diagonal from
    //    the raw r and k, one warp a row (the other warps); bf16 v to F4
    if (tid < DH) {
      float acc = 0.f;
#pragma unroll
      for (int t0 = 0; t0 < C; t0 += 16) {  // 16 loads in flight, then 16 adds
        float l[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) l[j] = to_f32(Ws[(t0 + j) * DH + tid]);
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          acc = acc + l[j];
          F3[(t0 + j) * DH + tid] = acc;
          if (t0 + j == C / 2) mid[tid] = acc;
        }
      }
      total[tid] = acc;
    } else if (warp >= CW) {
      // this warp's rows all at once, so that their butterflies overlap
      constexpr int NDW = WARPS - CW, RPW = (C + NDW - 1) / NDW;
      float acc[RPW];
#pragma unroll
      for (int q = 0; q < RPW; ++q) {
        const int t = warp - CW + NDW * q;
        acc[q] = 0.f;
#pragma unroll
        for (int j = 0; j < CW; ++j) {
          const int d = lane + 32 * j;
          if (t < C && d < DH)
            acc[q] = fmaf(to_f32(Rs[t * DH + d]) * us[j], to_f32(Ks[t * DH + d]), acc[q]);
        }
      }
#pragma unroll
      for (int sh = 16; sh > 0; sh >>= 1)
#pragma unroll
        for (int q = 0; q < RPW; ++q) acc[q] += __shfl_xor_sync(0xffffffffu, acc[q], sh);
#pragma unroll
      for (int q = 0; q < RPW; ++q) {
        const int t = warp - CW + NDW * q;
        if (lane == 0 && t < C) diag[t] = acc[q];
      }
      if constexpr (!G::V_DIRECT) {
        for (int e = tid - CW * 32; e < C * NV / 4; e += THREADS - CW * 32) {
          const int t = e / (NV / 4), c = (e % (NV / 4)) * 4;
          store4(F4 + t * NV + c, load4(Vs + t * NV + c));
        }
      }
    }
    __syncthreads();

    // 2. q_in = r e^{cum - logw}.  Steps 2 and 4 load a batch of groups
    //    before they store any (the compiler keeps a shared load behind an
    //    earlier shared store); a group past the tile reads the last one.
#pragma unroll
    for (int i0 = 0; i0 < EIT; i0 += EB2) {
      float4 cu[EB2], l[EB2], rr[EB2];
#pragma unroll
      for (int b = 0; b < EB2; ++b) {
        const int e = min(tid + (i0 + b) * THREADS, ELEM4 - 1);
        const int t = e / (DH / 4), d = (e % (DH / 4)) * 4;
        cu[b] = load4(F3 + t * DH + d);
        l[b] = load4(Ws + t * DH + d);
        rr[b] = load4(Rs + t * DH + d);
      }
#pragma unroll
      for (int b = 0; b < EB2; ++b) {
        const int e = tid + (i0 + b) * THREADS;
        if (ELEM4 % THREADS == 0 || e < ELEM4) {
          const int t = e / (DH / 4), d = (e % (DH / 4)) * 4;
          store4(F1 + sw<DH>(t, d), make_float4(rr[b].x * expf(cu[b].x - l[b].x),
                                                rr[b].y * expf(cu[b].y - l[b].y),
                                                rr[b].z * expf(cu[b].z - l[b].z),
                                                rr[b].w * expf(cu[b].w - l[b].w)));
        }
      }
    }
    __syncthreads();

    // 3. o_inter = q_in S
    float inter[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) inter[i][j] = 0.f;
    if (io) {
      int qb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qb[i] = swrow<DH>(rows[i]);
#pragma unroll
      for (int g = 0; g < DH / 4; ++g) {
        float4 q[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) q[i] = load4(F1 + (qb[i] ^ (4 * g)));
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) sv[jj] = load4(F2 + (4 * g + jj) * NV + 4 * cg);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              inter[i][j] = fmaf(at(q[i], jj), at(sv[jj], j), inter[i][j]);
      }
    }
    __syncthreads();

    // 4. q_mid into F1, k_mid into F2, k_out into F3 over cum
#pragma unroll
    for (int i0 = 0; i0 < EIT; i0 += EB4) {
      float4 cu[EB4], l[EB4], rr[EB4], kk[EB4], md[EB4], tt[EB4];
#pragma unroll
      for (int b = 0; b < EB4; ++b) {
        const int e = min(tid + (i0 + b) * THREADS, ELEM4 - 1);
        const int t = e / (DH / 4), d = (e % (DH / 4)) * 4;
        cu[b] = load4(F3 + t * DH + d);
        l[b] = load4(Ws + t * DH + d);
        rr[b] = load4(Rs + t * DH + d);
        kk[b] = load4(Ks + t * DH + d);
        md[b] = load4(mid + d);
        tt[b] = load4(total + d);
      }
#pragma unroll
      for (int b = 0; b < EB4; ++b) {
        const int e = tid + (i0 + b) * THREADS;
        if (ELEM4 % THREADS == 0 || e < ELEM4) {
          const int t = e / (DH / 4), d = (e % (DH / 4)) * 4;
          const int x = sw<DH>(t, d), y = t * DH + d;
          store4(F1 + x, make_float4(rr[b].x * expf((cu[b].x - l[b].x) - md[b].x),
                                     rr[b].y * expf((cu[b].y - l[b].y) - md[b].y),
                                     rr[b].z * expf((cu[b].z - l[b].z) - md[b].z),
                                     rr[b].w * expf((cu[b].w - l[b].w) - md[b].w)));
          store4(F2 + x, make_float4(kk[b].x * expf(md[b].x - cu[b].x),
                                     kk[b].y * expf(md[b].y - cu[b].y),
                                     kk[b].z * expf(md[b].z - cu[b].z),
                                     kk[b].w * expf(md[b].w - cu[b].w)));
          store4(F3 + y, make_float4(kk[b].x * expf(tt[b].x - cu[b].x),
                                     kk[b].y * expf(tt[b].y - cu[b].y),
                                     kk[b].z * expf(tt[b].z - cu[b].z),
                                     kk[b].w * expf(tt[b].w - cu[b].w)));
        }
      }
    }
    if constexpr (G::V_DIRECT) cp_async_wait<0>();  // this chunk's v
    __syncthreads();  // the staged chunk is consumed: stage the next one
    if (ci + 1 < nc) stage(ci + 1);
    cp_async_commit();  // (an empty group after the last chunk)

    // 5. the scores q_mid k_mid^T: whole tiles (tid < SC_FULL), one row
    //    of the remaining tiles (the next SC_PARTS threads); the threads
    //    without a whole tile update their part of the state meanwhile
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    int qb[4], kb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qb[i] = swrow<DH>(4 * sI + si0 + i);
      kb[i] = swrow<DH>(4 * sJ + i);
    }
    if (tid < G::SC_FULL) {
      scores<4, DH>(sc, F1, F2, qb, kb);
    } else {
      if (tid < G::SC_FULL + G::SC_PARTS) scores<1, DH>(sc, F1, F2, qb, kb);
      state_update<G>(Sr, F3, F4, total, tid);
    }
    __syncthreads();  // every thread is done reading q_mid and k_mid
    if (tid < G::SC_FULL + G::SC_PARTS) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = 4 * sI + si0 + i, s0 = 4 * sJ;
        if (i < sni)
          store4(F1 + sw<C>(t, s0),
                 make_float4(s0 < t ? sc[i][0] : 0.f, s0 + 1 < t ? sc[i][1] : 0.f,
                             s0 + 2 < t ? sc[i][2] : 0.f, s0 + 3 < t ? sc[i][3] : 0.f));
      }
    }
    if (tid >= G::SC_FULL) state_store<G>(Sr, F2, tid);
    __syncthreads();

    // 6. o_intra = A v over each row's causal groups; o = (o_inter +
    //    o_intra) + diag v, stored for the rows before S
    if (io) {
      float intra[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) intra[i][j] = 0.f;
      int ng[4], ab[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ng[i] = (rows[i] + 3) / 4;
        ab[i] = swrow<C>(rows[i]);
      }
      // all four rows up to row 1's last group, then rows 2 and 3 up to
      // row 3's: row 0 (row 2) may run one group past its own last, into
      // the zeros of its diagonal tile (fmaf(0, v, acc), as the TPU
      // kernel computes it)
      int g = 0;
#pragma unroll 2
      for (; g < ng[1]; ++g) intra_group<0, NV>(intra, F1, F4, ab, g, 4 * cg);
#pragma unroll 2
      for (; g < ng[3]; ++g) intra_group<2, NV>(intra, F1, F4, ab, g, 4 * cg);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = rows[i];
        if (t < nvalid) {
          const float dg = diag[t];
          const float4 vt = load4(F4 + t * NV + 4 * cg);
          store4(o + ((long long)ci * C + t) * os + 4 * cg,
                 make_float4((inter[i][0] + intra[i][0]) + dg * vt.x,
                             (inter[i][1] + intra[i][1]) + dg * vt.y,
                             (inter[i][2] + intra[i][2]) + dg * vt.z,
                             (inter[i][3] + intra[i][3]) + dg * vt.w));
        }
      }
    }

    // 7. the rest of the state: S <- e^{total} * S + k_out^T v, into F2
    if (tid < G::SC_FULL) {
      state_update<G>(Sr, F3, F4, total, tid);
      state_store<G>(Sr, F2, tid);
    }
  }

  float* st = a.state + (size_t)bh * DH * DH + c0;
#pragma unroll
  for (int kt = 0; kt < G::KVT; ++kt) {
    const int n = tid + kt * THREADS;
    if (n < G::KV_TILES) {
      const int dq = n / NCG, cx = n % NCG;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        store4(st + (size_t)(4 * dq + i) * DH + 4 * cx,
               make_float4(Sr[kt][i][0], Sr[kt][i][1], Sr[kt][i][2], Sr[kt][i][3]));
    }
  }
}

template <typename TI, typename TW, typename TO, int DH, int C>
int run_k(const Rwkv6Args* a, cudaStream_t stream) {
  using G = Cfg<TI, TW, DH, C>;
  // RWKV6-7B's shape holds two blocks an SM: the shared memory here, the
  // registers through __launch_bounds__(THREADS, MIN_BLOCKS)
  static_assert(DH != 64 || C != 64 || G::MIN_BLOCKS == 2,
                "dh 64, chunk 64 must fit two blocks an SM");
  auto kern = rwkv6_chunked_kernel<TI, TW, TO, DH, C>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)a->b * a->h * G::SLICES;
  if (a->b <= 0 || a->h <= 0 || a->s <= 0 || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, THREADS, G::SMEM, stream>>>(*a);
  return (int)cudaGetLastError();
}

template <typename TI, typename TW, typename TO, int DH>
int run_dh(const Rwkv6Args* a, int chunk, cudaStream_t stream) {
  switch (chunk) {
    case 16: return run_k<TI, TW, TO, DH, 16>(a, stream);
    case 32: return run_k<TI, TW, TO, DH, 32>(a, stream);
    case 64: return run_k<TI, TW, TO, DH, 64>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename TI, typename TW, typename TO>
int run(const Rwkv6Args* a, int dh, int chunk, cudaStream_t stream) {
  switch (dh) {
    case 16: return run_dh<TI, TW, TO, 16>(a, chunk, stream);
    case 32: return run_dh<TI, TW, TO, 32>(a, chunk, stream);
    case 64: return run_dh<TI, TW, TO, 64>(a, chunk, stream);
    case 128: return run_dh<TI, TW, TO, 128>(a, chunk, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
