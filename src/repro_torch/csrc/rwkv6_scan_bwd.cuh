// The gradient of the chunked RWKV6 (Finch) recurrence, for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The TPU kernel `rwkv6_chunked_bhsd` of the JAX
// package (src/repro/kernels/rwkv6_scan.py:75) is forward only, and the
// JAX package trains through its own jnp `chunk_step` scan
// (src/repro/nn/ssm.py:139-160), which XLA differentiates.  The port runs
// the chunked form through its Hopper kernel (rwkv6_scan.cuh), so the
// gradient of that kernel is the port's to write: these kernels are the
// backward of `nn/ssm.py::rwkv6_mix_chunked` in training.
//
// What it computes.  For r, k, v, logw, dy indexed (B,S,H,dh) through
// their strides, S any length, u (H,dh), the vector-Jacobian product of
// the forward's function (from a zero state, with no gradient for the
// final state) with the output gradient dy.  Per (b, h) and chunk of C
// rows, with the forward's quantities
//
//     cum = inclusive cumsum of logw over the chunk, cp = cum[t-1] (0 at
//     t = 0: the forward's cum - logw), total = cum[C-1], mid = cum[C/2]
//     q_in = r e^{cp}, q_mid = r e^{cp-mid}, k_mid = k e^{mid-cum},
//     k_out = k e^{total-cum}, A = tril_{-1}(q_mid k_mid^T),
//     diag = sum_d r u k,  S0 the state entering the chunk,
//
// and dS the gradient of the state leaving it (0 after the last chunk):
//
//     dA = tril_{-1}(dy v^T),  ddiag = sum_e dy v
//     dq_in = dy S0^T,  dq_mid = dA k_mid,  dk_mid = dA^T q_mid,
//     dk_out = v dS^T
//     dr = Pr + ddiag u k,  Pr = dq_in e^{cp} + dq_mid e^{cp-mid}
//     dk = Pk + ddiag u r,  Pk = dk_mid e^{mid-cum} + dk_out e^{total-cum}
//     dv = k_out dS + A^T dy + diag dy
//     du += sum_t ddiag r k
//     dlogw[s] = sum_{t>s} r Pr[t] + sum_{t<s} k Pk[t] - sum_t Y[t]
//                + e^{total} sum_e S0 dS,   with Y = dk_mid k_mid
//
// (the chain rule through cp, cum and total per channel: r Pr =
// dq_in q_in + dq_mid q_mid and k Pk = dk_mid k_mid + dk_out k_out, so the
// pointwise -Y[s] and the Y parts of the two scans add up to one sum).
// The states and their gradients come from two recurrences over the
// chunks, elementwise over (d, e):
//
//     S0[c+1] = e^{total[c]} S0[c] + k_out[c]^T v[c]
//     dS[c-1] = e^{total[c]} dS[c] + q_in[c]^T dy[c]
//
// mid is a renormaliser: the function does not depend on it in exact
// arithmetic, and its two gradient terms (-sum_t dq_mid q_mid and
// +sum_s dk_mid k_mid, per channel) are equal, so the kernels treat it as
// a constant.  (XLA's autodiff of the jnp scan, and the plain version's
// autograd, carry both terms, which cancel up to rounding.)
//
// A ragged last chunk is masked as in the forward: rows past S are read as
// zeros (a zero logw row repeats the last real cum, so mid and total are
// what the zero-padded form reads) and their gradients are not stored.
//
// Bound: operations.  At RWKV6-7B's training shape (B, S, H, dh) = (4,
// 2048, 64, 64), C = 64, a chunk needs k_out^T v, q_in^T dy, dq_in,
// dk_out and k_out dS (2 C dh^2 FLOP each) and A, dA, dq_mid, dk_mid and
// A^T dy over the strictly lower triangle (C (C-1) dh each): 3,911,680
// FLOP a chunk, 3.20e10 in all, 0.478 ms at the card's fp32 rate (67
// TFLOP/s).  The bytes: bf16 r, k, v and fp32 logw, dy read, bf16 dr, dk,
// dv and fp32 dlogw written (24 B an element), 0.81 GB: 0.240 ms at 3.35
// TB/s.  (The workspace, S0 and dS for every chunk, 268 MB written by the
// products, read and written by the scans and read by the gradients, is
// the design's, not the function's: about 1.07 GB more, 0.32 ms.)
//
// Design: three kernels, launched in order on one stream by one call, so
// that the only sequential part, the two recurrences above, is a cheap
// elementwise pass, and the products run on one block a (b, h, chunk):
// 8,192 blocks at the training shape.
//   A. chunk_products: one block of 256 threads a chunk reads its k, v,
//      logw, r and dy once, forms cum and total (a parallel scan), k_out
//      and q_in, and writes k_out^T v and q_in^T dy (the last chunk's and
//      the first chunk's are never read, and not computed) and e^{total}
//      to the workspace.  logw comes first and cum is scanned while k,
//      v and r land; dy lands in cum's tile while k_out^T v runs: four
//      16 KB tiles, three blocks an SM.
//   B. state_scans: one thread a four (d, e) elements of one (b, h): the
//      forward recurrence over the chunks, in place over k_out^T v (the
//      slot of chunk c ends up holding the state entering it), then the
//      reverse one in place over q_in^T dy (the gradient of the state
//      leaving chunk c), eight chunks' loads issued before their
//      dependent arithmetic.
//   C. chunk_grads: one block of 256 threads a chunk computes dr, dk, dv
//      and dlogw from its inputs, S0 and dS, and writes its part of du to
//      a (B H n_chunks, dh) buffer that the wrapper sums (one torch
//      reduction in a fixed order).  Its copies go in three groups:
//      logw; the chunk's other operands, which land while cum is
//      scanned; S0 and dS, which land during the first row sums.
// No block waits on another, no float atomics, every sum in a fixed
// order: a call gives the same bits every time (the depth remat policies
// are held bitwise equal on the card).
//   - Loads: cp.async of 16 bytes a thread (four fp32 or eight bf16,
//     neighbouring threads on neighbouring addresses), zero-filled past S,
//     straight from the strided tensors into shared tiles; bf16 operands
//     that feed products land in the upper half of their fp32 tile and are
//     widened in place (read into registers, a barrier, written back).
//     Each operand is read once a kernel.
//   - fp32 tiles are row-major with each row's 16-byte groups XOR-permuted
//     by the row's group of four (sx<W>), so that float4 reads of four
//     rows 4 apart, of a column group of many rows, or of one row all fall
//     in distinct banks: no padding.
//   - Products: fp32 FMAs (fmaf; the build passes --fmad=false) over 4x4
//     register tiles, four steps of the summed index at a time from eight
//     float4 shared reads (64 FMAs).  The tensor cores are not used: the
//     fp32 limits of RWKV6_BWD_TOL need fp32 products, which would take
//     three TF32 passes (3xTF32) a product; left for later work.
//   - A and dA share one (C, C) tile M: dA below the diagonal and A^T
//     above it; the diagonal 4x4 step of each triangular product is masked.
//   - Per-channel scans (cum; the two exclusive scans and two sums of
//     dlogw and du) use the whole block: a warp takes four channels, its
//     lanes eight row segments of C/8 rows; each lane sums its segment in
//     order, then the segments combine by warp shuffles (Kogge-Stone) in a
//     fixed order.  Row sums (diag, ddiag, sum_e S0 dS) are one warp a row,
//     a warp's rows side by side, with a butterfly of shuffles.
//   - Measured (NVIDIA H100 80GB HBM3, 700 W; PERF.md): at the training
//     shape the three kernels take about 0.40, 0.18 and 1.35 ms; phase C
//     has 128 registers a thread with a few spilled bytes and two blocks
//     an SM, and its products reach about a quarter of the fp32 rate.
//   - Phase C's shared memory at dh = C = 64 for bf16 r/k/v: five fp32
//     slots of 16 KB reused along the way (logw->cum->du terms;
//     dy->dlogw; v->k_out->q_mid->r Pr; dS->k_mid->k Pk; S0->M->Y), r and
//     k kept as bf16 (16 KB) and 1.5 KB of per-row and per-channel values:
//     99,840 B, two blocks an SM (228 KB, 1 KB reserved a block); fp32
//     r/k/v need 116,224 B, one block an SM.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Passed by value from the ctypes wrapper (kernels/ops.py mirrors it).
struct Rwkv6BwdArgs {
  const void* r;      // (B,S,H,dh) in the input type
  const void* k;
  const void* v;
  const float* logw;  // (B,S,H,dh) fp32
  const float* u;     // (H,dh) fp32, contiguous
  const float* dy;    // (B,S,H,dh) fp32, the output's gradient
  void* dr;           // (B,S,H,dh) in the input type
  void* dk;
  void* dv;
  float* dlogw;       // (B,S,H,dh) fp32
  float* du;          // (B*H*n_chunks, dh) fp32: each chunk's part of du
  float* ws;          // (B*H*n_chunks, 2, dh, dh) fp32, then (B*H*n_chunks, dh)
  // (batch, sequence, head) strides in elements; dh has stride 1, and every
  // base and stride of r, k, v, logw and dy is a multiple of 16 bytes
  long long r_stride[3];
  long long k_stride[3];
  long long v_stride[3];
  long long w_stride[3];
  long long y_stride[3];
  long long dr_stride[3];
  long long dk_stride[3];
  long long dv_stride[3];
  long long dw_stride[3];
  int b, h, s;
};

namespace rwkv6_bwd {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t SMEM_PER_SM = 233472;  // 228 KB on an H100 SM
constexpr size_t SMEM_RESERVED = 1024;  // the runtime's share of each block

__device__ __forceinline__ float shfl_up(float x, int delta) {
  return __shfl_up_sync(FULL, x, delta);
}
__device__ __forceinline__ float shfl_down(float x, int delta) {
  return __shfl_down_sync(FULL, x, delta);
}
__device__ __forceinline__ float shfl_xor(float x, int m) { return __shfl_xor_sync(FULL, x, m); }
__device__ __forceinline__ float shfl_idx(float x, int src) { return __shfl_sync(FULL, x, src); }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float4 f4(float x) { return make_float4(x, x, x, x); }
__device__ __forceinline__ float at(const float4& x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}
__device__ __forceinline__ float4 from(const float (&x)[4]) {
  return make_float4(x[0], x[1], x[2], x[3]);
}

// four consecutive elements of a plain row-major tile as floats
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

// Element (row, col) of a row-major fp32 tile W floats wide whose 16-byte
// groups are XOR-permuted within each row by (row / 4) mod (W / 4).
template <int W>
__device__ __forceinline__ int sx(int row, int col) {
  return row * W + ((((col >> 2) ^ (row >> 2)) & (W / 4 - 1)) << 2) + (col & 3);
}
template <int W>
__device__ __forceinline__ float4 ld4(const float* t, int row, int col) {
  return *reinterpret_cast<const float4*>(t + sx<W>(row, col));
}
template <int W>
__device__ __forceinline__ void st4(float* t, int row, int col, float4 x) {
  *reinterpret_cast<float4*>(t + sx<W>(row, col)) = x;
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
__device__ __forceinline__ void cp_async_wait_all() { cp_async_wait<0>(); }

// ROWS rows of W fp32 (row stride rs) into a swizzled tile; rows from
// nvalid on are zero-filled (their source is row 0, never read)
template <int ROWS, int W>
__device__ __forceinline__ void load_swz(float* dst, const float* src, long long rs, int nvalid,
                                         int tid) {
  constexpr int CPR = W / 4;
#pragma unroll 1
  for (int i = tid; i < ROWS * CPR; i += THREADS) {
    const int t = i / CPR, c = (i % CPR) * 4;
    const bool ok = t < nvalid;
    cp_async16(dst + sx<W>(t, c), src + (ok ? t : 0) * rs + c, ok);
  }
}

// ... into a plain row-major tile of T
template <typename T, int ROWS, int W>
__device__ __forceinline__ void load_plain(T* dst, const T* src, long long rs, int nvalid,
                                           int tid) {
  constexpr int PER = 16 / sizeof(T), CPR = W / PER;
#pragma unroll 1
  for (int i = tid; i < ROWS * CPR; i += THREADS) {
    const int t = i / CPR, c = (i % CPR) * PER;
    const bool ok = t < nvalid;
    cp_async16(dst + t * W + c, src + (ok ? t : 0) * rs + c, ok);
  }
}

// An operand of the input type TI bound for a swizzled fp32 tile of ROWS x
// W: fp32 is copied straight in; bf16 is copied into the tile's upper half
// and widened in place (grab into registers, a barrier, put).  put applies
// f(row, col, four values) to every group of four on the way.
template <typename TI, int ROWS, int W>
struct TileIn {
  __device__ __forceinline__ static void issue(float* tile, const TI* src, long long rs,
                                               int nvalid, int tid) {
    load_swz<ROWS, W>(tile, src, rs, nvalid, tid);
  }
  __device__ __forceinline__ void grab(const float*, int) {}
  template <typename F>
  __device__ __forceinline__ void put(float* tile, int tid, F f) const {
#pragma unroll 1
    for (int i = tid; i < ROWS * W / 4; i += THREADS) {
      const int t = i / (W / 4), c = (i % (W / 4)) * 4;
      st4<W>(tile, t, c, f(t, c, ld4<W>(tile, t, c)));
    }
  }
};

template <int ROWS, int W>
struct TileIn<__nv_bfloat16, ROWS, W> {
  static constexpr int CHUNKS = ROWS * W / 8;  // groups of eight bf16
  static constexpr int N = (CHUNKS + THREADS - 1) / THREADS;
  uint4 raw[N];
  __device__ __forceinline__ static __nv_bfloat16* staging(float* tile) {
    return reinterpret_cast<__nv_bfloat16*>(tile + ROWS * W / 2);
  }
  __device__ __forceinline__ static void issue(float* tile, const __nv_bfloat16* src,
                                               long long rs, int nvalid, int tid) {
    load_plain<__nv_bfloat16, ROWS, W>(staging(tile), src, rs, nvalid, tid);
  }
  __device__ __forceinline__ void grab(float* tile, int tid) {
    const uint4* st = reinterpret_cast<const uint4*>(staging(tile));
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int i = tid + n * THREADS;
      if (i < CHUNKS) raw[n] = st[i];
    }
  }
  template <typename F>
  __device__ __forceinline__ void put(float* tile, int tid, F f) const {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int i = tid + n * THREADS;
      if (i < CHUNKS) {
        const int t = i / (W / 8), c = (i % (W / 8)) * 8;
        const float4 lo = load4(reinterpret_cast<const __nv_bfloat16*>(&raw[n].x));
        const float4 hi = load4(reinterpret_cast<const __nv_bfloat16*>(&raw[n].z));
        st4<W>(tile, t, c, f(t, c, lo));
        st4<W>(tile, t, c + 4, f(t, c + 4, hi));
      }
    }
  }
};

// Sizes of one instantiation, in floats unless named otherwise.
template <typename TI, int DH, int C>
struct Cfg {
  static constexpr int TD = C * DH;                         // a (C, dh) tile
  static constexpr int MX = C > DH ? C : DH;
  static constexpr int SLOT = MX * MX;                      // (C, dh), (dh, dh) or (C, C)
  static constexpr int TILES_D = (C / 4) * (DH / 4);        // 4x4 tiles of (C, dh)
  static constexpr int TILES_S = (DH / 4) * (DH / 4);       // ... of (dh, dh)
  static constexpr int TILES_A = (C / 4) * (C / 4);         // ... of (C, C)
  static constexpr size_t SMEM_A = (size_t)(4 * TD + DH) * 4;
  static constexpr size_t SMEM_C =
      (size_t)(5 * SLOT + 4 * DH + 2 * C) * 4 + 2 * (size_t)TD * sizeof(TI);
  static constexpr int MIN_BLOCKS_C = SMEM_C + SMEM_RESERVED <= SMEM_PER_SM / 2 ? 2 : 1;
  static_assert(TILES_D <= THREADS && TILES_S <= THREADS && TILES_A <= THREADS,
                "one 4x4 tile of each product a thread");
  static_assert(C % 8 == 0 && DH % 8 == 0, "eight row segments, 16-byte groups");
};

// acc[i][j] += sum over one step of four k (kk..kk+3, in order) of
// L(r0 + i, k) R(k, c0 + j).  L is [row][k] (LT false) or [k][row] (LT
// true), R is [k][col] (RT false) or [col][k] (RT true), swizzled tiles LW
// and RW wide.  MASK 1 keeps only k < row, MASK 2 only k > row.
template <bool LT, int LW, bool RT, int RW, int MASK>
__device__ __forceinline__ void step4(float (&acc)[4][4], const float* L, int r0,
                                      const float* R, int c0, int kk) {
  float a[4][4], b[4][4];  // a[i][m], b[m][j]
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const float4 l = LT ? ld4<LW>(L, kk + x, r0) : ld4<LW>(L, r0 + x, kk);
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      if (LT) a[y][x] = at(l, y);
      else a[x][y] = at(l, y);
    }
  }
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const float4 q = RT ? ld4<RW>(R, c0 + x, kk) : ld4<RW>(R, kk + x, c0);
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      if (RT) b[y][x] = at(q, y);
      else b[x][y] = at(q, y);
    }
  }
  if (MASK) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int m = 0; m < 4; ++m)
        if (MASK == 1 ? !(kk + m < r0 + i) : !(kk + m > r0 + i)) a[i][m] = 0.f;
  }
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i][m], b[m][j], acc[i][j]);
}

template <bool LT, int LW, bool RT, int RW>
__device__ __forceinline__ void mm(float (&acc)[4][4], const float* L, int r0, const float* R,
                                   int c0, int k0, int k1) {
#pragma unroll 2
  for (int kk = k0; kk < k1; kk += 4) step4<LT, LW, RT, RW, 0>(acc, L, r0, R, c0, kk);
}

__device__ __forceinline__ void zero4(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// cum in place over the (C, DH) tile T of logw; total (and mid) per
// channel.  A warp takes four channels a pass, lane = 4 g + channel: lane
// g sums rows g C/8 .. (g+1) C/8 - 1 in order, then the segments' sums
// combine by shuffles (Kogge-Stone over g).
template <int DH, int C>
__device__ __forceinline__ void scan_cum(float* T, float* mid, float* total, int lane,
                                         int warp) {
  constexpr int L = C / 8;
  const int cs = lane & 3, g = lane >> 2;
#pragma unroll
  for (int pass = 0; pass < (DH + 4 * WARPS - 1) / (4 * WARPS); ++pass) {
    const int d = warp * 4 + pass * 4 * WARPS + cs;
    if (d >= DH) break;  // the same in every lane of the warp
    float x[L];
    float run = 0.f;
#pragma unroll
    for (int i = 0; i < L; ++i) {
      run = run + T[sx<DH>(g * L + i, d)];
      x[i] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) {
      const float y = shfl_up(incl, 4 * off);
      if (g >= off) incl = y + incl;
    }
    float base = shfl_up(incl, 4);
    if (g == 0) base = 0.f;
#pragma unroll
    for (int i = 0; i < L; ++i) {
      x[i] = base + x[i];
      T[sx<DH>(g * L + i, d)] = x[i];
    }
    const float tot = shfl_idx(incl, 28 + cs);
    const float md = shfl_idx(x[0], 16 + cs);  // row 4 L = C / 2
    if (g == 0) {
      total[d] = tot;
      if (mid) mid[d] = md;
    }
  }
}

// each of x's sums over the lanes, the same bits in every lane (a
// butterfly: IEEE addition commutes exactly)
template <int N>
__device__ __forceinline__ void warp_sums(float (&x)[N]) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1)
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = x[i] + shfl_xor(x[i], m);
}

// ---------------------------------------------------------------------------
// A. the products of each chunk: k_out^T v and q_in^T dy, and e^{total}
// ---------------------------------------------------------------------------
template <typename TI, int DH, int C>
__global__ void __launch_bounds__(THREADS, 3) chunk_products(const Rwkv6BwdArgs a) {
  using G = Cfg<TI, DH, C>;
  extern __shared__ __align__(16) float smem[];
  float* Cm = smem;          // logw, then cum, then dy
  float* Ko = Cm + G::TD;    // k, then k_out
  float* V = Ko + G::TD;     // v
  float* Qi = V + G::TD;     // r, then q_in
  float* total = Qi + G::TD;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nc = (a.s + C - 1) / C;
  const int bhc = blockIdx.x, bh = bhc / nc, ci = bhc % nc;
  const int bi = bh / a.h, hi = bh % a.h;
  const long long t0 = (long long)ci * C;
  const int nvalid = min(C, a.s - ci * C);
  const TI* r = static_cast<const TI*>(a.r) + bi * a.r_stride[0] + t0 * a.r_stride[1] +
                hi * a.r_stride[2];
  const TI* k = static_cast<const TI*>(a.k) + bi * a.k_stride[0] + t0 * a.k_stride[1] +
                hi * a.k_stride[2];
  const TI* v = static_cast<const TI*>(a.v) + bi * a.v_stride[0] + t0 * a.v_stride[1] +
                hi * a.v_stride[2];
  const float* lw = a.logw + bi * a.w_stride[0] + t0 * a.w_stride[1] + hi * a.w_stride[2];
  const float* dy = a.dy + bi * a.y_stride[0] + t0 * a.y_stride[1] + hi * a.y_stride[2];
  const long long chunks = (long long)a.b * a.h * nc;
  float* kv = a.ws + (size_t)bhc * 2 * DH * DH;
  float* qy = kv + DH * DH;
  float* etot = a.ws + (size_t)chunks * 2 * DH * DH + (size_t)bhc * DH;

  // logw first: cum is scanned while k, v and r land
  using In = TileIn<TI, C, DH>;
  load_swz<C, DH>(Cm, lw, a.w_stride[1], nvalid, tid);
  cp_async_commit();
  In::issue(Ko, k, a.k_stride[1], nvalid, tid);
  In::issue(V, v, a.v_stride[1], nvalid, tid);
  In::issue(Qi, r, a.r_stride[1], nvalid, tid);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  scan_cum<DH, C>(Cm, nullptr, total, lane, warp);
  cp_async_wait_all();
  __syncthreads();

  In sk, sv, sr;
  sk.grab(Ko, tid);
  sv.grab(V, tid);
  sr.grab(Qi, tid);
  __syncthreads();

  if (tid < DH) etot[tid] = expf(total[tid]);
  if (sizeof(TI) == 2) sv.put(V, tid, [](int, int, float4 x) { return x; });
  sk.put(Ko, tid, [&](int t, int c, float4 x) {  // k_out = k e^{total - cum}
    const float4 cu = ld4<DH>(Cm, t, c), tt = *reinterpret_cast<const float4*>(total + c);
    return make_float4(x.x * expf(tt.x - cu.x), x.y * expf(tt.y - cu.y),
                       x.z * expf(tt.z - cu.z), x.w * expf(tt.w - cu.w));
  });
  sr.put(Qi, tid, [&](int t, int c, float4 x) {  // q_in = r e^{cp}
    const float4 cp = t > 0 ? ld4<DH>(Cm, t - 1, c) : f4(0.f);
    return make_float4(x.x * expf(cp.x), x.y * expf(cp.y), x.z * expf(cp.z),
                       x.w * expf(cp.w));
  });
  __syncthreads();  // cum is dead: dy lands in its tile while k_out^T v runs
  load_swz<C, DH>(Cm, dy, a.y_stride[1], nvalid, tid);
  cp_async_commit();

  // (d, e) tiles: k_out^T v (not for the last chunk) and q_in^T dy (not
  // for the first), t in order
  const bool own = tid < G::TILES_S;
  const int d0 = 4 * (tid / (DH / 4)), e0 = 4 * (tid % (DH / 4));
  float acc[4][4];
  if (own && ci + 1 < nc) {
    zero4(acc);
    mm<true, DH, false, DH>(acc, Ko, d0, V, e0, 0, C);
#pragma unroll
    for (int i = 0; i < 4; ++i) store4(kv + (d0 + i) * DH + e0, from(acc[i]));
  }
  cp_async_wait_all();
  __syncthreads();
  if (own && ci > 0) {
    zero4(acc);
    mm<true, DH, false, DH>(acc, Qi, d0, Cm, e0, 0, C);
#pragma unroll
    for (int i = 0; i < 4; ++i) store4(qy + (d0 + i) * DH + e0, from(acc[i]));
  }
}

// ---------------------------------------------------------------------------
// B. the two recurrences over the chunks, in place, elementwise over (d, e)
// ---------------------------------------------------------------------------
template <int DH>
__global__ void __launch_bounds__(THREADS) state_scans(float* ws, int bh_count, int nc) {
  constexpr int Q = DH * DH / 4;  // groups of four (d, e) elements
  constexpr int BATCH = 8;        // chunks whose loads are issued together
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= (long long)bh_count * Q) return;
  const int bh = (int)(idx / Q), q = (int)(idx % Q), d = q / (DH / 4);
  const size_t step = 2 * (size_t)DH * DH;
  float* base = ws + (size_t)bh * nc * step + 4 * (size_t)q;
  const float* etot = ws + (size_t)bh_count * nc * step + (size_t)bh * nc * DH + d;

  // S0[c] = state entering chunk c: S0[0] = 0, S0[c+1] = e^{total[c]} S0[c] + kv[c]
  float4 S = f4(0.f);
#pragma unroll 1
  for (int c0 = 0; c0 < nc; c0 += BATCH) {
    float4 kv[BATCH];
    float e[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int c = c0 + j;
      kv[j] = c + 1 < nc ? *reinterpret_cast<const float4*>(base + c * step) : f4(0.f);
      e[j] = c < nc ? etot[(size_t)c * DH] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int c = c0 + j;
      if (c < nc) {
        *reinterpret_cast<float4*>(base + c * step) = S;
        S = make_float4(e[j] * S.x + kv[j].x, e[j] * S.y + kv[j].y, e[j] * S.z + kv[j].z,
                        e[j] * S.w + kv[j].w);
      }
    }
  }
  // dS[c] = gradient of the state leaving chunk c: dS[nc-1] = 0,
  // dS[c-1] = e^{total[c]} dS[c] + qy[c]
  float4 D = f4(0.f);
#pragma unroll 1
  for (int c0 = nc - 1; c0 >= 0; c0 -= BATCH) {
    float4 qy[BATCH];
    float e[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int c = c0 - j;
      qy[j] = c > 0 ? *reinterpret_cast<const float4*>(base + c * step + DH * DH) : f4(0.f);
      e[j] = c >= 0 ? etot[(size_t)c * DH] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int c = c0 - j;
      if (c >= 0) {
        *reinterpret_cast<float4*>(base + c * step + DH * DH) = D;
        D = make_float4(e[j] * D.x + qy[j].x, e[j] * D.y + qy[j].y, e[j] * D.z + qy[j].z,
                        e[j] * D.w + qy[j].w);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// C. the gradients of each chunk, from S0 and dS
// ---------------------------------------------------------------------------
template <typename TI, int DH, int C>
__global__ void __launch_bounds__(THREADS, (Cfg<TI, DH, C>::MIN_BLOCKS_C))
    chunk_grads(const Rwkv6BwdArgs a) {
  using G = Cfg<TI, DH, C>;
  extern __shared__ __align__(16) float smem[];
  float* S1 = smem;            // logw -> cum -> ddiag r k
  float* S2 = S1 + G::SLOT;    // dy -> dlogw
  float* S3 = S2 + G::SLOT;    // v -> k_out -> q_mid -> r Pr
  float* S4 = S3 + G::SLOT;    // dS -> k_mid -> k Pk
  float* S5 = S4 + G::SLOT;    // S0 -> M (A^T above the diagonal, dA below) -> Y
  TI* Rb = reinterpret_cast<TI*>(S5 + G::SLOT);  // r, plain
  TI* Kb = Rb + G::TD;                           // k, plain
  float* mid = reinterpret_cast<float*>(Kb + G::TD);
  float* total = mid + DH;
  float* uu = total + DH;
  float* sdS = uu + DH;    // sum_e S0 dS
  float* diag = sdS + DH;  // sum_d r u k
  float* ddiag = diag + C; // sum_e dy v

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nc = (a.s + C - 1) / C;
  const int bhc = blockIdx.x, bh = bhc / nc, ci = bhc % nc;
  const int bi = bh / a.h, hi = bh % a.h;
  const long long t0 = (long long)ci * C;
  const int nvalid = min(C, a.s - ci * C);
  const TI* r = static_cast<const TI*>(a.r) + bi * a.r_stride[0] + t0 * a.r_stride[1] +
                hi * a.r_stride[2];
  const TI* k = static_cast<const TI*>(a.k) + bi * a.k_stride[0] + t0 * a.k_stride[1] +
                hi * a.k_stride[2];
  const TI* v = static_cast<const TI*>(a.v) + bi * a.v_stride[0] + t0 * a.v_stride[1] +
                hi * a.v_stride[2];
  const float* lw = a.logw + bi * a.w_stride[0] + t0 * a.w_stride[1] + hi * a.w_stride[2];
  const float* dy = a.dy + bi * a.y_stride[0] + t0 * a.y_stride[1] + hi * a.y_stride[2];
  TI* dr = static_cast<TI*>(a.dr) + bi * a.dr_stride[0] + t0 * a.dr_stride[1] +
           hi * a.dr_stride[2];
  TI* dk = static_cast<TI*>(a.dk) + bi * a.dk_stride[0] + t0 * a.dk_stride[1] +
           hi * a.dk_stride[2];
  TI* dv = static_cast<TI*>(a.dv) + bi * a.dv_stride[0] + t0 * a.dv_stride[1] +
           hi * a.dv_stride[2];
  float* dlw = a.dlogw + bi * a.dw_stride[0] + t0 * a.dw_stride[1] + hi * a.dw_stride[2];
  const long long drs = a.dr_stride[1], dks = a.dk_stride[1], dvs = a.dv_stride[1],
                  dws = a.dw_stride[1];
  const float* S0g = a.ws + (size_t)bhc * 2 * DH * DH;
  const float* dSg = S0g + DH * DH;

  // three groups of copies: logw; the chunk's other operands, which land
  // while cum is scanned; S0 and dS, which land during the row sums
  using In = TileIn<TI, C, DH>;
  load_swz<C, DH>(S1, lw, a.w_stride[1], nvalid, tid);
  cp_async_commit();
  load_swz<C, DH>(S2, dy, a.y_stride[1], nvalid, tid);
  In::issue(S3, v, a.v_stride[1], nvalid, tid);
  load_plain<TI, C, DH>(Rb, r, a.r_stride[1], nvalid, tid);
  load_plain<TI, C, DH>(Kb, k, a.k_stride[1], nvalid, tid);
  cp_async_commit();
  load_swz<DH, DH>(S4, dSg, DH, DH, tid);
  load_swz<DH, DH>(S5, S0g, DH, DH, tid);
  cp_async_commit();
  if (tid < DH) uu[tid] = a.u[(size_t)hi * DH + tid];
  cp_async_wait<2>();
  __syncthreads();

  // 1. cum, mid, total; v widened (bf16)
  scan_cum<DH, C>(S1, mid, total, lane, warp);
  cp_async_wait<1>();
  __syncthreads();
  if (sizeof(TI) == 2) {
    In sv;
    sv.grab(S3, tid);
    __syncthreads();
    sv.put(S3, tid, [](int, int, float4 x) { return x; });
    __syncthreads();
  }

  // 2. the row sums: ddiag and diag (C rows), sum_e S0 dS (dh rows); a
  //    warp's rows side by side, so that their shuffles overlap
  {
    constexpr int RW = C / WARPS;
    float g[RW], dg[RW];
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int t = warp + i * WARPS;
      g[i] = 0.f;
      dg[i] = 0.f;
#pragma unroll
      for (int c = lane; c < DH; c += 32) {
        const int x = sx<DH>(t, c);
        g[i] = fmaf(S2[x], S3[x], g[i]);
        const float rr = to_f32(Rb[t * DH + c]), kk = to_f32(Kb[t * DH + c]);
        dg[i] = fmaf(rr * uu[c], kk, dg[i]);
      }
    }
    warp_sums(g);
    warp_sums(dg);
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        ddiag[warp + i * WARPS] = g[i];
        diag[warp + i * WARPS] = dg[i];
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();  // S0 and dS have landed
  {
    constexpr int RW = DH / WARPS;
    float sd[RW];
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int d = warp + i * WARPS;
      sd[i] = 0.f;
#pragma unroll
      for (int c = lane; c < DH; c += 32) {
        const int x = sx<DH>(d, c);
        sd[i] = fmaf(S5[x], S4[x], sd[i]);
      }
    }
    warp_sums(sd);
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < RW; ++i) sdS[warp + i * WARPS] = sd[i];
    }
  }

  // this thread's 4x4 tile of the (C, dh) outputs, rows t0r.., columns c0..
  const bool own = tid < G::TILES_D;
  const int t0r = 4 * (tid / (DH / 4)), c0 = 4 * (tid % (DH / 4));
  // ... and of the (C, C) tile M
  const bool own_a = tid < G::TILES_A;
  const int ti = tid / (C / 4), tj = tid % (C / 4);

  // 3. dq_in = dy S0^T and dk_out = v dS^T, held in registers
  float dqi[4][4], dko[4][4], dva[4][4];
  zero4(dqi);
  zero4(dko);
  zero4(dva);
  if (own) {
    mm<false, DH, true, DH>(dqi, S2, t0r, S5, c0, 0, DH);
    mm<false, DH, true, DH>(dko, S3, t0r, S4, c0, 0, DH);
  }
  __syncthreads();  // S0 is dead

  // 4. dA below the diagonal of M: dA[t][s] = sum_e dy[t][e] v[s][e]
  if (own_a && ti >= tj) {
    float acc[4][4];
    zero4(acc);
    mm<false, DH, true, DH>(acc, S2, 4 * ti, S3, 4 * tj, 0, DH);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (ti > tj) {
        st4<C>(S5, 4 * ti + i, 4 * tj, from(acc[i]));
      } else {
#pragma unroll
        for (int j = 0; j < i; ++j) S5[sx<C>(4 * ti + i, 4 * tj + j)] = acc[i][j];
      }
    }
  }
  __syncthreads();  // v is dead

  // 5. k_out into S3; dv = k_out dS (then A^T dy below)
  if (own) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0r + i;
      const float4 kk = load4(Kb + t * DH + c0), cu = ld4<DH>(S1, t, c0),
                   tt = *reinterpret_cast<const float4*>(total + c0);
      st4<DH>(S3, t, c0,
              make_float4(kk.x * expf(tt.x - cu.x), kk.y * expf(tt.y - cu.y),
                          kk.z * expf(tt.z - cu.z), kk.w * expf(tt.w - cu.w)));
    }
  }
  __syncthreads();
  if (own) mm<false, DH, false, DH>(dva, S3, t0r, S4, c0, 0, DH);
  __syncthreads();  // k_out and dS are dead

  // 6. q_mid into S3, k_mid into S4
  if (own) {
    const float4 md = *reinterpret_cast<const float4*>(mid + c0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0r + i;
      const float4 rr = load4(Rb + t * DH + c0), kk = load4(Kb + t * DH + c0),
                   cu = ld4<DH>(S1, t, c0), cp = t > 0 ? ld4<DH>(S1, t - 1, c0) : f4(0.f);
      st4<DH>(S3, t, c0,
              make_float4(rr.x * expf(cp.x - md.x), rr.y * expf(cp.y - md.y),
                          rr.z * expf(cp.z - md.z), rr.w * expf(cp.w - md.w)));
      st4<DH>(S4, t, c0,
              make_float4(kk.x * expf(md.x - cu.x), kk.y * expf(md.y - cu.y),
                          kk.z * expf(md.z - cu.z), kk.w * expf(md.w - cu.w)));
    }
  }
  __syncthreads();

  // 7. A^T above the diagonal of M: M[s][t] = A[t][s] = sum_d k_mid[s][d]
  //    q_mid[t][d], rows s of tile tj, columns t of tile ti
  if (own_a && ti >= tj) {
    float acc[4][4];
    zero4(acc);
    mm<false, DH, true, DH>(acc, S4, 4 * tj, S3, 4 * ti, 0, DH);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (tj < ti) {
        st4<C>(S5, 4 * tj + i, 4 * ti, from(acc[i]));
      } else {
#pragma unroll
        for (int j = i + 1; j < 4; ++j) S5[sx<C>(4 * tj + i, 4 * ti + j)] = acc[i][j];
      }
    }
  }
  __syncthreads();

  float Wq[4][4], Kq[4][4], Yq[4][4];  // r Pr, k Pk, dk_mid k_mid
  if (own) {
    // 8. dv += A^T dy (t' > t: M[t][t'] = A[t'][t]); dv + diag dy stored
    step4<false, C, false, DH, 2>(dva, S5, t0r, S2, c0, t0r);
    mm<false, C, false, DH>(dva, S5, t0r, S2, c0, t0r + 4, C);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0r + i;
      const float4 y = ld4<DH>(S2, t, c0);
      const float g = diag[t];
      if (t < nvalid)
        store4(dv + t * dvs + c0,
               make_float4(dva[i][0] + g * y.x, dva[i][1] + g * y.y, dva[i][2] + g * y.z,
                           dva[i][3] + g * y.w));
    }

    // 9. dq_mid = dA k_mid (s < t); dr stored
    float acc[4][4];
    zero4(acc);
    mm<false, C, false, DH>(acc, S5, t0r, S4, c0, 0, t0r);
    step4<false, C, false, DH, 1>(acc, S5, t0r, S4, c0, t0r);
    const float4 md = *reinterpret_cast<const float4*>(mid + c0),
                 tt = *reinterpret_cast<const float4*>(total + c0),
                 u4 = *reinterpret_cast<const float4*>(uu + c0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0r + i;
      const float4 rr = load4(Rb + t * DH + c0), kk = load4(Kb + t * DH + c0),
                   cp = t > 0 ? ld4<DH>(S1, t - 1, c0) : f4(0.f);
      const float g = ddiag[t];
      float o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float c = at(cp, j);
        const float pr = dqi[i][j] * expf(c) + acc[i][j] * expf(c - at(md, j));
        o[j] = pr + (g * at(u4, j)) * at(kk, j);
        Wq[i][j] = at(rr, j) * pr;
      }
      if (t < nvalid) store4(dr + t * drs + c0, from(o));
    }

    // 10. dk_mid = dA^T q_mid (t' > t: M[t'][t] = dA[t'][t]); dk stored
    zero4(acc);
    step4<true, C, false, DH, 2>(acc, S5, t0r, S3, c0, t0r);
    mm<true, C, false, DH>(acc, S5, t0r, S3, c0, t0r + 4, C);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0r + i;
      const float4 rr = load4(Rb + t * DH + c0), kk = load4(Kb + t * DH + c0),
                   cu = ld4<DH>(S1, t, c0), km = ld4<DH>(S4, t, c0);
      const float g = ddiag[t];
      float o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float c = at(cu, j);
        const float pk = acc[i][j] * expf(at(md, j) - c) + dko[i][j] * expf(at(tt, j) - c);
        o[j] = pk + (g * at(u4, j)) * at(rr, j);
        Kq[i][j] = at(kk, j) * pk;
        Yq[i][j] = acc[i][j] * at(km, j);
      }
      if (t < nvalid) store4(dk + t * dks + c0, from(o));
    }
  }
  __syncthreads();  // every product is done with the tiles

  // 11. the terms of dlogw and du, into dead slots
  if (own) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0r + i;
      const float4 rr = load4(Rb + t * DH + c0), kk = load4(Kb + t * DH + c0);
      const float g = ddiag[t];
      st4<DH>(S3, t, c0, from(Wq[i]));
      st4<DH>(S4, t, c0, from(Kq[i]));
      st4<DH>(S5, t, c0, from(Yq[i]));
      st4<DH>(S1, t, c0,
              make_float4(g * rr.x * kk.x, g * rr.y * kk.y, g * rr.z * kk.z, g * rr.w * kk.w));
    }
  }
  __syncthreads();

  // 12. per channel: dlogw[s] = sum_{t>s} r Pr + sum_{t<s} k Pk
  //     + (e^{total} sum_e S0 dS - sum_t Y), into S2; du's part.  Lanes as
  //     in scan_cum: a suffix scan (Kogge-Stone down) and a prefix scan
  //     over the segments, and two sums.
  {
    constexpr int L = C / 8;
    const int cs = lane & 3, g = lane >> 2;
    float* du = a.du + (size_t)bhc * DH;
#pragma unroll
    for (int pass = 0; pass < (DH + 4 * WARPS - 1) / (4 * WARPS); ++pass) {
      const int d = warp * 4 + pass * 4 * WARPS + cs;
      if (d >= DH) break;  // the same in every lane of the warp
      float suf[L], pre[L];
      float sw = 0.f, sk = 0.f, sy = 0.f, su = 0.f;
#pragma unroll
      for (int i = L - 1; i >= 0; --i) {
        suf[i] = sw;
        sw = sw + S3[sx<DH>(g * L + i, d)];
      }
#pragma unroll
      for (int i = 0; i < L; ++i) {
        const int x = sx<DH>(g * L + i, d);
        pre[i] = sk;
        sk = sk + S4[x];
        sy = sy + S5[x];
        su = su + S1[x];
      }
      float inw = sw, ink = sk;
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) {
        const float yw = shfl_down(inw, 4 * off), yk = shfl_up(ink, 4 * off);
        if (g + off < 8) inw = inw + yw;
        if (g >= off) ink = yk + ink;
      }
      float bw = shfl_down(inw, 4), bk = shfl_up(ink, 4);
      if (g == 7) bw = 0.f;
      if (g == 0) bk = 0.f;
#pragma unroll
      for (int m = 4; m < 32; m <<= 1) {
        sy = sy + shfl_xor(sy, m);
        su = su + shfl_xor(su, m);
      }
      const float cst = expf(total[d]) * sdS[d] - sy;
#pragma unroll
      for (int i = 0; i < L; ++i)
        S2[sx<DH>(g * L + i, d)] = ((bw + suf[i]) + (bk + pre[i])) + cst;
      if (g == 0) du[d] = su;
    }
  }
  __syncthreads();

  // 13. dlogw rows out, 16 bytes a thread
#pragma unroll 1
  for (int i = tid; i < nvalid * (DH / 4); i += THREADS) {
    const int t = i / (DH / 4), c = (i % (DH / 4)) * 4;
    store4(dlw + t * dws + c, ld4<DH>(S2, t, c));
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <typename TI, int DH, int C>
int set_smem() {
  using G = Cfg<TI, DH, C>;
  cudaError_t err = cudaFuncSetAttribute(chunk_products<TI, DH, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)G::SMEM_A);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaFuncSetAttribute(chunk_grads<TI, DH, C>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)G::SMEM_C);
}

// A, B, C on the stream, each launch checked
template <typename TI, int DH, int C>
int run_k(const Rwkv6BwdArgs* a, cudaStream_t stream) {
  using G = Cfg<TI, DH, C>;
  if (a->b <= 0 || a->h <= 0 || a->s <= 0) return (int)cudaErrorInvalidValue;
  const long long nc = (a->s + C - 1) / C, bh = (long long)a->b * a->h, chunks = bh * nc;
  const long long scan_blocks = (bh * (DH * DH / 4) + THREADS - 1) / THREADS;
  if (chunks > 0x7fffffffLL || scan_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  int err = set_smem<TI, DH, C>();
  if (err) return err;
  chunk_products<TI, DH, C><<<(unsigned)chunks, THREADS, G::SMEM_A, stream>>>(*a);
  err = (int)cudaGetLastError();
  if (err) return err;
  state_scans<DH><<<(unsigned)scan_blocks, THREADS, 0, stream>>>(a->ws, (int)bh, (int)nc);
  err = (int)cudaGetLastError();
  if (err) return err;
  chunk_grads<TI, DH, C><<<(unsigned)chunks, THREADS, G::SMEM_C, stream>>>(*a);
  return (int)cudaGetLastError();
}

// out[0..2]: resident blocks an SM of A, B, C; out[3], out[4]: the dynamic
// shared bytes of A and C (registers and spills: ptxas -v's log)
template <typename TI, int DH, int C>
int info_k(int* out) {
  using G = Cfg<TI, DH, C>;
  int err = set_smem<TI, DH, C>();
  if (err) return err;
  const void* fns[3] = {(const void*)chunk_products<TI, DH, C>, (const void*)state_scans<DH>,
                        (const void*)chunk_grads<TI, DH, C>};
  const size_t smem[3] = {G::SMEM_A, 0, G::SMEM_C};
  for (int i = 0; i < 3; ++i) {
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[i], fns[i], THREADS, smem[i]);
    if (err) return err;
  }
  out[3] = (int)G::SMEM_A;
  out[4] = (int)G::SMEM_C;
  return 0;
}

template <typename TI, int DH>
int run_dh(const Rwkv6BwdArgs* a, int chunk, cudaStream_t stream) {
  switch (chunk) {
    case 16: return run_k<TI, DH, 16>(a, stream);
    case 32: return run_k<TI, DH, 32>(a, stream);
    case 64: return run_k<TI, DH, 64>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename TI>
int run(const Rwkv6BwdArgs* a, int dh, int chunk, cudaStream_t stream) {
  switch (dh) {
    case 16: return run_dh<TI, 16>(a, chunk, stream);
    case 32: return run_dh<TI, 32>(a, chunk, stream);
    case 64: return run_dh<TI, 64>(a, chunk, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename TI, int DH>
int info_dh(int chunk, int* out) {
  switch (chunk) {
    case 16: return info_k<TI, DH, 16>(out);
    case 32: return info_k<TI, DH, 32>(out);
    case 64: return info_k<TI, DH, 64>(out);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename TI>
int info(int dh, int chunk, int* out) {
  switch (dh) {
    case 16: return info_dh<TI, 16>(chunk, out);
    case 32: return info_dh<TI, 32>(chunk, out);
    case 64: return info_dh<TI, 64>(chunk, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace rwkv6_bwd
