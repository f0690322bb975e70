// The gradient of the chunked RWKV6 (Finch) recurrence, for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The TPU kernel `rwkv6_chunked_bhsd` of the JAX
// package (src/repro/kernels/rwkv6_scan.py:75) is forward only, and the
// JAX package trains through its own jnp `chunk_step` scan
// (src/repro/nn/ssm.py:139-160), which XLA differentiates.  The port runs
// the chunked form through its Hopper kernel (rwkv6_scan.cuh), so the
// gradient of that kernel is the port's to write: this kernel is the
// backward of `nn/ssm.py::rwkv6_mix_chunked` in training.
//
// What it computes.  For r, k, v, logw, dy indexed (B,S,H,dh) through
// their strides, S any length, u (H,dh), the vector-Jacobian product of
// the forward's function (from a zero state, with no gradient for the
// final state) with the output gradient dy.  Per (b, h) and chunk of C
// rows, with the forward's quantities
//
//     cum = inclusive cumsum of logw over the chunk, cp = cum - logw,
//     total = cum[C-1], mid = cum[C/2]
//     q_in = r e^{cp}, q_mid = r e^{cp-mid}, k_mid = k e^{mid-cum},
//     k_out = k e^{total-cum}, A = tril_{-1}(q_mid k_mid^T),
//     diag = sum_d r u k,  S0 the state entering the chunk,
//
// and dS the gradient of the state leaving it (0 after the last chunk):
//
//     dA = tril_{-1}(dy v^T),  ddiag = sum_e dy v
//     dq_in = dy S0^T,  dq_mid = dA k_mid,  dk_mid = dA^T q_mid,
//     dk_out = v dS^T
//     dr = dq_in e^{cp} + dq_mid e^{cp-mid} + ddiag u k
//     dk = dk_mid e^{mid-cum} + dk_out e^{total-cum} + ddiag u r
//     dv = k_out dS + A^T dy + diag dy
//     du += sum_t ddiag r k
//     dlogw[s] = sum_{t>s} W[t] - Y[s] + sum_{t<s} Z[t] + e^{total} sum_e S0 dS
//        with W = dq_in q_in + dq_mid q_mid - Y, Y = dk_mid k_mid,
//        Z = dk_out k_out (the chain rule through cp = cum - logw, the
//        cumulative sum and total = cum[C-1], per channel)
//     dS <- e^{total} dS + q_in^T dy       (the state entering the chunk)
//
// mid is a renormaliser: the function does not depend on it in exact
// arithmetic, and its two gradient terms (-sum_t dq_mid q_mid and
// +sum_s dk_mid k_mid, per channel) are equal, so the kernel treats it as
// a constant.  (XLA's autodiff of the jnp scan, and the plain version's
// autograd, carry both terms, which cancel up to rounding.)
//
// A ragged last chunk is masked as in the forward: rows past S are read as
// zeros (a zero logw row repeats the last real cum, so mid and total are
// what the zero-padded form reads) and their gradients are not stored.
//
// Bound: operations.  At RWKV6-7B's training shape (B, S, H, dh) = (4,
// 2048, 64, 64), C = 64, a chunk needs the state recomputation k_out^T v,
// dq_in, dk_out, the two products of dv and q_in^T dy (2 C dh^2 FLOP
// each) and A, dA, dq_mid, dk_mid and A^T dy over the strictly lower
// triangle (C (C-1) dh each): 3,911,680 FLOP a chunk, 3.20e10 in all,
// 0.478 ms at the card's fp32 rate (67 TFLOP/s).  The bytes: bf16 r, k, v
// and fp32 logw, dy read, bf16 dr, dk, dv and fp32 dlogw written (24 B an
// element), 0.81 GB: 0.240 ms at 3.35 TB/s.  (The state workspace, 134 MB
// written and read back, is the design's, not the function's.)
//
// Design: simple and deterministic first (no float atomics, every sum in
// a fixed order, so a call gives the same bits every time: the depth
// remat policies are held bitwise equal on the card).
//   - One block of 256 threads a (b, h); the whole sequence in the block.
//   - A forward sweep recomputes the state entering every chunk (4x4
//     register tiles of S; S <- e^{total} S + k_out^T v, t in order) and
//     writes it to a workspace of B H n_chunks dh^2 floats.
//   - A reverse sweep over the chunks carries dS in registers (and a
//     shared copy for the products that read it).  Per chunk: the raw
//     chunk and its state are read into shared fp32 tiles (rows past S as
//     zeros); warps split the per-channel cumsum, the diagonal rows and
//     sum_e S0 dS; the four decayed factors are formed once (expf, the
//     forward's formulas); A and dA over the lower triangle; then each
//     thread owns one 4x4 tile of (t, d) and computes dq_in, dq_mid,
//     dk_mid and dk_out there, so dr and dk are finished in registers and
//     stored, with W, Y, Z and ddiag r k kept for the per-channel scans;
//     one 4x4 tile of dv and one of the new dS.  After a barrier W, Y, Z
//     and ddiag r k go to dead tiles and one thread a channel runs the
//     reverse and forward scans of dlogw and sums du over the chunk.
//   - Products are fp32 FMAs over 4x4 register tiles with scalar shared
//     loads; every tile row is dh + 1 (or C + 1) floats wide, so the rows a
//     warp reads fall in different banks (at most 2-way conflicts).
//   - du: each block writes its (b, h) partial; the wrapper sums them over
//     b (one torch reduction, a fixed order).
//   - Shared memory at dh = C = 64: 7 (C, dh) tiles, 2 (dh, dh) and 2
//     (C, C), 183 KB: one block an SM, 256 blocks at the training shape.
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
  float* du;          // (B*H, dh) fp32: each (b, h)'s part of du
  float* ws;          // (B*H, n_chunks, dh, dh) fp32 workspace
  // (batch, sequence, head) strides in elements; dh has stride 1
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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// Sizes of one instantiation, in floats.
template <int DH, int C>
struct Cfg {
  static constexpr int LT = DH + 1;   // row stride of the (C, dh) and (dh, dh) tiles
  static constexpr int LA = C + 1;    // row stride of the (C, C) tiles
  static constexpr int TD = C * LT;   // a (C, dh) tile
  static constexpr int TS = DH * LT;  // a (dh, dh) tile
  static constexpr int TA = C * LA;   // a (C, C) tile
  static constexpr int SMALL = 4 * DH + 2 * C;  // mid, total, u, sum S0 dS; diag, ddiag
  static constexpr size_t SMEM = (size_t)(7 * TD + 2 * TS + 2 * TA + SMALL) * 4;
  static constexpr int TD_TILES = (C / 4) * (DH / 4);  // 4x4 tiles of (C, dh)
  static constexpr int TS_TILES = (DH / 4) * (DH / 4);
  static constexpr int TA_TILES = (C / 4) * (C / 4);
  static_assert(TD_TILES <= THREADS && TS_TILES <= THREADS && TA_TILES <= THREADS,
                "one 4x4 tile of each product a thread");
  static_assert(2 * DH + C <= THREADS, "threads for the scans, the diagonal and S0 dS");
};

// acc[i][j] += sum_{k0 <= kk < k1} L(i, kk) R(kk, j), kk in order
template <typename LF, typename RF>
__device__ __forceinline__ void mm4(float (&acc)[4][4], int k0, int k1, LF L, RF R) {
#pragma unroll 4
  for (int kk = k0; kk < k1; ++kk) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = L(i, kk);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = R(kk, j);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero4(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// Rows [0, nvalid) of a (C, DH) chunk from global (row stride rs) into a
// shared tile of row stride LT, as fp32; the other rows as zeros.
template <typename T, int DH, int C>
__device__ __forceinline__ void load_chunk(float* dst, const T* src, long long rs, int nvalid,
                                           int tid) {
  constexpr int LT = DH + 1;
  for (int i = tid; i < C * DH; i += THREADS) {
    const int t = i / DH, d = i % DH;
    dst[t * LT + d] = t < nvalid ? to_f32(src[t * rs + d]) : 0.f;
  }
}

template <typename TI, int DH, int C>
__global__ void __launch_bounds__(THREADS, 1) rwkv6_chunked_bwd_kernel(const Rwkv6BwdArgs a) {
  using G = Cfg<DH, C>;
  constexpr int LT = G::LT, LA = G::LA;
  extern __shared__ __align__(16) float smem[];
  float* Tq = smem;          // r, then q_in; then W
  float* Tqm = Tq + G::TD;   // q_mid; then Y
  float* Tk = Tqm + G::TD;   // k, then k_mid; then Z
  float* Tko = Tk + G::TD;   // logw, then k_out; then ddiag r k
  float* Tc = Tko + G::TD;   // cum
  float* Tv = Tc + G::TD;    // v
  float* Ty = Tv + G::TD;    // dy
  float* TS = Ty + G::TD;    // S0, the state entering the chunk
  float* TdS = TS + G::TS;   // dS, the gradient of the state leaving it
  float* TA = TdS + G::TS;   // A = tril_{-1}(q_mid k_mid^T)
  float* TdA = TA + G::TA;   // dA = tril_{-1}(dy v^T)
  float* mid = TdA + G::TA;
  float* total = mid + DH;
  float* uu = total + DH;
  float* sdS = uu + DH;      // sum_e S0[d][e] dS[d][e]
  float* diag = sdS + DH;
  float* ddiag = diag + C;

  const int tid = threadIdx.x, bh = blockIdx.x;
  const int bi = bh / a.h, hi = bh % a.h;
  const TI* r = static_cast<const TI*>(a.r) + bi * a.r_stride[0] + hi * a.r_stride[2];
  const TI* k = static_cast<const TI*>(a.k) + bi * a.k_stride[0] + hi * a.k_stride[2];
  const TI* v = static_cast<const TI*>(a.v) + bi * a.v_stride[0] + hi * a.v_stride[2];
  const float* lw = a.logw + bi * a.w_stride[0] + hi * a.w_stride[2];
  const float* dy = a.dy + bi * a.y_stride[0] + hi * a.y_stride[2];
  TI* dr = static_cast<TI*>(a.dr) + bi * a.dr_stride[0] + hi * a.dr_stride[2];
  TI* dk = static_cast<TI*>(a.dk) + bi * a.dk_stride[0] + hi * a.dk_stride[2];
  TI* dv = static_cast<TI*>(a.dv) + bi * a.dv_stride[0] + hi * a.dv_stride[2];
  float* dlw = a.dlogw + bi * a.dw_stride[0] + hi * a.dw_stride[2];
  const long long rs = a.r_stride[1], ks = a.k_stride[1], vs = a.v_stride[1],
                  ws = a.w_stride[1], ys = a.y_stride[1], drs = a.dr_stride[1],
                  dks = a.dk_stride[1], dvs = a.dv_stride[1], dws = a.dw_stride[1];
  const int seq = a.s, nc = (seq + C - 1) / C;
  float* wsp = a.ws + (size_t)bh * nc * DH * DH;

  // this thread's 4x4 tiles: (dh, dh) state tiles, (C, dh) tiles, (C, C) tiles
  const bool own_s = tid < G::TS_TILES, own_d = tid < G::TD_TILES, own_a = tid < G::TA_TILES;
  const int sd = 4 * (tid / (DH / 4)), se = 4 * (tid % (DH / 4));  // rows d, columns e
  const int dt = 4 * (tid / (DH / 4)), dd = 4 * (tid % (DH / 4));  // rows t, columns d (or e)
  const int at = 4 * (tid / (C / 4)), as = 4 * (tid % (C / 4));    // rows t, columns s

  if (tid < DH) uu[tid] = a.u[(size_t)hi * DH + tid];

  // ---- forward sweep: the state entering every chunk, into the workspace
  float Sr[4][4];
  zero4(Sr);
  for (int ci = 0; ci < nc; ++ci) {
    const long long t0 = (long long)ci * C;
    const int nvalid = min(C, seq - ci * C);
    load_chunk<TI, DH, C>(Tk, k + t0 * ks, ks, nvalid, tid);
    load_chunk<TI, DH, C>(Tv, v + t0 * vs, vs, nvalid, tid);
    load_chunk<float, DH, C>(Tc, lw + t0 * ws, ws, nvalid, tid);
    if (own_s) {
      float* dst = wsp + (size_t)ci * DH * DH;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dst[(sd + i) * DH + se + j] = Sr[i][j];
    }
    __syncthreads();
    if (tid < DH) {  // cum in place, per channel in order
      float acc = 0.f;
      for (int t = 0; t < C; ++t) {
        acc = acc + Tc[t * LT + tid];
        Tc[t * LT + tid] = acc;
      }
      total[tid] = acc;
    }
    __syncthreads();
    for (int i = tid; i < C * DH; i += THREADS) {
      const int t = i / DH, d = i % DH;
      Tk[t * LT + d] = Tk[t * LT + d] * expf(total[d] - Tc[t * LT + d]);  // k_out
    }
    __syncthreads();
    if (own_s && ci + 1 < nc) {
      float kv[4][4];
      zero4(kv);
      mm4(kv, 0, C, [&](int i, int t) { return Tk[t * LT + sd + i]; },
          [&](int t, int j) { return Tv[t * LT + se + j]; });
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = expf(total[sd + i]);
#pragma unroll
        for (int j = 0; j < 4; ++j) Sr[i][j] = e * Sr[i][j] + kv[i][j];
      }
    }
    __syncthreads();
  }

  // ---- reverse sweep
  float dSr[4][4];
  zero4(dSr);
  for (int i = tid; i < G::TS; i += THREADS) TdS[i] = 0.f;
  float du_acc = 0.f;
  for (int ci = nc - 1; ci >= 0; --ci) {
    const long long t0 = (long long)ci * C;
    const int nvalid = min(C, seq - ci * C);
    __syncthreads();  // the previous chunk's scans are done with the tiles
    load_chunk<TI, DH, C>(Tq, r + t0 * rs, rs, nvalid, tid);
    load_chunk<TI, DH, C>(Tk, k + t0 * ks, ks, nvalid, tid);
    load_chunk<TI, DH, C>(Tv, v + t0 * vs, vs, nvalid, tid);
    load_chunk<float, DH, C>(Tko, lw + t0 * ws, ws, nvalid, tid);
    load_chunk<float, DH, C>(Ty, dy + t0 * ys, ys, nvalid, tid);
    {
      const float* src = wsp + (size_t)ci * DH * DH;
      for (int i = tid; i < DH * DH; i += THREADS) TS[(i / DH) * LT + i % DH] = src[i];
    }
    __syncthreads();

    // 1. cum, mid, total (one thread a channel); the diagonal and ddiag
    //    (one thread a row); sum_e S0 dS (one thread a channel)
    if (tid < DH) {
      float acc = 0.f;
      for (int t = 0; t < C; ++t) {
        acc = acc + Tko[t * LT + tid];
        Tc[t * LT + tid] = acc;
        if (t == C / 2) mid[tid] = acc;
      }
      total[tid] = acc;
    } else if (tid < DH + C) {
      const int t = tid - DH;
      float dg = 0.f, ddg = 0.f;
      for (int d = 0; d < DH; ++d) {
        dg = fmaf(Tq[t * LT + d] * uu[d], Tk[t * LT + d], dg);
        ddg = fmaf(Ty[t * LT + d], Tv[t * LT + d], ddg);
      }
      diag[t] = dg;
      ddiag[t] = ddg;
    } else if (tid < 2 * DH + C) {
      const int d = tid - DH - C;
      float acc = 0.f;
      for (int e = 0; e < DH; ++e) acc = fmaf(TS[d * LT + e], TdS[d * LT + e], acc);
      sdS[d] = acc;
    }
    __syncthreads();

    // 2. the decayed factors, the forward's formulas
    for (int i = tid; i < C * DH; i += THREADS) {
      const int t = i / DH, d = i % DH, x = t * LT + d;
      const float rr = Tq[x], kk = Tk[x], cu = Tc[x], cp = cu - Tko[x];
      const float md = mid[d], tt = total[d];
      Tq[x] = rr * expf(cp);
      Tqm[x] = rr * expf(cp - md);
      Tk[x] = kk * expf(md - cu);
      Tko[x] = kk * expf(tt - cu);
    }
    __syncthreads();

    // 3. A and dA over the lower triangle (zero on and above the diagonal)
    if (own_a) {
      float sc[4][4], dsc[4][4];
      zero4(sc);
      zero4(dsc);
      if (as <= at) {
        mm4(sc, 0, DH, [&](int i, int d) { return Tqm[(at + i) * LT + d]; },
            [&](int d, int j) { return Tk[(as + j) * LT + d]; });
        mm4(dsc, 0, DH, [&](int i, int e) { return Ty[(at + i) * LT + e]; },
            [&](int e, int j) { return Tv[(as + j) * LT + e]; });
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool lower = as + j < at + i;
          TA[(at + i) * LA + as + j] = lower ? sc[i][j] : 0.f;
          TdA[(at + i) * LA + as + j] = lower ? dsc[i][j] : 0.f;
        }
    }
    __syncthreads();

    // 4. the (t, d) tile: dq_in, dq_mid, dk_mid, dk_out; dr and dk stored,
    //    W, Y, Z and ddiag r k kept for the scans
    float W[4][4], Y[4][4], Z[4][4], U[4][4];
    if (own_d) {
      float dqi[4][4], dqm[4][4], dkm[4][4], dko[4][4];
      zero4(dqi);
      zero4(dqm);
      zero4(dkm);
      zero4(dko);
      mm4(dqi, 0, DH, [&](int i, int e) { return Ty[(dt + i) * LT + e]; },
          [&](int e, int j) { return TS[(dd + j) * LT + e]; });
      mm4(dqm, 0, min(dt + 3, C), [&](int i, int s) { return TdA[(dt + i) * LA + s]; },
          [&](int s, int j) { return Tk[s * LT + dd + j]; });
      mm4(dkm, dt + 1, C, [&](int i, int t) { return TdA[t * LA + dt + i]; },
          [&](int t, int j) { return Tqm[t * LT + dd + j]; });
      mm4(dko, 0, DH, [&](int i, int e) { return Tv[(dt + i) * LT + e]; },
          [&](int e, int j) { return TdS[(dd + j) * LT + e]; });
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = dt + i;
        const bool ok = t < nvalid;
        const float g = ddiag[t];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int d = dd + j, x = t * LT + d;
          const float rr = ok ? to_f32(r[(t0 + t) * rs + d]) : 0.f;
          const float kk = ok ? to_f32(k[(t0 + t) * ks + d]) : 0.f;
          const float l = ok ? lw[(t0 + t) * ws + d] : 0.f;
          const float cu = Tc[x], cp = cu - l, md = mid[d], tt = total[d];
          const float gu = g * uu[d];
          const float grad_r = (dqi[i][j] * expf(cp) + dqm[i][j] * expf(cp - md)) + gu * kk;
          const float grad_k = (dkm[i][j] * expf(md - cu) + dko[i][j] * expf(tt - cu)) + gu * rr;
          Y[i][j] = dkm[i][j] * Tk[x];
          W[i][j] = (dqi[i][j] * Tq[x] + dqm[i][j] * Tqm[x]) - Y[i][j];
          Z[i][j] = dko[i][j] * Tko[x];
          U[i][j] = g * rr * kk;
          if (ok) {
            put(dr + (t0 + t) * drs + d, grad_r);
            put(dk + (t0 + t) * dks + d, grad_k);
          }
        }
      }

      // 5. dv = k_out dS + A^T dy + diag dy, on the (t, e) tile
      float dvi[4][4], dva[4][4];
      zero4(dvi);
      zero4(dva);
      mm4(dvi, 0, DH, [&](int i, int d) { return Tko[(dt + i) * LT + d]; },
          [&](int d, int j) { return TdS[d * LT + dd + j]; });
      mm4(dva, dt + 1, C, [&](int i, int t) { return TA[t * LA + dt + i]; },
          [&](int t, int j) { return Ty[t * LT + dd + j]; });
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = dt + i;
        if (t < nvalid) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            put(dv + (t0 + t) * dvs + dd + j,
                (dvi[i][j] + dva[i][j]) + diag[t] * Ty[t * LT + dd + j]);
        }
      }
    }

    // 6. dS <- e^{total} dS + q_in^T dy, on the (d, e) tile
    if (own_s) {
      float qy[4][4];
      zero4(qy);
      mm4(qy, 0, C, [&](int i, int t) { return Tq[t * LT + sd + i]; },
          [&](int t, int j) { return Ty[t * LT + se + j]; });
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = expf(total[sd + i]);
#pragma unroll
        for (int j = 0; j < 4; ++j) dSr[i][j] = e * dSr[i][j] + qy[i][j];
      }
    }
    __syncthreads();  // every product is done reading the tiles

    if (own_d) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int x = (dt + i) * LT + dd + j;
          Tq[x] = W[i][j];
          Tqm[x] = Y[i][j];
          Tk[x] = Z[i][j];
          Tko[x] = U[i][j];
        }
    }
    if (own_s) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) TdS[(sd + i) * LT + se + j] = dSr[i][j];
    }
    __syncthreads();

    // 7. dlogw and du, one thread a channel: a reverse scan of W, then a
    //    forward scan of Z
    if (tid < DH) {
      const int d = tid;
      float acc = 0.f;
      for (int s = C - 1; s >= 0; --s) {
        const float o = acc - Tqm[s * LT + d];
        acc = acc + Tq[s * LT + d];
        Tqm[s * LT + d] = o;
      }
      acc = expf(total[d]) * sdS[d];
      for (int s = 0; s < C; ++s) {
        const float g = Tqm[s * LT + d] + acc;
        acc = acc + Tk[s * LT + d];
        if (s < nvalid) {
          dlw[(t0 + s) * dws + d] = g;
          du_acc = du_acc + Tko[s * LT + d];
        }
      }
    }
  }
  if (tid < DH) a.du[(size_t)bh * DH + tid] = du_acc;
}

template <typename TI, int DH, int C>
int run_k(const Rwkv6BwdArgs* a, cudaStream_t stream) {
  using G = Cfg<DH, C>;
  auto kern = rwkv6_chunked_bwd_kernel<TI, DH, C>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::SMEM);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)a->b * a->h;
  if (a->b <= 0 || a->h <= 0 || a->s <= 0 || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, THREADS, G::SMEM, stream>>>(*a);
  return (int)cudaGetLastError();
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

}  // namespace rwkv6_bwd
