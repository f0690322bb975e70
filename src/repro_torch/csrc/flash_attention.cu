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
// w > 0: j > i - w.  Its arithmetic is the TPU kernel's: q, k and v are
// upcast to fp32 before both products, the scale multiplies the finished
// q.k dot, the running max m, sum l and accumulator are fp32, and the
// masked sentinel is the FINITE -1e30.  With -inf a row that is wholly
// masked inside a partly covered tile would give exp(-inf - -inf) = NaN;
// with -1e30 such a row adds exp(0) = 1 per key, and that garbage is wiped
// exactly by corr = exp(m_prev - m_new) = 0 when its first real score
// arrives, as in the Pallas kernel.  l is floored at 1e-30 in the
// epilogue.  The output is in q's type (fp32 or bf16).
//
// Design.  One block per (q-tile of 64 rows, head, batch); the loop over
// 64-key tiles runs inside the block and carries m, l and the accumulator
// in registers (on the TPU the sequential grid dimension carried them in
// VMEM scratch).  256 threads as 16 x 16: thread (ty, tx) owns rows
// ty + 16i (i < 4) and, for the scores, key columns tx + 16j (j < 4); for
// the accumulator, head-dim columns tx + 16j (j < Dh/16).  The 16 threads
// of a row sit in one half-warp, so row max and row sum are xor-shuffles.
// The q tile (fp32) stays in shared memory for the whole loop; each k/v
// tile and the tile of probabilities pass through shared memory, rows
// padded by one float against bank conflicts.  K-tiles wholly above the
// causal diagonal end the loop, k-tiles wholly outside the window are
// skipped, and partly covered tiles are masked element by element.
//
// Bound: operations.  At the LM serving slice's shape (B=8, H=32, Hkv=4,
// S=1920, Dh=64, causal) one call needs 4*Dh*B*H*S(S+1)/2 = 1.2e11 FLOP
// for about 1.4e8 bytes of q, k, v and out in bf16: some 850 FLOP per
// byte, far above the card's ridge point.  This kernel does the products
// as fp32 FMAs on the CUDA cores, as the TPU kernel's fp32 dots ask, so
// its own ceiling is the 67 TFLOP/s fp32 rate (about 1.8 ms a call), not
// the 989 TFLOP/s of the bf16 tensor cores (0.12 ms).  What the design
// does about it: no S x S matrix ever reaches device memory, 4 x 4
// register micro-tiles reuse each shared-memory operand four times, and
// the causal mask halves the work by ending the k loop at the diagonal.
// mma.sync/wgmma, TMA and pipelining are later work.
//
// Shared memory is (64*(Dh+1)*2 + 64*Dh + 64*65) floats: 29 KB at Dh=16,
// 66 KB at Dh=64, 214 KB at Dh=256, so every head dim launches with its
// dynamic limit raised by cudaFuncSetAttribute.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

// Passed by value from the ctypes wrapper (kernels/ops.py mirrors it).
struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int b, h, hkv, sq, sk;
  int causal;
  int window;   // 0 = none
  float scale;  // 1/sqrt(Dh), rounded to fp32 on the host
};

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // keys per tile
constexpr int TX = 16;
constexpr int TY = 16;
constexpr int THREADS = TX * TY;
constexpr int RPT = BQ / TY;   // rows per thread
constexpr int CPT = BK / TX;   // score columns per thread
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <int DH>
constexpr size_t smem_floats() {
  return (size_t)BQ * (DH + 1) + (size_t)BK * (DH + 1) + (size_t)BK * DH +
         (size_t)BQ * (BK + 1);
}

template <typename T, int DH>
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
  const T* q = static_cast<const T*>(a.q) + (size_t)(bb * a.h + hh) * a.sq * DH;
  const T* k = static_cast<const T*>(a.k) + (size_t)(bb * a.hkv + kvh) * a.sk * DH;
  const T* v = static_cast<const T*>(a.v) + (size_t)(bb * a.hkv + kvh) * a.sk * DH;
  T* o = static_cast<T*>(a.out) + (size_t)(bb * a.h + hh) * a.sq * DH;

  for (int i = tid; i < BQ * DH; i += THREADS) {
    const int r = i / DH, d = i % DH, qp = q_start + r;
    Qs[r * QLD + d] = qp < a.sq ? to_f32(q[(size_t)qp * DH + d]) : 0.f;
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
    for (int i = tid; i < BK * DH; i += THREADS) {
      const int c = i / DH, d = i % DH, kp = k_start + c;
      const bool in = kp < a.sk;
      Ks[c * KLD + d] = in ? to_f32(k[(size_t)kp * DH + d]) : 0.f;
      Vs[c * VLD + d] = in ? to_f32(v[(size_t)kp * DH + d]) : 0.f;
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
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kp = k_start + tx + TX * j;
        bool ok = kp < a.sk;
        if (a.causal) ok = ok && kp <= qp;
        if (a.window > 0) ok = ok && kp > qp - a.window;
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
    const int qp = q_start + ty + TY * i;
    if (qp >= a.sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DPT; ++j)
      store(o + (size_t)qp * DH + tx + TX * j, acc[i][j] / denom);
  }
}

template <typename T, int DH>
int launch_dh(const FlashArgs& a, cudaStream_t stream) {
  const size_t smem = smem_floats<DH>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.sq + BQ - 1) / BQ, a.h, a.b);
  flash_fwd_kernel<T, DH><<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const FlashArgs& a, int dh, cudaStream_t stream) {
  if (a.b <= 0 || a.h <= 0 || a.hkv <= 0 || a.h % a.hkv != 0 || a.sk <= 0 ||
      a.sq < 0 || a.b > 65535 || a.h > 65535)
    return (int)cudaErrorInvalidValue;
  if (a.sq == 0) return 0;
  switch (dh) {
    case 16: return launch_dh<T, 16>(a, stream);
    case 32: return launch_dh<T, 32>(a, stream);
    case 64: return launch_dh<T, 64>(a, stream);
    case 96: return launch_dh<T, 96>(a, stream);
    case 128: return launch_dh<T, 128>(a, stream);
    case 256: return launch_dh<T, 256>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Both return cudaGetLastError() after the launch (0 on success).
int repro_flash_attention_f32(FlashArgs a, int dh, void* stream) {
  return launch<float>(a, dh, (cudaStream_t)stream);
}

int repro_flash_attention_bf16(FlashArgs a, int dh, void* stream) {
  return launch<__nv_bfloat16>(a, dh, (cudaStream_t)stream);
}

}  // extern "C"
