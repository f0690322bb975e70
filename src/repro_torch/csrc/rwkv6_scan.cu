// Chunked RWKV6 (Finch) recurrence for Hopper (sm_90a).
//
// Replaces the TPU kernel `rwkv6_chunked_bhsd` of the JAX package
// (src/repro/kernels/rwkv6_scan.py:75, body `_rwkv6_kernel` :27).  For
// r, k, v, logw (B,H,S,dh), S a multiple of the chunk C, and u (H,dh) it
// computes, per (b, h) and chunk in order, from a zero fp32 state S0:
//
//     cum = inclusive cumsum of logw over the chunk, per channel
//     cum_prev = cum - logw,  total = cum[C-1],  mid = cum[C/2]
//     q_in  = r e^{cum_prev}         q_mid = r e^{cum_prev - mid}
//     k_mid = k e^{mid - cum}        k_out = k e^{total - cum}
//     o  = (q_in S0 + tril_{-1}(q_mid k_mid^T) v) + (sum_d r u k) v
//     S0 <- e^{total}^T * S0 + k_out^T v
//
// and writes o in r's type and, after the last chunk, the fp32 state.
// Its arithmetic is the TPU kernel's: every operand is upcast to fp32 on
// load, cum is the sequential sum from 0 (as torch.cumsum's scan of a
// non-innermost dimension), cum_prev is cum - logw, mid and the
// renormalised factors are formed in that order, the intra-chunk scores
// are masked to the strictly lower triangle, and the inter-chunk and
// intra-chunk products are summed apart before the bonus diagonal is
// added.  Products and sums that belong together are fmaf; nothing else
// is contracted (--fmad=false).
//
// Design.  On the TPU the chunk axis is the sequential last grid axis
// and the (dh, dh) state sits in VMEM scratch.  Here one block owns one
// (b, h) and loops over the chunks itself, so the fp32 state stays in
// shared memory for the whole sequence: B*H blocks (512 at the RWKV6-7B
// serving shape) of 256 threads.  Each chunk's r, k, v and logw tiles are
// loaded into shared memory, upcast on load, and transformed in place:
//   1. the bonus diagonal sum_d r u k per row (one warp per row);
//   2. thread d < dh scans channel d: cum in registers, R <- q_in and
//      W (logw) <- q_mid;
//   3. o_inter = q_in S (registers);
//   4. thread d: R <- k_out, K <- k_mid;
//   5. the C x C scores q_mid k_mid^T, masked, into shared memory;
//   6. o_intra = scores v; o is stored;
//   7. S <- e^{total} * S + k_out^T v.
// The products run as fp32 FMAs on the CUDA cores over 16 x 16 thread
// micro-tiles (thread (ty, tx) owns rows ty + 16i and columns tx + 16j),
// rows padded by one float against bank conflicts.
//
// Bound: operations.  At the serving shape (B, H, S, dh) = (8, 64, 2048,
// 64), C = 64, fp32: 4 products of 2*64^3 FLOP per (b, h, chunk), 3.44e10
// FLOP, take 0.513 ms at the card's fp32 rate (67 TFLOP/s); the 1.35e9
// bytes of r, k, v, logw, o and the final state take 0.403 ms at 3.35
// TB/s (the same products on the bf16 tensor cores would take 0.035 ms).
// What the design does about it: every input is read once and o written
// once, nothing per chunk reaches device memory, the state never leaves
// shared memory, and 4 x 4 register micro-tiles reuse each shared-memory
// operand four times.  mma.sync/wgmma and TMA-fed pipelining are later
// work.
//
// Shared memory is (4 C (dh+1) + dh (dh+1) + C (C+1) + C + 2 dh) floats:
// 100,608 B at C = dh = 64 (with ptxas's 128 registers a thread, two
// blocks an SM), 216,064 B at C = 64, dh = 128 (one block), so every
// instantiation raises its dynamic limit with cudaFuncSetAttribute.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

// Passed by value from the ctypes wrapper (kernels/ops.py mirrors it).
struct Rwkv6Args {
  const void* r;
  const void* k;
  const void* v;
  const void* logw;
  const void* u;
  void* out;     // (B,H,S,dh) in r's type
  float* state;  // (B,H,dh,dh) fp32 final state
  int b, h, s;
};

namespace {

constexpr int TX = 16;
constexpr int TY = 16;
constexpr int THREADS = TX * TY;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <int DH, int C>
constexpr size_t smem_floats() {
  return 4 * (size_t)C * (DH + 1) + (size_t)DH * (DH + 1) + (size_t)C * (C + 1) +
         C + 2 * (size_t)DH;
}

template <typename T, int DH, int C>
__global__ void __launch_bounds__(THREADS) rwkv6_chunked_kernel(const Rwkv6Args a) {
  constexpr int LD = DH + 1, ALD = C + 1;
  constexpr int RT = C / TY;   // chunk rows per thread
  constexpr int CT = DH / TX;  // head-dim columns per thread
  constexpr int AT = C / TX;   // score columns per thread
  constexpr int ST = DH / TY;  // state rows per thread
  extern __shared__ float smem[];
  float* R = smem;             // r, then q_in, then k_out
  float* K = R + C * LD;       // k, then k_mid
  float* V = K + C * LD;       // v
  float* W = V + C * LD;       // logw, then q_mid
  float* S = W + C * LD;       // the state (dk rows, dv columns)
  float* A = S + DH * LD;      // masked scores
  float* diag = A + C * ALD;   // sum_d r u k per row
  float* etot = diag + C;      // e^{total} per channel
  float* us = etot + DH;       // u of this head

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.x;
  const size_t base = (size_t)bh * a.s * DH;
  const T* r = static_cast<const T*>(a.r) + base;
  const T* k = static_cast<const T*>(a.k) + base;
  const T* v = static_cast<const T*>(a.v) + base;
  const T* lw = static_cast<const T*>(a.logw) + base;
  T* o = static_cast<T*>(a.out) + base;

  for (int i = tid; i < DH * LD; i += THREADS) S[i] = 0.f;
  for (int d = tid; d < DH; d += THREADS)
    us[d] = to_f32(static_cast<const T*>(a.u)[(size_t)(bh % a.h) * DH + d]);

  const int nc = a.s / C;
  for (int ci = 0; ci < nc; ++ci) {
    const size_t off = (size_t)ci * C * DH;
    __syncthreads();  // the previous chunk no longer reads any tile
    for (int i = tid; i < C * DH; i += THREADS) {
      const int t = i / DH, d = i % DH;
      R[t * LD + d] = to_f32(r[off + i]);
      K[t * LD + d] = to_f32(k[off + i]);
      V[t * LD + d] = to_f32(v[off + i]);
      W[t * LD + d] = to_f32(lw[off + i]);
    }
    __syncthreads();

    // 1. the bonus diagonal, from the raw r and k
    for (int t = warp; t < C; t += WARPS) {
      float acc = 0.f;
      for (int d = lane; d < DH; d += 32)
        acc = fmaf(R[t * LD + d] * us[d], K[t * LD + d], acc);
#pragma unroll
      for (int sh = 16; sh > 0; sh >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, sh);
      if (lane == 0) diag[t] = acc;
    }
    __syncthreads();

    // 2. per-channel cumsum (kept in registers until step 4); q_in, q_mid
    float cum[C];
    float mid = 0.f;
    if (tid < DH) {
      const int d = tid;
      float acc = 0.f;
#pragma unroll
      for (int t = 0; t < C; ++t) {
        const float l = W[t * LD + d];
        acc = acc + l;
        cum[t] = acc;
        W[t * LD + d] = acc - l;  // cum_prev
      }
      mid = cum[C / 2];
      etot[d] = expf(cum[C - 1]);
#pragma unroll
      for (int t = 0; t < C; ++t) {
        const float rr = R[t * LD + d], cp = W[t * LD + d];
        R[t * LD + d] = rr * expf(cp);
        W[t * LD + d] = rr * expf(cp - mid);
      }
    }
    __syncthreads();

    // 3. o_inter = q_in S
    float inter[RT][CT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < CT; ++j) inter[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float qv[RT], sv[CT];
#pragma unroll
      for (int i = 0; i < RT; ++i) qv[i] = R[(ty + TY * i) * LD + d];
#pragma unroll
      for (int j = 0; j < CT; ++j) sv[j] = S[d * LD + tx + TX * j];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j) inter[i][j] = fmaf(qv[i], sv[j], inter[i][j]);
    }
    __syncthreads();  // q_in and S are no longer read

    // 4. k_out (into R) and k_mid (in place)
    if (tid < DH) {
      const int d = tid;
#pragma unroll
      for (int t = 0; t < C; ++t) {
        const float kk = K[t * LD + d];
        R[t * LD + d] = kk * expf(cum[C - 1] - cum[t]);
        K[t * LD + d] = kk * expf(mid - cum[t]);
      }
    }
    __syncthreads();

    // 5. scores q_mid k_mid^T, strictly lower triangular
    {
      float sc[RT][AT];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < AT; ++j) sc[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < DH; ++d) {
        float qv[RT], kv[AT];
#pragma unroll
        for (int i = 0; i < RT; ++i) qv[i] = W[(ty + TY * i) * LD + d];
#pragma unroll
        for (int j = 0; j < AT; ++j) kv[j] = K[(tx + TX * j) * LD + d];
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int j = 0; j < AT; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < AT; ++j) {
          const int t = ty + TY * i, s = tx + TX * j;
          A[t * ALD + s] = s < t ? sc[i][j] : 0.f;
        }
    }
    __syncthreads();

    // 6. o_intra = scores v; o = (o_inter + o_intra) + diag v
    {
      float intra[RT][CT];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j) intra[i][j] = 0.f;
#pragma unroll 4
      for (int s = 0; s < C; ++s) {
        float av[RT], vv[CT];
#pragma unroll
        for (int i = 0; i < RT; ++i) av[i] = A[(ty + TY * i) * ALD + s];
#pragma unroll
        for (int j = 0; j < CT; ++j) vv[j] = V[s * LD + tx + TX * j];
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int j = 0; j < CT; ++j) intra[i][j] = fmaf(av[i], vv[j], intra[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int t = ty + TY * i;
#pragma unroll
        for (int j = 0; j < CT; ++j) {
          const int c = tx + TX * j;
          store(o + off + (size_t)t * DH + c,
                (inter[i][j] + intra[i][j]) + diag[t] * V[t * LD + c]);
        }
      }
    }

    // 7. S <- e^{total} * S + k_out^T v (each thread its own entries)
    {
      float kv_[ST][CT];
#pragma unroll
      for (int i = 0; i < ST; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j) kv_[i][j] = 0.f;
#pragma unroll 4
      for (int t = 0; t < C; ++t) {
        float kk[ST], vv[CT];
#pragma unroll
        for (int i = 0; i < ST; ++i) kk[i] = R[t * LD + ty + TY * i];
#pragma unroll
        for (int j = 0; j < CT; ++j) vv[j] = V[t * LD + tx + TX * j];
#pragma unroll
        for (int i = 0; i < ST; ++i)
#pragma unroll
          for (int j = 0; j < CT; ++j) kv_[i][j] = fmaf(kk[i], vv[j], kv_[i][j]);
      }
#pragma unroll
      for (int i = 0; i < ST; ++i) {
        const int d = ty + TY * i;
#pragma unroll
        for (int j = 0; j < CT; ++j) {
          float* sp = S + d * LD + tx + TX * j;
          *sp = etot[d] * *sp + kv_[i][j];
        }
      }
    }
  }
  __syncthreads();
  float* st = a.state + (size_t)bh * DH * DH;
  for (int i = tid; i < DH * DH; i += THREADS) st[i] = S[(i / DH) * LD + i % DH];
}

template <typename T, int DH, int C>
int launch_k(const Rwkv6Args& a, cudaStream_t stream) {
  const size_t smem = smem_floats<DH, C>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      rwkv6_chunked_kernel<T, DH, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  rwkv6_chunked_kernel<T, DH, C><<<a.b * a.h, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int launch_dh(const Rwkv6Args& a, int chunk, cudaStream_t stream) {
  switch (chunk) {
    case 16: return launch_k<T, DH, 16>(a, stream);
    case 32: return launch_k<T, DH, 32>(a, stream);
    case 64: return launch_k<T, DH, 64>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch(const Rwkv6Args& a, int dh, int chunk, cudaStream_t stream) {
  if (a.b <= 0 || a.h <= 0 || a.s <= 0 || chunk <= 0 || a.s % chunk != 0 ||
      (long long)a.b * a.h > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  switch (dh) {
    case 16: return launch_dh<T, 16>(a, chunk, stream);
    case 32: return launch_dh<T, 32>(a, chunk, stream);
    case 64: return launch_dh<T, 64>(a, chunk, stream);
    case 128: return launch_dh<T, 128>(a, chunk, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Both return cudaGetLastError() after the launch (0 on success).
int repro_rwkv6_chunked_f32(Rwkv6Args a, int dh, int chunk, void* stream) {
  return launch<float>(a, dh, chunk, (cudaStream_t)stream);
}

int repro_rwkv6_chunked_bf16(Rwkv6Args a, int dh, int chunk, void* stream) {
  return launch<__nv_bfloat16>(a, dh, chunk, (cudaStream_t)stream);
}

}  // extern "C"
