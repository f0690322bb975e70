// The gradient of the chunked RWKV6 kernel (rwkv6_scan_bwd.cuh), for fp32
// and for bf16 r/k/v (logw, u, dy and dlogw fp32 in both): the backward of
// the model path's `rwkv6_chunked_fp32` (kernels/ops.py).
#include "rwkv6_scan_bwd.cuh"

extern "C" {

// Launches the three kernels on the stream; cudaGetLastError() after the
// first launch that fails, 0 when all three launched.
int repro_rwkv6_chunked_bwd_f32(Rwkv6BwdArgs a, int dh, int chunk, void* stream) {
  return rwkv6_bwd::run<float>(&a, dh, chunk, (cudaStream_t)stream);
}

int repro_rwkv6_chunked_bwd_bf16(Rwkv6BwdArgs a, int dh, int chunk, void* stream) {
  return rwkv6_bwd::run<__nv_bfloat16>(&a, dh, chunk, (cudaStream_t)stream);
}

// The three kernels' resident blocks an SM and the shared bytes of the
// first and last (rwkv6_bwd::info_k).
int repro_rwkv6_chunked_bwd_info(int bf16, int dh, int chunk, int* out) {
  return bf16 ? rwkv6_bwd::info<__nv_bfloat16>(dh, chunk, out)
              : rwkv6_bwd::info<float>(dh, chunk, out);
}

}  // extern "C"
