// The gradient of the chunked RWKV6 kernel (rwkv6_scan_bwd.cuh), for fp32
// and for bf16 r/k/v (logw, u, dy and dlogw fp32 in both): the backward of
// the model path's `rwkv6_chunked_fp32` (kernels/ops.py).
#include "rwkv6_scan_bwd.cuh"

extern "C" {

// cudaGetLastError() after the launch (0 on success).
int repro_rwkv6_chunked_bwd_f32(Rwkv6BwdArgs a, int dh, int chunk, void* stream) {
  return rwkv6_bwd::run<float>(&a, dh, chunk, (cudaStream_t)stream);
}

int repro_rwkv6_chunked_bwd_bf16(Rwkv6BwdArgs a, int dh, int chunk, void* stream) {
  return rwkv6_bwd::run<__nv_bfloat16>(&a, dh, chunk, (cudaStream_t)stream);
}

}  // extern "C"
