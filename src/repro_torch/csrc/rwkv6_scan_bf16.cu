// The chunked RWKV6 kernel of rwkv6_scan.cuh, instantiated for bf16 r/k/v,
// logw/u and out: the JAX-parity wrappers' bf16 entry (kernels/ops.py).
#include "rwkv6_scan.cuh"

extern "C" {

// cudaGetLastError() after the launch (0 on success).
int repro_rwkv6_chunked_bf16(Rwkv6Args a, int dh, int chunk, void* stream) {
  return run<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16>(&a, dh, chunk, (cudaStream_t)stream);
}

}  // extern "C"
