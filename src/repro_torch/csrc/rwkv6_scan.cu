// The chunked RWKV6 kernel of rwkv6_scan.cuh, instantiated for fp32 r/k/v,
// logw/u and out: the JAX-parity wrappers' fp32 entry (kernels/ops.py).
#include "rwkv6_scan.cuh"

extern "C" {

// cudaGetLastError() after the launch (0 on success).
int repro_rwkv6_chunked_f32(Rwkv6Args a, int dh, int chunk, void* stream) {
  return run<float, float, float>(&a, dh, chunk, (cudaStream_t)stream);
}

}  // extern "C"
