// The chunked RWKV6 kernel of rwkv6_scan.cuh, instantiated for bf16 r/k/v
// and fp32 logw/u and out: the model path's entry (kernels/ops.py).
#include "rwkv6_scan.cuh"

extern "C" {

// cudaGetLastError() after the launch (0 on success).
int repro_rwkv6_chunked_bf16_f32(Rwkv6Args a, int dh, int chunk, void* stream) {
  return run<__nv_bfloat16, float, float>(&a, dh, chunk, (cudaStream_t)stream);
}

}  // extern "C"
