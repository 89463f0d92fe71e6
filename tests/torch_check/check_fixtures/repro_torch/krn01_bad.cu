// KRN01 fixture (CUDA): launches whose errors go unread, a discarded
// cudaGetLastError(), and an extern "C" entry that returns no error code.

#include <cuda_runtime.h>

__global__ void scale(float* x, float a) { x[threadIdx.x] *= a; }

cudaError_t two_launches(float* x, cudaStream_t s) {
  scale<<<1, 32, 0, s>>>(x, 2.f);
  scale<<<1, 32, 0, s>>>(x, 3.f);
  return cudaGetLastError();
}

cudaError_t returns_early(float* x, int n, cudaStream_t s) {
  scale<<<1, 32, 0, s>>>(x, 2.f);
  if (n == 0) return cudaSuccess;
  return cudaGetLastError();
}

cudaError_t discards(float* x, cudaStream_t s) {
  scale<<<1, 32, 0, s>>>(x, 2.f);
  cudaGetLastError();
  return cudaSuccess;
}

extern "C" {

void scale_launch(float* x, void* stream) {
  scale<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(x, 2.f);
}

}  // extern "C"
