// KRN01 clean fixture (CUDA): every launch's error is read before the
// next launch and returned; the extern "C" entry returns it as an int.

#include <cuda_runtime.h>

__global__ void scale(float* x, float a) { x[threadIdx.x] *= a; }

cudaError_t two_launches(float* x, int f32, cudaStream_t s) {
  if (f32) {
    scale<<<1, 32, 0, s>>>(x, 2.f);
    return cudaGetLastError();
  }
  scale<<<1, 32, 0, s>>>(x, 2.f);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scale<<<1, 32, 0, s>>>(x, 3.f);
  return cudaGetLastError();
}

extern "C" {

struct ScaleArgs {
  long long n;
};

// Returns cudaGetLastError() after the launches (0 = launched).
int scale_launch(float* x, const ScaleArgs* a, void* stream) {
  if (a->n != 32) return (int)cudaErrorInvalidValue;
  return (int)two_launches(x, 1, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
