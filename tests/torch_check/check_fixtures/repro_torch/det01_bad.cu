// DET01 fixture (CUDA): arrival-order accumulations.

__global__ void combine(float* out, const float* rows, const int* idx) {
  const int i = threadIdx.x;
  atomicAdd(&out[idx[i]], rows[i]);
  float v = rows[i];
  asm volatile("red.global.add.f32 [%0], %1;" :: "l"(out), "f"(v));
}
