// DET01 clean fixture (CUDA): per-block partials summed in a fixed order;
// the comments and strings mentioning atomicAdd or red.global are inert.

__global__ void partials(float* part, const float* rows, int n) {
  float acc = 0.f;  // no atomicAdd: each block writes its own slot
  for (int i = threadIdx.x; i < n; i += blockDim.x) acc += rows[i];
  part[blockIdx.x * blockDim.x + threadIdx.x] = acc;
  asm volatile("// red.global.add.f32 is not used" ::);
  const char* note = "atomicAdd";
  (void)note;
}
