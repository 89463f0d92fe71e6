// CHK00 clean fixture (CUDA): a well-formed suppression (rule list +
// reason) silences the finding it covers and raises no hygiene finding.

__global__ void accumulate(float* out, const float* x) {
  // check: disable=DET01 -- fixture: the suppression is what is tested
  atomicAdd(out, x[threadIdx.x]);
}
