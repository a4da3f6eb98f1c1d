// Fixture CUDA source: launch entries for the resource rules.  Never
// compiled; the pass reads its `extern "C"` entries by regex.
#include <cuda_runtime.h>

extern "C" int ok_scan(const float* q, int n, void* stream) {  // expect: SPF304
  return 0;
}

// a query is not a launch entry: no row needed
extern "C" int ok_scan_smem_bytes(int dtype, int bs, int d, int k, int* shape) {
  return 0;
}

extern "C" int big_scan(const float* q, int n, void* stream) {  // expect: SPF301 SPF304
  return 0;
}

extern "C" int orphan_launch(const float* q, int n, void* stream) {  // expect: SPF303
  return 0;
}
