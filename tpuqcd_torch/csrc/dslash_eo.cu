// Entry points of the Dslash kernel library: one per storage and
// arithmetic type, each picking the link format's instantiation set
// (dslash_eo_inst.cu) at run time.  The kernel is in dslash_eo.cuh.

#include <cuda_runtime.h>
#include <stdint.h>

#define TQ_NO_KERNELS
#include "dslash_eo.cuh"

#define TQ_ENTRY(NAME)                                        \
  extern "C" int NAME##_r3(TQ_PARAMS);                        \
  extern "C" int NAME##_r2(TQ_PARAMS);                        \
  extern "C" int NAME##_r4(TQ_PARAMS);                        \
  extern "C" int NAME(TQ_PARAMS) {                            \
    if (nrow == 3) return NAME##_r3(TQ_ARGS);                 \
    if (nrow == 2) return NAME##_r2(TQ_ARGS);                 \
    if (nrow == 4) return NAME##_r4(TQ_ARGS);                 \
    return (int)cudaErrorInvalidValue;                        \
  }

TQ_ENTRY(tq_dslash_eo_f32)    // float storage, float arithmetic
TQ_ENTRY(tq_dslash_eo_bf16)   // __nv_bfloat16 storage, float arithmetic
TQ_ENTRY(tq_dslash_eo_f64)    // double storage and arithmetic
TQ_ENTRY(tq_dslash_eo_bf16c)  // __nv_bfloat16 storage and arithmetic

extern "C" const char* tq_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
