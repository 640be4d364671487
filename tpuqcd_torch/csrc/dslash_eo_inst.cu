// One instantiation set of the Dslash kernel (dslash_eo.cuh): a storage
// type, an arithmetic type and a link format, named on the command line:
//
//   nvcc -DTQ_STORAGE=float -DTQ_COMPUTE=float -DTQ_NROW=2 \
//        -DTQ_NAME=tq_dslash_eo_f32_r2 -c dslash_eo_inst.cu
//
// TQ_NROW is 3 (18-real links), 2 (reconstruct-12) or 4 (reconstruct-8).
// ops/dslash_cuda.py compiles the twelve of them side by side and links
// them with dslash_eo.cu, whose entries pick the link format at run time.

#include "dslash_eo.cuh"

extern "C" int TQ_NAME(TQ_PARAMS) {
  return launch<TQ_STORAGE, TQ_COMPUTE, TQ_NROW>(TQ_ARGS);
}
