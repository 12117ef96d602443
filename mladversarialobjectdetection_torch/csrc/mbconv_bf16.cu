// The bf16 instance of the forward of the fused MBConv kernels: the templates and the notes are in
// mbconv.cu, which this file instantiates for `mlad_mbconv_fwd_bf16`.
#define MLAD_MBCONV_PART 4
#include "mbconv.cu"
