// The bf16 instance of the input gradient of the fused MBConv kernels: the templates and the notes are in
// mbconv.cu, which this file instantiates for `mlad_mbconv_dx_bf16`.
#define MLAD_MBCONV_PART 5
#include "mbconv.cu"
