// The input gradient of the fused MBConv kernels: the templates and the notes are in
// mbconv.cu, which this file instantiates for `mlad_mbconv_dx`.
#define MLAD_MBCONV_PART 1
#include "mbconv.cu"
