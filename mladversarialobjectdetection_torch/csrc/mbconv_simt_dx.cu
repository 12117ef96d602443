// The SIMT ablation of the input gradient of the fused MBConv kernels: the templates and the notes are in
// mbconv.cu, which this file instantiates for `mlad_mbconv_dx_simt`.
#define MLAD_MBCONV_PART 3
#include "mbconv.cu"
