// The SIMT ablation of the forward of the fused MBConv kernels: the templates and the notes are in
// mbconv.cu, which this file instantiates for `mlad_mbconv_fwd_simt`.
#define MLAD_MBCONV_PART 2
#include "mbconv.cu"
