// The bf16 SIMT instance of the channel-major 3x3 convolution (the TPU kernel's
// own signature: bf16 x and out, float32 w and sums), the ablation of the bf16
// main path's Hopper instance (cmconv_bf16_sm90.cu): the templates and the notes
// are in cmconv.cu, which this file instantiates for `mlad_cmconv3x3_bf16`.
#define MLAD_CMCONV_BF16
#include "cmconv.cu"
