// The bf16 instance of the channel-major 3x3 convolution (the TPU kernel's own
// signature: bf16 x and out, float32 w and sums): the templates and the notes
// are in cmconv.cu, which this file instantiates for `mlad_cmconv3x3_bf16`.
#define MLAD_CMCONV_BF16
#include "cmconv.cu"
