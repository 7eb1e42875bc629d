"""The port's array operations (counterpart of `sam_pt_tpu/ops/`), with
the JAX package's exports. The attention kernels' wrappers are in
`flash_attention`, the LayerNorm kernel's in `layer_norm`, their build in
`_cuda`; none is imported here."""
from .sampling import (
    bilinear_sample,
    bilinear_sample_nchw,
    grid_sample_nearest,
    patch_sample,
    separable_neighborhood_sample,
)
from .resize import resize_bilinear, resize_nearest, resize_longest_side
from .color import rgb_to_gray, rgb_to_lab
from .posemb import (
    get_1d_sincos_embedding,
    get_3d_sincos_embedding,
    posemb_sincos_2d_xy,
)
