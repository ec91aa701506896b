"""Pure-function compute operators (the JAX equivalents of the reference's
per-pixel C++ loops). Everything here is shape-static, jit-safe, and vmappable.
"""

from super_resolution_tpu.ops.resize import (  # noqa: F401
    additive_resize,
    block_sum_downsample,
    cubic_resize,
    decimate,
    linear_resize,
    nearest_resize,
    resize,
    zero_upsample,
)
from super_resolution_tpu.ops.warp import (  # noqa: F401
    translate,
    translate_adjoint,
    translate_static,
)
from super_resolution_tpu.ops.blur import (  # noqa: F401
    blur,
    blur_adjoint,
    correlate2d,
    gaussian_kernel_1d,
    gaussian_kernel_2d,
)
