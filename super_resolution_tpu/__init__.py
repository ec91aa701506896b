"""super_resolution_tpu — a JAX multiframe super-resolution framework.

A from-scratch JAX/XLA re-design of the capabilities of the
rteammco/super-resolution C++ framework: multiframe MAP super-resolution
with a warp -> PSF-blur -> decimate degradation model, IRLS-reweighted
TV/BTV regularization, matrix-free CG/LBFGS solvers, subpixel registration,
hyperspectral (ENVI + spectral PCA) and wavelet-domain solving — built
for accelerators: channel-major [C, H, W] arrays, pure-function operators with
exact adjoints, `lax.while_loop` solvers under `jit`, and `jax.sharding`
meshes (frame / band / spatial-tile axes) for multi-device scaling.

Reference parity notes cite file:line of the C++ reference throughout.
"""

__version__ = "0.1.0"

from super_resolution_tpu.image.image_data import (  # noqa: F401
    ImageData,
    SpectralMode,
)
from super_resolution_tpu.models.image_model import (  # noqa: F401
    ImageModel,
    ImageModelParameters,
)
from super_resolution_tpu.solvers.irls import (  # noqa: F401
    IRLSMapSolver,
)
from super_resolution_tpu.solvers.map_solver import (  # noqa: F401
    IRLSMapSolverOptions,
    MapSolverOptions,
)
