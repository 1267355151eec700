from .warp import (  # noqa: F401
    grid_sample,
    perspective_coords,
    warp_perspective,
    warp_perspective_fast,
    warp_validity_at,
    upsample2d_align_corners,
    upflow8,
    avg_pool2d,
    coords_grid,
)
from .pad import NoPadder, make_padder  # noqa: F401
from .sampling import (  # noqa: F401
    sobol_1d,
    featuremap_coords,
    masked_sobol_gather,
)
from .interpolation import (  # noqa: F401
    interp_flow,
    flow_warp_coords,
    chain_flow,
    bilinear_interpolate,
    forward_interpolate,
)
from .kernels import (  # noqa: F401  (the six CUDA launch wrappers)
    warp_perspective_bilinear,
    corr_pyramid_lookup,
    local_corr_build,
    local_lookup_fine_multi,
    local_lookup_exact,
    local_lookup_fine,
)
