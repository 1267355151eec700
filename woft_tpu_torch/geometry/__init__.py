from .homography import (  # noqa: F401
    e2p,
    p2e,
    h_proj,
    compose_h,
    normalize_points,
    find_homography_wls_qr,
    proj_errors,
    np_e2p,
    np_p2e,
    np_h_proj,
    np_compose_h,
)
from .bbox import Bbox, h_bbox2bbox, project_bbox  # noqa: F401
