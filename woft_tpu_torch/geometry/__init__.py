from .homography import (  # noqa: F401
    e2p,
    p2e,
    h_proj,
    compose_h,
    normalize_points,
    find_homography_wls_qr,
    find_homography_wls_normal,
    find_homography_irls_qr,
    find_homography_dlt_svd,
    find_homography_cvransac,
    find_homography_trs,
    irls_l1,
    irls_huber,
    proj_errors,
    np_e2p,
    np_p2e,
    np_h_proj,
    np_compose_h,
)
from .bbox import (  # noqa: F401
    Bbox, h_bbox2bbox, project_bbox, decompose_h, h_interpolate)
