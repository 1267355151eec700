"""Visualization helpers (host side, cv2/numpy).

The port's own copy of ``woft_tpu/utils/vis.py``: the reference surfaces
the demo and the tracker's debug overlays use
(ref:pytracking/utils/vis_utils.py): mask contour blending, colormaps,
magenta/green alignment blends, flow-arrow rendering, Middlebury flow
colouring, and simple grid tiling. Images are numpy BGR uint8; ``cv2`` is
loaded inside the functions that draw (``geometry/homography.py:_cv2``).
"""

import numpy as np

from ..geometry.homography import _cv2
from .random_utils import tmp_np_seed


def blend_mask(img, mask, color=(0, 255, 0), alpha=0.5, fill=True,
               contour_thickness=None):
    """Blend a binary mask into an image; optionally only its contour
    (ref:vis_utils.py:593-621)."""
    cv2 = _cv2("blend_mask")
    out = img.copy()
    binary = np.uint8(mask > 0)
    if fill:
        overlay = out.copy()
        overlay[binary > 0] = color
        out = cv2.addWeighted(overlay, alpha, out, 1 - alpha, 0)
    if contour_thickness is not None:
        contours, _ = cv2.findContours(binary, cv2.RETR_EXTERNAL,
                                       cv2.CHAIN_APPROX_NONE)
        cv2.drawContours(out, contours, -1, color, contour_thickness)
    return out


def cv2_colormap(values, vmin=None, vmax=None, colormap=None):
    """Map scalars to BGR colors (ref:vis_utils.py:177-197)."""
    cv2 = _cv2("cv2_colormap")
    colormap = cv2.COLORMAP_VIRIDIS if colormap is None else colormap
    v = np.asarray(values, np.float32)
    vmin = np.nanmin(v) if vmin is None else vmin
    vmax = np.nanmax(v) if vmax is None else vmax
    scaled = np.clip((v - vmin) / max(vmax - vmin, 1e-12), 0, 1)
    return cv2.applyColorMap(np.uint8(255 * scaled), colormap)


def vis_alignment_plain(img_a, img_b):
    """Magenta/green alignment blend (ref:vis_utils.py:214-234)."""
    cv2 = _cv2("vis_alignment_plain")
    a = cv2.cvtColor(img_a, cv2.COLOR_BGR2GRAY)
    b = cv2.cvtColor(img_b, cv2.COLOR_BGR2GRAY)
    return np.dstack([b, a, b])     # BGR: a -> green, b -> magenta


def draw_text(img, text, pos="tl", size=1.0, thickness=2,
              color=(255, 255, 255)):
    cv2 = _cv2("draw_text")
    h = img.shape[0]
    xy = {"tl": (10, 30), "bl": (10, h - 10)}[pos]
    cv2.putText(img, text, xy, cv2.FONT_HERSHEY_SIMPLEX, size, (0, 0, 0),
                thickness + 2)
    cv2.putText(img, text, xy, cv2.FONT_HERSHEY_SIMPLEX, size, color,
                thickness)
    return img


def vis_flow_arrows(flow, canvas, grid_sz=20, color=(0, 255, 0),
                    weights=None):
    """Sparse flow arrows on a canvas, optionally weight-coloured
    (ref:vis_utils.py:702-928, simplified)."""
    cv2 = _cv2("vis_flow_arrows")
    H, W = flow.shape[:2]
    out = canvas.copy()
    for y in range(grid_sz // 2, H, grid_sz):
        for x in range(grid_sz // 2, W, grid_sz):
            dx, dy = flow[y, x]
            if weights is not None:
                w = float(np.clip(weights[y, x], 0, 1))
                c = (int(255 * (1 - w)), int(255 * w), 0)
            else:
                c = color
            cv2.arrowedLine(out, (x, y), (int(x + dx), int(y + dy)), c, 1,
                            tipLength=0.3)
    return out


def baker_colorwheel():
    """The 55-entry Middlebury/Baker optical-flow colour wheel.

    Same table as Scharstein's original evaluation code
    (ref:raft_core/utils/flow_viz.py:20-68; Baker et al., ICCV 2007),
    built here from the six hue segments as (start RGB, ramp channel, sign):
    within each segment one channel ramps linearly by floor(255*i/len)."""
    # (length, base RGB, ramping channel, direction)
    segments = [(15, (255, 0, 0), 1, +1),     # R -> Y
                (6, (255, 255, 0), 0, -1),    # Y -> G
                (4, (0, 255, 0), 2, +1),      # G -> C
                (11, (0, 255, 255), 1, -1),   # C -> B
                (13, (0, 0, 255), 0, +1),     # B -> M
                (6, (255, 0, 255), 2, -1)]    # M -> R
    rows = []
    for length, base, ch, sign in segments:
        seg = np.tile(np.asarray(base, np.float64), (length, 1))
        ramp = np.floor(255.0 * np.arange(length) / length)
        seg[:, ch] = base[ch] + sign * ramp
        rows.append(seg)
    return np.concatenate(rows)                           # (55, 3)


def flow_to_image(flow, clip_flow=None, convert_to_bgr=False):
    """Baker flow colouring, exact twin of the reference
    (ref:raft_core/utils/flow_viz.py:71-131): angle interpolates the
    55-colour wheel, radius (normalised to the frame max) desaturates
    toward white, out-of-range radii darken to 75%."""
    u = flow[..., 0].astype(np.float64)
    v = flow[..., 1].astype(np.float64)
    if clip_flow is not None:
        u = np.clip(u, 0, clip_flow)
        v = np.clip(v, 0, clip_flow)
    rad = np.sqrt(u ** 2 + v ** 2)
    rad = rad / (np.max(rad) + 1e-5)

    wheel = baker_colorwheel() / 255.0                    # (55, 3)
    ncols = wheel.shape[0]
    fk = (np.arctan2(-v, -u) / np.pi + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(np.int32)
    f = (fk - k0)[..., None]
    col = (1 - f) * wheel[k0] + f * wheel[(k0 + 1) % ncols]
    col = np.where(rad[..., None] <= 1,
                   1 - rad[..., None] * (1 - col), 0.75 * col)
    img = np.floor(255 * col).astype(np.uint8)
    return img[..., ::-1] if convert_to_bgr else img


def vis_flow_align(flow, img_a, img_b, grid_sz=20, arrow_color=None,
                   pt_radius=2, show_flow=True, weights=None):
    """Side-by-side correspondence visualisation: img_a | img_b with each
    grid point linked to its flow target, per-point coloured
    (ref:vis_utils.py:831-928 — the tracker's debug renderer).

    Args:
        flow: (H, W, 2) flow img_a -> img_b.
        arrow_color: optional (H*W, 3|4) per-pixel BGR(A) colors; alpha 0
            (4th channel) skips a point — the reference masks TCs this way.
        weights: optional (H, W) reliabilities -> red-to-green coloring
            when ``arrow_color`` is not given.
    """
    cv2 = _cv2("vis_flow_align")
    H, W = flow.shape[:2]
    canvas = np.hstack([img_a, img_b]).astype(np.uint8).copy()
    for y in range(grid_sz // 2, H, grid_sz):
        for x in range(grid_sz // 2, W, grid_sz):
            if arrow_color is not None:
                c = arrow_color[y * W + x]
                if len(c) > 3 and c[3] == 0:
                    continue
                color = tuple(int(v) for v in c[:3])
            elif weights is not None:
                w = float(np.clip(weights[y, x], 0, 1))
                color = (int(255 * (1 - w)), int(255 * w), 0)
            else:
                color = (0, 255, 0)
            dx, dy = flow[y, x]
            tx, ty = int(round(x + dx)) + W, int(round(y + dy))
            cv2.circle(canvas, (x, y), pt_radius, color, -1)
            if 0 <= ty < H and W <= tx < 2 * W:
                cv2.circle(canvas, (tx, ty), pt_radius, color, -1)
                if show_flow:
                    cv2.line(canvas, (x, y), (tx, ty), color, 1)
    return canvas


def name_fig(images, names):
    """Stamp a name onto each image (ref:vis_utils.py:434-504)."""
    out = []
    for im, name in zip(images, names):
        im = im.copy()
        if im.ndim == 2:
            im = np.dstack([im] * 3)
        out.append(draw_text(im, name))
    return out


def tile(image):
    """Identity hook kept for reference-API shape (the reference's tile
    resizes grid cells; griddify already emits one canvas)."""
    return image


def checkerboard(h, w, sq=8):
    """(ref:vis_utils.py:931-941)."""
    ys, xs = np.mgrid[0:h, 0:w]
    return np.uint8(255 * (((ys // sq) + (xs // sq)) % 2))


def griddify(images, cols):
    """Tile images into a grid (ref:vis_utils.py:434-504, simplified)."""
    import math
    rows = math.ceil(len(images) / cols)
    h = max(im.shape[0] for im in images)
    w = max(im.shape[1] for im in images)
    canvas = np.zeros((rows * h, cols * w, 3), np.uint8)
    for i, im in enumerate(images):
        r, c = divmod(i, cols)
        canvas[r * h:r * h + im.shape[0], c * w:c * w + im.shape[1]] = im
    return canvas


def hatch_pattern(shape, normal=(2, 1), spacing=10):
    """Parallel-line hatch raster (ref:vis_utils.py:29-65, re-derived):
    a pixel lies on a line when its signed distance to the line family
    (unit ``normal``, period ``spacing``) rounds to a multiple of spacing.
    Vectorized modulo test instead of the reference's per-line cv2.line."""
    H, W = shape[:2]
    n = np.asarray(normal, np.float64)
    n = n / np.linalg.norm(n)
    ys, xs = np.mgrid[:H, :W]
    d = xs * n[0] + ys * n[1]
    frac = d % spacing
    on_line = np.minimum(frac, spacing - frac) <= 0.5
    return np.where(on_line, np.uint8(255), np.uint8(0))


def cv2_hatch(canvas, mask, color=(0, 0, 0), alpha=1.0, **kwargs):
    """Hatch overlay where ``mask`` is True (ref:vis_utils.py:17-26)."""
    hm = (np.asarray(mask, bool) & (hatch_pattern(canvas.shape, **kwargs) > 0))
    overlay = hm[..., None] * np.asarray(color, np.uint8)[None, None]
    a = (hm * alpha)[..., None]
    return (a * overlay + (1 - a) * canvas).astype(np.uint8)


def cv2_colorbar(img, vmin, vmax, colormap=None):
    """Append a labelled colorbar strip under ``img``
    (ref:vis_utils.py:129-169; cv2 colormaps instead of matplotlib)."""
    cv2 = _cv2("cv2_colorbar")
    if img.shape[1] < 300:
        s = int(np.ceil(300 / img.shape[1]))
        img = cv2.resize(img, None, fx=s, fy=s,
                         interpolation=cv2.INTER_NEAREST)
    ramp = np.tile(np.linspace(0, 255, img.shape[1], dtype=np.uint8),
                   (20, 1))
    bar = cv2.applyColorMap(ramp, colormap if colormap is not None
                            else cv2.COLORMAP_VIRIDIS)
    sep = np.zeros((1, img.shape[1], 3), img.dtype)
    vis = np.vstack([img, sep, bar]).copy()
    font = cv2.FONT_HERSHEY_SIMPLEX
    for text, left in ((f"{vmin:.2f}", True), (f"{vmax:.2f}", False)):
        (tw, _), base = cv2.getTextSize(text, font, 0.5, 1)
        x = 5 if left else img.shape[1] - 5 - tw
        cv2.putText(vis, text, (x, img.shape[0] - 5 - base - 1), font, 0.5,
                    (255, 255, 255), 1, cv2.LINE_AA)
    return vis


def vis_alignment(init_img, current_img, h_cur2init, init_xywh, margin=0.0,
                  show_frames=True):
    """Template-crop alignment comparison (ref:vis_utils.py:237-276):
    warp the current frame into template coordinates, crop both around the
    (margin-grown) init box, blend magenta/green, outline the box."""
    cv2 = _cv2("vis_alignment")
    x, y, w, h = (int(round(v)) for v in init_xywh)
    mx, my = int(margin * w), int(margin * h)
    x0, y0 = x - mx, y - my
    x1, y1 = x + w + mx, y + h + my

    warped = cv2.warpPerspective(current_img, h_cur2init,
                                 (init_img.shape[1], init_img.shape[0]))

    def crop(im):
        pad_t, pad_l = max(0, -y0), max(0, -x0)
        c = im[max(0, y0):y1, max(0, x0):x1]
        return cv2.copyMakeBorder(c, pad_t, max(0, y1 - im.shape[0]),
                                  pad_l, max(0, x1 - im.shape[1]),
                                  cv2.BORDER_CONSTANT)

    template = crop(init_img)
    current = crop(warped)
    blend = vis_alignment_plain(current, template)
    box = (mx, my, w, h)
    for im in (template, current, blend):
        cv2.rectangle(im, (box[0], box[1]),
                      (box[0] + box[2], box[1] + box[3]), (0, 0, 255), 1)
    if show_frames:
        return np.concatenate([template, current, blend], axis=1)
    return blend


def make_knn_interp(db_xy, db_values):
    """K-NN interpolator factory (ref:vis_utils.py:543-590): scipy cKDTree
    lookup, the reference's (-d)/sum(-d) weighting, NaN for empty/short
    neighbourhoods."""
    from scipy.spatial import cKDTree
    tree = cKDTree(np.asarray(db_xy))
    n = len(db_xy)
    vals_db = np.asarray(db_values, np.float64)

    def interp(query_xy, K, max_dist=None, min_K=None):
        bound = np.inf if max_dist is None else max_dist
        dists, ids = tree.query(np.asarray(query_xy), k=K,
                                distance_upper_bound=bound)
        dists = np.atleast_2d(dists)
        ids = np.atleast_2d(ids)
        ok = ids < n
        d = np.where(ok, dists, np.nan)
        w = (-d) / np.nansum(-d, axis=-1, keepdims=True)
        v = np.where(ok, vals_db[np.minimum(ids, n - 1)], np.nan) * w
        out = np.nansum(v, axis=-1)
        bad = ~ok.any(axis=-1)
        if min_K is not None:
            bad |= ok.sum(axis=-1) < min_K
        out[bad] = np.nan
        return out

    return interp


class OverlayBackground:
    """Capture backgrounds, then alpha-mix drawn-over copies back onto them
    (ref:vis_utils.py:944-962)."""

    def __init__(self, *backgrounds):
        self._bg = [im.copy() for im in backgrounds]

    def overlay(self, *drawn, alpha=0.5):
        cv2 = _cv2("OverlayBackground.overlay")
        return [cv2.addWeighted(d, alpha, b, 1 - alpha, 0)
                for d, b in zip(drawn, self._bg)]


def line(img, pt1, pt2, color, thickness=1, line_type=None, shift=4):
    """cv2.line accepting float endpoints via fixed-point shift
    (ref:vis_utils.py:395-432 subpixel prims)."""
    cv2 = _cv2("line")
    m = 2 ** shift
    p1 = tuple(int(round(m * v)) for v in pt1)
    p2 = tuple(int(round(m * v)) for v in pt2)
    return cv2.line(img, p1, p2, color, thickness,
                    line_type or cv2.LINE_AA, shift)


def circle(img, center, radius, color, thickness=1, shift=4):
    """cv2.circle with float center/radius (ref:vis_utils.py:411-420)."""
    cv2 = _cv2("circle")
    m = 2 ** shift
    c = tuple(int(round(m * v)) for v in center)
    return cv2.circle(img, c, int(round(m * radius)), color, thickness,
                      cv2.LINE_AA, shift)


def polylines(img, pts, is_closed, color, thickness=1, shift=4):
    """cv2.polylines with float points (ref:vis_utils.py:423-430)."""
    cv2 = _cv2("polylines")
    p = np.round((2 ** shift) * np.asarray(pts)).astype(np.int32)
    return cv2.polylines(img, [p], is_closed, color, thickness,
                         cv2.LINE_AA, shift=shift)


def draw_corners(canvas, corners, color, thickness=2, with_cross=True,
                 with_tl=False):
    """Draw a 4-corner polygon with optional diagonals and TL dot
    (ref:vis_utils.py:372-392). corners: (2, 4) float (x, y) columns."""
    cv2 = _cv2("draw_corners")
    if corners is None:
        return canvas
    corners = np.asarray(corners, np.float64)
    assert corners.shape == (2, 4), corners.shape
    vis = canvas.copy()
    quad = corners.T                                      # (4, 2)
    vis = polylines(vis, quad, True, color, thickness)
    if with_cross:
        vis = line(vis, quad[0], quad[2], color, thickness)
        vis = line(vis, quad[1], quad[3], color, thickness)
    if with_tl:
        cv2.circle(vis, tuple(np.round(quad[0]).astype(int).tolist()),
                   radius=2 * thickness, color=color, thickness=-1)
    return vis


def vis_vector_in_center(img, vector, color=(0, 255, 0), thickness=2,
                         shift=4):
    """Draw a vector anchored at the image center
    (ref:vis_utils.py:394-400)."""
    canvas = img.copy()
    cx, cy = canvas.shape[1] / 2.0, canvas.shape[0] / 2.0
    line(canvas, (cx, cy), (cx + vector[0], cy + vector[1]), color,
         thickness, shift=shift)
    return canvas


def vis_flow(flow, src_img, dst_img, grid_sz=10, occl=None, occl_thr=255,
             arrow_color=(0, 0, 255), point_color=(0, 255, 255),
             point_radius=0, occlusion_color=None, vis_alpha=1.0,
             decimal_places=2):
    """Dual-view flow renderer: arrows + endpoints drawn subpixel into
    BOTH the source and destination images (ref:vis_utils.py:702-828).

    flow: (H, W, 2|3); occl: optional (H, W) uint8 soft occlusion, points
    at/above ``occl_thr`` are occluded (skipped, or tinted
    ``occlusion_color`` when given). ``arrow_color='rand'`` gives each
    grid point a deterministic random colour (seed 42, like upstream).
    Returns (src_vis, dst_vis)."""
    cv2 = _cv2("vis_flow")

    H, W = flow.shape[:2]
    shift = int(np.ceil(np.log2(10 ** decimal_places)))
    mul = 2 ** shift

    ys, xs = np.mgrid[0:H:grid_sz, 0:W:grid_sz]
    xs = xs.ravel()
    ys = ys.ravel()
    starts = np.stack([xs, ys], axis=1).astype(np.float64)
    ends = starts + flow[ys, xs, :2]

    occluded = (np.zeros(len(xs), bool) if occl is None
                else occl[ys, xs] >= occl_thr)
    if arrow_color == "rand":
        with tmp_np_seed(42):
            palette = np.random.randint(0, 255, size=(H * W, 3))
        colors = [tuple(int(v) for v in palette[i])
                  for i in ys * W + xs]
    else:
        colors = [arrow_color] * len(xs)

    src_vis = src_img.copy()
    dst_vis = dst_img.copy()
    bg = OverlayBackground(src_img.copy(), dst_img.copy())
    a_i = np.round(starts * mul).astype(np.int32)
    b_i = np.round(ends * mul).astype(np.int32)
    for i in range(len(xs)):
        if occluded[i] and occlusion_color is None:
            continue
        for canvas in (src_vis, dst_vis):
            cv2.line(canvas, tuple(a_i[i]), tuple(b_i[i]), colors[i],
                     lineType=cv2.LINE_AA, shift=shift)
    pr = point_radius * mul
    for i in range(len(xs)):
        if occluded[i] and occlusion_color is None:
            continue
        cv2.circle(src_vis, tuple(a_i[i]), radius=pr, color=point_color,
                   lineType=cv2.LINE_AA, shift=shift)
        cv2.circle(dst_vis, tuple(b_i[i]), radius=pr,
                   color=occlusion_color if occluded[i] else point_color,
                   lineType=cv2.LINE_AA, shift=shift)
    return bg.overlay(src_vis, dst_vis, alpha=vis_alpha)


def plt_to_img(fig, close=True):
    """Render a matplotlib figure to a BGR numpy image
    (ref:vis_utils.py:668-684)."""
    import matplotlib.pyplot as plt
    fig.tight_layout(pad=0)
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())[..., :3]
    if close:
        plt.close(fig)
    return buf[:, :, ::-1].copy()


def cv_plt_show(fig=None, close=True, window="cv: img"):
    """Show a matplotlib figure through cv2 ('q' quits)
    (ref:vis_utils.py:687-696). Headless-safe: without a display the
    rendered image is returned instead of shown."""
    import os
    cv2 = _cv2("cv_plt_show")
    import matplotlib.pyplot as plt
    if fig is None:
        fig = plt.gcf()
    img = plt_to_img(fig, close)
    if not os.environ.get("DISPLAY"):
        return img
    cv2.imshow(window, img)
    while cv2.waitKey(0) != ord("q"):
        pass
    return img


def compatible_contours(thresh, retrieval_mode=None):
    """cv2.findContours across OpenCV 2/3/4 return conventions
    (ref:vis_utils.py:624-665)."""
    cv2 = _cv2("compatible_contours")
    if retrieval_mode is None:
        retrieval_mode = cv2.RETR_EXTERNAL
    out = cv2.findContours(thresh, retrieval_mode, cv2.CHAIN_APPROX_SIMPLE)
    # cv2/cv4 return (contours, hierarchy); cv3 (img, contours, hierarchy)
    return out[1] if len(out) == 3 else out[0]


def to_gray_3ch(img):
    """Grayscale rendered back to 3 channels (ref:vis_utils.py:209)."""
    cv2 = _cv2("to_gray_3ch")
    g = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    return cv2.cvtColor(g, cv2.COLOR_GRAY2BGR)


class FlowGUI:
    """Interactive click-to-probe flow inspector
    (ref:vis_utils.py:965-1033): click a point in the left image, see its
    flow-mapped twin in the right; 'g' toggles gray, 'v' overlays flow
    arrows, 'q' quits, 'x' exits.

    Headless environments (no $DISPLAY) can still use ``probe(x, y)``
    programmatically and ``render(with_flow=...)`` to get the two
    canvases — the interactive ``draw()`` loop requires a display."""

    def __init__(self, left_img, right_img, flow_left_to_right, mask=None):
        self.left_img = left_img.copy()
        self.right_img = right_img.copy()
        self.mask = mask
        self.left_gray = to_gray_3ch(left_img)
        self.right_gray = to_gray_3ch(right_img)
        if flow_left_to_right.shape[0] == 2:
            flow_left_to_right = np.transpose(flow_left_to_right, (1, 2, 0))
        self.flow = np.asarray(flow_left_to_right)
        self.gray = True

    def _canvases(self):
        if self.gray:
            return self.left_gray.copy(), self.right_gray.copy()
        return self.left_img.copy(), self.right_img.copy()

    def probe(self, x, y):
        """-> ((right_x, right_y), visible) for a left-image click."""
        import torch
        from ..ops.interpolation import interp_flow
        flow = torch.from_numpy(np.ascontiguousarray(self.flow[..., :2]))
        f = interp_flow(flow, torch.tensor([[x], [y]],
                                           dtype=torch.float64)).numpy()
        visible = True
        if self.mask is not None:
            yi = int(np.clip(round(y), 0, self.mask.shape[0] - 1))
            xi = int(np.clip(round(x), 0, self.mask.shape[1] - 1))
            visible = bool(self.mask[yi, xi] > 0.5)
        return (x + float(f[0, 0]), y + float(f[1, 0])), visible

    def render(self, click=None, with_flow=False):
        left_vis, right_vis = self._canvases()
        if click is not None:
            (rx, ry), visible = self.probe(*click)
            color = (0, 0, 255) if visible else (135, 0, 120)
            cv2 = _cv2("FlowGUI.render")
            cv2.circle(left_vis, (int(round(click[0])),
                                  int(round(click[1]))),
                       radius=6, color=color, thickness=-1)
            right_vis = circle(right_vis, (rx, ry), radius=6, color=color,
                               thickness=-1)
        if with_flow:
            base = vis_alignment_plain(left_vis, right_vis)
            occl = (None if self.mask is None
                    else np.uint8(255) * (self.mask < 0.5).astype(np.uint8))
            left_vis, right_vis = vis_flow(self.flow, base, base,
                                           grid_sz=30, occl=occl,
                                           occl_thr=128)
        return left_vis, right_vis

    def draw(self):
        import os
        cv2 = _cv2("FlowGUI.draw")
        if not os.environ.get("DISPLAY"):
            raise RuntimeError("FlowGUI.draw() needs a display; use "
                               "probe()/render() headlessly")
        for name in ("cv: left", "cv: right"):
            cv2.namedWindow(name, cv2.WINDOW_NORMAL)
            cv2.resizeWindow(name, 800, 600)
        cv2.setMouseCallback("cv: left", self._handler)
        left_vis, right_vis = self.render()
        cv2.imshow("cv: left", left_vis)
        cv2.imshow("cv: right", right_vis)
        while True:
            c = cv2.waitKey(0)
            if c == ord("q"):
                break
            if c == ord("x"):
                raise SystemExit(1)
            if c == ord("g"):
                self.gray = not self.gray
            elif c == ord("v"):
                lv, _ = self.render(with_flow=True)
                cv2.imshow("cv: left_flow", lv)

    def _handler(self, event, x, y, flags, param):
        cv2 = _cv2("FlowGUI")
        if event != cv2.EVENT_LBUTTONDOWN:
            return
        left_vis, right_vis = self.render(click=(x, y))
        cv2.imshow("cv: left", left_vis)
        cv2.imshow("cv: right", right_vis)
        cv2.waitKey(1)
