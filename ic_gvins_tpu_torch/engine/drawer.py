"""Visualization (``engine/drawer.py``): tracked-feature image annotation
and trajectory / map state, numpy only.

The reference's Drawer / DrawerRviz (``tracking/drawer.{h,cc}``,
``ROS/drawer_rviz.{h,cc}``) publish an annotated tracking image (a motion
trail per feature and a rectangle coloured by map-point type,
``drawer.cc:25-69``), odometry, path and landmark clouds to rviz. The
``Drawer`` here keeps the same update API (``drawer.h:38-53``) and renders
numpy images on demand; ``save_artifacts`` writes PNG plots when
matplotlib is installed and ``.npy`` arrays otherwise.
"""

import os

import numpy as np

# rectangle colors by feature class, mirroring drawer.cc:46-68 (BGR there,
# RGB here): map-tracked triangulated = cyan-ish (255,255,0 BGR -> yellow),
# depth-associated = green, depth-initialized = yellow BGR -> cyan,
# reference-frame (not yet mapped) = blue BGR -> (0,0,255) RGB blue.
COLOR_TRIANGULATED = (0, 255, 255)
COLOR_DEPTH_ASSOCIATED = (0, 255, 0)
COLOR_DEPTH_INITIALIZED = (255, 255, 0)
COLOR_REF = (0, 0, 255)
COLOR_TRAIL = (255, 0, 0)

# MapPointType (mappoint.h:38-44). The reference only ever *creates*
# TRIANGULATED points (tracking.cc:767); DEPTH_ASSOCIATED is declared but
# unassigned there. This engine tracks the lifecycle: DEPTH_INITIALIZED
# (allocated at default depth) -> TRIANGULATED (two-view depth accepted)
# -> FIXED (left the window at marginalization, ic_gvins.cc:1695-1705).
MAPPOINT_NONE = 0
MAPPOINT_TRIANGULATED = 1
MAPPOINT_DEPTH_ASSOCIATED = 2
MAPPOINT_DEPTH_INITIALIZED = 3
MAPPOINT_FIXED = 4

_TYPE_COLORS = {
    MAPPOINT_TRIANGULATED: COLOR_TRIANGULATED,
    MAPPOINT_DEPTH_ASSOCIATED: COLOR_DEPTH_ASSOCIATED,
    MAPPOINT_DEPTH_INITIALIZED: COLOR_DEPTH_INITIALIZED,
}


def _to_rgb(img) -> np.ndarray:
    img = np.asarray(img)
    if img.ndim == 2:
        rgb = np.stack([img] * 3, axis=-1)
    else:
        rgb = img.copy()
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _draw_rect(rgb, x, y, half, color, width=2):
    """Hollow rectangle centered at (x, y) (drawer.cc rectangle)."""
    h, w = rgb.shape[:2]
    x0, x1 = int(round(x - half)), int(round(x + half))
    y0, y1 = int(round(y - half)), int(round(y + half))
    if x1 < 0 or y1 < 0 or x0 >= w or y0 >= h:
        return
    xc0, xc1 = max(x0, 0), min(x1 + 1, w)
    yc0, yc1 = max(y0, 0), min(y1 + 1, h)
    for b in range(width):
        if y0 + b >= 0 and y0 + b < h:
            rgb[y0 + b, xc0:xc1] = color
        if 0 <= y1 - b < h:
            rgb[y1 - b, xc0:xc1] = color
        if x0 + b >= 0 and x0 + b < w:
            rgb[yc0:yc1, x0 + b] = color
        if 0 <= x1 - b < w:
            rgb[yc0:yc1, x1 - b] = color


def _draw_line(rgb, p0, p1, color):
    """Feature motion trail (drawer.cc cv::line), by dense sampling."""
    h, w = rgb.shape[:2]
    p0 = np.asarray(p0, np.float64)
    p1 = np.asarray(p1, np.float64)
    n = int(np.ceil(np.linalg.norm(p1 - p0))) + 1
    ts = np.linspace(0.0, 1.0, n)
    xs = np.round(p0[0] + ts * (p1[0] - p0[0])).astype(int)
    ys = np.round(p0[1] + ts * (p1[1] - p0[1])).astype(int)
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    rgb[ys[ok], xs[ok]] = color


def draw_tracking_image(
    raw,
    pts_map_prev=None,
    pts_map_cur=None,
    map_types=None,
    pts_ref_prev=None,
    pts_ref_cur=None,
) -> np.ndarray:
    """Annotate a frame exactly like ``Drawer::drawTrackingImage``
    (drawer.cc:25-69): a trail line from the previous to the current pixel
    for every tracked feature, plus a hollow rectangle at the current pixel
    colored by mappoint type (map-tracked) or blue (reference-frame
    features not yet in the map). Rectangle size adapts to image height
    (21 px, or 15 px below 600 rows)."""
    rgb = _to_rgb(raw)
    half = 10.0 if rgb.shape[0] >= 600 else 7.0

    if pts_map_cur is not None and len(pts_map_cur):
        prev = np.asarray(pts_map_prev, np.float64)
        cur = np.asarray(pts_map_cur, np.float64)
        types = (
            np.asarray(map_types)
            if map_types is not None
            else np.full(len(cur), MAPPOINT_TRIANGULATED)
        )
        for k in range(len(cur)):
            color = _TYPE_COLORS.get(int(types[k]))
            if color is None:
                continue
            _draw_line(rgb, prev[k], cur[k], COLOR_TRAIL)
            _draw_rect(rgb, cur[k][0], cur[k][1], half, color)

    if pts_ref_cur is not None and len(pts_ref_cur):
        prev = np.asarray(pts_ref_prev, np.float64)
        cur = np.asarray(pts_ref_cur, np.float64)
        for k in range(len(cur)):
            _draw_line(rgb, prev[k], cur[k], COLOR_TRAIL)
            _draw_rect(rgb, cur[k][0], cur[k][1], half, COLOR_REF)
    return rgb


class Drawer:
    """Stateful visualization sink with the reference's update API
    (``drawer.h:38-53`` + the rviz publisher state): the pipeline pushes
    poses, tracked points and landmarks; ``render_tracking_image`` /
    ``save_artifacts`` produce the outputs on demand."""

    def __init__(self, keep_images: int = 1):
        self.keep_images = keep_images
        self.path_t: list[float] = []
        self.path_p: list[np.ndarray] = []
        self.fixed_points: list[np.ndarray] = []
        self.current_points: np.ndarray = np.zeros((0, 3))
        self.images: list[np.ndarray] = []
        self._map_prev = self._map_cur = self._map_types = None
        self._ref_prev = self._ref_cur = None

    # --- update API (parity drawer.h:44-53) ---
    def add_new_fixed_mappoint(self, point):
        self.fixed_points.append(np.asarray(point, np.float64))

    def update_map(self, current_points):
        self.current_points = np.asarray(current_points, np.float64)

    def update_odometry(self, t, p, q=None):
        self.path_t.append(float(t))
        self.path_p.append(np.asarray(p, np.float64))

    def update_tracked_mappoints(self, prev, cur, types=None):
        self._map_prev, self._map_cur, self._map_types = prev, cur, types

    def update_tracked_refpoints(self, prev, cur):
        self._ref_prev, self._ref_cur = prev, cur

    def update_frame(self, raw):
        """Render + retain the annotated tracking image for the frame
        (publishTrackingImage analog)."""
        img = draw_tracking_image(
            raw,
            self._map_prev,
            self._map_cur,
            self._map_types,
            self._ref_prev,
            self._ref_cur,
        )
        self.images.append(img)
        if len(self.images) > self.keep_images:
            self.images.pop(0)
        return img

    # --- offline artifacts (rviz-equivalent observability) ---
    def save_artifacts(self, outdir: str):
        """Write the retained tracking image(s), the path, and the landmark
        clouds to ``outdir`` (offline stand-ins for the rviz topics)."""
        os.makedirs(outdir, exist_ok=True)
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except Exception:  # matplotlib-free fallback: raw npy dumps
            for i, img in enumerate(self.images):
                np.save(os.path.join(outdir, f"tracking_{i}.npy"), img)
            np.save(os.path.join(outdir, "path.npy"), np.asarray(self.path_p))
            return
        for i, img in enumerate(self.images):
            plt.imsave(os.path.join(outdir, f"tracking_{i}.png"), img)
        fig, ax = plt.subplots(figsize=(6, 6))
        plot_trajectory(ax, self.path_t, self.path_p)
        if self.fixed_points:
            pts = np.stack(self.fixed_points)
            ax.plot(pts[:, 1], pts[:, 0], ".", ms=2, alpha=0.4, label="landmarks")
            ax.legend()
        fig.savefig(os.path.join(outdir, "map.png"), dpi=100)
        plt.close(fig)


def plot_trajectory(ax, times, positions, truth=None, label="estimate"):
    """North-East ground track (matplotlib axis)."""
    p = np.asarray(positions)
    if len(p):
        ax.plot(p[:, 1], p[:, 0], "-", label=label)
    if truth is not None:
        t = np.asarray(truth)
        ax.plot(t[:, 1], t[:, 0], "--", label="truth")
    ax.set_xlabel("East (m)")
    ax.set_ylabel("North (m)")
    ax.axis("equal")
    ax.legend()


def plot_statistics(ax_grid, stats: list[dict]):
    """Cost / culled / node-count curves (parity show_statistics.py)."""
    ts = [s["t"] for s in stats]
    keys = ["cost0", "cost1", "culled", "n_nodes"]
    for ax, k in zip(np.ravel(ax_grid), keys):
        ax.plot(ts, [s[k] for s in stats])
        ax.set_title(k)
        ax.set_xlabel("t (s)")


def annotate_tracked_image(img, pts, valid, radius: int = 3):
    """Simple tracked-feature markers (kept for lightweight callers)."""
    rgb = _to_rgb(img)
    h, w = rgb.shape[:2]
    for (x, y), ok in zip(np.asarray(pts), np.asarray(valid)):
        if not ok:
            continue
        xi, yi = int(round(x)), int(round(y))
        if not (radius <= xi < w - radius and radius <= yi < h - radius):
            continue
        rgb[yi - radius : yi + radius + 1, xi - radius : xi + radius + 1, 0] = 255
        rgb[yi - radius : yi + radius + 1, xi - radius : xi + radius + 1, 1:] //= 2
    return rgb
