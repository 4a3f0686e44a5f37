"""3D stick-figure motion rendering.

Port of ``motiondiffusion_moe_tpu/utils/plot.py`` (numpy and scipy on the
host, no device), kept in the port so that it imports nothing of the JAX
package. Capability match of ``text2motion/utils/plot_script.py:26-115``
(``plot_3d_motion``: an animated GIF with floor plane and root trajectory
trace) and ``utils/utils.py:125-130`` (``motion_temporal_filter``:
per-channel Gaussian smoothing).

``plot_3d_motion`` draws the JAX package's matplotlib figure with PIL
alone: matplotlib's 3D projection of that view (elevation 120, azimuth
-90, the default box aspect and camera distance, the axes' place in the
figure) in numpy, the floor plane, the root trace and the chains in the
same colours and line widths, the title, and the GIF written as
matplotlib's Pillow writer writes it (one frame per motion frame,
``1000 / fps`` ms each). Unlike matplotlib it antialiases no line and
draws the floor under the lines, never over them.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def motion_temporal_filter(motion: np.ndarray, sigma: float = 1.0) -> np.ndarray:
    """Gaussian-smooth each channel along time (``utils/utils.py:125-130``)."""
    from scipy.ndimage import gaussian_filter1d

    prev_shape = motion.shape
    motion = motion.reshape(motion.shape[0], -1)
    out = np.stack(
        [gaussian_filter1d(motion[:, i], sigma, mode="nearest")
         for i in range(motion.shape[1])], axis=1)
    return out.reshape(prev_shape)


CHAIN_COLORS = ["red", "blue", "black", "red", "blue",
                "darkblue", "darkblue", "darkblue", "darkblue", "darkblue"]


def _normalized(joints: np.ndarray):
    """The reference's normalisation: floor at the lowest height, the root
    centred in XZ; returns (data, root trajectory [T, 2], mins, maxs)."""
    data = np.asarray(joints, dtype=np.float64).copy()
    mins = data.min(axis=0).min(axis=0)
    maxs = data.max(axis=0).max(axis=0)
    data[:, :, 1] -= mins[1]
    trajec = data[:, 0, [0, 2]].copy()
    data[..., 0] -= data[:, 0:1, 0]
    data[..., 2] -= data[:, 0:1, 2]
    return data, trajec, mins, maxs


# matplotlib 3.10's Axes3D at the reference's view: the default box aspect
# (4, 4, 3) scaled as ``set_box_aspect(None)`` scales it, camera distance 10
# (``ax.dist = 7.5`` no longer moves it), focal length 1, and the 2D view
# limits and axes box of ``fig.add_subplot(111, projection="3d")`` in a
# square figure (fractions of the figure's width / height)
_BOX_ASPECT = np.array([4.0, 4.0, 3.0]) * (
    1.8294640721620434 * 25 / 24 / np.linalg.norm([4.0, 4.0, 3.0]))
_CAMERA_DIST = 10.0
_VIEW_LIM = (-0.095, 0.09)
_AXES_BOX = (0.1275, 0.11, 0.77, 0.77)


def view_projection(radius: float, elev: float = 120.0,
                    azim: float = -90.0) -> np.ndarray:
    """The 4x4 matrix matplotlib's ``Axes3D.get_proj`` builds for limits x
    [-r/2, r/2], y [0, r], z [0, r] at this view (perspective, roll 0)."""
    lo = np.array([-radius / 2, 0.0, 0.0])
    span = np.array([radius, radius, radius]) / _BOX_ASPECT
    world = np.eye(4)
    world[:3, :3] = np.diag(1.0 / span)
    world[:3, 3] = -lo / span
    R = 0.5 * _BOX_ASPECT
    e, a = np.deg2rad(elev), np.deg2rad(azim)
    eye = R + _CAMERA_DIST * np.array([np.cos(e) * np.cos(a),
                                       np.cos(e) * np.sin(a), np.sin(e)])
    # the vertical axis flips past 90 degrees of elevation
    up = np.array([0.0, 0.0, -1.0 if abs(e) > np.pi / 2 else 1.0])
    w = (eye - R) / np.linalg.norm(eye - R)
    u = np.cross(up, w)
    u /= np.linalg.norm(u)
    v = np.cross(w, u)
    view = np.eye(4)
    view[:3, :3] = [u, v, w]
    shift = np.eye(4)
    shift[:3, 3] = -eye
    zf, zb = -_CAMERA_DIST, _CAMERA_DIST
    persp = np.array([[1.0, 0, 0, 0], [0, 1.0, 0, 0],
                      [0, 0, (zf + zb) / (zf - zb), -2 * zf * zb / (zf - zb)],
                      [0, 0, -1.0, 0]])
    return persp @ view @ shift @ world


def project(points: np.ndarray, M: np.ndarray,
            size: Tuple[int, int]) -> np.ndarray:
    """[..., 3] data points -> [..., 2] pixel coordinates (x right, y
    down) of an image of ``size`` (width, height)."""
    h = np.concatenate([points, np.ones(points.shape[:-1] + (1,))], -1)
    p = h @ M.T
    xy = p[..., :2] / p[..., 3:4]
    lo, width = _VIEW_LIM[0], _VIEW_LIM[1] - _VIEW_LIM[0]
    x0, y0, bw, bh = _AXES_BOX
    W, H = size
    px = (x0 + (xy[..., 0] - lo) / width * bw) * W
    py = (y0 + (xy[..., 1] - lo) / width * bh) * H
    return np.stack([px, H - py], -1)




# the GIF's palette: white, the floor plane ((0.5, 0.5, 0.5) at alpha 0.5
# over white), then the line colours
_PALETTE = [(255, 255, 255), (191, 191, 191), (255, 0, 0), (0, 0, 255),
            (0, 0, 0), (0, 0, 139)]
_INDEX = {"floor": 1, "red": 2, "blue": 3, "black": 4, "darkblue": 5}


def plot_3d_motion(save_path: str, kinematic_tree: Sequence[Sequence[int]],
                   joints: np.ndarray, title: str = "",
                   figsize=(10, 10), fps: int = 20, radius: float = 4.0) -> None:
    """Render [T, J, 3] joints to an animated GIF (``plot_script.py:26-115``):
    the JAX package's matplotlib figure drawn with PIL, one frame per motion
    frame, ``1000 / fps`` ms each."""
    from PIL import Image, ImageDraw, ImageFont

    data, trajec, mins, maxs = _normalized(joints)
    dpi = 100
    size = (int(figsize[0] * dpi), int(figsize[1] * dpi))
    M = view_projection(radius)
    px = dpi / 72.0  # a point in pixels
    try:
        font = ImageFont.load_default(size=20 * px)
    except TypeError:  # Pillow < 10.1 has one bitmap size
        font = ImageFont.load_default()
    palette = [c for rgb in _PALETTE for c in rgb]

    frames = []
    for index in range(data.shape[0]):
        # drawn in the palette's indices, so the GIF writer quantizes nothing
        im = Image.new("P", size, 0)
        im.putpalette(palette)
        draw = ImageDraw.Draw(im)
        minx, maxx = mins[0] - trajec[index, 0], maxs[0] - trajec[index, 0]
        minz, maxz = mins[2] - trajec[index, 1], maxs[2] - trajec[index, 1]
        verts = np.array([[minx, 0, minz], [minx, 0, maxz],
                          [maxx, 0, maxz], [maxx, 0, minz]])
        draw.polygon([tuple(p) for p in project(verts, M, size)],
                     fill=_INDEX["floor"])
        if index > 1:  # the root's trajectory so far
            trace = np.stack([trajec[:index, 0] - trajec[index, 0],
                              np.zeros(index),
                              trajec[:index, 1] - trajec[index, 1]], -1)
            draw.line([tuple(p) for p in project(trace, M, size)],
                      fill=_INDEX["blue"], width=max(1, round(1.0 * px)))
        for i, (chain, color) in enumerate(zip(kinematic_tree,
                                               CHAIN_COLORS)):
            lw = 4.0 if i < 5 else 2.0
            pts = project(data[index, list(chain)], M, size)
            draw.line([tuple(p) for p in pts], fill=_INDEX[color],
                      width=max(1, round(lw * px)), joint="curve")
        if title:
            draw.text((size[0] / 2, 0.02 * size[1]), title,
                      fill=_INDEX["black"], font=font, anchor="mt")
        frames.append(im)
    # optimize=False: the palette is already the frames' own
    frames[0].save(save_path, save_all=True, append_images=frames[1:],
                   duration=int(1000 / fps), loop=0, optimize=False)
