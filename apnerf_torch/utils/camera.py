"""General camera model (Nerfies-style) with radial/tangential distortion
(the port's own copy of ``apnerf/utils/camera.py``).

Functional counterpart of the reference's ``Camera`` class
(lib/utils.py:113-433), which the reference main path never calls: pixel
to ray with iterative undistortion, 3D to 2D projection with distortion,
look-at construction, scale and crop. NumPy, host-side.
"""
from __future__ import annotations

import copy
import dataclasses
import json

import numpy as np


@dataclasses.dataclass
class Camera:
    orientation: np.ndarray          # [3,3] world->camera rotation
    position: np.ndarray             # [3]
    focal_length: float
    principal_point: np.ndarray      # [2]
    image_size: np.ndarray           # [2] (W, H)
    skew: float = 0.0
    pixel_aspect_ratio: float = 1.0
    radial_distortion: np.ndarray = None
    tangential_distortion: np.ndarray = None

    def __post_init__(self):
        if self.radial_distortion is None:
            self.radial_distortion = np.zeros(3)
        if self.tangential_distortion is None:
            self.tangential_distortion = np.zeros(2)
        self.orientation = np.asarray(self.orientation, np.float64)
        self.position = np.asarray(self.position, np.float64)
        self.principal_point = np.asarray(self.principal_point, np.float64)
        self.image_size = np.asarray(self.image_size)

    # ---------------------------------------------------------------
    @classmethod
    def from_json(cls, path):
        with open(path) as f:
            d = json.load(f)
        if "tangential" in d:
            d["tangential_distortion"] = d["tangential"]
        return cls(
            orientation=np.asarray(d["orientation"]),
            position=np.asarray(d["position"]),
            focal_length=d["focal_length"],
            principal_point=np.asarray(d["principal_point"]),
            skew=d.get("skew", 0.0),
            pixel_aspect_ratio=d.get("pixel_aspect_ratio", 1.0),
            radial_distortion=np.asarray(d.get("radial_distortion",
                                               [0, 0, 0])),
            tangential_distortion=np.asarray(d.get("tangential_distortion",
                                                   [0, 0])),
            image_size=np.asarray(d["image_size"]))

    @property
    def optical_axis(self):
        return self.orientation[2]

    @property
    def has_distortion(self):
        return (np.any(self.radial_distortion != 0)
                or np.any(self.tangential_distortion != 0))

    # ---------------------------------------------------------------
    def _distort(self, x, y):
        k1, k2, k3 = self.radial_distortion
        p1, p2 = self.tangential_distortion
        r2 = x * x + y * y
        d = 1.0 + r2 * (k1 + r2 * (k2 + k3 * r2))
        xd = d * x + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        yd = d * y + 2 * p2 * x * y + p1 * (r2 + 2 * y * y)
        return xd, yd

    def _undistort(self, xd, yd, iters=10):
        """Gauss-Newton inversion of the distortion (reference
        lib/utils.py:43-110)."""
        x, y = xd.copy(), yd.copy()
        for _ in range(iters):
            fx, fy = self._distort(x, y)
            fx, fy = fx - xd, fy - yd
            eps = 1e-6
            jxx = (self._distort(x + eps, y)[0] - self._distort(x, y)[0]) / eps
            jxy = (self._distort(x, y + eps)[0] - self._distort(x, y)[0]) / eps
            jyx = (self._distort(x + eps, y)[1] - self._distort(x, y)[1]) / eps
            jyy = (self._distort(x, y + eps)[1] - self._distort(x, y)[1]) / eps
            det = jxx * jyy - jxy * jyx
            det = np.where(np.abs(det) > 1e-12, det, 1.0)
            x = x - (fx * jyy - fy * jxy) / det
            y = y - (fy * jxx - fx * jyx) / det
        return x, y

    # ---------------------------------------------------------------
    def pixels_to_rays(self, pixels):
        """Normalized world ray directions for pixel coords [..., 2]."""
        pixels = np.asarray(pixels, np.float64)
        fy = self.focal_length * self.pixel_aspect_ratio
        y = (pixels[..., 1] - self.principal_point[1]) / fy
        x = (pixels[..., 0] - self.principal_point[0]
             - y * self.skew) / self.focal_length
        if self.has_distortion:
            x, y = self._undistort(x, y)
        dirs = np.stack([x, y, np.ones_like(x)], -1)
        dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
        world = dirs @ self.orientation  # R^T d
        return world / np.linalg.norm(world, axis=-1, keepdims=True)

    def project(self, points):
        """3D world points [..., 3] -> pixel coords [..., 2]."""
        pts = np.asarray(points, np.float64)
        local = (pts - self.position) @ self.orientation.T
        x = local[..., 0] / local[..., 2]
        y = local[..., 1] / local[..., 2]
        if self.has_distortion:
            x, y = self._distort(x, y)
        px = self.focal_length * x + self.skew * y + self.principal_point[0]
        py = (self.focal_length * self.pixel_aspect_ratio * y
              + self.principal_point[1])
        return np.stack([px, py], -1)

    def get_pixel_centers(self):
        xx, yy = np.meshgrid(np.arange(int(self.image_size[0])),
                             np.arange(int(self.image_size[1])))
        return np.stack([xx, yy], -1) + 0.5

    # ---------------------------------------------------------------
    def scale(self, factor: float):
        assert factor > 0
        c = copy.deepcopy(self)
        c.focal_length *= factor
        c.principal_point = c.principal_point * factor
        c.image_size = np.array([int(round(self.image_size[0] * factor)),
                                 int(round(self.image_size[1] * factor))])
        return c

    def look_at(self, position, look_at, up, eps=1e-6):
        axis = np.asarray(look_at, np.float64) - position
        n = np.linalg.norm(axis)
        assert n > eps, "camera too close to target"
        axis = axis / n
        right = np.cross(axis, up)
        nr = np.linalg.norm(right)
        assert nr > eps, "up parallel to optical axis"
        right = right / nr
        R = np.stack([right, np.cross(axis, right), axis])
        c = copy.deepcopy(self)
        c.position = np.asarray(position, np.float64)
        c.orientation = R
        return c

    def crop(self, left=0, right=0, top=0, bottom=0):
        lt = np.array([left, top])
        rb = np.array([right, bottom])
        new_size = self.image_size - lt - rb
        assert (new_size > 0).all(), "crop collapses the image"
        c = copy.deepcopy(self)
        c.image_size = new_size
        c.principal_point = self.principal_point - lt
        return c
