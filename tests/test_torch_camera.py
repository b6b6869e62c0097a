"""The port's copy of the Nerfies camera (apnerf_torch/utils/camera.py):
the cases of tests/test_camera.py on it, and the same projections as the
JAX package's copy."""
import numpy as np

from apnerf_torch.utils.camera import Camera


def _cam(**kw):
    base = dict(orientation=np.eye(3), position=np.zeros(3),
                focal_length=100.0, principal_point=np.array([32.0, 24.0]),
                image_size=np.array([64, 48]))
    base.update(kw)
    return Camera(**base)


def test_project_unproject_roundtrip_no_distortion():
    cam = _cam()
    rng = np.random.default_rng(0)
    pts = rng.uniform(-0.2, 0.2, (20, 3)) + [0, 0, 3.0]
    pix = cam.project(pts)
    rays = cam.pixels_to_rays(pix)
    # rays from the camera through the points
    expected = pts - cam.position
    expected /= np.linalg.norm(expected, axis=-1, keepdims=True)
    np.testing.assert_allclose(rays, expected, atol=1e-6)


def test_project_unproject_roundtrip_with_distortion():
    cam = _cam(radial_distortion=np.array([0.05, -0.01, 0.0]),
               tangential_distortion=np.array([0.001, -0.002]))
    rng = np.random.default_rng(1)
    pts = rng.uniform(-0.2, 0.2, (20, 3)) + [0, 0, 3.0]
    pix = cam.project(pts)
    rays = cam.pixels_to_rays(pix)
    expected = pts - cam.position
    expected /= np.linalg.norm(expected, axis=-1, keepdims=True)
    np.testing.assert_allclose(rays, expected, atol=1e-4)


def test_scale_and_crop():
    cam = _cam()
    half = cam.scale(0.5)
    assert half.focal_length == 50.0
    np.testing.assert_allclose(half.principal_point, [16.0, 12.0])
    cropped = cam.crop(left=4, top=2)
    np.testing.assert_allclose(cropped.principal_point, [28.0, 22.0])
    np.testing.assert_array_equal(cropped.image_size, [60, 46])


def test_look_at_points_camera_at_target():
    cam = _cam()
    c2 = cam.look_at(np.array([0, 0, 5.0]), np.zeros(3),
                     np.array([0, 1.0, 0]))
    # optical axis points from camera to origin
    np.testing.assert_allclose(c2.optical_axis, [0, 0, -1.0], atol=1e-6)
    pix = c2.project(np.zeros((1, 3)))
    np.testing.assert_allclose(pix[0], cam.principal_point, atol=1e-6)


def test_same_as_the_jax_package_copy(tmp_path):
    """from_json, pixels_to_rays with distortion, project, scale, look_at
    and crop give the JAX package's numbers exactly (both are numpy)."""
    import json
    from apnerf.utils.camera import Camera as JaxCamera
    spec = dict(orientation=np.eye(3).tolist(), position=[0.1, -0.2, 0.3],
                focal_length=90.0, principal_point=[31.0, 25.0],
                image_size=[64, 48], skew=0.01, pixel_aspect_ratio=1.02,
                radial_distortion=[0.04, -0.01, 0.002],
                tangential=[0.001, -0.002])
    path = tmp_path / "cam.json"
    path.write_text(json.dumps(spec))
    cams = [Camera.from_json(str(path)), JaxCamera.from_json(str(path))]
    rng = np.random.default_rng(2)
    pts = rng.uniform(-0.2, 0.2, (20, 3)) + [0, 0, 3.0]
    outs = []
    for c in cams:
        c2 = c.scale(0.5).look_at(np.array([0.3, 0.1, 4.0]), np.zeros(3),
                                  np.array([0, 1.0, 0])).crop(left=2, top=1)
        outs.append([c.project(pts), c.pixels_to_rays(c.get_pixel_centers()),
                     c2.project(pts), c2.orientation, c2.image_size])
    for got, want in zip(*outs):
        np.testing.assert_array_equal(got, want)
