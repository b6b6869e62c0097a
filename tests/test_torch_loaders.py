"""The port's dataset loaders against the JAX package's, on fixtures made
from seeds: a D-NeRF scene that the JAX ``generate_scene`` wrote (and the
port's own ``generate_scene``), WIM and ZJU fixtures built as in
tests/test_loaders.py (a resized case each, the nao ``coordinate_scale``,
a blosc-compressed ZJU cache), the blosc frame decoder, and two stage-1
steps on the WIM- and ZJU-format dicts (uint8 images, many images to one
camera). Arrays equal unless stated: resized images within one uint8
level (``area_resize`` against cv2's INTER_AREA), two for the WIM images
(RGB and alpha each within one, then composited), D-NeRF float images
within 1e-6."""
import json
import os
import pickle

import imageio.v2 as imageio
import numpy as np
import pytest

from apnerf.config import config as jconfig
from apnerf.data import bloscdec as jblosc
from apnerf.data import load_data as jload
from apnerf.data import synthetic as jsyn
from apnerf.train import stage1 as js1
from apnerf_torch.config import config as tconfig
from apnerf_torch.data import bloscdec as tblosc
from apnerf_torch.data import load_data as tload
from apnerf_torch.data import synthetic as tsyn
from apnerf_torch.models import tineuvox as tt
from apnerf_torch.train import stage1 as ts1
from apnerf_torch.utils.png import read_png
from torch_cli_scene import jax_init, one_torch_thread  # noqa

JAX_CFG = jconfig.builtin_config_dir()
PORT_CFG = tconfig.builtin_config_dir()
RESIZED = {"images", "masks"}


def _make_wim(root, n_frames=2, size=32):
    """tests/test_loaders.py's WIM fixture: 18 cameras, RGBA noise."""
    os.makedirs(root, exist_ok=True)
    cams = list(range(1, 10)) + list(range(11, 20))
    rng = np.random.default_rng(0)
    for c in cams:
        with open(os.path.join(root, f"cam_{c:03d}.json"), "w") as f:
            view = np.eye(4)
            view[2, 3] = -3.0 - 0.01 * c
            json.dump({"camera_data": {
                "intrinsics": {"fx": 40.0, "fy": 40.0, "cx": size / 2,
                               "cy": size / 2},
                "camera_view_matrix": view.T.tolist()}}, f)
    for fid in range(n_frames):
        for c in cams:
            img = rng.integers(0, 255, (size, size, 4), dtype=np.uint8)
            imageio.imwrite(
                os.path.join(root, f"frame_{fid:05d}_cam_{c:03d}.png"), img)
    return root


def _make_zju(path, n_frames=3, n_cams=4, size=32, pack=None):
    """tests/test_loaders.py's ZJU cache; ``pack`` compresses each image
    and mask (``blosc.pack_array``'s frames)."""
    rng = np.random.default_rng(1)
    data = {"frame_id": np.arange(n_frames),
            "camera_id": np.repeat(np.arange(n_cams), n_frames),
            "img": [], "mask": [], "camera_intrinsic": [],
            "camera_rotation": [], "camera_translation": []}
    for c in range(n_cams):
        for _ in range(n_frames):
            img = rng.integers(0, 255, (3, size, size), dtype=np.uint8)
            mask = (rng.random((size, size)) < 0.3).astype(np.uint8)[None]
            data["img"].append(pack(img) if pack else img)
            data["mask"].append(pack(mask) if pack else mask)
            data["camera_intrinsic"].append(
                np.array([[40.0, 0, size / 2], [0, 40.0, size / 2],
                          [0, 0, 1.0]]))
            data["camera_rotation"].append(np.eye(3))
            data["camera_translation"].append(
                np.array([[0.0], [0.0], [3.0 + c]]))
    with open(path, "wb") as f:
        pickle.dump(data, f)
    return path


def assert_same(got, want, resized=False, levels=1):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, np.ndarray):
            assert g.shape == w.shape and g.dtype == w.dtype, k
            if resized and k in RESIZED:
                d = np.abs(g.astype(np.float64) - w.astype(np.float64))
                tol = levels if w.dtype == np.uint8 else 1e-6
                assert d.max() <= tol, (k, d.max())
            elif w.dtype.kind == "f":
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-6,
                                           err_msg=k)
            else:
                np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            assert g == w, k


def load_both(family, name, **data):
    jcfg = jconfig.load_config(os.path.join(JAX_CFG, family, name))
    tcfg = tconfig.load_config(os.path.join(PORT_CFG, family, name))
    for cfg in (jcfg, tcfg):
        cfg.data.update(data)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def dnerf_scene(tmp_path_factory):
    return jsyn.generate_scene(str(tmp_path_factory.mktemp("d") / "arm"),
                               n_times=3, n_test=2, H=24, W=32)


@pytest.mark.parametrize("half_res", [True, False])
@pytest.mark.parametrize("load_test_val", [False, True])
def test_load_data_dnerf_vs_jax(dnerf_scene, half_res, load_test_val):
    """Every kept key of ``load_data`` on the JAX-written scene (cv2 halves
    the images on the JAX side)."""
    jcfg, tcfg = load_both("nerf", "jumpingjacks.py", datadir=dnerf_scene,
                           half_res=half_res)
    want = jload.load_data(jcfg.data, jcfg, load_test_val)
    got = tload.load_data(tcfg.data, tcfg, load_test_val)
    assert set(got) == set(want) and tload.KEPT_KEYS == jload.KEPT_KEYS
    assert_same({k: got[k] for k in tload.KEPT_KEYS},
                {k: want[k] for k in jload.KEPT_KEYS}, resized=half_res)
    assert len(got["images"]) == 3          # train 3, or val 1 + test 2
    assert got["images"].shape[1:3] == ((12, 16) if half_res else (24, 32))


def test_half_res_needs_even_sizes(tmp_path):
    root = tsyn.generate_scene(str(tmp_path / "odd"), n_times=2, n_test=1,
                               H=9, W=10)
    _, tcfg = load_both("nerf", "jumpingjacks.py", datadir=root,
                        half_res=True)
    with pytest.raises(ValueError, match="even"):
        tload.load_data(tcfg.data, tcfg)


def test_generate_scene_vs_jax(dnerf_scene, tmp_path):
    """The port's writer gives the JAX scene's pixels and json."""
    root = tsyn.generate_scene(str(tmp_path / "arm"), n_times=3, n_test=2,
                               H=24, W=32)
    for split in ("train", "val", "test"):
        with open(os.path.join(root, f"transforms_{split}.json")) as f:
            got = json.load(f)
        with open(os.path.join(dnerf_scene,
                               f"transforms_{split}.json")) as f:
            want = json.load(f)
        assert got == want
        for fr in got["frames"]:
            name = fr["file_path"] + ".png"
            want_px = imageio.imread(os.path.join(dnerf_scene, name))
            np.testing.assert_array_equal(
                imageio.imread(os.path.join(root, name)), want_px)
            np.testing.assert_array_equal(
                read_png(os.path.join(root, name)), want_px)
    assert tsyn.generate_scene(root) == root          # kept, not rewritten


@pytest.mark.parametrize("robot,size", [("spot", 32), ("spot", 20),
                                        ("nao", 32)])
def test_load_data_wim_vs_jax(tmp_path, robot, size):
    root = _make_wim(str(tmp_path / robot), n_frames=2, size=32)
    name = "nao.py" if robot == "nao" else "spot.py"
    jcfg, tcfg = load_both("wim", name, datadir=root, video_len=2,
                           wim_size=size)
    want = jload.load_data(jcfg.data, jcfg, bg_col=1.0)
    got = tload.load_data(tcfg.data, tcfg, bg_col=1.0)
    assert_same(got, want, resized=size != 32, levels=2)
    assert got["images"].dtype == np.uint8
    assert got["images"].shape == (36, size, size, 3)
    if robot == "nao":
        np.testing.assert_allclose(got["poses"][0][2, 3], 3.01 / 0.333,
                                   rtol=1e-4)
    assert len(got["i_train"]) == 36 and len(got["i_test"]) == 0


@pytest.mark.parametrize("cache", ["raw", "blosclz", "zlib", "resized"])
def test_load_data_zju_vs_jax(tmp_path, cache):
    pack = None if cache in ("raw", "resized") else (
        lambda a: jblosc.pack_array(a, cname=cache))
    path = _make_zju(str(tmp_path / "cache_train.pickle"), pack=pack)
    size = 20 if cache == "resized" else 32
    jcfg, tcfg = load_both("zju", "377.py", datadir=path, video_len=3,
                           zju_size=size)
    for bg in (0, 1.0):
        want = jload.load_data(jcfg.data, jcfg, bg_col=bg)
        got = tload.load_data(tcfg.data, tcfg, bg_col=bg)
        assert_same(got, want, resized=cache == "resized")
        assert got["images"].shape == (8, size, size, 3)


@pytest.mark.parametrize("cname", ["blosclz", "zlib"])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32, np.int64])
def test_bloscdec_vs_jax(cname, dtype):
    """Frames of the JAX encoder (byte shuffle at the element size, a
    leftover block, stored and compressed splits) decode alike in both
    packages, through the native blosclz decoder and the Python one."""
    rng = np.random.default_rng(7)
    arr = (rng.integers(0, 4, (70, 333)) * 17).astype(dtype)
    arr[::3] = rng.integers(0, 255, arr[::3].shape)
    frame = jblosc.pack_array(arr, cname=cname)
    want = jblosc.decompress(frame)
    for force in (False, True):
        assert tblosc.decompress(frame, force_python=force) == want
        np.testing.assert_array_equal(
            tblosc.unpack_array(frame, force_python=force), arr)
    stored = jblosc.compress(rng.bytes(4000), typesize=1)  # memcpyed frame
    assert tblosc.decompress(stored) == jblosc.decompress(stored)


def test_blosclz_native_vs_python():
    rng = np.random.default_rng(8)
    data = bytes(rng.integers(0, 3, 20000).astype(np.uint8)) + bytes(300) \
        + rng.bytes(500) + bytes(9000)
    stream = jblosc.blosclz_compress(data)
    assert len(stream) < len(data) // 2
    assert tblosc.blosclz_decompress(stream, len(data)) == data
    assert tblosc.blosclz_decompress_py(stream, len(data)) == data
    with pytest.raises(ValueError):
        tblosc.blosclz_decompress(stream, len(data) + 1)
    with pytest.raises(NotImplementedError):
        tblosc.decompress(bytes([2, 1, 0x04, 1]) + bytes(12))


def _tiny(cfg):
    cfg.model_and_render.update(num_voxels=12 ** 3, num_voxels_base=12 ** 3,
                                voxel_dim=4, net_width=24, defor_depth=3)
    cfg.train_config.update(N_rand=64, pg_scale=[])
    return cfg


@pytest.mark.parametrize("family", ["wim", "zju"])
def test_stage1_steps_on_loaded_dicts(tmp_path, monkeypatch, family):
    """Two ``scene_rep_reconstruction`` steps on the loaded dicts, the
    port's init replaced by the JAX init: the logged losses and PSNRs at
    rtol 1e-4 (test_torch_stage1.py's tolerance for whole runs)."""
    if family == "wim":
        root = _make_wim(str(tmp_path / "spot"), n_frames=2, size=16)
        jcfg, tcfg = load_both("wim", "spot.py", datadir=root, video_len=2,
                               wim_size=16)
    else:
        root = _make_zju(str(tmp_path / "cache_train.pickle"), size=16)
        jcfg, tcfg = load_both("zju", "377.py", datadir=root, video_len=3,
                               zju_size=16)
    bg = jcfg.train_config.bg_col
    jdata = jload.load_data(jcfg.data, jcfg, bg_col=bg)
    tdata = tload.load_data(tcfg.data, tcfg, bg_col=bg)
    assert tdata["images"].dtype == np.uint8
    assert len(np.unique(tdata["img_to_cam"])) < len(tdata["images"])

    monkeypatch.setattr(ts1.tineuvox, "init_model", jax_init)
    _, jm, jstats = js1.scene_rep_reconstruction(_tiny(jcfg), jdata,
                                                 n_iters=2, log_every=1)
    _, tm, tstats = ts1.scene_rep_reconstruction(_tiny(tcfg), tdata,
                                                 n_iters=2, log_every=1,
                                                 device="cpu")
    assert tm == tt.TiNeuVoxConfig(**jm.get_kwargs())
    assert len(tstats["loss"]) == len(jstats["loss"]) == 2
    assert np.isfinite(tstats["loss"]).all()
    np.testing.assert_allclose(tstats["loss"], jstats["loss"], rtol=1e-4)
    np.testing.assert_allclose(tstats["psnr"], jstats["psnr"], rtol=1e-4)
