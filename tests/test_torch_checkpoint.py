"""Checkpoints cross between the packages: a JAX-written
``temporalpoints_last.pkl`` loads and renders in the port, the port's
writer round-trips and the JAX loader reads it, and the port loads one
without importing jax."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import jax

from apnerf_torch.models import temporal_points as ttp
from apnerf_torch.utils import checkpoint as tck
from test_torch_temporal_points import (BASE, jax_state, port_model,  # noqa
                                        port_render, scene)

REPO = Path(__file__).resolve().parent.parent


class _TineuvoxCfg:
    def get_kwargs(self):
        return {"note": "test"}


def _jax_save(path, s):
    from apnerf import cli
    from apnerf.models import temporal_points as jtp
    cfg = jtp.TemporalPointsConfig(**BASE)
    cli.save_temporalpoints(str(path), s["params"], cfg, jax_state(cfg, s),
                            None, _TineuvoxCfg())


def test_jax_checkpoint_renders_in_port(tmp_path, scene):
    path = tmp_path / "temporalpoints_last.pkl"
    _jax_save(path, scene)
    model, state = tck.load_temporalpoints(str(path), device="cpu")
    assert model.cfg == ttp.TemporalPointsConfig(**BASE)
    ref_model, ref_state = port_model({}, scene)
    for k, v in ref_model.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    assert torch.equal(state["nn_i"], ref_state["nn_i"])
    got = port_render(model, state)
    want = port_render(ref_model, ref_state)
    assert torch.equal(got["rgb_marched"], want["rgb_marched"])
    assert torch.equal(got["depth"], want["depth"])


def test_port_writer_round_trips(tmp_path, scene):
    from apnerf import cli
    model, state = port_model({}, scene)
    path = tmp_path / "port.pkl"
    tck.save_temporalpoints(str(path), model, state)
    back, bstate = tck.load_temporalpoints(str(path), device="cpu")
    assert back.cfg == model.cfg
    for k, v in model.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
    for k in ("canonical_pcd", "nn_i", "xyz_min", "original_joints"):
        assert torch.equal(bstate[k], state[k]), k
    # the JAX package reads the port's file: same pytree, same config
    jparams, jcfg, _ = cli.load_temporalpoints(str(path))
    assert jcfg == type(jcfg)(**BASE)
    want = jax.tree_util.tree_leaves_with_path(scene["tree"])
    got = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, jparams)))
    assert len(got) == len(want)
    for kp, leaf in want:
        np.testing.assert_array_equal(got[kp], leaf)


def test_port_imports_no_jax(tmp_path, scene):
    """Every apnerf_torch module, then init_params, load_temporalpoints,
    the render entry points (simplify_skeleton, make_points_renderer with
    fused_agg through render_viewpoints with every metric, repose, LPIPS),
    two stage-1 training steps on a tiny scene (the second on the
    occupancy path), then the stage-2 half: the thinning library, the
    curriculum sampler, the export of that stage-1 model (skeletonizer
    included) and two train_pcd steps, then the command line (both stages
    of a micro config on a scene that ``generate_scene`` writes, without
    the tensorboard writer: TensorFlow's tensorboard imports jax) and
    ``load_data`` of each dataset format, in a fresh interpreter: neither
    jax nor the JAX package (apnerf) ever enters sys.modules (conftest
    imports jax here)."""
    model, state = port_model({}, scene)
    path = tmp_path / "port.pkl"
    tck.save_temporalpoints(str(path), model, state)
    code = (
        "import importlib, pkgutil, sys\n"
        "import numpy as np, torch\n"
        "torch.set_num_threads(1)  # the suite's workers share the CPUs\n"
        "import apnerf_torch\n"
        "for m in pkgutil.walk_packages(apnerf_torch.__path__, "
        "'apnerf_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from apnerf_torch.models import temporal_points as tp\n"
        "from apnerf_torch.utils.checkpoint import load_temporalpoints, \\\n"
        "    params_to_jax\n"
        f"model, state = load_temporalpoints({str(path)!r}, device='cpu')\n"
        "assert state['nn_i'].shape == (2000, 8)\n"
        "tp.init_params(model.cfg, state['canonical_pcd'].numpy(),\n"
        "               state['original_joints'].numpy(), state['bones'],\n"
        "               model.canonical_feat.detach().numpy(),\n"
        "               np.zeros(2000), np.zeros((2000, 3)),\n"
        "               {k: v for k, v in params_to_jax(model.state_dict())\n"
        "                .items() if k in tp.HEADS},\n"
        "               torch.Generator().manual_seed(0), device='cpu')\n"
        "from apnerf_torch import cli\n"
        "from apnerf_torch.render import lpips\n"
        "from apnerf_torch.render.render import render_viewpoints\n"
        "from apnerf_torch.render.renderers import make_points_renderer\n"
        "model.cfg = cli.points_render_config(model.cfg, {\n"
        "    'pcd_model_and_render': dict(knn_share=8, knn_cand=8,\n"
        "                                 fused_agg=True)})\n"
        "state, info = tp.simplify_skeleton(model, state,\n"
        "                                   np.linspace(0, 1, 5))\n"
        "assert info['prune_bones'].shape == (6,)\n"
        "pose = np.eye(4, dtype=np.float32); pose[2, 3] = 3.0\n"
        "data = dict(poses=pose[None], HW=np.array([[12, 16]]),\n"
        "            Ks=np.array([[[140., 0, 8], [0, 140., 6], [0, 0, 1]]]))\n"
        "view = make_points_renderer(model, state, 0.5, 6.0, 1.0,\n"
        "                            render_weights=False)\n"
        "out = render_viewpoints(view, data['poses'], data['HW'],\n"
        "                        data['Ks'], [0.5],\n"
        "                        gt_imgs=np.zeros((1, 12, 16, 3)),\n"
        "                        eval_psnr=True, eval_ssim=True, chunk=192,\n"
        "                        verbose=False, device='cpu')\n"
        "assert out['rgbs'].shape == (1, 12, 16, 3) and out['psnrs']\n"
        "assert view(0, 0.5)(*torch.rand(3, 192, 3))['knn_path'] \\\n"
        "    == 'shared_fused'\n"
        "out = cli.repose(model, state, data, 0.5, 6.0, 1.0,\n"
        "                 render_factor=4, chunk=12, verbose=False,\n"
        "                 device='cpu')\n"
        "assert out['rgbs'].shape == (60, 3, 4, 3)\n"
        "a = np.random.default_rng(0).random((64, 64, 3))\n"
        "assert lpips.lpips(a, 1 - a, 'alex', device='cpu') > 0\n"
        "from apnerf_torch.config import nerf_default\n"
        "from apnerf_torch.data.synthetic import make_scene\n"
        "from apnerf_torch.train.stage1 import scene_rep_reconstruction\n"
        "cfg = nerf_default(N_rand=32, pg_scale=[], occupancy_start=2)\n"
        "cfg.model_and_render.update(num_voxels=8 ** 3,\n"
        "                            num_voxels_base=8 ** 3, voxel_dim=4,\n"
        "                            defor_depth=2, net_width=16)\n"
        "scene = make_scene(2, 16, 16)\n"
        "m1, c1, stats = scene_rep_reconstruction(\n"
        "    cfg, scene, n_iters=2, log_every=1, device='cpu')\n"
        "assert len(stats['loss']) == 2 and np.isfinite(stats['loss']).all()\n"
        "from apnerf_torch.kinematics import morphology, skeletonizer\n"
        "from apnerf_torch.train import export, stage2\n"
        "from apnerf_torch.utils import samplers\n"
        "vol = np.zeros((12, 8, 8), bool); vol[2:10, 3:5, 3:5] = True\n"
        "assert morphology.skeletonize_3d(vol).any()\n"
        "assert samplers.InverseProportionalSampler(3).sample() in range(3)\n"
        f"art = export.export_point_cloud(m1, {str(tmp_path)!r}, 0.0, 0.5,\n"
        "    pcd_density_threshold=0.0, skeleton_density_threshold=0.0,\n"
        "    bone_length=3.0, canonical_pcd_num=200, overwrite=True)\n"
        "assert skeletonizer.create_skeleton is not None\n"
        "cfg.pcd_train_config.update(N_rand=16, full_t_iter=4)\n"
        "_, _, _, s2 = stage2.train_pcd(\n"
        "    cfg, scene, art['canonical'], art['skeleton'],\n"
        "    params_to_jax(m1.state_dict()), c1,\n"
        "    (np.asarray(c1.xyz_min), np.asarray(c1.xyz_max)), n_iters=2,\n"
        "    log_every=1, sample_budget=16, device='cpu')\n"
        "assert len(s2['loss']) == 2 and np.isfinite(s2['loss']).all()\n"
        "import json, os, pickle\n"
        "from apnerf_torch.config import load_config\n"
        "from apnerf_torch.data import synthetic\n"
        "from apnerf_torch.data.load_data import load_data\n"
        "from apnerf_torch.utils.png import write_png\n"
        f"root = {str(tmp_path)!r}\n"
        "os.chdir(root)\n"
        "arm = synthetic.generate_scene(root + '/arm', n_times=3, n_test=1,\n"
        "                               H=16, W=16)\n"
        "base = os.path.join(os.path.dirname(cli.__file__), 'config',\n"
        "                    'configs')\n"
        "open('micro.py', 'w').write(\n"
        "    f'_base_ = {base + \"/nerf/jumpingjacks.py\"!r}\\n'\n"
        "    'expname = \"e2e\"\\nbasedir = \"./logs/\"\\n'\n"
        "    f'data = dict(datadir={arm!r}, half_res=False)\\n'\n"
        "    'model_and_render = dict(num_voxels=8 ** 3, '\n"
        "    'num_voxels_base=8 ** 3, voxel_dim=4, defor_depth=2, '\n"
        "    'net_width=16)\\n'\n"
        "    'train_config = dict(N_iters=2, N_rand=32, pg_scale=[], '\n"
        "    'use_occupancy=False)\\n'\n"
        "    'pcd_model_and_render = dict(canonical_pcd_num=100, '\n"
        "    'bone_length=3.0, pcd_density_threshold=0.0, '\n"
        "    'skeleton_density_threshold=0.0, sample_budget=16)\\n'\n"
        "    'pcd_train_config = dict(N_iters=2, N_rand=16, '\n"
        "    'full_t_iter=4)\\n')\n"
        "# tensorboard imports TensorFlow where it is installed, and that jax\n"
        "sys.modules['torch.utils.tensorboard'] = None\n"
        "cli.main(['--config', 'micro.py', '--i_print', '1', '--i_save',\n"
        "          '1000'], device='cpu')\n"
        "assert os.path.isfile('logs/e2e/temporalpoints_last.pkl')\n"
        "cfg = load_config('micro.py')\n"
        "assert len(load_data(cfg.data, cfg)['images']) == 3\n"
        "os.makedirs('spot')\n"
        "for c in list(range(1, 10)) + list(range(11, 20)):\n"
        "    v = np.eye(4); v[2, 3] = -3.0\n"
        "    json.dump({'camera_data': {'intrinsics': {'fx': 8.0,\n"
        "        'fy': 8.0, 'cx': 4.0, 'cy': 4.0},\n"
        "        'camera_view_matrix': v.T.tolist()}},\n"
        "        open(f'spot/cam_{c:03d}.json', 'w'))\n"
        "    write_png(f'spot/frame_00000_cam_{c:03d}.png',\n"
        "              np.full((8, 8, 4), 200, np.uint8))\n"
        "cfg = load_config(base + '/wim/spot.py')\n"
        "cfg.data.update(datadir='spot', video_len=1, wim_size=8)\n"
        "assert load_data(cfg.data, cfg)['images'].shape == (18, 8, 8, 3)\n"
        "img = np.full((3, 8, 8), 9, np.uint8)\n"
        "msk = np.ones((1, 8, 8), np.uint8)\n"
        "pickle.dump({'frame_id': np.arange(2),\n"
        "             'camera_id': np.repeat(np.arange(2), 2),\n"
        "             'img': [img] * 4, 'mask': [msk] * 4,\n"
        "             'camera_intrinsic': [np.eye(3) * 8] * 4,\n"
        "             'camera_rotation': [np.eye(3)] * 4,\n"
        "             'camera_translation': [np.ones((3, 1))] * 4},\n"
        "            open('cache_train.pickle', 'wb'))\n"
        "cfg = load_config(base + '/zju/377.py')\n"
        "cfg.data.update(datadir='cache_train.pickle', video_len=2,\n"
        "                zju_size=8)\n"
        "assert load_data(cfg.data, cfg)['images'].shape == (2, 8, 8, 3)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'apnerf'))\n"
        "assert not bad, bad\n"
        "print('no jax')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "no jax" in res.stdout
