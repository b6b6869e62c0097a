"""What test_torch_cli_train.py and test_torch_cli_render.py share (not a
test module): tests/test_cli_e2e.py's micro scene (3 times, 1 test view,
32 x 32, written by the JAX ``generate_scene``) and micro config, for
each package a working directory of its own holding ``micro.py`` (the
same values over that package's ``nerf/jumpingjacks.py``; ``basedir``
and the tensorboard logs relative to it), and the JAX command line run
there. The stage-2 budgets are as in test_torch_stage2_train.py
(``sample_budget`` 32, ``active_fraction`` / ``pass_fraction`` 1), so
that both packages render the same samples, and stage 2 takes four steps
(test_torch_stage2_model.py's trajectory)."""
import contextlib
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from apnerf.data.synthetic import generate_scene
from apnerf.models import tineuvox as jt
from apnerf_torch.models import tineuvox as tt
from apnerf_torch.utils import checkpoint as tck

REPO = Path(__file__).resolve().parent.parent
BASES = {"jax": REPO / "apnerf" / "config" / "configs" / "nerf",
         "port": REPO / "apnerf_torch" / "config" / "configs" / "nerf"}
MICRO = """
_base_ = {base!r}
expname = "cli_e2e"
basedir = "./logs/"
data = dict(datadir={scene!r}, half_res=False)
model_and_render = dict(num_voxels=20 ** 3, num_voxels_base=20 ** 3)
train_config = dict(N_iters=10, N_rand=128, pg_scale=[],
                    use_occupancy=False)
pcd_model_and_render = dict(canonical_pcd_num=200, bone_length=5.0,
                            pcd_density_threshold=0.0,
                            skeleton_density_threshold=0.0,
                            sample_budget=32, active_fraction=1.0,
                            pass_fraction=1.0)
pcd_train_config = dict(N_iters=4, N_rand=64, full_t_iter=6)
"""
LOG = ["--i_print", "1", "--i_save", "1000"]
RUN_DIR = Path("logs") / "cli_e2e"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """PyTorch on one thread for the test module that imports this
    fixture (autouse there): under the suite's six
    workers the port's many small CPU operations otherwise wait on
    oversubscribed threads (a test file took five times as long)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_dirs(root):
    """(scene, {package: working directory with micro.py})."""
    scene = generate_scene(str(root / "scene" / "arm"), n_times=3,
                           n_test=1, H=32, W=32)
    dirs = {}
    for pkg, base in BASES.items():
        d = root / pkg
        d.mkdir()
        (d / "micro.py").write_text(MICRO.format(
            base=str(base / "jumpingjacks.py"), scene=scene))
        dirs[pkg] = d
    return scene, dirs


@contextlib.contextmanager
def working_dir(path):
    cwd = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(cwd)


@contextlib.contextmanager
def jax_compile_cache(path):
    """The JAX ``cli.main`` sets a persistent compile cache from
    ``APNERF_JAXCACHE``: point it at ``path`` and give the process back
    its settings afterwards."""
    old = (jax.config.jax_compilation_cache_dir,
           jax.config.jax_persistent_cache_min_compile_time_secs,
           os.environ.get("APNERF_JAXCACHE"))
    os.environ["APNERF_JAXCACHE"] = str(path)
    try:
        yield
    finally:
        jax.config.update("jax_compilation_cache_dir", old[0])
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          old[1])
        if old[2] is None:
            os.environ.pop("APNERF_JAXCACHE", None)
        else:
            os.environ["APNERF_JAXCACHE"] = old[2]


def jax_cli(workdir, argv, cache):
    from apnerf import cli as jcli
    with working_dir(workdir), jax_compile_cache(cache):
        jcli.main(["--config", "micro.py"] + argv)


def port_cli(workdir, argv):
    from apnerf_torch import cli as tcli
    with working_dir(workdir):
        tcli.main(["--config", "micro.py"] + argv, device="cpu")


def jax_init(mcfg, generator, device=None):
    """The port's stage-1 init made the JAX ``init_params`` at the CLI's
    seed 0 (jax.random.PRNGKey(0))."""
    jc = jt.TiNeuVoxConfig(**mcfg.get_kwargs())
    model = tt.TiNeuVox(tt.TiNeuVoxConfig(**jc.get_kwargs()))
    params = jt.init_params(jax.random.PRNGKey(0), jc)
    model.load_state_dict(tck.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return model.to(device)


def read_results(path):
    """``results.txt`` as {metric: value}."""
    out = {}
    for line in Path(path).read_text().splitlines():
        k, v = line.split(":")
        out[k.strip()] = float(v)
    return out
