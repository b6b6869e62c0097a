"""The port's config system and config files against the JAX package's:
every shipped config file loads to the same mapping (key by key, values
equal, ``_base_`` chains resolved) and dumps to the same text;
``ConfigDict`` reads and writes attributes; ``nerf_default`` agrees with
``nerf/default.py`` on every key they share."""
from pathlib import Path

import pytest

from apnerf.config import config as jconfig
from apnerf_torch.config import AttrDict, ConfigDict, nerf_default
from apnerf_torch.config import config as tconfig

REPO = Path(__file__).resolve().parent.parent
JAX_DIR = REPO / "apnerf" / "config" / "configs"
PORT_DIR = Path(tconfig.builtin_config_dir())
FILES = sorted(str(p.relative_to(JAX_DIR)) for p in JAX_DIR.glob("*/*.py"))


def plain(x):
    """Nested dicts of the mapping (the classes differ by package)."""
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(plain(v) for v in x)
    return x


def test_every_config_file_is_ported():
    assert len(FILES) == 22
    assert FILES == sorted(str(p.relative_to(PORT_DIR))
                           for p in PORT_DIR.glob("*/*.py"))


@pytest.mark.parametrize("name", FILES)
def test_config_file_vs_jax(name, tmp_path):
    """Equal mappings, key by key, and the same ``dump_config`` text."""
    want = jconfig.load_config(str(JAX_DIR / name))
    got = tconfig.load_config(str(PORT_DIR / name))
    assert isinstance(got, ConfigDict)
    assert plain(got) == plain(want)
    for section, value in want.items():
        if isinstance(value, dict):
            assert isinstance(got[section], ConfigDict), section
            assert set(got[section]) == set(value), section
    jconfig.dump_config(want, str(tmp_path / "jax.py"))
    tconfig.dump_config(got, str(tmp_path / "port.py"))
    text = (tmp_path / "port.py").read_text()
    assert text == (tmp_path / "jax.py").read_text()
    # the dump loads back to the same mapping
    assert plain(tconfig.load_config(str(tmp_path / "port.py"))) \
        == plain(got)


def test_base_chains_resolve():
    """zju/366.py -> zju/default.py -> nerf/default.py: each level's keys
    win over its base's, the rest is inherited."""
    cfg = tconfig.load_config(str(PORT_DIR / "zju" / "366.py"))
    assert "_base_" not in cfg
    assert cfg.data.video_len == 623 and cfg.expname == "366"   # 366.py
    assert cfg.train_config.bg_col == 0                         # zju
    assert cfg.pcd_model_and_render.sample_budget == 256        # zju
    assert cfg.model_and_render.num_voxels == 160 ** 3          # nerf
    assert cfg.pcd_train_config.lrate_joints == 1e-5            # nerf
    wim = tconfig.load_config(str(PORT_DIR / "wim" / "nao.py"))
    assert wim.train_config.N_iters == 40000                    # wim
    assert wim.train_config.N_rand == 4096                      # nerf
    assert wim.data.dataset_type == "wim"


def test_config_dict_attributes():
    """Attribute reads and writes, as the command line makes them
    (``cfg.data.skip_images = ...``, ``cfg.basedir += ...``)."""
    cfg = tconfig.load_config(str(PORT_DIR / "nerf" / "jumpingjacks.py"))
    cfg.data.skip_images = True
    cfg.basedir += "_x"
    assert cfg["data"]["skip_images"] is True
    assert cfg.basedir == "./logs/dnerf/_x"
    assert cfg.get("missing") is None and cfg.get("missing", 3) == 3
    with pytest.raises(AttributeError):
        cfg.missing
    copy = cfg.copy()
    copy.data.half_res = False
    assert cfg.data.half_res is True
    assert AttrDict is ConfigDict


def test_nerf_default_vs_config_file():
    """``nerf_default()`` (the defaults for configs built in code) equals
    ``nerf/default.py`` on every key both have; what it adds is the data
    keys a scene config sets."""
    want = tconfig.load_config(str(PORT_DIR / "nerf" / "default.py"))
    got = nerf_default()
    assert isinstance(got, ConfigDict)
    for section, values in got.items():
        extra = set(values) - set(want[section])
        if section == "data":
            assert extra == {"inverse_y", "flip_x", "flip_y", "canonical_t"}
        else:
            assert not extra, (section, extra)
        for k in set(values) & set(want[section]):
            assert values[k] == want[section][k], (section, k)
    assert nerf_default(N_iters=7).train_config.N_iters == 7
