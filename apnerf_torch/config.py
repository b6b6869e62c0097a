"""Training configs in the duck type that ``train.stage1`` reads: mappings
with attribute access and ``.get`` (as the JAX package's ``ConfigDict``),
without importing the JAX package."""
from __future__ import annotations


class AttrDict(dict):
    """A dict whose keys read as attributes."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e


def nerf_default(**train_overrides) -> AttrDict:
    """The D-NeRF (nerf family) stage-1 defaults of
    ``apnerf/config/configs/nerf/default.py`` (``train_config``,
    ``model_and_render``, the data flags of its scene configs); keyword
    arguments override ``train_config`` entries."""
    data = AttrDict(ndc=False, inverse_y=False, flip_x=False, flip_y=False,
                    add_cam=False)
    train = AttrDict(
        bg_col=1, N_iters=20000, N_rand=4096, lrate_feature=8e-2,
        lrate_featurenet=8e-4, lrate_deformation_net=6e-4,
        lrate_forward_warp=6e-4, lrate_densitynet=8e-4, lrate_timenet=8e-4,
        lrate_rgbnet=8e-4, lrate_decay=20, weight_main=1.0,
        weight_entropy_last=0.001, weight_rgbper=0.01, tv_every=1,
        tv_after=0, tv_before=1e9, tv_feature_before=10000,
        weight_tv_feature=0, pg_scale=[2000, 4000, 6000],
        weight_distortion=5e-2, weight_mask_loss=0,
        skip_zero_grad_fields=["feature"])
    train.update(train_overrides)
    model = AttrDict(
        num_voxels=160 ** 3, num_voxels_base=160 ** 3, voxel_dim=12,
        defor_depth=5, net_width=128, alpha_init=1e-3, fast_color_thres=1e-4,
        stepsize=0.5, world_bound_scale=1.05, no_view_dir=False)
    return AttrDict(data=data, train_config=train, model_and_render=model)
