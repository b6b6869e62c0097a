"""Training configs in the duck type that ``train.stage1`` and
``train.stage2`` read: mappings with attribute access and ``.get`` (as the
JAX package's ``ConfigDict``), the port's own copy of the defaults."""
from __future__ import annotations


class AttrDict(dict):
    """A dict whose keys read as attributes."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e


def nerf_default(**train_overrides) -> AttrDict:
    """The D-NeRF (nerf family) defaults of
    ``apnerf/config/configs/nerf/default.py``: stage 1's ``train_config``
    and ``model_and_render``, stage 2's ``pcd_train_config`` and
    ``pcd_model_and_render``, and the data keys both stages read (as the
    family's scene configs set them, ``canonical_t`` 0); keyword arguments
    override ``train_config`` entries."""
    data = AttrDict(ndc=False, inverse_y=False, flip_x=False, flip_y=False,
                    add_cam=False, canonical_t=0.0)
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
    n_pcd = 160000
    pcd_train = AttrDict(
        bg_col=1, pose_one_each=True, N_iters=n_pcd, full_t_iter=n_pcd // 2,
        lrate_decay=n_pcd // 1000, lrate_rgbnet=1e-4, lrate_densitynet=1e-4,
        lrate_featurenet=1e-4, lrate_canonical_feat=1e-4, lrate_gammas=1e-3,
        lrate_weights=1e-4, lrate_theta_weight=1e-4,
        lrate_forward_warp=1e-4, lrate_joints=1e-5, lrate_theta=1e-5,
        lrate_feat_net=1e-3, skip_zero_grad_fields=[], weight_render=2e2,
        weight_chamfer2D=5e-3, weight_arap=5e-3, weight_joint_chamfer=1,
        weight_transformation_reg=1e-1, weight_tv=1e1,
        weight_sparsity=2e-1, re_init_feat=False, re_init_mlps=False,
        avg_procrustes=False, over_parameterized_rot=True,
        use_global_view_dir=False, use_direct_loss=False,
        ray_sampler="random", embedding="full", pose_embedding_dim=0,
        N_rand=4096 * 2)
    pcd_model = AttrDict(
        sample_budget=192, active_fraction=0.30, occ_res=64, knn_share=1,
        knn_cand=12, coarse_stride=16, stepsize=0.5, world_bound_scale=1.05,
        fast_color_thres=1e-4, bone_length=10.0, pcd_density_threshold=0.05,
        skeleton_density_threshold=0.05, canonical_pcd_num=1e4,
        degree_threshold=15)
    return AttrDict(data=data, train_config=train, model_and_render=model,
                    pcd_train_config=pcd_train,
                    pcd_model_and_render=pcd_model)
