# Default hyperparameters for the D-NeRF synthetic family.
# Values chosen for parity with the reference D-NeRF setup
# (reference configs/nerf/default.py); structure is apnerf's own.

expname = None
basedir = "./logs/"

data = dict(
    datadir=None,
    dataset_type=None,
    load2gpu_on_the_fly=True,
    testskip=1,
    white_bkgd=False,
    half_res=True,
    factor=4,
    ndc=False,
    spherify=False,
    llffhold=8,
    load_depths=False,
    use_bg_points=False,
    add_cam=False,
)

train_config = dict(
    bg_col=1,
    N_iters=20000,
    N_rand=4096,
    lrate_feature=8e-2,
    lrate_featurenet=8e-4,
    lrate_deformation_net=6e-4,
    lrate_forward_warp=6e-4,
    lrate_densitynet=8e-4,
    lrate_timenet=8e-4,
    lrate_rgbnet=8e-4,
    lrate_decay=20,
    ray_sampler="in_maskcache",
    weight_main=1.0,
    weight_entropy_last=0.001,
    weight_rgbper=0.01,
    tv_every=1,
    tv_after=0,
    tv_before=1e9,
    tv_feature_before=10000,
    weight_tv_feature=0,
    pg_scale=[2000, 4000, 6000],
    weight_distortion=5e-2,
    weight_mask_loss=0,
    skip_zero_grad_fields=["feature"],
)

model_and_render = dict(
    num_voxels=160 ** 3,
    num_voxels_base=160 ** 3,
    voxel_dim=12,
    defor_depth=5,
    net_width=128,
    alpha_init=1e-3,
    fast_color_thres=1e-4,
    stepsize=0.5,
    world_bound_scale=1.05,
    no_view_dir=False,
)

_N_ITERS_PCD = 160000
pcd_train_config = dict(
    bg_col=1,
    pose_one_each=True,
    N_iters=_N_ITERS_PCD,
    full_t_iter=_N_ITERS_PCD // 2,
    lrate_decay=_N_ITERS_PCD // 1000,
    # backbone heads
    lrate_rgbnet=1e-4,
    lrate_densitynet=1e-4,
    lrate_featurenet=1e-4,
    lrate_canonical_feat=1e-4,
    # point model
    lrate_gammas=1e-3,
    lrate_weights=1e-4,
    lrate_theta_weight=1e-4,
    lrate_forward_warp=1e-4,
    lrate_joints=1e-5,
    lrate_theta=1e-5,
    lrate_feat_net=1e-3,
    skip_zero_grad_fields=[],
    weight_render=2e2,
    weight_chamfer2D=5e-3,
    weight_arap=5e-3,
    weight_joint_chamfer=1,
    weight_transformation_reg=1e-1,
    weight_tv=1e1,
    weight_sparsity=2e-1,
    re_init_feat=False,
    re_init_mlps=False,
    avg_procrustes=False,
    over_parameterized_rot=True,
    use_global_view_dir=False,
    use_direct_loss=False,
    ray_sampler="random",
    embedding="full",
    pose_embedding_dim=0,
    N_rand=4096 * 2,
)

pcd_model_and_render = dict(
    # Static sampling budgets (additive vs reference): per-ray sample
    # count after occupancy compaction, global fraction of samples fed
    # to the KNN, occupancy-grid resolution.
    sample_budget=192,
    active_fraction=0.30,
    occ_res=64,
    # subgroup-shared KNN + occupancy group width. knn_share=1 keeps the
    # exact per-sample KNN for training parity with the reference; the
    # CLI re-applies these keys at render time, so a model trained exact
    # renders with the shared path by setting e.g. knn_share=16,
    # knn_cand=8, coarse_stride=32.
    knn_share=1,
    knn_cand=12,
    coarse_stride=16,
    stepsize=0.5,
    world_bound_scale=1.05,
    fast_color_thres=1e-4,
    bone_length=10.0,
    pcd_density_threshold=0.05,
    skeleton_density_threshold=0.05,
    canonical_pcd_num=1e4,
    degree_threshold=15,
)
