# Default hyperparameters for the ZJU-MoCap human family.
# Parity values: reference configs/zju/default.py.
_base_ = "../nerf/default.py"

train_config = dict(
    bg_col=0,
    N_iters=40000,
    lrate_decay=40,
    weight_mask_loss=5e-2,
)

_N_ITERS_PCD = 160000 * 2
pcd_train_config = dict(
    bg_col=0,
    pose_one_each=False,
    N_iters=_N_ITERS_PCD,
    weight_start_iter=_N_ITERS_PCD // 2,
    full_t_iter=_N_ITERS_PCD // 2,
    lrate_decay=_N_ITERS_PCD // 1000,
    pose_embedding_dim=64,
)

pcd_model_and_render = dict(
    # Static sampling budgets (additive vs reference): per-ray sample
    # count after occupancy compaction, global fraction of samples fed
    # to the KNN, occupancy-grid resolution. The larger masked-human
    # budgets here are provisional pending real ZJU data.
    sample_budget=256,
    active_fraction=0.3,
    occ_res=64,
    skeleton_density_threshold=0.1,
)
