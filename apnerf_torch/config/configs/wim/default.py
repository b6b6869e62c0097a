# Default hyperparameters for the Watch-It-Move robot family.
# Parity values: reference configs/wim/default.py.
_base_ = "../nerf/default.py"

train_config = dict(
    N_iters=40000,
    lrate_decay=40,
)

model_and_render = dict(
    pre_train_t_num=10,
)

_N_ITERS_PCD = 160000
pcd_train_config = dict(
    pose_one_each=False,
    N_iters=_N_ITERS_PCD,
    full_t_iter=_N_ITERS_PCD // 2,
    lrate_decay=_N_ITERS_PCD // 1000,
)

pcd_model_and_render = dict()
