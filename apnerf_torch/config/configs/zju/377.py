_base_ = "./default.py"

expname = "377"
basedir = "./logs/zju/"

data = dict(
    datadir="./data/zju/377/cache_train.pickle",
    dataset_type="zju",
    canonical_t=0.0,
    video_len=493,
    inverse_y=True,
    flip_x=False,
    flip_y=False,
)
