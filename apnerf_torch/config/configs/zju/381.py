_base_ = "./default.py"

expname = "381"
basedir = "./logs/zju/"

data = dict(
    datadir="./data/zju/381/cache_train.pickle",
    dataset_type="zju",
    canonical_t=0.0,
    video_len=500,
    inverse_y=True,
    flip_x=False,
    flip_y=False,
)
