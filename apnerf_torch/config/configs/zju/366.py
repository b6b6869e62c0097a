_base_ = "./default.py"

expname = "366"
basedir = "./logs/zju/"

data = dict(
    datadir="./data/zju/366/cache_train.pickle",
    dataset_type="zju",
    canonical_t=0.0,
    video_len=623,
    inverse_y=True,
    flip_x=False,
    flip_y=False,
)
