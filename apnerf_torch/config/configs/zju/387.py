_base_ = "./default.py"

expname = "387"
basedir = "./logs/zju/"

data = dict(
    datadir="./data/zju/387/cache_train.pickle",
    dataset_type="zju",
    canonical_t=0.0,
    video_len=523,
    inverse_y=True,
    flip_x=False,
    flip_y=False,
)
