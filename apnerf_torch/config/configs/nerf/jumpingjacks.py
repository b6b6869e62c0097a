_base_ = "./default.py"

expname = "jumpingjacks"
basedir = "./logs/dnerf/"

data = dict(
    datadir="./data/dnerf/jumpingjacks",
    dataset_type="dnerf",
    canonical_t=0.0,
    inverse_y=False,
    flip_x=False,
    flip_y=False,
    half_res=True,
)
