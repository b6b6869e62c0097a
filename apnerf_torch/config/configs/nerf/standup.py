_base_ = "./default.py"

expname = "standup"
basedir = "./logs/dnerf/"

data = dict(
    datadir="./data/dnerf/standup",
    dataset_type="dnerf",
    canonical_t=1.0,
    inverse_y=False,
    flip_x=False,
    flip_y=False,
    half_res=True,
)
