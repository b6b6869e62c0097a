"""A whole run on the CPU at a tiny size, the look for a card skipped,
with the timed path broken underneath: ``correct`` must come out false
for each fault that a cell can have, and true for the sound program.

The faults are planted in the program: a step that leaves its state
unchanged (the masked Adam's update does nothing), half of the batch left
out (the loss is the mean over the first half of the rays), and a frame's
answer altered where it is produced (the colour of one pixel of every
chunk moved by 0.01). One chip: no exchange between chips to leave out.
"""
from unittest import mock

import pytest
import torch

from benchmark import run as bench
from benchmark.tests.tiny import tiny_context


def run_cell(workload):
    spec, ctx = tiny_context(workload)
    return bench.execute(ctx, spec)


TRAINING = ["dnerf-stage2-train", "zju-stage1-train", "zju-stage2-train"]


@pytest.mark.parametrize("workload", TRAINING + ["dnerf-repose"])
def test_sound_program_is_correct(workload):
    line = run_cell(workload)
    assert line["correct"], line["checks"]


@pytest.mark.parametrize("workload", TRAINING)
def test_state_left_unchanged(workload):
    from apnerf_torch.train import masked_adam
    with mock.patch.object(masked_adam.MaskedAdam, "apply",
                           lambda self, grads: None):
        line = run_cell(workload)
    assert not line["correct"]
    assert line["checks"]["change_norm_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("workload", TRAINING)
def test_half_the_batch_left_out(workload):
    from apnerf_torch.train import stage1, stage2
    module = stage1 if "stage1" in workload else stage2
    real = module.make_loss_fn

    def half(*args, **kw):
        loss_fn = real(*args, **kw)

        def on_half(batch, *rest):
            n = batch["cam"].shape[0] // 2
            return loss_fn({k: (v[:n] if k in ("rgb", "mask", "cam", "pix",
                                               "time") else v)
                            for k, v in batch.items()}, *rest)
        return on_half
    with mock.patch.object(module, "make_loss_fn", half):
        line = run_cell(workload)
    assert not line["correct"]


def test_answer_altered_where_produced():
    from apnerf_torch.models import temporal_points as tp
    real = tp.forward

    def altered(*args, **kw):
        out = real(*args, **kw)
        rgb = out["rgb_marched"].clone()
        rgb[0] += 0.01
        return dict(out, rgb_marched=rgb)
    with mock.patch.object(tp, "forward", altered):
        line = run_cell("dnerf-repose")
    assert not line["correct"]
    assert torch.isfinite(torch.tensor(line["checks"]["rgb_rmse"]["value"]))
