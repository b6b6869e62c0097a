"""One stage-2 training step in shared k-NN mode (``knn_share`` 8,
``knn_cand`` 12: the subgroup candidates, the per-member top-K ranking and
its one-hot selection) against the JAX kernel path, at ``agg_bf16`` False
and True; scene, comparison and tolerances as test_torch_stage2_step.py."""
import pytest

from test_torch_stage2_step import run_case  # noqa


@pytest.mark.parametrize("bf16", [False, True])
def test_shared_step_vs_jax_kernel_path(bf16, monkeypatch):
    run_case("shared", bf16, monkeypatch)
