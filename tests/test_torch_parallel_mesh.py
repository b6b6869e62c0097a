"""The port's ray mesh (``apnerf_torch.parallel``) on gloo ranks spawned on
the CPU (a file store under ``tmp_path`` as the rendezvous, so that the
suite's workers never share a port).

* The ZeRO-1 split against the JAX package's rule: a moment leaf under
  ``ZERO1_MIN_SIZE`` (8,192) stays replicated, a larger one is split
  ceil(n / world) elements a rank (the JAX package splits the first axis
  that divides; the flattened range takes any leaf, a ragged one padded).
* ``MaskedAdam`` on 2 and 4 ranks, ZeRO-1 on: each rank holds 1/world of
  the large leaves' moments; after three updates the parameters and the
  whole moments equal the single-process optimizer's given the sum of the
  ranks' gradients, exactly (the ranks' parts have disjoint supports, so
  their fp32 sum is exact). The skip-field mask reads the summed
  gradient: rank 0's part is zero wherever rank 1's is not.
  ``state_to_jax`` gathers the single-device format and
  ``load_state_from_jax`` gives each rank its range back.
* ``shard_rows`` (with a row count that does not divide over the ranks)
  and ``count_once``: the gathered rows, the loss and the summed gradient
  equal the single-process ones at rtol 1e-6.
* ``local_batch_slice`` and the rank-0 broadcast of ``put_replicated``
  (parameters, a bool tensor, a transposed one).
"""
import numpy as np
import pytest
import torch

from apnerf.parallel import mesh as jmesh
from apnerf_torch.parallel import mesh as pmesh, ranks


@pytest.mark.parametrize("shape,world", [((16, 16, 16, 4), 8),
                                         ((3, 24, 5), 8), ((3, 5, 7), 8),
                                         ((16,), 8), ((64, 256), 2),
                                         ((17, 1031), 4), ((90, 91), 4)])
def test_zero1_split(shape, world):
    n = int(np.prod(shape))
    got = pmesh.zero1_split(n, world)
    # the JAX rule at its default minimum keeps the same leaves replicated
    replicated = jmesh._zero1_spec(shape, world,
                                   jmesh.ZERO1_MIN_SIZE) == jmesh.P()
    if n < pmesh.ZERO1_MIN_SIZE:
        assert got is None and replicated
    else:
        assert got == -(-n // world)
        assert got * world - n < world


def _adam_case(world, seed=0):
    rng = np.random.default_rng(seed)
    params = {"feature": rng.normal(size=(32, 320)).astype(np.float32),
              "net": rng.normal(size=(17, 1031)).astype(np.float32),
              "small": rng.normal(size=(4, 5)).astype(np.float32)}
    steps = []
    for _ in range(3):
        parts = [{} for _ in range(world)]
        for name, v in params.items():
            g = rng.normal(size=v.shape).astype(np.float32) * 1e-3
            if name == "feature":
                g[rng.random(v.shape) < 0.4] = 0.0   # untouched voxels
            owner = rng.integers(0, world, v.shape)
            for r in range(world):
                parts[r][name] = np.where(owner == r, g, 0.0).astype(
                    np.float32)
        steps.append(parts)
    cfg = {"lrate_decay": 0.02, "lrate_feature": 0.08, "lrate_net": 1e-3,
           "lrate_small": 1e-2, "skip_zero_grad_fields": ["feature"]}
    return params, steps, cfg


@pytest.mark.parametrize("world", [2, 4])
def test_zero1_adam_matches_single(world, tmp_path):
    params, steps, cfg = _adam_case(world)
    want = ranks.adam_updates(params=params, grads=steps, cfg_train=cfg)
    got = ranks.spawn(world, ranks.adam_updates, store_dir=str(tmp_path),
                      params=params, grads=steps, cfg_train=cfg)
    for r, res in enumerate(got):
        assert set(res["split"]) == {"feature", "net"}
        for name, v in params.items():
            held = res["held_mu"][name]
            if name == "small":
                assert held.shape == v.shape            # replicated
            else:
                assert held.size == -(-v.size // world)   # 1/world
                lo = r * held.size
                whole = want["held_mu"][name].reshape(-1)
                np.testing.assert_array_equal(
                    held[:max(0, min(held.size, v.size - lo))],
                    whole[lo:lo + held.size], err_msg=name)
            np.testing.assert_array_equal(res["params"][name],
                                          want["params"][name], err_msg=name)
            np.testing.assert_array_equal(res["reloaded_mu"][name],
                                          res["held_mu"][name], err_msg=name)
        for attr in ("mu", "nu"):
            for name in params:
                np.testing.assert_array_equal(
                    np.asarray(res["saved"][attr][name]),
                    np.asarray(want["saved"][attr][name]),
                    err_msg=f"{attr} {name}")
        assert int(res["saved"]["count"]) == 3
    # the skip mask read the summed gradient: entries that rank 0 did not
    # touch moved all the same
    moved = got[0]["params"]["feature"] != params["feature"]
    zero_on_0 = steps[0][0]["feature"] == 0
    assert (moved & zero_on_0).any()


def test_shard_rows_and_count_once(tmp_path):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(23, 5)).astype(np.float32)     # 23 rows: ragged
    w = rng.normal(size=(5, 4)).astype(np.float32)
    want = ranks.collectives(x=x, w=w)
    for world in (2, 4):
        for res in ranks.spawn(world, ranks.collectives,
                               store_dir=str(tmp_path), x=x, w=w):
            np.testing.assert_allclose(res["y"], want["y"], rtol=1e-6)
            np.testing.assert_allclose(res["loss"], want["loss"], rtol=1e-6)
            np.testing.assert_allclose(res["grad"], want["grad"], rtol=1e-6,
                                       atol=1e-7)


def test_put_replicated_and_batch_slice(tmp_path):
    got = ranks.spawn(2, ranks.broadcast_check, store_dir=str(tmp_path))
    np.testing.assert_array_equal(got[0]["w"], got[1]["w"])
    np.testing.assert_array_equal(got[0]["occ"], got[1]["occ"])
    np.testing.assert_array_equal(got[0]["frames"], got[1]["frames"])
    assert [g["slice"] for g in got] == [(0, 4), (4, 4)]
    assert [g["writer"] for g in got] == [True, False]
    assert all(g["ragged"].startswith("ValueError") for g in got)
