"""The port's ``train_pcd`` resumed from the JAX package's mid-stage
checkpoint (step 3 of the run of test_torch_stage2_train.py, whose scene
and fixtures this file shares): step 4 runs on the same rays as the JAX
package resumed from the same checkpoint (a JAX checkpoint carries no host
random state, so both start their generators anew), its loss within 1e-3
relative, and the port's checkpoint at step 4 has the JAX pytree
structure."""
import shutil

import numpy as np

import jax

from apnerf.utils import checkpoint as jck
from test_torch_stage2_train import (recorded, run_jax, run_port,  # noqa
                                     setup)


def test_resume_from_jax_checkpoint(setup, recorded, tmp_path):
    jpath, tpath = str(tmp_path / "jax.pkl"), str(tmp_path / "port.pkl")
    run_jax(setup, n_iters=3, ckpt_path=jpath, ckpt_every=3)
    shutil.copy(jpath, tpath)
    for v in recorded.values():
        v.clear()
    _, _, _, jres = run_jax(setup, n_iters=4, ckpt_path=jpath, ckpt_every=2)
    _, _, _, tres = run_port(setup, n_iters=4, ckpt_path=tpath, ckpt_every=2)
    assert len(recorded["jax"]) == len(recorded["port"]) == 2
    np.testing.assert_array_equal(recorded["jax"][-1], recorded["port"][-1])
    assert len(jres["loss"]) == len(tres["loss"]) == 1
    assert np.isfinite(tres["loss"]).all()
    np.testing.assert_allclose(tres["loss"], jres["loss"], rtol=1e-3)
    jp, tp = jck.load_checkpoint(jpath), jck.load_checkpoint(tpath)
    assert jp["global_step"] == tp["global_step"] == 4
    assert jp["model_kwargs"] == tp["model_kwargs"]
    for key in ("params", "opt_state"):
        assert (jax.tree_util.tree_structure(
            jax.tree_util.tree_map(np.asarray, tp[key]))
            == jax.tree_util.tree_structure(
                jax.tree_util.tree_map(np.asarray, jp[key]))), key
