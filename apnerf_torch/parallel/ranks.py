"""Rank programs: a port function run on every rank of a process group.

``spawn(world, program, **kwargs)`` starts ``world`` processes (gloo on
the CPU, a file store under ``store_dir`` as the rendezvous; NCCL with
``device="cuda"``, one card a rank), runs ``program(mesh=<the rank's
mesh>, **kwargs)`` on each and returns the ranks' results in rank order.
A rank that fails, or that does not finish within ``timeout`` seconds,
stops the others and raises. The programs below return numpy, so that
their results pickle back; each also runs in one process with
``mesh=None``, the single-device run they are held against. This module
imports no jax, so a spawned rank never loads it.
"""
from __future__ import annotations

import os
import pickle
import tempfile
import time
import traceback
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch


def _rank_main(rank: int, world: int, store_path: str, device: str,
               program: Callable, kwargs: Dict[str, Any],
               out_dir: str) -> None:
    from . import distributed, mesh as pmesh
    torch.set_num_threads(1)
    result: Any
    try:
        distributed.initialize(world, rank, store_path=store_path,
                               device=device)
        result = program(mesh=pmesh.make_mesh(world), **kwargs)
        ok = True
    except BaseException:
        result, ok = traceback.format_exc(), False
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump((ok, result), f)
    distributed.shutdown()
    if not ok:
        raise SystemExit(1)


def spawn(world: int, program: Callable, store_dir: Optional[str] = None,
          device: str = "cpu", timeout: float = 600.0, **kwargs) -> List:
    """``program(mesh=..., **kwargs)`` on ``world`` spawned ranks -> the
    ranks' results, rank 0 first."""
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(dir=store_dir) as d:
        store = os.path.join(d, "store")
        procs = [ctx.Process(target=_rank_main, args=(
            r, world, store, device, program, kwargs, d), daemon=True)
            for r in range(world)]
        for p in procs:
            p.start()
        t0 = time.time()
        try:
            while any(p.is_alive() for p in procs):
                failed = [p for p in procs
                          if p.exitcode not in (None, 0)]
                if failed or time.time() - t0 > timeout:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                p.join()
        results, errors = [], []
        for r in range(world):
            path = os.path.join(d, f"rank{r}.pkl")
            if not os.path.isfile(path):
                errors.append(f"rank {r}: no result (exit code "
                              f"{procs[r].exitcode})")
                continue
            with open(path, "rb") as f:
                ok, res = pickle.load(f)
            (results if ok else errors).append(
                res if ok else f"rank {r}:\n{res}")
        if errors:
            raise RuntimeError("spawned ranks failed:\n" + "\n".join(errors))
        return results


# ---------------------------------------------------------------------------
# programs
# ---------------------------------------------------------------------------

def _np_state(module: torch.nn.Module) -> Dict[str, np.ndarray]:
    return {k: v.detach().float().cpu().numpy()
            for k, v in module.state_dict().items()}


@contextmanager
def record_survivors(store: List):
    """Record what every static-budget compaction keeps: (its ``src`` in
    order, the entries that asked for a slot) of
    ``ops.compaction.compact_flat`` (stage 1) and
    ``models.temporal_points._budget_compact`` (stage 2). A budget binds
    where the second is above the first's length."""
    from ..models import temporal_points as tp
    from ..ops import compaction
    flat, budget = compaction.compact_flat, tp._budget_compact

    def compact_flat(valid, n):
        src, filled = flat(valid, n)
        store.append((src.detach().cpu().numpy(), int(valid.sum())))
        return src, filled

    def budget_compact(keep, values, n, fill):
        out = budget(keep, values, n, fill)
        store.append((out.detach().cpu().numpy(), int(keep.sum())))
        return out

    compaction.compact_flat, tp._budget_compact = compact_flat, \
        budget_compact
    try:
        yield store
    finally:
        compaction.compact_flat, tp._budget_compact = flat, budget


def train_stage1(mesh=None, cfg=None, data=None, init_state=None,
                 ckpt_path=None, **kw) -> Dict[str, Any]:
    """``stage1.scene_rep_reconstruction`` on the CPU -> the parameters,
    the stats and the compactions' survivors. ``init_state``: the model's
    initial ``state_dict`` (numpy), in place of the seeded init."""
    from ..models import tineuvox
    from ..train import stage1
    init = tineuvox.init_model
    if init_state is not None:
        def init_from(mcfg, generator, device=None):
            model = tineuvox.TiNeuVox(mcfg)
            model.load_state_dict({k: torch.as_tensor(v)
                                   for k, v in init_state.items()})
            return model.to(device)
        tineuvox.init_model = init_from
    srcs: List[np.ndarray] = []
    try:
        with record_survivors(srcs):
            model, _, stats = stage1.scene_rep_reconstruction(
                cfg, data, mesh=mesh, device="cpu", ckpt_path=ckpt_path,
                **kw)
    finally:
        tineuvox.init_model = init
    return {"params": _np_state(model), "stats": stats, "srcs": srcs}


def train_stage2(mesh=None, cfg=None, data=None, canonical=None,
                 skeleton=None, heads=None, tcfg=None, bbox=None,
                 init_state=None, **kw) -> Dict[str, Any]:
    """``stage2.train_pcd`` on the CPU -> the parameters, the stats, the
    survivors and the printed budget audit. ``init_state``: the model's
    initial ``state_dict`` (numpy), loaded after ``build_model``."""
    import contextlib
    import io
    from ..train import stage2
    build = stage2.build_model
    if init_state is not None:
        def build_from(*args, **kwargs):
            mcfg, model, state = build(*args, **kwargs)
            model.load_state_dict({k: torch.as_tensor(v)
                                   for k, v in init_state.items()})
            return mcfg, model, state
        stage2.build_model = build_from
    srcs: List[np.ndarray] = []
    out = io.StringIO()
    try:
        with record_survivors(srcs), contextlib.redirect_stdout(out):
            model, _, _, stats = stage2.train_pcd(
                cfg, data, canonical, skeleton, heads, tcfg, bbox,
                mesh=mesh, device="cpu", **kw)
    finally:
        stage2.build_model = build
    audit = [l for l in out.getvalue().splitlines() if "budget audit" in l]
    return {"params": _np_state(model), "stats": stats, "srcs": srcs,
            "audit": audit}


@contextmanager
def local_group(store_dir: str, device: str = "cpu"):
    """A one-rank group in this process (gloo on the CPU, a file store in
    ``store_dir``) -> its mesh; the group is left on exit."""
    from . import distributed, mesh as pmesh
    distributed.initialize(1, 0, store_path=os.path.join(store_dir,
                                                         "store1"),
                           device=device)
    try:
        yield pmesh.make_mesh(1)
    finally:
        distributed.shutdown()


def render_views(mesh=None, model=None, state=None, views=(), chunk=64,
                 renderer_kw=None, extra_keys=(), bad_chunk=None
                 ) -> Dict[str, Any]:
    """Views through ``render.render_image`` with the image function of
    ``make_points_renderer`` (``state`` given) or ``make_backbone_renderer``
    -> the images (``views``: (i, t, K, c2w, H, W) each) and, with
    ``bad_chunk``, the error a render at that chunk raised."""
    from ..render import render, renderers
    kw = dict(renderer_kw or {})
    if state is not None:
        for_view = renderers.make_points_renderer(model, state, mesh=mesh,
                                                  **kw)
    else:
        for_view = renderers.make_backbone_renderer(model, mesh=mesh, **kw)
    images = [render.render_image(for_view(i, t), K, c2w, H, W,
                                  chunk=chunk, extra_keys=extra_keys,
                                  device="cpu")
              for i, t, K, c2w, H, W in views]
    error = None
    if bad_chunk is not None:
        i, t, K, c2w, H, W = views[0]
        try:
            render.render_image(for_view(i, t), K, c2w, H, W,
                                chunk=bad_chunk, device="cpu")
        except ValueError as e:
            error = f"ValueError: {e}"
    return {"images": images, "error": error}


class _Leaves(torch.nn.Module):
    """One parameter a name, copies of the arrays of ``values``."""

    def __init__(self, values: Dict[str, np.ndarray]):
        super().__init__()
        for name, v in values.items():
            self.register_parameter(name, torch.nn.Parameter(
                torch.tensor(v)))


def adam_updates(mesh=None, params=None, grads=(), cfg_train=None,
                 zero1_min_size=None) -> Dict[str, Any]:
    """``MaskedAdam`` updates of the parameters ``params`` (name -> array)
    with the gradients ``grads`` (a list of steps, each a list over the
    ranks of name -> array: this rank's part; without a mesh their sum)
    -> the parameters, the moments this rank holds, the whole moments of
    ``state_to_jax`` and the moments after ``load_state_from_jax`` of
    them."""
    from ..train.masked_adam import MaskedAdam
    model = _Leaves(params)
    kw = {} if zero1_min_size is None else {"zero1_min_size": zero1_min_size}
    opt = MaskedAdam(model, cfg_train, mesh=mesh, **kw)
    for parts in grads:
        if mesh is None:
            g = {n: torch.as_tensor(sum(p[n] for p in parts)) for n in params}
        else:
            g = {n: torch.as_tensor(v) for n, v in parts[mesh.rank].items()}
        opt.update(opt.reduce(g))
    held = {n: m.numpy().copy() for n, m in opt.mu.items()}
    saved = opt.state_to_jax()
    opt.load_state_from_jax(saved)
    return {"params": _np_state(model), "held_mu": held,
            "split": dict(opt.split), "saved": saved,
            "reloaded_mu": {n: m.numpy().copy() for n, m in opt.mu.items()}}


def collectives(mesh=None, x=None, w=None) -> Dict[str, Any]:
    """``shard_rows`` of a differentiable row function over ``x`` [n, d]
    (``w`` [d, e] replicated) and a ``count_once`` term: the output, the
    loss and ``w``'s gradient summed over the ranks."""
    from . import mesh as pmesh
    xt = torch.as_tensor(x)
    wt = torch.as_tensor(w).requires_grad_(True)
    y = pmesh.shard_rows(mesh, lambda a: torch.tanh(a @ wt), xt)
    loss = (y ** 2).sum() + pmesh.count_once((wt ** 2).sum(), mesh)
    loss.backward()
    g = wt.grad
    if mesh is not None:
        g = pmesh.all_reduce_(g.clone(), mesh)
    return {"y": y.detach().numpy(), "loss": float(loss.detach()),
            "grad": g.numpy()}


def train_steps(mesh=None, stage=1, setup=None, n_steps=2,
                zero1_min_sizes=(None,)) -> List[Dict[str, Any]]:
    """``n_steps`` eager steps (``make_train_step``) of stage 1 or 2 from
    ``setup`` (``model``, ``cfg_train``, the step's other arguments
    ``args`` / ``kw``, stage 2 its ``state``, the ``batch``), once for
    each ZeRO-1 minimum of ``zero1_min_sizes`` (``MaskedAdam(mesh=,
    zero1_min_size=)``; ``None``: the moments replicated), each from a
    copy of ``setup`` -> per run the losses, the parameters after each
    step and the moments this rank holds."""
    import copy
    from ..train import stage1, stage2
    from ..train.masked_adam import MaskedAdam
    runs = []
    for min_size in zero1_min_sizes:
        s = copy.deepcopy(setup)
        model = s["model"]
        opt = MaskedAdam(model, s["cfg_train"], mesh=mesh,
                         zero1_min_size=min_size)
        if stage == 1:
            step = stage1.make_train_step(model, s["cfg_train"], opt,
                                          *s["args"], **s["kw"])
        else:
            step = stage2.make_train_step(model, s["state"], s["cfg_train"],
                                          opt, *s["args"], **s["kw"])
        losses, params = [], []
        for _ in range(n_steps):
            if stage == 1:
                loss, _ = step(s["batch"], True, s.get("occ"))
            else:
                loss = step(s["batch"])["loss"]
            losses.append(float(loss))
            params.append(_np_state(model))
        runs.append({"losses": losses, "params": params,
                     "held_mu": {n: m.numpy().copy()
                                 for n, m in opt.mu.items()},
                     "split": dict(opt.split)})
    return runs


def broadcast_check(mesh=None) -> Dict[str, Any]:
    """A module, a bool tensor and a transposed (not contiguous) one made
    differently on each rank, then put replicated; this rank's slice of a
    batch of 8 and the error of one of 7 rays."""
    from . import distributed, mesh as pmesh
    torch.manual_seed(mesh.rank)
    m = torch.nn.Linear(3, 2)
    extra = {"occ": torch.rand(16) > 0.5, "frames": torch.rand(4, 3).t(),
             "n": 3}
    pmesh.put_replicated(m, mesh, extra)
    try:
        distributed.local_batch_slice(7)
        ragged = "no error"
    except ValueError as e:
        ragged = f"ValueError: {e}"
    return {"w": m.weight.detach().numpy(), "occ": extra["occ"].numpy(),
            "frames": extra["frames"].numpy(),
            "slice": distributed.local_batch_slice(8), "writer": pmesh.writer(mesh),
            "ragged": ragged}


def cli_main(mesh=None, argv=(), workdir=None) -> Dict[str, Any]:
    """``cli.main(argv, device="cpu")`` in ``workdir`` (a rank joins the
    group it runs in) -> what each ``render_viewpoints`` call returned
    (its images and PSNRs)."""
    from .. import cli
    from ..render import render as rmod
    real, store = rmod.render_viewpoints, []

    def recorded(*args, **kwargs):
        out = real(*args, **kwargs)
        store.append({"rgbs": out["rgbs"], "psnrs": out["psnrs"]})
        return out

    cwd = os.getcwd()
    os.chdir(workdir)
    rmod.render_viewpoints = recorded
    try:
        cli.main(list(argv), device="cpu")
    finally:
        rmod.render_viewpoints = real
        os.chdir(cwd)
    return {"renders": store}
