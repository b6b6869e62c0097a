"""Per-model renderers for ``render.render_viewpoints`` (port of
``apnerf/render/renderers.py``).

A renderer is ``for_view(i, t, ...) -> fn``. ``fn(rays_o, rays_d,
viewdirs) -> dict`` renders one chunk of rays (the chunk loop of
``render.render_image``), and its ``finish()`` returns what belongs to the
whole view (the 2D joints for the skeleton overlay) after the budget
audit. ``fn.image_fn(K, c2w, H, W, chunk, inverse_y, flip_x, flip_y)``
renders the whole view at once, as the JAX package's ``lax.scan`` does
(``make_image_scan``): on a CUDA device a view is two CUDA-graph replays,
the frame (``prepare_frame``, the JAX ``prep`` jit) and every chunk with
its rays made on the device; on the CPU the same two bodies run eagerly.
A capture that fails raises: there is no eager fallback on the card.

With ``mesh`` (``parallel.mesh``) the image function splits a view's
chunks over the ranks: rank r renders chunks r, r + n, ... (each chunk
whole, under the single-device chunk's budgets, with no collective inside
a chunk), and one all-gather at the end of the chunk graph gives every
rank the whole view in chunk order; the budget audit's worst chunk is
then taken over all ranks. As in the JAX package, a chunk that does not
divide over the ranks raises (``ValueError``), although the split itself
would not need it. The eager chunk function renders its chunk whole on
every rank. The renderer's model and state are broadcast from rank 0 when
it is built; ``render_viewpoints`` writes on rank 0 only.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..data.rays import pixels_to_rays
from ..models import temporal_points as tp
from ..models import tineuvox
from ..ops.marching import composite
from ..parallel import mesh as pmesh
# the graph machinery the render shares with training, importable here
from ..utils.graphs import GraphedCall, Graphs, load_static  # noqa: F401


def make_image_scan(body: Callable, keys, graphs: Graphs, mesh=None):
    """Whole-image renderer: the rays made on the device, the chunk loop
    as one CUDA graph (the JAX ``lax.scan``); with ``mesh`` the rank's
    chunks and the all-gather of the view (see the module docstring).

    ``body(extra, ro, rd, vd) -> dict``; ``extra`` is whatever the chunks
    read besides the rays (the frame, a time): a graph reads it where it
    lay at capture, so the caller passes the same object for a key and
    refills it in place. Returns ``image_fn(extra, K, c2w, H, W, chunk,
    inverse_y, flip_x, flip_y) -> dict`` of ``keys`` stacked ``[n_chunks,
    chunk, ...]`` (and, as they stand, whatever values of the last chunk
    are no tensors). Every chunk has ``chunk`` rays: the last one repeats
    the last pixel, as the JAX scan pads it. One graph per (extra, H, W,
    chunk, flags); K [3, 3] and c2w [4, 4] go into its static inputs."""
    world, rank = (1, 0) if mesh is None else (mesh.world, mesh.rank)

    def image_fn(extra, K, c2w, H: int, W: int, chunk: int,
                 inverse_y=False, flip_x=False, flip_y=False):
        if chunk % world:
            raise ValueError(f"chunk {chunk} must divide over the "
                             f"{world}-rank mesh")
        # on the card a graph belongs to the ``extra`` it read at capture
        # (the key's id stays unique: the frame graph or the renderer
        # holds the object); on the CPU ``extra`` is passed at every call
        owner = id(extra) if graphs.pool is not None else None
        key = ("scan", owner, H, W, chunk, inverse_y, flip_x, flip_y)

        def make():
            dev = graphs.device
            Kd = torch.zeros((1, 3, 3), device=dev)
            cd = torch.zeros((1, 4, 4), device=dev)
            n = H * W
            n_chunks = -(-n // chunk)
            per = -(-n_chunks // world)           # chunks a rank renders

            def run(extra):
                cam = torch.zeros(chunk, dtype=torch.int64, device=dev)
                ar = torch.arange(chunk, device=dev)
                parts: Dict[str, list] = {k: [] for k in keys}
                last = {}
                for j in range(per):
                    # a rank short of chunks renders the last one again
                    ci = min(j * world + rank, n_chunks - 1)
                    pix = torch.clamp(ci * chunk + ar, max=n - 1)
                    ro, rd, vd = pixels_to_rays(
                        Kd, cd, cam, pix, H, W, inverse_y=inverse_y,
                        flip_x=flip_x, flip_y=flip_y)
                    last = body(extra, ro, rd, vd)
                    for k in keys:
                        if last.get(k) is not None:
                            parts[k].append(last[k])
                out = {k: v for k, v in last.items()
                       if not torch.is_tensor(v)}
                out.update((k, gather(torch.stack(v))) for k, v in
                           parts.items() if v)
                return out

            def gather(x):
                """[per, chunk, ...] of each rank -> [n_chunks, chunk,
                ...] in chunk order."""
                if mesh is None:
                    return x
                x = pmesh.all_gather_flat(x, mesh)
                x = x.view(world, per, *x.shape[1:]).transpose(0, 1)
                return x.reshape(world * per, *x.shape[2:])[:n_chunks]

            return run, (Kd, cd)

        call = graphs.call(key, make)
        Kd, cd = call.inputs
        load_static(Kd, K)
        load_static(cd, c2w)
        return call(extra)

    return image_fn


def chunk_loop(fn: Callable) -> Callable:
    """``fn``'s eager chunk loop: the view's chunk function (and its
    ``finish``) without its image function, so that ``render_image`` runs
    the chunks from Python (the JAX package's tests delete ``image_fn``
    for the same end)."""
    def plain(ro, rd, vd):
        return fn(ro, rd, vd)
    if hasattr(fn, "finish"):
        plain.finish = fn.finish
    return plain


def make_backbone_renderer(model: tineuvox.TiNeuVox, stepsize, near, far, bg,
                           mesh=None):
    """Renderer for the TiNeuVox backbone: ``for_view(i, t)``; its image
    function reads the time from a static input. ``mesh``: the view's
    chunks split over the ranks (see the module docstring)."""
    pmesh.put_replicated(model, mesh)
    n_steps = model.cfg.max_steps(stepsize)
    graphs = Graphs(model.feature.device, thread_local=mesh is not None)
    t_static = torch.zeros(1, device=graphs.device)

    def body(t, ro, rd, vd):
        times = t.reshape(1, 1).expand(ro.shape[0], 1)
        res = tineuvox.forward(model, ro, rd, vd, times, near, far,
                               stepsize, bg, n_steps)
        return {"rgb_marched": res["rgb_marched"], "depth": res["depth"]}

    scan = make_image_scan(body, ("rgb_marched", "depth"), graphs, mesh)

    def for_view(i, t):
        @torch.inference_mode()
        def fn(ro, rd, vd):
            return body(torch.full((1,), float(t), device=ro.device), ro,
                        rd, vd)

        @torch.inference_mode()
        def image_fn(*args):
            t_static.fill_(float(t))
            return scan(t_static, *args)

        fn.image_fn = image_fn
        return fn

    for_view.graphs = graphs
    for_view.mesh = mesh
    return for_view


def _warn_audit(audit) -> None:
    """Budget-audit warning from one [act_demand, act_granted, pass_demand,
    pass_granted] row (a renderer prints it once in its lifetime)."""
    if audit[0] > audit[1] or audit[2] > audit[3]:
        print("render: budget audit — static sampling budgets "
              f"truncated (active {audit[0]}/{audit[1]}, "
              f"radius-pass {audit[2]}/{audit[3]}); raise "
              "active_fraction/pass_fraction if quality "
              "matters more than speed")


def weight_palette(n: int, seed: int = 0) -> np.ndarray:
    """LBS-weight false colours: seaborn's hls palette when installed
    (as the JAX package), else the same hues computed here."""
    try:
        from seaborn import color_palette
        cols = np.array(color_palette("hls", n))
    except ImportError:
        hues = np.linspace(0, 1, n, endpoint=False)
        cols = np.stack([np.abs(hues * 6 - 3) - 1, 2 - np.abs(hues * 6 - 2),
                         2 - np.abs(hues * 6 - 4)], -1).clip(0, 1)
    rng = np.random.default_rng(seed)
    return cols[rng.permutation(n)]


def make_points_renderer(model: tp.TemporalPoints, state, near, far, bg,
                         render_weights: bool = True,
                         render_pcd_direct: bool = False, poses=None,
                         Ks=None, mesh=None):
    """Renderer for a stage-2 point model: ``for_view(i, t,
    rot_params=None)`` renders at time ``t`` or in the pose ``rot_params``
    [J, 4]. A chunk gives ``rgb_marched`` (the direct point-cloud render
    with ``render_pcd_direct``), ``depth``, ``acc`` (accumulated opacity),
    ``weights`` (LBS-weight colours, with ``render_weights``), the chunk's
    ``budget_audit`` row and ``knn_path``. The chunk function ``fn`` warps
    the cloud (``prepare_frame``) at its first call; its ``image_fn``
    replays the frame graph (the time or the pose a static input) and the
    chunk graph and adds the frame's ``joints_warped``. With ``poses`` and
    ``Ks`` the view's ``finish()`` adds ``joints_2d`` and ``bones``. The
    budget audit warns once per renderer, over the worst chunk of its first
    view. ``mesh``: the view's chunks split over the ranks (see the module
    docstring)."""
    pmesh.put_replicated(model, mesh, state)
    cfg = model.cfg
    dev = state["canonical_pcd"].device
    mask = (tp.get_weights(model, state).sum(0) > 0).cpu().numpy()
    cols = np.zeros((cfg.n_joints, 3), np.float32)
    if mask.any():
        cols[mask] = weight_palette(int(mask.sum()))
    cols_dev = torch.as_tensor(cols, device=dev)
    graphs = Graphs(dev, thread_local=mesh is not None)

    def body(frame, ro, rd, vd):
        res = tp.forward(model, state, ro, rd, vd, near=near, far=far, bg=bg,
                         render_depth=True, render_weights=render_weights,
                         render_pcd_direct=render_pcd_direct, frame=frame)
        out = {"rgb_marched": res["rgb_marched"], "depth": res["depth"],
               "acc": res["weights_per_sample"].sum(-1),
               "budget_audit": res["budget_audit"],
               "knn_path": res["knn_path"]}
        if render_pcd_direct:
            out["rgb_marched"] = res["rgb_marched_direct"]
        if render_weights:
            col = torch.einsum("rbj,jc->rbc", res["lbs_w_per_sample"],
                               cols_dev)
            out["weights"] = composite(
                res["weights_for_render"], col, bg=bg,
                alphainv_last=res["alphainv_for_render"])
        return out

    scan = make_image_scan(
        body, ("rgb_marched", "depth", "acc", "weights", "budget_audit"),
        graphs, mesh)

    def graphed_frame(t, rot_params):
        """The frame graph of a time, or of a pose of this shape, with its
        static input refilled."""
        use_rot = rot_params is not None
        key = ("frame", tuple(np.shape(rot_params)) if use_rot else None)

        def make():
            inp = torch.zeros(key[1] or (1,), device=dev)
            return (lambda: tp.prepare_frame(
                model, state, t=None if use_rot else inp,
                rot_params=inp if use_rot else None)), (inp,)

        call = graphs.call(key, make)
        if use_rot:
            load_static(call.inputs[0], rot_params)
        else:
            call.inputs[0].fill_(float(t or 0.0))
        return call()

    def for_view(i, t, rot_params=None):
        use_rot = rot_params is not None
        audits, eager = [], {}

        def eager_frame():
            if "frame" not in eager:
                eager["frame"] = tp.prepare_frame(
                    model, state, t=None if use_rot else float(t or 0.0),
                    rot_params=(torch.as_tensor(
                        rot_params, dtype=torch.float32, device=dev)
                        if use_rot else None))
            return eager["frame"]

        @torch.inference_mode()
        def fn(ro, rd, vd):
            out = body(eager_frame(), ro, rd, vd)
            audits.append(out["budget_audit"])
            return out

        @torch.inference_mode()
        def image_fn(*args):
            frame = graphed_frame(t, rot_params)
            out = dict(scan(frame, *args))
            out["joints_warped"] = frame["joints_warped"]
            return out

        @torch.inference_mode()
        def finish(image: Optional[Dict[str, np.ndarray]] = None
                   ) -> Dict[str, np.ndarray]:
            """``image``: the image path's ``budget_audit`` rows and
            ``joints_warped``, read back; without it, the chunk loop's."""
            if image is None:
                rows = (torch.stack(audits).cpu().numpy() if audits
                        else np.zeros((0, 4)))
                joints = None
            else:
                rows, joints = image["budget_audit"], image["joints_warped"]
            extras = {}
            if not for_view._audited and len(rows):
                # the worst chunk of the whole view: the first chunk is
                # often background with next to no demand
                for_view._audited = True
                _warn_audit(np.max(rows, 0).tolist())
            if poses is not None and Ks is not None and i < len(poses):
                if joints is None:
                    joints = eager_frame()["joints_warped"].cpu()
                j2 = tp.project_points(
                    torch.as_tensor(joints, dtype=torch.float32),
                    torch.as_tensor(np.asarray(poses[i], np.float32)),
                    torch.as_tensor(np.asarray(Ks[i], np.float32)))
                extras["joints_2d"] = j2.numpy()
                extras["bones"] = np.asarray(state["bones"])
            return extras

        fn.image_fn = image_fn
        fn.finish = finish
        return fn

    for_view._audited = False
    for_view.graphs = graphs
    for_view.mesh = mesh
    return for_view


@torch.inference_mode()
def render_view(model: tp.TemporalPoints, state, H: int, W: int, K, c2w,
                t: Optional[float] = None,
                rot_params: Optional[torch.Tensor] = None,
                near: float = 0.5, far: float = 6.0, bg: float = 1.0,
                chunk: int = 8192,
                render_weights: bool = True) -> Dict[str, torch.Tensor]:
    """Render one H x W view at time ``t`` or pose ``rot_params`` ->
    ``rgb`` [H, W, 3], ``depth`` [H, W], ``acc`` [H, W] (accumulated
    opacity), ``weights`` [H, W, 3] (LBS colours, with ``render_weights``),
    ``knn_path`` and the per-chunk ``budget_audit`` rows, as tensors on the
    model's device.

    One view of ``make_points_renderer`` through its image function (on a
    CUDA device: captured and replayed once, so a renderer of its own that
    renders many views pays the capture once)."""
    fn = make_points_renderer(model, state, near, far, bg,
                              render_weights=render_weights)(
        0, t, rot_params=rot_params)
    out = fn.image_fn(K, c2w, H, W, chunk)
    keys = {"rgb": "rgb_marched", "depth": "depth", "acc": "acc"}
    if render_weights:
        keys["weights"] = "weights"
    result = {}
    for k, src in keys.items():
        v = out[src].reshape(-1, *out[src].shape[2:])[:H * W]
        result[k] = v.reshape(H, W, *v.shape[1:])
    result["budget_audit"] = out["budget_audit"]
    result["knn_path"] = out["knn_path"]
    return result
