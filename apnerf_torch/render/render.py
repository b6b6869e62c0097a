"""Image / video rendering and the evaluation loop (port of
``apnerf/render/render.py``): chunked full-image rendering for either
model family, PSNR / SSIM / LPIPS accumulation, ``results.txt``, per-frame
PNGs, and the skeleton overlay on the LBS-weight renders.

Images are written through the port's own PNG codec (``utils.png``);
``imageio`` and ``cv2`` are optional: ``write_video`` takes the first
encoder that imports, and ``cv2`` draws the skeleton overlay.
"""
from __future__ import annotations

import os
from typing import Callable, Dict

import numpy as np
import torch

from .. import resolve_device
from ..data.rays import pixels_to_rays
from ..parallel import mesh as pmesh
from ..utils import png, profiling
from . import metrics

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


# what an image function gives for the whole view, not per pixel
# (``renderers.make_points_renderer``): read back with the pixels and handed
# to ``finish``
VIEW_KEYS = ("budget_audit", "joints_warped")


def _read_back(tensors: Dict[str, torch.Tensor]):
    """Start copying ``tensors`` to the host -> (host tensors, the event
    that marks the copies done). CUDA tensors go to pinned memory with
    copies queued behind the work that makes them; CPU tensors are
    already there (no event)."""
    if not any(v.is_cuda for v in tensors.values()):
        return tensors, None
    host = {}
    for k, v in tensors.items():
        host[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
        host[k].copy_(v, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


@torch.inference_mode()
def render_image(render_chunk: Callable, K, c2w, H: int, W: int,
                 chunk: int = 8192, inverse_y=False, flip_x=False,
                 flip_y=False, extra_keys=(), device=None, async_out=False):
    """Render one full image -> numpy arrays [H, W(, C)].

    ``render_chunk(rays_o, rays_d, viewdirs) -> dict`` with at least
    ``rgb_marched`` [B, 3] and ``depth`` [B]. Where it has an
    ``image_fn`` (``renderers.make_image_scan``) the whole image is that
    one call (on a CUDA device two graph replays), else the rays are made
    on ``device`` (``None``: the CUDA device; raises without one), where
    the renderer's model must lie, and go through ``render_chunk`` chunk by
    chunk. Every chunk has ``chunk`` rays: the last one is padded by
    repeating the last pixel and cut back. What ``render_chunk.finish()``
    returns, where there is one, is added to the result (``joints_2d``,
    ``bones``).

    ``async_out``: return ``finalize() -> result`` instead of the result.
    On the image path the outputs' copies to the host are only queued, so
    that the caller can queue the next view before it reads this one.

    Spans of the image path (``utils.profiling``), one unit a frame:
    ``render.frame`` from the call to the result on the host, and in it
    ``render.readback`` (the copies queued), then in ``finalize``
    ``render.wait`` (the wait on the device), ``render.host_copy`` and
    ``render.finish``."""
    device = resolve_device(device)
    n = H * W
    keys = ("rgb_marched", "depth") + tuple(extra_keys)
    finish = getattr(render_chunk, "finish", None)
    image_fn = getattr(render_chunk, "image_fn", None)
    if image_fn is not None:
        frame = profiling.span("render.frame", "frame")
        with frame:
            out = image_fn(K, c2w, H, W, chunk, inverse_y, flip_x, flip_y)
            with profiling.scope("render.readback"):
                host, done = _read_back({k: v for k, v in out.items()
                                         if (k in keys or k in VIEW_KEYS)
                                         and torch.is_tensor(v)})

        def finalize():
            with frame:
                with profiling.scope("render.wait", mirror=True):
                    if done is not None:
                        done.synchronize()
                # copied out of the pinned buffers, which go back to the
                # cache
                with profiling.scope("render.host_copy", mirror=True):
                    arrays = {k: np.array(v.numpy())
                              for k, v in host.items()}
                result = {}
                for k in keys:
                    if k in arrays:
                        v = arrays[k]
                        v = v.reshape(-1, *v.shape[2:])[:n]
                        result[k] = v.reshape(H, W, *v.shape[1:])
                if finish is not None:
                    with profiling.scope("render.finish", mirror=True):
                        result.update(finish({k: arrays[k]
                                              for k in VIEW_KEYS
                                              if k in arrays}))
            frame.close()
            return result

        return finalize if async_out else finalize()

    Kd = torch.as_tensor(np.asarray(K, np.float32), device=device)[None]
    cd = torch.as_tensor(np.asarray(c2w, np.float32), device=device)[None]
    cam = torch.zeros(chunk, dtype=torch.int64, device=device)
    outs: Dict[str, list] = {}
    for start in range(0, n, chunk):
        m = min(chunk, n - start)
        pix = torch.arange(start, start + chunk, device=device).clamp(
            max=n - 1)
        ro, rd, vd = pixels_to_rays(Kd, cd, cam, pix, H, W,
                                    inverse_y=inverse_y, flip_x=flip_x,
                                    flip_y=flip_y)
        res = render_chunk(ro, rd, vd)
        for k in keys:
            if res.get(k) is not None:
                outs.setdefault(k, []).append(res[k][:m])
    result = {}
    for k, parts in outs.items():
        v = torch.cat(parts, 0).cpu().numpy()
        result[k] = v.reshape(H, W, *v.shape[1:])
    if finish is not None:
        result.update(finish())
    return (lambda: result) if async_out else result


def overlay_skeleton(img, joints_2d, bones):
    """Draw bones and joints onto a weight render (needs ``cv2``; the
    image comes back unchanged without it)."""
    if cv2 is None or joints_2d is None or bones is None:
        return img
    # plain-int, range-clipped coordinates: cv2 rejects np.int32 scalar
    # tuples and coordinates far outside the canvas
    lim = 4 * max(img.shape[0], img.shape[1])
    pts = np.clip(np.nan_to_num(np.asarray(joints_2d), nan=-lim),
                  -lim, lim).astype(np.int32)
    img = np.array(img, copy=True, order="C")    # cv2 draws in place
    for bone in bones:
        img = cv2.line(img, (int(pts[bone[0]][0]), int(pts[bone[0]][1])),
                       (int(pts[bone[1]][0]), int(pts[bone[1]][1])),
                       color=(0, 0, 0), thickness=1)
    for j in range(len(pts)):
        img = cv2.circle(img, (int(pts[j][0]), int(pts[j][1])), radius=3,
                         color=(0, 0, 0), thickness=-1)
    return img


def render_viewpoints(render_chunk_for, render_poses, HW, Ks, test_times,
                      gt_imgs=None, savedir=None, render_factor=0,
                      eval_psnr=False, eval_ssim=False, eval_lpips_alex=False,
                      eval_lpips_vgg=False, inverse_y=False, flip_x=False,
                      flip_y=False, chunk=8192, verbose=True,
                      extra_keys=("weights",), device=None):
    """Render a sequence of viewpoints on ``device`` (``None``: the CUDA
    device; raises without one) and evaluate them where ``gt_imgs`` are
    given.

    ``render_chunk_for(i, time) -> chunk_fn`` returns the per-view chunk
    renderer (``renderers.make_points_renderer`` /
    ``make_backbone_renderer``; the model it closes over must lie on
    ``device``). View i + 1 is queued before view i is read back (its
    metrics, PNGs and overlay on the host overlap the device's next view).
    Returns ``rgbs``, ``depths``, ``weights`` (with the skeleton overlaid
    where the renderer gave joints) and the per-view metric lists; with
    ``savedir`` also writes ``img_*.png``, ``weights_*.png`` and, when
    PSNR was evaluated, ``results.txt``. A renderer built with a ``mesh``
    renders each view over its ranks, each of which calls this; only rank
    0 writes files."""
    device = resolve_device(device)
    if savedir is not None and not pmesh.writer(
            getattr(render_chunk_for, "mesh", None)):
        savedir = None
    HW = np.copy(np.asarray(HW))
    Ks = np.copy(np.asarray(Ks, np.float32))
    if render_factor != 0:
        HW = HW // render_factor
        Ks[:, :2, :3] = Ks[:, :2, :3] / render_factor

    rgbs, depths, weights = [], [], []
    joints_all, bones = {}, None
    psnrs, ssims, lp_a, lp_v = [], [], [], []

    def dispatch(i):
        """Queue view i -> its ``finalize``."""
        return render_image(
            render_chunk_for(i, float(test_times[i])), Ks[i],
            render_poses[i], int(HW[i][0]), int(HW[i][1]), chunk=chunk,
            inverse_y=inverse_y, flip_x=flip_x, flip_y=flip_y,
            extra_keys=extra_keys, device=device, async_out=True)

    pending = dispatch(0) if len(render_poses) else None
    for i in range(len(render_poses)):
        H, W = int(HW[i][0]), int(HW[i][1])
        # view i + 1 is queued before view i is read back, so that the
        # device renders it meanwhile. Every view of a key replays the same
        # graphs, whose outputs replay i + 1 overwrites; view i's copies to
        # the host were queued before it on the same stream, so the
        # stream's order has them done first.
        nxt = dispatch(i + 1) if i + 1 < len(render_poses) else None
        res = pending()
        pending = nxt
        rgb = res["rgb_marched"]
        rgbs.append(rgb)
        depths.append(res.get("depth", np.zeros((H, W))))
        if "weights" in res:
            weights.append(res["weights"])
        if res.get("joints_2d") is not None:
            j2 = res["joints_2d"]
            if not inverse_y:
                # x mirror with the view's width
                j2 = np.copy(j2)
                j2[:, 0] = (W - 1) - j2[:, 0]
            joints_all[i] = j2
            bones = res.get("bones")

        if gt_imgs is not None and render_factor == 0:
            gt = np.asarray(gt_imgs[i], np.float32)
            if gt.dtype == np.uint8 or gt.max() > 1.5:
                gt = gt / 255.0
            if eval_psnr:
                psnrs.append(metrics.psnr(rgb, gt[..., :3]))
            if eval_ssim:
                ssims.append(metrics.rgb_ssim(rgb, gt[..., :3], max_val=1))
            if eval_lpips_alex:
                lp_a.append(metrics.rgb_lpips(gt[..., :3], rgb, "alex",
                                              device=device))
            if eval_lpips_vgg:
                lp_v.append(metrics.rgb_lpips(gt[..., :3], rgb, "vgg",
                                              device=device))
        if verbose:
            print(f"render_viewpoints: {i + 1}/{len(render_poses)}")

    if psnrs and savedir is not None:
        os.makedirs(savedir, exist_ok=True)
        with open(os.path.join(savedir, "results.txt"), "w") as f:
            if eval_psnr:
                f.write(f"psnr: {np.mean(psnrs)}\n")
            if eval_ssim:
                f.write(f"ssim: {np.mean(ssims)}\n")
            # the metric is named honestly: "lpips_rand_*" when only the
            # seeded-random-feature fallback is available
            if eval_lpips_vgg:
                f.write(f"{metrics.lpips_metric_name('vgg')}: "
                        f"{np.mean(lp_v)}\n")
            if eval_lpips_alex:
                f.write(f"{metrics.lpips_metric_name('alex')}: "
                        f"{np.mean(lp_a)}\n")

    if savedir is not None:
        os.makedirs(savedir, exist_ok=True)
        for i, rgb in enumerate(rgbs):
            png.write_png(os.path.join(savedir, f"img_{i:03d}.png"),
                          metrics.to8b(rgb))
        for i, w in enumerate(weights):
            png.write_png(os.path.join(savedir, f"weights_{i:03d}.png"),
                          metrics.to8b(w))

    # skeleton overlay on the weight renders
    for i in range(len(weights)):
        if i in joints_all and bones is not None:
            weights[i] = overlay_skeleton(weights[i], joints_all[i], bones)

    return {
        "rgbs": np.array(rgbs), "depths": np.array(depths),
        "weights": np.array(weights) if weights else np.zeros(0),
        "psnrs": psnrs, "ssims": ssims, "lpips_alex": lp_a, "lpips_vgg": lp_v,
    }


def write_video(path, frames, fps=30):
    """Write ``frames`` [T, H, W(, 3)] in [0, 1] as a video; returns the
    file written (``None`` when there are no frames). The first encoder
    that works: mp4 through imageio (ffmpeg), mp4v through cv2, an
    animated GIF through imageio; where neither imageio nor cv2 imports,
    an animated PNG (``utils.png.write_apng``) at ``path`` with the suffix
    ``.png``."""
    frames8 = metrics.to8b(frames)
    if frames8.size == 0 or frames8.ndim < 3:
        print(f"write_video: no frames for {path}, skipped")
        return None
    if frames8.ndim == 3:
        frames8 = frames8[..., None].repeat(3, -1)
    try:
        import imageio.v2 as imageio
    except ImportError:
        imageio = None
    if imageio is not None:
        try:
            imageio.mimwrite(path, frames8, fps=fps, quality=8)
            return path
        except (ValueError, ImportError):
            pass
    if cv2 is not None:
        h, w = frames8.shape[1:3]
        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"),
                             fps, (w, h))
        if vw.isOpened():
            for f in frames8:
                vw.write(np.ascontiguousarray(f[..., ::-1]))  # RGB -> BGR
            vw.release()
            return path
    if imageio is not None:
        gif = os.path.splitext(path)[0] + ".gif"
        imageio.mimwrite(gif, frames8, duration=1000.0 / fps, loop=0)
        print(f"write_video: no mp4 backend, wrote {gif}")
        return gif
    apng = os.path.splitext(path)[0] + ".png"
    png.write_apng(apng, frames8, fps=fps)
    print(f"write_video: neither imageio nor cv2 is installed, wrote the "
          f"animated PNG {apng}")
    return apng
