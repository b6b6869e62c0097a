"""Self-contained LPIPS in PyTorch (AlexNet / VGG16 feature architectures;
port of ``apnerf/render/lpips_jax.py``).

The exact LPIPS v0.1 pipeline: input scaling layer, backbone feature taps
after each ReLU stage, per-tap channelwise unit normalisation, squared
difference, non-negative 1x1 linear calibration, spatial mean, sum over
taps (Zhang et al. 2018). Official weights are loaded when available, from
an ``.npz`` made by ``convert_torch_checkpoint`` (``weights_path`` or
``APNERF_LPIPS_WEIGHTS``). Without them it falls back to **seeded random
features with uniform calibration** ("LPIPS-rand"): a usable perceptual
metric (Zhang et al. 2018, Table 5 "Rand") whose absolute numbers differ
from official LPIPS, so scores are comparable only within this
implementation and the JAX package's (same seeds, same numpy arrays). A
warning is printed once.

The convolutions are library calls (``F.conv2d``, ``F.max_pool2d``), in
full fp32: TF32 is switched off around them.
"""
from __future__ import annotations

import os
import warnings

import numpy as np
import torch
import torch.nn.functional as Fn

from .. import resolve_device

# (out_channels, kernel, stride, pad) per conv; 'M' = 3x3/2 maxpool (alex)
# or 2x2/2 maxpool (vgg). Taps are taken after each ReLU marked 'T'.
_ALEX = [
    (64, 11, 4, 2), "T", ("M", 3, 2),
    (192, 5, 1, 2), "T", ("M", 3, 2),
    (384, 3, 1, 1), "T",
    (256, 3, 1, 1), "T",
    (256, 3, 1, 1), "T",
]
_VGG = [
    (64, 3, 1, 1), (64, 3, 1, 1), "T", ("M", 2, 2),
    (128, 3, 1, 1), (128, 3, 1, 1), "T", ("M", 2, 2),
    (256, 3, 1, 1), (256, 3, 1, 1), (256, 3, 1, 1), "T", ("M", 2, 2),
    (512, 3, 1, 1), (512, 3, 1, 1), (512, 3, 1, 1), "T", ("M", 2, 2),
    (512, 3, 1, 1), (512, 3, 1, 1), (512, 3, 1, 1), "T",
]
_ARCH = {"alex": _ALEX, "vgg": _VGG}
# LPIPS scaling layer constants (lpips/lpips.py ScalingLayer)
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

_warned_random = set()


def _conv_specs(arch):
    specs, c_in = [], 3
    for item in _ARCH[arch]:
        if isinstance(item, tuple) and item[0] != "M":
            c_out, k, s, p = item
            specs.append((c_in, c_out, k, s, p))
            c_in = c_out
    return specs


def random_params(arch: str, seed: int = 0):
    """Seeded He-initialised backbone + uniform calibration (LPIPS-rand)."""
    rng = np.random.default_rng(seed)
    convs = []
    for c_in, c_out, k, _, _ in _conv_specs(arch):
        fan = c_in * k * k
        w = rng.normal(0, np.sqrt(2.0 / fan),
                       (c_out, c_in, k, k)).astype(np.float32)
        b = np.zeros(c_out, np.float32)
        convs.append((w, b))
    # calibration weights exist only for tapped stages
    lins = [np.full(d, 1.0 / d, np.float32) for d in _tap_dims(arch)]
    return {"convs": convs, "lins": lins}


def _tap_dims(arch):
    dims, c = [], 3
    for item in _ARCH[arch]:
        if isinstance(item, tuple) and item[0] != "M":
            c = item[0]
        elif item == "T":
            dims.append(c)
    return dims


def convert_torch_checkpoint(arch: str, out_path: str):
    """Convert the official lpips-package weights (requires the ``lpips``
    and ``torchvision`` packages with their downloaded checkpoints) into the
    ``.npz`` format this module loads. Run wherever those exist; ship the
    npz."""
    import lpips as lpips_pkg  # pragma: no cover  (needs external env)
    net = lpips_pkg.LPIPS(net=arch, version="0.1").eval()
    payload = {}
    convs = [m for m in net.net.modules()
             if m.__class__.__name__ == "Conv2d"]
    for i, m in enumerate(convs):
        payload[f"conv{i}_w"] = m.weight.detach().numpy()
        payload[f"conv{i}_b"] = m.bias.detach().numpy()
    for i, lin in enumerate(net.lins):
        payload[f"lin{i}"] = lin.model[1].weight.detach().numpy().reshape(-1)
    np.savez(out_path, **payload)


def load_params(arch: str, weights_path: str | None = None):
    """Load official weights if available, else seeded-random fallback."""
    path = weights_path or os.environ.get("APNERF_LPIPS_WEIGHTS", "")
    if path and os.path.isfile(path):
        z = np.load(path)
        convs, i = [], 0
        while f"conv{i}_w" in z:
            convs.append((z[f"conv{i}_w"].astype(np.float32),
                          z[f"conv{i}_b"].astype(np.float32)))
            i += 1
        lins, i = [], 0
        while f"lin{i}" in z:
            lins.append(np.maximum(z[f"lin{i}"].astype(np.float32), 0.0))
            i += 1
        return {"convs": convs, "lins": lins}
    if arch not in _warned_random:
        _warned_random.add(arch)
        warnings.warn(
            f"LPIPS({arch}): no pretrained weights found (set "
            f"APNERF_LPIPS_WEIGHTS); using seeded-random features — scores "
            f"are self-consistent but not comparable to official LPIPS.")
    return random_params(arch, seed={"alex": 0, "vgg": 1}[arch])


def _features(params, arch, x):
    """Backbone forward on x [N, 3, H, W]; the tapped activations."""
    taps = []
    ci = 0
    h = x
    for item in _ARCH[arch]:
        if item == "T":
            taps.append(h)
        elif item[0] == "M":
            _, k, s = item
            h = Fn.max_pool2d(h, k, stride=s)
        else:
            _, k, s, p = item
            w, b = params["convs"][ci]
            ci += 1
            h = torch.relu(Fn.conv2d(h, w, b, stride=s, padding=p))
    return taps


def _lpips_fn(params, arch, img0, img1):
    """img0, img1 [N, 3, H, W] in [0, 1] -> distances [N]."""
    shift = torch.as_tensor(_SHIFT, device=img0.device)[None, :, None, None]
    scale = torch.as_tensor(_SCALE, device=img0.device)[None, :, None, None]

    def prep(im):
        return ((im * 2.0 - 1.0) - shift) / scale        # [0,1] -> [-1,1]

    f0 = _features(params, arch, prep(img0))
    f1 = _features(params, arch, prep(img1))
    total = 0.0
    for t0, t1, lin in zip(f0, f1, params["lins"]):
        n0 = t0 / torch.sqrt((t0 ** 2).sum(1, keepdim=True) + 1e-10)
        n1 = t1 / torch.sqrt((t1 ** 2).sum(1, keepdim=True) + 1e-10)
        d = (n0 - n1) ** 2
        total = total + (d * lin[None, :, None, None]).sum(1).mean((1, 2))
    return total


_CACHE = {}


@torch.no_grad()
def lpips(gt, img, net_name: str = "alex", weights_path: str | None = None,
          device=None) -> float:
    """LPIPS distance between two [H, W, 3] images in [0, 1], computed on
    ``device`` (``None``: the CUDA device; raises without one)."""
    device = resolve_device(device)
    path = weights_path or os.environ.get("APNERF_LPIPS_WEIGHTS", "")
    key = (net_name, path, str(device))
    if key not in _CACHE:
        params = load_params(net_name, path)
        _CACHE[key] = {
            "convs": [(torch.as_tensor(w, device=device),
                       torch.as_tensor(b, device=device))
                      for w, b in params["convs"]],
            "lins": [torch.as_tensor(v, device=device)
                     for v in params["lins"]]}
    g = torch.as_tensor(np.asarray(gt, np.float32), device=device)
    p = torch.as_tensor(np.asarray(img, np.float32), device=device)
    g, p = (x.permute(2, 0, 1)[None] for x in (g, p))
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        return float(_lpips_fn(_CACHE[key], net_name, g, p)[0])
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
