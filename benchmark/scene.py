"""The benchmark's scene: one articulated figure made from the seed.

There is no dataset on disk, so every run makes its own: the SMPL 24-joint
tree with the rest joints of ``figure/<name>.json``, a capsule round each
bone, and per-joint rotations over time drawn from the seed (the rest pose
at the canonical time 0). Its RGB images and masks are volume-rendered from
the family's camera layout at the family's resolution, on the device, in
plain PyTorch. The stage-2 starting state is made beside them: a canonical
cloud of ``canonical_pcd_num`` points drawn inside the capsules at time 0,
the skeleton, the backbone's heads and the per-point features, drawn from a
``torch.Generator`` on the device in a few large calls.

Everything here is the benchmark's own: the program and the reference are
both handed what ``make_scene`` returns, as numpy arrays.
"""
from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass, field
from typing import Any, Dict

import numpy as np
import torch

from .reference.frozen.models.tineuvox import TiNeuVoxConfig

HERE = os.path.dirname(os.path.abspath(__file__))
DENSITY = 60.0       # a capsule's density inside
SOFT = 0.01          # width of a capsule's soft edge
N_MARCH = 96         # samples a ray in the images' volume render
RAY_CHUNK = 8192


def load_figure(name: str) -> Dict[str, Any]:
    with open(os.path.join(HERE, "figure", f"{name}.json")) as f:
        return json.load(f)


def seed_of(seed: int) -> int:
    """A seed that every generator takes (torch's take < 2**64)."""
    return int(seed) % (2 ** 63)


def rodrigues(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rotation matrices [..., 3, 3] of unit ``axis`` [..., 3] by ``angle``."""
    x, y, z = axis.unbind(-1)
    c, s = torch.cos(angle), torch.sin(angle)
    C = 1.0 - c
    return torch.stack([
        torch.stack([c + x * x * C, x * y * C - z * s, x * z * C + y * s], -1),
        torch.stack([y * x * C + z * s, c + y * y * C, y * z * C - x * s], -1),
        torch.stack([z * x * C - y * s, z * y * C + x * s, c + z * z * C], -1),
    ], -2)


@dataclass
class Figure:
    rest: torch.Tensor        # [J, 3] rest joints, centred and scaled
    parents: list
    radius: torch.Tensor      # [J] capsule radius of the bone ending at j
    axes: torch.Tensor        # [J, 3] rotation axis of each joint
    amps: torch.Tensor        # [J] amplitude (radians), 0 at the root
    freqs: torch.Tensor       # [J] cycles over t in [0, 1]
    phases: torch.Tensor      # [J]
    colors: torch.Tensor      # [J, 3] colour of the bone ending at j

    @property
    def bones(self):
        return [[p, j] for j, p in enumerate(self.parents) if p >= 0]

    def joints_at(self, t: float) -> torch.Tensor:
        """Posed joints [J, 3] at time ``t``: each joint turns about its
        axis by amp * (sin(2 pi f t + phase) - sin(phase)), so t = 0 is the
        rest pose; forward kinematics down the tree."""
        ang = self.amps * (torch.sin(2 * math.pi * self.freqs * t
                                     + self.phases) - torch.sin(self.phases))
        local = rodrigues(self.axes, ang)
        glob = [None] * len(self.parents)
        pos = [None] * len(self.parents)
        for j, p in enumerate(self.parents):
            if p < 0:
                glob[j], pos[j] = local[j], self.rest[j]
            else:
                pos[j] = pos[p] + glob[p] @ (self.rest[j] - self.rest[p])
                glob[j] = glob[p] @ local[j]
        return torch.stack(pos)

    def inside(self, joints: torch.Tensor, pts: torch.Tensor):
        """(inside [N, B] in [0, 1] per bone, bone colours [B, 3]) of
        ``pts`` [N, 3] for the figure posed at ``joints``."""
        b = torch.tensor(self.bones, device=pts.device)
        joints = joints.to(pts.dtype)
        a, e = joints[b[:, 0]], joints[b[:, 1]]
        s = e - a
        u = ((pts[:, None] - a) * s).sum(-1) / (s * s).sum(-1)
        u = u.clamp(0.0, 1.0)
        d = torch.linalg.vector_norm(pts[:, None] - (a + u[..., None] * s),
                                     dim=-1)
        r = self.radius[b[:, 1]].to(pts.dtype)
        return (((r - d) / SOFT).clamp(0.0, 1.0),
                self.colors[b[:, 1]].to(pts.dtype))

    def density_color(self, joints, pts):
        ins, cols = self.inside(joints, pts)
        sigma = DENSITY * ins.amax(-1)
        w = ins + 1e-9
        return sigma, (w @ cols) / w.sum(-1, keepdim=True)


def make_figure(spec: Dict[str, Any], gen: torch.Generator, device
                ) -> Figure:
    """The figure of the configuration's ``figure`` block, its motion and
    colours drawn from ``gen``."""
    fig = load_figure(spec["name"])
    rest = torch.tensor(fig["joints"], dtype=torch.float64)
    rest = (rest - 0.5 * (rest.amin(0) + rest.amax(0))) * float(spec["scale"])
    J = len(fig["parents"])
    draw = torch.rand((J, 9), generator=gen, device=device,
                      dtype=torch.float64)
    axes = torch.nn.functional.normalize(draw[:, :3] * 2 - 1, dim=-1)
    lo, hi = spec["amp"]
    amps = lo + (hi - lo) * draw[:, 3]
    amps[0] = 0.0
    freqs = torch.where(draw[:, 4] < 0.5, 1.0, 2.0).to(torch.float64)
    phases = 2 * math.pi * draw[:, 5]
    colors = 0.15 + 0.8 * draw[:, 6:9]
    return Figure(rest.to(device), list(fig["parents"]),
                  torch.tensor(fig["radius"], dtype=torch.float64,
                               device=device) * float(spec["scale"]),
                  axes, amps, freqs, phases, colors)


def pose_spherical(theta_deg: float, phi_deg: float, radius: float):
    """Camera-to-world [4, 4], OpenGL convention, on a sphere (the D-NeRF
    loader's)."""
    th, ph = math.radians(theta_deg), math.radians(phi_deg)
    trans = np.eye(4)
    trans[2, 3] = radius
    rp = np.eye(4)
    rp[1, 1], rp[1, 2], rp[2, 1], rp[2, 2] = (math.cos(ph), -math.sin(ph),
                                              math.sin(ph), math.cos(ph))
    rt = np.eye(4)
    rt[0, 0], rt[0, 2], rt[2, 0], rt[2, 2] = (math.cos(th), -math.sin(th),
                                              math.sin(th), math.cos(th))
    flip = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0],
                     [0, 0, 0, 1]], np.float64)
    return flip @ rt @ rp @ trans


def look_at_opencv(pos: np.ndarray) -> np.ndarray:
    """Camera-to-world [4, 4] at ``pos`` looking at the origin, OpenCV
    convention (x right, y down, z forward), z up in the world."""
    f = -pos / np.linalg.norm(pos)
    r = np.cross(f, [0.0, 0.0, 1.0])
    r /= np.linalg.norm(r)
    d = np.cross(f, r)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = r, d, f, pos
    return c2w


def cameras(cam: Dict[str, Any], rng: np.random.Generator):
    """(poses [C, 4, 4], Ks [C, 3, 3], img_to_cam [N], times [N]) of the
    configuration's ``cameras`` block. ``monocular``: one camera an image,
    at a random azimuth and elevation, image k at time k / (N - 1) (the
    D-NeRF layout); ``ring``: ``n_cams`` fixed cameras round the figure,
    every time seen by each (the ZJU-MoCap layout)."""
    H = W = int(cam["size"])
    focal = float(cam["focal"])
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]])
    if cam["layout"] == "monocular":
        n = int(cam["n_images"])
        az = rng.uniform(0.0, 360.0, n)
        el = rng.uniform(*cam["elevation"], n)
        poses = np.stack([pose_spherical(a, e, float(cam["radius"]))
                          for a, e in zip(az, el)])
        times = np.arange(n) / max(n - 1, 1)
        img_to_cam = np.arange(n)
    else:
        n_cams, n_times = int(cam["n_cams"]), int(cam["n_times"])
        az0 = rng.uniform(0.0, 2 * math.pi)
        poses = []
        for c in range(n_cams):
            a = az0 + 2 * math.pi * c / n_cams
            poses.append(look_at_opencv(float(cam["radius"]) * np.array(
                [math.cos(a), math.sin(a), float(cam["height"])])))
        poses = np.stack(poses)
        times = np.repeat(np.arange(n_times) / max(n_times - 1, 1), n_cams)
        img_to_cam = np.tile(np.arange(n_cams), n_times)
    Ks = np.repeat(K[None], len(poses), 0)
    return (poses.astype(np.float32), Ks.astype(np.float32),
            img_to_cam.astype(np.int64), times.astype(np.float32))


def camera_rays(K, c2w, H, W, inverse_y, device):
    """Rays [H * W, 3] through the pixel centres, as the program's
    ``pixels_to_rays`` forms them."""
    f32 = torch.float32
    j, i = torch.meshgrid(torch.arange(H, device=device, dtype=f32) + 0.5,
                          torch.arange(W, device=device, dtype=f32) + 0.5,
                          indexing="ij")
    K = torch.as_tensor(K, dtype=f32, device=device)
    c2w = torch.as_tensor(c2w, dtype=f32, device=device)
    x = (i - K[0, 2]) / K[0, 0]
    y = (j - K[1, 2]) / K[1, 1]
    if inverse_y:
        dirs = torch.stack([x, y, torch.ones_like(x)], -1)
    else:
        dirs = torch.stack([x, -y, -torch.ones_like(x)], -1)
    rd = dirs.reshape(-1, 3) @ c2w[:3, :3].T
    return c2w[:3, 3].expand_as(rd), rd


def render_image(fig: Figure, joints, K, c2w, H, W, near, far, inverse_y,
                 device):
    """(rgb [H, W, 3], opacity [H, W]) of the figure posed at ``joints``:
    ``N_MARCH`` samples a ray across the figure's bounding sphere."""
    ro, rd = camera_rays(K, c2w, H, W, inverse_y, device)
    joints = joints.float()
    centre = 0.5 * (joints.amin(0) + joints.amax(0))
    rad = float((joints - centre).norm(dim=-1).max() + fig.radius.max()
                + SOFT)
    dn = torch.nn.functional.normalize(rd, dim=-1)
    oc = ro - centre
    b = (oc * dn).sum(-1)
    disc = b * b - ((oc * oc).sum(-1) - rad * rad)
    hit = disc > 0
    sq = disc.clamp(min=0).sqrt()
    scale = rd.norm(dim=-1)
    t0 = ((-b - sq) / scale).clamp(near, far)
    t1 = ((-b + sq) / scale).clamp(near, far)
    hit &= t1 > t0
    rgb = torch.zeros((H * W, 3), device=device)
    acc = torch.zeros(H * W, device=device)
    idx = hit.nonzero()[:, 0]
    steps = (torch.arange(N_MARCH, device=device) + 0.5) / N_MARCH
    for s in range(0, len(idx), RAY_CHUNK):
        r = idx[s:s + RAY_CHUNK]
        dt = (t1[r] - t0[r]) / N_MARCH
        tt = t0[r, None] + (t1[r] - t0[r])[:, None] * steps
        pts = ro[r, None] + rd[r, None] * tt[..., None]
        sigma, col = fig.density_color(joints, pts.reshape(-1, 3))
        alpha = 1.0 - torch.exp(-sigma.view(len(r), N_MARCH)
                                * (dt * scale[r])[:, None])
        trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]),
                                         1.0 - alpha[:, :-1]], 1), 1)
        w = alpha * trans
        rgb[r] = (w[..., None] * col.view(len(r), N_MARCH, 3)).sum(1)
        acc[r] = w.sum(1)
    return rgb.view(H, W, 3), acc.view(H, W)


@dataclass
class Scene:
    """What the program and the reference are both handed (numpy)."""
    data: Dict[str, Any]          # the ``data_dict`` of the trainers
    canonical: Dict[str, Any]     # the export's canonical cloud
    skeleton: Dict[str, Any]      # joints, bones, skeleton_pcd
    heads: Dict[str, np.ndarray]  # backbone heads, state_dict names
    backbone: Dict[str, Any]      # TiNeuVoxConfig keyword arguments
    bbox: tuple                   # the stage-1 box (xyz_min, xyz_max)
    figure: Figure = field(repr=False, default=None)


def head_shapes(F: int, views_ch: int, times_ch: int, time_out: int):
    """State-dict names and shapes of the backbone heads that stage 2
    copies (``rgbnet``, ``densitynet``, ``timenet``), with each layer's
    fan-in."""
    out = {}

    def layer(name, din, dout):
        out[f"{name}.weight"] = ((dout, din), din)
        out[f"{name}.bias"] = ((dout,), din)

    layer("rgbnet.feature_linears", F, F)
    layer("rgbnet.views_linears.layers.0", F + views_ch, F // 2)
    layer("rgbnet.views_linears.layers.1", F // 2, 3)
    layer("densitynet.layers.0", F, 1)
    layer("timenet.layers.0", times_ch, F)
    layer("timenet.layers.1", F, time_out)
    return out


def make_scene(cfg: Dict[str, Any], seed: int, device,
               images: bool = True) -> Scene:
    """The scene of configuration ``cfg`` (a ``configs/*.json`` mapping)
    from ``seed`` on ``device``. ``images`` off: without the training
    images and masks (for a cell that reads none; every other array is the
    same, since their rendering draws nothing from the seed)."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed_of(seed))
    rng = np.random.default_rng(seed_of(seed))
    fig = make_figure(cfg["figure"], gen, device)
    cam = cfg["cameras"]
    poses, Ks, img_to_cam, times = cameras(cam, rng)
    H = W = int(cam["size"])
    near, far = float(cam["near"]), float(cam["far"])
    inverse_y = bool(cfg["data"]["inverse_y"])
    bg = float(cfg["pcd_train_config"]["bg_col"])
    n = len(times)
    empty = np.zeros(0, np.int64)
    data = dict(hwf=[H, W, float(cam["focal"])], HW=np.array([[H, W]] * n),
                Ks=Ks, near=near, far=far, i_train=np.arange(n),
                i_val=empty, i_test=empty, poses=poses, times=times,
                img_to_cam=img_to_cam, irregular_shape=False)
    if images:
        rgbs, accs = [], []
        for k in range(n):
            rgb, acc = render_image(fig, fig.joints_at(float(times[k])),
                                    Ks[img_to_cam[k]], poses[img_to_cam[k]],
                                    H, W, near, far, inverse_y, device)
            rgbs.append(rgb + bg * (1.0 - acc[..., None]))
            accs.append(acc)
        rgb = torch.stack(rgbs).clamp(0, 1)
        acc = torch.stack(accs).clamp(0, 1)
        if cam["image_dtype"] == "uint8":
            rgb = (rgb * 255).round().to(torch.uint8)
            acc = (acc > 0.5).to(torch.uint8)
        else:
            rgb, acc = rgb.float(), acc.float()
        data["images"] = rgb.cpu().numpy()
        data["masks"] = acc[..., None].cpu().numpy()

    # the figure's box over all times, a margin round it: stage 1's box
    posed = torch.stack([fig.joints_at(float(t)) for t in np.unique(times)])
    pad = float(fig.radius.max()) + 0.1
    box_min = (posed.amin((0, 1)) - pad).cpu().numpy()
    box_max = (posed.amax((0, 1)) + pad).cpu().numpy()
    mr = cfg["model_and_render"]
    backbone = dict(xyz_min=tuple(float(x) for x in box_min),
                    xyz_max=tuple(float(x) for x in box_max),
                    num_voxels=int(mr["num_voxels"]),
                    num_voxels_base=int(mr["num_voxels_base"]),
                    voxel_dim=int(mr["voxel_dim"]),
                    defor_depth=int(mr["defor_depth"]),
                    net_width=int(mr["net_width"]),
                    no_view_dir=bool(mr["no_view_dir"]))
    extent = (box_max.astype(np.float64) - box_min)
    voxel_size = float((extent.prod() / backbone["num_voxels"]) ** (1 / 3))

    # the canonical cloud: points drawn inside the capsules at time 0
    P = int(cfg["pcd_model_and_render"]["canonical_pcd_num"])
    F = backbone["net_width"]
    j0 = fig.joints_at(0.0)
    lo = j0.amin(0) - fig.radius.max()
    hi = j0.amax(0) + fig.radius.max()
    pts = []
    have = 0
    while have < P:
        u = torch.rand((16 * P, 3), generator=gen, device=device,
                       dtype=torch.float64)
        cand = lo + (hi - lo) * u
        keep = fig.inside(j0, cand)[0].amax(-1) >= 1.0
        pts.append(cand[keep])
        have += int(keep.sum())
    pcd = torch.cat(pts)[:P]
    ins, cols = fig.inside(j0, pcd)
    w = ins + 1e-9
    pcd_rgb = (w @ cols) / w.sum(-1, keepdim=True)
    draw = torch.randn((P, F + 1), generator=gen, device=device)
    feat = 0.1 * draw[:, :F]
    alphas = (0.6 + 0.1 * draw[:, F]).clamp(0.3, 0.9)
    pcd_np = pcd.float().cpu().numpy()
    canonical = dict(pcd=pcd_np, feat=feat.cpu().numpy(),
                     raw_feat=feat.cpu().numpy(),
                     alphas=alphas.cpu().numpy(),
                     rgbs=pcd_rgb.float().cpu().numpy(), t=0.0,
                     xyz_min=pcd_np.min(0), xyz_max=pcd_np.max(0),
                     voxel_size=voxel_size)
    bones = fig.bones
    jb = torch.tensor(bones, device=device)
    frac = torch.linspace(0.0, 1.0, 8, device=device, dtype=torch.float64)
    skel = (j0[jb[:, 0], None] + frac[:, None]
            * (j0[jb[:, 1]] - j0[jb[:, 0]])[:, None]).reshape(-1, 3)
    skeleton = dict(joints=j0.float().cpu().numpy(), bones=bones,
                    skeleton_pcd=skel.float().cpu().numpy())

    # the backbone heads, uniform within 1 / sqrt(fan-in), one draw
    tc = TiNeuVoxConfig(**backbone)
    shapes = head_shapes(F, tc.views_ch, tc.times_ch, tc.timenet_output)
    total = sum(int(np.prod(s)) for s, _ in shapes.values())
    flat = torch.rand(total, generator=gen, device=device) * 2 - 1
    heads, at = {}, 0
    for name, (shape, fan_in) in shapes.items():
        k = int(np.prod(shape))
        heads[name] = (flat[at:at + k].view(shape)
                       / math.sqrt(fan_in)).cpu().numpy()
        at += k
    return Scene(data, canonical, skeleton, heads, backbone,
                 (box_min, box_max), fig)
