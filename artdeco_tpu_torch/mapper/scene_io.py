"""Scene export: Gaussian PLY, xyz+RGB PLY, COLMAP binary model, TUM
keyframe poses, camera-frustum PLY, test renders.

Port of the writers of ``artdeco_tpu/mapper/scene_io.py``, its readers
(``read_gaussian_ply``, ``load_scene_for_viewing`` for the viewers) and
``read_colmap_model``, the COLMAP dataset's reader.  The files are the JAX
package's byte for byte given the same scene; the tensors come to the host
once per file.  Test renders are written as PNG by a small zlib writer, so
no image library is needed.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import struct
import types
import zlib
from typing import Dict, List

import numpy as np
import torch


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# PLY
# ---------------------------------------------------------------------------

def write_ply(path: str, fields: List[tuple], columns: List[np.ndarray]):
    """Binary little-endian PLY. fields: [(name, 'f4'|'u1'), ...]."""
    n = columns[0].shape[0]
    type_map = {"f4": "float", "u1": "uchar"}
    np_map = {"f4": "<f4", "u1": "u1"}
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property {type_map[t]} {name}" for name, t in fields]
    header.append("end_header\n")
    rec = np.rec.fromarrays([np.asarray(c).astype(np_map[t]) for c, (_, t) in zip(columns, fields)],
                            names=[name for name, _ in fields])
    with open(path, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        rec.tofile(f)


def gaussian_ply_fields(sh_degree: int) -> List[tuple]:
    k = (sh_degree + 1) ** 2
    names = ["x", "y", "z", "nx", "ny", "nz"]
    names += [f"f_dc_{i}" for i in range(3)]
    names += [f"f_rest_{i}" for i in range(3 * (k - 1))]
    names += ["opacity"]
    names += [f"scale_{i}" for i in range(3)]
    names += [f"rotation_{i}" for i in range(4)]
    return [(n, "f4") for n in names]


def save_gaussian_ply(path: str, scene_model) -> int:
    """The Gaussian PLY with the mlp_cov modulation baked into scaling and
    rotation, so standard 3DGS viewers reproduce the render."""
    from artdeco_tpu_torch.mapper.scene_model import mlp_cov_apply

    slab = scene_model.slab
    sel = np.where(_np(slab.active))[0]
    xyz = _np(slab.xyz)[sel]
    f_dc = _np(slab.f_dc)[sel]
    f_rest = _np(slab.f_rest)[sel]
    opacity = _np(slab.opacity)[sel]
    cls_id = _np(slab.cls_id)[sel]
    gfeat = _np(scene_model.gfeat.val)[np.clip(cls_id, 0, scene_model.cfg.cluster_capacity - 1)]
    local = _np(slab.local_feat)[sel]
    feats = torch.as_tensor(np.concatenate([gfeat, local], axis=-1),
                            device=scene_model.mlp.w1.device)
    with torch.no_grad():
        sr = _np(mlp_cov_apply(scene_model.mlp, feats))
    scaling = np.log((1.0 / (1.0 + np.exp(-sr[:, :3]))) * np.exp(_np(slab.scaling)[sel])
                     + 1e-30)
    rotation = _np(slab.rotation)[sel] * sr[:, 3:7]
    # channel-major coefficients (torch's transpose(1, 2).flatten layout)
    # (explicit widths: an empty scene has no -1 to infer)
    f_dc_flat = f_dc.transpose(0, 2, 1).reshape(len(sel), f_dc.shape[1] * f_dc.shape[2])
    f_rest_flat = f_rest.transpose(0, 2, 1).reshape(len(sel), f_rest.shape[1] * f_rest.shape[2])
    cols = ([xyz[:, i] for i in range(3)]
            + [np.zeros(len(sel), np.float32)] * 3
            + [f_dc_flat[:, i] for i in range(3)]
            + [f_rest_flat[:, i] for i in range(f_rest_flat.shape[1])]
            + [opacity[:, 0]]
            + [scaling[:, i] for i in range(3)]
            + [rotation[:, i] for i in range(4)])
    write_ply(path, gaussian_ply_fields(scene_model.cfg.sh_degree), cols)
    return len(sel)


def read_gaussian_ply(path: str) -> dict:
    """Parse a Gaussian PLY written by :func:`save_gaussian_ply` back into
    field arrays (binary little-endian only)."""
    with open(path, "rb") as f:
        names = []
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("property"):
                names.append(line.split()[-1])
            elif line == "end_header":
                break
            elif not line:
                raise ValueError(f"{path}: truncated PLY header")
        rec = np.fromfile(f, dtype=np.dtype([(n, "<f4") for n in names]))
    cols = {n: rec[n] for n in names}
    n = len(rec)
    xyz = np.stack([cols["x"], cols["y"], cols["z"]], -1)
    f_dc = np.stack([cols[f"f_dc_{i}"] for i in range(3)], -1)[:, None, :]
    n_rest = sum(1 for k in names if k.startswith("f_rest_"))
    if n_rest:
        flat = np.stack([cols[f"f_rest_{i}"] for i in range(n_rest)], -1)
        f_rest = flat.reshape(n, 3, n_rest // 3).transpose(0, 2, 1)
    else:
        f_rest = np.zeros((n, 0, 3), np.float32)
    return dict(xyz=xyz, f_dc=f_dc, f_rest=f_rest, opacity=cols["opacity"][:, None],
                scaling=np.stack([cols[f"scale_{i}"] for i in range(3)], -1),
                rotation=np.stack([cols[f"rotation_{i}"] for i in range(4)], -1))


@dataclasses.dataclass
class ViewerScene:
    """What the viewers read of a scene: ``slab``, ``gfeat.val``, ``mlp``,
    ``cfg`` and the camera it was saved with (``width``, ``height``, ``f``)."""
    slab: object
    gfeat: object
    mlp: object
    cfg: object
    width: int
    height: int
    f: float


def load_scene_for_viewing(run_dir: str, focal: float = None, device=None) -> ViewerScene:
    """A renderable scene from a saved run directory (its ``**/gs.ply``, or
    a ``.ply`` path) on ``device`` (default: the CUDA device).

    The PLY is MLP-baked (``save_gaussian_ply``), so the scene renders
    through an identity ``MlpCov``: zero weights and the output bias
    [20, 20, 20, 1, 1, 1, 1] (sigmoid(20) is 1 in float32, unit gains keep
    the baked rotation), one cluster of zero features, and ``d_max`` at
    1e10 (no LOD culling).  Width, height and focal come from
    ``metadata.json``'s ``config`` (else 640x360 and ``focal`` or 500); a
    metadata file that cannot be read raises.
    """
    from artdeco_tpu_torch.device import resolve
    from artdeco_tpu_torch.mapper import gaussians as G
    from artdeco_tpu_torch.mapper.config import MapperConfig
    from artdeco_tpu_torch.mapper.scene_model import MlpCov

    device = resolve(device)
    candidates = (glob.glob(os.path.join(run_dir, "pcd", "gs.ply"))
                  + glob.glob(os.path.join(run_dir, "**", "gs.ply"), recursive=True)
                  + ([run_dir] if run_dir.endswith(".ply") else []))
    if not candidates:
        raise FileNotFoundError(f"no gs.ply under {run_dir}")
    fields = read_gaussian_ply(candidates[0])
    n = len(fields["xyz"])
    sh_degree = int(round(np.sqrt(1 + fields["f_rest"].shape[1]))) - 1

    width, height, f = 640, 360, focal or 500.0
    meta_path = os.path.join(run_dir, "metadata.json")
    if os.path.isfile(meta_path):
        with open(meta_path) as fh:
            meta = json.load(fh)
        cfgm = meta.get("config", meta)
        width = int(cfgm.get("width", width))
        height = int(cfgm.get("height", height))
        f = float(cfgm.get("f", cfgm.get("focal", f)))

    cfg = MapperConfig(capacity=max(n, 1), sh_degree=sh_degree, local_feat_dim=1,
                       global_feat_dim=1, cluster_capacity=1, voxel_table_size=2)
    slab = G.create_slab(max(n, 1), sh_degree, 1, 1e-4, device)
    f32 = dict(dtype=torch.float32, device=device)
    # global + local feature -> a 2-wide MLP input
    mlp = MlpCov(w1=torch.zeros(2, 2, **f32), b1=torch.zeros(2, **f32),
                 w2=torch.zeros(2, 7, **f32),
                 b2=torch.tensor([20.0, 20.0, 20.0, 1.0, 1.0, 1.0, 1.0], **f32))
    return ViewerScene(slab=dataclasses_replace_slab(slab, fields, n),
                       gfeat=types.SimpleNamespace(val=torch.zeros(1, 1, **f32)),
                       mlp=mlp, cfg=cfg, width=width, height=height, f=f)


def dataclasses_replace_slab(slab, fields: dict, n: int):
    """Scatter loaded PLY fields into a fresh slab's first ``n`` rows; a
    field whose trailing shape differs from the slab's (an ``f_rest`` of
    another SH degree) is skipped."""
    cap, device = slab.capacity, slab.xyz.device
    upd = dict(active=torch.arange(cap, device=device) < n)
    for key in ("xyz", "f_dc", "f_rest", "scaling", "rotation", "opacity"):
        base = getattr(slab, key)
        v = np.asarray(fields[key], np.float32)
        if v.shape[1:] != tuple(base.shape[1:]):
            continue
        upd[key] = base.clone()
        upd[key][:n] = torch.as_tensor(v, device=device)
    upd["d_max"] = torch.full((cap, 1), 1e10, dtype=torch.float32, device=device)
    return dataclasses.replace(slab, **upd)


def save_xyz_rgb_ply(path: str, scene_model) -> int:
    """xyz + DC-term RGB point cloud."""
    slab = scene_model.slab
    sel = np.where(_np(slab.active))[0]
    xyz = _np(slab.xyz)[sel]
    f_dc = _np(slab.f_dc)[sel][:, 0, :]
    rgb = np.clip(f_dc * 0.28209479177387814 + 0.5, 0, 1)
    rgb_u8 = (rgb * 255).astype(np.uint8)
    fields = [("x", "f4"), ("y", "f4"), ("z", "f4"),
              ("red", "u1"), ("green", "u1"), ("blue", "u1")]
    write_ply(path, fields, [xyz[:, 0], xyz[:, 1], xyz[:, 2],
                             rgb_u8[:, 0], rgb_u8[:, 1], rgb_u8[:, 2]])
    return len(sel)


def save_poses_as_pyramid_ply(Rts_w2c: np.ndarray, path: str, size: float = 0.3,
                              color: str = "red"):
    """Camera frusta as 5-vertex pyramids."""
    c = {"red": (255, 0, 0), "green": (0, 255, 0), "blue": (0, 0, 255)}.get(color, (255, 0, 0))
    base = np.asarray([[0, 0, 0], [-0.5, -0.375, 1], [0.5, -0.375, 1],
                       [0.5, 0.375, 1], [-0.5, 0.375, 1]]) * size
    verts = []
    for Rt in Rts_w2c:
        c2w = np.linalg.inv(Rt)
        verts.append(base @ c2w[:3, :3].T + c2w[:3, 3])
    verts = np.concatenate(verts, axis=0) if verts else np.zeros((0, 3))
    n = verts.shape[0]
    fields = [("x", "f4"), ("y", "f4"), ("z", "f4"),
              ("red", "u1"), ("green", "u1"), ("blue", "u1")]
    write_ply(path, fields, [verts[:, 0], verts[:, 1], verts[:, 2],
                             np.full(n, c[0], np.uint8), np.full(n, c[1], np.uint8),
                             np.full(n, c[2], np.uint8)])


# ---------------------------------------------------------------------------
# COLMAP binary model
# ---------------------------------------------------------------------------

def rotmat_to_qvec(R: np.ndarray) -> np.ndarray:
    """3x3 -> COLMAP (qw, qx, qy, qz)."""
    K = np.array([
        [R[0, 0] - R[1, 1] - R[2, 2], 0, 0, 0],
        [R[0, 1] + R[1, 0], R[1, 1] - R[0, 0] - R[2, 2], 0, 0],
        [R[0, 2] + R[2, 0], R[1, 2] + R[2, 1], R[2, 2] - R[0, 0] - R[1, 1], 0],
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1],
         R[0, 0] + R[1, 1] + R[2, 2]],
    ]) / 3.0
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    if q[0] < 0:
        q = -q
    return q


def write_colmap_model(out_dir: str, cameras: Dict, images: Dict):
    """cameras: id -> dict(model_id, width, height, params);
    images: id -> dict(qvec, tvec, camera_id, name)."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cid, c in cameras.items():
            f.write(struct.pack("<iiQQ", cid, c["model_id"], c["width"], c["height"]))
            for p in c["params"]:
                f.write(struct.pack("<d", float(p)))
    with open(os.path.join(out_dir, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for iid, im in images.items():
            f.write(struct.pack("<i", iid))
            for q in im["qvec"]:
                f.write(struct.pack("<d", float(q)))
            for t in im["tvec"]:
                f.write(struct.pack("<d", float(t)))
            f.write(struct.pack("<i", im["camera_id"]))
            f.write(im["name"].encode() + b"\x00")
            f.write(struct.pack("<Q", 0))  # no 2D points
    with open(os.path.join(out_dir, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", 0))


def read_colmap_model(model_dir: str):
    """Binary COLMAP reader (``cameras.bin``, ``images.bin``): the JAX
    package's ``read_colmap_model``.  Returns ({camera_id: dict(model_id,
    width, height, params)}, {image_id: dict(qvec, tvec, camera_id,
    name)})."""
    cameras = {}
    with open(os.path.join(model_dir, "cameras.bin"), "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        num_params = {0: 3, 1: 4, 2: 4, 3: 5, 4: 8}  # SIMPLE_PINHOLE..OPENCV
        for _ in range(n):
            cid, model_id, w, h = struct.unpack("<iiQQ", f.read(24))
            k = num_params.get(model_id, 4)
            params = struct.unpack(f"<{k}d", f.read(8 * k))
            cameras[cid] = dict(model_id=model_id, width=w, height=h, params=list(params))
    images = {}
    with open(os.path.join(model_dir, "images.bin"), "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        for _ in range(n):
            iid = struct.unpack("<i", f.read(4))[0]
            qvec = struct.unpack("<4d", f.read(32))
            tvec = struct.unpack("<3d", f.read(24))
            cam_id = struct.unpack("<i", f.read(4))[0]
            name = b""
            while True:
                ch = f.read(1)
                if ch == b"\x00":
                    break
                name += ch
            n2d = struct.unpack("<Q", f.read(8))[0]
            f.read(n2d * 24)
            images[iid] = dict(qvec=list(qvec), tvec=list(tvec), camera_id=cam_id,
                               name=name.decode())
    return cameras, images


_PNG_COLOR_TYPE = {1: 0, 3: 2, 4: 6}     # channels -> grey, RGB, RGBA


def write_png(path: str, img: np.ndarray):
    """(H, W) grey, (H, W, 3) RGB or (H, W, 4) RGBA uint8 as an 8-bit PNG
    (colour type 0, 2 or 6)."""
    img = np.ascontiguousarray(img)
    channels = 1 if img.ndim == 2 else img.shape[2]
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or channels not in _PNG_COLOR_TYPE:
        raise ValueError(f"write_png takes (H, W[, 1|3|4]) uint8, not {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, _PNG_COLOR_TYPE[channels],
                                          0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


# ---------------------------------------------------------------------------
# Full scene save
# ---------------------------------------------------------------------------

def save_scene(scene_model, path: str, reconstruction_time: float = 0.0,
               n_frames: int = 0, save_renders: bool = True,
               with_lpips: bool = True) -> dict:
    """Metrics (``evaluate``, LPIPS included unless ``with_lpips`` is off)
    and, when ``path`` is set, every export file under it.  Returns the
    metrics."""
    from artdeco_tpu_torch.mapper import keyframe as KFmod

    metrics = {"num keyframes": len(scene_model.keyframes),
               "num gaussians": int(scene_model.n_active_gaussians)}
    if reconstruction_time > 0:
        metrics["time"] = reconstruction_time
        if n_frames > 0:
            metrics["FPS"] = n_frames / reconstruction_time
    metrics.update(scene_model.evaluate(with_lpips=with_lpips))
    if not path:
        return metrics
    os.makedirs(path, exist_ok=True)
    pcd_path = os.path.join(path, "point_clouds")
    os.makedirs(pcd_path, exist_ok=True)
    save_gaussian_ply(os.path.join(pcd_path, "gs.ply"), scene_model)
    save_xyz_rgb_ply(os.path.join(pcd_path, "xyz_rgb.ply"), scene_model)

    Rts = _np(KFmod.get_all_Rt(scene_model.pool))
    kfs = [kf for kf in scene_model.keyframes if kf is not None]
    kf_json = [{"info": {"is_test": bool(kf.is_test), "name": kf.image_name},
                "Rt": Rts[kf.index].tolist(), "f": scene_model.f} for kf in kfs]
    metadata = {**metrics,
                "config": {"width": scene_model.width, "height": scene_model.height,
                           "sh_degree": scene_model.cfg.sh_degree, "f": scene_model.f},
                "keyframes": kf_json}
    with open(os.path.join(path, "metadata.json"), "w") as f:
        json.dump(metadata, f, indent=4, default=str)

    if save_renders:
        save_test_frames(scene_model, os.path.join(path, "test_images"))

    cameras, images = {}, {}
    cx, cy = (scene_model.width - 1) / 2, (scene_model.height - 1) / 2
    for kf in kfs:
        i = kf.index
        cameras[i] = dict(model_id=0, width=scene_model.width, height=scene_model.height,
                          params=[scene_model.f, cx, cy])  # SIMPLE_PINHOLE
        images[i] = dict(qvec=rotmat_to_qvec(Rts[i, :3, :3]).tolist(),
                         tvec=Rts[i, :3, 3].tolist(), camera_id=i, name=kf.image_name)
    colmap_dir = os.path.join(path, "colmap")
    write_colmap_model(colmap_dir, cameras, images)
    save_xyz_rgb_ply(os.path.join(colmap_dir, "points3D.ply"), scene_model)

    with open(os.path.join(path, "onthefly.txt"), "w") as f1:
        for kf in kfs:
            Twc = np.linalg.inv(Rts[kf.index])
            q = rotmat_to_qvec(Twc[:3, :3])
            x, y, z = Twc[:3, 3]
            name = os.path.splitext(kf.image_name)[0]
            f1.write(f"{name} {x} {y} {z} {q[1]} {q[2]} {q[3]} {q[0]}\n")
    save_poses_as_pyramid_ply(np.asarray([Rts[kf.index] for kf in kfs]),
                              os.path.join(path, "onthefly.ply"), size=0.3, color="red")
    return metrics


def save_test_frames(scene_model, out_dir: str):
    """Render the test views and write them as PNG."""
    os.makedirs(out_dir, exist_ok=True)
    for kf in scene_model.keyframes:
        if kf is None or not kf.is_test:
            continue
        img = _np(torch.clamp(scene_model.render_from_id(kf.index, pyr_lvl=0)["render"], 0, 1))
        arr = (img.transpose(1, 2, 0) * 255).astype(np.uint8)
        write_png(os.path.join(out_dir, f"{kf.index:05d}.png"), np.ascontiguousarray(arr))
