"""Undistort TUM RGB-D sequences into the rectified layout the system trains on.

Port of ``scripts/rectify_tum.py`` without OpenCV: the per-scene
intrinsics of record (the TUM calibration constants), rectification to a
centred principal point with square pixels (``getOptimalNewCameraMatrix``
at alpha 1, ``dataio.camera.optimal_new_camera_matrix``), plus validity
masks.  Reads ``<scene>/rgb`` through ``dataio.image_io.load_image`` (PNG
everywhere; JPEG only where the native loader can be built) and writes
``<scene>/images`` (RGBA PNG: the JAX script's BGRA file holds the same
pixels), ``<scene>/masks`` (grey PNG) and ``<scene>/calib.yaml``, the
rectified intrinsics for the ``--calib`` flag.  The image is resampled with
OpenCV's reflected border and the mask with a zero one
(``dataio.resample.remap_bilinear``), bit for bit ``cv2.remap``.

Usage:
  python -m artdeco_tpu_torch.scripts.rectify_tum --base_dir data \\
      [--scenes TUM/rgbd_dataset_freiburg1_desk ...]
"""

import argparse
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# OpenCV ordering: fx, fy, cx, cy, k1, k2, p1, p2[, k3] — the published TUM
# freiburg calibrations
TUM_CALIB = {
    "TUM/rgbd_dataset_freiburg1_desk": [
        517.306408, 516.469215, 318.643040, 255.313989,
        0.262383, -0.953104, -0.005358, 0.002628, 1.163314],
    "TUM/rgbd_dataset_freiburg2_xyz": [
        520.908620, 521.007327, 325.141442, 249.701764,
        0.231222, -0.784899, -0.003257, -0.000105, 0.917205],
    "TUM/rgbd_dataset_freiburg3_long_office_household": [
        535.4, 539.2, 320.1, 247.6, 0.0, 0.0, 0.0, 0.0],
}


def rectified_K(params, h, w):
    """New camera matrix: keep all pixels (alpha=1), then square the focal."""
    from artdeco_tpu_torch.dataio.camera import optimal_new_camera_matrix

    K_in = np.array([[params[0], 0.0, params[2]],
                     [0.0, params[1], params[3]],
                     [0.0, 0.0, 1.0]])
    dist = np.asarray(params[4:], np.float64)
    K_out = optimal_new_camera_matrix(K_in, dist, w, h, alpha=1)
    f = 0.5 * (K_out[0, 0] + K_out[1, 1])
    K_out[0, 0] = K_out[1, 1] = f
    return K_in, dist, K_out


def list_images(folder):
    exts = {".jpg", ".jpeg", ".png"}
    return sorted(
        n for n in os.listdir(folder)
        if os.path.splitext(n)[1].lower() in exts
    )


def rectify_scene(scene_dir: str, params):
    from artdeco_tpu_torch.dataio.camera import undistort_maps
    from artdeco_tpu_torch.dataio.image_io import load_image
    from artdeco_tpu_torch.dataio.resample import remap_bilinear
    from artdeco_tpu_torch.mapper.scene_io import write_png

    in_dir = os.path.join(scene_dir, "rgb")
    out_dir = os.path.join(scene_dir, "images")
    mask_dir = os.path.join(scene_dir, "masks")
    os.makedirs(out_dir, exist_ok=True)
    os.makedirs(mask_dir, exist_ok=True)

    names = list_images(in_dir)
    if not names:
        print(f"  {scene_dir}: no images under rgb/, skipped")
        return
    h, w = load_image(os.path.join(in_dir, names[0])).shape[:2]
    K_in, dist, K_out = rectified_K(params, h, w)
    mapx, mapy = undistort_maps(K_in, dist, K_out, w, h)
    # the mask is the same for every frame: computed once
    ones = np.full((h, w), 255, np.uint8)
    mask = remap_bilinear(ones, mapx, mapy)
    mask = np.where(mask == 0, 0, 255).astype(np.uint8)

    def one(name):
        img = load_image(os.path.join(in_dir, name))
        rect = remap_bilinear(img, mapx, mapy, border="reflect")
        rect[mask == 0] = 0
        rgba = np.concatenate([rect, mask[..., None]], axis=-1)
        write_png(os.path.join(out_dir, name), rgba)
        write_png(os.path.join(mask_dir, os.path.splitext(name)[0] + ".png"), mask)

    with ThreadPoolExecutor() as ex:
        list(ex.map(one, names))

    with open(os.path.join(scene_dir, "calib.yaml"), "w") as f:
        f.write(f"fx: {K_out[0, 0]:.6f}\n"
                f"fy: {K_out[1, 1]:.6f}\n"
                f"cx: {K_out[0, 2]:.6f}\n"
                f"cy: {K_out[1, 2]:.6f}\n"
                f"width: {w}\nheight: {h}\ndistortion: []\n")
    print(f"  {scene_dir}: {len(names)} images rectified "
          f"(f={K_out[0, 0]:.1f})")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--base_dir", default="data")
    ap.add_argument("--scenes", nargs="+", default=list(TUM_CALIB))
    args = ap.parse_args(argv)
    for scene in args.scenes:
        params = TUM_CALIB.get(scene)
        if params is None:
            print(f"  {scene}: no calibration of record, skipped")
            continue
        rectify_scene(os.path.join(args.base_dir, scene), params)


if __name__ == "__main__":
    main()
