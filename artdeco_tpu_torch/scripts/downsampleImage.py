"""Batch-downsample an image folder.

Port of ``scripts/downsampleImage.py`` without OpenCV: each PNG or JPEG of
``images_dir`` is shrunk by ``--factor`` as ``cv2.resize(img, (0, 0),
fx=1/f, fy=1/f, interpolation=cv2.INTER_AREA)`` does
(``dataio.resample.resize_area_scale``, bit for bit) and written under the
same name to ``--out``.  Frames are read through
``dataio.image_io.load_image`` (PNG everywhere; JPEG only where the native
loader can be built).  A ``.jpg``/``.jpeg`` output raises: ``cv2.imwrite``
encodes it at quality 95, and the port's encoder (``dataio/jpeg.py``)
writes quality 50 only.

Usage:
  python -m artdeco_tpu_torch.scripts.downsampleImage IMAGES_DIR -o OUT [--factor 2]
"""

import argparse
import os


def main(argv=None):
    from artdeco_tpu_torch.dataio.image_io import load_image
    from artdeco_tpu_torch.dataio.resample import resize_area_scale
    from artdeco_tpu_torch.mapper.scene_io import write_png

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("images_dir")
    ap.add_argument("-o", "--out", required=True)
    ap.add_argument("--factor", type=float, default=2.0)
    args = ap.parse_args(argv)
    names = [n for n in sorted(os.listdir(args.images_dir))
             if n.lower().endswith((".png", ".jpg", ".jpeg"))]
    jpegs = [n for n in names if not n.lower().endswith(".png")]
    if jpegs:
        raise NotImplementedError(
            f"{jpegs[0]}: writing JPEG at cv2.imwrite's quality 95 is not ported (the port's "
            f"encoder, dataio/jpeg.py, writes quality 50 only); convert the folder to PNG")
    os.makedirs(args.out, exist_ok=True)
    for n in names:
        img = load_image(os.path.join(args.images_dir, n))
        out = resize_area_scale(img, 1 / args.factor, 1 / args.factor)
        write_png(os.path.join(args.out, n), out)
    print("done")


if __name__ == "__main__":
    main()
