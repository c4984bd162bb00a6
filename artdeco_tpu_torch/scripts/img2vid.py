"""Assemble images into a video.

Port of ``scripts/img2vid.py`` without OpenCV: the PNG or JPEG frames of
``images_dir``, in name order, become an MP4 at ``--fps``.  The JAX script
writes MPEG-4 Part 2 (``mp4v``), which needs a codec library; this one
writes the same container, size, frame rate and frames as Motion JPEG
(``dataio.video.write_mp4``, each frame ``dataio.jpeg.encode_jpeg``'s
quality-50 JPEG), the departure the turntable MP4 also makes.  A frame
whose size differs from the first raises, where ``cv2.VideoWriter`` drops
it without a word.

Usage:
  python -m artdeco_tpu_torch.scripts.img2vid IMAGES_DIR [-o out.mp4] [--fps 30]
"""

import argparse
import os


def main(argv=None):
    from artdeco_tpu_torch.dataio.image_io import load_image
    from artdeco_tpu_torch.dataio.jpeg import encode_jpeg
    from artdeco_tpu_torch.dataio.video import write_mp4

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("images_dir")
    ap.add_argument("-o", "--out", default="out.mp4")
    ap.add_argument("--fps", type=int, default=30)
    args = ap.parse_args(argv)
    names = sorted(
        n for n in os.listdir(args.images_dir)
        if n.lower().endswith((".png", ".jpg", ".jpeg"))
    )
    if not names:
        raise SystemExit("no images found")
    samples, size = [], None
    for n in names:
        img = load_image(os.path.join(args.images_dir, n))
        if size is None:
            size = img.shape[:2]
        elif img.shape[:2] != size:
            raise ValueError(f"{n}: {img.shape[1]}x{img.shape[0]}, not the first frame's "
                             f"{size[1]}x{size[0]}")
        samples.append(encode_jpeg(img))
    h, w = size
    write_mp4(args.out, samples, w, h, args.fps)
    print(f"wrote {args.out} ({len(names)} frames)")


if __name__ == "__main__":
    main()
