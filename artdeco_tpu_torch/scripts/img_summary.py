"""Per-directory image count + first-image size summary (CSV).

Port of ``scripts/img_summary.py``: dataset vetting before a batch run,
how many frames each capture has and at what resolution.  The first
image's size comes from its file header (``dataio.image_io.image_size``:
PNG, JPEG with its Exif orientation, BMP, TIFF, WebP), without decoding
and without OpenCV.  A header that cannot be read raises, where the JAX
script prints an empty size.

Usage: python -m artdeco_tpu_torch.scripts.img_summary DIR [DIR ...]
"""

import os
import sys
from pathlib import Path

EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff", ".webp"}


def summarize(root: Path):
    from artdeco_tpu_torch.dataio.image_io import image_size

    count, first = 0, None
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            if Path(f).suffix.lower() in EXTS:
                count += 1
                if first is None:
                    first = Path(dirpath) / f
    size = ""
    if first is not None:
        w, h = image_size(str(first))
        size = f"{w}x{h}"
    return count, size


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(f"Usage: {Path(sys.argv[0]).name} DIR [DIR ...]",
              file=sys.stderr)
        raise SystemExit(1)
    print("name,count,image_size")
    counts = []
    for arg in argv:
        p = Path(arg)
        if not p.is_dir():
            print(f"{p.name},0,")
            continue
        count, size = summarize(p)
        counts.append(count)
        print(f"{p.name},{count},{size}")
    if counts:
        print(f"min {min(counts)} max {max(counts)}")


if __name__ == "__main__":
    main()
