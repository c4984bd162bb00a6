"""MP4 files of JPEG frames, without OpenCV or a codec library.

The JAX package writes its turntables with ``cv2.VideoWriter(path,
fourcc("mp4v"), 30, (w, h))``, MPEG-4 Part 2.  Writing that codec needs a
codec library, so ``write_mp4`` keeps the container, the frame rate and the
frames and changes the codec: an ISO base media file (``ftyp``, ``mdat``,
``moov`` with one video ``trak``) whose samples are baseline JPEG frames
under a ``jpeg`` visual sample entry (Motion JPEG, which FFmpeg and
players read).  ``read_mp4_samples`` reads such a file's samples back.
"""

from __future__ import annotations

import struct

import numpy as np

_MATRIX = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)


def _box(kind: bytes, *payload: bytes) -> bytes:
    body = b"".join(payload)
    return struct.pack(">I", 8 + len(body)) + kind + body


def _full_box(kind: bytes, version: int, flags: int, *payload: bytes) -> bytes:
    return _box(kind, struct.pack(">I", (version << 24) | flags), *payload)


def write_mp4(path: str, samples: list, width: int, height: int, fps: int = 30) -> None:
    """An MP4 of ``samples`` (JPEG files' bytes, ``dataio.jpeg.encode_jpeg``'s,
    one a frame of width x height) at ``fps``."""
    n = len(samples)
    if n == 0:
        raise ValueError("an MP4 needs at least one frame")
    ftyp = _box(b"ftyp", b"isom", struct.pack(">I", 512), b"isom", b"iso2", b"mp41")
    data = b"".join(samples)
    if len(ftyp) + 8 + len(data) >= 1 << 32:
        raise ValueError("write_mp4 writes 32-bit offsets: the frames exceed 4 GiB")
    mdat = _box(b"mdat", data)
    duration = n * 1000 // fps                     # in the movie's 1/1000 s
    mvhd = _full_box(b"mvhd", 0, 0, struct.pack(">IIII", 0, 0, 1000, duration),
                     struct.pack(">IH", 0x10000, 0x100), bytes(10), _MATRIX, bytes(24),
                     struct.pack(">I", 2))
    tkhd = _full_box(b"tkhd", 0, 3, struct.pack(">IIIII", 0, 0, 1, 0, duration), bytes(8),
                     struct.pack(">hhhH", 0, 0, 0, 0), _MATRIX,
                     struct.pack(">II", width << 16, height << 16))
    mdhd = _full_box(b"mdhd", 0, 0, struct.pack(">IIII", 0, 0, fps, n),
                     struct.pack(">HH", 0x55C4, 0))   # language "und"
    hdlr = _full_box(b"hdlr", 0, 0, struct.pack(">I", 0), b"vide", bytes(12),
                     b"VideoHandler\x00")
    vmhd = _full_box(b"vmhd", 0, 1, bytes(8))
    dinf = _box(b"dinf", _full_box(b"dref", 0, 0, struct.pack(">I", 1),
                                   _full_box(b"url ", 0, 1)))
    name = b"Photo - JPEG"
    entry = _box(b"jpeg", bytes(6), struct.pack(">H", 1), bytes(16),
                 struct.pack(">HHIIIH", width, height, 0x480000, 0x480000, 0, 1),
                 bytes([len(name)]) + name.ljust(31, b"\x00"), struct.pack(">Hh", 0x18, -1))
    stsd = _full_box(b"stsd", 0, 0, struct.pack(">I", 1), entry)
    stts = _full_box(b"stts", 0, 0, struct.pack(">III", 1, n, 1))
    stsc = _full_box(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, n, 1))
    stsz = _full_box(b"stsz", 0, 0, struct.pack(">II", 0, n),
                     np.asarray([len(s) for s in samples], ">u4").tobytes())
    stco = _full_box(b"stco", 0, 0, struct.pack(">II", 1, len(ftyp) + 8))
    stbl = _box(b"stbl", stsd, stts, stsc, stsz, stco)
    trak = _box(b"trak", tkhd, _box(b"mdia", mdhd, hdlr, _box(b"minf", vmhd, dinf, stbl)))
    with open(path, "wb") as f:
        f.write(ftyp + mdat + _box(b"moov", mvhd, trak))


def _boxes(buf: bytes, pos: int, end: int):
    while pos + 8 <= end:
        size, kind = struct.unpack(">I4s", buf[pos:pos + 8])
        if size < 8 or pos + size > end:
            raise ValueError(f"MP4: bad box {kind!r} at {pos}")
        yield kind, pos + 8, pos + size
        pos += size


def read_mp4_samples(path: str) -> dict:
    """The first track of a file ``write_mp4`` wrote: its sample entry's
    kind, width and height, the frame rate and every sample's bytes."""
    with open(path, "rb") as f:
        buf = f.read()
    found = {}

    def walk(pos, end):
        for kind, body, stop in _boxes(buf, pos, end):
            if kind in (b"moov", b"trak", b"mdia", b"minf", b"stbl"):
                walk(body, stop)
            else:
                found.setdefault(kind, buf[body:stop])

    walk(0, len(buf))
    stsd, stsz, stco = found[b"stsd"], found[b"stsz"], found[b"stco"]
    entry = stsd[8:]
    w, h = struct.unpack(">HH", entry[32:36])
    size, n = struct.unpack(">II", stsz[4:12])
    sizes = [size] * n if size else list(np.frombuffer(stsz[12:12 + 4 * n], ">u4"))
    n_chunks = struct.unpack(">I", stco[4:8])[0]
    if n_chunks != 1:
        raise ValueError(f"MP4: {n_chunks} chunks (write_mp4 writes one)")
    pos = struct.unpack(">I", stco[8:12])[0]
    samples = []
    for s in sizes:
        samples.append(buf[pos:pos + int(s)])
        pos += int(s)
    timescale = struct.unpack(">I", found[b"mdhd"][12:16])[0]
    delta = struct.unpack(">I", found[b"stts"][12:16])[0]
    return dict(kind=entry[4:8].decode(), width=w, height=h, fps=timescale / delta,
                samples=samples)
