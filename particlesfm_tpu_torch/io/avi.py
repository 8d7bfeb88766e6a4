"""Pure-Python MJPEG-in-AVI video writer.

The reference ships a `motion_seg.mp4` debugging overlay written through
OpenCV (upstream motion_seg/main_motion_segmentation.py:114-119). This
image has no video codecs, but an AVI container holding baseline JPEG frames
(fourcc "MJPG") needs none: PIL emits the JPEGs and the RIFF container is a
fixed byte layout. Every mainstream player (ffmpeg, VLC, QuickTime, browsers
via ffmpeg.wasm) decodes MJPEG AVI.

Layout written (single video stream, index present):

    RIFF('AVI '
      LIST('hdrl' avih LIST('strl' strh strf))
      LIST('movi' '00dc'{jpeg} ...)
      'idx1' index)

A copy of particlesfm_tpu/io/avi.py: the same frames give the same bytes.
"""
from __future__ import annotations

import io
import struct
from pathlib import Path

import numpy as np

_AVIF_HASINDEX = 0x00000010
_AVIIF_KEYFRAME = 0x00000010


def _chunk(fourcc: bytes, payload: bytes) -> bytes:
    pad = b"\x00" if len(payload) % 2 else b""
    return fourcc + struct.pack("<I", len(payload)) + payload + pad


def _list(fourcc: bytes, payload: bytes) -> bytes:
    return _chunk(b"LIST", fourcc + payload)


def _encode_jpeg(frame, quality: int) -> bytes:
    from PIL import Image

    img = frame if isinstance(frame, Image.Image) else Image.fromarray(
        np.asarray(frame, np.uint8))
    buf = io.BytesIO()
    img.convert("RGB").save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def write_mjpeg_avi(path, frames, fps: int = 10, quality: int = 90) -> None:
    """Write `frames` (PIL Images or HxWx3 uint8 arrays, uniform size) as an
    MJPEG AVI at `path`."""
    jpegs = [_encode_jpeg(f, quality) for f in frames]
    if not jpegs:
        raise ValueError("write_mjpeg_avi: no frames")
    from PIL import Image

    f0 = frames[0]
    w, h = (f0.size if isinstance(f0, Image.Image)
            else (f0.shape[1], f0.shape[0]))
    maxbuf = max(len(j) for j in jpegs)

    avih = _chunk(b"avih", struct.pack(
        "<14I",
        int(1_000_000 / fps),        # dwMicroSecPerFrame
        maxbuf * fps,                # dwMaxBytesPerSec
        0,                           # dwPaddingGranularity
        _AVIF_HASINDEX,              # dwFlags
        len(jpegs),                  # dwTotalFrames
        0, 1,                        # dwInitialFrames, dwStreams
        maxbuf,                      # dwSuggestedBufferSize
        w, h, 0, 0, 0, 0))           # width, height, reserved[4]
    strh = _chunk(b"strh", b"vids" + b"MJPG" + struct.pack(
        "<IHHIIIIIIIi4H",
        0, 0, 0,                     # flags, priority, language
        0,                           # initial frames
        1, fps,                      # scale, rate -> fps
        0, len(jpegs),               # start, length (frames)
        maxbuf,                      # suggested buffer size
        0xFFFFFFFF, 0,               # quality, sample size
        0, 0, w, h))                 # rcFrame
    strf = _chunk(b"strf", struct.pack(
        "<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG", w * h * 3, 0, 0, 0, 0))
    hdrl = _list(b"hdrl", avih + _list(b"strl", strh + strf))

    movi_chunks, index, offset = [], [], 4   # 4 = len(b"movi")
    for j in jpegs:
        c = _chunk(b"00dc", j)
        movi_chunks.append(c)
        index.append(struct.pack("<4sIII", b"00dc", _AVIIF_KEYFRAME,
                                 offset, len(j)))
        offset += len(c)
    movi = _list(b"movi", b"".join(movi_chunks))
    idx1 = _chunk(b"idx1", b"".join(index))

    body = b"AVI " + hdrl + movi + idx1
    Path(path).write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)


def read_mjpeg_avi_frames(path) -> list:
    """Parse an MJPEG AVI back into decoded RGB uint8 arrays (test/debug aid:
    walks the movi list; not a general AVI reader)."""
    from PIL import Image

    data = Path(path).read_bytes()
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise ValueError("not an AVI file")
    frames = []
    pos = 12
    while pos + 8 <= len(data):
        fourcc = data[pos:pos + 4]
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        if fourcc == b"LIST":
            listtype = data[pos + 8:pos + 12]
            if listtype in (b"movi", b"hdrl"):
                pos += 12          # descend
                continue
            pos += 8 + size + (size % 2)
        elif fourcc == b"00dc":
            jpeg = data[pos + 8:pos + 8 + size]
            frames.append(np.asarray(Image.open(io.BytesIO(jpeg)).convert("RGB")))
            pos += 8 + size + (size % 2)
        else:
            pos += 8 + size + (size % 2)
    return frames
