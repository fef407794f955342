"""Video export: mux recorded frames into a playable file without ffmpeg.

The reference records MP4 through PyBullet's GUI capture
(BaseAviary.py:523-537) and ships `assets/ffmpeg_png2mp4.sh` for turning PNG
sequences into MP4. This image has no ffmpeg and no pip installs, so the
portable equivalent is a **pure-Python MJPEG AVI muxer**: each frame is a
JPEG (encoded by Pillow) wrapped in a RIFF/AVI container with the MJPG fourcc
— playable by VLC/mpv/ffplay/QuickTime and convertible losslessly to MP4 with
`ffmpeg -i out.avi -c copy out.mp4` where ffmpeg exists. `encode_video`
prefers ffmpeg (true MP4) when it is on PATH and falls back to the muxer.
"""

import io
import os
import shutil
import struct
import subprocess

import numpy as np


def _jpeg_bytes(frame: np.ndarray, quality: int = 90) -> bytes:
    from PIL import Image

    arr = np.asarray(frame)
    if arr.dtype != np.uint8:
        # Float frames in matplotlib's [0, 1] convention would clip to 0/1
        # intensity (a black video); rescale them to [0, 255] first.
        if np.issubdtype(arr.dtype, np.floating) and arr.size and arr.max() <= 1.0:
            arr = arr * 255.0
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    if arr.ndim == 3 and arr.shape[2] == 4:
        arr = arr[:, :, :3]
    buf = io.BytesIO()
    Image.fromarray(arr).convert("RGB").save(buf, format="JPEG",
                                             quality=quality)
    return buf.getvalue()


def write_mjpeg_avi(frames, path: str, fps: int = 24, quality: int = 90) -> str:
    """Write an iterable of HxWx{3,4} uint8 frames as an MJPG-fourcc AVI.

    RIFF layout: hdrl(avih + strl(strh,strf)) + movi(00dc JPEG chunks) + idx1.
    """
    jpegs = [_jpeg_bytes(f, quality) for f in frames]
    if not jpegs:
        raise ValueError("no frames to encode")
    # Recover dimensions from the first JPEG via PIL (robust for generators)
    from PIL import Image

    with Image.open(io.BytesIO(jpegs[0])) as im:
        width, height = im.size
    n = len(jpegs)

    def chunk(fourcc: bytes, payload: bytes) -> bytes:
        pad = b"\x00" if len(payload) % 2 else b""
        return fourcc + struct.pack("<I", len(payload)) + payload + pad

    def lst(fourcc: bytes, payload: bytes) -> bytes:
        body = fourcc + payload
        pad = b"\x00" if len(body) % 2 else b""
        return b"LIST" + struct.pack("<I", len(body)) + body + pad

    max_bytes = max(len(j) for j in jpegs)
    avih = struct.pack(
        "<14I",
        int(1e6 // fps),       # dwMicroSecPerFrame
        max_bytes * fps,       # dwMaxBytesPerSec
        0,                     # dwPaddingGranularity
        0x10,                  # dwFlags: AVIF_HASINDEX
        n, 0, 1, 0,            # totalframes, initialframes, streams, bufsize
        width, height,
        0, 0, 0, 0,            # reserved
    )
    strh = struct.pack(
        "<4s4sIHHIIIIIIIIhhhh",
        b"vids", b"MJPG", 0, 0, 0, 0,
        1, fps,                # scale, rate -> fps
        0, n, max_bytes, 0xFFFFFFFF, 0,
        0, 0, width, height,
    )
    strf = struct.pack(
        "<IiiHH4sIiiII",
        40, width, height, 1, 24, b"MJPG",
        width * height * 3, 0, 0, 0, 0,
    )
    hdrl = lst(b"hdrl", chunk(b"avih", avih)
               + lst(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)))

    movi_chunks, idx, offset = [], [], 4  # offset relative to 'movi' fourcc
    for j in jpegs:
        c = chunk(b"00dc", j)
        movi_chunks.append(c)
        idx.append(struct.pack("<4sIII", b"00dc", 0x10, offset, len(j)))
        offset += len(c)
    movi = lst(b"movi", b"".join(movi_chunks))
    idx1 = chunk(b"idx1", b"".join(idx))

    body = b"AVI " + hdrl + movi + idx1
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)
    return path


def encode_video(frames, path: str, fps: int = 24) -> str:
    """Frames -> video file. Uses ffmpeg (H.264 MP4) when available; falls
    back to the built-in MJPEG AVI muxer (path extension switched to .avi)."""
    frames = list(frames)  # may need two passes (ffmpeg then fallback)
    if shutil.which("ffmpeg") and path.endswith(".mp4"):
        import tempfile

        try:
            with tempfile.TemporaryDirectory() as td:
                from PIL import Image

                for i, fr in enumerate(frames):
                    arr = np.asarray(fr)
                    if arr.ndim == 3 and arr.shape[2] == 4:
                        arr = arr[:, :, :3]
                    Image.fromarray(arr.astype(np.uint8)).save(
                        os.path.join(td, f"f{i:06d}.png"))
                subprocess.run(
                    ["ffmpeg", "-y", "-framerate", str(fps), "-i",
                     os.path.join(td, "f%06d.png"), "-pix_fmt", "yuv420p",
                     path],
                    check=True, capture_output=True)
            return path
        except (subprocess.CalledProcessError, OSError):
            # a present-but-broken ffmpeg (missing encoder, sandbox) must not
            # defeat the dependency-free fallback this module exists for
            pass
    if path.endswith(".mp4"):
        path = path[:-4] + ".avi"
    return write_mjpeg_avi(frames, path, fps=fps)


def png_dir_to_video(png_dir: str, out_path: str = None, fps: int = 24) -> str:
    """Mux a directory of numbered PNG frames (the record=True output,
    compat/gym.py) into one playable file — the ffmpeg_png2mp4.sh analogue."""
    from PIL import Image

    names = sorted(f for f in os.listdir(png_dir) if f.endswith(".png"))
    if not names:
        raise FileNotFoundError(f"no PNG frames in {png_dir}")
    frames = [np.asarray(Image.open(os.path.join(png_dir, f)).convert("RGB"))
              for f in names]
    out = out_path or os.path.join(png_dir, "video.mp4")
    return encode_video(frames, out, fps=fps)
