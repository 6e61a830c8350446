"""Dependency-free AVI muxer: video frames + PCM audio in one file.

A copy of ``gesture_diffusion_tpu/export/avi.py`` (numpy and struct), kept
here so the port never imports the JAX package.  It writes the RIFF/AVI
container directly, with no ffmpeg: MJPEG frames (encoded by Pillow,
imported only when a frame is encoded) or uncompressed bottom-up BGR DIB
frames (``codec="raw"``, no Pillow), interleaved with 16-bit PCM audio
chunks, plus the idx1 index.
"""

from __future__ import annotations

import io
import struct
from typing import Iterable, Optional

import numpy as np

_AVIF_HASINDEX = 0x10
_AVIF_ISINTERLEAVED = 0x100
_AVIIF_KEYFRAME = 0x10


def _chunk(fourcc: bytes, payload: bytes) -> bytes:
    pad = b"\0" if len(payload) % 2 else b""
    return fourcc + struct.pack("<I", len(payload)) + payload + pad


def _list(kind: bytes, payload: bytes) -> bytes:
    return _chunk(b"LIST", kind + payload)


def check_frame(f: np.ndarray, i: int, h, w) -> np.ndarray:
    """Shared muxer frame validation: (H, W, 3) uint8, uniform sizes.

    Without it a float frame silently truncates to near-black and a
    mid-stream size change writes a container whose header promises the
    first frame's geometry — both produced 'valid' but corrupt files."""
    f = np.asarray(f)
    if f.dtype != np.uint8:
        raise ValueError(
            f"frame {i}: expected uint8 RGB, got dtype {f.dtype} "
            "(scale to 0-255 and cast explicitly)")
    if f.ndim != 3 or f.shape[-1] != 3:
        raise ValueError(f"frame {i}: expected (H, W, 3), got {f.shape}")
    if h is not None and f.shape[:2] != (h, w):
        raise ValueError(
            f"frame {i}: size {f.shape[:2]} != first frame's {(h, w)}")
    return np.ascontiguousarray(f)


def check_fps(fps) -> None:
    try:
        val = float(fps)
    except (TypeError, ValueError):
        raise ValueError(
            f"fps must be a positive finite number, got {fps!r}") from None
    if not (val > 0 and np.isfinite(val)):
        raise ValueError(f"fps must be positive and finite, got {fps!r}")


def encode_jpeg(frame: np.ndarray, quality: int) -> bytes:
    """(H, W, 3) uint8 RGB -> JPEG bytes (shared by the avi/mp4 muxers)."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(frame, np.uint8)).save(
        buf, format="JPEG", quality=quality)
    return buf.getvalue()


def _encode_frame(frame: np.ndarray, codec: str, quality: int) -> bytes:
    """(H, W, 3) uint8 RGB -> encoded chunk payload."""
    if codec == "mjpeg":
        return encode_jpeg(frame, quality)
    # raw DIB: bottom-up rows, BGR, each row padded to 4 bytes
    h, w, _ = frame.shape
    bgr = frame[::-1, :, ::-1]
    row = bgr.reshape(h, w * 3)
    pad = (-w * 3) % 4
    if pad:
        row = np.concatenate([row, np.zeros((h, pad), np.uint8)], axis=1)
    return row.tobytes()


def write_avi(
    path: str,
    frames: Iterable[np.ndarray],        # (H, W, 3) uint8 RGB, equal sizes
    fps: int,
    audio: Optional[np.ndarray] = None,  # (S,) or (S, ch) float [-1,1] or int16
    sample_rate: int = 16000,
    codec: str = "mjpeg",
    quality: int = 85,
) -> str:
    # stream-encode: consume the iterator one frame at a time (a 60 s clip
    # holds ~1 GB of raw RGB; the compressed chunks are what we keep), and
    # never hold a caller-yielded buffer past its iteration — producers
    # that reuse a render buffer stay correct
    check_fps(fps)
    it = iter(frames)
    encoded = []
    h = w = None
    for i, f in enumerate(it):
        f = check_frame(f, i, h, w)
        if h is None:
            h, w, _ = f.shape
        encoded.append(_encode_frame(f, codec, quality))
    if not encoded:
        raise ValueError("no frames")
    n = len(encoded)
    vid_id = b"00dc" if codec == "mjpeg" else b"00db"

    pcm = None
    block_align = 0
    channels = 0
    if audio is not None:
        a = np.asarray(audio)
        if a.dtype != np.int16:
            a = np.clip(np.asarray(a, np.float64), -1.0, 1.0)
            a = (a * 32767.0).astype(np.int16)
        if a.ndim == 1:
            a = a[:, None]
        channels = a.shape[1]
        block_align = 2 * channels
        pcm = np.ascontiguousarray(a)

    # movi payload: interleave one video frame + the matching audio span.
    # Built as a chunk list + running offset (repeated bytes += is O(n^2))
    parts = []
    index = []
    offset = 4                    # index offsets count from the movi fourcc
    samples_per_frame = (sample_rate // fps) if pcm is not None else 0
    for i, data in enumerate(encoded):
        index.append(struct.pack("<4sIII", vid_id, _AVIIF_KEYFRAME,
                                 offset, len(data)))
        parts.append(_chunk(vid_id, data))
        offset += len(parts[-1])
        if pcm is not None:
            s0 = i * samples_per_frame
            s1 = pcm.shape[0] if i == n - 1 else (i + 1) * samples_per_frame
            if s0 < pcm.shape[0]:
                a_data = pcm[s0:s1].tobytes()
                index.append(struct.pack("<4sIII", b"01wb", _AVIIF_KEYFRAME,
                                         offset, len(a_data)))
                parts.append(_chunk(b"01wb", a_data))
                offset += len(parts[-1])
    movi_payload = b"".join(parts)
    index = b"".join(index)

    max_chunk = max(len(e) for e in encoded) + 8

    avih = struct.pack(
        "<IIIIIIIIIIIIII",
        int(1e6 / fps), max_chunk * fps, 0,
        _AVIF_HASINDEX | _AVIF_ISINTERLEAVED,
        n, 0, 2 if pcm is not None else 1, max_chunk, w, h, 0, 0, 0, 0)

    vstrh = struct.pack(
        "<4s4sIHHIIIIIIiI4H",
        b"vids", b"MJPG" if codec == "mjpeg" else b"DIB ",
        0, 0, 0, 0, 1, fps, 0, n, max_chunk, -1, 0,
        0, 0, w, h)
    vstrf = struct.pack(
        "<IiiHHIIiiII", 40, w, h, 1,
        24, 0x47504A4D if codec == "mjpeg" else 0,     # 'MJPG' | BI_RGB
        w * h * 3, 0, 0, 0, 0)
    strl_v = _list(b"strl", _chunk(b"strh", vstrh) + _chunk(b"strf", vstrf))

    hdrl = _chunk(b"avih", avih) + strl_v
    if pcm is not None:
        astrh = struct.pack(
            "<4s4sIHHIIIIIIiI4H",
            b"auds", b"\0\0\0\0", 0, 0, 0, 0,
            1, sample_rate, 0, pcm.shape[0],
            sample_rate * block_align, -1,
            block_align, 0, 0, 0, 0)
        astrf = struct.pack("<HHIIHH", 1, channels, sample_rate,
                            sample_rate * block_align, block_align, 16)
        hdrl += _list(b"strl", _chunk(b"strh", astrh) + _chunk(b"strf", astrf))

    body = (_list(b"hdrl", hdrl)
            + _list(b"movi", movi_payload)
            + _chunk(b"idx1", index))
    with open(path, "wb") as f:
        f.write(_chunk(b"RIFF", b"AVI " + body))
    return path


def read_avi_structure(path: str) -> dict:
    """Minimal RIFF walker for validation: returns header fields and chunk
    counts (used by tests; not a decoder)."""
    with open(path, "rb") as f:
        blob = f.read()
    assert blob[:4] == b"RIFF" and blob[8:12] == b"AVI "
    out = {"video_frames": 0, "audio_chunks": 0, "audio_bytes": 0}

    def walk(data, pos, end):
        while pos < end:
            fourcc = data[pos:pos + 4]
            size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
            payload0 = pos + 8
            if fourcc == b"LIST":
                walk(data, payload0 + 4, payload0 + size)
            elif fourcc == b"avih":
                (out["usec_per_frame"], _, _, out["flags"], out["frames"],
                 _, out["streams"], _, out["width"], out["height"]
                 ) = struct.unpack("<10I", data[payload0:payload0 + 40])
            elif fourcc in (b"00dc", b"00db"):
                out["video_frames"] += 1
            elif fourcc == b"01wb":
                out["audio_chunks"] += 1
                out["audio_bytes"] += size
            elif fourcc == b"idx1":
                out["index_entries"] = size // 16
            pos = payload0 + size + (size % 2)

    walk(blob, 12, len(blob))
    return out
