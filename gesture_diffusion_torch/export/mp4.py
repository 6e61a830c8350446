"""Native MP4 (ISO base media / ISO-IEC 14496-12) muxer — no ffmpeg.

A copy of ``gesture_diffusion_tpu/export/mp4.py`` (numpy and struct), kept
here so the port never imports the JAX package.  It writes a
standards-track MP4:

  * video track — ``mp4v`` VisualSampleEntry whose ``esds``
    DecoderConfigDescriptor declares objectTypeIndication 0x6C (ISO/IEC
    10918-1, i.e. JPEG): Motion-JPEG-in-MP4 the MPEG-4-systems way
    (the JPEGs are encoded by Pillow);
  * audio track — ``sowt`` (16-bit little-endian PCM) AudioSampleEntry.

Layout: ``ftyp`` + one ``mdat`` (all JPEG frames, then the PCM) + ``moov``
with full sample tables (one chunk per track).  Box writing is bottom-up
pure bytes; a structural reader for tests walks the tree back.
"""

from __future__ import annotations

import struct
from typing import Iterable, List, Optional

import numpy as np

from .avi import check_fps, check_frame, encode_jpeg

_MVHD_MATRIX = struct.pack(">9i", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0,
                           0x40000000)


def _box(kind: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", len(payload) + 8) + kind + payload


def _full(kind: bytes, version: int, flags: int, payload: bytes) -> bytes:
    return _box(kind, struct.pack(">B3s", version,
                                  flags.to_bytes(3, "big")) + payload)


def _esds_jpeg(max_size: int, max_rate: int, avg_rate: int) -> bytes:
    """ES_Descriptor: DecoderConfig(OTI 0x6C = JPEG, streamType visual).
    bufferSizeDB must hold the largest access unit (one whole JPEG frame) —
    a strict demuxer sizes its elementary-stream buffer from it."""

    def desc(tag: int, payload: bytes) -> bytes:
        # expandable size, minimal encoding (payloads here are < 128)
        return bytes([tag, len(payload)]) + payload

    buffer_db = min(max(max_size, 0xFFFF), 0xFFFFFF)      # 24-bit field
    dec_conf = desc(0x04, struct.pack(
        ">BBBHII", 0x6C, (4 << 2) | 1,
        buffer_db >> 16, buffer_db & 0xFFFF, max_rate, avg_rate))
    sl_conf = desc(0x06, b"\x02")
    es = desc(0x03, struct.pack(">HB", 1, 0) + dec_conf + sl_conf)
    return _full(b"esds", 0, 0, es)


def _sample_tables(sizes: List[int], chunk_offset: int, delta: int,
                   n_samples: int, constant_size: int = 0) -> bytes:
    stts = _full(b"stts", 0, 0, struct.pack(">III", 1, n_samples, delta))
    stsc = _full(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, n_samples, 1))
    if constant_size:
        stsz = _full(b"stsz", 0, 0, struct.pack(">II", constant_size,
                                                n_samples))
    else:
        stsz = _full(b"stsz", 0, 0, struct.pack(">II", 0, n_samples)
                     + b"".join(struct.pack(">I", s) for s in sizes))
    stco = _full(b"stco", 0, 0, struct.pack(">II", 1, chunk_offset))
    return stts + stsc + stsz + stco


def _tkhd(track_id: int, duration_mv: int, w: int = 0, h: int = 0,
          volume: int = 0) -> bytes:
    # v0: creation, modification, track_ID, reserved, duration, reserved(8),
    # layer, alternate_group, volume, reserved(2), matrix, width, height
    return _full(b"tkhd", 0, 7, struct.pack(
        ">IIIII8xhhH2x36sII", 0, 0, track_id, 0, duration_mv,
        0, 0, volume, _MVHD_MATRIX, w << 16, h << 16))


def _mdhd(timescale: int, duration: int) -> bytes:
    return _full(b"mdhd", 0, 0, struct.pack(">IIIIHH", 0, 0, timescale,
                                            duration, 0x55C4, 0))


def _hdlr(handler: bytes, name: bytes) -> bytes:
    return _full(b"hdlr", 0, 0, struct.pack(">I4s12x", 0, handler)
                 + name + b"\0")


def _dinf() -> bytes:
    return _box(b"dinf", _full(b"dref", 0, 0, struct.pack(">I", 1)
                               + _full(b"url ", 0, 1, b"")))


def write_mp4(
    path: str,
    frames: Iterable[np.ndarray],        # (H, W, 3) uint8 RGB, equal sizes
    fps: float,
    audio: Optional[np.ndarray] = None,  # (S,) or (S, ch) float [-1,1] / int16
    sample_rate: int = 16000,
    quality: int = 85,
) -> str:
    """Mux MJPEG video (+ optional PCM audio) into an ISO-BMFF .mp4.

    Frames are consumed one at a time (producers may reuse their render
    buffer); only the compressed JPEGs are held."""
    check_fps(fps)
    encoded: List[bytes] = []
    h = w = None
    for i, f in enumerate(frames):
        f = check_frame(f, i, h, w)
        if h is None:
            h, w, _ = f.shape
        encoded.append(encode_jpeg(f, quality))
    if not encoded:
        raise ValueError("no frames")
    n = len(encoded)

    pcm = None
    channels = 0
    if audio is not None:
        a = np.asarray(audio)
        if a.dtype != np.int16:
            a = np.clip(np.asarray(a, np.float64), -1.0, 1.0)
            a = (a * 32767.0).astype(np.int16)
        if a.ndim == 1:
            a = a[:, None]
        channels = a.shape[1]
        pcm = np.ascontiguousarray(a)

    ftyp = _box(b"ftyp", b"isom" + struct.pack(">I", 512)
                + b"isomiso2mp41")
    video_bytes = b"".join(encoded)
    pcm_bytes = pcm.tobytes() if pcm is not None else b""
    mdat = _box(b"mdat", video_bytes + pcm_bytes)
    video_off = len(ftyp) + 8                    # first JPEG inside mdat
    audio_off = video_off + len(video_bytes)

    movie_timescale = 1000
    if float(fps) == int(fps):
        # integer rate: exact 1-tick-per-frame tables (the common path,
        # kept bit-identical with earlier writers)
        v_timescale, v_delta = int(fps), 1
    else:
        # fractional rate (e.g. 29.97): fixed 90 kHz media timescale with
        # a rounded per-frame delta (3003 for NTSC) — struct.pack needs
        # integers, so fps itself cannot be the timescale
        v_timescale = 90000
        v_delta = int(round(v_timescale / float(fps)))
    duration_mv = int(round(n * movie_timescale / fps))
    max_size = max(len(e) for e in encoded)
    avg_rate = int(sum(len(e) for e in encoded) * 8 * fps / n)

    # --- video trak -----------------------------------------------------
    max_rate = int(max(avg_rate, max_size * 8 * fps))  # worst frame at rate
    sample_entry = _box(b"mp4v", struct.pack(
        ">6xH16xHHII4xH32pHh", 1, w, h, 0x480000, 0x480000, 1, b"",
        24, -1) + _esds_jpeg(max_size, max_rate, avg_rate))
    stbl = _box(b"stbl",
                _full(b"stsd", 0, 0, struct.pack(">I", 1) + sample_entry)
                + _sample_tables([len(e) for e in encoded], video_off,
                                 v_delta, n))
    minf = _box(b"minf", _full(b"vmhd", 0, 1, struct.pack(">HHHH", 0, 0, 0, 0))
                + _dinf() + stbl)
    mdia = _box(b"mdia", _mdhd(v_timescale, n * v_delta)
                + _hdlr(b"vide", b"VideoHandler") + minf)
    traks = _box(b"trak", _tkhd(1, duration_mv, w, h) + mdia)

    # --- audio trak -----------------------------------------------------
    if pcm is not None:
        s_count = pcm.shape[0]
        entry = _box(b"sowt", struct.pack(
            ">6xH8xHH4xI", 1, channels, 16, sample_rate << 16))
        stbl_a = _box(
            b"stbl",
            _full(b"stsd", 0, 0, struct.pack(">I", 1) + entry)
            + _sample_tables([], audio_off, 1, s_count,
                             constant_size=2 * channels))
        minf_a = _box(b"minf", _full(b"smhd", 0, 0, struct.pack(">HH", 0, 0))
                      + _dinf() + stbl_a)
        mdia_a = _box(b"mdia", _mdhd(sample_rate, s_count)
                      + _hdlr(b"soun", b"SoundHandler") + minf_a)
        dur_a = int(round(s_count * movie_timescale / sample_rate))
        traks += _box(b"trak", _tkhd(2, dur_a, volume=0x0100) + mdia_a)
        duration_mv = max(duration_mv, dur_a)

    next_track = 3 if pcm is not None else 2
    mvhd = _full(b"mvhd", 0, 0, struct.pack(
        ">IIII", 0, 0, movie_timescale, duration_mv)
        + struct.pack(">iH10x", 0x10000, 0x0100) + _MVHD_MATRIX
        + struct.pack(">24xI", next_track))
    moov = _box(b"moov", mvhd + traks)

    with open(path, "wb") as f:
        f.write(ftyp + mdat + moov)
    return path


def read_mp4_structure(path: str) -> dict:
    """Walk the box tree and decode the sample tables (test oracle): box
    sizes must tile their containers exactly, and each trak reports its
    handler, sample-entry fourcc, timescale, sample count/sizes and chunk
    offset so tests can check every sample lands inside mdat."""
    with open(path, "rb") as f:
        data = f.read()

    containers = {b"moov", b"trak", b"mdia", b"minf", b"stbl", b"dinf"}

    def walk(pos: int, end: int) -> list:
        boxes = []
        while pos + 8 <= end:
            size, kind = struct.unpack(">I4s", data[pos:pos + 8])
            if size < 8 or pos + size > end:
                raise ValueError(f"bad box {kind!r} size {size} at {pos}")
            entry = {"type": kind.decode("latin1"), "size": size,
                     "offset": pos}
            if kind in containers:
                entry["children"] = walk(pos + 8, pos + size)
            boxes.append(entry)
            pos += size
        if pos != end:
            raise ValueError(f"container not exactly tiled: {pos} != {end}")
        return boxes

    top = walk(0, len(data))

    def find(boxes, kind):
        out = []
        for b in boxes:
            if b["type"] == kind:
                out.append(b)
            out.extend(find(b.get("children", []), kind))
        return out

    def payload(box, skip_fullbox=False):
        start = box["offset"] + 8 + (4 if skip_fullbox else 0)
        return data[start:box["offset"] + box["size"]]

    traks = []
    for trak in find(top, "trak"):
        kids = trak["children"]
        hdlr = find(kids, "hdlr")[0]
        mdhd = find(kids, "mdhd")[0]
        stsd = find(kids, "stsd")[0]
        stsz = find(kids, "stsz")[0]
        stco = find(kids, "stco")[0]
        stts = find(kids, "stts")[0]
        _, _, timescale, duration, _, _ = struct.unpack(
            ">IIIIHH", payload(mdhd, True)[:20])
        entry_fourcc = payload(stsd, True)[8:12].decode("latin1")
        sz = payload(stsz, True)
        const_size, n = struct.unpack(">II", sz[:8])
        sizes = ([const_size] * n if const_size else
                 list(struct.unpack(f">{n}I", sz[8:8 + 4 * n])))
        chunk_offset = struct.unpack(">II", payload(stco, True)[:8])[1]
        _, stts_count, stts_delta = struct.unpack(">III",
                                                  payload(stts, True)[:12])
        traks.append({
            "handler": payload(hdlr, True)[4:8].decode("latin1"),
            "sample_entry": entry_fourcc,
            "timescale": timescale,
            "duration": duration,
            "n_samples": n,
            "sizes": sizes,
            "chunk_offset": chunk_offset,
            "stts": (stts_count, stts_delta),
        })

    mdat = find(top, "mdat")[0]
    return {"top_types": [b["type"] for b in top],
            "n_traks": len(traks),
            "traks": traks,
            "mdat_range": (mdat["offset"] + 8,
                           mdat["offset"] + mdat["size"]),
            "file_size": len(data)}
