"""Video and frame writing on the host.

The port's own copy of the JAX package's writers (e2fgvi_tpu/data/
video.py). An .mp4 goes through OpenCV's VideoWriter with the mp4v fourcc
(the reference's own output, test.py:191-196), else imageio's ffmpeg, else
a self-contained MJPEG-in-MP4 muxer; other paths get a self-contained
MJPEG-AVI (RIFF container + JPEG frames via PIL). write_frames dumps
numbered PNGs (evaluate --save_results, reference evaluate.py:143-151).
"""

import io
import os
import struct

import numpy as np
from PIL import Image


def _fourcc(s):
    return s.encode("ascii")


def write_mjpeg_avi(path, frames, fps=24, quality=95):
    """frames: iterable of uint8 (H, W, 3) RGB arrays -> .avi file."""
    frames = list(frames)
    if not frames:
        raise ValueError("no frames")
    h, w = frames[0].shape[:2]
    jpegs = []
    for f in frames:
        buf = io.BytesIO()
        Image.fromarray(f).save(buf, format="JPEG", quality=quality)
        data = buf.getvalue()
        if len(data) % 2:
            data += b"\x00"
        jpegs.append(data)

    n = len(jpegs)
    usec_per_frame = int(1_000_000 / fps)
    max_bytes = max(len(j) for j in jpegs)

    avih = struct.pack(
        "<14I", usec_per_frame, max_bytes * fps, 0, 0x10, n, 0, 1,
        max_bytes, w, h, 0, 0, 0, 0)
    strh = _fourcc("vids") + _fourcc("MJPG") + struct.pack(
        "<IHHIIIIIIIIhhhh", 0, 0, 0, 0, 1, fps, 0, n, max_bytes, 0xFFFFFFFF,
        0, 0, 0, w, h)
    strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, _fourcc("MJPG"),
                       w * h * 3, 0, 0, 0, 0)

    def chunk(tag, data):
        pad = b"\x00" if len(data) % 2 else b""
        return _fourcc(tag) + struct.pack("<I", len(data)) + data + pad

    def lst(tag, data):
        return chunk("LIST", _fourcc(tag) + data)

    hdrl = lst("hdrl", chunk("avih", avih) +
               lst("strl", chunk("strh", strh) + chunk("strf", strf)))

    movi_items = b""
    offsets = []
    off = 4  # after 'movi'
    for j in jpegs:
        offsets.append((off, len(j)))
        movi_items += chunk("00dc", j)
        off += 8 + len(j) + (len(j) % 2)
    movi = lst("movi", movi_items)

    idx = b""
    for o, ln in offsets:
        idx += _fourcc("00dc") + struct.pack("<III", 0x10, o, ln)
    idx1 = chunk("idx1", idx)

    riff_body = _fourcc("AVI ") + hdrl + movi + idx1
    with open(path, "wb") as f:
        f.write(_fourcc("RIFF") + struct.pack("<I", len(riff_body)) +
                riff_body)


def _box(tag, payload):
    return struct.pack(">I", 8 + len(payload)) + _fourcc(tag) + payload


def _full_box(tag, version, flags, payload):
    return _box(tag, struct.pack(">B3s", version,
                                 flags.to_bytes(3, "big")) + payload)


def _mp4_descriptor(tag, payload):
    # MPEG-4 BaseDescriptor with minimal-length encoding (payloads < 128)
    assert len(payload) < 128
    return struct.pack(">BB", tag, len(payload)) + payload


def write_mjpeg_mp4(path, frames, fps=24, quality=95):
    """frames: iterable of uint8 (H, W, 3) RGB arrays -> .mp4 file.

    A self-contained ISO BMFF muxer: one video track whose samples are
    complete JPEG images, declared via an `mp4v` sample entry with an
    `esds` objectTypeIndication of 0x6C (ISO/IEC 10918-1 JPEG), the
    standard MJPEG-in-MP4 signaling, decodable by ffmpeg/VLC/QuickTime."""
    frames = list(frames)
    if not frames:
        raise ValueError("no frames")
    h, w = frames[0].shape[:2]
    jpegs = []
    for f in frames:
        buf = io.BytesIO()
        Image.fromarray(np.asarray(f, np.uint8)).save(
            buf, format="JPEG", quality=quality)
        jpegs.append(buf.getvalue())
    n = len(jpegs)
    mdat_payload = b"".join(jpegs)

    timescale = int(fps) * 512
    delta = timescale // int(fps)
    duration = n * delta

    ftyp = _box("ftyp", _fourcc("isom") + struct.pack(">I", 512)
                + _fourcc("isom") + _fourcc("iso2") + _fourcc("mp41"))

    # --- sample table -----------------------------------------------------
    max_jpeg = max(len(j) for j in jpegs)
    avg_rate = int(len(mdat_payload) * 8 * fps / n)
    dec_cfg = _mp4_descriptor(
        0x04,  # DecoderConfigDescriptor
        struct.pack(">BB3sII", 0x6C, (0x04 << 2) | 1,   # JPEG, visual stream
                    max_jpeg.to_bytes(3, "big"), avg_rate, avg_rate))
    es_desc = _mp4_descriptor(
        0x03, struct.pack(">HB", 1, 0) + dec_cfg
        + _mp4_descriptor(0x06, b"\x02"))               # SLConfig: MP4
    esds = _full_box("esds", 0, 0, es_desc)
    sample_entry = _box(
        "mp4v",
        b"\x00" * 6 + struct.pack(">H", 1)              # data_reference_index
        + b"\x00" * 16                                  # pre_defined/reserved
        + struct.pack(">HHIIIH", w, h, 0x00480000, 0x00480000, 0, 1)
        + b"\x05MJPEG" + b"\x00" * 26                   # compressorname
        + struct.pack(">Hh", 24, -1) + esds)
    stsd = _full_box("stsd", 0, 0, struct.pack(">I", 1) + sample_entry)
    stts = _full_box("stts", 0, 0, struct.pack(">III", 1, n, delta))
    stsc = _full_box("stsc", 0, 0, struct.pack(">IIII", 1, 1, n, 1))
    stsz = _full_box("stsz", 0, 0, struct.pack(">II", 0, n)
                     + b"".join(struct.pack(">I", len(j)) for j in jpegs))
    # one chunk holding every sample; its offset = ftyp + mdat header
    chunk_off = len(ftyp) + 8
    stco = _full_box("stco", 0, 0, struct.pack(">II", 1, chunk_off))
    stbl = _box("stbl", stsd + stts + stsc + stsz + stco)

    # --- track / movie boxes ---------------------------------------------
    dref = _full_box("dref", 0, 0,
                     struct.pack(">I", 1) + _full_box("url ", 0, 1, b""))
    minf = _box("minf",
                _full_box("vmhd", 0, 1, struct.pack(">4H", 0, 0, 0, 0))
                + _box("dinf", dref) + stbl)
    mdhd = _full_box("mdhd", 0, 0,
                     struct.pack(">IIIIHH", 0, 0, timescale, duration,
                                 0x55C4, 0))            # language "und"
    hdlr = _full_box("hdlr", 0, 0,
                     struct.pack(">I", 0) + _fourcc("vide")
                     + b"\x00" * 12 + b"VideoHandler\x00")
    mdia = _box("mdia", mdhd + hdlr + minf)
    matrix = struct.pack(">9i", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0,
                         0x40000000)
    tkhd = _full_box("tkhd", 0, 3,
                     struct.pack(">IIIII", 0, 0, 1, 0, duration)
                     + b"\x00" * 8 + struct.pack(">hhhH", 0, 0, 0, 0)
                     + matrix + struct.pack(">II", w << 16, h << 16))
    trak = _box("trak", tkhd + mdia)
    mvhd = _full_box("mvhd", 0, 0,
                     struct.pack(">IIII", 0, 0, timescale, duration)
                     + struct.pack(">IH", 0x00010000, 0x0100) + b"\x00" * 10
                     + matrix + b"\x00" * 24 + struct.pack(">I", 2))
    moov = _box("moov", mvhd + trak)

    with open(path, "wb") as f:
        f.write(ftyp + _box("mdat", mdat_payload) + moov)


def write_video(path, frames, fps=24):
    """Write RGB uint8 frames with the best available backend; returns the
    path written. An .mp4 request always produces an mp4."""
    frames = [np.asarray(f, np.uint8) for f in frames]
    if path.endswith(".mp4"):
        try:
            # the reference's own writer (test.py:191-196): cv2 mp4v
            import cv2
            h, w = frames[0].shape[:2]
            wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"),
                                 fps, (w, h))
            if wr.isOpened():
                for f in frames:
                    wr.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
                wr.release()
                if os.path.getsize(path) > 0:
                    return path
            wr.release()
        except ImportError:
            pass
        try:
            import imageio
            with imageio.get_writer(path, fps=fps) as wr:
                for f in frames:
                    wr.append_data(f)
            return path
        except Exception:
            write_mjpeg_mp4(path, frames, fps=fps)
            return path
    if not path.endswith(".avi"):
        path = path + ".avi"
    write_mjpeg_avi(path, frames, fps=fps)
    return path


def write_frames(dirpath, frames):
    """Dump frames as zero-padded PNGs (for external E_warp evaluation)."""
    os.makedirs(dirpath, exist_ok=True)
    for i, f in enumerate(frames):
        Image.fromarray(np.asarray(f, np.uint8)).save(
            os.path.join(dirpath, f"{i:05d}.png"))
