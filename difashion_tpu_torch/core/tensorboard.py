"""Pure-Python TensorBoard event writer and reader (no TensorFlow or
tensorboardX). Copy of `difashion_tpu/core/tensorboard.py`: given the same
wall times, the writer emits the same bytes as the JAX package's.

The training loop logs its scalars per logged step (and validation sample
grids) as a TFRecord stream of `tensorflow.Event` protos with masked-CRC32C
framing, readable by TensorBoard and by `read_events` below.

Wire format (both directions implemented here):
  record  = uint64 length | uint32 masked_crc(length) | data | uint32 masked_crc(data)
  Event   = 1: double wall_time | 2: int64 step | 3: string file_version
            | 5: Summary
  Summary = repeated 1: Value;  Value = 1: string tag | 2: float simple_value
            | 4: Image;  Image = 1: int32 height | 2: int32 width
            | 3: int32 colorspace (3 = RGB) | 4: bytes encoded (PNG)
"""
from __future__ import annotations

import os
import socket
import struct
import time
from typing import Iterator, Optional, Tuple

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), table-driven, with the TFRecord mask
# ---------------------------------------------------------------------------

_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if not _CRC_TABLE:
        poly = 0x82F63B78
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            table.append(c)
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# minimal protobuf encode/decode
# ---------------------------------------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _encode_event(wall_time: float, step: Optional[int] = None,
                  file_version: Optional[str] = None,
                  scalars: Optional[dict] = None,
                  images: Optional[dict] = None) -> bytes:
    """images: {tag: (height, width, colorspace, encoded_png_bytes)}."""
    out = bytearray()
    out += b"\x09" + struct.pack("<d", wall_time)            # 1: wall_time
    if step is not None:
        out += b"\x10" + _varint(step & 0xFFFFFFFFFFFFFFFF)  # 2: step
    if file_version is not None:
        fv = file_version.encode()
        out += b"\x1a" + _varint(len(fv)) + fv               # 3: file_version
    if scalars or images:
        summary = bytearray()
        for tag, value in (scalars or {}).items():
            t = tag.encode()
            v = (b"\x0a" + _varint(len(t)) + t               # Value.tag
                 + b"\x15" + struct.pack("<f", float(value)))  # Value.simple_value
            summary += b"\x0a" + _varint(len(v)) + v         # Summary.value
        for tag, (h, w, cs, png) in (images or {}).items():
            img = (b"\x08" + _varint(h)                      # Image.height
                   + b"\x10" + _varint(w)                    # Image.width
                   + b"\x18" + _varint(cs)                   # Image.colorspace
                   + b"\x22" + _varint(len(png)) + png)      # Image.encoded
            t = tag.encode()
            v = (b"\x0a" + _varint(len(t)) + t               # Value.tag
                 + b"\x22" + _varint(len(img)) + img)        # Value.image
            summary += b"\x0a" + _varint(len(v)) + v         # Summary.value
        out += b"\x2a" + _varint(len(summary)) + bytes(summary)  # 5: summary
    return bytes(out)


def _decode_event(data: bytes) -> dict:
    ev: dict = {"scalars": {}, "images": {}}
    pos = 0
    while pos < len(data):
        key, pos = _read_varint(data, pos)
        field, wire = key >> 3, key & 7
        if wire == 1:       # 64-bit
            val = data[pos:pos + 8]
            pos += 8
            if field == 1:
                ev["wall_time"] = struct.unpack("<d", val)[0]
        elif wire == 0:     # varint
            val, pos = _read_varint(data, pos)
            if field == 2:
                ev["step"] = val
        elif wire == 2:     # length-delimited
            ln, pos = _read_varint(data, pos)
            val = data[pos:pos + ln]
            pos += ln
            if field == 3:
                ev["file_version"] = val.decode()
            elif field == 5:
                _decode_summary(val, ev["scalars"], ev["images"])
        elif wire == 5:     # 32-bit
            pos += 4
        else:
            break
    return ev


def _decode_summary(data: bytes, scalars: dict,
                    images: Optional[dict] = None) -> None:
    pos = 0
    while pos < len(data):
        key, pos = _read_varint(data, pos)
        if key >> 3 == 1 and key & 7 == 2:
            ln, pos = _read_varint(data, pos)
            v = data[pos:pos + ln]
            pos += ln
            tag, value, image, vp = None, None, None, 0
            while vp < len(v):
                vkey, vp = _read_varint(v, vp)
                if vkey >> 3 == 1 and vkey & 7 == 2:
                    vl, vp = _read_varint(v, vp)
                    tag = v[vp:vp + vl].decode()
                    vp += vl
                elif vkey >> 3 == 2 and vkey & 7 == 5:
                    value = struct.unpack("<f", v[vp:vp + 4])[0]
                    vp += 4
                elif vkey >> 3 == 4 and vkey & 7 == 2:
                    vl, vp = _read_varint(v, vp)
                    image = _decode_image(v[vp:vp + vl])
                    vp += vl
                else:
                    break
            if tag is not None and value is not None:
                scalars[tag] = value
            if tag is not None and image is not None and images is not None:
                images[tag] = image
        else:
            break
    return None


def _decode_image(data: bytes) -> dict:
    img: dict = {}
    pos = 0
    fields = {1: "height", 2: "width", 3: "colorspace"}
    while pos < len(data):
        key, pos = _read_varint(data, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(data, pos)
            if field in fields:
                img[fields[field]] = val
        elif wire == 2:
            ln, pos = _read_varint(data, pos)
            if field == 4:
                img["png"] = data[pos:pos + ln]
            pos += ln
        else:
            break
    return img


# ---------------------------------------------------------------------------
# writer / reader
# ---------------------------------------------------------------------------

class TBEventWriter:
    """TensorBoard event writer (`events.out.tfevents.*`): scalars, and PNG
    images through PIL."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        host = socket.gethostname()
        self.path = os.path.join(
            log_dir, f"events.out.tfevents.{int(time.time())}.{host}"
        )
        self._f = open(self.path, "ab")
        self._write(_encode_event(time.time(), file_version="brain.Event:2"))

    def _write(self, data: bytes) -> None:
        header = struct.pack("<Q", len(data))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(data)
        self._f.write(struct.pack("<I", _masked_crc(data)))

    def add_scalars(self, step: int, scalars: dict,
                    wall_time: Optional[float] = None) -> None:
        self._write(_encode_event(
            wall_time if wall_time is not None else time.time(),
            step=int(step), scalars=scalars,
        ))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self.add_scalars(step, {tag: value})

    def add_image(self, tag: str, image, step: int,
                  wall_time: Optional[float] = None) -> None:
        """image: uint8 numpy array [H, W, 3] (RGB) or [H, W] (grayscale)."""
        import io

        import numpy as np
        from PIL import Image as PILImage

        arr = np.asarray(image)
        if arr.dtype != np.uint8:
            raise TypeError(f"add_image expects uint8, got {arr.dtype}")
        h, w = arr.shape[:2]
        cs = 3 if arr.ndim == 3 else 1          # TB colorspace: 1=gray, 3=RGB
        buf = io.BytesIO()
        PILImage.fromarray(arr).save(buf, format="PNG")
        self._write(_encode_event(
            wall_time if wall_time is not None else time.time(),
            step=int(step), images={tag: (h, w, cs, buf.getvalue())},
        ))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()


def read_events(path: str, verify_crc: bool = True) -> Iterator[dict]:
    """Parse an event file back into dicts {wall_time, step, scalars, ...}."""
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return
            (length,) = struct.unpack("<Q", header)
            (hcrc,) = struct.unpack("<I", f.read(4))
            data = f.read(length)
            (dcrc,) = struct.unpack("<I", f.read(4))
            if verify_crc and (hcrc != _masked_crc(header) or dcrc != _masked_crc(data)):
                raise ValueError(f"{path}: a record's CRC does not match its bytes")
            yield _decode_event(data)
