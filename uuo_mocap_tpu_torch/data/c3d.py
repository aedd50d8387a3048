"""C3D motion-capture file reader and writer, from the C3D spec
(counterpart of ``uuo_mocap_tpu/data/c3d.py``; pure Python).

Covers what the pipeline uses: 3D point data (float or scaled integer), the
POINT:RATE/UNITS/LABELS/USED parameters, the Intel (little-endian) processor
format, and a float-format writer for the synthetic export.

File layout: 512-byte blocks; block 1 is the header, the parameter section
starts at the block named in header byte 0, point data at the block in
header word 9.
"""
from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional

import numpy as np

_BLOCK = 512
_PROC_INTEL = 84  # 83 + 1
_INT16_MAX = 32767


def peek_c3d_shape(filename: str) -> "tuple[int, int]":
    """(num_frames, num_points) from the 512-byte header alone — cheap
    enough to shape-bucket a whole work list before batching without
    parsing any point data (the reference has no batch grouping at all;
    its loop is one file at a time, ``test/test.py:50-147``).

    Frame counts above the 16-bit header limit read as the capped header
    value; bucketing only needs an approximate key, and per-group padding
    always uses the true parsed shapes.
    """
    with open(filename, "rb") as f:
        raw = f.read(22)
    if len(raw) < 22 or raw[1] != 0x50:
        raise ValueError(f"{filename}: not a C3D file")
    num_points, _, first_frame, last_frame = struct.unpack_from("<4H", raw, 2)
    return last_frame - first_frame + 1, num_points


def read_c3d(filename: str, use_native: bool = True) -> Dict[str, Any]:
    """Read a C3D file -> dict with ``points`` [F, M, 4] (x, y, z, residual),
    ``rate``, ``units``, ``labels``, ``first_frame``, ``num_points``.

    ``use_native`` parses with the native library (``data/c3d_native.py``,
    built on first use; a failed build or parse raises), else with this
    pure-Python implementation.
    """
    if use_native:
        from uuo_mocap_tpu_torch.data.c3d_native import read_c3d_native

        return read_c3d_native(filename)
    with open(filename, "rb") as f:
        raw = f.read()

    param_block = raw[0]
    if raw[1] != 0x50:
        raise ValueError(f"{filename}: not a C3D file (magic byte {raw[1]:#x})")

    header = struct.unpack_from("<9H", raw, 2)
    num_points = header[0]
    analog_per_frame = header[1]
    first_frame = header[2]
    last_frame = header[3]
    scale = struct.unpack_from("<f", raw, 12)[0]
    data_block = struct.unpack_from("<H", raw, 16)[0]
    analog_samples = struct.unpack_from("<H", raw, 18)[0]
    rate = struct.unpack_from("<f", raw, 20)[0]

    # ---- parameter section
    p0 = (param_block - 1) * _BLOCK
    proc = raw[p0 + 3]
    if proc != _PROC_INTEL:
        raise NotImplementedError(f"processor type {proc} (only Intel/{_PROC_INTEL} supported)")

    params: Dict[str, Dict[str, Any]] = {}
    group_names: Dict[int, str] = {}
    pos = p0 + 4
    while pos < len(raw):
        name_len = struct.unpack_from("<b", raw, pos)[0]
        if name_len == 0:
            break
        gid = struct.unpack_from("<b", raw, pos + 1)[0]
        name = raw[pos + 2 : pos + 2 + abs(name_len)].decode("ascii", "replace").strip()
        pos2 = pos + 2 + abs(name_len)
        offset = struct.unpack_from("<h", raw, pos2)[0]
        next_pos = pos2 + offset if offset > 0 else len(raw)
        if gid < 0:  # group definition
            group_names[-gid] = name
        else:  # parameter in group gid
            dtype = struct.unpack_from("<b", raw, pos2 + 2)[0]
            ndims = raw[pos2 + 3]
            dims = list(raw[pos2 + 4 : pos2 + 4 + ndims])
            dstart = pos2 + 4 + ndims
            count = int(np.prod(dims)) if dims else 1
            if dtype == -1:
                size = 1
                data = raw[dstart : dstart + count]
            elif dtype == 1:
                size = 1
                data = np.frombuffer(raw, np.int8, count, dstart)
            elif dtype == 2:
                size = 2
                data = np.frombuffer(raw, "<i2", count, dstart)
            elif dtype == 4:
                size = 4
                data = np.frombuffer(raw, "<f4", count, dstart)
            else:
                raise ValueError(f"bad parameter type {dtype} for {name}")
            params.setdefault(gid, {})[name] = {"dims": dims, "dtype": dtype, "data": data}
        if offset <= 0:
            break
        pos = next_pos

    def get_param(group: str, name: str):
        for gid, gname in group_names.items():
            if gname == group and gid in params and name in params[gid]:
                return params[gid][name]
        return None

    # authoritative values from parameters where present
    p = get_param("POINT", "USED")
    if p is not None:
        num_points = int(np.asarray(p["data"])[0])
    p = get_param("POINT", "RATE")
    if p is not None:
        rate = float(np.asarray(p["data"])[0])
    p = get_param("POINT", "SCALE")
    if p is not None:
        scale = float(np.asarray(p["data"])[0])
    p = get_param("POINT", "FRAMES")
    num_frames = last_frame - first_frame + 1
    if p is not None:
        v = int(np.asarray(p["data"])[0])
        # POINT:FRAMES is a signed 16-bit word, written as 32767 for longer
        # captures (write_c3d does so); the header's unsigned count holds up
        # to 65535 frames and then takes over
        if v > 0 and not (v == _INT16_MAX and num_frames > v):
            num_frames = v

    units = "mm"
    p = get_param("POINT", "UNITS")
    if p is not None:
        units = bytes(p["data"]).decode("ascii", "replace").strip() or "mm"

    labels: List[str] = []
    p = get_param("POINT", "LABELS")
    if p is not None and len(p["dims"]) == 2:
        w, n = p["dims"]
        for i in range(n):
            labels.append(bytes(p["data"][i * w : (i + 1) * w]).decode("ascii", "replace").strip())

    # ---- point data
    d0 = (data_block - 1) * _BLOCK
    is_float = scale < 0
    # each 3D point takes 4 values; analog takes analog_per_frame values
    values_per_frame = num_points * 4 + analog_per_frame
    if is_float:
        arr = np.frombuffer(raw, "<f4", values_per_frame * num_frames, d0)
    else:
        arr = np.frombuffer(raw, "<i2", values_per_frame * num_frames, d0).astype(np.float32)
    arr = arr.reshape(num_frames, values_per_frame)
    pts = arr[:, : num_points * 4].reshape(num_frames, num_points, 4).copy()
    if not is_float:
        pts[:, :, :3] *= abs(scale)

    return {
        "points": pts,
        "rate": rate,
        "units": units,
        "labels": labels,
        "first_frame": first_frame,
        "num_points": num_points,
    }


def _param_bytes(name: str, gid: int, dtype: int, dims: List[int], payload: bytes) -> bytes:
    header = struct.pack("<bb", len(name), gid) + name.encode("ascii")
    body = struct.pack("<bb", dtype, len(dims)) + bytes(dims) + payload + b"\x00"  # empty desc
    offset = 2 + len(body)
    return header + struct.pack("<h", offset) + body


def _group_bytes(name: str, gid: int) -> bytes:
    header = struct.pack("<bb", len(name), -gid) + name.encode("ascii")
    body = b"\x00"
    offset = 2 + len(body)
    return header + struct.pack("<h", offset) + body


def write_c3d(
    filename: str,
    points: np.ndarray,  # [F, M, 3] in ``units``
    rate: float = 30.0,
    units: str = "m",
    labels: Optional[List[str]] = None,
) -> str:
    """Write float-format Intel C3D with POINT parameters."""
    points = np.asarray(points, np.float32)
    F, M, _ = points.shape
    labels = labels or [f"M{i:03d}" for i in range(M)]
    label_w = max(4, max(len(l) for l in labels))
    label_blob = b"".join(l.ljust(label_w).encode("ascii") for l in labels)

    # ---- parameter section
    gid = 1
    pblob = struct.pack("<BBbb", 0, 0, 0, _PROC_INTEL)
    pblob += _group_bytes("POINT", gid)
    pblob += _param_bytes("USED", gid, 2, [], struct.pack("<h", M))
    pblob += _param_bytes("FRAMES", gid, 2, [], struct.pack("<h", min(F, _INT16_MAX)))
    pblob += _param_bytes("RATE", gid, 4, [], struct.pack("<f", rate))
    pblob += _param_bytes("SCALE", gid, 4, [], struct.pack("<f", -1.0))
    pblob += _param_bytes("UNITS", gid, -1, [len(units)], units.encode("ascii"))
    pblob += _param_bytes("LABELS", gid, -1, [label_w, M], label_blob)
    pblob += b"\x00\x00"  # terminator
    n_param_blocks = (len(pblob) + _BLOCK - 1) // _BLOCK
    pblob = pblob.ljust(n_param_blocks * _BLOCK, b"\x00")

    param_block = 2
    data_block = param_block + n_param_blocks

    # ---- header
    header = bytearray(_BLOCK)
    header[0] = param_block
    header[1] = 0x50
    struct.pack_into("<H", header, 2, M)  # num points
    struct.pack_into("<H", header, 4, 0)  # analog per frame
    struct.pack_into("<H", header, 6, 1)  # first frame
    struct.pack_into("<H", header, 8, min(F, 65535))  # last frame
    struct.pack_into("<H", header, 10, 10)  # max gap
    struct.pack_into("<f", header, 12, -1.0)  # float scale
    struct.pack_into("<H", header, 16, data_block)
    struct.pack_into("<H", header, 18, 0)  # analog samples
    struct.pack_into("<f", header, 20, rate)

    # ---- data: [x, y, z, residual] per point
    data = np.zeros((F, M, 4), np.float32)
    data[:, :, :3] = points
    blob = data.tobytes()
    blob = blob.ljust(((len(blob) + _BLOCK - 1) // _BLOCK) * _BLOCK, b"\x00")

    with open(filename, "wb") as f:
        f.write(bytes(header))
        f.write(pblob)
        f.write(blob)
    return filename
