"""PLY/PCD point-cloud readers (host-side, numpy).

The port's own copy of the readers of :mod:`sycl_points_tpu.points.io`:
PLY ascii / binary_little_endian / binary_big_endian and PCD ascii / binary
/ binary_compressed (PCL LZF, structure-of-arrays body), with x/y/z,
red/green/blue (or packed rgb/rgba), normals, any field whose name contains
``intensity`` and a time field. The LZF decoder is the pure-Python one.

Returns plain numpy dicts; :meth:`PointCloud.from_numpy` moves them to a
device. :func:`finite_filter` drops the rows with a non-finite point.
"""

from __future__ import annotations

import os
import struct

import numpy as np

_PLY_DTYPES = {
    "char": np.int8, "int8": np.int8,
    "uchar": np.uint8, "uint8": np.uint8,
    "short": np.int16, "int16": np.int16,
    "ushort": np.uint16, "uint16": np.uint16,
    "int": np.int32, "int32": np.int32,
    "uint": np.uint32, "uint32": np.uint32,
    "float": np.float32, "float32": np.float32,
    "double": np.float64, "float64": np.float64,
}


def _fields_to_cloud(names, columns) -> dict:
    """Map named columns to the canonical cloud dict."""
    cols = dict(zip(names, columns))
    out: dict = {}
    out["points"] = np.stack([cols["x"], cols["y"], cols["z"]], axis=1).astype(np.float32)

    for trio in (("nx", "ny", "nz"), ("normal_x", "normal_y", "normal_z")):
        if all(k in cols for k in trio):
            out["normals"] = np.stack([cols[k] for k in trio], axis=1).astype(np.float32)
            break

    if all(k in cols for k in ("red", "green", "blue")):
        rgb = np.stack([cols["red"], cols["green"], cols["blue"]], axis=1).astype(np.float32)
        if rgb.max(initial=0.0) > 1.0:
            rgb = rgb / 255.0
        if "alpha" in cols:
            alpha = cols["alpha"].astype(np.float32)
            if alpha.max(initial=0.0) > 1.0:
                alpha = alpha / 255.0
        else:
            alpha = np.ones(len(rgb), dtype=np.float32)
        out["rgb"] = np.concatenate([rgb, alpha[:, None]], axis=1)
    elif "rgb" in cols or "rgba" in cols:
        packed = cols.get("rgb", cols.get("rgba"))
        packed = packed.astype(np.float32).view(np.uint32) if packed.dtype.kind == "f" else packed.astype(np.uint32)
        r = ((packed >> 16) & 0xFF).astype(np.float32) / 255.0
        g = ((packed >> 8) & 0xFF).astype(np.float32) / 255.0
        b = (packed & 0xFF).astype(np.float32) / 255.0
        out["rgb"] = np.stack([r, g, b, np.ones_like(r)], axis=1)

    for name in names:
        if "intensity" in name.lower():
            out["intensities"] = cols[name].astype(np.float32)
            break
    for name in names:
        if name in ("time", "timestamp", "t") or "time" in name.lower():
            out["timestamp_offsets"] = cols[name].astype(np.float32)
            break
    return out


def read_ply(path: str) -> dict:
    """Read a PLY file (ascii or binary, either byte order)."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.find(b"end_header")
    if header_end < 0:
        raise ValueError(f"{path}: not a PLY file (no end_header)")
    header_end = data.find(b"\n", header_end) + 1
    header = data[:header_end].decode("ascii", errors="replace")

    fmt = None
    n_vertex = 0
    props: list[tuple[str, np.dtype]] = []
    in_vertex = False
    seen_vertex = False
    for line in header.splitlines():
        tok = line.strip().split()
        if not tok:
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            in_vertex = tok[1] == "vertex"
            if in_vertex:
                n_vertex = int(tok[2])
                seen_vertex = True
            elif not seen_vertex and int(tok[2]) > 0:
                # the body is parsed from header_end on, so a non-empty element
                # before the vertices would be misread as vertex records
                raise ValueError(
                    f"{path}: element '{tok[1]}' precedes 'vertex' — "
                    "only vertex-first PLY layouts are supported"
                )
        elif tok[0] == "property" and in_vertex:
            if tok[1] == "list":
                raise ValueError(f"{path}: list properties not supported for vertices")
            props.append((tok[2], np.dtype(_PLY_DTYPES[tok[1]])))

    names = [p[0] for p in props]
    if fmt == "ascii":
        table = np.array(data[header_end:].decode("ascii").split(), dtype=np.float64)
        table = table[: n_vertex * len(props)].reshape(n_vertex, len(props))
        columns = [table[:, i].astype(props[i][1]) for i in range(len(props))]
    elif fmt in ("binary_little_endian", "binary_big_endian"):
        order = "<" if fmt == "binary_little_endian" else ">"
        rec = np.dtype([(n, d.newbyteorder(order)) for n, d in props])
        table = np.frombuffer(data, dtype=rec, count=n_vertex, offset=header_end)
        columns = [table[n].astype(d) for n, d in props]
    else:
        raise ValueError(f"{path}: unsupported PLY format {fmt}")
    return _fields_to_cloud(names, columns)


def _lzf_decompress(src: bytes, out_len: int) -> bytes:
    """PCL/liblzf decompression.

    Stream grammar: control byte < 32 -> literal run of ``ctrl+1`` bytes;
    otherwise a back-reference of ``(ctrl >> 5) + 2`` bytes (7 extends the
    length by the next byte) at distance ``((ctrl & 0x1f) << 8 | next) + 1``.
    Overlapping copies are byte-serial by definition."""
    out = bytearray()
    i, n = 0, len(src)
    while i < n and len(out) < out_len:
        ctrl = src[i]
        i += 1
        if ctrl < 32:
            cnt = ctrl + 1
            out += src[i : i + cnt]
            i += cnt
        else:
            length = ctrl >> 5
            if length == 7:
                length += src[i]
                i += 1
            ref = len(out) - (((ctrl & 0x1F) << 8) | src[i]) - 1
            i += 1
            if ref < 0:
                raise ValueError("lzf: back-reference before stream start")
            for _ in range(length + 2):
                out.append(out[ref])
                ref += 1
    if len(out) != out_len:
        raise ValueError(f"lzf: decompressed {len(out)} bytes, expected {out_len}")
    return bytes(out)


def read_pcd(path: str) -> dict:
    """Read a PCD file (ascii, binary, or binary_compressed/LZF)."""
    with open(path, "rb") as f:
        data = f.read()

    lines = []
    offset = 0
    while True:
        nl = data.find(b"\n", offset)
        if nl < 0:
            raise ValueError(f"{path}: PCD header has no DATA line")
        line = data[offset:nl].decode("ascii", errors="replace").strip()
        offset = nl + 1
        if line and not line.startswith("#"):
            lines.append(line)
        if line.upper().startswith("DATA"):
            break

    hdr = {}
    for line in lines:
        tok = line.split()
        hdr[tok[0].upper()] = tok[1:]
    names = [n.lower() for n in hdr["FIELDS"]]
    sizes = [int(s) for s in hdr["SIZE"]]
    types = hdr["TYPE"]
    counts = [int(c) for c in hdr.get("COUNT", ["1"] * len(names))]
    n_points = int(hdr["POINTS"][0]) if "POINTS" in hdr else int(hdr["WIDTH"][0]) * int(hdr.get("HEIGHT", ["1"])[0])
    mode = hdr["DATA"][0].lower()

    np_types = {("F", 4): np.float32, ("F", 8): np.float64,
                ("I", 1): np.int8, ("I", 2): np.int16, ("I", 4): np.int32,
                ("U", 1): np.uint8, ("U", 2): np.uint16, ("U", 4): np.uint32}
    dtypes = [np_types[(t.upper(), s)] for t, s in zip(types, sizes)]

    if mode == "ascii":
        table = np.array(data[offset:].decode("ascii").split(), dtype=np.float64)
        stride = sum(counts)
        table = table[: n_points * stride].reshape(n_points, stride)
        columns, out_names, col = [], [], 0
        for name, dt, cnt in zip(names, dtypes, counts):
            if cnt == 1:
                columns.append(table[:, col].astype(dt))
                out_names.append(name)
            col += cnt
        return _fields_to_cloud(out_names, columns)
    if mode == "binary":
        fields = []
        for name, dt, cnt in zip(names, dtypes, counts):
            if cnt == 1:
                fields.append((name, np.dtype(dt).newbyteorder("<")))
            else:
                fields.append((name, np.dtype(dt).newbyteorder("<"), (cnt,)))
        table = np.frombuffer(data, dtype=np.dtype(fields), count=n_points, offset=offset)
        out_names = [n for n, c in zip(names, counts) if c == 1]
        return _fields_to_cloud(out_names, [table[n] for n in out_names])
    if mode == "binary_compressed":
        # PCL layout: u32 compressed size, u32 uncompressed size, LZF data; the
        # uncompressed body is a structure of arrays (all x, all y, ...)
        comp_len, uncomp_len = struct.unpack_from("<II", data, offset)
        raw = _lzf_decompress(data[offset + 8 : offset + 8 + comp_len], uncomp_len)
        out_names, columns = [], []
        pos = 0
        for name, dt, cnt in zip(names, dtypes, counts):
            d = np.dtype(dt).newbyteorder("<")
            if cnt == 1:
                out_names.append(name)
                columns.append(np.frombuffer(raw, dtype=d, count=n_points, offset=pos))
            pos += d.itemsize * n_points * cnt
        return _fields_to_cloud(out_names, columns)
    raise ValueError(f"{path}: unsupported PCD data mode {mode}")


def read_file(path: str) -> dict:
    """Read a ``.ply`` or ``.pcd`` file by its extension."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".ply":
        return read_ply(path)
    if ext == ".pcd":
        return read_pcd(path)
    raise ValueError(f"unsupported point cloud extension: {ext}")


def finite_filter(cloud: dict) -> dict:
    """Drop the rows whose point has a non-finite coordinate (the JAX
    package's ``io._finite_filter``)."""
    finite = np.isfinite(cloud["points"]).all(axis=1)
    return {k: v[finite] for k, v in cloud.items()}
