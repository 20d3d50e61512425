"""PLY/PCD point-cloud readers and writers (host-side, numpy).

The port's own copy of :mod:`sycl_points_tpu.points.io`. Readers: PLY ascii /
binary_little_endian / binary_big_endian and PCD ascii / binary /
binary_compressed (PCL LZF, structure-of-arrays body), with x/y/z,
red/green/blue (or packed rgb/rgba), normals, any field whose name contains
``intensity`` and a time field. Writers: PLY ascii / binary and PCD ascii /
binary / binary_compressed, non-finite points skipped. The LZF codec is the
native library's (:mod:`.native_io`) when it can be built, else the
pure-Python one; the two may emit different but equally valid streams.

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
    """PCL/liblzf decompression: the native codec when it can be built, else
    :func:`_lzf_decompress_py`, which gives the same bytes."""
    from sycl_points_tpu_torch.points import native_io

    native = native_io.lzf_decompress(src, out_len)
    return native if native is not None else _lzf_decompress_py(src, out_len)


def _lzf_decompress_py(src: bytes, out_len: int) -> bytes:
    """PCL/liblzf decompression in Python.

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


def _lzf_compress(src: bytes) -> bytes:
    """liblzf-style compression: the native codec when it can be built, else
    :func:`_lzf_compress_py`. Either stream decompresses with either decoder
    and with PCL's."""
    from sycl_points_tpu_torch.points import native_io

    native = native_io.lzf_compress(src)
    return native if native is not None else _lzf_compress_py(src)


def _lzf_compress_py(src: bytes) -> bytes:
    """Greedy liblzf compression in Python: 3-byte hash matches up to 8 KiB
    back, runs of up to 264 bytes, literal runs of up to 32."""
    out = bytearray()
    table: dict = {}
    lit_start = 0
    i, n = 0, len(src)

    def flush_literals(end):
        s = lit_start
        while s < end:
            run = min(32, end - s)
            out.append(run - 1)
            out.extend(src[s : s + run])
            s += run

    while i < n:
        if i + 3 <= n:
            key = src[i : i + 3]
            cand = table.get(key, -1)
            table[key] = i
            dist = i - cand - 1
            if cand >= 0 and 0 <= dist < (1 << 13):
                length = 3
                max_len = min(n - i, 264)
                while length < max_len and src[cand + length] == src[i + length]:
                    length += 1
                flush_literals(i)
                l_enc = length - 2
                if l_enc < 7:
                    out.append((l_enc << 5) | (dist >> 8))
                else:
                    out.append((7 << 5) | (dist >> 8))
                    out.append(l_enc - 7)
                out.append(dist & 0xFF)
                i += length
                lit_start = i
                continue
        i += 1
    flush_literals(n)
    return bytes(out)


def write_ply(path: str, cloud: dict, binary: bool = True) -> None:
    """Write a PLY file (binary_little_endian or ascii): x/y/z, then nx/ny/nz,
    red/green/blue (uchar) and intensity where the cloud has them; non-finite
    points are skipped."""
    cloud = finite_filter(cloud)
    pts = cloud["points"].astype(np.float32)
    n = len(pts)
    props = [("x", pts[:, 0]), ("y", pts[:, 1]), ("z", pts[:, 2])]
    if "normals" in cloud:
        nm = cloud["normals"].astype(np.float32)
        props += [("nx", nm[:, 0]), ("ny", nm[:, 1]), ("nz", nm[:, 2])]
    if "rgb" in cloud:
        rgb_u8 = np.clip(cloud["rgb"][:, :3] * 255.0, 0, 255).astype(np.uint8)
        props += [("red", rgb_u8[:, 0]), ("green", rgb_u8[:, 1]), ("blue", rgb_u8[:, 2])]
    if "intensities" in cloud:
        props.append(("intensity", cloud["intensities"].astype(np.float32)))

    type_names = {np.dtype(np.float32): "float", np.dtype(np.uint8): "uchar"}
    header = ["ply", "format binary_little_endian 1.0" if binary else "format ascii 1.0", f"element vertex {n}"]
    header += [f"property {type_names[col.dtype]} {name}" for name, col in props]
    header.append("end_header")

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if binary:
            table = np.empty(n, dtype=np.dtype([(name, col.dtype.newbyteorder("<")) for name, col in props]))
            for name, col in props:
                table[name] = col
            f.write(table.tobytes())
        else:
            arr = np.stack([col.astype(np.float64) for _, col in props], axis=1)
            int_cols = [i for i, (_, col) in enumerate(props) if col.dtype == np.uint8]
            lines = [" ".join(f"{int(v)}" if i in int_cols else f"{v:.9g}" for i, v in enumerate(row)) for row in arr]
            f.write(("\n".join(lines) + "\n").encode("ascii"))


def write_pcd(path: str, cloud: dict, binary: bool = True, compressed: bool = False) -> None:
    """Write a PCD file (ascii, binary or binary_compressed): x/y/z, then
    normal_x/y/z, a packed rgb and intensity where the cloud has them, every
    field a float32; non-finite points are skipped."""
    cloud = finite_filter(cloud)
    pts = cloud["points"].astype(np.float32)
    n = len(pts)
    fields = [("x", pts[:, 0]), ("y", pts[:, 1]), ("z", pts[:, 2])]
    if "normals" in cloud:
        nm = cloud["normals"].astype(np.float32)
        fields += [("normal_x", nm[:, 0]), ("normal_y", nm[:, 1]), ("normal_z", nm[:, 2])]
    if "rgb" in cloud:
        rgb = np.clip(cloud["rgb"][:, :3] * 255.0, 0, 255).astype(np.uint32)
        packed = (rgb[:, 0] << 16) | (rgb[:, 1] << 8) | rgb[:, 2]
        fields.append(("rgb", packed.view(np.float32)))
    if "intensities" in cloud:
        fields.append(("intensity", cloud["intensities"].astype(np.float32)))

    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        f"FIELDS {' '.join(name for name, _ in fields)}\n"
        f"SIZE {' '.join('4' for _ in fields)}\n"
        f"TYPE {' '.join('F' for _ in fields)}\n"
        f"COUNT {' '.join('1' for _ in fields)}\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n"
        f"DATA {'binary_compressed' if compressed else 'binary' if binary else 'ascii'}\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        table = np.stack([col for _, col in fields], axis=1).astype(np.float32)
        if compressed:
            # PCL's structure-of-arrays body, LZF-compressed
            soa = np.ascontiguousarray(table.T).tobytes()
            comp = _lzf_compress(soa)
            f.write(struct.pack("<II", len(comp), len(soa)))
            f.write(comp)
        elif binary:
            f.write(np.ascontiguousarray(table).tobytes())
        else:
            f.write(("\n".join(" ".join(f"{v:.9g}" for v in row) for row in table) + "\n").encode("ascii"))


def write_file(path: str, cloud: dict, binary: bool = True) -> None:
    """Write a ``.ply`` or ``.pcd`` file by its extension."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".ply":
        write_ply(path, cloud, binary)
    elif ext == ".pcd":
        write_pcd(path, cloud, binary)
    else:
        raise ValueError(f"unsupported point cloud extension: {ext}")
