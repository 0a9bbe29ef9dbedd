"""Minimal PLY mesh/point-cloud IO (binary + ascii), numpy only: the port's
own copy of nero_tpu/geometry/mesh_io.py. Stage II reads the Stage-I mesh
(`data/meshes/<name>-<step>.ply`) through `read_ply`.
"""
from __future__ import annotations

import numpy as np

_PLY_DTYPES = {
    "char": "i1", "uchar": "u1", "int8": "i1", "uint8": "u1",
    "short": "i2", "ushort": "u2", "int16": "i2", "uint16": "u2",
    "int": "i4", "uint": "u4", "int32": "i4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def write_ply(path: str, vertices: np.ndarray, triangles: np.ndarray | None = None,
              vertex_colors: np.ndarray | None = None, vertex_normals: np.ndarray | None = None):
    """Write a binary-little-endian PLY. vertices [V,3] f32; triangles [F,3] int."""
    vertices = np.ascontiguousarray(vertices, np.float32)
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {len(vertices)}",
              "property float x", "property float y", "property float z"]
    vert_fields = [vertices]
    if vertex_normals is not None:
        header += ["property float nx", "property float ny", "property float nz"]
        vert_fields.append(np.ascontiguousarray(vertex_normals, np.float32))
    if vertex_colors is not None:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    if triangles is not None:
        header += [f"element face {len(triangles)}",
                   "property list uchar int vertex_indices"]
    header.append("end_header")

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if vertex_colors is None:
            vdata = np.concatenate(vert_fields, axis=1).astype("<f4")
            f.write(vdata.tobytes())
        else:
            colors = np.ascontiguousarray(vertex_colors)
            if colors.dtype != np.uint8:
                colors = np.clip(colors * 255.0 + 0.5, 0, 255).astype(np.uint8)
            n = len(vertices)
            fdata = np.concatenate(vert_fields, axis=1).astype("<f4")
            rec = np.zeros(n, dtype=[("f", "<f4", fdata.shape[1]), ("c", "u1", 3)])
            rec["f"] = fdata
            rec["c"] = colors
            f.write(rec.tobytes())
        if triangles is not None:
            tris = np.ascontiguousarray(triangles, np.int32)
            rec = np.zeros(len(tris), dtype=[("n", "u1"), ("idx", "<i4", 3)])
            rec["n"] = 3
            rec["idx"] = tris
            f.write(rec.tobytes())


def _parse_header(f):
    line = f.readline().strip()
    if line != b"ply":
        raise ValueError("not a PLY file")
    fmt = None
    elements = []  # (name, count, [(prop_name, dtype) or ('list', count_dtype, item_dtype, name)])
    cur = None
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unexpected EOF in PLY header")
        tokens = line.decode("ascii", "replace").strip().split()
        if not tokens:
            continue
        if tokens[0] == "format":
            fmt = tokens[1]
        elif tokens[0] == "comment":
            continue
        elif tokens[0] == "element":
            cur = {"name": tokens[1], "count": int(tokens[2]), "props": []}
            elements.append(cur)
        elif tokens[0] == "property":
            if tokens[1] == "list":
                cur["props"].append(("list", _PLY_DTYPES[tokens[2]], _PLY_DTYPES[tokens[3]], tokens[4]))
            else:
                cur["props"].append((tokens[2], _PLY_DTYPES[tokens[1]]))
        elif tokens[0] == "end_header":
            break
    return fmt, elements


def read_ply(path: str):
    """Read a PLY file. Returns dict with 'vertices' [V,3] f32 and optionally
    'triangles' [F,3] i32, 'colors' [V,3] u8, 'normals' [V,3] f32."""
    with open(path, "rb") as f:
        fmt, elements = _parse_header(f)
        endian = "<" if "little" in fmt else ">"
        out = {}
        for elem in elements:
            if fmt == "ascii":
                rows = [f.readline().split() for _ in range(elem["count"])]
                _parse_element_ascii(elem, rows, out)
            else:
                _parse_element_binary(elem, f, endian, out)
    return out


def _parse_element_ascii(elem, rows, out):
    props = elem["props"]
    if elem["name"] == "vertex":
        names = [p[0] for p in props]
        data = np.asarray([[float(v) for v in r] for r in rows], np.float64)
        _extract_vertex_fields(names, data, out)
    elif elem["name"] == "face":
        tris = [[int(v) for v in r[1:4]] for r in rows]
        out["triangles"] = np.asarray(tris, np.int32)


def _parse_element_binary(elem, f, endian, out):
    props = elem["props"]
    has_list = any(p[0] == "list" for p in props)
    if not has_list:
        dt = np.dtype([(p[0], endian + p[1]) for p in props])
        buf = f.read(dt.itemsize * elem["count"])
        rec = np.frombuffer(buf, dtype=dt, count=elem["count"])
        if elem["name"] == "vertex":
            names = [p[0] for p in props]
            data = np.stack([rec[n].astype(np.float64) for n in names], axis=1)
            _extract_vertex_fields(names, data, out)
        return
    # list property (faces): assume one list per row, fixed arity 3 (triangles)
    if len(props) == 1 and props[0][0] == "list":
        _, cnt_dt, item_dt, _name = props[0]
        cnt_size = np.dtype(cnt_dt).itemsize
        item_size = np.dtype(item_dt).itemsize
        # peek first count
        pos = f.tell()
        first = np.frombuffer(f.read(cnt_size), dtype=endian + cnt_dt)[0]
        f.seek(pos)
        row = cnt_size + int(first) * item_size
        buf = f.read(row * elem["count"])
        rec = np.frombuffer(buf, dtype=np.dtype([("n", endian + cnt_dt),
                                                 ("idx", endian + item_dt, int(first))]),
                            count=elem["count"])
        if elem["name"] == "face":
            out["triangles"] = rec["idx"].astype(np.int32)
    else:
        # general case: parse row by row (rare; slow path)
        tris = []
        for _ in range(elem["count"]):
            for p in props:
                if p[0] == "list":
                    _, cnt_dt, item_dt, _name = p
                    n = int(np.frombuffer(f.read(np.dtype(cnt_dt).itemsize),
                                          dtype=endian + cnt_dt)[0])
                    vals = np.frombuffer(f.read(n * np.dtype(item_dt).itemsize),
                                         dtype=endian + item_dt)
                    if elem["name"] == "face":
                        tris.append(vals[:3])
                else:
                    f.read(np.dtype(p[1]).itemsize)
        if tris:
            out["triangles"] = np.asarray(tris, np.int32)


def _extract_vertex_fields(names, data, out):
    cols = {n: i for i, n in enumerate(names)}
    if all(k in cols for k in ("x", "y", "z")):
        out["vertices"] = data[:, [cols["x"], cols["y"], cols["z"]]].astype(np.float32)
    if all(k in cols for k in ("nx", "ny", "nz")):
        out["normals"] = data[:, [cols["nx"], cols["ny"], cols["nz"]]].astype(np.float32)
    if all(k in cols for k in ("red", "green", "blue")):
        out["colors"] = data[:, [cols["red"], cols["green"], cols["blue"]]].astype(np.uint8)


def compute_vertex_normals(vertices: np.ndarray, triangles: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals."""
    v0 = vertices[triangles[:, 0]]
    v1 = vertices[triangles[:, 1]]
    v2 = vertices[triangles[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)
    normals = np.zeros_like(vertices)
    for i in range(3):
        np.add.at(normals, triangles[:, i], fn)
    norm = np.linalg.norm(normals, axis=-1, keepdims=True)
    return normals / np.maximum(norm, 1e-12)
