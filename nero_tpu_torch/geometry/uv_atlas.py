"""UV atlases, seam inpainting and OBJ/MTL export for baked material textures
(numpy, host side; a copy of nero_tpu/geometry/uv_atlas.py).

Two atlases replace the reference's xatlas unwrap
(extract_materials_texture_map.py:72-86) without a dependency: a
per-triangle atlas (triangles packed pairwise into square grid cells, two
right-triangle halves per cell, inset by a gutter) and a normal-clustered
chart atlas. The material textures are baked by querying the field at each
texel's 3-D surface position, so chart boundaries carry no colour
discontinuity; the gutter and nearest-neighbour inpainting handle bilinear
filtering across seams.
"""
from __future__ import annotations

import numpy as np


def triangle_atlas(triangles: np.ndarray, gutter: float = 0.15):
    """Pack each triangle into its own half-cell.

    Returns (uv [T*3, 2] in [0,1], new_tris [T,3] indexing the uv/vertex dup
    arrays, vert_map [T*3] original vertex index per new corner).
    """
    t = len(triangles)
    cells = (t + 1) // 2
    g = int(np.ceil(np.sqrt(cells)))
    cell = 1.0 / g
    inset = gutter * cell

    uv = np.zeros((t * 3, 2), np.float32)
    new_tris = np.arange(t * 3, dtype=np.int32).reshape(t, 3)
    vert_map = triangles.reshape(-1).astype(np.int64)

    idx = np.arange(t)
    cell_id = idx // 2
    is_upper = (idx % 2).astype(bool)
    cx = (cell_id % g).astype(np.float32) * cell
    cy = (cell_id // g).astype(np.float32) * cell

    lo = inset
    hi = cell - inset
    # lower-left half: corners (lo,lo), (hi,lo), (lo,hi)
    low_c = np.stack([np.stack([cx + lo, cy + lo], -1),
                      np.stack([cx + hi, cy + lo], -1),
                      np.stack([cx + lo, cy + hi], -1)], axis=1)
    # upper-right half: corners (hi,hi), (lo,hi), (hi,lo)
    up_c = np.stack([np.stack([cx + hi, cy + hi], -1),
                     np.stack([cx + lo, cy + hi], -1),
                     np.stack([cx + hi, cy + lo], -1)], axis=1)
    corners = np.where(is_upper[:, None, None], up_c, low_c)
    uv[:] = corners.reshape(-1, 2)
    return uv, new_tris, vert_map


def _face_normals(vertices: np.ndarray, triangles: np.ndarray):
    v0 = vertices[triangles[:, 0]]
    e1 = vertices[triangles[:, 1]] - v0
    e2 = vertices[triangles[:, 2]] - v0
    n = np.cross(e1, e2)
    area2 = np.linalg.norm(n, axis=-1)
    n = n / np.maximum(area2[:, None], 1e-12)
    return n, area2 * 0.5


def _grow_charts(triangles, normals, areas, normal_cos, max_tris):
    """BFS normal-clustered charts. Returns list of triangle-index arrays."""
    from collections import defaultdict, deque
    edge2tris = defaultdict(list)
    for t, tri in enumerate(triangles):
        for a, b in ((tri[0], tri[1]), (tri[1], tri[2]), (tri[2], tri[0])):
            edge2tris[(min(a, b), max(a, b))].append(t)
    neighbors = defaultdict(list)
    for tris_on_edge in edge2tris.values():
        for i in tris_on_edge:
            for j in tris_on_edge:
                if i != j:
                    neighbors[i].append(j)

    order = np.argsort(-areas)  # biggest faces seed first
    assigned = np.full(len(triangles), -1, np.int64)
    charts = []
    for seed in order:
        if assigned[seed] >= 0:
            continue
        cid = len(charts)
        members = [seed]
        assigned[seed] = cid
        n_seed = normals[seed]
        q = deque([seed])
        while q and len(members) < max_tris:
            t = q.popleft()
            for nb in neighbors[t]:
                if assigned[nb] >= 0:
                    continue
                if np.dot(normals[nb], n_seed) < normal_cos:
                    continue
                assigned[nb] = cid
                members.append(nb)
                q.append(nb)
        charts.append(np.asarray(members, np.int64))
    return charts


def chart_atlas(vertices: np.ndarray, triangles: np.ndarray,
                normal_cos: float = 0.65, max_chart_tris: int = 20000,
                gutter_px: float = 2.0, resolution: int = 1024):
    """Normal-clustered chart atlas (xatlas-lite).

    Grows charts of near-coplanar connected triangles (face normal within
    acos(normal_cos) of the seed), parameterises each by orthographic
    projection onto the seed plane (injective for normal deviation < 90 deg;
    folded triangles are demoted to singleton charts), rotates each chart to
    its principal axes, and shelf-packs the chart rectangles at a single
    global texel scale so texture density is uniform across the surface.

    Returns (uv [N,2] in [0,1], uv_tris [T,3] int32 rows into uv,
    vert_map [N] original vertex index per uv row). Contract identical to
    triangle_atlas, but shared chart-interior vertices are NOT duplicated, so
    bilinear filtering only crosses seams at chart boundaries.
    """
    triangles = np.asarray(triangles, np.int64)
    normals, areas = _face_normals(vertices, triangles)
    charts = _grow_charts(triangles, normals, areas, normal_cos, max_chart_tris)

    # --- parameterise each chart; demote folded triangles to singletons ----
    chart_items = []   # (tri_idx array, verts2d [K,2], uniq_verts [K])
    pending = list(charts)
    while pending:
        members = pending.pop()
        tris_c = triangles[members]
        # weighted chart normal (fall back to seed face normal on cancel)
        n_avg = (normals[members] * areas[members][:, None]).sum(0)
        nn = np.linalg.norm(n_avg)
        n_c = n_avg / nn if nn > 1e-12 else normals[members[0]]
        # orthonormal plane basis
        helper = np.array([1.0, 0, 0]) if abs(n_c[0]) < 0.9 else np.array([0, 1.0, 0])
        bu = np.cross(n_c, helper)
        bu /= np.linalg.norm(bu)
        bv = np.cross(n_c, bu)
        uniq, inv = np.unique(tris_c.reshape(-1), return_inverse=True)
        p2 = np.stack([vertices[uniq] @ bu, vertices[uniq] @ bv], -1)
        tri2 = inv.reshape(-1, 3)
        # fold check: projected signed area must be one consistent sign
        a2 = np.cross(p2[tri2[:, 1]] - p2[tri2[:, 0]],
                      p2[tri2[:, 2]] - p2[tri2[:, 0]])
        dominant = np.sign(a2.sum()) or 1.0
        folded = (a2 * dominant) <= 0
        if folded.any() and len(members) > 1:
            keep = members[~folded]
            if len(keep):
                pending.append(keep)
            pending.extend(members[folded, None])
            continue
        # principal-axes rotation tightens the bbox
        c = p2.mean(0)
        q = p2 - c
        cov = q.T @ q
        _, vecs = np.linalg.eigh(cov)
        p2 = q @ vecs[:, ::-1]  # major axis -> u
        p2 -= p2.min(0)
        chart_items.append((members, p2.astype(np.float64), uniq))

    # --- pack: uniform global scale + shelf packing -----------------------
    gutter = gutter_px / resolution
    sizes = np.asarray([it[1].max(0) if len(it[1]) else (0, 0)
                        for it in chart_items])  # mesh units
    total_area = float((sizes[:, 0] * sizes[:, 1]).sum()) or 1e-12

    def try_pack(scale):
        """First-fit-decreasing-height shelf packing; None if it overflows."""
        order = np.argsort(-(sizes[:, 1]))  # by height desc
        offsets = np.zeros((len(chart_items), 2))
        shelves = []  # [y, height, next_x]
        y_top = 0.0
        for i in order:
            w = sizes[i, 0] * scale + 2 * gutter
            h = sizes[i, 1] * scale + 2 * gutter
            if w > 1.0 or h > 1.0:
                return None
            for shelf in shelves:
                if h <= shelf[1] and shelf[2] + w <= 1.0:
                    offsets[i] = (shelf[2] + gutter, shelf[0] + gutter)
                    shelf[2] += w
                    break
            else:
                if y_top + h > 1.0:
                    return None
                shelves.append([y_top, h, w])
                offsets[i] = (gutter, y_top + gutter)
                y_top += h
        return offsets

    scale = np.sqrt(0.8 / total_area)
    offsets = None
    for _ in range(60):
        offsets = try_pack(scale)
        if offsets is not None:
            break
        scale *= 0.97
    assert offsets is not None, "atlas packing failed"

    # --- emit ---------------------------------------------------------------
    uv_rows = []
    vert_map_rows = []
    uv_tris = np.zeros((len(triangles), 3), np.int32)
    base = 0
    for (members, p2, uniq), off in zip(chart_items, offsets):
        uv_rows.append(p2 * scale + off)
        vert_map_rows.append(uniq)
        # rebuild local indices (np.unique order is stable/deterministic)
        lut = {v: k for k, v in enumerate(uniq)}
        for t in members:
            uv_tris[t] = [base + lut[v] for v in triangles[t]]
        base += len(uniq)
    uv = np.concatenate(uv_rows, 0).astype(np.float32)
    vert_map = np.concatenate(vert_map_rows, 0)
    return uv, uv_tris, vert_map


def knn_inpaint(image: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Fill texels outside `mask` with their nearest valid texel (seam gutter).

    Parity with the sklearn-KNN inpaint at reference
    extract_materials_texture_map.py:136-149, using scipy's cKDTree.
    """
    from scipy.spatial import cKDTree
    h, w = mask.shape
    ys, xs = np.nonzero(mask)
    if len(ys) == 0:
        return image
    tree = cKDTree(np.stack([ys, xs], -1))
    iy, ix = np.nonzero(~mask)
    if len(iy) == 0:
        return image
    _, nn = tree.query(np.stack([iy, ix], -1), k=1)
    out = image.copy()
    out[iy, ix] = image[ys[nn], xs[nn]]
    return out


def export_obj(path: str, vertices: np.ndarray, triangles: np.ndarray,
               uv: np.ndarray, uv_tris: np.ndarray, vert_map: np.ndarray,
               mtl_name: str = "material_0", mtl_file: str | None = None):
    """Write an OBJ with per-corner UVs + a companion MTL referencing textures."""
    with open(path, "w") as f:
        if mtl_file:
            f.write(f"mtllib {mtl_file}\n")
        for v in vertices:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for t in uv:
            f.write(f"vt {t[0]:.6f} {1.0 - t[1]:.6f}\n")
        if mtl_file:
            f.write(f"usemtl {mtl_name}\n")
        for tri, uvt in zip(triangles, uv_tris):
            f.write("f " + " ".join(
                f"{vert_map[u] + 1}/{u + 1}" for u in uvt) + "\n")


def export_mtl(path: str, name: str = "material_0", albedo: str = "albedo.jpg"):
    with open(path, "w") as f:
        f.write(f"newmtl {name}\n")
        f.write("Kd 1.0 1.0 1.0\n")
        f.write(f"map_Kd {albedo}\n")
