"""ctypes bindings for the C++ geometry runtime (the repository's
csrc/nero_native.cpp): BVH build, exact host ray trace, mesh signed
distances, iso-surface extraction and the rasterisers.

The port keeps its own copy of the bindings and its own build of the
library: `g++ -O3 -march=native -fopenmp` into `build/nero_tpu_torch/`, at
first use, named by a hash of the source, the flags and the host CPU model
(so a build directory carried to another machine is rebuilt there). A failed
build raises: there is no retry without OpenMP, which would run the
million-point distance queries on one core without saying so. All functions
have pure-numpy signatures.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading

import numpy as np

from nero_tpu_torch.core.paths import repo_path

_LOCK = threading.Lock()
_LIB = None

_SRC = repo_path("csrc", "nero_native.cpp")
_BUILD_DIR = repo_path("build", "nero_tpu_torch")
_FLAGS = ["-O3", "-march=native", "-fopenmp", "-shared", "-fPIC"]

_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int)
_U8P = ctypes.POINTER(ctypes.c_uint8)


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.strip()
    except OSError:
        pass
    return platform.processor()


def _lib_path() -> str:
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update((" ".join(_FLAGS) + platform.machine() + _cpu_model()).encode())
    return os.path.join(_BUILD_DIR, f"libnero_native-{h.hexdigest()[:16]}.so")


def _build_lib(path: str) -> None:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"   # several processes may build at once
    proc = subprocess.run(["g++", *_FLAGS, "-o", tmp, _SRC], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for csrc/nero_native.cpp (rc {proc.returncode}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, path)


def get_lib():
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        path = _lib_path()
        if not os.path.exists(path):
            _build_lib(path)
        lib = ctypes.CDLL(path)
        lib.nero_free.argtypes = [ctypes.c_void_p]
        lib.isosurface.argtypes = [_F32P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_float, ctypes.POINTER(_F32P), _I32P,
                                   ctypes.POINTER(_I32P), _I32P]
        lib.isosurface_mt.argtypes = lib.isosurface.argtypes
        lib.bvh_build.argtypes = [_F32P, ctypes.c_int, _I32P, ctypes.c_int,
                                  ctypes.c_int, ctypes.POINTER(_F32P),
                                  ctypes.POINTER(_I32P), _I32P,
                                  ctypes.POINTER(_F32P), ctypes.POINTER(_I32P)]
        lib.bvh_trace.argtypes = [_F32P, _I32P, ctypes.c_int, _F32P, ctypes.c_int,
                                  _F32P, _F32P, ctypes.c_int, ctypes.c_float,
                                  _F32P, _F32P, _F32P, _U8P]
        lib.mesh_sdf_grid.argtypes = [_F32P, _I32P, ctypes.c_int, _F32P, ctypes.c_int,
                                      _F32P, _F32P, ctypes.c_int, _F32P]
        lib.mesh_sdf_points.argtypes = [_F32P, _I32P, ctypes.c_int, _F32P,
                                        ctypes.c_int, _F32P, ctypes.c_int, _F32P]
        lib.rasterize_depth.argtypes = [_F32P, ctypes.c_int, _I32P, ctypes.c_int,
                                        _F32P, ctypes.c_int, ctypes.c_int, _F32P]
        lib.rasterize_uv.argtypes = [_F32P, ctypes.c_int, _I32P, ctypes.c_int,
                                     _F32P, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, _F32P, _U8P]
        _LIB = lib
        return lib


def _as_f32(a):
    return np.ascontiguousarray(a, np.float32)


def _as_i32(a):
    return np.ascontiguousarray(a, np.int32)


def _take_array(lib, ptr, shape, dtype):
    n = int(np.prod(shape))
    ctype = ctypes.c_float if dtype == np.float32 else ctypes.c_int
    buf = np.ctypeslib.as_array(ctypes.cast(ptr, ctypes.POINTER(ctype)), (n,))
    out = np.array(buf, dtype=dtype).reshape(shape)
    lib.nero_free(ctypes.cast(ptr, ctypes.c_void_p))
    return out


def isosurface(grid: np.ndarray, iso: float = 0.0):
    """Extract the iso-surface of a [nx,ny,nz] scalar field.

    Returns (vertices [V,3] in grid coords, triangles [T,3] int32)."""
    lib = get_lib()
    grid = _as_f32(grid)
    nx, ny, nz = grid.shape
    verts_p = _F32P()
    tris_p = _I32P()
    nv = ctypes.c_int()
    nt = ctypes.c_int()
    lib.isosurface(grid.ctypes.data_as(_F32P), nx, ny, nz, ctypes.c_float(iso),
                   ctypes.byref(verts_p), ctypes.byref(nv),
                   ctypes.byref(tris_p), ctypes.byref(nt))
    verts = _take_array(lib, verts_p, (nv.value, 3), np.float32)
    tris = _take_array(lib, tris_p, (max(nt.value, 0), 3), np.int32)
    return verts, tris


def isosurface_mt(grid: np.ndarray, iso: float = 0.0):
    """Marching-tetrahedra iso-surface (exact edge-interpolated vertices).

    Marching-cubes-family counterpart of `isosurface` (surface nets); same
    return contract: (vertices [V,3] grid coords, triangles [T,3] int32)."""
    lib = get_lib()
    grid = _as_f32(grid)
    nx, ny, nz = grid.shape
    verts_p = _F32P()
    tris_p = _I32P()
    nv = ctypes.c_int()
    nt = ctypes.c_int()
    lib.isosurface_mt(grid.ctypes.data_as(_F32P), nx, ny, nz,
                      ctypes.c_float(iso),
                      ctypes.byref(verts_p), ctypes.byref(nv),
                      ctypes.byref(tris_p), ctypes.byref(nt))
    verts = _take_array(lib, verts_p, (nv.value, 3), np.float32)
    tris = _take_array(lib, tris_p, (max(nt.value, 0), 3), np.int32)
    return verts, tris


def bvh_build(verts: np.ndarray, tris: np.ndarray, leaf_size: int = 4):
    """Build a flattened hit/miss-link BVH.

    Returns dict: nodes_f [N,8] f32 (bmin,bmax,pad2), nodes_i [N,4] i32
    (tri_start|-1, tri_count, miss, pad), tri_data [T,9] f32 (v0,e1,e2),
    tri_ids [T] i32."""
    lib = get_lib()
    verts = _as_f32(verts)
    tris = _as_i32(tris)
    nodes_f_p = _F32P()
    nodes_i_p = _I32P()
    tri_data_p = _F32P()
    tri_ids_p = _I32P()
    n_nodes = ctypes.c_int()
    lib.bvh_build(verts.ctypes.data_as(_F32P), len(verts),
                  tris.ctypes.data_as(_I32P), len(tris), leaf_size,
                  ctypes.byref(nodes_f_p), ctypes.byref(nodes_i_p),
                  ctypes.byref(n_nodes), ctypes.byref(tri_data_p),
                  ctypes.byref(tri_ids_p))
    n = n_nodes.value
    nt = len(tris)
    return {
        "nodes_f": _take_array(lib, nodes_f_p, (n, 8), np.float32),
        "nodes_i": _take_array(lib, nodes_i_p, (n, 4), np.int32),
        "tri_data": _take_array(lib, tri_data_p, (nt, 9), np.float32),
        "tri_ids": _take_array(lib, tri_ids_p, (nt,), np.int32),
    }


def bvh_trace_cpu(bvh: dict, rays_o: np.ndarray, rays_d: np.ndarray,
                  far: float = 10.0):
    """CPU trace. Returns (inters [n,3], normals [n,3] geometric, depth [n],
    hit [n] bool). Miss: depth=far, inter=o+far*d, normal=0."""
    lib = get_lib()
    rays_o = _as_f32(rays_o)
    rays_d = _as_f32(rays_d)
    n = len(rays_o)
    inters = np.empty((n, 3), np.float32)
    normals = np.empty((n, 3), np.float32)
    depth = np.empty((n,), np.float32)
    hit = np.empty((n,), np.uint8)
    lib.bvh_trace(bvh["nodes_f"].ctypes.data_as(_F32P),
                  bvh["nodes_i"].ctypes.data_as(_I32P), len(bvh["nodes_f"]),
                  bvh["tri_data"].ctypes.data_as(_F32P), len(bvh["tri_data"]),
                  rays_o.ctypes.data_as(_F32P), rays_d.ctypes.data_as(_F32P),
                  n, ctypes.c_float(far),
                  inters.ctypes.data_as(_F32P), normals.ctypes.data_as(_F32P),
                  depth.ctypes.data_as(_F32P), hit.ctypes.data_as(_U8P))
    return inters, normals, depth, hit.astype(bool)


def mesh_sdf_grid(bvh: dict, bmin, bmax, res: int) -> np.ndarray:
    """Signed-distance grid of a watertight mesh (positive outside).

    Returns [res,res,res] f32, x-major. Sign from +x crossing parity,
    magnitude from BVH closest-triangle queries (OpenMP)."""
    lib = get_lib()
    bmin = _as_f32(bmin)
    bmax = _as_f32(bmax)
    out = np.empty((res, res, res), np.float32)
    lib.mesh_sdf_grid(bvh["nodes_f"].ctypes.data_as(_F32P),
                      bvh["nodes_i"].ctypes.data_as(_I32P), len(bvh["nodes_f"]),
                      bvh["tri_data"].ctypes.data_as(_F32P), len(bvh["tri_data"]),
                      bmin.ctypes.data_as(_F32P), bmax.ctypes.data_as(_F32P),
                      res, out.ctypes.data_as(_F32P))
    return out


def mesh_sdf_points(bvh: dict, pts: np.ndarray) -> np.ndarray:
    """Signed distance (positive outside) of a watertight mesh at [N,3] points."""
    lib = get_lib()
    pts = _as_f32(pts)
    out = np.empty((len(pts),), np.float32)
    lib.mesh_sdf_points(bvh["nodes_f"].ctypes.data_as(_F32P),
                        bvh["nodes_i"].ctypes.data_as(_I32P), len(bvh["nodes_f"]),
                        bvh["tri_data"].ctypes.data_as(_F32P), len(bvh["tri_data"]),
                        pts.ctypes.data_as(_F32P), len(pts),
                        out.ctypes.data_as(_F32P))
    return out


def rasterize_depth(verts_cam: np.ndarray, tris: np.ndarray, K: np.ndarray,
                    h: int, w: int) -> np.ndarray:
    """Depth map of a camera-space mesh; 0 where no coverage."""
    lib = get_lib()
    verts_cam = _as_f32(verts_cam)
    tris = _as_i32(tris)
    K = _as_f32(K)
    depth = np.empty((h, w), np.float32)
    lib.rasterize_depth(verts_cam.ctypes.data_as(_F32P), len(verts_cam),
                        tris.ctypes.data_as(_I32P), len(tris),
                        K.ctypes.data_as(_F32P), h, w,
                        depth.ctypes.data_as(_F32P))
    return depth


def rasterize_uv(uv: np.ndarray, tris: np.ndarray, attrs: np.ndarray,
                 h: int, w: int):
    """Bake per-vertex attributes into UV space. Returns (image [h,w,C], mask)."""
    lib = get_lib()
    uv = _as_f32(uv)
    tris = _as_i32(tris)
    attrs = _as_f32(attrs)
    c = attrs.shape[1]
    image = np.empty((h, w, c), np.float32)
    mask = np.empty((h, w), np.uint8)
    lib.rasterize_uv(uv.ctypes.data_as(_F32P), len(uv),
                     tris.ctypes.data_as(_I32P), len(tris),
                     attrs.ctypes.data_as(_F32P), c, h, w,
                     image.ctypes.data_as(_F32P), mask.ctypes.data_as(_U8P))
    return image, mask.astype(bool)
