"""Builds the port's CUDA sources with nvcc and loads them with ctypes.

Each `csrc/<name>.cu` becomes `build/nero_tpu_torch/<name>-<hash>.so`, a
shared library with a plain C interface, compiled for `sm_90a`. The hash
covers the source and the shared headers, so an edited source rebuilds and an
unchanged one is reused. A source whose widths follow a configuration (the
SDF's PE octaves, the IDE degree, the light PE octaves) is built once per
specialisation: `defines` are `-D` macros, written into the library's name
(`<name>-<tag>-<hash>.so`) and its hash; no defines is the shipped
configuration. Nothing is compiled when a module is imported: the first call
that launches a kernel builds it (or `build_all` builds every source at
once, one nvcc process each, in parallel).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

from nero_tpu_torch.core.paths import repo_path

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = repo_path("build", "nero_tpu_torch")
SOURCES = ("sdf_grad", "shader", "sphere_march", "march", "field_fwd", "lights", "sdf_fwd",
           "predictor")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def tag(defines=()) -> str:
    """The specialisation's part of a library's name: `NERO_IDE_DEG=4` gives
    `ide_deg4`."""
    return "-".join(f"{k.removeprefix('NERO_').lower()}{v}" for k, v in defines)


def label(name: str, defines=()) -> str:
    return f"{name}[{tag(defines)}]" if defines else name


def _lib_path(name: str, defines=()) -> str:
    h = hashlib.sha256()
    headers = sorted(fn for fn in os.listdir(CSRC) if fn.endswith(".cuh"))
    for fn in (f"{name}.cu", *headers):
        with open(os.path.join(CSRC, fn), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS + _flags(defines)).encode())
    stem = f"{name}-{tag(defines)}" if defines else name
    return os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:16]}.so")


def _flags(defines) -> list:
    return [f"-D{k}={v}" for k, v in defines]


def _start(name: str, defines=()):
    """Start nvcc for one source; returns (path, (process, log, start) or None
    if built)."""
    path = _lib_path(name, defines)
    if os.path.exists(path):
        return path, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    log = open(path + ".log", "w")
    cmd = [_nvcc(), *NVCC_FLAGS, *_flags(defines), "-o", path + ".tmp",
           os.path.join(CSRC, f"{name}.cu")]
    return path, (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), log,
                  time.perf_counter())


def _finish(what: str, path: str, job) -> float:
    """Wait for a build; its seconds from the start (0.0 when it was built)."""
    if job is None:
        return 0.0
    proc, log, start = job
    rc = proc.wait()
    seconds = time.perf_counter() - start
    log.close()
    if rc != 0:
        with open(path + ".log") as f:
            raise RuntimeError(f"nvcc failed for {what} (rc {rc}):\n{f.read()}")
    os.replace(path + ".tmp", path)
    return seconds


def _key(job) -> tuple:
    """A job of `build_all`: a source name, or (name, defines)."""
    return (job, ()) if isinstance(job, str) else (job[0], tuple(job[1]))


def build_all(jobs=SOURCES) -> dict:
    """Compile every library of `jobs` that is not built yet, all nvcc runs
    at once; returns each one's seconds from the start to its end (0.0 where
    it was built before) by `label`."""
    with _lock:
        started = {_key(j): _start(*_key(j)) for j in jobs}
        return {label(*k): _finish(label(*k), path, job) for k, (path, job) in started.items()}


def load(name: str, defines=()) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu with `defines` ((macro, value)
    pairs), building it on first use."""
    key = (name, tuple(defines))
    with _lock:
        if key not in _libs:
            path, job = _start(*key)
            _finish(label(*key), path, job)
            _libs[key] = ctypes.CDLL(path)
        return _libs[key]


def parse_ptxas(log: str, kernel: str) -> dict:
    """Registers and spill bytes (stores + loads) that `-Xptxas -v` reported
    for the first entry function whose mangled name matches `kernel` (a
    regular expression: a template instance is its name, `\\w*` and the
    mangled arguments); empty if the log does not have it. The spills are
    the entry's own, not those of the functions it calls, which ptxas lists
    after it."""
    info, inside, own, entry = {}, False, False, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            if inside:
                break
            inside = own = re.search(kernel, line) is not None
            entry = re.search(r"Compiling entry function '([^']+)'", line).group(1)
        elif inside and "Function properties for" in line:
            own = line.split("Function properties for", 1)[1].strip() == entry
        elif own and "spill stores" in line:
            nums = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            info["spill_bytes"] = sum(int(x) for x in nums)
        elif inside and "Used" in line and "registers" in line:
            info["regs"] = int(re.search(r"Used (\d+) registers", line).group(1))
    return info


def ptxas_info(name: str, kernel: str, defines=()) -> dict:
    """`parse_ptxas` of csrc/<name>.cu's build log (with `defines`); empty
    without one (a library built elsewhere)."""
    log = (_lib_path(name, defines) if defines else _lib_path(name)) + ".log"
    if not os.path.exists(log):
        return {}
    with open(log) as f:
        return parse_ptxas(f.read(), kernel)


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
