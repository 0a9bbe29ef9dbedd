"""The PyTorch port stands alone: no module of nero_tpu_torch, and not
chip_smoke.py, imports JAX or the JAX package; and its CUDA sources hold their
own products: none includes a library of finished kernels or PyTorch's
headers."""
import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "optax", "nero_tpu")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "nero_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in sorted(names) if n.endswith(".py")]
    return sorted(files)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_has_modules():
    assert len(_port_files()) > 30


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_imports(path):
    bad = sorted({m for m in _imported_roots(path) if m in FORBIDDEN})
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


CSRC = os.path.join(ROOT, "nero_tpu_torch", "csrc")
KERNEL_SOURCES = ("sdf_grad.cu", "shader.cu", "sphere_march.cu", "march.cu", "field_fwd.cu",
                  "lights.cu", "sdf_fwd.cu", "predictor.cu")
HEADERS = ("common.cuh", "encode.cuh", "engine.cuh", "field.cuh", "mma.cuh", "sdf_net.cuh")


def test_every_kernel_source_is_registered():
    from nero_tpu_torch.ops import cuda_build
    assert tuple(f"{n}.cu" for n in cuda_build.SOURCES) == KERNEL_SOURCES
    assert sorted(n for n in os.listdir(CSRC) if n.endswith(".cu")) == sorted(KERNEL_SOURCES)
    assert sorted(n for n in os.listdir(CSRC) if n.endswith(".cuh")) == sorted(HEADERS)


@pytest.mark.parametrize("name", KERNEL_SOURCES + HEADERS)
def test_kernel_sources_call_no_library(name):
    text = open(os.path.join(CSRC, name)).read().lower()
    includes = [l for l in text.splitlines() if l.strip().startswith("#include")]
    for word in ("cublas", "cudnn", "cutlass", "torch", "aten", "c10", "thrust", "cub/"):
        assert not any(word in l for l in includes), f"{name} includes {word}"
    assert "cublas" not in text and "cudnn" not in text


def test_every_tpu_kernel_has_a_wrapper_with_a_plain_version_and_a_count():
    """One ops module per TPU kernel of nero_tpu/ops/pallas, each with its
    plain version and its launch counters."""
    import importlib
    for mod, plain in (("sdf_grad", "sdf_with_grad_plain"), ("shader", "shader_raw_plain"),
                       ("sphere_march", "sphere_march_plain"), ("march", "march_plain"),
                       ("lights", "lights_raw_plain"), ("sdf_fwd", "sdf_fwd_plain"),
                       ("field_fwd", "field_fwd_plain"), ("predictor", "predictor_plain")):
        m = importlib.import_module(f"nero_tpu_torch.ops.{mod}")
        assert callable(getattr(m, plain)), (mod, plain)
        assert isinstance(m.launches, dict) and m.launches, mod
        assert all(v == 0 for v in m.launches.values()), f"{mod}: counted a launch on the CPU"
