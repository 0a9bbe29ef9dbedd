"""Neural visibility: distill the mesh SDF into a small MLP and trace it by
marching, all dense linear algebra on the device.

Counterpart of nero_tpu/geometry/neural_tracer.py. Stage-II shading traces
512 x 768 rays per step against the fixed Stage-I mesh:

  1. at init, signed distances of the mesh (exact: the host library's BVH
     closest point + parity sign) are sampled and distilled into a compact
     MLP with Adam on the device: `std` is PE6 -> 4 x 128, `wide` a
     quarter-octave encoding of 123 channels -> 3 dense layers;
  2. per query, at the field's own `pe` (0-7 for the kernels, 6 unless
     given), `ops/sphere_march.py::sphere_march` (march mode `sphere`) or
     `ops/march.py::march` (`uniform`: a fixed scan of n_coarse samples, then
     bisection) brackets the first crossing of the field along each ray and
     refines it (the CUDA kernel for CUDA tensors, its plain version for CPU
     tensors); the normal is the field's gradient at the hit, taken by
     autograd on the f32 field.

Both march modes go through their kernel's wrapper on every device (the JAX
package's non-fused CPU path is a third, all-f32 uniform scan; the port's
`uniform` mode is its fused one). With `uniform`, set `n_refine` to 8: the
default of 2 was tuned for the Illinois refinement of the sphere march. The
distilled fields are cached in the port's own directory: the cache key does
not name the framework, and the two packages draw different random numbers.
The JAX package's tracer distils and packs at its `pe` but marches and takes
the normal at pe 6 whatever it is; this one keeps its pe for both.
"""
from __future__ import annotations

import hashlib
import math
import os

import numpy as np
import torch

from nero_tpu_torch.core.paths import repo_path
from nero_tpu_torch.geometry.bvh import RayTracer
from nero_tpu_torch.geometry.native import mesh_sdf_points
from nero_tpu_torch.ops.march import march
from nero_tpu_torch.ops.mlp import apply_dense, init_dense
from nero_tpu_torch.ops.sphere_march import (TOPOLOGIES, WIDE_CHAINS, WIDE_DIM,
                                             pack_field_params, sphere_march)
from nero_tpu_torch.utils.encodings import positional_encode, positional_encode_dim

MARCH_MODES = ("sphere", "uniform")


# ---------------------------------------------------------------------------
# The distilled field
# ---------------------------------------------------------------------------


def wide_encode(x: torch.Tensor) -> torch.Tensor:
    """The `wide` topology's encoding [..., 3] -> [..., WIDE_DIM]: a finer
    frequency ladder (quarter-octave spacing up to 2^4.75) folded into one
    123-channel first layer, so that the field needs one hidden layer fewer.
    Channel order of ops/sphere_march.py::pe_rows_wide."""
    feats = [x]
    for base, n_oct in WIDE_CHAINS:
        a = x * base
        for _ in range(n_oct):
            feats += [torch.sin(a), torch.cos(a)]
            a = a * 2.0
    return torch.cat(feats, dim=-1)


def init_field(gen: torch.Generator, width: int = 128, depth: int = 4, pe: int = 6,
               topology: str = "std", device="cpu"):
    if topology == "wide":
        dims = [WIDE_DIM, width, width, 1]
    elif topology == "std":
        dims = [positional_encode_dim(3, pe)] + [width] * (depth - 1) + [1]
    else:
        raise NotImplementedError(f"field topology {topology!r}")
    return {"layers": [init_dense(gen, dims[i], dims[i + 1], weight_norm=False, device=device)
                       for i in range(len(dims) - 1)]}


def field_apply(params, x: torch.Tensor, pe: int = 6, topology: str = "std") -> torch.Tensor:
    h = wide_encode(x) if topology == "wide" else positional_encode(x, pe)
    layers = params["layers"]
    for layer in layers[:-1]:
        h = torch.relu(apply_dense(layer, h))
    return apply_dense(layers[-1], h)[..., 0]


# ---------------------------------------------------------------------------
# Distillation
# ---------------------------------------------------------------------------


def _sample_training_points(vertices, triangles, n_surface, n_uniform, bound, rng):
    # area-weighted surface samples with gaussian offsets at three scales
    v0 = vertices[triangles[:, 0]]
    v1 = vertices[triangles[:, 1]]
    v2 = vertices[triangles[:, 2]]
    areas = np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1)
    probs = areas / areas.sum()
    tri_idx = rng.choice(len(triangles), n_surface, p=probs)
    u = rng.rand(n_surface, 1)
    v = rng.rand(n_surface, 1)
    flip = (u + v) > 1
    u = np.where(flip, 1 - u, u)
    v = np.where(flip, 1 - v, v)
    surf = v0[tri_idx] + u * (v1[tri_idx] - v0[tri_idx]) + v * (v2[tri_idx] - v0[tri_idx])
    scales = np.repeat(np.asarray([0.002, 0.01, 0.05]), n_surface // 3 + 1)[:n_surface]
    near = surf + rng.randn(n_surface, 3) * scales[:, None]
    uni = rng.uniform(-bound, bound, (n_uniform, 3))
    return np.concatenate([near, uni], 0).astype(np.float32)


def warmup_cosine_lr(step: int, peak: float, warmup: int, steps: int, end: float) -> float:
    """optax.warmup_cosine_decay_schedule(0, peak, warmup, steps, end)."""
    if step < warmup:
        return peak * step / warmup
    frac = min(max((step - warmup) / max(steps - warmup, 1), 0.0), 1.0)
    return end + (peak - end) * 0.5 * (1.0 + math.cos(math.pi * frac))


def distill_field(vertices, triangles, bvh_np, *, width=128, depth=4, pe=6,
                  n_samples=1_500_000, steps=3000, batch=65536, clamp=0.1, seed=0,
                  bound=1.05, topology="std", device="cpu"):
    """Fit the field to exact mesh signed distances. Returns (params, rms_band)."""
    rng = np.random.RandomState(seed)
    pts = _sample_training_points(vertices, triangles, int(n_samples * 0.7),
                                  n_samples - int(n_samples * 0.7), bound, rng)
    target = np.clip(mesh_sdf_points(bvh_np, pts), -clamp, clamp)

    params = init_field(torch.Generator().manual_seed(seed), width, depth, pe,
                        topology=topology, device=device)
    leaves = [t for layer in params["layers"] for t in layer.values()]
    warmup = min(100, max(1, steps // 10))
    opt = torch.optim.Adam(leaves, lr=2e-3)
    pts_d = torch.as_tensor(pts, device=device)
    tgt_d = torch.as_tensor(target, device=device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    for step in range(steps):
        for group in opt.param_groups:
            group["lr"] = warmup_cosine_lr(step, 2e-3, warmup, steps, 1e-4)
        idx = torch.randint(0, pts_d.shape[0], (batch,), generator=gen, device=device)
        pred = torch.clamp(field_apply(params, pts_d[idx], pe, topology), -clamp, clamp)
        loss = torch.mean((pred - tgt_d[idx]) ** 2)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()

    # report the near-band residual (what visibility accuracy depends on)
    band = np.abs(target) < 0.02
    with torch.no_grad():
        pred = field_apply(params, torch.as_tensor(pts[band][:100000], device=device),
                           pe, topology).cpu().numpy()
    rms = float(np.sqrt(np.mean((pred - target[band][:100000]) ** 2)))
    params = {"layers": [{k: v.detach() for k, v in layer.items()}
                         for layer in params["layers"]]}
    return params, rms


# ---------------------------------------------------------------------------
# Tracing
# ---------------------------------------------------------------------------


def sphere_segment(rays_o, rays_d, bound: float, t0: float = 0.012):
    """The [t_enter, t_exit] segment of each ray inside the bounding sphere
    |p| = bound (the field is only trained there) and its validity."""
    b = torch.sum(rays_o * rays_d, dim=-1)
    c = torch.sum(rays_o ** 2, dim=-1) - bound * bound
    disc = b * b - c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t_enter = torch.clamp(-b - sq, min=t0)
    t_exit = torch.maximum(-b + sq, t_enter + 1e-3)
    return t_enter, t_exit, (disc > 0) & (t_exit > t_enter)


def neural_trace(params, packed, rays_o, rays_d, bound: float, far=10.0, n_coarse: int = 32,
                 n_refine: int = 8, t0: float = 0.012, march_mode: str = "sphere",
                 n_sphere: int = 16, margin: float = 0.003, topology: str = "std",
                 refine: str = "bisect", pe: int = 6):
    """March the field to the first +->- crossing (`sphere`: sphere trace,
    `uniform`: n_coarse-sample scan), refine, and take the normal from the
    field's gradient, all at the field's `pe` octaves (`std`). Returns (t [R],
    normal [R,3] inward (-grad), hit [R]), all detached."""
    with torch.no_grad():
        rays_o, rays_d = rays_o.detach(), rays_d.detach()
        t_enter, t_exit, valid = sphere_segment(rays_o, rays_d, bound, t0)
        if march_mode == "sphere":
            t_mid, found = sphere_march(packed, rays_o, rays_d, t_enter, t_exit,
                                        n_sphere=n_sphere, n_refine=n_refine, t0=t0,
                                        margin=margin, dt_frac=1.0 / (n_coarse - 1),
                                        refine=refine, topology=topology, pe=pe)
        elif march_mode == "uniform":
            t_mid, found = march(packed, rays_o, rays_d, t_enter, t_exit, n_coarse=n_coarse,
                                 n_refine=n_refine, t0=t0, topology=topology, pe=pe)
        else:
            raise NotImplementedError(f"march mode {march_mode!r}")
        hit = found & valid
        t_hit = torch.where(hit, t_mid, torch.full_like(t_mid, far))
        hit_pts = rays_o + rays_d * t_hit[:, None]
    with torch.enable_grad():
        p = hit_pts.requires_grad_(True)
        (grad,) = torch.autograd.grad(field_apply(params, p, pe, topology=topology).sum(), p)
    gn = torch.linalg.norm(grad, dim=-1, keepdim=True)
    normal = torch.where(hit[:, None], -grad / torch.clamp(gn, min=1e-9),
                         torch.zeros_like(grad))
    return t_hit, normal, hit


class NeuralTracer:
    """Tracer of a fixed mesh: distilled SDF field + marching.

    trace(rays_o, rays_d) -> (inters, normals (inward), depth [R,1], hit);
    a miss has depth == far. The exact host BVH is kept for precompute
    passes (`trace_cpu`)."""

    # repo-root anchored: CLIs running from another cwd hit the same cache
    CACHE_DIR = repo_path("data", "cache", "neural_tracer_torch")

    def __init__(self, vertices: np.ndarray, triangles: np.ndarray, far: float = 10.0,
                 width: int = 128, depth: int = 4, pe: int = 6, distill_steps: int = 3000,
                 n_coarse: int = 32, n_refine: int = 8, seed: int = 0, verbose: bool = True,
                 cache: bool = True, distill_samples: int = 1_500_000,
                 distill_batch: int = 65536, march_mode: str = "sphere", n_sphere: int = 18,
                 field_topology: str = "std", refine_mode: str = "illinois", device="cpu"):
        if field_topology not in TOPOLOGIES or march_mode not in MARCH_MODES:
            raise NotImplementedError(f"field topology {field_topology!r}, march mode "
                                      f"{march_mode!r}")
        self.far = far
        self.pe = pe
        self.march_mode = march_mode
        self.field_topology = field_topology
        self.n_coarse = n_coarse
        self.n_refine = n_refine
        self.n_sphere = n_sphere
        self.refine_mode = refine_mode
        self.device = torch.device(device)
        self._bvh_tracer = RayTracer(vertices, triangles, far=far)
        self.bound = float(np.linalg.norm(vertices, axis=-1).max() * 1.05 + 0.02)
        cached = self._load_cache(vertices, triangles, width, depth, pe, distill_steps, seed,
                                  distill_samples, distill_batch,
                                  field_topology) if cache else None
        if cached is not None:
            self.field_params, self.distill_rms = cached
            if verbose:
                print(f"[NeuralTracer] loaded cached field ({self._cache_path})")
        else:
            self.field_params, self.distill_rms = distill_field(
                vertices, triangles, self._bvh_tracer._bvh_np, width=width, depth=depth, pe=pe,
                steps=distill_steps, seed=seed, bound=self.bound, n_samples=distill_samples,
                batch=distill_batch, topology=field_topology, device=self.device)
            if cache:
                self._save_cache()
        self.packed = pack_field_params(self.field_params, pe, topology=field_topology)
        if verbose:
            print(f"[NeuralTracer] distilled {width}x{depth} {field_topology} field; "
                  f"near-band RMS {self.distill_rms:.4f}")

    # -------------------------------------------------------------- cache
    def _load_cache(self, vertices, triangles, width, depth, pe, steps, seed, n_samples,
                    batch, topology="std"):
        """Distilled fields are deterministic in (mesh, hyperparams, seed):
        cache them on disk so every CLI that rebuilds the material model
        pays distillation once."""
        h = hashlib.sha1()
        h.update(np.ascontiguousarray(vertices, np.float32).tobytes())
        h.update(np.ascontiguousarray(triangles, np.int32).tobytes())
        h.update(f"w{width}d{depth}pe{pe}s{steps}seed{seed}n{n_samples}"
                 f"b{batch}v1t{topology}".encode())
        self._cache_path = os.path.join(self.CACHE_DIR, h.hexdigest() + ".npz")
        if not os.path.exists(self._cache_path):
            return None
        try:
            data = np.load(self._cache_path)
            params = {"layers": [{"w": torch.as_tensor(data[f"w{i}"], device=self.device),
                                  "b": torch.as_tensor(data[f"b{i}"], device=self.device)}
                                 for i in range(int(data["n_layers"]))]}
            return params, float(data["rms"])
        except Exception as e:  # corrupt cache: re-distill
            print(f"[NeuralTracer] cache read failed ({e}); re-distilling")
            return None

    def _save_cache(self):
        os.makedirs(self.CACHE_DIR, exist_ok=True)
        layers = self.field_params["layers"]
        arrs = {"n_layers": np.asarray(len(layers)), "rms": np.asarray(self.distill_rms)}
        for i, layer in enumerate(layers):
            arrs[f"w{i}"] = layer["w"].cpu().numpy()
            arrs[f"b{i}"] = layer["b"].cpu().numpy()
        tmp = f"{self._cache_path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **arrs)
        os.replace(tmp, self._cache_path)

    @property
    def margin(self) -> float:
        """Sphere-trace safety margin against field error: 3x the measured
        near-band distill RMS (the field must not claim "far" when near)."""
        return max(0.002, 3.0 * float(self.distill_rms))

    def trace_fn(self):
        def fn(rays_o, rays_d):
            t, normal, hit = neural_trace(self.field_params, self.packed, rays_o, rays_d,
                                          self.bound, self.far, self.n_coarse, self.n_refine,
                                          march_mode=self.march_mode, n_sphere=self.n_sphere,
                                          margin=self.margin, topology=self.field_topology,
                                          refine=self.refine_mode, pe=self.pe)
            inters = rays_o + rays_d * t[:, None]
            return inters, normal, t[:, None], hit
        return fn

    def trace(self, rays_o, rays_d):
        return self.trace_fn()(rays_o, rays_d)

    def trace_cpu(self, rays_o, rays_d):
        return self._bvh_tracer.trace_cpu(rays_o, rays_d)
