"""Extract the Stage-I SDF iso-surface to <output_dir>/<name>-<step>.ply:

    python -m nero_tpu_torch.extract_mesh --cfg configs/shape/proc/sphere.yaml

Reads the port's own checkpoint (<model_root>/<name>/model.npz), evaluates
the SDF on a resolution^3 grid over [-1.01, 1.01]^3 on the card (`--device
cpu` on the CPU) and extracts the 0-level set on the host. Same flags and
artefact name as the repository's extract_mesh.py.
"""
import argparse
import os
import time
from pathlib import Path

from nero_tpu_torch.core.checkpoint import load_checkpoint
from nero_tpu_torch.core.config import load_cfg
from nero_tpu_torch.core.device import resolve_device
from nero_tpu_torch.fields.sdf import sdf_value
from nero_tpu_torch.geometry.isosurface import extract_fields, surface_from_grid
from nero_tpu_torch.geometry.mesh_io import write_ply
from nero_tpu_torch.models.shape import NeROShapeModel

BOUND_MIN, BOUND_MAX = [-1.01, -1.01, -1.01], [1.01, 1.01, 1.01]


def main(argv=None) -> dict:
    """Returns {'path', 'step', 'vertices', 'triangles', 'grid_seconds',
    'surface_seconds'}."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg", type=str, required=True)
    parser.add_argument("--resolution", type=int, default=512)
    parser.add_argument("--output_dir", type=str, default="data/meshes")
    parser.add_argument("--method", type=str, default="surface_nets",
                        choices=["surface_nets", "marching_tets"],
                        help="iso-surfacer: surface_nets (cell-centred, smoother) or "
                             "marching_tets (edge-interpolated, of the marching-cubes family)")
    parser.add_argument("--device", type=str, default=None, help="default: cuda")
    flags = parser.parse_args(argv)
    device = resolve_device(flags.device)

    cfg = load_cfg(flags.cfg)
    model = NeROShapeModel(cfg, training=False, device=device)
    ckpt_fn = os.path.join(cfg.get("model_root", "data/model"), cfg["name"], "model.npz")
    step, _ = load_checkpoint(ckpt_fn, model.params)
    print(f"loaded step {step} from {ckpt_fn}")

    sdf_params, sdf_cfg = model.params["sdf"], model.scfg.sdf_cfg
    t0 = time.perf_counter()
    grid = extract_fields(BOUND_MIN, BOUND_MAX, flags.resolution,
                          lambda p: sdf_value(sdf_params, p, sdf_cfg), device=device)
    t1 = time.perf_counter()
    vertices, triangles = surface_from_grid(grid, BOUND_MIN, BOUND_MAX, 0.0, flags.method)
    t2 = time.perf_counter()
    print(f"mesh: {len(vertices)} verts, {len(triangles)} tris; grid {flags.resolution}^3 "
          f"on {device.type} {t1 - t0:.3f} s, iso-surface ({flags.method}) on the host "
          f"{t2 - t1:.3f} s")

    Path(flags.output_dir).mkdir(exist_ok=True, parents=True)
    out = os.path.join(flags.output_dir, f"{cfg['name']}-{step}.ply")
    write_ply(out, vertices, triangles)
    print(f"wrote {out}")
    return {"path": out, "step": step, "vertices": vertices, "triangles": triangles,
            "grid_seconds": t1 - t0, "surface_seconds": t2 - t1}


if __name__ == "__main__":
    main()
