"""Relight an extracted mesh and its materials under a new HDR environment
in Blender:

    python -m nero_tpu_torch.relight --name bell-neon --mesh M.ply \
        --material data/materials/<name>-<step> --hdr neon.exr

Drives Blender headless with the repository's
blender_backend/relight_backend.py (a Blender script: bpy, mathutils and
numpy). Blender is an external renderer; this module only builds its
command line, the same as the repository's relight.py.
"""
import argparse
import shutil
import subprocess
import sys

from nero_tpu_torch.core.paths import repo_path


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--blender", type=str, default="blender",
                        help="path to the blender binary")
    parser.add_argument("--name", type=str, required=True,
                        help="output name, e.g. bell-neon")
    parser.add_argument("--mesh", type=str, required=True, help="mesh ply path")
    parser.add_argument("--material", type=str, required=True,
                        help="dir with {metallic,roughness,albedo}.npy")
    parser.add_argument("--hdr", type=str, required=True, help="HDR env map")
    parser.add_argument("--trans", action="store_true", dest="trans", default=False)
    flags = parser.parse_args(argv)

    blender = shutil.which(flags.blender)
    if blender is None:
        print("error: blender binary not found; install Blender or pass --blender",
              file=sys.stderr)
        sys.exit(1)

    backend = repo_path("blender_backend", "relight_backend.py")
    cmd = [blender, "--background", "--python", backend, "--",
           "--name", flags.name, "--mesh", flags.mesh,
           "--material", flags.material, "--hdr", flags.hdr]
    if flags.trans:
        cmd.append("--trans")
    subprocess.run(cmd, check=True)


if __name__ == "__main__":
    main()
