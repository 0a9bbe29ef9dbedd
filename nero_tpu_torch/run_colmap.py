"""COLMAP structure-from-motion for a custom object capture:

    python -m nero_tpu_torch.run_colmap --project_dir data/custom/kettle

Pre-seeds the database with one shared SIMPLE_RADIAL camera at the focal
guess sqrt(h^2 + w^2), then runs COLMAP's feature_extractor ->
exhaustive_matcher -> mapper, and with the dense steps image_undistorter ->
patch_match_stereo -> stereo_fusion. COLMAP stays an external binary
(preprocessing, not the training path): this module only builds its command
lines, the same as the repository's run_colmap.py.
"""
import argparse
import os
import shutil
import subprocess
import sys
from glob import glob
from pathlib import Path

import numpy as np

from nero_tpu_torch.dataset.colmap_db import COLMAPDatabase
from nero_tpu_torch.utils.image import imread


def run_sfm(project_dir: str, colmap: str = "colmap", same_camera: bool = True,
            dense: bool = True):
    project_dir = Path(project_dir)
    image_dir = project_dir / "images"
    db_path = project_dir / "colmap" / "database.db"
    db_path.parent.mkdir(exist_ok=True, parents=True)

    img_fns = sorted(glob(str(image_dir / "*")))
    assert img_fns, f"no images in {image_dir}"
    h, w = imread(img_fns[0]).shape[:2]
    focal = np.sqrt(h ** 2 + w ** 2)  # a reasonable FOV prior

    if not db_path.exists():
        db = COLMAPDatabase(str(db_path))
        db.add_camera("SIMPLE_RADIAL", w, h, [focal, w / 2, h / 2, 0.0],
                      prior_focal_length=True, camera_id=1)
        for i, fn in enumerate(img_fns):
            db.add_image(os.path.basename(fn), 1, image_id=i + 1)
        db.commit()
        db.close()

    def run(*args):
        print("+", " ".join(args))
        subprocess.run(args, check=True)

    cam_args = ["--ImageReader.single_camera", "1"] if same_camera else []
    run(colmap, "feature_extractor", "--database_path", str(db_path),
        "--image_path", str(image_dir), *cam_args)
    run(colmap, "exhaustive_matcher", "--database_path", str(db_path))
    sparse_dir = project_dir / "colmap" / "sparse"
    sparse_dir.mkdir(exist_ok=True, parents=True)
    run(colmap, "mapper", "--database_path", str(db_path),
        "--image_path", str(image_dir), "--output_path", str(sparse_dir))
    if dense:
        dense_dir = project_dir / "colmap" / "dense"
        dense_dir.mkdir(exist_ok=True, parents=True)
        run(colmap, "image_undistorter", "--image_path", str(image_dir),
            "--input_path", str(sparse_dir / "0"), "--output_path", str(dense_dir))
        run(colmap, "patch_match_stereo", "--workspace_path", str(dense_dir))
        run(colmap, "stereo_fusion", "--workspace_path", str(dense_dir),
            "--output_path", str(dense_dir / "fused.ply"))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--project_dir", type=str, required=True,
                        help="dir with an images/ subfolder")
    parser.add_argument("--colmap", type=str, default="colmap")
    parser.add_argument("--no_dense", action="store_true", default=False)
    flags = parser.parse_args(argv)
    if shutil.which(flags.colmap) is None:
        print("error: colmap binary not found on PATH", file=sys.stderr)
        sys.exit(1)
    run_sfm(flags.project_dir, flags.colmap, dense=not flags.no_dense)


if __name__ == "__main__":
    main()
