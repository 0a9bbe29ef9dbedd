"""Validation metrics, PSNR path: 'shape_render' (ground truth, render,
normals) and 'mat_render' (ground truth, render and the material panels),
each PSNR/SSIM plus a JPEG (counterpart of nero_tpu/train/metrics.py).
Runs on the host after the outputs are fetched."""
from __future__ import annotations

from pathlib import Path

import numpy as np

from nero_tpu_torch.utils.color import color_map_backward
from nero_tpu_torch.utils.image import compute_psnr, compute_ssim, concat_images_list, imsave


def _to_img(data, h, w):
    img = color_map_backward(np.asarray(data)).reshape([h, w, -1])
    return np.repeat(img, 3, axis=-1) if img.shape[-1] == 1 else img


def shape_render_metrics(data_pr, data_gt, step, *, data_index, model_name,
                         vis_dir="data/train_vis"):
    rgb_gt = color_map_backward(np.asarray(data_pr["gt_rgb"]))
    rgb_pr = color_map_backward(np.asarray(data_pr["ray_rgb"]))
    h, w, _ = rgb_pr.shape
    out_dir = Path(vis_dir) / model_name
    out_dir.mkdir(exist_ok=True, parents=True)
    imsave(str(out_dir / f"{step}-index-{data_index}.jpg"),
           concat_images_list(rgb_gt, rgb_pr, _to_img(data_pr["normal"], h, w)))
    return {"psnr": np.asarray([compute_psnr(rgb_gt, rgb_pr)]),
            "ssim": np.asarray([compute_ssim(rgb_gt, rgb_pr)])}


def mat_render_metrics(data_pr, data_gt, step, *, data_index, model_name,
                       vis_dir="data/train_vis"):
    rgb_gt = color_map_backward(np.asarray(data_pr["rgb_gt"]))
    rgb_pr = color_map_backward(np.asarray(data_pr["rgb_pr"]))
    h, w, _ = rgb_pr.shape
    imgs = [rgb_gt, rgb_pr]
    for k in ["albedo", "metallic", "roughness", "specular_light", "specular_color",
              "diffuse_light", "diffuse_color"]:
        if k in data_pr:
            imgs.append(_to_img(data_pr[k], h, w))
    panels = [concat_images_list(*imgs[:5]), concat_images_list(*imgs[5:])]
    out_dir = Path(vis_dir) / model_name
    out_dir.mkdir(exist_ok=True, parents=True)
    imsave(str(out_dir / f"{step}-index-{data_index}.jpg"),
           concat_images_list(*panels, vert=True))
    return {"psnr": np.asarray([compute_psnr(rgb_gt, rgb_pr)]),
            "ssim": np.asarray([compute_ssim(rgb_gt, rgb_pr)])}


name2metrics = {"shape_render": shape_render_metrics, "mat_render": mat_render_metrics}


def psnr_key_metric(results: dict) -> float:
    return float(np.mean(results["psnr"]))


name2key_metrics = {"psnr": psnr_key_metric}
