"""Tiny configurations for the CPU tests: the real files' structure, with
widths a CPU run holds (ViT `vit_tiny_test`, an IST of width 16, 2
objects of 6 views, 96 x 128 images)."""

import copy
import json
import os.path as osp

HERE = osp.dirname(osp.abspath(__file__))
BENCH = osp.dirname(HERE)


def config(name: str = "gigapose-large") -> dict:
    with open(osp.join(BENCH, "configs", f"{name}.json")) as f:
        c = json.load(f)
    c["model"].update(backbone="vit_tiny_test", embed_dim=64, depth=2, num_heads=2,
                      mlp_hidden=256, ist_initial_dim=16, ist_block_dims=[16, 16, 16, 16],
                      ist_descriptor=16, templates=6)
    # set between the tiny program's readings on the CPU and its control's
    c["checks"]["coarse_images"]["limits"] = {"view_gap_p90": 1e-3, "score_excess_p90": 0.2,
                                              "pose_gap_p90": 1.5e-4, "ae_cos": 1e-4,
                                              "ist_err": 0.05}
    return c


def traffic() -> dict:
    with open(osp.join(BENCH, "traffic", "bop_lmo.json")) as f:
        t = json.load(f)
    t.update(image_hw=[96, 128], template_hw=[96, 128], object_ids=[1, 5],
             detections_cycle=[2, 3], pool_cycles=2, box_px=[24, 60], template_axes_px=[12, 30],
             template_K=[114.5, 114.7, 64.0, 48.0], judged_images=2)
    return copy.deepcopy(t)


def train_traffic() -> dict:
    with open(osp.join(BENCH, "traffic", "train.json")) as f:
        t = json.load(f)
    t.update(batch_size=3, pool_batches=3, image_hw=[96, 128], template_hw=[96, 128],
             template_K=[114.5, 114.7, 64.0, 48.0], K=[114.5, 114.7, 65.0, 48.4],
             template_axes_px=[12, 30], centre_margin_px=[40, 35])
    return t
