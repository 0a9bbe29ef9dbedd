"""Multi-scene Stage I of the port (models/multi_scene.py,
train_multi_scene.py) on the CPU: the scenes against each scene trained
alone, the ('scene', 'data') layout on 4 gloo ranks, the stacked checkpoint
against nero_tpu's in both directions, and the entry point.

Bars: in one process a scene is its scene alone to the bit (the same
operations on the same numbers); on the 2 x 2 layout nero_tpu's DP bars of
tests/test_parallel.py::test_scene_by_ray_mesh_matches_per_scene (loss rtol
2e-3 / atol 1e-5, parameters 2e-4); checkpoint leaves are copies, equal to
the bit."""
import os

import jax
import numpy as np
import optax
import pytest
import torch
import yaml

import torch_parallel_common as C
from nero_tpu.core import checkpoint as JC
from nero_tpu.models.multi_scene import MultiSceneShapeModel as JaxMultiScene
from nero_tpu.train.lr import name2lr_schedule as jax_schedules
from nero_tpu_torch import train_multi_scene as tool
from nero_tpu_torch.core.checkpoint import load_checkpoint
from nero_tpu_torch.core.convert import tree_items
from nero_tpu_torch.models.multi_scene import MultiSceneShapeModel
from nero_tpu_torch.models.shape import NeROShapeModel
from test_torch_shape_e2e import TINY_CFG

torch.set_num_threads(1)

LR_CFG = {"end_warm": 1, "end_iter": 10, "lr": 1e-3}


def _cfgs(n=2, **over):
    return [{**TINY_CFG, "name": f"scene{s}", "lr_cfg": LR_CFG, **over} for s in range(n)]


def _alone(cfg, s, steps):
    """Scene s trained alone with seed random_seed + s: (logs, parameters)."""
    model = NeROShapeModel({**cfg, "random_seed": cfg.get("random_seed", 6033) + s},
                           device="cpu")
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    logs = [C._numpy(model.train_step(opt, i)) for i in range(steps)]
    return logs, C._params(model.params)


def test_scenes_in_one_process_are_the_scenes_alone():
    cfgs = _cfgs()
    ms = MultiSceneShapeModel(cfgs, device="cpu")
    assert ms.scenes == [0, 1] and ms.names == ["scene0", "scene1"]
    opt = torch.optim.Adam(ms.parameters(), lr=1e-3)
    logs = [ms.train_step(opt, i) for i in range(3)]
    assert logs[-1][0]["loss_total"] != logs[-1][1]["loss_total"]
    for s in range(2):
        alone_logs, alone = _alone(cfgs[s], s, 3)
        got = C._params(ms.scene_params(s))
        assert all(np.array_equal(got[k], alone[k]) for k in alone), s
        assert [C._numpy(l[s]) for l in logs] == alone_logs
    out = ms.test_step(1, 0, 3)
    assert np.isfinite(out["ray_rgb"]).all()


def test_scenes_must_share_the_step():
    cfgs = _cfgs()
    with pytest.raises(ValueError, match="differs from scene 0"):
        MultiSceneShapeModel([cfgs[0], {**cfgs[1], "n_samples": 8}], training=False,
                             device="cpu")
    # per-scene keys may differ, at any depth
    nested = lambda c, db: {**c, "val_set_list": [{"name": "val", "cfg": {"database_name": db}}]}
    MultiSceneShapeModel([nested(cfgs[0], "a"), nested(cfgs[1], "b")], training=False,
                         device="cpu")
    with pytest.raises(ValueError, match="differ in count or size"):
        MultiSceneShapeModel([cfgs[0], {**cfgs[1], "database_name": "proc/sphere/32_4"}],
                             device="cpu")


def test_scene_by_ray_layout_matches_each_scene_alone(tmp_path):
    """('scene', 'data') 2 x 2 on 4 gloo ranks: each scene on its own ray
    group within the DP bars of the scene alone (seeds 100 + s + s, as
    nero_tpu's test offsets them)."""
    cfgs = [{**c, "bf16_hidden": False, "random_seed": 100 + s}
            for s, c in enumerate(_cfgs())]
    out = C.run_ranks("multi_scene_step", 4, tmp_path, cfgs, 2)
    assert [o[0] for o in out] == [0, 0, 1, 1]
    for s in range(2):
        alone_logs, alone = _alone(cfgs[s], s, 2)
        for scene, logs, params in out[2 * s:2 * s + 2]:
            for got, want in zip(logs, alone_logs):
                np.testing.assert_allclose(got[s]["loss_total"], want["loss_total"],
                                           rtol=2e-3, atol=1e-5)
            worst = max(float(np.max(np.abs(params[k] - alone[k]))) for k in alone)
            assert worst < 2e-4, (s, worst)


def _yaml_cfgs(tmp_path, n=2):
    paths = []
    for c in _cfgs(n):
        p = tmp_path / f"{c['name']}.yaml"
        p.write_text(yaml.safe_dump(c))
        paths.append(str(p))
    return paths


def _run(paths, root, total, **flags):
    argv = ["--cfgs", *paths, "--total_step", str(total), "--model_root", str(root),
            "--device", "cpu"]
    for k, v in flags.items():
        argv += [f"--{k}", str(v)]
    return tool.main(argv)


def test_entry_point_flags_resume_and_exports(tmp_path, capsys):
    paths = _yaml_cfgs(tmp_path)
    full = _run(paths, tmp_path / "a", 4, log_step=1, save_interval=2)
    assert full["checkpoint"] == str(tmp_path / "a" / "multi_scene0_scene1" / "model.npz")
    assert [h["step"] for h in full["history"]] == [0, 1, 2, 3]
    text = capsys.readouterr().out
    assert "multi-scene training: ['scene0', 'scene1'] for 4 steps" in text
    assert "step 4: mean loss" in text and "exported" in text
    _run(paths, tmp_path / "b", 2, log_step=1)
    resumed = _run(paths, tmp_path / "b", 4, log_step=1)
    assert "resumed from step 2" in capsys.readouterr().out
    assert [h["step"] for h in resumed["history"]] == [2, 3]
    for s in range(2):
        a = C._params(full["model"].scene_params(s))
        b = C._params(resumed["model"].scene_params(s))
        assert all(np.array_equal(a[k], b[k]) for k in a), s
        assert resumed["history"][-1][f"scene{s}/loss_total"] == \
            full["history"][-1][f"scene{s}/loss_total"]
    # the exports load into the port's single-scene model and nero_tpu's loader
    for s, fn in enumerate(full["exports"]):
        assert fn == str(tmp_path / "a" / f"scene{s}" / "model.npz")
        model = NeROShapeModel(dict(_cfgs()[s]), training=False, device="cpu")
        assert load_checkpoint(fn, model.params)[0] == 4
        want = C._params(full["model"].scene_params(s))
        assert all(np.array_equal(v.detach().numpy(), want[k])
                   for k, v in tree_items(model.params))
        step, _, jp, _ = JC.load_checkpoint(fn, JaxMultiScene(_cfgs(), training=False)
                                            .models[s].params)
        got = dict(tree_items(jax.tree_util.tree_map(np.asarray, jp)))
        assert step == 4 and all(np.array_equal(got[k], want[k]) for k in want)
    # more than three scenes name the checkpoint by the first three
    assert tool.checkpoint_path("r", ["a", "b", "c", "d", "e"]) == \
        os.path.join("r", "multi_a_b_c_plus2", "model.npz")


def _jax_templates(n=2):
    ms = JaxMultiScene(_cfgs(n), training=False)
    opt = optax.adam(learning_rate=jax_schedules["warm_up_cos"](dict(LR_CFG)))
    return ms.params, jax.vmap(opt.init)(ms.params)


def test_stacked_checkpoint_port_to_nero_tpu(tmp_path):
    paths = _yaml_cfgs(tmp_path)
    out = _run(paths, tmp_path, 3, log_step=10, save_interval=10)
    ms = out["model"]
    params_t, opt_t = _jax_templates()
    step, _, params, opt_state = JC.load_checkpoint(out["checkpoint"], params_t, opt_t)
    assert step == 3
    got = dict(tree_items(jax.tree_util.tree_map(np.asarray, params)))
    adam, sched = opt_state
    mu = dict(tree_items(jax.tree_util.tree_map(np.asarray, adam.mu)))
    nu = dict(tree_items(jax.tree_util.tree_map(np.asarray, adam.nu)))
    assert np.array_equal(np.asarray(adam.count), [3, 3])
    assert np.array_equal(np.asarray(sched.count), [3, 3])
    # the stacked leaves and their Adam state, scene s at index s
    for k, leaf in tree_items(ms.params):
        st = out["optimizer"].state[leaf]
        for s in range(2):
            assert np.array_equal(got[k][s], leaf[s].detach().numpy()), k
            assert np.array_equal(mu[k][s], st["exp_avg"][s].numpy()), k
            assert np.array_equal(nu[k][s], st["exp_avg_sq"][s].numpy()), k


def test_stacked_checkpoint_nero_tpu_to_port(tmp_path):
    """nero_tpu's stacked checkpoint (random moments, counts [5, 5]) resumes
    the port's tool: its parameters and Adam state are the file's."""
    params, opt_state = _jax_templates()
    rng = np.random.default_rng(0)
    noise = lambda t: jax.tree_util.tree_map(
        lambda a: np.asarray(rng.standard_normal(a.shape), np.float32), t)
    params = noise(params)
    adam, sched = opt_state
    opt_state = (adam._replace(count=np.asarray([5, 5], np.int32), mu=noise(adam.mu),
                               nu=jax.tree_util.tree_map(np.abs, noise(adam.nu))),
                 sched._replace(count=np.asarray([5, 5], np.int32)))
    paths = _yaml_cfgs(tmp_path)
    ckpt = tool.checkpoint_path(str(tmp_path), ["scene0", "scene1"])
    JC.save_checkpoint(ckpt, 5, 0.0, params, opt_state)
    out = _run(paths, tmp_path, 5, log_step=10)        # resumes at 5: no step left
    assert out["history"] == []
    want = dict(tree_items(jax.tree_util.tree_map(np.asarray, params)))
    mu = dict(tree_items(jax.tree_util.tree_map(np.asarray, opt_state[0].mu)))
    opt = out["optimizer"]
    for k, leaf in tree_items(out["model"].params):
        assert float(opt.state[leaf]["step"]) == 5.0
        for s in range(2):
            assert np.array_equal(leaf[s].detach().numpy(), want[k][s]), k
            assert np.array_equal(opt.state[leaf]["exp_avg"][s].numpy(), mu[k][s]), k
