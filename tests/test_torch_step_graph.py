"""The Stage-I step replayed from a CUDA graph (nero_tpu_torch/core/
step_graph.py). On the CPU: the per-step numbers passed as 0-d tensors give
the Python numbers' bits, the graph's key, which models take the eager path,
and the kernel counters' arithmetic on a stand-in graph. On the card (`-m
gpu`): graphed steps against eager steps from the same weights and
generator states, a returned log that later steps leave alone, the launch
counters, and the port's kernels in a profiler trace of replayed steps. No
JAX is imported: the card's tests run here too."""
import contextlib

import pytest
import torch
from torch.utils._pytree import tree_leaves

from nero_tpu_torch.core import step_graph as sg
from nero_tpu_torch.core.step_graph import StepGraph, ineligible_reason
from nero_tpu_torch.models.multi_scene import MultiSceneShapeModel
from nero_tpu_torch.models.shape import NeROShapeModel, step_key, step_scalars
from nero_tpu_torch.ops import sdf_grad
from nero_tpu_torch.ops.mlp import scaled
from nero_tpu_torch.render.rays import sample_ray_batch
from nero_tpu_torch.render.shape import _CumprodOfNonzero, shape_config_from_dict

torch.set_num_threads(1)

# the phases of a Stage-I job at a test's size: the init-SDF term to 1,000,
# inv_s frozen to 15,000, the occlusion loss from 20,000, the anneal to
# 50,000, the eikonal weight ramped from 500 to 30,000
TINY = {
    "name": "graph_tiny", "network": "shape", "database_name": "proc/sphere/32_6",
    "n_samples": 8, "n_importance": 8, "up_sample_steps": 2, "n_bg_samples": 4,
    "train_ray_num": 16, "test_ray_num": 64, "occ_loss_step": 20000, "occ_loss_max_pn": 32,
    "freeze_inv_s_step": 15000, "anneal_end": 50000,
    "loss": ["nerf_render", "eikonal", "std", "init_sdf_reg", "occ"],
    "eikonal_weight": 0.1, "eikonal_weight_anneal_begin": 500,
    "eikonal_weight_anneal_end": 30000, "key_metric_name": "psnr",
}
STEPS = (999, 1000, 14999, 15000, 19999, 20000, 25000, 50001)
# another step of each one's key: a captured step's code reads its numbers
# from the scalars and may not read the step number for anything else
SAME_KEY = {999: 0, 1000: 14999, 14999: 1000, 15000: 19999, 19999: 15000, 20000: 50001,
            25000: 20000, 50001: 25000}


def _as_scalars(numbers: dict) -> dict:
    """The step's numbers as StepGraph hands them to the step's work: views
    of one f32 vector."""
    values = torch.tensor([float(v) for v in numbers.values()], dtype=torch.float32)
    return {k: values[i] for i, k in enumerate(numbers)}


@pytest.fixture(scope="module")
def tiny():
    model = NeROShapeModel(TINY, device="cpu")
    d = model.train_data
    batch = sample_ray_batch(torch.Generator().manual_seed(3), d["imgs_u8"], d["K_inv"],
                             d["poses"], TINY["train_ray_num"], d["human_poses"])
    return model, batch, model.gen.get_state()


def _loss_and_grads(model, batch, step, state, scalars=None):
    model.gen.set_state(state)
    for p in model.parameters():
        p.grad = None
    loss, log = model.loss_fn(model.params, batch, step, model.gen, None, scalars)
    loss.backward()
    return ([loss.detach()] + [log[k].detach() for k in sorted(log)],
            [None if p.grad is None else p.grad.clone() for p in model.parameters()],
            model.gen.get_state())


@pytest.mark.parametrize("number", ["own", "same_key"])
@pytest.mark.parametrize("step", STEPS)
def test_step_numbers_as_device_scalars_give_the_same_bits(tiny, step, number):
    """Render, losses and gradients with the step's numbers as 0-d tensors
    equal the Python numbers' to the bit; with the step number of another
    step of the same key too, so nothing else of the step reads it."""
    model, batch, state = tiny
    want = _loss_and_grads(model, batch, step, state)
    n = step if number == "own" else SAME_KEY[step]
    assert step_key(n, model.cfg, model.scfg) == step_key(step, model.cfg, model.scfg)
    got = _loss_and_grads(model, batch, n, state,
                          _as_scalars(step_scalars(step, model.cfg, model.scfg)))
    for a, b in zip(want[0], got[0]):
        assert torch.equal(a, b), (a, b)
    for a, b in zip(want[1], got[1]):
        assert (a is None and b is None) or torch.equal(a, b)
    assert torch.equal(want[2], got[2])


def test_the_key_holds_over_a_phase_and_changes_at_its_ends():
    cfg = {**TINY, "loss": TINY["loss"]}
    scfg = shape_config_from_dict(cfg)
    assert len({step_key(s, cfg, scfg) for s in range(25000, 25011)}) == 1
    for a, b in ((999, 1000), (14999, 15000), (19999, 20000)):
        assert step_key(a, cfg, scfg) != step_key(b, cfg, scfg), (a, b)
    # the anneal's end is a number, not another program
    assert step_key(49999, cfg, scfg) == step_key(50001, cfg, scfg)
    no_reg = {**cfg, "loss": [n for n in cfg["loss"] if n != "init_sdf_reg"]}
    assert step_key(999, no_reg, scfg) == step_key(1000, no_reg, scfg)


def test_eligibility_follows_what_the_model_can_observe():
    scfg = shape_config_from_dict(TINY)
    cuda = torch.device("cuda")
    assert ineligible_reason(cuda, None, scfg) is None
    assert ineligible_reason("cpu", None, scfg) == "not_cuda"
    assert ineligible_reason(cuda, object(), scfg) == "ray_group"
    assert ineligible_reason(cuda, None, scfg._replace(remat_shader=True)) == "remat_shader"


@pytest.mark.parametrize("scenes", [1, 2], ids=["one_scene", "scenes2"])
def test_the_cpu_takes_the_eager_step(scenes):
    if scenes == 1:
        model = NeROShapeModel(TINY, device="cpu")
    else:
        model = MultiSceneShapeModel([{**TINY, "name": f"s{s}"} for s in range(scenes)],
                                     device="cpu")
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    for step in (25000, 25001):
        model.train_step(opt, step)
    assert model.step_graph.reason == "not_cuda"
    assert model.step_graph.counts == {"captures": 0, "replays": 0, "eager": {"not_cuda": 2}}
    assert model.step_graph.replayed_share() == 0.0


class _StandInGraph:
    """A CUDA graph that captures nothing and replays nothing: the body runs
    once under the capture, as PyTorch dispatches it there."""

    def __init__(self):
        self.generators, self.replays = [], 0

    def register_generator_state(self, gen):
        self.generators.append(gen)

    def replay(self):
        self.replays += 1


class _StandInStream:
    def wait_stream(self, other):
        pass


@pytest.fixture
def stand_in(monkeypatch):
    """The helper's CUDA calls on the CPU; the kernel counters restored after."""
    graphs = []

    def new_graph():
        graphs.append(_StandInGraph())
        return graphs[-1]

    monkeypatch.setattr(torch.cuda, "CUDAGraph", new_graph)
    monkeypatch.setattr(torch.cuda, "graph", lambda g: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: _StandInStream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _StandInStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.Tensor, "pin_memory", lambda self: self)
    counts = sg.kernel_counts()
    yield graphs
    sg.set_counts(counts)


def _counted_body(p, gen):
    """A step's work that counts one B1 forward launch of 10 FLOPs, as a
    kernel wrapper counts on the host."""
    def body(step, scalars):
        sdf_grad.launches["sdf_grad_fwd"] += 1
        sdf_grad.flop_tally["sdf_grad_fwd"] += 10.0
        loss = scaled(p * torch.rand(p.shape, generator=gen), scalars["w"]).sum()
        loss.backward()
        return {"loss": loss.detach(), "scene": {"n": torch.ones(2, dtype=torch.int64)}}
    return body


def test_counters_count_each_replay_and_not_the_capture(stand_in):
    gen = torch.Generator().manual_seed(0)
    p = torch.nn.Parameter(torch.ones(4))
    opt = torch.optim.SGD([p], lr=0.1)
    graph = StepGraph("cpu", None, [gen])
    body = _counted_body(p, gen)
    l0, f0 = sdf_grad.launches["sdf_grad_fwd"], sdf_grad.flop_tally["sdf_grad_fwd"]

    def counted():
        return (sdf_grad.launches["sdf_grad_fwd"] - l0,
                sdf_grad.flop_tally["sdf_grad_fwd"] - f0)

    graph.step(opt, 0, body, "a", {"w": 0.5})                 # the warm-up, eager
    assert counted() == (1, 10.0) and graph.graph is None
    graph.step(opt, 1, body, "a", {"w": 0.5})                 # capture, one replay
    assert counted() == (2, 20.0)                           # the capture's count taken back
    assert stand_in[0].generators == [gen] and stand_in[0].replays == 1
    assert graph.grads[0] is p.grad
    for step in (2, 3, 4):
        log = graph.step(opt, step, body, "a", {"w": 0.5})   # replays
    assert counted() == (5, 50.0) and stand_in[0].replays == 4
    assert graph.counts == {"captures": 1, "replays": 4, "eager": {"warmup": 1}}
    assert graph.replayed_share() == pytest.approx(0.8)
    assert log["scene"]["n"].dtype == torch.int64 and log["loss"].shape == ()

    graph.step(opt, 5, body, "b", {"w": 0.25})                # a new key warms up again
    graph.step(opt, 6, body, "b", {"w": 0.25})
    assert counted() == (7, 70.0) and len(stand_in) == 2
    p.grad = torch.zeros_like(p)                            # the graph's buffer replaced
    graph.step(opt, 7, body, "b", {"w": 0.25})
    assert graph.graph is None and graph.counts["eager"]["warmup"] == 3
    assert graph.counts["captures"] == 2 and graph.counts["replays"] == 5


def test_a_returned_log_is_a_copy_of_the_graph_outputs(stand_in):
    gen = torch.Generator().manual_seed(0)
    p = torch.nn.Parameter(torch.ones(4))
    opt = torch.optim.SGD([p], lr=0.1)
    graph = StepGraph("cpu", None, [gen])
    body = _counted_body(p, gen)
    for step in (0, 1):                                     # warm-up; capture, one replay
        first = graph.step(opt, step, body, "a", {"w": 0.5})
    want = _floats(first)
    for t in tree_leaves(graph.log):
        t.zero_()                       # the next replay rewrites the outputs
    assert _floats(first) == want and want[0] != 0.0
    second = graph.step(opt, 2, body, "a", {"w": 0.5})
    assert _floats(second) == [0.0, [0, 0]]
    assert second["scene"]["n"].dtype == torch.int64


def test_scaled_multiplies_as_a_python_number_does():
    t = torch.linspace(-3, 3, 97).to(torch.bfloat16)
    s = 0.123456789
    assert torch.equal(scaled(t, torch.tensor(s)), t * s)
    f = torch.linspace(-3, 3, 97)
    assert torch.equal(scaled(f, torch.tensor(s)), f * s)


def test_the_encodings_make_their_device_tables_once():
    """A table made from a Python list on the device is a host copy, which a
    capture refuses: the encodings make theirs once a device, in the warm-up."""
    from nero_tpu_torch.utils.encodings import _ipe_scales, integrated_pos_encode

    cpu = torch.device("cpu")
    scales = _ipe_scales(0, 6, cpu, torch.float32)
    assert _ipe_scales(0, 6, cpu, torch.float32) is scales
    assert scales.tolist() == [2.0 ** i for i in range(6)]
    mean, var = torch.randn(7, 3), torch.rand(7, 3)
    mean_s = (mean[..., None, :] * scales[:, None]).reshape(7, 18)
    var_s = (var[..., None, :] * scales[:, None] ** 2).reshape(7, 18)
    got = integrated_pos_encode(mean, var, 0, 6)
    assert torch.equal(got[:, :18], torch.exp(-0.5 * var_s) * torch.sin(mean_s))


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_capturable_cumprod_is_torch_cumprod_to_the_bit(device, dtype):
    """The compositing's cumulative product, whose backward reads nothing
    back to the host, against torch.cumprod's forward and backward, on the
    shapes of a batch of rays (the factors 1 - alpha + 1e-7, no zero)."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator().manual_seed(7)
    for shape in ((512, 161), (37, 2), (3, 5, 129)):
        x = (1.0 - torch.rand(shape, generator=gen, dtype=dtype) + 1e-7).to(device)
        g = torch.randn(shape, generator=gen, dtype=dtype).to(device)
        a, b = x.clone().requires_grad_(), x.clone().requires_grad_()
        ya, yb = torch.cumprod(a, -1), _CumprodOfNonzero.apply(b)
        ya.backward(g)
        yb.backward(g)
        assert torch.equal(ya, yb) and torch.equal(a.grad, b.grad), shape


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

# (configuration, scenes, the shader's kernel family): the whole shader (B2)
# launches once a step each way; the per-head shader of sphere_heads.yaml
# runs the predictor kernel (B8) head by head and the value-only SDF kernel
# (B6) in the sampler and the occlusion marches, several times a step
CARD = {"sphere": ("configs/shape/proc/sphere.yaml", 1, "shader"),
        "human_light": ("configs/shape/proc/sphere_real.yaml", 1, "shader"),
        "sphere_scenes4": ("configs/shape/proc/sphere.yaml", 4, "shader"),
        "heads": ("configs/shape/proc/sphere_heads.yaml", 1, "predictor"),
        "heads_scenes2": ("configs/shape/proc/sphere_heads.yaml", 2, "predictor")}
FIRST = 25000   # the occlusion phase, where a job spends 280,000 of its steps


def _card_model(path: str, scenes: int):
    from nero_tpu_torch.core.config import load_cfg

    cfg = load_cfg(path)
    if scenes == 1:
        model = NeROShapeModel(cfg, device="cuda")
    else:
        model = MultiSceneShapeModel([{**cfg, "name": f"s{s}"} for s in range(scenes)],
                                     device="cuda")
    return model, torch.optim.Adam(model.parameters(), lr=1e-4, fused=True)


def _steps(model, opt, first: int, n: int) -> list:
    from nero_tpu_torch.ops.mlp import product_mode, resolve_matmul_precision

    with product_mode(resolve_matmul_precision("default", "cuda")):
        return [model.train_step(opt, first + i) for i in range(n)]


def _floats(log) -> list:
    return [v.tolist() for v in tree_leaves(log)]


@pytest.fixture(scope="module", params=sorted(CARD))
def card_pair(request):
    """Three graphed and three eager steps of one configuration from the
    same weights and generator states, with each side's launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the step graph captures CUDA work")
    from nero_tpu_torch.core.mfu import launch_counts

    path, scenes, family = CARD[request.param]
    graphed, opt_g = _card_model(path, scenes)
    eager, opt_e = _card_model(path, scenes)
    eager.step_graph.reason = "compared"    # the eager step, on the card
    with torch.no_grad():
        for a, b in zip(eager.parameters(), graphed.parameters()):
            a.copy_(b)
    for a, b in zip(eager.step_graph.generators, graphed.step_graph.generators):
        a.set_state(b.get_state())
    out = {"family": family}
    for name, model, opt in (("graphed", graphed, opt_g), ("eager", eager, opt_e)):
        before = launch_counts()
        logs = _steps(model, opt, FIRST, 3)
        torch.cuda.synchronize()
        after = launch_counts()
        out[name] = {"model": model, "opt": opt, "logs": logs,
                     "launches": {k: v - before.get(k, 0) for k, v in after.items()
                                  if v != before.get(k, 0)}}
    return out


@pytest.mark.gpu
def test_graphed_steps_equal_eager_steps_on_the_card(card_pair):
    """Losses, Adam's first moment, the parameters and the generators after
    a warm-up, a capture and a replay equal three eager steps to the bit."""
    g, e = card_pair["graphed"], card_pair["eager"]
    assert g["model"].step_graph.counts == {"captures": 1, "replays": 2,
                                            "eager": {"warmup": 1}}
    for i, (a, b) in enumerate(zip(g["logs"], e["logs"])):
        assert _floats(a) == _floats(b), i
    leaves = zip(g["model"].parameters(), e["model"].parameters())
    for i, (a, b) in enumerate(leaves):
        assert torch.equal(a, b), i
        assert torch.equal(g["opt"].state[a]["exp_avg"], e["opt"].state[b]["exp_avg"]), i
    for a, b in zip(g["model"].step_graph.generators, e["model"].step_graph.generators):
        assert torch.equal(a.get_state(), b.get_state())


@pytest.mark.gpu
def test_launch_counters_count_what_the_card_ran(card_pair):
    g, e = card_pair["graphed"], card_pair["eager"]
    assert g["launches"] == e["launches"]
    assert {k.split("_")[0] for k in g["launches"]} >= {"sdf", card_pair["family"]}
    b1 = [v for k, v in g["launches"].items() if k.startswith("sdf_grad_")]
    assert b1 == [3, 3], g["launches"]      # forward and backward, once a step
    if card_pair["family"] == "shader":
        assert all(v == 3 for v in g["launches"].values()), g["launches"]
    else:
        assert all(v % 3 == 0 for v in g["launches"].values()), g["launches"]


@pytest.mark.gpu
def test_a_returned_log_is_left_alone_by_later_steps(card_pair):
    g, e = card_pair["graphed"], card_pair["eager"]
    before = [_floats(log) for log in g["logs"]]
    _steps(g["model"], g["opt"], FIRST + 3, 2)
    assert [_floats(log) for log in g["logs"]] == before == [_floats(log) for log in e["logs"]]


@pytest.mark.gpu
def test_replayed_steps_show_the_port_kernels_in_a_trace(card_pair):
    """B1's and the shader's kernels (B2's, or B8's) by name in a
    torch.profiler trace of replayed steps, each replay inside
    `nero.step.graph`."""
    from torch.profiler import ProfilerActivity, profile

    from nero_tpu_torch.core.trace import port_kernel

    g = card_pair["graphed"]
    replays = g["model"].step_graph.counts["replays"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _steps(g["model"], g["opt"], FIRST + 10, 4)
        torch.cuda.synchronize()
    assert g["model"].step_graph.counts["replays"] > replays
    kernels = {port_kernel(e.name) for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA}
    families = {k[0] for k in kernels if k is not None}
    assert {"sdf_grad", card_pair["family"]} <= families, families
    assert any(e.name == "nero.step.graph" for e in prof.events())
