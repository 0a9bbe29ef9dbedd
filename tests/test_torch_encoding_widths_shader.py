"""The whole-shader kernel (B2) at IDE degrees 1-4 and light PE octaves 4 and
10, default and `sphere_direction` variants: its plain twin, the emulation
of its rounding points and its packed layout against nero_tpu's
`shader_fused_raw` in interpret mode (tests/torch_encoding_shader_common.py;
the `human_light` variants: tests/test_torch_encoding_widths_shader_human.py).
The CUDA kernel is held against the plain version at these widths on the
card by chip_smoke.py."""
import pytest
import torch

from torch_encoding_shader_common import ENCODINGS, check_forward, check_grads

torch.set_num_threads(1)


@pytest.mark.parametrize("variant", ["default", "sphere"])
@pytest.mark.parametrize("deg,lpf", ENCODINGS)
def test_forward_against_pallas(variant, deg, lpf):
    check_forward(variant, deg, lpf)


@pytest.mark.parametrize("variant,deg,lpf", [("default", 1, 10), ("sphere", 3, 4)])
def test_grads_against_pallas(variant, deg, lpf):
    check_grads(variant, deg, lpf)
