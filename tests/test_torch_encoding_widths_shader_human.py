"""The whole-shader kernel (B2) at IDE degrees 1-4 and light PE octaves 4 and
10 in its `human_light` variants (with and without `sphere_direction`):
tests/test_torch_encoding_widths_shader.py's checks."""
import pytest
import torch

from torch_encoding_shader_common import ENCODINGS, check_forward, check_grads

torch.set_num_threads(1)


@pytest.mark.parametrize("variant", ["human", "both"])
@pytest.mark.parametrize("deg,lpf", ENCODINGS)
def test_forward_against_pallas(variant, deg, lpf):
    check_forward(variant, deg, lpf)


@pytest.mark.parametrize("variant,deg,lpf", [("human", 2, 4), ("both", 4, 10)])
def test_grads_against_pallas(variant, deg, lpf):
    check_grads(variant, deg, lpf)
