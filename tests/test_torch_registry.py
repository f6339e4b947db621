"""The registry's and the API config's helpers against the reference's:
``configs.PAPER_ARCHS``, ``applicable_shapes`` and ``skip_reason`` (the
assignment's shape skips) for every architecture and input shape, and
``api.config.max_feasible_spatial`` over a grid of widths, data degrees
and device counts (with ``tests/test_serve.py``'s four cases)."""
import itertools

import pytest

from repro import configs as jconfigs
from repro.api.config import max_feasible_spatial as jmax_feasible_spatial
from repro_torch import configs
from repro_torch.api.config import max_feasible_spatial


def test_paper_archs_are_the_references():
    assert configs.PAPER_ARCHS == jconfigs.PAPER_ARCHS
    assert set(configs.ALL_ARCHS) == set(jconfigs.ALL_ARCHS)


@pytest.mark.parametrize("arch", configs.ALL_ARCHS)
def test_applicable_shapes_and_skip_reasons_are_the_references(arch):
    assert configs.applicable_shapes(arch) == jconfigs.applicable_shapes(arch)
    for shape in configs.INPUT_SHAPES:
        assert configs.skip_reason(arch, shape) == \
            jconfigs.skip_reason(arch, shape)
        applies = shape in configs.applicable_shapes(arch)
        assert applies == (configs.skip_reason(arch, shape) == "") or \
            arch in configs.PAPER_ARCHS


def test_max_feasible_spatial_is_the_references():
    assert max_feasible_spatial(8, 1, 8) == 2    # local-width floor
    assert max_feasible_spatial(512, 1, 8) == 8  # device-count ceiling
    assert max_feasible_spatial(512, 2, 8) == 4  # data eats devices
    assert max_feasible_spatial(7, 1, 8) == 1    # nothing divides
    for width, data, devices in itertools.product(
            (1, 4, 7, 8, 12, 16, 32, 48, 64, 128, 256, 512),
            (1, 2, 3, 4), (1, 2, 4, 8, 16, 64)):
        assert max_feasible_spatial(width, data, devices) == \
            jmax_feasible_spatial(width, data, devices)
