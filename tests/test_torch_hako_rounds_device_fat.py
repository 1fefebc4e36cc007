"""The card's round schedule (test_torch_hako_rounds_device.py's
rounds_device_plain: one list of lanes a round, the survivors in a
permuted order) on a fat tree (supernode rows, T = 1: the layout a 1024^3
scene takes), forced at 512^3 by setting USE_SNODES_ABOVE to 128 in both
packages: against the JAX package's interpret-mode intersect_hako,
primary and shadow rays, with that file's bars, and against the port's
plain driver bit for bit with its rounds and unresolved lanes, at the
default caps, with one probe and one sub-brick visit a round, and cut at
3 rounds. Its own file: the fat interpret-mode reference is the
slowest."""

import pytest
import torch

from test_torch_hako_rounds_device import CAPS, check_against_jax, check_against_plain_driver

torch.set_num_threads(1)


@pytest.mark.parametrize("shadow", [False, True])
def test_fat_device_schedule_matches_jax(shadow):
    check_against_jax("fat512", shadow)


@pytest.mark.parametrize("caps", list(CAPS))
@pytest.mark.parametrize("shadow", [False, True])
def test_fat_device_schedule_equals_plain_driver(shadow, caps):
    check_against_plain_driver("fat512", shadow, caps)
