"""Operation counts from widths, each against a count by hand."""

import pytest

from portbench import flops

LINEAR = dict(xdim=2, ydim=2, hidden=[512, 512, 512])
SCAT = dict(xdim=3, ydim=23, hidden=[512, 512, 512])


def test_b1_sample_step_by_hand_and_against_the_kernel_table():
    # layer 0 over [x, t]: 3 x 512; two hidden 512 x 512; output 512 x 2
    by_hand = 2 * (3 * 512 + 2 * 512 * 512 + 512 * 2)
    assert by_hand == 1_053_696
    assert flops.sampler_sample_step(2, [512] * 3) == by_hand
    assert abs(by_hand / 1.055e6 - 1) < 2e-3  # the kernel table's 1.055 MFLOP at 5 -> 512^3 -> 2
    # its bf16 bound for a 30k x 200 posterior, 6.39 ms
    assert abs(30_000 * 200 * by_hand / flops.PEAKS["bf16"] * 1e3 - 6.39) < 0.01


def test_b1_launch_adds_the_condition_fold_once():
    step = 2 * (4 * 512 + 2 * 512 * 512 + 512 * 3)
    assert flops.sampler_launch(3, 23, [512] * 3, 30_000, 200) == 30_000 * 200 * step + 2 * 23 * 512


def test_linear_condition_by_hand():
    f = 2 * 30_000 * (5 * 512 + 2 * 512 * 512 + 512 * 2)  # the score-MSE's pass over the analytic samples
    b1 = 30_000 * 200 * 1_053_696 + 2 * 2 * 512
    assert flops.linear_condition(2, 2, [512] * 3, 30_000, 200, 10) == 10 * (b1 + f)
    assert abs(flops.linear_condition(2, 2, [512] * 3, 30_000, 200, 10) / 6.35e13 - 1) < 0.01


@pytest.mark.parametrize("xdim,passes", [(2, 18), (3, 20)])
def test_pinn_step_passes(xdim, passes):
    # IC 3, DSM 3, ds/dt 2 + 4, grad_z h (1 + d) forward + (1 + d) backward
    assert flops.pinn_passes(xdim) == 3 + 3 + 6 + 2 * (1 + xdim) == passes


def test_pinn_step_by_hand():
    f = 2 * 1000 * (27 * 512 + 2 * 512 * 512 + 512 * 3)
    assert flops.pinn_step(3, 23, [512] * 3, 1000) == 20 * f == 21_585_920_000
