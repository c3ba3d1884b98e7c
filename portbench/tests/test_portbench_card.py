"""The benchmark's checks on the card (``-m cuda``; each test skips without
one): the sampler kernel against the reference's Philox stream, and for
every cell, at its own size, the program judged correct and the control
(the reference one precision lower in the program's place) and, for a
training cell, the half-batch fault judged not correct.

    python -m pytest portbench/tests/test_portbench_card.py -m cuda -q
"""

import pytest
import torch

from portbench import calibrate, common
from portbench.drivers.eval import gap_quantiles
from portbench.reference import mlp
from portbench.reference.precision import CONTROL, REFERENCE
from portbench.tests.tiny import CELLS

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sampler kernel has no CPU mode")
    return torch.device("cuda")


def test_b1_follows_the_reference_philox_stream(cuda):
    from dmip_tpu_torch.ops.em_kernel import fused_em_sampler

    g = torch.Generator(device=cuda).manual_seed(11)
    params = common.mlp_weights(g, [27, 512, 512, 512, 3])
    x0, y = torch.randn(4096, 3, generator=g, device=cuda), torch.randn(23, generator=g, device=cuda)
    seed = 2**40 + 12345
    prog = fused_em_sampler(params, x0, y, 200, seed=seed)
    ref = mlp.sample(params, x0, y, 200, seed, REFERENCE)
    ctrl = mlp.sample(params, x0, y, 200, seed, CONTROL)
    assert gap_quantiles(prog, ref)[1] < 0.25 * gap_quantiles(ctrl, ref)[1]


@pytest.mark.parametrize("name", CELLS)
def test_program_passes_and_control_fails_at_the_cells_size(cuda, name):
    rows = dict(calibrate.readings(name, 2**31 + 777, 4.0, control=True))
    limits = common.load_json(f"portbench/limits/{name}.json")
    passes = lambda vals: all(vals[k] <= limits[k] for k in limits)
    assert passes(rows["program"]), rows
    assert not passes(rows["control"]), rows


@pytest.mark.parametrize("name", [c for c in CELLS if c.endswith(".train")])
def test_the_half_batch_fault_fails_at_the_cells_size(cuda, name):
    rows = dict(calibrate.readings(name, 2**31 + 778, 4.0, control=True))
    limits = common.load_json(f"portbench/limits/{name}.json")
    assert not all(rows["half_batch"][k] <= limits[k] for k in limits), rows
