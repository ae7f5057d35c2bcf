"""The port's hand-written CUDA kernels (B1 force, B2 energy) against their
plain-torch twins on the card. A CUDA kernel has no CPU mode, so without a
CUDA device every test here skips. On the card (which has no JAX, hence no
conftest):

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

Bars as on the CPU side: forces atol 2e-5 on max-scaled accelerations,
potential energy relative 1e-5."""

import numpy as np
import pytest
import torch

from nbody_tpu_torch.core import SimulationConfig, simulate
from nbody_tpu_torch.ics import generate_spiral
from nbody_tpu_torch.models import GraphModel
from nbody_tpu_torch.ops import pairwise as pw
from nbody_tpu_torch.train import autoregressive_rollout

pytestmark = pytest.mark.gpu

G, EPS = 4.5e-6, 0.05


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _spiral(n, seed, dev):
    return generate_spiral(torch.Generator().manual_seed(seed), n, device=dev)


@pytest.mark.parametrize("n", [1, 31, 257, 1000])
def test_b1_kernel_matches_twin(cuda, n):
    pos, _, mass = _spiral(n, n, cuda)
    before = pw.partial_accelerations.launches
    got = pw.partial_accelerations(pos, pos, mass, G, EPS)
    assert pw.partial_accelerations.launches == before + 1
    want = pw.partial_accelerations_torch(pos, pos, mass, G, EPS)
    scale = float(want.abs().max()) + 1e-30
    assert float((got - want).abs().max()) / scale <= 2e-5


def test_b1_rectangular_mask_and_zero_softening(cuda):
    pos, _, mass = _spiral(700, 2, cuda)
    tgt = pos[100:190].contiguous()
    got = pw.partial_accelerations(tgt, pos, mass, G, 0.0)
    want = pw.partial_accelerations_torch(tgt, pos, mass, G, 0.0)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) / float(want.abs().max()) <= 2e-5
    mask = torch.arange(700, device=cuda) < 650
    acc = pw.accelerations(pos, mass, G, EPS, mask=mask)
    assert torch.all(acc[650:] == 0)
    ref = pw.partial_accelerations_torch(pos[:650], pos[:650], mass[:650], G, EPS)
    assert float((acc[:650] - ref).abs().max()) / float(ref.abs().max()) <= 2e-5


@pytest.mark.parametrize("n", [2, 255, 256, 1000])
def test_b2_kernel_matches_twin(cuda, n):
    pos, _, mass = _spiral(n, n, cuda)
    got = pw.potential_energy(pos, mass, G, EPS)
    want = pw.pair_potential_torch(pos, mass, pos, mass, G, EPS, masked=True)
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    mask = torch.arange(n, device=cuda) < max(n - 7, 1)
    got_m = pw.potential_energy(pos, mass, G, EPS, mask=mask)
    m = mass * mask
    want_m = pw.pair_potential_torch(pos, m, pos, m, G, EPS, masked=True)
    assert abs(float(got_m) - float(want_m)) <= 1e-5 * abs(float(want_m)) + 1e-30


def test_b2_cross_and_chunked(cuda):
    pos, _, mass = _spiral(1500, 5, cuda)
    a, b = pos[:600].contiguous(), pos[600:].contiguous()
    got = pw.cross_potential(a, mass[:600], b, mass[600:], G, EPS)
    want = pw.pair_potential_torch(a, mass[:600], b, mass[600:], G, EPS, masked=False)
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    full = float(pw.potential_energy(pos, mass, G, EPS))
    chunked = pw.chunked_potential_energy(pos, mass, G, EPS, chunk=400)
    assert abs(chunked - full) <= 1e-5 * abs(full)


def test_b2_is_deterministic(cuda):
    pos, _, mass = _spiral(3000, 6, cuda)
    us = {float(pw.potential_energy(pos, mass, G, EPS)) for _ in range(5)}
    assert len(us) == 1


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    pos, _, mass = _spiral(64, 7, cuda)
    with pytest.raises(TypeError):
        pw.partial_accelerations(pos.double(), pos.double(), mass.double(), G, EPS)
    with pytest.raises(ValueError):
        pw.partial_accelerations(pos.t().contiguous().t(), pos, mass, G, EPS)
    with pytest.raises(ValueError):
        pw.partial_accelerations(pos, pos.cpu(), mass, G, EPS)
    with pytest.raises(ValueError):
        pw.pair_potential(pos[:10].contiguous(), mass[:10], pos, mass, G, EPS, masked=True)


def test_simulate_kernel_backend_matches_dense_on_card(cuda):
    pos, vel, mass = _spiral(300, 8, cuda)
    cfg = dict(g_const=1e-3, softening=EPS, dt=1e-3, calc_energy=True)
    tk = simulate(pos, vel, mass, 50, SimulationConfig(**cfg, force_backend="auto"))
    td = simulate(pos, vel, mass, 50, SimulationConfig(**cfg, force_backend="dense"))
    torch.testing.assert_close(tk.positions, td.positions, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(tk.u_energy, td.u_energy, rtol=1e-5, atol=0)


def test_surrogate_rollout_on_card_matches_cpu(cuda):
    pos, vel, mass = _spiral(200, 9, torch.device("cpu"))
    model = GraphModel(input_dim=4, gnn_dim=64, message_passing_steps=2, aggr="mean",
                       neighbors=10, generator=torch.Generator().manual_seed(0)).eval()
    want = autoregressive_rollout(model, pos, vel, mass, 10, 1e-4)
    got = autoregressive_rollout(model.to(cuda), pos.to(cuda), vel.to(cuda),
                                 mass.to(cuda), 10, 1e-4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=1e-4, atol=1e-5)
