"""The frozen peaks and the operation, byte and pair counts on hand-worked
shapes."""

import pytest
import torch

from benchmark.drivers.rollout import _pairs_edges
from benchmark.harness import counts


def test_bound_picks_the_larger_side():
    t, by = counts.bound_s(67e12, 0)
    assert (t, by) == (1.0, "operations")
    t, by = counts.bound_s(0, 3.35e12)
    assert (t, by) == (1.0, "bytes")


def test_b3_counts_by_hand():
    # 10 receivers, k 4, 7 pairs, 5 live edges, ci 2, co 3, D 2
    flops, nbytes = counts.b3_counts(10, 4, 7, 5, 2, 3, 2)
    assert flops == 2 * 2 * 3 * 7 + 16 * 2 * 5
    assert nbytes == 4 * (10 * 2 + 10 * 4 * 5 + 8 * 2 * 3 + 10 * 3)


def test_b3_one_pair_and_one_edge_at_the_published_width():
    f1, _ = counts.b3_counts(1, 1, 1, 0, 128, 128, 6)
    f2, _ = counts.b3_counts(1, 1, 0, 1, 128, 128, 6)
    assert f1 == 2 * 128 * 128 and f2 == 16 * 128


def test_b7_counts_by_hand():
    # 600 rows, block 256 -> 768 padded rows, 2 copies, k 3
    flops, nbytes = counts.b7_counts(600, 3, 256, 2)
    assert flops == 9 * 2 * 768 * 768
    assert nbytes == 2 * ((768 + 512) * 16 + 768 * 3 * 8)


def test_b7_at_1m_k10_is_bound_by_operations():
    t, by = counts.bound_s(*counts.b7_counts(1_000_000, 10, 256, 4))
    assert by == "operations"
    assert t == pytest.approx(9 * 4 * 1_000_192 * 768 / 67e12)


def test_gnn_forward_flops_by_hand():
    cfg = {"input_dim": 4, "gnn_dim": 2, "message_passing_steps": 2}
    n, k = 3, 5
    layer1 = 2 * (2 * n * 4 * 2) + 3 * n * k * 2 + 2 * n * 2 * 2
    layer2 = 2 * (2 * n * 2 * 2) + 3 * n * k * 2 + 2 * n * 2 * 2
    head = 2 * n * (4 + 2) * 3
    assert counts.gnn_forward_flops(n, k, cfg) == layer1 + layer2 + head


def test_contconv_forward_flops_by_hand():
    cfg = {"in_channels": 4, "encoder_hiddens": [2], "continuous_conv_dim": 3,
           "decoder_hiddens": [2], "filter_resolution": [2, 3]}
    n, k = 5, 4
    layers = [(7.0, 6.0), (8.0, 2.0)]
    enc = 2 * n * (4 * 2 + 2 * 3)
    conv = (2 * 3 * 3 * 7 + 16 * 3 * 6) + (2 * 3 * 3 * 8 + 16 * 3 * 2)
    dec = 2 * n * (6 * 2 + 2 * 3)
    assert counts.contconv_forward_flops(n, k, cfg, layers) == enc + conv + dec


def test_pairs_and_edges_on_a_hand_worked_graph():
    cfg = {"radius": 1.0, "filter_resolution": [2], "continuous_conv_layers": 1}
    pos = torch.tensor([[0.0, 0.0, 0.0], [0.5, 0.0, 0.0], [3.0, 0.0, 0.0]])
    idx = torch.tensor([[0, 1], [1, 0], [2, 0]], dtype=torch.int32)
    valid = torch.tensor([[True, True], [True, True], [True, True]])
    (pairs, edges), = _pairs_edges(cfg, pos, idx, valid)
    # live edges: the three self edges and the two edges between bodies 0, 1
    # (body 2 lies 3 away from body 0). At D = 2 every corner of a grid point
    # strictly inside the cube is live: the self edge maps to the centre (8
    # cells); the edge at +-0.5 on x maps off the centre plane on x but keeps
    # all 8 corners too; receivers 0 and 1 touch 8 cells, receiver 2 touches 8.
    assert edges == 5.0
    assert pairs == 24.0
