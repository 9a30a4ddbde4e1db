"""The traffic generator and the seeded weights: the same seed gives the
same inputs, another seed other inputs, and every seed the same sizes."""

import itertools

import numpy as np
import torch

from benchmark.lib import traffic, weights
from benchmark.tests._tiny import CPU, frame_cell, train_cell

BIG = 2 ** 31 + 12345


def test_frames_repeat_by_seed():
    t = frame_cell().traffic
    a, b = traffic.make_frames(t, BIG, CPU), traffic.make_frames(t, BIG, CPU)
    c = traffic.make_frames(t, BIG + 1, CPU)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    assert [f.shape for f in a] == [(48, 40, 3), (48, 40, 3), (20, 20, 3)]
    assert not np.array_equal(a[0], a[1])


def test_batches_repeat_by_seed_and_rows_differ():
    t = train_cell().traffic
    a, b = traffic.make_batches(t, 32, 7, CPU), traffic.make_batches(t, 32,
                                                                     7, CPU)
    c = traffic.make_batches(t, 32, 8, CPU)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    rows = torch.cat(a).flatten(1)
    assert len({tuple(r.tolist()) for r in rows}) == rows.shape[0]


def test_every_seed_sends_the_same_sizes():
    t = traffic.load("frames_mixed")
    cycle = traffic.frame_cycle(t)
    assert len(cycle) == 20
    for seed in (0, 1, BIG):
        order = list(itertools.islice(traffic.frame_order(t, seed), 40))
        for k in range(2):
            part = order[20 * k:20 * (k + 1)]
            assert sorted(part) == list(range(20))
    one = list(itertools.islice(traffic.frame_order(t, 3), 20))
    two = list(itertools.islice(traffic.frame_order(t, 4), 20))
    assert one != two


def test_mixed_sizes_follow_the_issue_shares():
    t = traffic.load("frames_mixed")
    counts = {(s["w"], s["h"]): s["per_cycle"] for s in t["sizes"]}
    assert counts == {(256, 256): 6, (640, 360): 6, (854, 480): 5,
                      (1280, 720): 3}


def test_weights_repeat_by_seed_and_follow_the_default_init():
    cfg = frame_cell().config
    a = weights.generator_weights(cfg, BIG, CPU)
    b = weights.generator_weights(cfg, BIG, CPU)
    c = weights.generator_weights(cfg, 1, CPU)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv_first.weight"], c["conv_first.weight"])
    w = a["body.0.rdb1.conv5.weight"]           # fan_in 9 * (16 + 4 * 8)
    bound = 1.0 / (9 * 48) ** 0.5
    assert float(w.abs().max()) <= bound and float(w.abs().max()) > 0.9 * bound
