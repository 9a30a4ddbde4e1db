"""The plain reference against the port's plain CPU path at a tiny
width, in float32: the generator, the tiled uint8 upscale and the GAN
training step."""

import numpy as np
import torch

from benchmark.lib import program, traffic, weights
from benchmark.drivers.gan_train import Driver as Training
from benchmark.reference import rrdbnet
from benchmark.tests._tiny import CPU, frame_cell, train_cell


def test_generator_matches_the_port():
    from super_resolution_tpu_torch.models.rrdb import RRDBNet

    cfg = dict(frame_cell().config, n_blocks=2)
    w = weights.generator_weights(cfg, 3, CPU)
    model = RRDBNet(program.generator_config(cfg))
    model.load_state_dict(w, strict=True)
    model.prepare(torch.float32)
    x = torch.randn(2, 12, 10, 3, generator=torch.Generator().manual_seed(0))
    want = model(x)
    got = rrdbnet.generator(w, cfg, x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert want.shape == got.shape == (2, 48, 40, 3)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_tiled_upscale_matches_the_port():
    cell = frame_cell()
    cfg, t = cell.config, cell.traffic
    w = weights.generator_weights(cfg, 4, CPU)
    up = program.Upscaler(cfg, t, w, CPU)
    for frame in traffic.make_frames(t, 4, CPU):
        want = up(frame)
        got = rrdbnet.upscale_frame(w, cfg, torch.from_numpy(frame),
                                    t["tile"], t["halo"]).numpy()
        assert got.shape == want.shape
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_gan_step_matches_the_port():
    cell = train_cell()
    drv = Training(cell.config, cell.traffic, 11, CPU)
    drv.free_program()
    numbers = drv.check()
    assert numbers["loss_gap"] < 1e-5
    assert numbers["grad_gap"] < 1e-5
    assert numbers["change_gap"] < 1e-3


def test_gan_step_leaves_out_round_off_leaves_only():
    """D's conv biases ahead of BatchNorm and its head bias get a
    gradient of round-off; every other leaf moves."""
    cell = train_cell()
    drv = Training(cell.config, cell.traffic, 12, CPU)
    drv.free_program()
    ref = drv._reference()
    norms = {k: float(g.norm()) for k, g in ref.first_grads.items()}
    from benchmark.lib.compare import group_medians

    med = group_medians(norms)
    still = sorted(k for k, v in norms.items()
                   if v < 1e-3 * med[k.split(".")[0]])
    convs = [f"d.conv{i}_{j}.bias" for i in range(4) for j in range(2)
             if (i, j) != (0, 0)]
    assert still == sorted(convs + ["d.head.bias"])


def test_config_mismatch_is_refused():
    cell = train_cell()
    cfg = dict(cell.config, training=dict(cell.config["training"],
                                          lambda_adv=0.1))
    try:
        Training(cfg, cell.traffic, 1, CPU)
    except ValueError as e:
        assert "lambda_adv" in str(e)
    else:
        raise AssertionError("a preset that departs from the "
                             "configuration must be refused")

