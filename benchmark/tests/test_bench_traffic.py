"""The traffic generator: every sequence of a batch moves differently,
and a seed repeats its inputs exactly."""

import numpy as np

from benchmark import spec, traffic as gen
from benchmark.reference import config as ref_config

SEED = 2_147_483_901  # past 31 bits


def _sim(seed, n=3, frames=8):
    cfg = spec.vio_config(ref_config, spec.cell("msckf.offline.b16").config)
    tr = spec.cell("msckf.offline.b16").traffic
    return gen.simulate(cfg, tr, seed, n, frames)


def test_sequences_differ_in_motion():
    tr = spec.cell("msckf.offline.b16").traffic
    us = [gen.motion_factor(SEED, b) for b in range(16)]
    assert len(set(us)) == 16 and all(0.0 <= u < 1.0 for u in us)
    amps = [gen.motion(tr, u)["amp"] for u in us]
    assert len(set(amps)) == 16
    seqs = _sim(SEED, frames=60)      # past the static start and the ramp
    for a in range(3):
        for b in range(a + 1, 3):
            # different trajectories: different ground truth and IMU
            assert np.abs(seqs[a]["gt_p"] - seqs[b]["gt_p"]).max() > 1e-3
            assert not np.array_equal(seqs[a]["imu"]["imu_acc"], seqs[b]["imu"]["imu_acc"])


def test_motion_spans_the_two_ends():
    tr = spec.cell("msckf.offline.b16").traffic
    assert gen.motion(tr, 0.0) == dict(amp=(1.5, 1.0, 0.5), yaw_rate=0.2, wobble_amp=0.1)
    assert gen.motion(tr, 1.0) == dict(amp=(2.5, 1.8, 0.9), yaw_rate=0.6, wobble_amp=0.25)


def test_a_seed_repeats_exactly():
    a, b = _sim(SEED), _sim(SEED)
    for x, y in zip(a, b):
        assert x["u"] == y["u"]
        np.testing.assert_array_equal(x["gt_p"], y["gt_p"])
        for k in gen.IMU_KEYS:
            np.testing.assert_array_equal(x["imu"][k], y["imu"][k])
    c = _sim(SEED + 1)
    assert any(x["u"] != y["u"] for x, y in zip(a, c))


def test_every_seed_gets_the_same_sizes():
    for seed in (0, 1, -5, 2**40 + 3):
        seqs = _sim(seed, n=2, frames=8)
        assert [s["imu"]["imu_dt"].shape for s in seqs] == [(8, 32)] * 2


def test_the_vectorised_trajectory_is_the_simulator_s():
    from benchmark.reference.data.simulator import bundle_frames, simulate_sequence

    cfg = spec.vio_config(ref_config, spec.cell("msckf.offline.b16").config)
    tr = spec.cell("msckf.offline.b16").traffic
    new = gen.simulate(cfg, tr, SEED, 2, 40)
    for b, s in enumerate(new):
        seq = simulate_sequence(cfg, gen.sim_config(cfg, tr, SEED, b, 40))
        fr, init, first = bundle_frames(seq, cfg)
        for k in gen.IMU_KEYS:
            np.testing.assert_array_equal(fr[k][:40], s["imu"][k])
        np.testing.assert_array_equal(seq["gt_p"][first:first + 40], s["gt_p"])
        for k in init:
            np.testing.assert_array_equal(np.asarray(init[k]), np.asarray(s["init"][k]))
