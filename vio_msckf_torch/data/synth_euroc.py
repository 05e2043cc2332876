"""Write a rendered synthetic sequence in the EuRoC MAV on-disk layout
(mav0/{imu0,cam0,cam1,state_groundtruth_estimate0}, ns timestamps, CSV
headers, per-frame PNGs; reference MSCKF/dataset.py:12-221). The port's
counterpart of vio_msckf_tpu/data/synth_euroc.py: the frames come from the
port's renderer and are written by the port's PNG encoder (data/png.py),
so no imaging library is needed.

It lets the whole `--path` flow (directory scan, CSV parse, stereo sync
check, PNG decode ring, chunked feed to the device) run end to end where
no real EuRoC data is at hand.
"""

import os

import numpy as np

from vio_msckf_torch.config import VIOConfig
from vio_msckf_torch.data.png import write_png_gray
from vio_msckf_torch.data.render import render_sequence
from vio_msckf_torch.data.simulator import SimConfig, simulate_sequence

EPOCH_NS = 1403636579763555584  # arbitrary EuRoC-era epoch


def write_synthetic_euroc(root, cfg: VIOConfig, sim: SimConfig, render_seed=7, augs=None,
                          device="cuda"):
    """Write the sequence under `root` (creates root/mav0/...), rendering on
    `device`. Returns the number of frames written."""
    seq = simulate_sequence(cfg, sim)
    mav = os.path.join(root, "mav0")
    os.makedirs(os.path.join(mav, "imu0"), exist_ok=True)
    os.makedirs(os.path.join(mav, "cam0", "data"), exist_ok=True)
    os.makedirs(os.path.join(mav, "cam1", "data"), exist_ok=True)
    os.makedirs(os.path.join(mav, "state_groundtruth_estimate0"), exist_ok=True)

    # imu0/data.csv (ns timestamps, gyro then acc — dataset.py:55-76)
    imu_ns = (seq["imu_t"] * 1e9).astype(np.int64) + EPOCH_NS
    with open(os.path.join(mav, "imu0", "data.csv"), "w") as f:
        f.write("#timestamp [ns],w_RS_S_x,w_RS_S_y,w_RS_S_z,"
                "a_RS_S_x,a_RS_S_y,a_RS_S_z\n")
        for i in range(len(imu_ns)):
            g = seq["imu_gyro"][i]
            a = seq["imu_acc"][i]
            f.write(f"{imu_ns[i]},{g[0]},{g[1]},{g[2]},"
                    f"{a[0]},{a[1]},{a[2]}\n")

    # groundtruth CSV (p, q_wxyz, v, bw, ba — dataset.py:12-47)
    gt_ns = (seq["frame_t"] * 1e9).astype(np.int64) + EPOCH_NS
    gt_path = os.path.join(mav, "state_groundtruth_estimate0", "data.csv")
    with open(gt_path, "w") as f:
        f.write("#timestamp,p_x,p_y,p_z,q_w,q_x,q_y,q_z,"
                "v_x,v_y,v_z,bw_x,bw_y,bw_z,ba_x,ba_y,ba_z\n")
        for i in range(len(gt_ns)):
            p = seq["gt_p"][i]
            f.write(f"{gt_ns[i]},{p[0]},{p[1]},{p[2]},1,0,0,0,"
                    "0,0,0,0,0,0,0,0,0\n")

    # Rendered stereo PNGs, clipped and cast to uint8 as the reference's
    # writer does.
    R_stack = seq["gt_R_i_w"].transpose(0, 2, 1)
    cam0, cam1 = render_sequence(cfg, R_stack, seq["gt_p"], radius=14.0, seed=render_seed,
                                 augs=augs, device=device)
    cam0 = np.clip(cam0.cpu().numpy(), 0, 255).astype(np.uint8)
    cam1 = np.clip(cam1.cpu().numpy(), 0, 255).astype(np.uint8)
    for i in range(len(gt_ns)):
        write_png_gray(os.path.join(mav, "cam0", "data", f"{gt_ns[i]}.png"), cam0[i])
        write_png_gray(os.path.join(mav, "cam1", "data", f"{gt_ns[i]}.png"), cam1[i])
    return len(gt_ns)
