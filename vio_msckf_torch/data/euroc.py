"""EuRoC MAV dataset reader. The port's copy of vio_msckf_tpu/data/euroc.py
(numpy), on the port's bundling and static initialization.

Covers the reference's data layer (MSCKF/dataset.py:12-221): ground-truth /
IMU CSV parsing, timestamp-sorted stereo PNG listing with the 0.01 s sync
check, and start-time offsetting. Images are decoded on demand through the
native loader (runtime/euroc_loader.cc) where it builds, else with PIL, as
the reference does, else through data/png.py.
"""

import os

import numpy as np


class EuRoCSequence:
    """One EuRoC sequence directory (…/MH_01_easy with mav0/ inside)."""

    def __init__(self, path, start_offset=0.0):
        mav = os.path.join(path, "mav0")
        self.imu = self._read_imu(os.path.join(mav, "imu0", "data.csv"))
        gt_csv = os.path.join(mav, "state_groundtruth_estimate0", "data.csv")
        self.groundtruth = (
            self._read_groundtruth(gt_csv) if os.path.exists(gt_csv) else None
        )
        self.cam0_files, self.cam0_t = self._list_imgs(os.path.join(mav, "cam0", "data"))
        self.cam1_files, self.cam1_t = self._list_imgs(os.path.join(mav, "cam1", "data"))
        if len(self.cam0_files) != len(self.cam1_files):
            raise ValueError("stereo length mismatch")  # dataset.py:164
        # Stereo sync check (dataset.py:174).
        if not np.all(np.abs(self.cam0_t - self.cam1_t) < 0.01):
            raise ValueError("unsynced stereo pair")
        self.starttime = max(self.imu["t"][0], self.cam0_t[0])
        self.set_starttime(start_offset)

    @staticmethod
    def _read_imu(path):
        raw = np.genfromtxt(path, delimiter=",", skip_header=1)
        return dict(t=raw[:, 0] * 1e-9, gyro=raw[:, 1:4], acc=raw[:, 4:7])

    @staticmethod
    def _read_groundtruth(path):
        raw = np.genfromtxt(path, delimiter=",", skip_header=1)
        return dict(
            t=raw[:, 0] * 1e-9,
            p=raw[:, 1:4],
            q_wxyz=raw[:, 4:8],
            v=raw[:, 8:11],
            bw=raw[:, 11:14],
            ba=raw[:, 14:17],
        )

    @staticmethod
    def _list_imgs(d):
        names = sorted(
            (f for f in os.listdir(d) if f.endswith(".png")),
            key=lambda x: float(x[:-4]),
        )  # dataset.py:217-221
        t = np.array([float(f[:-4]) * 1e-9 for f in names])
        return [os.path.join(d, f) for f in names], t

    def set_starttime(self, offset):
        """Start-offset masking (dataset.py:210-215; vio.py:88 uses 40 s)."""
        t0 = self.starttime + offset
        self._imu_from = int(np.searchsorted(self.imu["t"], t0))
        self._cam_from = int(np.searchsorted(self.cam0_t, t0))

    @property
    def frame_times(self):
        return self.cam0_t[self._cam_from:]

    def imu_stream(self):
        i = self._imu_from
        return self.imu["t"][i:], self.imu["gyro"][i:], self.imu["acc"][i:]

    def image_paths(self, first, n, cam=0):
        """Paths of frames first .. first + n - 1 after the start offset."""
        files = self.cam0_files if cam == 0 else self.cam1_files
        return files[self._cam_from + first:self._cam_from + first + n]

    def load_image(self, idx, cam=0):
        return load_png_gray(self.image_paths(idx, 1, cam)[0])

    def __len__(self):
        return len(self.cam0_t) - self._cam_from

    def gt_aligned_positions(self, times):
        """Ground-truth positions interpolated at the given times (for ATE;
        the reference never computes this)."""
        gt = self.groundtruth
        if gt is None:
            return None
        return np.stack(
            [np.interp(times, gt["t"], gt["p"][:, k]) for k in range(3)], axis=1
        )


def load_png_gray(path):
    """Decode one grayscale PNG: the native loader where it builds, else
    PIL, else data/png.py (runtime/native_loader.py:decoder_name)."""
    from vio_msckf_torch.runtime import native_loader

    if native_loader.available():
        return native_loader.load_png_gray(path)
    return native_loader.decode_fallback(path)


def bundle_euroc_frames(seq: EuRoCSequence, config, max_frames=None):
    """Per-frame IMU bundles for an EuRoC sequence (data/bundling.py).

    Returns (frames dict without images, init dict, first, frame_times).
    """
    from vio_msckf_torch.data.bundling import bundle_imu_stream
    from vio_msckf_torch.filter.msckf import initialize_gravity_and_bias

    M = config.filter.imu_per_frame
    imu_t, gyro_s, acc_s = seq.imu_stream()
    if len(imu_t) == 0:
        raise ValueError(
            "no IMU samples after the start offset — the sequence is "
            "shorter than --offset (the reference's 40 s static-start "
            "skip, vio.py:88, assumes a full-length EuRoC run); pass a "
            "smaller --offset"
        )
    n_init = config.filter.init_imu_samples
    q0, bg, gravity = initialize_gravity_and_bias(gyro_s[:n_init], acc_s[:n_init])
    t_ready = imu_t[min(n_init, len(imu_t) - 1)]

    frame_t = seq.frame_times
    first = int(np.searchsorted(frame_t, t_ready))
    frames_t = frame_t[first:]
    if max_frames is not None:
        frames_t = frames_t[:max_frames]

    gyro, acc, dts, valid = bundle_imu_stream(imu_t, gyro_s, acc_s, frames_t, M)

    frames = dict(imu_gyro=gyro, imu_acc=acc, imu_dt=dts, imu_valid=valid)
    init = dict(q0=q0, bg0=bg, gravity=gravity)
    return frames, init, first, frames_t
