"""Trajectory viewer in a separate process. The port's copy of
vio_msckf_tpu/viewer.py (numpy + matplotlib).

Mirrors the reference viewer's architecture (MSCKF/viewer.py:10-116): the
render loop runs in its own `multiprocessing.Process`, fed through two
mp.Queues with latest-wins draining, so visualization never back-pressures
the filter. The reference renders with pangolin/OpenGL; this viewer renders
with matplotlib (Agg) to a PNG that refreshes in place — the same live 3-D
trajectory and current camera frame, with no display server.
"""

import multiprocessing as mp
import time

import numpy as np


class DynamicArray:
    """Growable (N, 3) buffer (reference viewer.py:120-164)."""

    def __init__(self, shape=3, capacity=1000):
        self._data = np.zeros((capacity, shape), np.float64)
        self._n = 0

    def append(self, x):
        if self._n == len(self._data):
            self._data = np.concatenate([self._data,
                                         np.zeros_like(self._data)])
        self._data[self._n] = x
        self._n += 1

    def array(self):
        return self._data[: self._n]

    def __len__(self):
        return self._n


def _drain(q):
    """Pull everything currently queued (reference drains latest-wins,
    viewer.py:75-86; we keep all poses so the drawn trajectory is complete
    and apply latest-wins to images only)."""
    items = []
    while True:
        try:
            items.append(q.get_nowait())
        except Exception:
            break
    return items


def _viewer_loop(pose_q, img_q, out_png, interval):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    traj = DynamicArray(3)
    img = None
    fig = plt.figure(figsize=(10, 5))
    ax3d = fig.add_subplot(121, projection="3d")
    axim = fig.add_subplot(122)

    last_draw = 0.0
    stop = False
    while not stop:
        for pose in _drain(pose_q):
            if isinstance(pose, str) and pose == "STOP":
                stop = True
                break
            traj.append(np.asarray(pose, np.float64))
        imgs = _drain(img_q)
        if imgs:
            img = imgs[-1]
        if stop:
            break

        now = time.time()
        if now - last_draw >= interval and len(traj):
            last_draw = now
            ax3d.cla()
            t = traj.array()
            ax3d.plot(t[:, 0], t[:, 1], t[:, 2], "b-", lw=1)
            ax3d.scatter(*t[-1], c="r", s=20)
            ax3d.set_title(f"trajectory ({len(traj)} poses)")
            if img is not None:
                axim.cla()
                axim.imshow(img, cmap="gray")
                axim.set_axis_off()
            fig.savefig(out_png, dpi=80)
        time.sleep(0.02)

    if len(traj):
        t = traj.array()
        ax3d.cla()
        ax3d.plot(t[:, 0], t[:, 1], t[:, 2], "b-", lw=1)
        fig.savefig(out_png, dpi=80)
    plt.close(fig)


class Viewer:
    """Process-isolated live viewer.

    viewer = Viewer("live.png"); viewer.update_pose(p); viewer.update_image(img)
    """

    def __init__(self, out_png="vio_live.png", interval=0.5):
        ctx = mp.get_context("spawn")
        self._pose_q = ctx.Queue()
        self._img_q = ctx.Queue()
        self._proc = ctx.Process(
            target=_viewer_loop,
            args=(self._pose_q, self._img_q, out_png, interval),
            daemon=True,
        )
        self._proc.start()

    def update_pose(self, p):
        self._pose_q.put(np.asarray(p, np.float64).tolist())

    def update_image(self, img):
        small = np.asarray(img)[::2, ::2].copy()
        self._img_q.put(small)

    def close(self, timeout=60.0):
        # Generous join: the spawned process may still be importing
        # matplotlib under heavy load, and it writes its final frame on
        # STOP — terminating early would drop it.
        self._pose_q.put("STOP")
        self._proc.join(timeout)
        if self._proc.is_alive():
            self._proc.terminate()
