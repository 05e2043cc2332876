"""Image and geometry ops. The three hand-written CUDA kernels sit behind
`fast.fast_nms`, `klt.track_level` and `spd.spd_solve`."""
