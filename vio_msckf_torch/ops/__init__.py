"""Image and geometry ops. The three hand-written CUDA kernels sit behind
`fast.fast_nms`, `klt.track_pyramid` and `spd.spd_solve`."""
