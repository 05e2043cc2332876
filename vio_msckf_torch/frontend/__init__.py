from vio_msckf_torch.frontend.tracker import StereoTracker, TrackerState

__all__ = ["StereoTracker", "TrackerState"]
