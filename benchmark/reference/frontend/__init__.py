from benchmark.reference.frontend.tracker import StereoTracker, TrackerState

__all__ = ["StereoTracker", "TrackerState"]
