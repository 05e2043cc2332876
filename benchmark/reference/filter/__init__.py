from benchmark.reference.filter.state import (
    FilterState,
    FeatureMap,
    MsckfParams,
    init_filter_state,
    init_feature_map,
    make_params,
)
from benchmark.reference.filter.msckf import MSCKF, FilterOutput

__all__ = [
    "FilterState",
    "FeatureMap",
    "MsckfParams",
    "init_filter_state",
    "init_feature_map",
    "make_params",
    "MSCKF",
    "FilterOutput",
]
