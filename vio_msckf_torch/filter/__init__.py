from vio_msckf_torch.filter.state import (
    FilterState,
    FeatureMap,
    MsckfParams,
    init_filter_state,
    init_feature_map,
    make_params,
)
from vio_msckf_torch.filter.msckf import MSCKF, FilterOutput

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
