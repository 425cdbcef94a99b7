"""The analysis suite (counterpart of libdogleg_tpu/analysis): outlierness
factors, outlier marking, query-point confidence and gradient checks."""

from libdogleg_tpu_torch.analysis.gradients import (check_gradients,
                                                    check_gradients_autodiff,
                                                    check_gradients_products,
                                                    format_gradient_table)
from libdogleg_tpu_torch.analysis.outlierness import (
    get_outlierness_factors,
    get_outlierness_factors_ba,
    get_outlierness_scale,
    mark_outliers,
    outlierness_trace_new_feature,
    outlierness_trace_new_features_windowed,
    pseudoinverse_rows,
    report_outliers,
)

__all__ = [
    "check_gradients",
    "check_gradients_autodiff",
    "check_gradients_products",
    "format_gradient_table",
    "get_outlierness_factors",
    "get_outlierness_factors_ba",
    "get_outlierness_scale",
    "mark_outliers",
    "outlierness_trace_new_feature",
    "outlierness_trace_new_features_windowed",
    "pseudoinverse_rows",
    "report_outliers",
]
