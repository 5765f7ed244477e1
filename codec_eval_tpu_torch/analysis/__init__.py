"""Analysis studies: comparisons, outliers, heuristics, predictors.

Port of ``codec_eval_tpu/analysis``: the comparison sweep and the
heuristics run on the card unless the caller asks for the CPU; the rest is
host code, the JAX modules' own.
"""

from . import quality_predictor
from .comparison import (
    ComparisonRow,
    OutlierReport,
    RdCompareResult,
    find_outliers,
    rd_compare,
    read_comparison_csv,
    sweep_codecs,
    write_comparison_csv,
)
from .heuristics import FEATURE_NAMES, compute_heuristics, heuristics_batch, heuristics_one
from .predictor import (
    Rule,
    RuleScore,
    WinnerSample,
    default_rules,
    determine_winners,
    evaluate_rules,
    fit_logistic_rule,
)
