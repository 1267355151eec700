from .metrics import corner_errors, alignment_error, success_rates  # noqa: F401
from .synth_eval import synth_trajectory, evaluate_tracker_synthetic  # noqa: F401
