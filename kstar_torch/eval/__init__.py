from .alarms import (dwell_tradeoff_from_curves, evaluate_video_alarms,
                     operating_grid_from_curves, score_alarm_rows, score_alarms,
                     sweep_prob_curves, threshold_sweep,
                     threshold_tradeoff_from_curves)
from .evaluate import evaluate, evaluate_probs, format_report
from .feature_importance import compute_permute_feature_importance
