from .alarms import (dwell_tradeoff_from_curves, evaluate_multimodal_alarms,
                     evaluate_video_alarms, multimodal_threshold_sweep,
                     operating_grid_from_curves, score_alarm_rows, score_alarms,
                     sweep_multimodal_prob_curves, sweep_prob_curves,
                     threshold_sweep, threshold_tradeoff_from_curves)
from .evaluate import (evaluate, evaluate_detail, evaluate_probs, evaluation_figure,
                       format_report)
from .feature_importance import compute_permute_feature_importance, plot_feature_importance
