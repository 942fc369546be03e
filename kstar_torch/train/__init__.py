"""The port's training core (``kstar_tpu/train``): state and optax-exact
optimizers, the guarded train step (single-stream and multimodal), the
epoch loops (``fit``), seed ensembles (``ensemble``), Gradient Blending
(``gb``), CCA pre-training (``cca``), mixup and video CutMix (``mixup``),
ASHA/TPE search (``hpo``, ``tpe``; ``hpo_vmap`` keeps JAX's grouping names),
metrics, early stopping and metric logging."""

from .early_stopping import EarlyStopping
from .logging import MetricWriter
from .loop import (History, fit, make_eval_step, make_scan_steps,
                   make_train_step, run_eval_epoch, run_train_epoch)
from .metrics import (accuracy, classification_report, confusion_matrix,
                      macro_f1, precision_recall_curve, roc_auc, roc_curve,
                      softmax_np, threshold_predict)
from .state import (Optimizer, TrainState, create_train_state, load_checkpoint,
                    load_params, make_optimizer, save_checkpoint)
from . import cca, gb, hpo, mixup
from .gb import fit_gb, gb_estimate
from .ensemble import (create_ensemble_state, fit_ensemble,
                       make_ensemble_eval, make_ensemble_step,
                       unstack_ensemble)
