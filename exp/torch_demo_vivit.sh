#!/bin/bash
# exp/demo_vivit.sh through the PyTorch/CUDA port: the same argument list
# (kstar_torch/analysis/demos.py VIVIT), written into results/torch and
# weights/torch so that the JAX demo's artifacts of the same tag stay as
# they are. Extra flags override, e.g. --num_epoch 2 or --device cpu.
set -e
cd "$(dirname "$0")/.."

python -m kstar_torch.analysis.demos vivit "$@"
