#!/bin/bash
# exp/demo_multimodal.sh through the PyTorch/CUDA port: the same argument
# list (kstar_torch/analysis/demos.py MULTIMODAL), written into
# results/torch and weights/torch so that the JAX demo's artifacts of the
# same tags stay as they are. The variants take the flags of
# exp/demo_multimodal.sh's header, as there:
#   --pair_mode aligned --tag demo_multimodal_aligned
#   --pair_mode aligned --train_with_normal --synthetic_normal 12 \
#     --tag demo_multimodal_aligned_normal
# (or by name: python -m kstar_torch.analysis.demos multimodal_aligned).
set -e
cd "$(dirname "$0")/.."

python -m kstar_torch.analysis.demos multimodal "$@"
