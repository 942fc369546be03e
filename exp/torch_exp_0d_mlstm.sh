#!/bin/bash
# 0D MLSTM-FCN sweep over prediction distance x seeds
# (mirrors reference exp/exp_0D_mlstm.sh: dist in {1..5,8,12,20}, seeds 40-43)
#
# The per-dist seed grid trains as ONE vmapped ensemble run (--seeds,
# train/ensemble.py): all four seeds advance simultaneously in a single
# compiled program (~3x the serial wall-clock on-chip, PERFORMANCE.md),
# emitting the same per-seed _seed_N checkpoints the reference's four
# processes would.
for dist in 1 2 3 4 5 8 12 20; do
  python -m kstar_torch.cli.train_0d --model MLSTM_FCN --dist $dist \
    --seeds 40 41 42 43 --use_sampling --use_DRW --loss_type Focal --save_dir ./results/torch --weight_dir ./weights/torch "$@"
done
