#!/bin/bash
# R(2+1)D sweep over prediction distance x seeds (mirrors reference exp/exp_r2plus1d.sh)
for dist in 1 2 3 4 5 8 12 20; do
  for seed in 40 41 42 43; do
    python -m kstar_torch.cli.train_vision --model R2Plus1D --dist $dist \
      --random_seed $seed --use_sampling --use_DRW --loss_type Focal --save_dir ./results/torch --weight_dir ./weights/torch "$@"
  done
done
