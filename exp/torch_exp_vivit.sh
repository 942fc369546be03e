#!/bin/bash
# ViViT sweep over prediction distance x seeds
for dist in 1 2 3 4 5 8 12 20; do
  for seed in 40 41 42 43; do
    python -m kstar_torch.cli.train_vision --model ViViT --dist $dist \
      --random_seed $seed --use_sampling --use_DRW --loss_type Focal --save_dir ./results/torch --weight_dir ./weights/torch "$@"
  done
done
