#!/bin/bash
# learning-algorithm grid for 0D models (mirrors reference exp/exp_la_*.sh)
for model in Transformer CnnLSTM MLSTM_FCN; do
  for loss in CE Focal LDAM; do
    python -m kstar_torch.cli.train_0d --model $model --loss_type $loss --use_sampling --save_dir ./results/torch --weight_dir ./weights/torch "$@"
    python -m kstar_torch.cli.train_0d --model $model --loss_type $loss --use_DRW --save_dir ./results/torch --weight_dir ./weights/torch "$@"
  done
done
