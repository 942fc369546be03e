#!/bin/bash
# learning-algorithm grid: loss in {CE, Focal, LDAM} x boost in {RS, RW, DRW}
# (mirrors reference exp/exp_la_vivit.sh)
for loss in CE Focal LDAM; do
  python -m kstar_torch.cli.train_vision --model ViViT --loss_type $loss --use_sampling --save_dir ./results/torch --weight_dir ./weights/torch "$@"
  python -m kstar_torch.cli.train_vision --model ViViT --loss_type $loss --use_weighting --save_dir ./results/torch --weight_dir ./weights/torch "$@"
  python -m kstar_torch.cli.train_vision --model ViViT --loss_type $loss --use_DRW --save_dir ./results/torch --weight_dir ./weights/torch "$@"
done
