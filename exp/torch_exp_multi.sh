#!/bin/bash
# multimodal configs: seq_len 84 tau 1 / seq_len 21 tau 4 (mirrors reference exp/exp_multi.sh)
python -m kstar_torch.cli.train_multimodal --model_type concat --use_GB --seq_len 84 --tau 1 --save_dir ./results/torch --weight_dir ./weights/torch "$@"
python -m kstar_torch.cli.train_multimodal --model_type concat --use_GB --seq_len 21 --tau 4 --save_dir ./results/torch --weight_dir ./weights/torch "$@"
python -m kstar_torch.cli.train_multimodal --model_type TFN --use_GB --seq_len 21 --tau 4 --save_dir ./results/torch --weight_dir ./weights/torch "$@"
