#!/bin/bash
# Finetuned-student evaluation, on the card (the port's counterpart of the
# JAX package's scripts/run_eval.sh).
set -e
FT_DIR=${FT_DIR:-./model_HLSTM_TeaStud_every10_finetune/}
DATA=${DATA:-"./yt8m/validate*.tfrecord"}
time python -u -m efficientvideoclassification_youtube8m_torch.cli.eval \
  --eval_data_pattern "$DATA" --train_dir "$FT_DIR" \
  --frame_features True --feature_names "rgb, audio" --feature_sizes "1024, 128" \
  --model "HierarchicalLstmModel" --batch_size 256 --num_inputs_to_lstm 20 \
  --lstm_layers 2 --every_n 10 --run_once True
