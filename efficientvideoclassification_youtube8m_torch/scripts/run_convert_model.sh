#!/bin/bash
# Checkpoint surgery, on the card: teacher-student -> standalone student
# in <TRAIN_DIR minus 'train'>finetune/ (the reference's
# train_convert_model.py:398-401; the port's counterpart of the JAX
# package's scripts/run_convert_model.sh). From run_train.sh's default
# TRAIN_DIR (no trailing slash) that is ./model_HLSTM_TeaStud_every10_finetune/,
# the default FT_DIR of run_finetune.sh and run_eval.sh.
set -e
TRAIN_DIR=${TRAIN_DIR:-./model_HLSTM_TeaStud_every10_train}
time python -u -m efficientvideoclassification_youtube8m_torch.cli.convert \
  --train_dir "$TRAIN_DIR" \
  --frame_features True --feature_names "rgb, audio" --feature_sizes "1024, 128" \
  --model "HierarchicalLstmModel" --batch_size 128 --num_inputs_to_lstm 20 \
  --lstm_layers 2 --every_n 10 &> output_HLSTM_TeaStud_every10_convertModel
