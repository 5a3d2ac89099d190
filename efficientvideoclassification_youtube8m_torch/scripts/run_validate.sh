#!/bin/bash
# Student validation against the teacher-student train dir, on the card
# (the port's counterpart of the JAX package's scripts/run_validate.sh).
# TRAIN_DIR's default is run_train.sh's.
set -e
TRAIN_DIR=${TRAIN_DIR:-./model_HLSTM_TeaStud_every10_train}
DATA=${DATA:-"./yt8m/validate*.tfrecord"}
time python -u -m efficientvideoclassification_youtube8m_torch.cli.validate \
  --eval_data_pattern "$DATA" --train_dir "$TRAIN_DIR" \
  --frame_features True --feature_names "rgb, audio" --feature_sizes "1024, 128" \
  --model "HierarchicalLstmModel" --batch_size 256 --num_inputs_to_lstm 20 \
  --lstm_layers 2 --every_n 10 --run_once True
