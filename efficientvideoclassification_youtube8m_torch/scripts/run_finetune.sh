#!/bin/bash
# Student-only finetuning with per-epoch backups, on the card (the
# reference's run_finetune.sh:7-12; the port's counterpart of the JAX
# package's scripts/run_finetune.sh). FT_DIR's default is where
# run_convert_model.sh writes from run_train.sh's default TRAIN_DIR.
set -e
FT_DIR=${FT_DIR:-./model_HLSTM_TeaStud_every10_finetune/}
DATA=${DATA:-"./yt8m/train*.tfrecord"}
EPOCH=${EPOCH:-1}
time python -u -m efficientvideoclassification_youtube8m_torch.cli.finetune \
  --train_data_pattern "$DATA" --train_dir "$FT_DIR" \
  --frame_features True --feature_names "rgb, audio" --feature_sizes "1024, 128" \
  --model "HierarchicalLstmModel" --batch_size 256 --num_inputs_to_lstm 20 \
  --lstm_layers 2 --num_epochs 1 --every_n 10 \
  &> output_HLSTM_TeaStud_every10_finetune_after_${EPOCH}epc

# a missing file is no failure of the run
mkdir -p "$FT_DIR/backup_epc${EPOCH}/train"
mv "$FT_DIR"/events* "$FT_DIR/backup_epc${EPOCH}/train/" 2>/dev/null || true
cp -r "$FT_DIR"/model.ckpt* "$FT_DIR/backup_epc${EPOCH}/" 2>/dev/null || true
cp "$FT_DIR"/check* "$FT_DIR/backup_epc${EPOCH}/" 2>/dev/null || true
