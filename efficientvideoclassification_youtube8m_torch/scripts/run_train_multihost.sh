#!/bin/bash
# Multi-host distillation training on cards: one invocation of this script
# per host, which starts one training process for each of the host's cards
# (the port's counterpart of the JAX package's scripts/run_train_multihost.sh,
# whose one process a host drives all of its chips).
#
#   # fresh model (explicitly):
#   START_NEW_MODEL=True NUM_HOSTS=2 HOST_INDEX=0 COORDINATOR=10.0.0.1:7077 ./run_train_multihost.sh
#   START_NEW_MODEL=True NUM_HOSTS=2 HOST_INDEX=1 COORDINATOR=10.0.0.1:7077 ./run_train_multihost.sh
#   # relaunch-and-resume (the fault-tolerance flow) is the DEFAULT:
#   NUM_HOSTS=2 HOST_INDEX=0 COORDINATOR=10.0.0.1:7077 ./run_train_multihost.sh
#
# Semantics (handled inside the binaries: cli/train.py, parallel/distributed.py):
#   * NPROC_PER_HOST processes a host, by default torch.cuda.device_count();
#     each runs on the card its LOCAL_RANK names;
#   * the cluster spec rides in TF_CONFIG, in the shape the reference's
#     dispatcher consumed (train.py:704-733): the master at COORDINATOR,
#     then one worker at COORDINATOR's port + i for every other process of
#     the cluster (NUM_HOSTS x NPROC_PER_HOST entries in all), so
#     parse_tf_config gives every process its own rank and all of them
#     one coordinator;
#   * --batch_size is the GLOBAL batch and must divide by the number of
#     processes; each process loads its slice from its own disjoint set of
#     input shards (there must be at least as many input files as processes);
#   * gradients reduce over NCCL; rank 0 (the "master" job) owns summaries
#     and checkpoints;
#   * TRAIN_DIR must be shared storage (NFS or the like) so eval jobs and
#     resume see one checkpoint stream.
#
# The script waits for every process and exits with the first failure's
# status. A failure stops the host's other processes: their collectives
# would otherwise wait for the lost peer until their timeout.
set -e
NUM_HOSTS=${NUM_HOSTS:-2}
HOST_INDEX=${HOST_INDEX:-0}
COORDINATOR=${COORDINATOR:-127.0.0.1:7077}
if [[ "$COORDINATOR" != *:* ]]; then
  echo "COORDINATOR must be host:port (got '$COORDINATOR')" >&2
  exit 1
fi
NPROC_PER_HOST=${NPROC_PER_HOST:-$(python -c "import torch; print(torch.cuda.device_count())")}
if ! [[ "$NPROC_PER_HOST" =~ ^[0-9]+$ ]] || [ "$NPROC_PER_HOST" -lt 1 ]; then
  echo "no CUDA device on this host (NPROC_PER_HOST '$NPROC_PER_HOST')" >&2
  exit 1
fi
TRAIN_DIR=${TRAIN_DIR:-./model_HLSTM_TeaStud_every10_train}
DATA=${DATA:-"./yt8m/train*.tfrecord"}
mkdir -p "$TRAIN_DIR"

# reference cluster-spec shape: one master + workers, master first
NUM_PROCESSES=$((NUM_HOSTS * NPROC_PER_HOST))
WORKERS=""
for ((i = 1; i < NUM_PROCESSES; i++)); do
  WORKERS+="\"${COORDINATOR%:*}:$((${COORDINATOR##*:} + i))\""
  [ "$i" -lt $((NUM_PROCESSES - 1)) ] && WORKERS+=", "
done

launch() {
  local pids=() status=0 rank task r
  for ((r = 0; r < NPROC_PER_HOST; r++)); do
    rank=$((HOST_INDEX * NPROC_PER_HOST + r))
    if [ "$rank" -eq 0 ]; then
      task='{"type": "master", "index": 0}'
    else
      task="{\"type\": \"worker\", \"index\": $((rank - 1))}"
    fi
    TF_CONFIG="{\"cluster\": {\"master\": [\"$COORDINATOR\"], \"worker\": [$WORKERS]}, \"task\": $task}" \
    LOCAL_RANK=$r python -u -m efficientvideoclassification_youtube8m_torch.cli.train \
      --train_data_pattern "$DATA" --train_dir "$TRAIN_DIR" \
      --frame_features True --feature_names "rgb, audio" --feature_sizes "1024, 128" \
      --model "HierarchicalLstmModel" --batch_size ${BATCH_SIZE:-512} \
      --num_inputs_to_lstm 20 --lstm_layers 2 \
      --start_new_model ${START_NEW_MODEL:-False} --num_epochs ${EPOCH:-1} \
      --every_n 10 --base_learning_rate 0.001 \
      --checkpoint_format ${CHECKPOINT_FORMAT:-orbax} &
    pids+=($!)
  done
  for r in "${pids[@]}"; do
    wait -n || {
      local failed=$?
      if [ "$status" -eq 0 ]; then
        status=$failed
        kill "${pids[@]}" 2>/dev/null || true
      fi
    }
  done
  return "$status"
}

time launch
