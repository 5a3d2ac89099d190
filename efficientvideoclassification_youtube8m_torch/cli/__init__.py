"""Entry-point binaries of the reference's five-binary pipeline (port of
the JAX package's cli/):

  train     -> train.py               (teacher+student distillation)
  validate  -> validate.py            (student eval with teacher present)
  convert   -> train_convert_model.py (checkpoint surgery)
  finetune  -> train_finetune.py      (student-only training)
  eval      -> eval_finetune.py       (student-only eval; --quantize int8)

and the tools around them:

  infer               -> Kaggle-CSV inference (bf16 or --quantize int8)
  inference_bias      -> inference_bias.py (a rescaled bias tensor)
  max_ensemble        -> max_ensemble.py (per-label max of CSVs)
  train_ensemble      -> an ensemble head trained over K CSVs
  inference_ensemble  -> inference_ensemble.py (a learned head over K CSVs)
  inspect_checkpoint  -> inspect_checkpoint_myfile.py
  hash_check          -> hash_check_redownload.py (shard md5s)
  export_tf           -> a checkpoint as a reference TF-V2 bundle

Run as `python -m efficientvideoclassification_youtube8m_torch.cli.<name>`
with the JAX package's flags; `--device cpu` runs on the CPU, the default
`/gpu:0` on the first CUDA device. Under `torch.distributed` (TF_CONFIG
or MASTER_ADDR/MASTER_PORT/RANK/WORLD_SIZE in the environment) train,
finetune, validate and eval run one process per device, data-parallel
(parallel/).
"""
