"""Training: the distill and finetune steps (train.step), TF-semantics
optimizers (train.optimizer) and the training state (train.state). The
validate and eval steps are not ported yet."""
