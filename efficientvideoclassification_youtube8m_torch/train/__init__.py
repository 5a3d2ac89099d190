"""Training: the distill and finetune steps and the validate, eval and
int8 eval steps (train.step), TF-semantics optimizers (train.optimizer)
and the training state (train.state)."""
