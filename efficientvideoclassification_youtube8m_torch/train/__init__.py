"""Train/eval steps. Only the forward half (train.step) is ported so far."""
