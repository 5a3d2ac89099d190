"""The plain reference of the training steps: the paper's three
distillation losses with the teacher's own, and TF-Adam with slim's
per-variable gradient clipping, as the reference's train.py and
train_finetune.py define them. Plain PyTorch; it imports nothing of the
program.

* Label loss: binary cross-entropy with epsilon 1e-5, summed over
  classes, mean over the batch; the teacher adds its l2 term.
* L_REP: mean over the batch of ||teacher state - student state||^2;
  L_PRED: the batch's SUM of KL(teacher || student) over the predictions
  renormalized per row (1e-20 guards); the student's loss is
  2 L_REP + L_PRED + its label loss + its l2 term (the reference adds
  L_REP twice, train.py:406). The teacher gets no gradient from the
  student's terms.
* Each gradient tensor is clipped to norm 1 by its own norm, then
  TF-Adam (beta 0.9, 0.999, epsilon 1e-8 outside the bias correction)
  at the learning rate 0.001 x 0.95^floor(step x batch / 4e6) of the
  shared global step before the update; a distillation step advances
  the global step by 2, a finetune step by 1.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from portbench.reference.model import (
    PLAIN,
    Params,
    Precision,
    preprocess,
    student_input,
    tower,
)


def cross_entropy(pred: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    y = labels.to(torch.float32)
    eps = 1e-5
    return -(y * torch.log(pred + eps)
             + (1 - y) * torch.log(1 - pred + eps)).sum(1).mean()


def kl_sum(teacher: torch.Tensor, student: torch.Tensor) -> torch.Tensor:
    t = teacher / torch.clamp(teacher.sum(1, keepdim=True), min=1e-20)
    s = student / torch.clamp(student.sum(1, keepdim=True), min=1e-20)
    return (t * (torch.log(t + 1e-20) - torch.log(s + 1e-20))).sum()


class Adam:
    """TF-Adam with per-variable clipping over a dict of leaves."""

    def __init__(self, params: Params, clip: float = 1.0):
        self.clip = clip
        self.t = 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    def clipped(self, grads: Params) -> Params:
        return {k: g * min(1.0, self.clip / max(float(g.norm()), 1e-30))
                for k, g in grads.items()}

    def update(self, params: Params, grads: Params, lr: float) -> Params:
        """Update `params` in place; returns the clipped gradients."""
        grads = self.clipped(grads)
        self.t += 1
        lr_t = lr * (1 - 0.999 ** self.t) ** 0.5 / (1 - 0.9 ** self.t)
        with torch.no_grad():
            for k, p in params.items():
                g = grads[k]
                self.m[k].mul_(0.9).add_(0.1 * g)
                self.v[k].mul_(0.999).add_(0.001 * g * g)
                p.sub_(lr_t * self.m[k] / (self.v[k].sqrt() + 1e-8))
        return grads


def learning_rate(cfg: Dict, global_step: int) -> float:
    p = (global_step * cfg["batch_size"]) // cfg["learning_rate_decay_examples"]
    return cfg["base_learning_rate"] * cfg["learning_rate_decay"] ** p


def _grads(loss: torch.Tensor, params: Params) -> Params:
    names = list(params)
    return dict(zip(names, torch.autograd.grad(loss, [params[k] for k in names])))


def distill_losses(cfg: Dict, teacher: Params, student: Params, batch: Dict,
                   prec: Precision = PLAIN) -> Dict[str, torch.Tensor]:
    """The losses of one distillation step on a batch {"features" uint8
    [B, max_frames, D], "labels" [B, V], "num_frames" [B]}."""
    nf = batch["num_frames"].to(torch.int64)
    x = preprocess(batch["features"], nf)
    out_t = tower(teacher, x, nf, cfg["num_inputs_to_lstm"], prec)
    xs, nfs = student_input(batch["features"], nf, cfg["every_n"],
                            cfg["max_num_frames"])
    out_s = tower(student, xs, nfs, cfg["num_inputs_L1"], prec)
    ce_t = cross_entropy(out_t["predictions"], batch["labels"])
    ce_s = cross_entropy(out_s["predictions"], batch["labels"])
    rep = ((out_t["state"].detach() - out_s["state"]) ** 2).sum(1).mean()
    kl = kl_sum(out_t["predictions"].detach(), out_s["predictions"])
    return {"teacher_label_loss": ce_t, "student_label_loss": ce_s,
            "student_loss_state": rep, "pred_loss": kl,
            "teacher_final_loss": ce_t + out_t["reg"],
            "total_student_loss": 2 * rep + kl + ce_s + out_s["reg"]}


def finetune_losses(cfg: Dict, student: Params, batch: Dict,
                    prec: Precision = PLAIN) -> Dict[str, torch.Tensor]:
    xs, nfs = student_input(batch["features"], batch["num_frames"].to(torch.int64),
                            cfg["every_n"], cfg["max_num_frames"])
    out = tower(student, xs, nfs, cfg["num_inputs_L1"], prec)
    ce = cross_entropy(out["predictions"], batch["labels"])
    return {"student_label_loss": ce, "total_student_loss": ce + out["reg"]}


def run_steps(cfg: Dict, step: str, towers: Dict[str, Params],
              batches: Sequence[Dict], prec: Precision = PLAIN) -> Dict:
    """Train `towers` ({"teacher", "student"} or {"student"}, leaves that
    require grad) in place over `batches`, one step each. Returns the
    losses of each step (floats) and the first step's clipped gradients
    by "<tower>.<leaf>"."""
    optimizers = {name: Adam(p) for name, p in towers.items()}
    losses: List[Dict[str, float]] = []
    first = None
    global_step = 0
    for batch in batches:
        lr = learning_rate(cfg, global_step)
        if step == "distill":
            ls = distill_losses(cfg, towers["teacher"], towers["student"], batch, prec)
            objectives = {"teacher": ls["teacher_final_loss"],
                          "student": ls["total_student_loss"]}
        else:
            ls = finetune_losses(cfg, towers["student"], batch, prec)
            objectives = {"student": ls["total_student_loss"]}
        grads = {name: _grads(objectives[name], towers[name]) for name in towers}
        clipped = {name: optimizers[name].update(towers[name], grads[name], lr)
                   for name in towers}
        if first is None:
            first = {f"{name}.{k}": g.detach() for name in clipped
                     for k, g in clipped[name].items()}
        losses.append({k: float(v.detach()) for k, v in ls.items()})
        global_step += 2 if step == "distill" else 1
        del ls, objectives, grads
    return {"losses": losses, "first_grads": first}
