"""Entry-point binaries of the reference's five-binary pipeline (port of
the JAX package's cli/):

  train     -> train.py               (teacher+student distillation)
  validate  -> validate.py            (student eval with teacher present)
  convert   -> train_convert_model.py (checkpoint surgery)
  finetune  -> train_finetune.py      (student-only training)
  eval      -> eval_finetune.py       (student-only eval; --quantize int8)

Run as `python -m efficientvideoclassification_youtube8m_torch.cli.<name>`
with the JAX package's flags; `--device cpu` runs on the CPU, the default
`/gpu:0` on the first CUDA device. `infer`, the ensemble tools
(`inference_ensemble`, `inference_bias`, `max_ensemble`,
`train_ensemble`), `export_tf` and `inspect_checkpoint` are not ported
yet: their modules raise NotImplementedError naming ROADMAP Queue 1 item
14.
"""


def not_ported(name: str, what: str):
    """The `main` of a binary that is not ported yet: it raises."""

    def main(argv=None):
        raise NotImplementedError(
            f"cli.{name} ({what}) is not ported to the GPU package yet "
            f"(ROADMAP Queue 1 item 14); run the JAX package's cli.{name}")

    return main
