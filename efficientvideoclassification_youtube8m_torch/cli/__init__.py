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
  inspect_checkpoint  -> inspect_checkpoint_myfile.py
  hash_check          -> hash_check_redownload.py (shard md5s)

Run as `python -m efficientvideoclassification_youtube8m_torch.cli.<name>`
with the JAX package's flags; `--device cpu` runs on the CPU, the default
`/gpu:0` on the first CUDA device. `inference_ensemble`, `train_ensemble`
and `export_tf` are not ported yet: their modules raise
NotImplementedError naming the ROADMAP Queue 1 item they wait for.
"""


def not_ported(name: str, what: str, item: str):
    """The `main` of a binary that is not ported yet: it raises, naming
    the ROADMAP Queue 1 item (by its title) that ports it."""

    def main(argv=None):
        raise NotImplementedError(
            f"cli.{name} ({what}) is not ported to the GPU package yet "
            f"(ROADMAP Queue 1, {item}); run the JAX package's cli.{name}")

    return main
