"""Max-ensembler: per-label max merge of K prediction CSVs.

Rebuild of the reference's `max_ensemble.py` (streaming instead of
materializing all 700,640 Kaggle rows); a copy of the JAX package's
cli/max_ensemble.py over the port's ensemble.py.
"""

from __future__ import annotations

import argparse
import glob
import logging
import sys

from efficientvideoclassification_youtube8m_torch.ensemble import (
    max_ensemble,
    write_predictions_csv,
)

logger = logging.getLogger("max_ensemble")


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser("Per-label max ensemble of prediction CSVs")
    parser.add_argument("--preds_pattern", required=True)
    parser.add_argument("--output_file", required=True)
    parser.add_argument("--num_classes", type=int, default=4716)
    parser.add_argument("--top_k", type=int, default=20)
    args = parser.parse_args(argv)

    files = sorted(glob.glob(args.preds_pattern))
    if not files:
        raise IOError(f"no files match {args.preds_pattern!r}")
    logger.info("ensembling %d files: %s", len(files), " ".join(files))
    write_predictions_csv(
        args.output_file, max_ensemble(files, args.num_classes, args.top_k)
    )
    logger.info("wrote %s", args.output_file)


if __name__ == "__main__":
    main(sys.argv[1:])
