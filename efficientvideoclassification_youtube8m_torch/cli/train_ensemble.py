"""cli.train_ensemble (ensemble training): not ported yet, ROADMAP Queue 1, the model zoo and losses."""

import sys

from efficientvideoclassification_youtube8m_torch.cli import not_ported

main = not_ported("train_ensemble", "ensemble training", "the model zoo and losses")

if __name__ == "__main__":
    main(sys.argv[1:])
