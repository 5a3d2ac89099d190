"""cli.train_ensemble (ensemble training): not ported yet, ROADMAP Queue 1 item 14."""

import sys

from efficientvideoclassification_youtube8m_torch.cli import not_ported

main = not_ported("train_ensemble", "ensemble training")

if __name__ == "__main__":
    main(sys.argv[1:])
