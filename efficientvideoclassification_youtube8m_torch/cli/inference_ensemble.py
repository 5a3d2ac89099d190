"""cli.inference_ensemble (ensemble inference): not ported yet, ROADMAP Queue 1, the model zoo and losses."""

import sys

from efficientvideoclassification_youtube8m_torch.cli import not_ported

main = not_ported("inference_ensemble", "ensemble inference", "the model zoo and losses")

if __name__ == "__main__":
    main(sys.argv[1:])
