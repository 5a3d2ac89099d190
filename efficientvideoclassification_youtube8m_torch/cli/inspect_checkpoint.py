"""cli.inspect_checkpoint (the checkpoint inspector): not ported yet, ROADMAP Queue 1 item 14."""

import sys

from efficientvideoclassification_youtube8m_torch.cli import not_ported

main = not_ported("inspect_checkpoint", "the checkpoint inspector")

if __name__ == "__main__":
    main(sys.argv[1:])
