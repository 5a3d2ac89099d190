"""cli.export_tf (export to a TF-V2 bundle): not ported yet, ROADMAP Queue 1, checkpoint interop."""

import sys

from efficientvideoclassification_youtube8m_torch.cli import not_ported

main = not_ported("export_tf", "export to a TF-V2 bundle", "checkpoint interop")

if __name__ == "__main__":
    main(sys.argv[1:])
