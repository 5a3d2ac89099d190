"""Bias-tweak inference — named-binary parity with the reference's
`inference_bias.py` (port of the JAX package's cli/inference_bias.py).

Runs inference with one bias parameter rescaled as
`new = old/alpha + mean(old - old/alpha)` (:158-161). A thin front-end
over cli/infer.py, which implements the rescaling (`rescale_bias_param`).
"""

from __future__ import annotations

import sys

from efficientvideoclassification_youtube8m_torch.cli import flags as flags_lib
from efficientvideoclassification_youtube8m_torch.cli.infer import inference


def main(argv=None):
    flags_lib.setup_logging()
    parser = flags_lib.base_parser("Inference with a rescaled bias tensor (GPU)")
    parser.add_argument("--output_file", required=True)
    parser.add_argument("--tensor_name", required=True,
                        help="params path of the bias, e.g. "
                        "classifier/experts/b")
    parser.add_argument("--alpha_bias", type=float, default=2.0)
    args = parser.parse_args(argv)
    flags_lib.dump_flags(args)
    inference(args)


if __name__ == "__main__":
    main(sys.argv[1:])
