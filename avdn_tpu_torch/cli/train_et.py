"""HAA-Transformer entry point (the reference's ``xview_et/main.py``):

    python -m avdn_tpu_torch.cli.train_et --root_dir <dataset> --output_dir <run>
    python -m avdn_tpu_torch.cli.train_et --inference True \
        --render_twopass False --bf16 False --resume_file agent.pt ...
"""

import sys

from avdn_tpu_torch.cli.main import main as _main


def main(argv=None, device=None):
    return _main(sys.argv[1:] if argv is None else argv, family="et", device=device)


if __name__ == "__main__":
    main()
