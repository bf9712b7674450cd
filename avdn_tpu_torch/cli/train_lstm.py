"""HAA-LSTM entry point (the reference's ``xview_lstm/main.py``):

    python -m avdn_tpu_torch.cli.train_lstm --root_dir <dataset> --output_dir <run> \
        --feedback student --max_action_len 10 --max_instr_len 100 \
        --batch_size 4 --optim adamW --lr 1e-5 --nss_w 0
    python -m avdn_tpu_torch.cli.train_lstm --inference True \
        --render_twopass False --bf16 False --resume_file agent.pt ...

The first is ``scripts/run_lstm_haa.sh``'s recipe; the checkpoints it
writes, and the ``.pt`` that ``--resume_file`` reads, hold the reference's
LSTM layout (``{lang_model, vln_model}``, the Darknet under
``vision_model.``).
"""

import sys

from avdn_tpu_torch.cli.main import main as _main


def main(argv=None, device=None):
    return _main(sys.argv[1:] if argv is None else argv, family="lstm", device=device)


if __name__ == "__main__":
    main()
