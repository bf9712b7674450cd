#!/bin/bash
# Reproduce the reference's released-checkpoint validation numbers
# (BASELINE.md table / reference valid.txt:4,11) with the PyTorch port, on
# the card, the day the dataset assets land. Auto-skips with a clear message
# while they are absent. Usage: scripts/repro_valid_torch.sh [ROOT] [flags]
#
# Matches the reference's src/scripts/avdn_paper/run_et_haa.sh:40-43
# (inference mode, released best_val_unseen, max_action_len 5).
set -e
cd "$(dirname "$0")/.."
exec python tools/repro_valid_torch.py --root_dir "${1:-../datasets}" "${@:2}"
