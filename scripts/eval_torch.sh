#!/usr/bin/env bash
# Evaluate every run under a work dir with the PyTorch port, then average
# the metrics (scripts/eval.sh's counterpart; tools/avg_metrics.py imports
# neither package). Extra arguments go to the evaluation, e.g.
#   scripts/eval_torch.sh workdir --flow_model raft --flow_ckpt raft-things.pth
set -euo pipefail
cd "$(dirname "$0")/.."

OUTPUT_DIR="${1:-workdir}"
shift $(($# > 0 ? 1 : 0))
python -m tclight_torch.evaluate --output_dir "$OUTPUT_DIR" --eval_cost "$@"
python tools/avg_metrics.py --output_dir "$OUTPUT_DIR"
