#!/usr/bin/env bash
# Relight with every example config through the PyTorch port
# (scripts/relight.sh's counterpart). With one card the configs run one at a
# time; with N cards visible (CUDA_VISIBLE_DEVICES, else nvidia-smi) config i
# runs on card i mod N, each card taking its configs one at a time, as the
# reference's dispatcher gives each config a free GPU. Extra arguments go to
# every run, e.g.
#   scripts/relight_torch.sh -i clip.mp4 model_dir=path/to/iclight
# A failed config is reported and the others go on; the exit code is 1 if
# any failed.
set -euo pipefail
cd "$(dirname "$0")/.."

if [[ -n "${CUDA_VISIBLE_DEVICES:-}" ]]; then
  IFS=, read -ra CARDS <<< "$CUDA_VISIBLE_DEVICES"
else
  mapfile -t CARDS < <(nvidia-smi --query-gpu=index --format=csv,noheader)
fi
if ((${#CARDS[@]} == 0)); then
  echo "[relight_torch] no CUDA card visible" >&2
  exit 1
fi

CONFIGS=(configs/examples/*.yaml)
LOGS=$(mktemp -d)
trap 'rm -rf "$LOGS"' EXIT

lane() {  # lane <k>: configs k, k+N, ... on card k, one at a time
  local k=$1 failed=0
  shift
  for ((i = k; i < ${#CONFIGS[@]}; i += ${#CARDS[@]})); do
    echo "[relight_torch] card ${CARDS[k]}: ${CONFIGS[i]}"
    CUDA_VISIBLE_DEVICES=${CARDS[k]} python -m tclight_torch.run --config "${CONFIGS[i]}" "$@" \
      || { echo "[relight_torch] FAILED: ${CONFIGS[i]}"; failed=$((failed + 1)); }
  done
  echo "$failed" > "$LOGS/lane$k"
}

for ((k = 0; k < ${#CARDS[@]} && k < ${#CONFIGS[@]}; k++)); do
  lane "$k" "$@" &
done
wait

failed=0
for f in "$LOGS"/lane*; do
  failed=$((failed + $(cat "$f")))
done
echo "[relight_torch] ${#CONFIGS[@]} configs, $failed failed"
((failed == 0))
