#!/usr/bin/env bash
# Tiptoe-style cluster baseline on the PyTorch + CUDA port, on the card
# (reference run-cluster-search.sh role; scripts/run-cluster-search.sh's
# flags).
set -euo pipefail
cd "$(dirname "$0")/.."
python -m pacmann_tpu_torch.cli.cluster_search -n "${N:-1000000}" -d 128 -k 10 \
  -q "${Q:-100}" ${INPUT:+-input "$INPUT"} ${QUERY:+-query "$QUERY"} \
  ${GND:+-gnd "$GND"} -report "${REPORT:-cluster-report.txt}" "$@"
