#!/usr/bin/env bash
# Non-private ANN baseline on the PyTorch + CUDA port, on the card
# (reference run-ngt-search.sh role; scripts/run-ann.sh's flags).
set -euo pipefail
cd "$(dirname "$0")/.."
python -m pacmann_tpu_torch.cli.ann -n "${N:-1000000}" -d 128 -m 32 -k 10 \
  -q "${Q:-100}" -step 20 -parallel 3 \
  ${INPUT:+-input "$INPUT"} ${QUERY:+-query "$QUERY"} ${GND:+-gnd "$GND"} \
  ${GRAPH:+-graph "$GRAPH"} "$@"
