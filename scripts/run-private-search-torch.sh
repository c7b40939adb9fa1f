#!/usr/bin/env bash
# Canonical private-search run on the PyTorch + CUDA port, on the card
# (the reference's run-private-search.sh parameters: SIFT1M, n=1e6 d=128
# m=32 k=10 q=100 step=20 parallel=3 rtt=50).
# Point -input/-query/-gnd at SIFT files (bvecs/fvecs/ivecs) when available;
# without them the driver generates synthetic data.
set -euo pipefail
cd "$(dirname "$0")/.."
python -m pacmann_tpu_torch.cli.private_search \
  -n "${N:-1000000}" -d 128 -m 32 -k 10 -q "${Q:-100}" \
  -step 20 -parallel 3 -rtt 50 \
  -engine device-fused -concurrent "${CONCURRENT:-8}" \
  ${INPUT:+-input "$INPUT"} ${QUERY:+-query "$QUERY"} ${GND:+-gnd "$GND"} \
  ${GRAPH:+-graph "$GRAPH"} \
  -report "${REPORT:-private-search-report.txt}" "$@"
