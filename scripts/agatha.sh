#!/bin/bash
# Benchmark harness — drop-in analogue of the reference's AGAThA.sh
# (reference cite: AGAThA.sh:1-52): runs the aligner N times on a
# FASTA pair set, collects per-iteration kernel time into raw.log and
# per-pair scores into score.log, then averages into time.json.
#
# Usage: scripts/agatha.sh [-i ITER] [-q QUERY.fasta] [-t TARGET.fasta]
#                              [-o OUTPUT_DIR]
set -euo pipefail

REPO_DIR="$(cd "$(dirname "$0")/.." && pwd)"
OUTPUT_DIR="${REPO_DIR}/output"
QUERY=""
TARGET=""
ITER=1
IDLE=5
DATASET_NAME="test"
PROCESS="AGAThA-JAX"

while getopts "i:q:t:o:" opt; do
    case "$opt" in
    i) ITER="$OPTARG" ;;
    q) QUERY="$OPTARG" ;;
    t) TARGET="$OPTARG" ;;
    o) OUTPUT_DIR="$OPTARG" ;;
    esac
done

RAW_FILE="${OUTPUT_DIR}/raw.log"
FINAL_FILE="${OUTPUT_DIR}/time.json"
SCORE_FILE="${OUTPUT_DIR}/score.log"

mkdir -p "$OUTPUT_DIR"
rm -f "$RAW_FILE" "$SCORE_FILE" "$FINAL_FILE"

if [ -z "$QUERY" ] || [ -z "$TARGET" ]; then
    echo ">>> No dataset given; generating the synthetic benchmark set."
    python "${REPO_DIR}/scripts/make_dataset.py" "$OUTPUT_DIR"
    QUERY="${OUTPUT_DIR}/query.fasta"
    TARGET="${OUTPUT_DIR}/ref.fasta"
fi

echo ">>> Running $PROCESS for $ITER iterations."
iter=0
while [ "$iter" -lt "$ITER" ]; do
    echo ">> Iteration $((iter + 1))"
    # Canonical parameters and positional order (reference cite:
    # AGAThA.sh:44 — ref.fasta rides in the FIRST slot, the one the
    # binary calls query_batch; alignment is not symmetric in
    # q_end/t_end, so the order matters on real datasets).
    python -m agatha_jax.cli -p -m 1 -x 4 -q 6 -r 2 -s 3 -z 400 -w 751 \
        "$TARGET" "$QUERY" "$RAW_FILE" > "$SCORE_FILE"
    iter=$((iter + 1))
    if [ "$iter" -lt "$ITER" ]; then sleep "$IDLE"; fi
done

echo "$PROCESS complete."
echo "Creating output files..."
python "${REPO_DIR}/scripts/avg_time.py" "$PROCESS" "$DATASET_NAME" \
    "$RAW_FILE" "$FINAL_FILE" "$ITER"
echo "Complete."
