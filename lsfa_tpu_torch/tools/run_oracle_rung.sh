#!/bin/bash
# The oracle-warp rung in the PyTorch port, run after run_ablation_r05.sh
# (the same lock: it refuses to overlap a ladder): trains the mv_only graph
# with the generator's analytic flow in place of decoded MVs
# (data/oracle_flow.py) and re-scores it on the extended val set. The
# result bounds what any motion-vector estimate can reach on this data:
# oracle >> mv_only means the codec's 16x16 MV field is the accuracy
# ceiling; oracle ~= mv_only means warped-feature detection itself is.
#
# Usage: run_oracle_rung.sh [STEPS] [PROFILE] [ART]
# Environment: ART (default runs/ablation_torch of the repo, never
# runs/ablation_r0*), DATA (default ART/data), OUTROOT (default ART/ckpts),
# LOCK, EXTRA (more flags for every tool).
set -u
set -o pipefail
export PYTHONUNBUFFERED=1
STEPS=${1:-4500}
PROFILE=${2:-hard}
REPO=$(cd "$(dirname "$0")/../.." && pwd)
ART=${3:-${ART:-$REPO/runs/ablation_torch}}
case "$ART" in
  */runs/ablation_r0*|runs/ablation_r0*)
    echo "refusing to write into $ART: the JAX package's reports live there" >&2
    exit 1;;
esac
DATA=${DATA:-$ART/data}
OUTROOT=${OUTROOT:-$ART/ckpts}
BATCH="C-$(date +%Y%m%d)"
EXTRA=${EXTRA:-}
cd "$REPO" || exit 1

LOCK=${LOCK:-${TMPDIR:-/tmp}/lsfa_ablation_torch.lock}
exec 9>"$LOCK"
if ! flock -n 9; then
  echo "ladder instance holds $LOCK — run after it finishes" >&2
  exit 1
fi

if [ ! -d "$OUTROOT/rfcn/checkpoints" ]; then
  echo "stage-A rfcn checkpoint missing — run run_ablation_r05.sh first" >&2
  exit 1
fi

if [ ! -f "$ART/report_oracle.json" ]; then
  echo "=== rung oracle ($STEPS steps, profile=$PROFILE) ==="
  python -m lsfa_tpu_torch.tools.train_synth_full \
    --rung oracle --profile "$PROFILE" --steps "$STEPS" \
    --out "$OUTROOT/oracle" --data "$DATA" --batch-tag "$BATCH" \
    --init-from "$OUTROOT/rfcn/checkpoints" $EXTRA \
    > "$OUTROOT/oracle.log" 2>&1
  tail -3 "$OUTROOT/oracle.log"
  cp "$OUTROOT/oracle/report.json" "$ART/report_oracle.json" || exit 1
  cp "$OUTROOT/oracle/curves.jsonl" "$ART/curves_oracle.jsonl" 2>/dev/null
fi
[ -f "$ART/report_oracle_xval.json" ] || \
  python -m lsfa_tpu_torch.tools.eval_rung --rung oracle \
    --ckpt "$OUTROOT/oracle/checkpoints" --data "$DATA" \
    --profile "$PROFILE" --out "$ART" $EXTRA \
    >> "$OUTROOT/oracle.xval.log" 2>&1

python -m lsfa_tpu_torch.tools.render_ablation --dir "$ART"
echo "=== oracle rung complete ==="
