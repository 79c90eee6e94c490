#!/bin/bash
# The LSFA module-ablation ladder on the synthetic VID set, in the PyTorch
# port: each rung trains the recipe through
# `python -m lsfa_tpu_torch.tools.train_synth_full` and scores held-out
# mAP through the evaluation loops. The rungs share one dataset (DATA).
#
# Two stages, as the reference's recipe (a pretrained ResNet merged into
# the detector, dff_rfcn/train_end2end.py:107-115): the single-frame rfcn
# rung trains first, and every LSFA rung warm-starts its shared detection
# stack from that checkpoint (--init-from), then trains the aggregation
# modules and fine-tunes end to end.
#
#   rfcn    -> single-frame R-FCN stage A (full backbone every frame)
#   mv_only -> pure DFF-style MV warping (no R-net / small net / Nq)
#   rnet    -> + residual-correction branch
#   small   -> + small-image detail net
#   full    -> + FlowNet/Nq long-term key aggregation (the flagship);
#              FLOW_INIT may name a checkpoint directory of
#              lsfa_tpu_torch.tools.pretrain_flow
#
# Usage: run_ablation_ladder.sh [STEPS] [PROFILE] [OUTROOT] [ART]
# Environment: ART (reports; default runs/ablation_torch of the repo, never
# runs/ablation_r0*, the JAX package's), DATA, FLOW_INIT, RUNGS, LOCK, and
# EXTRA (more flags for every tool, e.g. "--cpu-smoke" or "--device cpu").
set -u
set -o pipefail
export PYTHONUNBUFFERED=1
STEPS=${1:-4500}
PROFILE=${2:-hard}
OUTROOT=${3:-${TMPDIR:-/tmp}/lsfa_ablation_torch}
REPO=$(cd "$(dirname "$0")/../.." && pwd)
ART=${4:-${ART:-$REPO/runs/ablation_torch}}
DATA=${DATA:-$OUTROOT/data}
FLOW_INIT=${FLOW_INIT:-}
RUNGS=${RUNGS:-"rfcn mv_only rnet small full"}
EXTRA=${EXTRA:-}
case "$ART" in
  */runs/ablation_r0*|runs/ablation_r0*)
    echo "refusing to write into $ART: the JAX package's reports live there" >&2
    exit 1;;
esac
mkdir -p "$ART" "$OUTROOT"
cd "$REPO" || exit 1

# one ladder at a time: two concurrent ladders resume each other's partial
# checkpoints and fight over the one card
LOCK=${LOCK:-${TMPDIR:-/tmp}/lsfa_ablation_torch.lock}
exec 9>"$LOCK"
if ! flock -n 9; then
  echo "another ladder instance holds $LOCK — refusing to start" >&2
  exit 1
fi

for RUNG in $RUNGS; do
  OUT="$OUTROOT/$RUNG"
  if [ -f "$ART/report_$RUNG.json" ]; then
    echo "=== rung $RUNG already done, skipping ==="
    continue
  fi
  INIT=""
  if [ "$RUNG" != "rfcn" ]; then
    if [ ! -d "$OUTROOT/rfcn/checkpoints" ]; then
      echo "stage-A rfcn checkpoint missing under $OUTROOT/rfcn — abort" >&2
      exit 1
    fi
    INIT="--init-from $OUTROOT/rfcn/checkpoints"
  fi
  if [ "$RUNG" = "full" ] && [ -n "$FLOW_INIT" ]; then
    INIT="$INIT --init-flow $FLOW_INIT"
  fi
  # crash resume: pick up from the last epoch checkpoint, and keep the
  # longest curves file seen so far (a resumed run that goes straight to
  # evaluation rewrites curves.jsonl empty)
  RESUME=""
  if [ -d "$OUT/checkpoints" ] && [ -n "$(ls -A "$OUT/checkpoints" 2>/dev/null)" ]; then
    RESUME="--resume"
    echo "(resuming rung $RUNG from $OUT/checkpoints)"
  fi
  mkdir -p "$OUT"
  if [ -s "$OUT/curves.jsonl" ]; then
    cp "$OUT/curves.jsonl" "$OUT/curves.backup.jsonl"
  fi
  echo "=== rung $RUNG ($STEPS steps, profile=$PROFILE) ==="
  python -m lsfa_tpu_torch.tools.train_synth_full \
    --rung "$RUNG" --profile "$PROFILE" --steps "$STEPS" \
    --out "$OUT" --data "$DATA" $INIT $RESUME $EXTRA \
    > "$OUT.log" 2>&1
  rc=$?
  tail -5 "$OUT.log"
  if [ -f "$OUT/curves.backup.jsonl" ] && \
     [ "$(wc -c < "$OUT/curves.backup.jsonl")" -gt "$(wc -c < "$OUT/curves.jsonl" 2>/dev/null || echo 0)" ]; then
    mv "$OUT/curves.backup.jsonl" "$OUT/curves.jsonl"
  fi
  if [ -f "$OUT/report.json" ]; then
    cp "$OUT/report.json" "$ART/report_$RUNG.json"
    cp "$OUT/curves.jsonl" "$ART/curves_$RUNG.jsonl" 2>/dev/null
  else
    echo "rung $RUNG FAILED (rc=$rc)"
  fi
done
echo "=== ladder complete ==="
ls -la "$ART"
