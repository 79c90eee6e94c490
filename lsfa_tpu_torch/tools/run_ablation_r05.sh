#!/bin/bash
# The full ablation campaign in the PyTorch port, run durably: the dataset
# and checkpoints live under ART (gitignored data/ and ckpts/), and every
# rung is re-scored on the extended val set right after it trains, so that
# a lost machine cannot orphan a checkpoint before its evidence exists.
#
# Phases:
#   A  rfcn stage-A pretrain             -> report_rfcn.json + xval
#   B  FlowNet photometric pretrain      -> ckpts/flow
#   C  mv_only/rnet/small/full rungs     -> report_<rung>.json + xval
#      (each xval carries mAP_by_offset, the frames-from-key decay curve)
#   D  lt_off A/B on the full rung's own weights
#   E  resume mv_only + full one more epoch (~2x budget)
#      -> report_<rung>_9k.json + xval tag xval9k
#   F  render ABLATION.md
#
# Usage: run_ablation_r05.sh [STEPS] [PROFILE] [ART]
# Environment: ART (default runs/ablation_torch of the repo, never
# runs/ablation_r0*, the JAX package's), DATA (default ART/data), OUTROOT
# (default ART/ckpts), LOCK, EXTRA (more flags for every tool, e.g.
# "--cpu-smoke" or "--device cpu").
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
mkdir -p "$ART" "$OUTROOT" "$DATA"
cd "$REPO" || exit 1

LOCK=${LOCK:-${TMPDIR:-/tmp}/lsfa_ablation_torch.lock}
exec 9>"$LOCK"
if ! flock -n 9; then
  echo "another ladder instance holds $LOCK — refusing to start" >&2
  exit 1
fi

xval () {  # rung [extra eval_rung args...] — re-score on the extended val set
  local RUNG=$1; shift
  python -m lsfa_tpu_torch.tools.eval_rung --rung "$RUNG" \
    --ckpt "$OUTROOT/$RUNG/checkpoints" --data "$DATA" \
    --profile "$PROFILE" --out "$ART" $EXTRA "$@" \
    >> "$OUTROOT/$RUNG.xval.log" 2>&1 || echo "xval $RUNG FAILED" >&2
}

train_rung () {  # rung steps [extra train args...]
  local RUNG=$1 S=$2; shift 2
  local OUT="$OUTROOT/$RUNG"
  local INIT=""
  if [ "$RUNG" != "rfcn" ]; then
    INIT="--init-from $OUTROOT/rfcn/checkpoints"
  fi
  # two attempts: attempt 2 resumes from the last epoch checkpoint in a
  # fresh process (timeout bounds a wedged run)
  local rc=1
  for attempt in 1 2; do
    local RESUME=""
    if [ -d "$OUT/checkpoints" ] && [ -n "$(ls -A "$OUT/checkpoints" 2>/dev/null)" ]; then
      RESUME="--resume"
      echo "(resuming rung $RUNG from $OUT/checkpoints)"
    fi
    echo "=== rung $RUNG ($S steps, profile=$PROFILE, attempt $attempt) ==="
    timeout 7200 python -m lsfa_tpu_torch.tools.train_synth_full \
      --rung "$RUNG" --profile "$PROFILE" --steps "$S" \
      --out "$OUT" --data "$DATA" --batch-tag "$BATCH" $INIT $RESUME $EXTRA "$@" \
      > "$OUT.log" 2>&1
    rc=$?
    [ $rc -eq 0 ] && break
    echo "rung $RUNG attempt $attempt failed (rc=$rc)" >&2
    sleep 60
  done
  tail -3 "$OUT.log"
  if [ -f "$OUT/report.json" ]; then
    cp "$OUT/report.json" "$ART/report_$RUNG.json"
    cp "$OUT/curves.jsonl" "$ART/curves_$RUNG.jsonl" 2>/dev/null
  else
    echo "rung $RUNG FAILED (rc=$rc)" >&2
    return 1
  fi
}

# ---- phase A: single-frame stage-A pretrain + immediate re-score
if [ ! -f "$ART/report_rfcn_xval.json" ]; then
  [ -f "$ART/report_rfcn.json" ] || train_rung rfcn "$STEPS" || exit 1
  xval rfcn
fi

# ---- phase B: FlowNet photometric pretrain (the full rung's warm start),
# retried in a fresh process
FLOW="$OUTROOT/flow"
if [ ! -d "$FLOW" ] || [ -z "$(ls -A "$FLOW" 2>/dev/null)" ]; then
  for attempt in 1 2 3; do
    echo "=== FlowNet photometric pretrain (attempt $attempt) ==="
    timeout 7200 python -m lsfa_tpu_torch.tools.pretrain_flow --steps 800 \
      --out "$FLOW" --data "$DATA" --profile "$PROFILE" $EXTRA \
      > "$OUTROOT/flow.log" 2>&1 && break
    echo "flow pretrain attempt $attempt failed (rc=$?)" >&2
    rm -rf "$FLOW"
    [ "$attempt" = 3 ] && { echo "flow pretrain FAILED" >&2; exit 1; }
    sleep 60
  done
  tail -2 "$OUTROOT/flow.log"
fi

# ---- phase C: the LSFA rungs, each re-scored immediately
for RUNG in mv_only rnet small; do
  if [ ! -f "$ART/report_${RUNG}_xval.json" ]; then
    [ -f "$ART/report_$RUNG.json" ] || train_rung "$RUNG" "$STEPS" || continue
    xval "$RUNG"
  fi
done
if [ ! -f "$ART/report_full_xval.json" ]; then
  [ -f "$ART/report_full.json" ] || \
    train_rung full "$STEPS" --init-flow "$FLOW" || exit 1
  xval full
fi

# ---- phase D: lt_off inference A/B on the full rung's own weights
[ -f "$ART/report_full_xval_ltoff.json" ] || xval full --lt-off

# ---- phase E: double the budget on the two decisive rungs
for RUNG in mv_only full; do
  if [ ! -f "$ART/report_${RUNG}_xval9k.json" ]; then
    FLOWARG=""
    [ "$RUNG" = full ] && FLOWARG="--init-flow $FLOW"
    python -m lsfa_tpu_torch.tools.train_synth_full \
      --rung "$RUNG" --profile "$PROFILE" --steps $((2 * STEPS)) \
      --out "$OUTROOT/$RUNG" --data "$DATA" --batch-tag "$BATCH" \
      --init-from "$OUTROOT/rfcn/checkpoints" $FLOWARG --resume --tag _9k $EXTRA \
      > "$OUTROOT/$RUNG.9k.log" 2>&1 \
      || { echo "9k resume $RUNG FAILED" >&2; continue; }
    cp "$OUTROOT/$RUNG/report_9k.json" "$ART/report_${RUNG}_9k.json" 2>/dev/null
    xval "$RUNG" --tag xval9k
  fi
done

# ---- phase F: render
python -m lsfa_tpu_torch.tools.render_ablation --dir "$ART"
echo "=== campaign complete ==="
ls -la "$ART"
