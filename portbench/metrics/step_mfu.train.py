"""One WCT step (``finetune.make_train_step``) against the card: the
operations the step needs (forward, ``dx`` and slab gradients, causal
attention, the head; not the recomputed forward) over the bf16 peak, over
the traced steps' time on the device's clock (first activity to last)."""

from portbench import costs


def read(run):
    tr = run.trace
    if tr is None or run.peaks is None:
        return None
    acts = [a for a in tr.activities if a.index is not None]
    if not acts:
        return None
    spent = (max(a.end for a in acts) - min(a.start for a in acts)) / 1e9
    mix = run.mix
    ops = costs.train_step_ops(run.dims, mix["batch"], mix["seq"]) * run.traced["steps"]
    return 100.0 * ops / run.peaks["flops"] / spent
