"""The comparisons that decide ``correct``: what the timed path produced
against the plain reference (``portbench/reference``), on the same inputs
and weights, computed after the window has closed.

Serving: at each compared pixel, the amount by which the reference's
score of the served label lies below its best score, in units of the
median margin between the reference's two best scores.  ``gap_mean`` is
its mean over the compared pixels: the model's labels against the head's
logits, and ``crf_gap_mean`` the CRF's refined labels against the final Q
of the reference mean field run on the served model labels.  A random net
of this depth moves its logits by several percent under bf16 rounding
alone, so labels flip wherever two classes nearly tie; a flip at a
near-tie costs almost nothing here, and the mean separates the configured
precision from one step below it by one to two orders of magnitude
(PERF.md).  ``mismatch`` and ``gap_max`` are reported beside it.

Training: the steps' losses (``loss_gap``, the worst relative gap); each
leaf's first gradient by the gap between its norm and the reference's
(``grad_gap`` the worst leaf, ``grad_gap_median`` the median leaf) and by
the norm of the difference (``grad_err_median``); each leaf's change over
the steps by the gap of norms (``update_gap``, ``update_gap_median``);
each relative to the larger of that leaf's reference norm and the median
leaf's.  Leaves whose reference gradient is under a thousandth of the
median leaf's move by round-off alone and are left out of the change.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import harness as H
from portbench.reference import crf as RC
from portbench.reference import model as RM


def reference_scores(config, w, X, crf=None, quant=None, block=4):
    """Reference scores (n, C, H, W) of images ``X`` (n, H, W, 3) on the
    device: the head's logits, or with ``crf`` the mean field's final Q
    from the reference's own labels; in blocks of ``block`` images."""
    out = []
    with H.no_tf32(), torch.no_grad():
        for i in range(0, len(X), block):
            z = RM.logits(config, w, X[i:i + block], quant)
            if crf is not None:
                lab = torch.argmax(z, dim=1)
                z = torch.stack([
                    RC.mean_field(X[i + j], lab[j], crf, config["n_classes"],
                                  quant) for j in range(len(lab))])
            out.append(z)
    return torch.cat(out)


def serve_check(config, w, X, served, raw=None, crf=None, control=None):
    """The compared numbers of a serving cell.  ``X`` (n, H, W, 3) the
    images on the device; ``served`` (n, H, W) the labels served; ``raw``
    the model's labels served beside them where a CRF runs (``crf``, its
    configuration).  The model's labels are judged against the reference's
    logits (``gap_mean`` ...); the CRF's against the reference's mean field
    run on the served model labels, the way a served model's tokens are
    judged (``crf_gap_mean`` ...).  With ``control`` (``{"quant": fn}``)
    the reference at that precision takes the program's place; with
    ``{"fault": "crf_skipped"}`` the program's refined labels are replaced
    by its model labels (a planted fault)."""
    if control is not None and control.get("fault") == "crf_skipped":
        served = raw              # planted: the CRF leaves the labels alone
    elif control is not None and control.get("fault"):
        raise ValueError(f"unknown serving fault {control['fault']!r}")
    elif control is not None:
        q = control["quant"]
        with H.no_tf32(), torch.no_grad():
            model = torch.cat([RM.logits(config, w, X[i:i + 4], q)
                               for i in range(0, len(X), 4)]).argmax(1)
            refined = (torch.stack([RC.mean_field(X[j], model[j], crf,
                                                  config["n_classes"], q)
                                    for j in range(len(X))]).argmax(1)
                       if crf is not None else model)
        served, raw = refined.cpu().numpy(), model.cpu().numpy()
    model_labels = raw if crf is not None else served
    out = serve_numbers(model_labels, reference_scores(config, w, X))
    if crf is not None:
        raw_t = torch.as_tensor(np.asarray(raw)).to(X.device)
        with H.no_tf32(), torch.no_grad():
            Q = torch.stack([RC.mean_field(X[j], raw_t[j], crf,
                                           config["n_classes"])
                             for j in range(len(X))])
        out.update({"crf_" + k: v for k, v in
                    serve_numbers(served, Q).items()})
    return out


def serve_numbers(served, ref):
    """``gap_mean``, ``gap_max`` and ``mismatch`` of served labels
    (n, H, W) against the reference's scores (n, C, H, W)."""
    served = torch.as_tensor(np.asarray(served)).to(ref.device).long()
    top2 = ref.topk(2, dim=1).values
    margin = max(float((top2[:, 0] - top2[:, 1]).median()), 1e-12)
    gap = (top2[:, 0] - ref.gather(1, served[:, None])[:, 0]) / margin
    return {"gap_mean": float(gap.mean()), "gap_max": float(gap.max()),
            "mismatch": float((served != ref.argmax(1)).float().mean())}


def _norm_gaps(prog, ref, names):
    """Per leaf |norm(prog) - norm(ref)| / max(norm(ref), median leaf's),
    and per leaf norm(prog - ref) / max(norm(ref), median leaf's)."""
    rn = {n: float(ref[n].norm()) for n in names}
    med = float(np.median(list(rn.values())))
    gap = [abs(float(prog[n].norm()) - rn[n]) / max(rn[n], med, 1e-30)
           for n in names]
    err = [float((prog[n].to(ref[n].device) - ref[n]).norm())
           / max(rn[n], med, 1e-30) for n in names]
    return gap, err


def train_numbers(prog, ref):
    """Training's numbers from (losses, first gradients, changes) of the
    program and of the reference: the steps' losses; each leaf's first
    gradient by the gap of its norm (worst and median leaf, and the worst
    leaf's name) and by the norm of its difference (median leaf); each
    leaf's change by the gap of its norm (worst and median leaf)."""
    pl, pg, pd = prog
    rl, rg, rd = ref
    names = sorted(rg)
    gn = {n: float(rg[n].norm()) for n in names}
    med = float(np.median(list(gn.values())))
    moving = [n for n in names if gn[n] >= 1e-3 * med]
    g_gap, g_err = _norm_gaps(pg, rg, names)
    d_gap, _ = _norm_gaps(pd, rd, moving)
    n = min(len(pl), len(rl))
    return {"grad_gap_leaf": names[int(np.argmax(g_gap))],
            "loss_gap": max(abs(pl[i] - rl[i]) / abs(rl[i])
                            for i in range(n)),
            "grad_gap": max(g_gap), "grad_gap_median": float(np.median(g_gap)),
            "grad_err_median": float(np.median(g_err)),
            "update_gap": max(d_gap),
            "update_gap_median": float(np.median(d_gap))}


def judge(numbers: dict, limits: dict):
    """[(name, value, limit, ok)] for every limited number; a number
    without a value (a run that gave none) fails."""
    out = []
    for name, limit in limits.items():
        v = numbers.get(name)
        ok = v is not None and np.isfinite(v) and v <= limit
        out.append((name, v, limit, bool(ok)))
    return out
