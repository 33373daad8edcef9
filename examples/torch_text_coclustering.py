"""Doc x term co-clustering on the CLASSIC4-shaped proxy, on PyTorch: discovers
document collections and their vocabularies simultaneously, then serves
topic assignment for unseen documents from the fitted model.

    PYTHONPATH=src python examples/torch_text_coclustering.py             # on the card
    PYTHONPATH=src python examples/torch_text_coclustering.py --overlap
    PYTHONPATH=src python examples/torch_text_coclustering.py --ckpt /path/to/model
    PYTHONPATH=src python examples/torch_text_coclustering.py --device cpu --n-docs 1500

The ``repro_torch`` version of ``examples/text_coclustering.py``. With
``--ckpt`` pointing at a saved CoclusterModel (saved by either package) the
fit is skipped and the checkpoint is served directly; an unfitted or stale
checkpoint fails loudly (``streaming.ModelLoadError``) instead of producing
garbage labels. ``--overlap`` fits in the non-exhaustive assignment mode
(DESIGN.md §11): terms that serve several collections keep *multiple*
memberships and terms whose votes never concentrate are flagged as
outliers instead of being forced into a topic. ``main`` returns the scores
it prints.
"""

from __future__ import annotations

import argparse
import sys
import tempfile

import numpy as np
import torch

from repro_torch import streaming
from repro_torch.core import LAMCConfig, cocluster_scores, lamc_cocluster
from repro_torch.core.metrics import nmi
from repro_torch.data import classic4_proxy
from repro_torch.device import resolve_device


def fit_model(data, ckpt_dir: str, dev: torch.device, overlap: bool = False):
    print(f"doc-term matrix: {data.shape}, density {data.density:.3f}")
    cfg = LAMCConfig(
        n_row_clusters=4, n_col_clusters=4,
        min_cocluster_rows=700, min_cocluster_cols=120,
        p_thresh=0.95, workers=8,
        # sparse doc-term data: a single doc hits only ~density * q anchor
        # terms, so out-of-sample scoring needs a wider anchor set than the
        # dense default (64) to see enough of each request
        signature_dim=256,
        assignment="overlap" if overlap else "hard",
    )
    out = lamc_cocluster(data.matrix, cfg, device=dev)
    s = cocluster_scores(out.row_labels.cpu().numpy(), out.col_labels.cpu().numpy(),
                         data.row_labels, data.col_labels)
    print(f"plan {out.plan.m}x{out.plan.n} T_p={out.plan.t_p} -> "
          f"NMI={s['nmi']:.3f} ARI={s['ari']:.3f}")
    scores = dict(plan=(out.plan.m, out.plan.n, out.plan.phi, out.plan.psi, out.plan.t_p),
                  fit_nmi=s["nmi"], fit_ari=s["ari"])
    if overlap:
        scores.update(show_overlap(out))
    model = streaming.model_from_result(out)
    streaming.save_model(ckpt_dir, model, cfg=cfg, plan=out.plan)
    return scores


def show_overlap(out) -> dict:
    """Multi-membership demo: which terms straddle topic vocabularies."""
    doc_m = out.row_membership.cpu().numpy()
    term_m = out.col_membership.cpu().numpy()
    counts = {}
    for name, m in (("docs", doc_m), ("terms", term_m)):
        card = m.sum(1)
        single, multi, none = (int((card == 1).sum()), int((card >= 2).sum()),
                               int((card == 0).sum()))
        counts[name] = dict(single=single, multi=multi, outliers=none)
        print(f"{name}: {single} single-topic, {multi} multi-topic, {none} outliers")
    col_votes = out.col_votes.cpu().numpy()
    for t in np.nonzero(term_m.sum(1) >= 2)[0][:8]:
        topics = np.nonzero(term_m[t])[0].tolist()
        share = col_votes[t] / max(col_votes[t].sum(), 1)
        print(f"  term {t}: topics {topics} "
              f"(vote shares {[f'{share[c]:.2f}' for c in topics]})")
    return dict(memberships=counts)


def serve_from(model: streaming.CoclusterModel, data) -> dict:
    # vote margins = per-document confidence (consensus strength)
    votes = model.row_votes.cpu().numpy()
    margin = np.sort(votes, 1)[:, -1] / np.maximum(votes.sum(1), 1)
    print(f"mean consensus confidence: {margin.mean():.2f} "
          f"(1.0 = all resamples agree)")

    # out-of-sample: assign "new" documents (here: the training docs,
    # scored only through the q anchor terms) against the topic signatures
    n = min(512, data.shape[0], model.n_rows)
    res = streaming.assign_rows(model, data.matrix[:n])
    agree = nmi(res.labels.cpu().numpy(), model.row_labels[:n].cpu().numpy())
    print(f"assign_rows on {n} docs: NMI vs fitted labels = {agree:.3f}")
    return dict(consensus_confidence=float(margin.mean()), assign_nmi_vs_fit=agree)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", default=None,
                    help="serve this saved CoclusterModel instead of fitting")
    ap.add_argument("--n-docs", type=int, default=6000)
    ap.add_argument("--overlap", action="store_true",
                    help="fit in non-exhaustive overlap mode and demo "
                         "multi-membership terms (DESIGN.md §11)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    data = classic4_proxy(seed=0, n_docs=args.n_docs)
    if args.ckpt is not None:
        try:
            model, meta = streaming.load_model(args.ckpt, device=dev)
        except streaming.ModelLoadError as e:
            sys.exit(f"cannot serve from {args.ckpt!r}: {e}")
        if model.n_cols != data.shape[1]:
            sys.exit(
                f"cannot serve from {args.ckpt!r}: model was fitted on "
                f"{model.n_rows}x{model.n_cols} data but this corpus has "
                f"{data.shape[1]} terms (stale checkpoint?)")
        print(f"restored {meta['kind']} ({model.n_rows}x{model.n_cols})")
        return serve_from(model, data)

    with tempfile.TemporaryDirectory() as ckpt_dir:
        scores = fit_model(data, ckpt_dir, dev, overlap=args.overlap)
        # serve from the *restored* artifact — the same path a separate
        # serving process would take
        model, _ = streaming.load_model(ckpt_dir, device=dev)
        scores.update(serve_from(model, data))
    return scores


if __name__ == "__main__":
    main()
